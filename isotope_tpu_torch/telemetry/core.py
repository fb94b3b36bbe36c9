"""Engine self-telemetry: counters, gauges, phase timers, run records.

The port of ``isotope_tpu.telemetry.core``.  The simulated *workload*
is observable through ``metrics/prometheus.py``; this module is the
always-on instrumentation layer the ENGINE reports through:

- **Counters / gauges / phase timers** live in one process-wide
  registry (plain host dicts — recording is a dict update, never a
  device op).  Instrumented code calls :func:`counter_inc`,
  :func:`gauge_set` / :func:`gauge_max`, and ``with phase("name"):``
  unconditionally.
- **Spans** (:func:`span`) name a stretch of host code on the
  profiler's timeline, the clock its device trace shares, so device
  time and idle time can be put down to the code that launched or
  awaited it.  With no profiler recording a span is one check: no op,
  no registry update.  ``phase`` opens one around its body.
- **Detail mode** (:func:`enable` with ``detail=True``) additionally
  arms :func:`segment_fence`: the engine synchronizes the card at each
  level of its upward and start-time sweeps, so each level gets its
  own wall-time phase (``torch.cuda.synchronize``; a CPU tensor needs
  no fence).  The fences serialize the block, so detail mode is for
  *diagnosis*, not benchmarking; with detail off the fence returns
  before touching torch: the block loop gains no op and no sync.
- **Exposition**: :func:`snapshot` freezes the registry into a
  :class:`RunTelemetry` record that serializes to ``telemetry.jsonl``
  lines, and :func:`prometheus_text` renders the same state as
  ``isotope_engine_*`` Prometheus series so one scrape sees the
  workload *and* the engine.

The reference's XLA hooks (``time_first_call``, ``record_trace``,
``install_jax_hooks``: trace, lower and compile seconds, retraces, the
persistent-cache traffic) have no counterpart here, since the port
traces and compiles nothing; :func:`summary_block` keeps their keys,
which read 0.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Any, Dict, Iterator, List, Optional, Set

import torch
from torch._C._autograd import _profiler_enabled

SCHEMA = "isotope-engine-telemetry/v1"

class _State:
    """The process-wide registry (one instance, module-level)."""

    def __init__(self) -> None:
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.phases: Dict[str, float] = {}
        self.meta: Dict[str, Any] = {}  # run annotations (degraded_to, ...)
        self.emit = False          # artifact emission requested (--telemetry)
        self.detail = False        # segment fencing armed (--telemetry=detail)
        self.last_fence_t: Optional[float] = None


_STATE = _State()


# -- mode switches ---------------------------------------------------------

def enable(detail: bool = False) -> None:
    """Request artifact emission (and optionally detail-mode fencing)."""
    _STATE.emit = True
    _STATE.detail = bool(detail)


def disable() -> None:
    _STATE.emit = False
    _STATE.detail = False


def emitting() -> bool:
    """Whether the caller asked for telemetry artifacts (``--telemetry``)."""
    return _STATE.emit


def detail_enabled() -> bool:
    return _STATE.detail


def reset() -> None:
    """Clear every counter/gauge/phase (tests, per-bench-case isolation).

    Leaves the emit/detail switches in place.
    """
    _STATE.counters.clear()
    _STATE.gauges.clear()
    _STATE.phases.clear()
    _STATE.meta.clear()
    _STATE.last_fence_t = None


# -- counters / gauges / phases --------------------------------------------

def counter_inc(name: str, n: float = 1.0) -> None:
    _STATE.counters[name] = _STATE.counters.get(name, 0.0) + n


def set_meta(key: str, value: Any) -> None:
    """Annotate the current run record (e.g. ``degraded_to``).

    Meta entries land in the snapshot's ``meta`` section and the
    ``summary_block`` headline — not in the numeric Prometheus series.
    """
    _STATE.meta[key] = value


def get_meta(key: str, default: Any = None) -> Any:
    return _STATE.meta.get(key, default)


def counter_get(name: str) -> float:
    return _STATE.counters.get(name, 0.0)


def _gauge_key(name: str, labels: Dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


def gauge_set(name: str, value: float, **labels: Any) -> None:
    _STATE.gauges[_gauge_key(name, labels)] = float(value)


def gauge_max(name: str, value: float, **labels: Any) -> None:
    """High-water gauge: keeps the max ever observed (device memory)."""
    key = _gauge_key(name, labels)
    prev = _STATE.gauges.get(key)
    if prev is None or value > prev:
        _STATE.gauges[key] = float(value)


def gauge_get(name: str, **labels: Any) -> Optional[float]:
    return _STATE.gauges.get(_gauge_key(name, labels))


def phase_add(name: str, seconds: float) -> None:
    _STATE.phases[name] = _STATE.phases.get(name, 0.0) + seconds


def phase_seconds(name: str) -> float:
    return _STATE.phases.get(name, 0.0)


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A range ``name`` on the profiler's timeline while a profiler
    records (``torch.profiler.record_function``), nested in whatever
    range the host thread is in; otherwise a context that does nothing.

    The gate is one check, so spans may sit on the block path.  Close a
    span before a generator yields: the lockstep twins
    (``parallel/sharded.py``) suspend the block loops between blocks,
    and a span left open would swallow the other loops' work.
    """
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Accumulating wall-clock phase timer, and a :func:`span` of the
    same name.

    Its seconds are host wall time with no device sync: on the card,
    the time to enqueue the body's work, not to run it (the span shows
    the work on a profiler's trace).  Re-entering the same name sums;
    nested phases time independently, so an enclosing phase's seconds
    include its children's (each name is its own accumulator — there is
    no implicit hierarchy).
    """
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        phase_add(name, time.perf_counter() - t0)


# -- engine hooks ----------------------------------------------------------

def fence_reset() -> None:
    """Start a new fence epoch (called at the top of a sweep)."""
    _STATE.last_fence_t = None


def segment_fence(label: str, value) -> None:
    """Detail-mode-only fence at a segment boundary (callers on the
    block path build ``label`` only when :func:`detail_enabled`).

    Records the wall time since the previous fence (launch + device
    execution of this segment) under ``segment.<label>``, synchronizing
    the card first when ``value`` lives there.  With detail off this
    returns before touching torch — the default path gains no op and no
    sync point.
    """
    if not _STATE.detail or value is None:
        return
    t_prev = _STATE.last_fence_t
    if t_prev is None:
        t_prev = time.perf_counter()
    if value.device.type == "cuda":
        torch.cuda.synchronize(value.device)
    t1 = time.perf_counter()
    counter_inc("engine_fences")
    phase_add(f"segment.{label}", t1 - t_prev)
    _STATE.last_fence_t = t1
    # numeric-sentinel localization: the fence holds the segment's
    # output, so a NaN is pinned to the segment that PRODUCED it (the
    # run-level sentinel only sees the reduced summary).  Never raises —
    # the run-level sentinel decides.
    if value.is_floating_point() and bool(torch.isnan(value).any()):
        counter_inc("numeric_sentinel_violations")
        gauge_set("numeric_sentinel", 1.0, segment=label)


def record_device_memory() -> Optional[float]:
    """High-water per-device memory gauges from torch's caching
    allocator (``torch.cuda.max_memory_allocated``, bytes since the
    last ``reset_peak_memory_stats``).

    Returns the max peak bytes across devices, or ``None`` without an
    initialized CUDA device (the CPU has no such statistic).
    """
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    peak = None
    for i in range(torch.cuda.device_count()):
        v = float(torch.cuda.max_memory_allocated(i))
        gauge_max("device_memory_peak_bytes", v, device=str(i))
        peak = max(peak or 0.0, v)
    if peak is not None:
        gauge_max("device_memory_peak_bytes_max", peak)
    return peak


# -- derived views ---------------------------------------------------------

def summary_block() -> Dict[str, Any]:
    """The headline numbers every perf report should carry."""
    c, p, g = _STATE.counters, _STATE.phases, _STATE.gauges
    hits = c.get("executable_cache_hits", 0.0)
    misses = c.get("executable_cache_misses", 0.0)
    total = hits + misses
    padded = c.get("bucket_padded_elems", 0.0)
    real = c.get("bucket_real_elems", 0.0)
    peak = g.get("device_memory_peak_bytes_max")
    blk: Dict[str, Any] = {
        "retries_total": int(c.get("retries_total", 0.0)),
        "degradations_total": int(c.get("degradations_total", 0.0)),
        "compile_s": round(
            p.get("compile.trace", 0.0)
            + p.get("compile.lower", 0.0)
            + p.get("compile.backend", 0.0),
            4,
        ),
        "trace_s": round(p.get("compile.trace", 0.0), 4),
        "lower_s": round(p.get("compile.lower", 0.0), 4),
        "backend_s": round(p.get("compile.backend", 0.0), 4),
        "cache_hits": int(hits),
        "cache_misses": int(misses),
        "cache_hit_ratio": round(hits / total, 4) if total else None,
        "persistent_cache_hits": int(c.get("persistent_cache_hits", 0.0)),
        "persistent_cache_misses": int(
            c.get("persistent_cache_misses", 0.0)
        ),
        "padding_waste_fraction": (
            round((padded - real) / padded, 4) if padded else 0.0
        ),
        "peak_device_bytes": peak,
    }
    # key PRESENT only when the run actually degraded: bench_regress
    # keys its degraded-on-a-previously-clean-case gate on presence
    if _STATE.meta.get("degraded_to"):
        blk["degraded_to"] = _STATE.meta["degraded_to"]
    # vet keys PRESENT only when a vet pass actually ran this record:
    # bench_regress's opt-in new-vet-errors gate skips captures (and
    # baselines) that never vetted instead of reading absence as zero
    if c.get("vet_runs_total"):
        blk["vet_runs"] = int(c["vet_runs_total"])
        blk["vet_errors"] = int(c.get("vet_errors_total", 0.0))
        blk["vet_warnings"] = int(c.get("vet_warnings_total", 0.0))
    return blk


def summary_line() -> str:
    """One human-readable line over :func:`summary_block` — the shared
    stderr rendering of the ``simulate --telemetry`` / ``telemetry``
    commands (one format string, so the two CLIs cannot drift)."""
    blk = summary_block()
    peak = blk["peak_device_bytes"]
    return (
        "telemetry: compile {compile_s:.2f}s (trace {trace_s:.2f} / "
        "lower {lower_s:.2f} / backend {backend_s:.2f}), exec-cache "
        "{cache_hits}h/{cache_misses}m, persistent-cache "
        "{persistent_cache_hits}h/{persistent_cache_misses}m, padding "
        "waste {padding_waste_fraction:.1%}, peak device bytes {peak}"
    ).format(peak="n/a" if peak is None else f"{peak:.0f}", **blk)


# -- the per-run record ----------------------------------------------------

@dataclasses.dataclass
class RunTelemetry:
    """One frozen snapshot of the registry, serializable to JSONL."""

    label: Optional[str]
    phases: Dict[str, float]
    counters: Dict[str, float]
    gauges: Dict[str, float]
    meta: Dict[str, Any]
    schema: str = SCHEMA

    def to_dict(self) -> dict:
        return {
            "schema": self.schema,
            "label": self.label,
            "phases": self.phases,
            "counters": self.counters,
            "gauges": self.gauges,
            "meta": self.meta,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "RunTelemetry":
        return cls(
            label=d.get("label"),
            phases=dict(d.get("phases", {})),
            counters=dict(d.get("counters", {})),
            gauges=dict(d.get("gauges", {})),
            meta=dict(d.get("meta", {})),
            schema=d.get("schema", SCHEMA),
        )

    def to_json_line(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    def append_jsonl(self, path) -> None:
        # heal a crash-torn tail before appending: if the file does not
        # end in a newline (a killed run's half-written record), start
        # this record on a fresh line so the fragment stays an isolated
        # bad line (which the readers skip-and-count) instead of
        # swallowing this record into unreadable garbage
        lead = ""
        try:
            with open(path, "rb") as f:
                f.seek(-1, 2)
                if f.read(1) not in (b"\n", b""):
                    lead = "\n"
        except OSError:
            pass  # missing or empty file: nothing to heal
        with open(path, "a") as f:
            f.write(lead + self.to_json_line() + "\n")

    def prometheus_text(self) -> str:
        return _render_prometheus(self.phases, self.counters, self.gauges)


def snapshot(label: Optional[str] = None) -> RunTelemetry:
    """Freeze the current registry (refreshing device-memory gauges)."""
    record_device_memory()
    meta: Dict[str, Any] = {"unix_time": time.time()}
    cuda = torch.cuda.is_available()
    meta["backend"] = "cuda" if cuda else "cpu"
    meta["device_count"] = torch.cuda.device_count() if cuda else 1
    meta["torch_version"] = torch.__version__
    meta.update(_STATE.meta)  # run annotations (degraded_to, ...)
    return RunTelemetry(
        label=label,
        phases={k: round(v, 6) for k, v in sorted(_STATE.phases.items())},
        counters=dict(sorted(_STATE.counters.items())),
        gauges={k: float(v) for k, v in sorted(_STATE.gauges.items())},
        meta=meta,
    )


# -- Prometheus exposition -------------------------------------------------

def _render_prometheus(phases, counters, gauges) -> str:
    out: List[str] = []
    out.append(
        "# HELP isotope_engine_phase_seconds_total Wall seconds spent in"
        " each engine phase."
    )
    out.append("# TYPE isotope_engine_phase_seconds_total counter")
    for name, v in sorted(phases.items()):
        out.append(
            f'isotope_engine_phase_seconds_total{{phase="{name}"}}'
            f" {v:.10g}"
        )
    out.append(
        "# HELP isotope_engine_events_total Engine event counters"
        " (cache hits/misses, buckets formed, traces, fences)."
    )
    out.append("# TYPE isotope_engine_events_total counter")
    promoted = []
    for name, v in sorted(counters.items()):
        if name.endswith("_total"):
            # resilience headline counters (retries_total,
            # degradations_total, ...) get their own first-class series
            # — alert rules key on isotope_engine_degradations_total
            # directly, not on a label of the events grab-bag
            promoted.append((name, v))
            continue
        out.append(
            f'isotope_engine_events_total{{event="{name}"}} {v:.10g}'
        )
    for name, v in promoted:
        out.append(
            f"# HELP isotope_engine_{name} Engine resilience counter."
        )
        out.append(f"# TYPE isotope_engine_{name} counter")
        out.append(f"isotope_engine_{name} {v:.10g}")
    # gauges carry their own (optional) label block in the key
    seen_families: Set[str] = set()
    for key, v in sorted(gauges.items()):
        family = key.split("{", 1)[0]
        if family not in seen_families:
            seen_families.add(family)
            out.append(
                f"# HELP isotope_engine_{family} Engine gauge."
            )
            out.append(f"# TYPE isotope_engine_{family} gauge")
        out.append(f"isotope_engine_{key} {v:.10g}")
    return "\n".join(out) + "\n"


def prometheus_text() -> str:
    """Render the live registry as ``isotope_engine_*`` series."""
    return _render_prometheus(
        _STATE.phases, _STATE.counters, _STATE.gauges
    )


# -- JSONL validation / iteration -------------------------------------------

def _jsonl_docs(path) -> Iterator[dict]:
    """Parsed records of a ``telemetry.jsonl`` file.

    An undecodable line — a crash mid-append leaving a torn tail, or a
    torn fragment a later ``append_jsonl`` healed onto its own line —
    is skipped and counted under ``telemetry_torn_lines``: one bad
    line costs one record, never the file.  (Same quarantine policy as
    the sweep checkpoint loader.)
    """
    with open(path) as f:
        lines = f.read().splitlines()
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            yield json.loads(line)
        except json.JSONDecodeError:
            counter_inc("telemetry_torn_lines")


def iter_jsonl(path) -> Iterator["RunTelemetry"]:
    """Iterate a ``telemetry.jsonl`` file as :class:`RunTelemetry`
    records, quarantining crash-torn lines (see ``_jsonl_docs``)."""
    for doc in _jsonl_docs(path):
        yield RunTelemetry.from_dict(doc)


def validate_jsonl(path) -> int:
    """Validate a ``telemetry.jsonl`` file; returns the record count.

    Raises ``ValueError`` on schema violations.  A crash-torn line (a
    killed run's half-written record) is skipped, not an error.
    """
    n = 0
    for i, doc in enumerate(_jsonl_docs(path), 1):
        if doc.get("schema") != SCHEMA:
            raise ValueError(
                f"{path}:{i}: schema {doc.get('schema')!r} != {SCHEMA!r}"
            )
        for section in ("phases", "counters", "gauges", "meta"):
            if not isinstance(doc.get(section), dict):
                raise ValueError(
                    f"{path}:{i}: missing/invalid {section!r} section"
                )
        for section in ("phases", "counters", "gauges"):
            for k, v in doc[section].items():
                if not isinstance(k, str) or not isinstance(
                    v, (int, float)
                ):
                    raise ValueError(
                        f"{path}:{i}: {section}[{k!r}] is not numeric"
                    )
        n += 1
    if n == 0:
        raise ValueError(f"{path}: no telemetry records")
    return n
