"""Op auditor: the VET-J rules over a pilot block's op log.

The port of ``isotope_tpu.analysis.jaxpr_audit``.  The reference walks
the jaxpr its engine would jit; the port walks the op log of one pilot
block (``analysis/oplog.py``: ``Simulator._simulate_core`` at the
reference's trace size under a dispatch mode), so a site is an aten
name and the frame that dispatched it (``aten.nonzero@sim/joins.py:
slot_sweep``), not a jaxpr path:

- **host sync points** (VET-J001): ``aten._local_scalar_dense`` (an
  ``.item()``, ``float()`` or ``bool()`` of a tensor), device-to-host
  copies and the ops whose output shape or work depends on the data
  (``nonzero``, ``masked_select``, ``unique``, indexing by a boolean
  mask) each stall the launch queue until the card catches up;
- **dtype leaks** (VET-J002): float64 / complex128 outputs, but for the
  block's deliberate float64 sites (:data:`F64_ALLOWED`, each with its
  reason; any other float64 op is still a finding);
- **nondeterministic accumulation** (VET-J003, info): float
  ``index_add``, ``scatter_add`` and ``index_put(accumulate=True)``;
- **retrace hazards** (VET-J004): :func:`audit_cache_signature` is the
  reference's, a pure function.  The port has no executable cache
  (``compiler/cache.py`` is not ported), so :func:`audit_simulator` does
  not call it on a Simulator.

``$ISOTOPE_VET_INJECT`` seeds the defects into the pilot: ``callback``
an ``.item()`` of the first output leaf, ``f64`` a float64 round trip of
``client_latency`` at a site of its own (``_inject_f64``), and
``graddead`` is read by the gradient audit.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import torch

from isotope_tpu_torch.analysis.findings import (
    SEV_ERROR,
    SEV_INFO,
    SEV_WARN,
    Finding,
)

ENV_VET_INJECT = "ISOTOPE_VET_INJECT"

#: ops that stall the host on the card: a scalar read back, or an
#: output whose shape depends on the data
HOST_SYNC_OPS = frozenset({
    "aten._local_scalar_dense",
    "aten.nonzero",
    "aten.nonzero_static",
    "aten.masked_select",
    "aten.unique",
    "aten._unique",
    "aten._unique2",
    "aten.unique_dim",
    "aten.unique_consecutive",
})

#: dtypes whose presence in the pilot is a leak (VET-J002)
WIDE_DTYPES = frozenset({torch.float64, torch.complex128})

#: float accumulations whose order is backend-dependent (VET-J003)
SCATTER_ACCUM_OPS = frozenset({
    "aten.index_add",
    "aten.index_add_",
    "aten.scatter_add",
    "aten.scatter_add_",
})

#: the block's deliberate float64 sites (``file:function``), each with
#: its reason (ROADMAP.md queue 3); float64 anywhere else is VET-J002
F64_ALLOWED = {
    "sim/engine.py:_clock_cumsum": (
        "request clocks are float32 prefix sums accumulated in float64, "
        "as torch's CPU cumsum does; an ungraceful kill's reset lands "
        "within four float32 spacings of the kill time"
    ),
    "metrics/attribution.py:_winner_charges": (
        "the blame sweep sums D in float64 and rounds it once, so the "
        "card's atomic order does not reach the float32 value"
    ),
    "metrics/attribution.py:_sweep": (
        "blame buckets take their log in float64: counts within one "
        "bucket of the reference's"
    ),
    "metrics/attribution.py:blame_bucket_index": (
        "the bucket log in the precision of its float64 input"
    ),
}

#: how many distinct sites one rule reports before folding into a count
MAX_SITES_PER_RULE = 5


def inject_spec() -> Tuple[str, ...]:
    """The armed defect-injection kinds (env ISOTOPE_VET_INJECT)."""
    spec = os.environ.get(ENV_VET_INJECT, "")
    kinds = tuple(k.strip() for k in spec.split(",") if k.strip())
    for k in kinds:
        if k not in ("callback", "f64", "graddead"):
            raise ValueError(
                f"unknown {ENV_VET_INJECT} kind {k!r} "
                "(one of: callback, f64, graddead)"
            )
    return kinds


def _first_leaf(out) -> Optional[torch.Tensor]:
    for x in out:
        if isinstance(x, torch.Tensor):
            return x
    return None


def _inject_callback(out):
    """The ``callback`` defect: a host read of the first output leaf."""
    leaf = _first_leaf(out)
    if leaf is not None and leaf.numel():
        leaf.max().item()
    return out


def _inject_f64(out):
    """The ``f64`` defect: ``client_latency`` through float64."""
    lat = out.client_latency
    wide = lat.to(torch.float64)
    return out._replace(client_latency=(wide * 2.0).to(lat.dtype))


def _injector(kinds):
    steps = []
    if "callback" in kinds:
        steps.append(_inject_callback)
    if "f64" in kinds:
        steps.append(_inject_f64)
    if not steps:
        return None

    def inject(out):
        for step in steps:
            out = step(out)
        return out

    return inject


def trace_entry(sim, load, num_requests: int = 8):
    """``(pilot, n)``: the recorded pilot block ``load`` would run, and
    its request count (closed loops trace one request per connection
    at least; the cost model scales by THIS n).  The saturated
    ``-qps max`` program is replaced by the plain closed loop."""
    from isotope_tpu_torch.analysis import oplog

    p = oplog.run_pilot(sim, load, num_requests,
                        inject=_injector(inject_spec()))
    return p, p.n


def _site(op) -> str:
    return f"{op.name}@{op.site}"


def _fold_sites(rule: str, severity: str, sites: List[str],
                message: str) -> List[Finding]:
    """One finding per distinct site, folding the tail into a count."""
    seen = dict.fromkeys(sites)  # order-preserving dedupe
    distinct = list(seen)
    out = [
        Finding(rule, severity, message, path=site)
        for site in distinct[:MAX_SITES_PER_RULE]
    ]
    extra = len(distinct) - MAX_SITES_PER_RULE
    if extra > 0:
        out.append(Finding(
            rule, severity,
            f"{message} ({extra} more distinct site(s), "
            f"{len(sites)} occurrences total)",
            path=distinct[MAX_SITES_PER_RULE],
        ))
    return out


def audit_log(log) -> List[Finding]:
    """The VET-J rules over one op log."""
    from isotope_tpu_torch.analysis.oplog import ALIAS

    sync_sites: List[str] = []
    wide_sites: List[str] = []
    scatter_sites: List[str] = []
    for op in log.ops:
        if op.name == ALIAS:
            continue
        site = _site(op)
        if op.packet in HOST_SYNC_OPS or op.to_host or op.bool_index:
            sync_sites.append(site)
        if (op.packet in SCATTER_ACCUM_OPS or op.accumulate) and any(
            dt.is_floating_point for dt in op.out_dtypes
        ):
            scatter_sites.append(site)
        if op.site not in F64_ALLOWED:
            for dt in op.out_dtypes:
                if dt in WIDE_DTYPES:
                    wide_sites.append(f"{site}->{str(dt)[6:]}")
                    break

    findings: List[Finding] = []
    findings += _fold_sites(
        "VET-J001", SEV_ERROR, sync_sites,
        "host read or data-dependent shape stalls the launch queue "
        "once a block",
    )
    findings += _fold_sites(
        "VET-J002", SEV_ERROR, wide_sites,
        "wide dtype in the block (doubles the event-tensor footprint; "
        "off the fast path)",
    )
    findings += _fold_sites(
        "VET-J003", SEV_INFO, scatter_sites,
        "float scatter-add: accumulation order is backend-dependent",
    )
    return findings


def audit_cache_signature(signature) -> List[Finding]:
    """Cross-check an executable-cache key (the reference's
    ``compiler/cache.py``): an **unhashable** component crashes the
    lookup, and a component whose ``repr`` embeds its memory address
    (``... at 0x...``) digests differently in every process — a
    guaranteed retrace.  Pure host data; the port has no executable
    cache of its own, so nothing in it calls this on a Simulator."""
    findings: List[Finding] = []

    def rec(obj, path: str) -> None:
        if isinstance(obj, tuple):
            try:
                hash(obj)
            except TypeError:
                findings.append(Finding(
                    "VET-J004", SEV_ERROR,
                    "unhashable executable-cache key component "
                    "(the AOT cache lookup would raise)",
                    path=path,
                ))
                return
            for i, x in enumerate(obj):
                rec(x, f"{path}[{i}]")
            return
        try:
            hash(obj)
        except TypeError:
            findings.append(Finding(
                "VET-J004", SEV_ERROR,
                f"unhashable signature component of type "
                f"{type(obj).__name__}",
                path=path,
            ))
            return
        r = repr(obj)
        if " at 0x" in r:
            findings.append(Finding(
                "VET-J004", SEV_WARN,
                f"id-based repr {r[:60]!r}: array_digest "
                "(compiler/cache.py) hashes this component by repr, so "
                "the cache key changes every process — a guaranteed "
                "retrace",
                path=path,
            ))

    rec(signature, "signature")
    return findings


def audit_simulator(sim, load, num_requests: int = 8,
                    trace: bool = True
                    ) -> Tuple[List[Finding], Optional[object], int]:
    """All op-audit findings for one Simulator under one load:
    ``(findings, pilot, traced_n)``.  The pilot and its request count go
    to the cost model, so the block is recorded once.  ``trace=False``
    records nothing.  The executable-cache signature audit (J004) is not
    run: the port has no such cache."""
    if not trace:
        return [], None, max(int(num_requests), 1)
    pilot, traced_n = trace_entry(sim, load, num_requests)
    return audit_log(pilot.log), pilot, traced_n
