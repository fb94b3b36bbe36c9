"""The op log: one pilot block of the engine, recorded op by op.

The port's counterpart of the reference's traced jaxpr
(``isotope_tpu.analysis.jaxpr_audit.trace_entry`` and ``iter_eqns``).
Eager PyTorch has no program to trace, so the static passes read a
**pilot block** instead: ``Simulator._simulate_core`` run once at the
reference's trace size (8 requests, or one per connection for a closed
loop) under a ``TorchDispatchMode`` that records every aten op:

- its name (``aten.add.Tensor``) and site, the innermost frame under
  ``isotope_tpu_torch/`` as ``file:function``;
- the dtypes, shapes and bytes of its outputs;
- the values it reads and writes.  A value is one version of a tensor:
  an op's fresh output, a view of a value, or the new version an
  in-place op writes.  A write through one alias reaches the others
  through the tensors' shared version counter (an ``alias`` entry joins
  the two versions).

Storage lifetimes are tracked with ``weakref.finalize``, so the live
bytes' high-water is the eager program's own; storages the pilot reads
but did not allocate (the Simulator's tables) are counted apart, as
``external_bytes``.

The census kernel is launched through ctypes, so a dispatch mode would
see its two ``torch.empty`` calls and not the kernel (and on the CPU the
plain version's inner ops).  ``native/census.py`` calls
:attr:`OpLog.census_hook` while a log records: the census is one entry,
``census``, on both devices, with inputs ``step_base``, ``step_mask``,
``agg``, ``fail_step`` and ``err`` and outputs ``busy`` and ``excl``.
With no log recording, the hook costs the census one global test.

The saturated ``-qps max`` program is replaced by the plain closed loop,
as the reference's trace is (its tables come from pilot runs, which the
audit must not start).  The pilot never runs a real block: it calls
``_simulate_core`` at the pilot's size and nothing else of the engine's
entry points (``run``, ``run_blocks``, ``run_summary``).
"""
from __future__ import annotations

import dataclasses
import pathlib
import sys
import weakref
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

_PKG = pathlib.Path(__file__).resolve().parents[1]
_SELF = pathlib.Path(__file__).resolve()

#: the reference's trace size (``jaxpr_audit.trace_entry``)
TRACE_REQUESTS = 8

#: the entry of a census call in the log
CENSUS = "census"
#: the join of two versions of one storage (a write through an alias)
ALIAS = "alias"

_CENSUS_INPUTS = ("step_base", "step_mask", "agg", "fail_step", "err")


@dataclasses.dataclass
class Op:
    """One entry of the log."""

    name: str                      # "aten.add.Tensor", "census", "alias"
    site: str                      # "sim/engine.py:_simulate_core"
    ins: Tuple[int, ...]           # values read (tensor arguments)
    outs: Tuple[int, ...]          # values written
    in_shapes: Tuple[tuple, ...]
    out_shapes: Tuple[tuple, ...]
    out_dtypes: Tuple[torch.dtype, ...]
    new_bytes: int = 0             # storage bytes this op allocated
    accumulate: bool = False       # index_put(accumulate=True)
    to_host: bool = False          # a copy from the card to the host
    bool_index: bool = False       # index / index_put by a boolean mask

    @property
    def packet(self) -> str:
        """The name without its overload: ``aten.add``."""
        parts = self.name.split(".")
        return ".".join(parts[:2]) if parts[0] == "aten" else self.name


class Value(NamedTuple):
    dtype: torch.dtype
    shape: tuple


_REL: Dict[str, Optional[str]] = {}


def _rel(filename: str) -> Optional[str]:
    """``filename`` relative to the package, None outside it (cached)."""
    rel = _REL.get(filename, "")
    if rel == "":
        path = pathlib.Path(filename).resolve()
        try:
            rel = None if path == _SELF else \
                path.relative_to(_PKG).as_posix()
        except ValueError:
            rel = None
        _REL[filename] = rel
    return rel


def _site(skip: int = 2) -> str:
    """The innermost frame under the package, outside this module,
    ``skip`` frames up."""
    f = sys._getframe(skip)
    while f is not None:
        rel = _rel(f.f_code.co_filename)
        if rel is not None:
            return f"{rel}:{f.f_code.co_name}"
        f = f.f_back
    return "?"


_INDEX_PUT = ("aten::index_put", "aten::index_put_", "aten::_index_put_impl_")


def _accumulates(func, args, kwargs) -> bool:
    """An ``index_put`` with ``accumulate=True``."""
    if func._schema.name not in _INDEX_PUT:
        return False
    return bool(kwargs.get("accumulate", args[3] if len(args) > 3
                           else False))


#: ops whose output depends on their tensor arguments' shapes only: they
#: read no value (a jaxpr broadcasts a literal for them)
_SHAPE_ONLY = frozenset({
    "aten::ones_like", "aten::zeros_like", "aten::empty_like",
    "aten::full_like", "aten::rand_like", "aten::randn_like",
    "aten::new_ones", "aten::new_zeros", "aten::new_empty",
    "aten::new_full", "aten::new_empty_strided",
})


def _bool_index(func, args) -> bool:
    """An ``index`` / ``index_put`` by a boolean mask: its work (and for
    ``index`` its output shape) depends on the data."""
    if func._schema.name not in _INDEX_PUT + ("aten::index",):
        return False
    return any(
        isinstance(t, torch.Tensor) and t.dtype in (torch.bool, torch.uint8)
        for t in (args[1] if len(args) > 1 else ()) or ()
    )


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


class OpLog:
    """The ops of one recorded span, with their values and the live
    bytes' high-water.  Use :meth:`record` as a context manager."""

    def __init__(self):
        self.ops: List[Op] = []
        self.values: List[Value] = []
        self.external: Dict[int, None] = {}    # external value ids
        self.external_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.census_calls = 0
        self._tensor_val = WeakIdKeyDictionary()  # tensor -> (vid, version)
        self._storage_last: Dict[int, int] = {}   # storage key -> vid
        self._storage_bytes: Dict[int, int] = {}  # internal live storages
        self._ext_storages: Dict[int, None] = {}
        self._paused = False

    # -- values ----------------------------------------------------------

    def _new_value(self, t: torch.Tensor) -> int:
        self.values.append(Value(t.dtype, tuple(t.shape)))
        return len(self.values) - 1

    @staticmethod
    def _skey(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def _free(self, key: int) -> None:
        nbytes = self._storage_bytes.pop(key, None)
        if nbytes is not None:
            self.live_bytes -= nbytes
        self._storage_last.pop(key, None)

    def read(self, t: torch.Tensor) -> int:
        """The value ``t`` holds now."""
        got = self._tensor_val.get(t)
        skey = self._skey(t)
        if got is None:
            vid = self._new_value(t)
            if skey not in self._storage_bytes and \
                    skey not in self._ext_storages:
                storage = t.untyped_storage()
                self._ext_storages[skey] = None
                self.external_bytes += storage.nbytes()
                self.external[vid] = None
                weakref.finalize(storage, self._ext_storages.pop, skey,
                                 None)
            self._tensor_val[t] = (vid, t._version)
            self._storage_last.setdefault(skey, vid)
            return vid
        vid, version = got
        if t._version != version:
            last = self._storage_last.get(skey, vid)
            if last != vid:
                # written through another alias: join the two versions
                new = self._new_value(t)
                self.ops.append(Op(
                    ALIAS, "", (vid, last), (new,), (), (tuple(t.shape),),
                    (t.dtype,),
                ))
                vid = new
            self._tensor_val[t] = (vid, t._version)
        return vid

    def _write(self, t: torch.Tensor, fresh: bool) -> Tuple[int, int]:
        """A value for an op's output ``t``; ``(vid, new bytes)``."""
        vid = self._new_value(t)
        skey = self._skey(t)
        new_bytes = 0
        if fresh and skey not in self._storage_bytes \
                and skey not in self._ext_storages:
            storage = t.untyped_storage()
            new_bytes = storage.nbytes()
            self._storage_bytes[skey] = new_bytes
            self.live_bytes += new_bytes
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(storage, self._free, skey)
        self._storage_last[skey] = vid
        self._tensor_val[t] = (vid, t._version)
        return vid, new_bytes

    # -- recording -------------------------------------------------------

    def dispatch(self, func, args, kwargs):
        if self._paused:
            return func(*args, **kwargs)
        in_ts = (
            [] if func._schema.name in _SHAPE_ONLY
            else _tensors((args, kwargs))
        )
        ins = tuple(self.read(t) for t in in_ts)
        in_ids = {id(t) for t in in_ts}
        out = func(*args, **kwargs)
        out_ts = _tensors(out)
        mutable = func._schema.is_mutable
        outs, new_bytes = [], 0
        for t in out_ts:
            # an output that is an input object was written in place
            # (its version is bumped after this returns); a view shares
            # its input's storage: neither allocates
            fresh = id(t) not in in_ids and not func.is_view
            vid, nb = self._write(t, fresh)
            if id(t) in in_ids and mutable:
                self._tensor_val[t] = (vid, t._version + 1)
            outs.append(vid)
            new_bytes += nb
        self.ops.append(Op(
            name=f"aten.{func._schema.name.split('::')[-1]}"
            + (f".{func._overloadname}" if func._overloadname != "default"
               else ""),
            site=_site(),
            ins=ins,
            outs=tuple(outs),
            in_shapes=tuple(tuple(t.shape) for t in in_ts),
            out_shapes=tuple(tuple(t.shape) for t in out_ts),
            out_dtypes=tuple(t.dtype for t in out_ts),
            new_bytes=new_bytes,
            accumulate=_accumulates(func, args, kwargs),
            to_host=any(t.device.type != "cpu" for t in in_ts)
            and any(t.device.type == "cpu" for t in out_ts),
            bool_index=_bool_index(func, args),
        ))
        return out

    def census_hook(self, step_base, step_mask, agg, fail_step=None,
                    err=None):
        """The census as one entry (``native/census.py`` calls this
        while the log records)."""
        from isotope_tpu_torch.native import census as census_mod

        named = dict(zip(_CENSUS_INPUTS,
                         (step_base, step_mask, agg, fail_step, err)))
        in_ts = [t for t in named.values() if t is not None]
        ins = tuple(self.read(t) for t in in_ts)
        self._paused = True
        census_mod.AUDIT = None
        try:
            busy, excl = census_mod.census(step_base, step_mask, agg,
                                           fail_step, err)
        finally:
            census_mod.AUDIT = self.census_hook
            self._paused = False
        outs, new_bytes = [], 0
        for t in (busy, excl):
            vid, nb = self._write(t, True)
            outs.append(vid)
            new_bytes += nb
        self.census_calls += 1
        self.ops.append(Op(
            CENSUS, _site(3), ins, tuple(outs),
            tuple(tuple(t.shape) for t in in_ts),
            (tuple(busy.shape), tuple(excl.shape)),
            (busy.dtype, excl.dtype), new_bytes,
        ))
        return busy, excl

    def record(self):
        return _Recording(self)


class _Mode(TorchDispatchMode):
    def __init__(self, log: OpLog):
        super().__init__()
        self.log = log

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # the port compiles nothing: leave __torch_dispatch__ unwrapped,
        # so the first recording of a process does not import
        # torch._dynamo (seconds of host time)
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return self.log.dispatch(func, args, kwargs or {})


class _Recording:
    def __init__(self, log: OpLog):
        self.log = log
        self.mode = _Mode(log)

    def __enter__(self):
        from isotope_tpu_torch.native import census as census_mod

        if census_mod.AUDIT is not None:
            raise RuntimeError("an op log is already recording")
        census_mod.AUDIT = self.log.census_hook
        self.mode.__enter__()
        return self.log

    def __exit__(self, *exc):
        from isotope_tpu_torch.native import census as census_mod

        try:
            return self.mode.__exit__(*exc)
        finally:
            census_mod.AUDIT = None


class Pilot(NamedTuple):
    """A recorded pilot block: its log, its request count, its output
    (``SimResults``, or the ``RunSummary`` of a knob-armed pilot) and
    the value ids of the arguments it was seeded at."""

    log: OpLog
    n: int
    out: object
    seeds: Dict[str, int]


def pilot_size(load, num_requests: int = TRACE_REQUESTS) -> int:
    """The request count a pilot runs (``jaxpr_audit.trace_entry``):
    ``num_requests``, and at least one per connection for a closed
    loop.  The cost model scales by this count."""
    from isotope_tpu_torch.sim.config import CLOSED_LOOP

    n = max(int(num_requests), 1)
    if load.kind == CLOSED_LOOP:
        n = max(n, int(load.connections))
    return n


def run_pilot(sim, load, num_requests: int = TRACE_REQUESTS,
              armed: bool = False,
              inject: Optional[Callable] = None,
              arm: Optional[Callable] = None) -> Pilot:
    """Record one pilot block of ``sim`` under ``load``.

    The block's draws come from ``TorchDraws(0)`` on the Simulator's
    device; its rate is the load's (a closed loop's rate solve runs
    pilots of its own, so the pilot takes the asked-for rate, or the
    capacity for ``-qps max``).  ``armed`` runs the knob-armed block of
    the gradient audit: the fleets' ``cpu_scale`` / ``err_scale`` are
    passed (1.0) and the block is reduced to its ``RunSummary``, as the
    reference's member body is.  ``arm`` (the gradient audit's
    ``graddead`` defect) maps ``cpu_scale`` before the block sees it,
    ``inject`` (the ``callback`` / ``f64`` defects) maps the block's
    output; both run inside the recording."""
    from isotope_tpu_torch.sim import summary as summary_mod
    from isotope_tpu_torch.sim.config import CLOSED_LOOP, OPEN_LOOP
    from isotope_tpu_torch.sim.draws import TorchDraws

    closed = load.kind == CLOSED_LOOP
    conns = int(load.connections) if closed else 0
    n = pilot_size(load, num_requests)
    dev = sim.device
    offered = float(load.qps) if load.qps else float(sim.capacity_qps())
    if not (offered > 0 and offered < float("inf")):
        offered = 1.0
    pace = conns / float(load.qps) if closed and load.qps else 0.0
    nominal = conns / offered if closed else 0.0
    t = dict(
        offered_qps=sim._scalar(offered),
        pace_gap=sim._scalar(pace),
        nominal_gap=sim._scalar(nominal),
        visits_pc=sim._vis_arg(offered).clone(),
        phase_windows=sim._windows_arg(offered, False).clone(),
    )
    if armed:
        t.update(
            cpu_scale=sim._scalar(1.0),
            err_scale=sim._scalar(1.0),
        )
    t0 = torch.zeros((), dtype=torch.float32, device=dev)
    conn_t0 = torch.zeros(max(conns, 1) if closed else 1,
                          dtype=torch.float32, device=dev)
    source = TorchDraws(0, dev)
    log = OpLog()
    # the arguments' values, made before the span: the grad audit seeds
    # its taint there
    seeds = {name: log.read(x) for name, x in t.items()}
    with log.record():
        draws = sim._draws(source, None, n, OPEN_LOOP if not closed
                           else CLOSED_LOOP)
        cpu_scale = t.get("cpu_scale")
        if arm is not None and cpu_scale is not None:
            cpu_scale = arm(cpu_scale)
        res, _, _ = sim._simulate_core(
            n, load.kind, conns, draws,
            t["offered_qps"], t["pace_gap"], t["offered_qps"], t0, conn_t0,
            visits_pc=t["visits_pc"],
            nominal_gap=t["nominal_gap"] if closed else None,
            phase_windows=t["phase_windows"],
            cpu_scale=cpu_scale,
            err_scale=t.get("err_scale"),
        )
        out = res
        if inject is not None:
            out = inject(out)
        if armed:
            out = summary_mod.summarize(out)
    return Pilot(log, n, out, seeds)


def out_values(log: OpLog, out) -> List[Tuple[str, int]]:
    """``(field, value id)`` of each tensor leaf of a NamedTuple output,
    in field order (``None`` fields skipped)."""
    pairs = []
    for name in type(out)._fields:
        x = getattr(out, name)
        if isinstance(x, torch.Tensor):
            pairs.append((name, log.read(x)))
    return pairs
