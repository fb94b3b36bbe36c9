"""Python front end of the exact DES fidelity oracle (native/des_oracle.cpp).

The oracle simulates the same physical system the analytic engine models —
FIFO k-replica stations, the reference executor's script semantics
(isotope/service/pkg/srv/executable.go:43-179), open/closed-loop load —
by exact event-driven simulation with **no** independence or stationarity
assumptions.  It is the ground truth for the north star's fidelity axis:
the engine's p50/p99 must track the oracle's (tests/test_torch_oracle.py;
ORACLE.md has the reference's measured error envelope).

Slow by design relative to the device engine (one event at a time on
the host CPU), but fast in absolute terms, so million-request
validation runs finish in seconds.

A copy of ``isotope_tpu.sim.oracle`` over the port's own copy of the C++
source (``isotope_tpu_torch/native/des_oracle.cpp``), built by
``native/host.py``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np

from isotope_tpu_torch.compiler.compile import _lower_script
from isotope_tpu_torch.models.graph import ServiceGraph
from isotope_tpu_torch.native.host import load_library
from isotope_tpu_torch.sim.config import (
    CLOSED_LOOP,
    OPEN_LOOP,
    SERVICE_TIME_DETERMINISTIC,
    SERVICE_TIME_EXPONENTIAL,
    SERVICE_TIME_LOGNORMAL,
    SERVICE_TIME_PARETO,
    ChaosEvent,
    LoadModel,
    SimParams,
)

_ST_KIND = {
    SERVICE_TIME_EXPONENTIAL: 0,
    SERVICE_TIME_DETERMINISTIC: 1,
    SERVICE_TIME_LOGNORMAL: 2,
    SERVICE_TIME_PARETO: 3,
}

_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _bind():
    lib = load_library("des_oracle")
    fn = lib.des_run
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_int32, _i32p, _f64p, _f64p,                 # services
        _i32p, _f64p, _i32p,                                 # script offsets
        ctypes.c_int32, ctypes.c_int32,                      # totals
        _i32p, _f64p, _f64p, _f64p, _i32p, _f64p, _f64p,     # calls
        ctypes.c_int32,                                      # entry
        ctypes.c_double, ctypes.c_double,                    # network
        ctypes.c_int32, ctypes.c_double, ctypes.c_double,    # service time
        ctypes.c_int32, _i32p, _f64p, _f64p, _i32p, _u8p,    # chaos
        ctypes.c_int32, ctypes.c_double, ctypes.c_int32,     # load
        ctypes.c_double,                                     # pace jitter
        ctypes.c_int64, ctypes.c_uint64,                     # n, seed
        _f64p, _f64p, _u8p, _f64p, _f64p,                    # outputs
        ctypes.POINTER(ctypes.c_int64),
    ]
    return fn


@dataclasses.dataclass(frozen=True)
class OracleResults:
    """Per-request ground truth from one oracle run."""

    client_start: np.ndarray    # (N,) send times
    client_latency: np.ndarray  # (N,) client-observed round trips
    client_error: np.ndarray    # (N,) bool
    busy_time: np.ndarray       # (S,) total CPU-seconds served per service
    arrivals: np.ndarray        # (S,) hop arrivals per service
    hop_events: int             # executed hops

    @property
    def client_end(self) -> np.ndarray:
        return self.client_start + self.client_latency

    def quantiles_s(self, qs=(0.5, 0.75, 0.9, 0.99, 0.999)) -> np.ndarray:
        return np.quantile(self.client_latency, qs)

    def steady_quantiles_s(
        self, qs=(0.5, 0.99), warmup_s: float = 0.0
    ) -> np.ndarray:
        """Quantiles over requests arriving after ``warmup_s`` — the
        oracle starts empty, so early requests see an underloaded system
        while the analytic engine samples the stationary law."""
        mask = self.client_start >= warmup_s
        return np.quantile(self.client_latency[mask], qs)

    def utilization(self, duration_s: float, replicas: np.ndarray):
        return self.busy_time / (np.asarray(replicas) * duration_s)


class OracleSimulator:
    """Lowers a ServiceGraph once; runs the native DES per load."""

    def __init__(
        self,
        graph: ServiceGraph,
        params: SimParams = SimParams(),
        chaos: Sequence[ChaosEvent] = (),
        entry: Optional[str] = None,
    ):
        self.graph = graph
        self.params = params
        if params.network.entry_extra_latency_s:
            # des_oracle.cpp models a uniform per-edge network; the
            # ingress gateway's entry-edge tax is engine-only for now
            raise ValueError(
                "the DES oracle does not model entry_extra_latency_s "
                "(ingress gateway environments); compare against an "
                "environment without a gateway"
            )
        names = tuple(s.name for s in graph.services)
        self.names = names
        idx = {n: i for i, n in enumerate(names)}
        if entry is None:
            eps = graph.entrypoints()
            if not eps:
                raise ValueError("service graph has no entrypoint")
            self._entry = idx[eps[0].name]
        else:
            self._entry = idx[entry]

        self.replicas = np.asarray(
            [max(1, s.num_replicas) for s in graph.services], np.int32
        )
        self._err = np.asarray(
            [float(s.error_rate) for s in graph.services], np.float64
        )
        self._resp = np.asarray(
            [float(int(s.response_size)) for s in graph.services], np.float64
        )

        # cross-cluster edge class (NetworkModel cross_cluster_*): a call
        # whose caller and callee have different ``cluster`` fields pays
        # the gateway extra and rides the cross bandwidth
        clusters = [getattr(s, "cluster", "") for s in graph.services]
        net = params.network
        cross_bps = net.cross_cluster_bytes_per_second or 0.0

        svc_step_off = [0]
        step_base: list = []
        step_call_off = [0]
        ct, cp, cs, cto, ca, cex, cbp = [], [], [], [], [], [], []
        for si, s in enumerate(graph.services):
            for step in _lower_script(s.script, idx):
                step_base.append(step.base)
                for call in step.calls:
                    ct.append(call.target)
                    cp.append(call.send_prob)
                    cs.append(call.size)
                    cto.append(
                        call.timeout if math.isfinite(call.timeout)
                        else math.inf
                    )
                    ca.append(call.attempts)
                    cross = clusters[si] != clusters[call.target]
                    cex.append(net.cross_cluster_latency_s if cross else 0.0)
                    cbp.append(cross_bps if cross else 0.0)
                step_call_off.append(len(ct))
            svc_step_off.append(len(step_base))
        self._svc_step_off = np.asarray(svc_step_off, np.int32)
        self._step_base = np.asarray(step_base, np.float64)
        self._step_call_off = np.asarray(step_call_off, np.int32)
        self._call_target = np.asarray(ct, np.int32)
        self._call_prob = np.asarray(cp, np.float64)
        self._call_size = np.asarray(cs, np.float64)
        self._call_timeout = np.asarray(cto, np.float64)
        self._call_attempts = np.asarray(ca, np.int32)
        self._call_extra = np.asarray(cex, np.float64)
        self._call_bps = np.asarray(cbp, np.float64)

        self._chaos_svc = np.asarray(
            [idx[ev.service] for ev in chaos], np.int32
        )
        self._chaos_start = np.asarray(
            [ev.start_s for ev in chaos], np.float64
        )
        self._chaos_end = np.asarray([ev.end_s for ev in chaos], np.float64)
        self._chaos_down = np.asarray(
            [-1 if ev.replicas_down is None else ev.replicas_down
             for ev in chaos],
            np.int32,
        )
        self._chaos_drain = np.asarray(
            [bool(ev.drain) for ev in chaos], np.uint8
        )
        self._fn = _bind()

    def run(
        self,
        load: LoadModel,
        num_requests: int,
        seed: int = 0,
        pace_jitter: float = 0.1,
    ) -> OracleResults:
        """``pace_jitter`` models fortio's always-on ``-jitter`` flag
        (perf/benchmark/runner/runner.py:255-268): each closed-loop pace
        gap is perturbed by +/-10% uniform, and paced connections start
        phase-staggered — the steady state of jittered periodic workers."""
        n = int(num_requests)
        S = len(self.names)
        out_start = np.empty(n, np.float64)
        out_lat = np.empty(n, np.float64)
        out_err = np.empty(n, np.uint8)
        out_busy = np.empty(S, np.float64)
        out_arr = np.empty(S, np.float64)
        out_hops = ctypes.c_int64(0)
        if load.kind == OPEN_LOOP:
            kind, qps, conns = 0, float(load.qps), 1
        elif load.kind == CLOSED_LOOP:
            kind = 1
            qps = float(load.qps) if load.qps is not None else 0.0
            conns = load.connections
        else:  # pragma: no cover - LoadModel validates
            raise ValueError(load.kind)
        net = self.params.network
        rc = self._fn(
            S, self.replicas, self._err, self._resp,
            self._svc_step_off, self._step_base, self._step_call_off,
            len(self._step_base), len(self._call_target),
            self._call_target, self._call_prob, self._call_size,
            self._call_timeout, self._call_attempts, self._call_extra,
            self._call_bps, self._entry,
            float(net.base_latency_s), float(net.bytes_per_second),
            _ST_KIND[self.params.service_time],
            float(self.params.cpu_time_s),
            float(self.params.service_time_param),
            len(self._chaos_svc), self._chaos_svc, self._chaos_start,
            self._chaos_end, self._chaos_down, self._chaos_drain,
            kind, qps, conns, float(pace_jitter), n, seed,
            out_start, out_lat, out_err, out_busy, out_arr,
            ctypes.byref(out_hops),
        )
        if rc != 0:
            raise RuntimeError(f"des_run failed with code {rc}")
        return OracleResults(
            client_start=out_start,
            client_latency=out_lat,
            client_error=out_err.astype(bool),
            busy_time=out_busy,
            arrivals=out_arr,
            hop_events=int(out_hops.value),
        )


def oracle_quantiles(
    yaml_text: str,
    load: LoadModel,
    num_requests: int,
    qs: Tuple[float, ...] = (0.5, 0.99),
    params: SimParams = SimParams(),
    seed: int = 0,
    warmup_s: float = 0.0,
) -> np.ndarray:
    """One-shot convenience used by the fidelity tests."""
    sim = OracleSimulator(ServiceGraph.from_yaml(yaml_text), params)
    res = sim.run(load, num_requests, seed)
    return res.steady_quantiles_s(qs, warmup_s)
