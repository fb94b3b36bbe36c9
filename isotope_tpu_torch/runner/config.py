"""Experiment configuration.

TOML schema follows the reference's ``isotope/example-config.toml`` where
it maps onto simulation (topology_paths, environments, client
qps/duration/num_concurrent_connections); the cluster/istio/image blocks —
GKE deployment detail — are replaced by a ``[sim]`` block (model
parameters, seed, mesh shape) and per-environment overlays.

Environments: the reference runs each topology twice, bare ("NONE") and
meshed ("ISTIO", Envoy sidecars injected around every pod,
kubernetes.go:150-157).  The simulator models the mesh as extra per-edge
latency and per-hop proxy CPU — both explicit, overridable knobs.

A copy of ``isotope_tpu.runner.config``: the environments, the
``ExperimentConfig`` fields and ``load_toml`` with its ``[[chaos]]``
(bounce shorthand, ``drain``), ``[[churn]]``, ``[mtls]`` and environment
overlays give the reference's values.  The keys that need the fleet and
search modules (``ensemble_jitter``, ``ensemble_chaos_jitter``,
``ensemble_split``, ``[search]`` candidates and jitter, and the spec
constructors of an armed ensemble or search) raise ``NotImplementedError``
naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import pathlib

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11: the tomli backport is the
    import tomli as tomllib  # same parser under its pre-stdlib name
from typing import Dict, List, Optional, Tuple

from isotope_tpu_torch.models.errors import config_path
from isotope_tpu_torch.sim.config import (
    ChaosEvent,
    MtlsSchedule,
    bounce_schedule,
    LoadModel,
    SimParams,
    TrafficSplit,
)
from isotope_tpu_torch.utils import duration as dur


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to isotope_tpu_torch yet "
        "(ROADMAP.md queue 1: fleets)"
    )


# One Envoy traversal, one way — the per-pass tax underlying the
# baseline-vs-sidecar deltas of the twopods benchmarks
# (perf/benchmark/README.md's mode comparisons).
DEFAULT_PROXY_LATENCY_S = 250e-6


@dataclasses.dataclass(frozen=True)
class EnvironmentModel:
    """How an environment (service mesh flavor) perturbs the data plane.

    Models the reference's 5-way sidecar-mode matrix
    (perf/benchmark/runner/runner.py:93-99 port table, :178-197
    mode -> URI) as direction-aware per-edge proxy passes:

    - ``client_proxy``: the *caller's* outbound Envoy on every edge
      (fortio client included) — the "clientsidecar" mode;
    - ``server_proxy``: the *callee's* inbound Envoy on every edge —
      "serversidecar";
    - both flags -> "both"; neither -> "baseline";
    - ``gateway``: entry traffic traverses the ingress gateway (an
      extra Envoy on the client -> entrypoint edge only) — "ingress".

    Each pass adds ``proxy_latency_s`` to the edge's one-way latency in
    both directions (Envoy sits on the request and response path).
    ``extra_hop_latency_s`` is a free-form additional per-edge tax for
    custom environments.
    """

    name: str
    client_proxy: bool = False
    server_proxy: bool = False
    gateway: bool = False
    proxy_latency_s: float = DEFAULT_PROXY_LATENCY_S
    # extra one-way per-edge latency on top of the proxy passes
    extra_hop_latency_s: float = 0.0

    def apply(self, params: SimParams) -> SimParams:
        passes = int(self.client_proxy) + int(self.server_proxy)
        extra = self.extra_hop_latency_s + passes * self.proxy_latency_s
        entry_extra = self.proxy_latency_s if self.gateway else 0.0
        if not extra and not entry_extra:
            return params
        net = params.network
        return dataclasses.replace(
            params,
            network=dataclasses.replace(
                net,
                base_latency_s=net.base_latency_s + extra,
                entry_extra_latency_s=(
                    net.entry_extra_latency_s + entry_extra
                ),
            ),
        )


# The reference's sidecar-mode matrix (runner.py:93-99), plus the
# NONE/ISTIO pair of isotope's run_tests.py (aliases of baseline/both).
DEFAULT_ENVIRONMENTS = {
    "NONE": EnvironmentModel(name="NONE"),
    "ISTIO": EnvironmentModel(
        name="ISTIO", client_proxy=True, server_proxy=True
    ),
    "baseline": EnvironmentModel(name="baseline"),
    "clientsidecar": EnvironmentModel(
        name="clientsidecar", client_proxy=True
    ),
    "serversidecar": EnvironmentModel(
        name="serversidecar", server_proxy=True
    ),
    "both": EnvironmentModel(
        name="both", client_proxy=True, server_proxy=True
    ),
    "ingress": EnvironmentModel(
        name="ingress", server_proxy=True, gateway=True
    ),
}


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    topology_paths: Tuple[str, ...]
    environments: Tuple[EnvironmentModel, ...]
    qps: Tuple[Optional[float], ...]     # None == "max"
    connections: Tuple[int, ...]
    duration_s: float
    load_kind: str = "closed"            # fortio's default mode
    # the load-generator identity axis of the reference's benchmark
    # matrix: "fortio" (closed-loop workers, runner.py:255-268) or
    # "nighthawk" (open-loop, runner.py:270-316); flows into the suite
    # publish id `<date>_<loadgen>_<branch>_<ver>`
    loadgen: str = "fortio"
    num_requests: int = 100_000
    seed: int = 0
    cpu_time_s: float = SimParams().cpu_time_s
    service_time: str = SimParams().service_time
    service_time_param: float = SimParams().service_time_param
    mesh_data: int = 0                   # 0 => all devices
    mesh_svc: int = 1
    # explicit mesh spec (CLI --mesh / TOML [sim] mesh / $ISOTOPE_MESH):
    # "auto" (cost-model layout search, parallel/layout.py),
    # "DATAxSVC[xSLICE]", or "data=4,svc=2,slice=1".  Overrides the
    # legacy mesh_data/mesh_svc pair when set.
    mesh_spec: Optional[str] = None
    # collective/compute overlap on sharded runs (SimParams.overlap):
    # merge collectives pipeline one block behind the event sweeps
    overlap: bool = False
    labels: str = ""
    chaos: Tuple[ChaosEvent, ...] = ()
    churn: Tuple[TrafficSplit, ...] = ()
    mtls: Optional[MtlsSchedule] = None
    # entrypoint override: pick one instance of a multi-entry topology
    # (replicate_topology); None = the graph's first entrypoint
    entry: Optional[str] = None
    # critical-path blame attribution (metrics/attribution.py): arms
    # SimParams.attribution so the runner's attributed pass can reduce
    # per-service blame on device (--attribution[=tail])
    attribution: bool = False
    # simulation flight recorder (metrics/timeline.py): arms
    # SimParams.timeline so the runner's timeline pass can accumulate
    # windowed series on device (--timeline[=<window>])
    timeline: bool = False
    timeline_window_s: float = SimParams().timeline_window_s
    # in-graph resilience policies (sim/policies.py): when True, the
    # topology's `policies:` block compiles to per-service tables and
    # the MAIN run co-simulates the breaker / retry-budget /
    # autoscaler control loop inside the block scan (--policies /
    # TOML [sim] policies = true).  Implies the timeline recorder (the
    # control loop's observation side).
    policies: bool = False
    # reactive canary rollouts (sim/rollout.py): when True, the
    # topology's `rollouts:` block compiles to per-service step
    # schedules and the MAIN run co-simulates the progressive-delivery
    # controller (canary traffic splits as scan-carry state, PROMOTE /
    # HOLD / ROLLBACK from the per-version window signals) inside the
    # block scan (--rollouts / TOML [sim] rollouts = true).  Implies
    # the timeline recorder, like policies.
    rollouts: bool = False
    # scenario ensembles (sim/ensemble.py): N > 0 runs every
    # unprotected case as a Monte Carlo fleet of N seed members in ONE
    # jitted program per device (--ensemble N / TOML [sim] ensemble),
    # reporting the pooled summary plus a `<label>.ensemble.json`
    # artifact with quantile bands and SLO-violation probabilities.
    # 0 (the default) leaves every run byte-identical to the solo path.
    ensemble: int = 0
    # per-member lognormal jitters (log-space sigma; see
    # EnsembleSpec.from_jitter) — the seed-jitter spec of
    # `--ensemble-jitter qps=0.1,cpu=0.05,error=0.2`
    ensemble_qps_jitter: float = 0.0
    ensemble_cpu_jitter: float = 0.0
    ensemble_error_jitter: float = 0.0
    ensemble_jitter_seed: int = 0
    # the SLO latency (seconds) the ensemble artifact's P(violation)
    # estimate is computed against; None omits the estimate
    ensemble_slo_s: Optional[float] = None
    # per-member chaos schedules (chaos fleets): a
    # resilience/faults.ChaosJitterSpec spec string
    # ("time=0.2,magnitude=0.5,target=0.3,seed=K") jittering each
    # fleet member's kill timing / target / magnitude; None keeps the
    # base schedule on every member (--ensemble-chaos-jitter /
    # TOML [sim] ensemble_chaos_jitter)
    ensemble_chaos_jitter: Optional[str] = None
    # importance splitting (sim/splitting.py): a SplitSpec string
    # ("levels=4,members=64,keep=0.25,threshold=0.5,sev=err_peak")
    # arming the rare-outage estimator per ensemble case; the result
    # lands behind `<label>.ensemble.json`'s schema-versioned
    # "splitting" key (--ensemble-split / TOML [sim] ensemble_split)
    ensemble_split: Optional[str] = None
    # the splitting screening-horizon fraction: overrides the
    # spec string's ``horizon=`` key so sweeps can tune how much of
    # the case's request count each splitting level simulates
    # (--split-horizon / TOML [sim] ensemble_split_horizon); None
    # defers to the spec string (default 0.25)
    ensemble_split_horizon: Optional[float] = None
    # config search (sim/search.py): candidates > 0 arms a
    # successive-halving bracket per case (TOML [search] block),
    # writing a `<label>.search.json` isotope-search/v1 artifact with
    # the per-rung survivor lineage and the winning candidate
    search_candidates: int = 0
    search_eta: int = 4
    search_rungs: int = 3
    search_growth: Optional[int] = None
    search_rank: str = "err_share"
    search_slo_s: Optional[float] = None
    # the population's jitter spec ("qps=0.2,cpu=0.1,error=0.3[,seed=K]")
    search_jitter: Optional[str] = None
    search_seed: int = 0
    # trace-driven provenance (ingest/): the raw informational
    # ``[ingest]`` table an `isotope-tpu ingest` run wrote into the
    # TOML (label, entry, window count, qps band).  None for
    # hand-written configs; when set, the runner stamps the rows so
    # fitted-replay measurements are never compared against
    # hand-written twins (run.py `_ingest` marker).
    ingest: Optional[dict] = None

    def sim_params(self) -> SimParams:
        return SimParams(
            cpu_time_s=self.cpu_time_s,
            service_time=self.service_time,
            service_time_param=self.service_time_param,
            attribution=self.attribution,
            # the policy/rollout co-sims observe through the recorder
            timeline=self.timeline or self.policies or self.rollouts,
            timeline_window_s=self.timeline_window_s,
            overlap=self.overlap,
            ensemble=max(int(self.ensemble), 0),
        )

    def ensemble_spec(self):
        """None when the ensemble axis is off; an armed ensemble raises
        (the fleets are not ported)."""
        if self.ensemble <= 0:
            return None
        raise _unported("scenario ensembles (sim/ensemble.py)")

    def chaos_jitter_spec(self):
        """None when the chaos jitter is off or no chaos schedule
        exists to jitter; an armed jitter raises (not ported)."""
        if not self.ensemble_chaos_jitter or not self.chaos:
            return None
        raise _unported("chaos jitter (resilience/faults.py)")

    def split_spec(self):
        """None when importance splitting is off; an armed split
        raises (not ported)."""
        if not self.ensemble_split:
            return None
        raise _unported("importance splitting (sim/splitting.py)")

    def search_spec(self):
        """None when the search axis is off; an armed search raises
        (not ported)."""
        if self.search_candidates <= 0:
            return None
        raise _unported("config search (sim/search.py)")

    def load_models(self):
        for conn in self.connections:
            for qps in self.qps:
                yield LoadModel(
                    kind=self.load_kind,
                    qps=qps,
                    connections=conn,
                    duration_s=self.duration_s,
                )


def _parse_qps(value) -> Optional[float]:
    if value == "max":
        return None
    return float(value)


def load_toml(path) -> ExperimentConfig:
    path = pathlib.Path(path)
    with open(path, "rb") as f:
        doc = tomllib.load(f)
    # topology paths resolve relative to the config file, not the cwd
    base = path.parent
    doc["topology_paths"] = [
        str(p if (p := pathlib.Path(raw)).is_absolute() else base / p)
        for raw in doc.get("topology_paths", ())
    ]

    envs: List[EnvironmentModel] = []
    env_overrides: Dict[str, dict] = doc.get("environment", {})
    for name in doc.get("environments", ["NONE"]):
        if name in env_overrides:
            o = env_overrides[name]
            if set(o) == {"extra_hop_latency"}:
                # legacy knob alone: REPLACES the whole tax (the
                # pre-matrix semantics), so existing configs that tuned
                # e.g. ISTIO via extra_hop_latency keep their numbers
                # instead of silently stacking on the proxy passes
                envs.append(
                    EnvironmentModel(
                        name=name,
                        extra_hop_latency_s=dur.parse_duration_seconds(
                            o["extra_hop_latency"]
                        ),
                    )
                )
                continue
            default_env = DEFAULT_ENVIRONMENTS.get(
                name, EnvironmentModel(name=name)
            )
            envs.append(
                dataclasses.replace(
                    default_env,
                    name=name,
                    client_proxy=bool(
                        o.get("client_proxy", default_env.client_proxy)
                    ),
                    server_proxy=bool(
                        o.get("server_proxy", default_env.server_proxy)
                    ),
                    gateway=bool(o.get("gateway", default_env.gateway)),
                    proxy_latency_s=(
                        dur.parse_duration_seconds(o["proxy_latency"])
                        if "proxy_latency" in o
                        else default_env.proxy_latency_s
                    ),
                    extra_hop_latency_s=(
                        dur.parse_duration_seconds(o["extra_hop_latency"])
                        if "extra_hop_latency" in o
                        else default_env.extra_hop_latency_s
                    ),
                )
            )
        elif name in DEFAULT_ENVIRONMENTS:
            envs.append(DEFAULT_ENVIRONMENTS[name])
        else:
            raise ValueError(
                f"unknown environment {name!r}: define an [environment."
                f"{name}] block"
            )

    client = doc.get("client", {})
    with config_path("client.qps"):
        qps_raw = client.get("qps", "max")
        qps_list = (
            [_parse_qps(q) for q in qps_raw]
            if isinstance(qps_raw, list)
            else [_parse_qps(qps_raw)]
        )
    with config_path("client.num_concurrent_connections"):
        conns_raw = client.get("num_concurrent_connections", 64)
        conns = (
            [int(c) for c in conns_raw]
            if isinstance(conns_raw, list)
            else [int(conns_raw)]
        )

    chaos: List[ChaosEvent] = []
    for i, ev in enumerate(doc.get("chaos", [])):
        with config_path(f"chaos[{i}]"):
            down = ev.get("replicas_down", "all")
            down_n = None if down == "all" else int(down)
            drain = bool(ev.get("drain", True))
            with config_path("start"):
                start = dur.parse_duration_seconds(ev["start"])
            with config_path("end"):
                end = dur.parse_duration_seconds(ev["end"])
            if "period" in ev or "repeat" in ev:
                # rolling-restart shorthand (gateway-bouncer): repeat
                # the [start, end) window every `period` for `repeat`
                # cycles
                if "period" not in ev:
                    raise ValueError(
                        f"[[chaos]] block for {ev['service']!r} sets "
                        "'repeat' without 'period'"
                    )
                chaos.extend(
                    bounce_schedule(
                        service=ev["service"],
                        period_s=dur.parse_duration_seconds(
                            ev["period"]
                        ),
                        down_s=end - start,
                        count=int(ev.get("repeat", 1)),
                        start_s=start,
                        replicas_down=down_n,
                        drain=drain,
                    )
                )
            else:
                chaos.append(
                    ChaosEvent(
                        service=ev["service"],
                        start_s=start,
                        end_s=end,
                        replicas_down=down_n,
                        drain=drain,
                    )
                )

    # [[churn]]: the config-churner analogue (rotating traffic weights)
    churn: List[TrafficSplit] = []
    for i, ts in enumerate(doc.get("churn", [])):
        with config_path(f"churn[{i}]"):
            churn.append(
                TrafficSplit(
                    service=ts["service"],
                    period_s=dur.parse_duration_seconds(ts["period"]),
                    weights=tuple(float(w) for w in ts["weights"]),
                )
            )

    # [mtls]: the auto-mTLS switching analogue — a schedule of per-edge
    # one-way taxes cycled every `period` (perf/load/auto-mtls/scale.py)
    mtls = None
    if "mtls" in doc:
        m = doc["mtls"]
        with config_path("mtls"):
            mtls = MtlsSchedule(
                period_s=dur.parse_duration_seconds(m["period"]),
                taxes_s=tuple(
                    dur.parse_duration_seconds(x) if isinstance(x, str)
                    else float(x)
                    for x in m["taxes"]
                ),
            )

    # loadgen axis: fortio is closed-loop by default, nighthawk is the
    # open-loop generator (runner.py:270-316 builds a distinct
    # invocation; it has no closed-loop mode)
    loadgen = client.get("loadgen", "fortio")
    if loadgen not in ("fortio", "nighthawk"):
        raise ValueError(
            f"unknown loadgen {loadgen!r} (choose fortio or nighthawk)"
        )
    default_kind = "open" if loadgen == "nighthawk" else "closed"
    load_kind = client.get("load_kind", default_kind)
    if loadgen == "nighthawk" and load_kind != "open":
        raise ValueError(
            "nighthawk is an open-loop generator; drop load_kind or "
            "set it to \"open\" (runner.py:270-316)"
        )

    sim = doc.get("sim", {})
    defaults = SimParams()
    return ExperimentConfig(
        topology_paths=tuple(doc.get("topology_paths", ())),
        environments=tuple(envs),
        qps=tuple(qps_list),
        connections=tuple(conns),
        duration_s=dur.parse_duration_seconds(client.get("duration", "5m")),
        load_kind=load_kind,
        loadgen=loadgen,
        num_requests=int(sim.get("num_requests", 100_000)),
        seed=int(sim.get("seed", 0)),
        cpu_time_s=(
            dur.parse_duration_seconds(sim["cpu_time"])
            if "cpu_time" in sim
            else defaults.cpu_time_s
        ),
        service_time=sim.get("service_time", defaults.service_time),
        service_time_param=float(
            sim.get("service_time_param", defaults.service_time_param)
        ),
        mesh_data=int(sim.get("mesh_data", 0)),
        mesh_svc=int(sim.get("mesh_svc", 1)),
        mesh_spec=sim.get("mesh"),
        overlap=bool(sim.get("overlap", False)),
        labels=doc.get("labels", ""),
        chaos=tuple(chaos),
        churn=tuple(churn),
        mtls=mtls,
        entry=sim.get("entry"),
        timeline=bool(sim.get("timeline", False)),
        timeline_window_s=(
            dur.parse_duration_seconds(sim["timeline_window"])
            if "timeline_window" in sim
            else SimParams().timeline_window_s
        ),
        policies=bool(sim.get("policies", False)),
        rollouts=bool(sim.get("rollouts", False)),
        **_ensemble_kwargs(sim),
        **_search_kwargs(doc.get("search", {})),
        ingest=(
            dict(doc["ingest"])
            if isinstance(doc.get("ingest"), dict) else None
        ),
    )


def _ensemble_kwargs(sim: dict) -> dict:
    """The ``[sim]`` ensemble keys: ``ensemble = N`` (member count),
    ``ensemble_jitter = "qps=0.1,cpu=0.05,error=0.2[,seed=K]"`` (the
    per-member perturbation spec), ``ensemble_slo = "250ms"`` (the SLO
    the artifact's P(violation) estimate targets)."""
    out: dict = {"ensemble": int(sim.get("ensemble", 0))}
    if "ensemble_jitter" in sim:
        with config_path("sim.ensemble_jitter"):
            raise _unported("ensemble jitter specs (sim/ensemble.py)")
    if "ensemble_slo" in sim:
        with config_path("sim.ensemble_slo"):
            out["ensemble_slo_s"] = dur.parse_duration_seconds(
                sim["ensemble_slo"]
            )
    if "ensemble_chaos_jitter" in sim:
        with config_path("sim.ensemble_chaos_jitter"):
            raise _unported("chaos jitter (resilience/faults.py)")
    if "ensemble_split" in sim:
        with config_path("sim.ensemble_split"):
            raise _unported("importance splitting (sim/splitting.py)")
    if "ensemble_split_horizon" in sim:
        with config_path("sim.ensemble_split_horizon"):
            h = float(sim["ensemble_split_horizon"])
            if not 0.0 < h <= 1.0:
                raise ValueError(
                    "ensemble_split_horizon must lie in (0, 1]"
                )
        out["ensemble_split_horizon"] = h
    return out


def _search_kwargs(search: dict) -> dict:
    """The ``[search]`` block: ``candidates = N`` arms a
    successive-halving bracket per case; ``eta``/``rungs``/``growth``
    shape the bracket, ``rank`` picks the severity channel
    (``err_share`` | ``err_peak`` | ``p99``; ``slo = "250ms"``
    anchors p99), ``jitter`` draws the population and ``seed``
    derives the rank tie-breaks.  Specs validate eagerly — a typo'd
    block must fail at config load, not mid-sweep."""
    if not search:
        return {}
    known = {"candidates", "eta", "rungs", "growth", "rank", "slo",
             "jitter", "seed"}
    unknown = sorted(set(search) - known)
    if unknown:
        with config_path("search"):
            raise ValueError(
                f"unknown [search] keys {unknown} (expected "
                f"{sorted(known)})"
            )
    out: dict = {
        "search_candidates": int(search.get("candidates", 0)),
        "search_eta": int(search.get("eta", 4)),
        "search_rungs": int(search.get("rungs", 3)),
        "search_rank": str(search.get("rank", "err_share")),
        "search_seed": int(search.get("seed", 0)),
    }
    if "growth" in search:
        out["search_growth"] = int(search["growth"])
    if "slo" in search:
        with config_path("search.slo"):
            out["search_slo_s"] = dur.parse_duration_seconds(
                search["slo"]
            )
    if "jitter" in search:
        with config_path("search.jitter"):
            raise _unported("search population jitter (sim/ensemble.py)")
    if out["search_candidates"] > 0:
        with config_path("search"):
            raise _unported("config search (sim/search.py)")
    return out
