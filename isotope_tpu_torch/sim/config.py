"""Simulation parameters: service-time, network, and load models.

These are the knobs the reference distributes across deployment reality —
vCPU limits on the service pods (isotope/example-config.toml [server]),
cluster networking, and the Fortio command line
(perf/benchmark/runner/runner.py:255-268: ``fortio load -c C -qps Q -t
Ds``).  Here they are explicit, reproducible model parameters.

A copy of ``isotope_tpu.sim.config``: every field and default of
``SimParams``, ``NetworkModel`` and ``LoadModel`` is kept, so one
parameter set describes a run of either package.  The port honours the
fields of the physics it implements; the options of layers it has not
ported yet (attribution, timeline, ensembles) raise in the Simulator,
and the JAX executor switches (scan buckets, the Pallas census flag,
packed carries) have no effect here; ``overlap`` pipelines the merge
of ``parallel/sharded.py``'s mesh runs.  The chaos,
traffic-split and mTLS schedule types (``ChaosEvent``,
``bounce_schedule``, ``TrafficSplit``, ``MtlsSchedule``) are copied with
their validation and messages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


# The reference's mock service saturates at 12-14k QPS on one vCPU
# (isotope/service/README.md:28-34) => ~77 microseconds of CPU per request.
DEFAULT_CPU_TIME_S = 1.0 / 13_000.0

SERVICE_TIME_EXPONENTIAL = "exponential"
SERVICE_TIME_DETERMINISTIC = "deterministic"
SERVICE_TIME_LOGNORMAL = "lognormal"
SERVICE_TIME_PARETO = "pareto"


@dataclasses.dataclass(frozen=True)
class NetworkModel:
    """Per-edge network delay: base one-way latency + bytes / bandwidth.

    The reference's edges are kube-DNS-addressed HTTP/1.1 keep-alive hops
    through optional Envoy sidecars (srv/request.go:30-48); intra-cluster
    one-way latency is typically a few hundred microseconds and payloads
    ride ~10 Gbps NICs.

    ``entry_extra_latency_s`` is additional one-way latency on the
    client -> entrypoint edge only — the ingress-gateway traversal of
    the reference's "ingress" sidecar mode (runner.py:96,190-197).

    ``cross_cluster_latency_s`` / ``cross_cluster_bytes_per_second``
    form the cross-cluster edge class: the reference splits one service
    graph across cluster1/cluster2 (+ VMs) so cross-cluster calls
    traverse an egress gateway, inter-cluster network, and the remote
    ingress gateway (perf/load/templates/service-graph.gen.yaml:1-3,
    common.sh:36-42).  Edges between services with different
    ``cluster`` fields pay the extra one-way latency and ride the
    (usually lower) cross-cluster bandwidth; ``None`` bandwidth means
    same as intra-cluster.
    """

    base_latency_s: float = 250e-6
    bytes_per_second: float = 1.25e9  # 10 Gbit/s
    entry_extra_latency_s: float = 0.0
    cross_cluster_latency_s: float = 1e-3
    cross_cluster_bytes_per_second: Optional[float] = None

    def one_way(self, size_bytes):
        return self.base_latency_s + size_bytes / self.bytes_per_second

    def entry_one_way(self, size_bytes):
        return self.one_way(size_bytes) + self.entry_extra_latency_s


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Model parameters fixed at trace time."""

    cpu_time_s: float = DEFAULT_CPU_TIME_S
    # "exponential" matches the M/M/k queue model exactly (closed-form
    # validation); "deterministic" uses the fixed CPU demand (an M/D/k
    # approximation sampled with M/M/k waits); "lognormal" / "pareto" are
    # heavy-tail mixtures (BASELINE.json configs[4]) with the same mean —
    # ``service_time_param`` is sigma (log-space) resp. the tail index
    # alpha (> 1).
    service_time: str = SERVICE_TIME_EXPONENTIAL
    service_time_param: float = 1.0
    network: NetworkModel = NetworkModel()
    # Gaussian-copula correlation between the queueing-wait draws of
    # concurrent sibling hops.  Parallel stations fed by the same arrival
    # epochs have positively correlated backlogs, and correlated maxima
    # are smaller than independent ones — with iid draws the engine
    # overestimates fork-join p50 by ~6% at rho 0.7.  The normal-scores
    # correlation of two queues driven by a common Poisson stream is
    # ~0.4 nearly independent of rho (measured by Lindley recursion;
    # see ORACLE.md), and r=0.4 brings fork-join quantiles within ~1%
    # of the DES oracle.  0 disables (iid draws, exact for chains).
    sibling_copula_r: float = 0.4
    # Extra correlation among the serial RETRY attempts of one call, on
    # top of the sibling term: attempt n+1 re-enters the same station
    # milliseconds after attempt n timed out, so it sees nearly the same
    # backlog — with independent draws the engine misses the
    # timeout-cascade tail entirely (one timeout predicts the next).
    # Total attempt-attempt correlation = sibling_copula_r +
    # retry_copula_r; fit against the DES oracle (ORACLE.md).
    retry_copula_r: float = 0.5
    # Hierarchical decay of the sibling copula across the GROUP tree
    # (open loop only): two hops whose sibling groups share their
    # lowest common ancestor L levels up correlate at
    # sibling_copula_r * gamma^L — same-depth groups only, so serial
    # path sums stay independent (a parent-child term inflates the p99
    # tail; see engine).  gamma=0 recovers the flat within-group-only
    # copula.  Fork-join subtrees are fed by the same upstream
    # arrivals, so COUSIN subtree compositions correlate too — the
    # flat copula missed that, leaving tree13 p50 +7.9% at rho=0.9
    # (ORACLE.md r4 "known out-of-envelope" #1); 0.9 measured: +4.1%
    # p50 / +2.1% p99 at rho=0.9, monotone improvements at 0.3-0.85,
    # saturated sampler untouched.  Fit against the DES oracle like r.
    # SCOPE (ADVICE r5): only MULTI-MEMBER sibling groups — real
    # concurrent fan-outs / retry fans — join the hierarchy; singleton
    # groups (sequential single calls) keep their flat independent
    # factor, so r * gamma^L is NOT applied between a fan-out and a
    # same-depth single-call cousin on mixed sequential/concurrent
    # graphs.  Deliberate: a dense factor row per singleton group
    # captured ~7 GB of constants on a 30k-hop sequential graph (see
    # engine), and a singleton's own wait has no within-group
    # correlation to transfer in the first place.
    hierarchical_copula_gamma: float = 0.9
    # Dense-grid element threshold above which a skewed level (grid
    # > 4x its real call-step count) leaves the dense step grid — the
    # star-10k mitigation.  Lower it to force the non-dense path on
    # small graphs (tests).
    sparse_level_elems: int = 262_144
    # Dense-blocked sparse levels (sim/joins.TiledJoin): a level past
    # the sparse threshold is partitioned into fixed-width dense tiles
    # (hops binned by script-width class, padded to the bin's widest
    # script — compiler/buckets.plan_tiles) executed with the exact
    # dense step-grid ops restricted to each bin; only scripts wider
    # than ``sparse_tile_pmax`` keep the true sparse call-slot
    # encoding as a residual.  Bit-identical to the dense grid in
    # eager, <= 1 ULP under jit (tests/test_sparse_tiles.py); off
    # falls back to the pure sparse encoding everywhere.
    sparse_tiling: bool = True
    sparse_tile_pmax: int = 64
    # Pallas census kernel (native/census_pallas.py): fuse the per-step
    # census / WaitGroup-max join (max with the sleep floor, step mask,
    # busy row-sum, exclusive step prefix — today a chain of XLA ops)
    # into one hand-written kernel.  None = auto: on for TPU backends,
    # off elsewhere (the CPU interpreter-mode kernel is for equivalence
    # tests, not speed).  False reproduces today's op-by-op path
    # exactly; True forces the kernel (interpreter mode off-TPU).
    pallas_census: Optional[bool] = None
    # Pack the census/blame carries where the <= 1 ULP pins allow:
    # attribution hop counters / blame-histogram censuses accumulate as
    # int32 (exact where f32 loses integers past 2^24) and the census
    # kernel's step mask rides as bf16 (0/1 exact).  Latency/blame
    # accumulators stay f32.  Attribution off is byte-identical either
    # way (the packing only touches attributed programs).  BOUND: any
    # single attributed run must keep every counter under 2^31 events
    # (int32 wraps where f32 merely lost precision; int64 needs the
    # globally-disabled x64 mode) — for longer soaks set
    # ``packed_carries=False`` or split the run.
    packed_carries: bool = True
    # Bucket scheduling discipline (compiler/buckets.plan_segments):
    # "critical-path" partitions each scan-eligible run by a DP
    # minimizing the summed per-segment critical-path cost (dispatch
    # overhead + padded elements); "greedy" is the historical
    # left-to-right maximal extension.
    bucket_schedule: str = "critical-path"
    # Bucketed level-scan executor (sim/levelscan.py): consecutive
    # depth levels with close shapes are padded to shared bounds and
    # swept by ONE lax.scan body per bucket, so trace/HLO size is
    # O(buckets) instead of O(depth) — the large-graph compile-wall
    # fix.  ``level_bucket_waste`` caps the padded/real element ratio
    # a bucket may cost (compiler/buckets.py); raise it to force wider
    # buckets (tests do), set ``bucketed_scan=False`` to fall back to
    # the fully unrolled trace.  Results are bit-identical either way.
    bucketed_scan: bool = True
    level_bucket_waste: float = 1.6
    # Critical-path blame attribution (metrics/attribution.py): when
    # True, ``Simulator.run_attributed`` accumulates per-hop blame
    # vectors + per-service blame histograms inside the block scan (and
    # the sharded psum merge).  Off (default) leaves every summary path
    # byte-identical — pinned by tests/test_attribution.py.
    attribution: bool = False
    # top-K slowest requests whose per-hop vectors are mined on device
    # (O(K * H)) and fed to the trace exporters as tail exemplars
    attribution_top_k: int = 8
    # the conditional-tail cut quantile estimated by the pilot pass in
    # ``--attribution=tail`` mode (p99 by default)
    attribution_tail_quantile: float = 0.99
    # Simulation flight recorder (metrics/timeline.py): when True,
    # ``Simulator.run_timeline`` bins every hop event into fixed
    # sim-time windows inside the block scan and accumulates
    # per-service x per-window series (O(S * W) carries, psum-merged
    # across shards).  Off (default) leaves every summary path
    # byte-identical — pinned like attribution.
    timeline: bool = False
    # window width in sim seconds — the scrape interval the reference's
    # Prometheus collection used against the mock services
    timeline_window_s: float = 10.0
    # hard cap on the window count; the planner widens windows (with a
    # warning) instead of letting the O(S * W) carries OOM the device
    timeline_max_windows: int = 256
    # Collective/compute overlap (parallel/sharded.py): when True, the
    # sharded runner issues each block's summary-merge collectives
    # INSIDE the block loop, one block late — block k's all-reduce /
    # reduce-scatter results are consumed while block k+1 computes, so
    # cross-host merge latency hides behind the next block's event
    # sweep.  Off (default) keeps the historical single
    # post-scan merge byte-identical; on matches off exactly on
    # integer-valued fields and to reduction-order f32 noise on float
    # sums (tests/test_multihost.py).  SCOPE: the plain summary path
    # (ShardedSimulator.run) only — the attributed/timeline diagnostic
    # passes keep their single post-scan merge (their O(K*H)/O(S*W)
    # leaves merge once), and single-device Simulator runs ignore it
    # (there is no collective to overlap).
    overlap: bool = False
    # Scenario ensembles (sim/ensemble.py): the default Monte Carlo
    # fleet size of ``Simulator.run_ensemble`` when no explicit
    # EnsembleSpec is passed — N scenario variants (seeds, and
    # optionally qps/cpu/error-rate perturbations) run as ONE jitted
    # program per device with a leading member axis (jax.vmap), the
    # way the TPU Ising idiom batches independent lattices.  0 (the
    # default) leaves every existing entry point byte-identical: the
    # solo paths never see the member axis, and member k of a
    # seeds-only ensemble is bit-identical to a solo run with
    # ``fold_in(key, seeds[k])`` (tests/test_ensemble.py).
    ensemble: int = 0

    def __post_init__(self):
        if self.service_time not in (
            SERVICE_TIME_EXPONENTIAL,
            SERVICE_TIME_DETERMINISTIC,
            SERVICE_TIME_LOGNORMAL,
            SERVICE_TIME_PARETO,
        ):
            raise ValueError(f"unknown service_time: {self.service_time!r}")
        if self.cpu_time_s <= 0:
            raise ValueError("cpu_time_s must be positive")
        if self.service_time == SERVICE_TIME_PARETO and (
            self.service_time_param <= 1.0
        ):
            raise ValueError("pareto tail index alpha must be > 1 for a "
                             "finite mean")
        if self.service_time == SERVICE_TIME_LOGNORMAL and (
            self.service_time_param <= 0.0
        ):
            raise ValueError("lognormal sigma must be positive")
        if not 0.0 <= self.sibling_copula_r < 1.0:
            raise ValueError("sibling_copula_r must be in [0, 1)")
        if not 0.0 <= self.retry_copula_r < 1.0:
            raise ValueError("retry_copula_r must be in [0, 1)")
        if self.level_bucket_waste < 1.0:
            raise ValueError("level_bucket_waste must be >= 1")
        if self.sparse_tile_pmax < 1:
            raise ValueError("sparse_tile_pmax must be >= 1")
        if self.bucket_schedule not in ("critical-path", "greedy"):
            raise ValueError(
                f"unknown bucket_schedule: {self.bucket_schedule!r} "
                "(expected 'critical-path' or 'greedy')"
            )
        if self.attribution_top_k < 0:
            raise ValueError("attribution_top_k must be >= 0")
        if not 0.0 < self.attribution_tail_quantile < 1.0:
            raise ValueError(
                "attribution_tail_quantile must lie in (0, 1)"
            )
        if self.timeline_window_s <= 0.0:
            raise ValueError("timeline_window_s must be positive")
        if self.timeline_max_windows < 1:
            raise ValueError("timeline_max_windows must be >= 1")
        if self.ensemble < 0:
            raise ValueError("ensemble must be >= 0 (0 = off)")
        # (sibling_copula_r + retry_copula_r < 1 is required only for
        # hops inside a multi-attempt call; the Simulator enforces it
        # when such calls exist)


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """Kill replicas of a service during a time window.

    The simulation analogue of the reference's chaos CronJobs
    (perf/stability/istio-chaos-partial kills all-but-one replica every
    interval; istio-chaos-total scales components to zero and restores
    them after chaosDurationMinutes).  ``replicas_down=None`` means all
    replicas (total outage: callers get transport errors, which — unlike
    downstream 500s — DO propagate, srv/handler.go:66-76).

    ``drain`` selects the shutdown policy at the window's start — the
    axis the reference's graceful-shutdown stability test exercises
    (perf/stability/graceful-shutdown: a long in-flight request across
    a replica kill):

    - ``True`` (default, graceful): killed replicas finish their
      in-flight requests; only *new* work sees the reduced capacity
      (Kubernetes' default terminationGracePeriod behavior).
    - ``False`` (ungraceful): requests resident on a killed replica at
      the kill instant die with a connection reset — a transport error
      at their caller.  Each resident request dies with probability
      ``replicas_down / alive-replicas-before-the-kill``.
    """

    service: str
    start_s: float
    end_s: float
    replicas_down: Optional[int] = None  # None == all
    drain: bool = True

    def __post_init__(self):
        if self.end_s <= self.start_s:
            raise ValueError("chaos window must have end_s > start_s")
        if self.start_s < 0:
            raise ValueError("chaos window must start at t >= 0")
        if self.replicas_down is not None and self.replicas_down <= 0:
            raise ValueError("replicas_down must be positive (or None=all)")


def bounce_schedule(
    service: str,
    period_s: float,
    down_s: float,
    count: int,
    start_s: float = 0.0,
    replicas_down: Optional[int] = None,
    drain: bool = True,
) -> "tuple[ChaosEvent, ...]":
    """Rolling-restart chaos: ``count`` outage windows of ``down_s``
    seconds, one per ``period_s``.

    The simulation analogue of the reference's gateway-bouncer
    (perf/stability/gateway-bouncer/README.md:14-21: the ingress
    gateway is rolling-restarted on a loop and fortio clients crash on
    the connection errors the bounce causes).  Point it at the
    entrypoint service to bounce the ingress: during each window the
    entry refuses connections, outside the windows traffic is clean.
    """
    if down_s <= 0 or down_s > period_s:
        raise ValueError("bounce needs 0 < down_s <= period_s")
    if count <= 0:
        raise ValueError("bounce count must be positive")
    return tuple(
        ChaosEvent(
            service=service,
            start_s=start_s + i * period_s,
            end_s=start_s + i * period_s + down_s,
            replicas_down=replicas_down,
            drain=drain,
        )
        for i in range(count)
    )


@dataclasses.dataclass(frozen=True)
class TrafficSplit:
    """Time-varying traffic weight toward one service.

    The simulation analogue of the reference's config churner
    (perf/load/templates/config-map.yaml:40-60): an in-cluster
    ``rollout.sh`` rotates VirtualService v1/v2 weights through
    100/70/40/20 forever, producing steady-state control-plane churn
    that actually shifts traffic.  Here every call targeting
    ``service`` has its send probability multiplied by
    ``weights[floor(t / period_s) mod len(weights)]`` — model a canary
    as two services (v1/v2) with complementary weight schedules.
    """

    service: str
    period_s: float
    weights: "tuple[float, ...]"

    def __post_init__(self):
        if self.period_s <= 0:
            raise ValueError("churn period_s must be positive")
        if not self.weights:
            raise ValueError("churn weights must be non-empty")
        if any(not 0.0 <= w <= 1.0 for w in self.weights):
            raise ValueError("churn weights must lie in [0, 1]")
        object.__setattr__(self, "weights", tuple(self.weights))

    @property
    def mean_weight(self) -> float:
        return sum(self.weights) / len(self.weights)


@dataclasses.dataclass(frozen=True)
class MtlsSchedule:
    """Time-phased per-edge mTLS tax.

    The simulation analogue of the reference's auto-mTLS scale test
    (perf/load/auto-mtls/scale.py:1-130): istio-sidecar and legacy
    deployments are alternately scaled so the share of connections
    paying the mTLS handshake flips over time, exercising istiod's
    auto-mTLS switching.  Here the *data-plane consequence* is modeled
    directly: every edge's one-way wire latency gains
    ``taxes_s[floor(t / period_s) mod len(taxes_s)]`` at the request's
    arrival time — e.g. ``taxes_s=(0.0, 1e-3)`` alternates the tax off
    and on each period, and a mixed-fleet phase is a fractional tax.
    The tax is pure latency (the handshake burns proxy CPU, not
    service CPU), so offered-load/queueing tables are unaffected —
    matching how the sidecar-mode environments model proxies.
    """

    period_s: float
    taxes_s: "tuple[float, ...]"

    def __post_init__(self):
        if self.period_s <= 0:
            raise ValueError("mtls period_s must be positive")
        if not self.taxes_s:
            raise ValueError("mtls taxes_s must be non-empty")
        if any(x < 0 for x in self.taxes_s):
            raise ValueError("mtls taxes must be >= 0")
        object.__setattr__(self, "taxes_s", tuple(self.taxes_s))


OPEN_LOOP = "open"
CLOSED_LOOP = "closed"


@dataclasses.dataclass(frozen=True)
class LoadModel:
    """The client side of the experiment.

    - ``open``: Poisson arrivals at ``qps`` (Nighthawk's open-loop mode,
      runner.py:270-316) — arrival times are independent of latencies.
    - ``closed``: ``connections`` workers each issue requests serially,
      pacing to ``qps`` overall when it is finite (Fortio's default
      closed-loop mode, runner.py:255-268; ``qps=None`` is Fortio's
      ``-qps max``).
    """

    kind: str = OPEN_LOOP
    qps: float | None = 1000.0
    connections: int = 64
    duration_s: float = 240.0

    def __post_init__(self):
        if self.kind not in (OPEN_LOOP, CLOSED_LOOP):
            raise ValueError(f"unknown load model kind: {self.kind!r}")
        if self.kind == OPEN_LOOP and (self.qps is None or self.qps <= 0):
            raise ValueError("open-loop load requires a positive qps")
        if self.qps is not None and self.qps <= 0:
            raise ValueError("qps must be positive (or None for max)")
        if self.connections <= 0:
            raise ValueError("connections must be positive")


@dataclasses.dataclass(frozen=True)
class DesignParam:
    """One registered design knob for the gradient audit (VET-G rules).

    A knob either enters the traced program through named member-body
    invars (``invars`` — names from
    :data:`~isotope_tpu_torch.analysis.grad_audit.GRAD_INVARS`, the ten
    traced arguments of the engine's universal member scan), or it is
    baked into the jaxpr at build time (``invars`` empty,
    ``constant_site`` says where) — the recompile-per-value population
    problem from the config-search residuals.  ``partial`` notes knobs
    that are only partly traced (the rest rides as constants)."""

    name: str
    doc: str
    invars: tuple = ()
    constant_site: str = ""
    partial: str = ""

    @property
    def traced(self) -> bool:
        return bool(self.invars)


#: every design parameter the gradient audit classifies.  Order is the
#: report order; names are stable API (tests/data pins key on them).
DESIGN_PARAMS: tuple = (
    DesignParam(
        "qps_scale",
        "offered-load scale: the open-loop arrival rate / closed-loop "
        "pacing gap the planner would sweep",
        invars=("offered_qps", "pace_gap", "nominal_gap"),
    ),
    DesignParam(
        "cpu_time_s",
        "per-service mean service time (the cpu_scale jitter scale "
        "multiplies every sampled service time and the utilization "
        "denominator)",
        invars=("cpu_scale",),
    ),
    DesignParam(
        "error_rate_scale",
        "per-service 5xx error-rate scale (the err_scale jitter scale "
        "multiplies every hop's errorRate before the 5xx coin)",
        invars=("err_scale",),
    ),
    DesignParam(
        "traffic_split_weights",
        "traffic-split / canary phase weights, as the per-phase visit "
        "vectors the closed-form solver bakes from them",
        invars=("visits_pc",),
        partial="per-hop churn send-coin thresholds stay baked "
                "constants (engine._churn_weights)",
    ),
    DesignParam(
        "timeout_ladder",
        "per-call deadline ladder",
        constant_site="compiled.call_timeout (per-hop f32 table baked "
                      "at compile time)",
    ),
    DesignParam(
        "retry_budgets",
        "per-call retry counts and per-service retry budgets",
        constant_site="compiled.hop_attempt unroll + "
                      "policies.device_tables retry_budget",
    ),
    DesignParam(
        "breaker_caps",
        "circuit-breaker max_pending / max_connections caps",
        constant_site="policies.device_tables breaker columns",
    ),
    DesignParam(
        "hpa_targets",
        "autoscaler target_utilization / min / max replicas",
        constant_site="policies.device_tables autoscaler columns",
    ),
    DesignParam(
        "canary_step_weights",
        "rollout step schedule weights and bake durations",
        constant_site="rollout.device_tables step/bake rows",
    ),
    DesignParam(
        "lb_choices_d",
        "load-balancer power-of-d choices_d and panic thresholds",
        constant_site="policies lb tables (choices_d, panic_threshold)",
    ),
)
