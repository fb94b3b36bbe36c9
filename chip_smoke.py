"""Drive the PyTorch port on one CUDA card, end to end, and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (any
CUDA card of compute capability 9.0 with ``nvcc``).  Phases, in order;
any failure exits non-zero and nothing is caught:

1. card: name and power limit from ``nvidia-smi``;
2. build: compile the census kernel (``isotope_tpu_torch/native/csrc``)
   with ``nvcc`` for ``sm_90a`` and print what ``ptxas -v`` says of
   each kernel (registers, shared memory, spills);
3. kernel: hold the kernel against its plain torch version on the card
   at every census shape of the main path (each dense level with
   children and each tile holding calls of the eleven runs of phase 5,
   and of the closed loops' rate pilots, as ``Simulator.census_shapes``
   gives them: among them the star-10k block's tiles and its 1 x 5,021
   root, every call of the three scenario runs, all with a fail step,
   and the panic run's call with both a fail step and error flags), at
   the default blocks of
   ``realistic-star-50.yaml`` and ``realistic-star-auxiliary-50.yaml``
   and at fixture shapes, among them a 4,096-step axis (rtol 1e-5: the
   plain version's ``cumsum`` may associate differently), and bit for
   bit against ``census_sequential``, the kernel's own order of
   operations in plain torch.  Then, per census call of one block of each
   of those configurations, print the kernel's device-only time
   (``torch.profiler``'s device time for the kernel's own name, L2
   flushed before every launch), its bound and share of bound, the
   wrapper's host cost (host clock over a few hundred enqueues) and the
   plain version's time, and per block the sums;
4. in situ: one block of the flagship tree (1000 qps), of the
   retry/timeout/error topology (500 qps) and of
   ``realistic-powerlaw-100.yaml`` (6,500 qps), 16,384 requests each, of
   the star-10k graph with 30 s timeouts (3,355 requests at 6,500 qps)
   and of ``canonical.yaml`` under ``-qps max`` (16,384 requests, 64
   connections; its tables and rate solved once on the CPU and used by
   both sides), and every block of the three scenario runs of phase 5
   (svc100k-chaos, canonical-2r-storm, canonical-2r-qps-max-bounce), the
   whole lb-10svc-100r-panic run and one block of 16,384 requests of
   lb-1000svc-lr, with the same draws, on the card (kernel) and on the
   CPU (plain version), compared like the CPU tests compare the port
   with the JAX package;
5. main path at full size, after one warm-up block of each run (the
   warm-up also solves and caches the closed loops' rates from the same
   seed, so the timed closed-loop runs skip their pilots and tables): the
   flagship (121 hops) open loop at 100k qps in 4 blocks of 262,144
   requests, ``1000-svc_2000-end.yaml`` open loop at 10k qps in blocks
   of 32,768, ``canonical.yaml`` paced closed loop at the CLI defaults,
   ``realistic-powerlaw-100.yaml`` open loop at 6,500 qps (half its
   capacity) in 2 blocks of its default 335,544, the 10,000-service star
   graph with 30 s timeouts (BASELINE configs[3]) open loop at 6,500 qps
   (half its capacity) in 4 blocks of its default 3,355, and
   ``canonical.yaml`` under ``-qps max`` (64 connections, 240 s, capped
   at 1,000,000 requests: 2 blocks of 524,288); then the scenario
   runs: svc100k-chaos (BASELINE configs[4]: the 100,000-service
   multitier graph, Pareto service times, a total outage of ``mock-7``
   in [5 s, 15 s), open loop at 100 qps, 4 blocks of its default 335),
   canonical-2r-storm (``canonical-2-replicas.yaml`` under ``ISTIO``, open
   loop at 10,000 qps in 2 blocks of 262,144: one of b's two replicas
   killed ungracefully in [10 s, 20 s), the canary rotation of c's
   traffic every 30 s, an mTLS tax of 0 / 1 ms every 20 s) and
   canonical-2r-qps-max-bounce (the same graph under ``-qps max``, 64
   connections, 2 blocks of 524,288, b bounced to one replica for 10 s
   every 60 s from 30 s); then the lb runs: lb-10svc-100r-panic
   (``10-svc_1000-end.yaml``, 10 services of 100 replicas, under
   least_request with d = 2 and a 50% panic threshold, a ring hash of
   skew 1.2 on ``svc-0-0`` and wrr 3:1:1:1 on ``svc-0-1``, 60 of
   ``svc-0-2``'s replicas killed in [2 s, 6 s), open loop at 30,000 qps
   for 8 s in its default block) and lb-1000svc-lr
   (``1000-svc_2000-end.yaml`` under least_request, the 1000-svc run's
   load); the host build times (graph, compile, ``Simulator(...)``, the
   saturated tables) are printed, the launch count is set to 0 just
   before each run and must equal its blocks times its census calls per
   block just after; the share of ``svc-0-2``'s hops that fast-fail in
   the kill window is printed and must be 60% (+-1%), and 0 outside;
6. the CLI as a subprocess: ``simulate`` once on the card; ``check`` on
   ``canonical.yaml`` and ``simulate --qps max`` (50,000 requests each),
   on the card and with ``--device cpu``: both ``check`` runs must give
   the same exit code and alarm lines (values within rtol 1e-4), both
   ``simulate`` runs a Fortio document; ``simulate --environment ISTIO``
   on ``two-cluster-canonical.yaml``, on the card and with ``--device
   cpu``, whose draw-independent values (label, requested load, count,
   return codes) must agree; ``simulate --lb-out`` on the lb topology
   (written to a temporary YAML), on the card and with ``--device cpu``,
   whose draw-independent values and lb documents must agree, and
   ``simulate --qps max`` on it, which must exit non-zero;
7. oracle: build the DES oracle (``isotope_tpu_torch/native/
   des_oracle.cpp``) with ``g++`` and hold the engine on the card to
   it: the six exact interpreter-parity cases of the reference's
   ``tests/test_oracle.py`` (deterministic service times, 32 quiet
   requests: client latency within rtol 1e-5, errors and hop events
   equal), the six open-loop fidelity cases (chain3, tree13, star9 at
   rho 0.3 and 0.7: 200,000 requests on the card, 1,000,000 in the
   oracle, warm-up 0.5 s; p50 and p99 within 5%) and the paced closed
   case (chain3, 64 connections at half capacity, 128,000 / 512,000:
   p50 and p99 within 5%, throughput within 2%); each relative error is
   printed.

It then prints the kernel table as one JSON line and, last, the result
line ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
with code 1 and prints no result.
"""
from __future__ import annotations

import json
import math
import pathlib
import re
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
TOPOLOGIES = ROOT / "examples" / "topologies"

# H100 SXM data sheet: HBM3 rate and the float32 rate outside the tensor
# cores (the census kernel does plain f32 arithmetic)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

KERNEL_RTOL = 1e-5
RESULT_RTOL, RESULT_ATOL = 1e-5, 1e-9
# saturated closed loop: the finite-population law's quantile map
# v = -log1p(-u') magnifies one-ULP differences of its normals in the
# far tail (tests/test_torch_closed.py)
SAT_RTOL, SAT_ATOL = 1e-4, 1e-5
# star-10k: the root's busy time is a float32 sum over 5,021 steps,
# left to right in the kernel and vectorized in the CPU's plain version;
# the two roundings drift apart by ~sqrt(5021) * 6e-8 = 4e-6 typically,
# 2.0e-5 at most over 3,355 requests as measured on an H100
STAR_RTOL = 1e-4
# check alarm values, card against CPU (utilization x replicas)
CHECK_RTOL = 1e-4
# requests of the check and -qps max CLI runs (phase 6)
CLI_REQUESTS = 50_000

# the retry/timeout/error topology of tests/test_census_pallas.py
CENSUS_YAML = """
services:
- name: entry
  isEntrypoint: true
  errorRate: 2%
  script:
  - call: {service: mid, timeout: 30ms, retries: 2}
  - sleep: 1ms
- name: mid
  errorRate: 5%
  script:
  - - call: {service: leaf, timeout: 10ms, retries: 1}
    - call: {service: leaf2, probability: 60}
- name: leaf
  errorRate: 3%
- name: leaf2
  script:
  - call: deep
- name: deep
"""

FIXTURE_SHAPES = (
    [((13, 37, 5), f, e) for f in (False, True) for e in (False, True)]
    + [((4096, 512, 64), True, True)]
    # a step axis far past any tile the kernel stages whole
    + [((64, 3, 4096), True, True)]
)

# configurations whose census calls phase 3 checks and times but that
# phase 5 does not run, at their default blocks
CENSUS_ONLY_TOPOLOGIES = ("realistic-star-50", "realistic-star-auxiliary-50")

# the closed-loop rate pilot's block (``Simulator.solve_closed_rate``)
PILOT_N = 2048
# the saturated tables' fork-join pilots (``Simulator._sat_pilot``)
SAT_PILOT_N = 32_768
# BASELINE configs[3]: the 10k realistic star graph with 30 s timeouts
STAR10K_QPS = 6500.0
# BASELINE configs[4], the reference's svc100k_chaos case: the 100k
# multitier graph at 100 qps, mock-7 down in [5 s, 15 s)
SVC100K_QPS = 100.0
SVC100K_BLOCKS = 4
# the storm: canonical-2-replicas.yaml at 10k qps, 2 blocks of 262,144
STORM_QPS = 10_000.0
STORM_BLOCK = 262_144
# in situ, the storm's kill phase overloads b (15,750 visits/s against
# one replica's 13,000/s): the wait law clamps rho at 0.9999, its rate
# is 1.3/s, and a wait -log(u / p) / 1.3 near u = p moves by 9e-8 s per
# float32 spacing of u (one ULP of erfc or log, which the card and the
# CPU round differently); floats are held to four such spacings there
STORM_ATOL = 4.0 * 2.0**-23 / 1.3

# lb-10svc-100r-panic: 10-svc_1000-end.yaml (100 replicas a service)
# under Istio's default balancer (least_request, d = 2) with Envoy's
# default healthy-panic threshold, a skewed ring and a weighted round
# robin; 60 of svc-0-2's 100 replicas are killed in [2 s, 6 s), which
# leaves 40% healthy, below the threshold, so 60% of its hops there
# fast-fail
LB_PANIC_POLICIES = {
    "defaults": {"lb": {"policy": "least_request", "choices_d": 2,
                        "panic_threshold": "50%"}},
    "svc-0-0": {"lb": {"policy": "ring_hash", "hash_skew": 1.2}},
    "svc-0-1": {"lb": {"policy": "wrr", "weights": [3, 1, 1, 1]}},
}
LB_PANIC_QPS = 30_000.0
LB_PANIC_S = 8.0
LB_KILL = dict(service="svc-0-2", start_s=2.0, end_s=6.0, replicas_down=60)
LB_PANIC_SHARE, LB_PANIC_BAND = 0.6, 0.01
# lb-1000svc-lr: 1000-svc_2000-end.yaml under least_request at the
# 1000-svc run's load
LB_LR_POLICIES = {"defaults": {"lb": "least_request"}}

# the reference's oracle fixtures (tests/test_oracle.py)
CHAIN3 = """
services:
- name: a
  isEntrypoint: true
  script: [{call: b}]
- name: b
  script: [{call: c}]
- name: c
"""
TREE13 = """
services:
- name: entry
  isEntrypoint: true
  script:
  - [{call: c0}, {call: c1}, {call: c2}]
""" + "".join(
    f"- name: c{i}\n  script: [[{{call: l{i}0}}, {{call: l{i}1}}, "
    f"{{call: l{i}2}}]]\n" for i in range(3)
) + "".join(f"- name: l{i}{j}\n" for i in range(3) for j in range(3))
STAR9 = """
services:
- name: entry
  isEntrypoint: true
  script:
  - [{call: s0}, {call: s1}, {call: s2}, {call: s3},
     {call: s4}, {call: s5}, {call: s6}, {call: s7}]
""" + "".join(f"- name: s{i}\n" for i in range(8))
PARITY = {
    "sequential-sleeps-and-calls": """
services:
- name: entry
  isEntrypoint: true
  script:
  - sleep: 10ms
  - call: leaf
  - sleep: 5ms
- name: leaf
""",
    "concurrent-join-with-sleep": """
services:
- name: entry
  isEntrypoint: true
  script:
  - [{sleep: 30ms}, {call: fast}, {call: slow}]
- name: fast
- name: slow
  script: [{sleep: 50ms}]
""",
    "error-rate-fast-500-skips-script": """
services:
- name: entry
  isEntrypoint: true
  script: [{call: flaky}]
- name: flaky
  errorRate: 100%
  script: [{sleep: 80ms}]
""",
    "retries-exhausted-by-500s": """
services:
- name: entry
  isEntrypoint: true
  script:
  - call: {service: flaky, retries: 2}
- name: flaky
  errorRate: 100%
""",
    "timeout-is-transport-and-truncates": """
services:
- name: entry
  isEntrypoint: true
  script:
  - call: {service: slow, timeout: 10ms}
  - sleep: 40ms
- name: slow
  script: [{sleep: 60ms}]
""",
    # b down for the whole run
    "chaos-total-outage": CHAIN3,
}
PARITY_RTOL = 1e-5
FIDELITY_BAND = 0.05   # p50 and p99, engine against oracle
THROUGHPUT_BAND = 0.02  # the paced closed loop's solved rate
ORACLE_WARMUP_S = 0.5


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return out


# -- phase 3: the kernel against its plain version -------------------------


def census_inputs(n, b, p, with_fail, with_err, seed=0):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    kw = dict(device="cuda", generator=g)
    base = torch.rand((b, p), **kw)
    mask = (torch.rand((b, p), **kw) > 0.3).float()
    agg = torch.rand((n, b, p), **kw) * 2.0
    fail = (
        torch.randint(0, p + 1, (n, b), dtype=torch.int32, **kw)
        if with_fail else None
    )
    err = torch.rand((n, b), **kw) > 0.7 if with_err else None
    return base, mask, agg, fail, err


def census_bound_ms(n, b, p, with_fail, with_err):
    """Least time for one census call: each input read once, each output
    written once, over the HBM rate (the ~4 f32 operations per element
    are far below the compute bound)."""
    nbytes = 4 * (n * b * p)          # agg
    nbytes += 2 * 4 * (b * p)         # base, mask
    nbytes += 4 * n * b if with_fail else 0
    nbytes += n * b if with_err else 0
    nbytes += 4 * n * b + 4 * n * b * p   # busy, excl
    ops = 4 * n * b * p
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def time_ms(fn, flush, reps=20):
    """Mean time of ``fn`` over ``reps`` calls, each after an L2 flush,
    with CUDA events around the call only: device time plus whatever
    host time the call's launches leave the device idle."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def device_ms(fn, flush, reps=20, attempts=5):
    """Mean device-only time of the census kernel in ``fn``: the
    profiler's device time for kernels whose name holds ``census``, over
    ``reps`` calls, each after an L2 flush.  A profiled pass that
    records fewer than its ``reps`` launches (seen a few times in a run
    of a few hundred passes, in bursts) is repeated; after ``attempts``
    such passes the time is taken with CUDA events around each call
    instead, which adds the launch gap, and the line says so."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        kernels = [
            e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "census" in e.key
        ]
        count = sum(e.count for e in kernels)
        total_us = sum(
            getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
            for e in kernels
        )
        if count == reps and total_us > 0:
            return total_us / count / 1e3
        log(f"profiled pass {attempt + 1} recorded {count} census "
            f"kernels with {total_us} us of device time, expected {reps}")
    ms = time_ms(fn, flush, reps)
    log(f"profiler recorded no full pass in {attempts}: {ms:.4f} ms "
        f"per call from CUDA events around each call")
    return ms


def host_us(fn, reps=300):
    """The wrapper's host cost per call: host clock over ``reps``
    enqueues, without waiting for the device, divided by the count."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


def census_check_shapes(runs, census_only):
    """Every census shape phase 3 checks, in order, without repeats: the
    main path's (with the closed loop's rate pilot), the census-only
    configurations' and the fixtures."""
    shapes = []
    for _, sim, load, _, block in runs:
        shapes += sim.census_shapes(block)
        if load.kind == "closed":
            shapes += sim.census_shapes(
                SAT_PILOT_N if load.qps is None else PILOT_N
            )
    for _, sim, block in census_only:
        shapes += sim.census_shapes(block)
    shapes += [(n, b, p, f, e) for (n, b, p), f, e in FIXTURE_SHAPES]
    return list(dict.fromkeys(shapes))


def kernel_phase(census_mod, runs, census_only):
    """Check the kernel at every census shape of ``runs`` and
    ``census_only`` and at the fixtures; time it per call and per block
    of each.  Returns the largest error, the times per flagship block
    (the first run) and the device ms per block of each."""
    max_err = 0.0
    for n, b, p, with_fail, with_err in census_check_shapes(
        runs, census_only
    ):
        args = census_inputs(n, b, p, with_fail, with_err)
        busy, excl = census_mod.census(*args)
        ref_busy, ref_excl = census_mod.census_reference(*args)
        seq_busy, seq_excl = census_mod.census_sequential(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(busy, ref_busy, rtol=KERNEL_RTOL, atol=0)
        torch.testing.assert_close(excl, ref_excl, rtol=KERNEL_RTOL, atol=0)
        if not (torch.equal(busy, seq_busy) and torch.equal(excl, seq_excl)):
            raise AssertionError(
                f"kernel {n}x{b}x{p}: differs from its sequential twin"
            )
        err = max(
            float((busy - ref_busy).abs().max()),
            float((excl - ref_excl).abs().max()),
        )
        max_err = max(max_err, err)
        log(f"kernel ok {n}x{b}x{p} fail={with_fail} err={with_err} "
            f"max_abs_err={err:.3e} (bit-equal to the sequential twin)")

    # time each configuration's census calls of one block, L2 flushed
    # before each launch
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    blocks = [(name, sim, block) for name, sim, _, _, block in runs]
    per_block = []
    for name, sim, block in blocks + list(census_only):
        ms = plain_ms = bound_ms = 0.0
        for shape in sim.census_shapes(block):
            args = census_inputs(*shape, seed=1)
            k = device_ms(lambda: census_mod.census(*args), flush)
            host = host_us(lambda: census_mod.census(*args))
            r = time_ms(lambda: census_mod.census_reference(*args), flush,
                        reps=5)
            bd = census_bound_ms(*shape)
            n, b, p, f, e = shape
            log(f"kernel time {n}x{b}x{p} fail={f} err={e}: device "
                f"{k:.4f} ms (profiler), bound {bd:.4f} ms (bytes), "
                f"{bd / k:.1%} of bound; plain {r:.4f} ms")
            log(f"kernel host {n}x{b}x{p}: {host:.1f} us per call "
                f"(wrapper, host clock over 300 enqueues)")
            ms += k
            plain_ms += r
            bound_ms += bd
        log(f"kernel time per {name} block "
            f"({len(sim.census_shapes(block))} calls): device {ms:.4f} ms,"
            f" bound {bound_ms:.4f} ms, {bound_ms / ms:.1%} of bound; "
            f"plain {plain_ms:.4f} ms")
        per_block.append((name, ms, plain_ms, bound_ms))
    _, ms, plain_ms, bound_ms = per_block[0]
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                ms_per_block={name: t for name, t, _, _ in per_block})


# -- phase 4: in situ, card against CPU ---------------------------------------


def compare_results(got, want, what, rtol=RESULT_RTOL, atol=RESULT_ATOL):
    """Booleans exactly, float fields within ``rtol``/``atol``; returns
    the largest difference of the float fields as a share of its
    tolerance ``atol + rtol * |want|`` (at most 1)."""
    for name in ("hop_sent", "hop_error", "client_error", "unstable"):
        a = getattr(got, name).cpu()
        b = getattr(want, name).cpu()
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} differs")
    worst = 0.0
    for name in ("client_start", "client_latency", "hop_latency",
                 "hop_start", "utilization"):
        a = getattr(got, name).cpu().double()
        b = getattr(want, name).cpu().double()
        torch.testing.assert_close(
            a, b, rtol=rtol, atol=atol, msg=lambda m: f"{what}: {m}",
        )
        worst = max(worst, float(((a - b).abs() / (
            atol + rtol * b.abs())).max()))
    return worst


def share_closed_tables(src, dst, connections):
    """Hand ``src``'s saturated tables (solved once) to ``dst``, on its
    device, so both runs sample the same finite-population law."""
    dst._closed_cache[connections] = tuple(
        x.to(dst.device) if isinstance(x, torch.Tensor) else x
        for x in src._closed_tables(connections)
    )


def in_situ_phase(port, cases):
    """``cases``: (name, make, load, requests, block, rtol, atol), where
    ``make(device)`` builds the case's Simulator on a device; ``block``
    None runs the requests as one block (``Simulator.run``), else each
    block of ``Simulator.run_blocks`` is compared."""
    for name, make, load, n, block, rtol, atol in cases:
        source = port.TorchDraws(11, "cuda")
        on_cpu_sim = make("cpu")
        card_sim = make("cuda")
        if load.kind == "closed" and load.qps is None:
            on_cpu_sim.solve_closed_rate(load, n, source)
            share_closed_tables(on_cpu_sim, card_sim, load.connections)
        before = port.census.launches
        if block is None:
            on_card = [card_sim.run(load, n, source)]
        else:
            on_card = list(card_sim.run_blocks(load, n, source,
                                               block_size=block))
        torch.cuda.synchronize()
        if port.census.launches == before:
            raise AssertionError(f"in situ {name}: kernel never launched")
        on_cpu = (
            [on_cpu_sim.run(load, n, source)] if block is None
            else on_cpu_sim.run_blocks(load, n, source, block_size=block)
        )
        worst = 0.0
        events = errors = 0
        for b, (got, want) in enumerate(zip(on_card, on_cpu)):
            worst = max(worst, compare_results(
                got, want, f"in situ {name} block {b}", rtol, atol))
            events += int(got.hop_events)
            errors += int(got.client_error.sum())
        log(f"in situ ok {name}: card (kernel) == cpu (plain), "
            f"{len(on_card)} block(s), {events} hop events, {errors} client "
            f"errors, largest difference {worst:.3f} of its tolerance "
            f"(rtol {rtol:g}, atol {atol:g} s)")


# -- phase 5: the main path at full size -----------------------------------------


def star10k_graph(port):
    """BASELINE configs[3]: the 10,000-service realistic star graph with
    30 s call timeouts."""
    return port.ServiceGraph.decode(port.with_call_policy(
        port.realistic_topology(10_000, archetype="star", seed=0),
        timeout="30s",
    ))


def main_path_runs(port, flagship_graph, device="cuda", build_s=None):
    """The six runs of the main path: (name, simulator, load, requests,
    block size).  ``build_s`` collects the host seconds of the star-10k
    graph's generation, compilation and ``Simulator``."""
    flagship = port.Simulator(port.compile_graph(flagship_graph),
                              device=device)
    svc1000 = port.Simulator(
        port.compile_graph(port.ServiceGraph.from_yaml_file(
            TOPOLOGIES / "1000-svc_2000-end.yaml")),
        device=device,
    )
    canonical = port.Simulator(
        port.compile_graph(port.ServiceGraph.from_yaml_file(
            TOPOLOGIES / "canonical.yaml")),
        device=device,
    )
    conns = 64
    closed = port.LoadModel(kind="closed", qps=1000.0, connections=conns,
                            duration_s=240.0)
    closed_n = min(int(min(1000.0, canonical.capacity_qps()) * 240.0),
                   1_000_000)
    # run_summary's closed-loop block: a whole number per connection
    closed_block = (
        min(canonical.default_block_size(), closed_n) // conns * conns
    )
    powerlaw = port.Simulator(
        port.compile_graph(port.ServiceGraph.from_yaml_file(
            TOPOLOGIES / "realistic-powerlaw-100.yaml")),
        device=device,
    )
    powerlaw_block = powerlaw.default_block_size()
    t = time.perf_counter()
    star_graph = star10k_graph(port)
    t_graph = time.perf_counter()
    star_compiled = port.compile_graph(star_graph)
    t_compile = time.perf_counter()
    star = port.Simulator(star_compiled, device=device)
    t_sim = time.perf_counter()
    if build_s is not None:
        build_s.update(star10k_graph=t_graph - t,
                       star10k_compile=t_compile - t_graph,
                       star10k_simulator=t_sim - t_compile)
    star_block = star.default_block_size()
    # -qps max: its own Simulator, so its tables are built (and timed)
    # apart from the paced run's
    sat = port.Simulator(canonical.compiled, device=device)
    sat_load, sat_n, sat_block = qps_max_load(port, sat)
    return [
        ("flagship", flagship, port.LoadModel(kind="open", qps=1e5),
         4 * 262_144, 262_144),
        ("1000-svc_2000-end", svc1000, port.LoadModel(kind="open", qps=1e4),
         262_144, 32_768),
        ("canonical closed c=64", canonical, closed, closed_n, closed_block),
        ("realistic-powerlaw-100", powerlaw,
         port.LoadModel(kind="open", qps=powerlaw.capacity_qps() / 2),
         2 * powerlaw_block, powerlaw_block),
        ("star-10k-timeouts", star,
         port.LoadModel(kind="open", qps=STAR10K_QPS), 4 * star_block,
         star_block),
        ("canonical-qps-max", sat, sat_load, sat_n, sat_block),
    ]


def qps_max_load(port, sim, conns=64):
    """``-qps max`` at the CLI defaults (64 connections, 240 s) capped at
    1,000,000 requests: (load, requests, block)."""
    load = port.LoadModel(kind="closed", qps=None, connections=conns,
                          duration_s=240.0)
    n = min(int(sim.capacity_qps() * 240.0), 1_000_000)
    return load, n, min(sim.default_block_size(), n) // conns * conns


def scenario_runs(port, build_s, device="cuda"):
    """The three scenario runs of the main path: (name, simulator on
    ``device``, load, requests, block, make), ``make(device)`` building
    the same Simulator (compiled graph, parameters, schedules) on
    another device.  ``build_s`` collects the host seconds of the
    svc100k graph's generation, compilation and ``Simulator``."""
    t = time.perf_counter()
    graph = port.ServiceGraph.decode(
        port.realistic_topology(100_000, archetype="multitier", seed=0)
    )
    t_graph = time.perf_counter()
    svc100k = port.compile_graph(graph)
    t_compile = time.perf_counter()
    pareto = port.SimParams(service_time="pareto", service_time_param=2.5)
    outage = (port.ChaosEvent("mock-7", 5.0, 15.0, replicas_down=None),)

    def make_svc100k(device):
        return port.Simulator(svc100k, pareto, outage, device=device)

    big = make_svc100k(device)
    build_s.update(svc100k_graph=t_graph - t,
                   svc100k_compile=t_compile - t_graph,
                   svc100k_simulator=time.perf_counter() - t_compile)
    big_block = big.default_block_size()

    canon2 = port.compile_graph(port.ServiceGraph.from_yaml_file(
        TOPOLOGIES / "canonical-2-replicas.yaml"))
    istio = port.DEFAULT_ENVIRONMENTS["ISTIO"].apply(port.SimParams())
    storm = dict(
        chaos=(port.ChaosEvent("b", 10.0, 20.0, replicas_down=1,
                               drain=False),),
        # the reference's canary rotation (100/70/40/20) of c's traffic
        churn=(port.TrafficSplit("c", 30.0, (1.0, 0.7, 0.4, 0.2)),),
        mtls=port.MtlsSchedule(20.0, (0.0, 1e-3)),
    )

    def make_storm(device):
        return port.Simulator(canon2, istio, device=device, **storm)

    bounce = port.bounce_schedule("b", period_s=60.0, down_s=10.0, count=4,
                                  start_s=30.0, replicas_down=1)

    def make_bounce(device):
        return port.Simulator(canon2, chaos=bounce, device=device)

    sat = make_bounce(device)
    sat_load, sat_n, sat_block = qps_max_load(port, sat)
    return [
        ("svc100k-chaos", big, port.LoadModel(kind="open", qps=SVC100K_QPS),
         SVC100K_BLOCKS * big_block, big_block, make_svc100k),
        ("canonical-2r-storm", make_storm(device),
         port.LoadModel(kind="open", qps=STORM_QPS), 2 * STORM_BLOCK,
         STORM_BLOCK, make_storm),
        ("canonical-2r-qps-max-bounce", sat, sat_load, sat_n, sat_block,
         make_bounce),
    ]


def with_policies(port, path, policies):
    """The graph of ``path`` with a ``policies:`` block attached."""
    graph = port.ServiceGraph.from_yaml_file(path)
    graph.policies = dict(policies)
    return graph


def lb_runs(port, device="cuda"):
    """The two lb runs of the main path: (name, simulator on
    ``device``, load, requests, block, make), as :func:`scenario_runs`."""
    out = []
    for name, topo, policies, chaos, qps, n, block in (
        ("lb-10svc-100r-panic", "10-svc_1000-end.yaml", LB_PANIC_POLICIES,
         (port.ChaosEvent(**LB_KILL),), LB_PANIC_QPS,
         int(LB_PANIC_QPS * LB_PANIC_S), None),
        ("lb-1000svc-lr", "1000-svc_2000-end.yaml", LB_LR_POLICIES, (),
         1e4, 262_144, 32_768),
    ):
        graph = with_policies(port, TOPOLOGIES / topo, policies)
        compiled = port.compile_graph(graph)
        tables = port.compile_lb(graph, compiled)

        def make(device, compiled=compiled, chaos=chaos, tables=tables):
            return port.Simulator(compiled, chaos=chaos, lb=tables,
                                  device=device)

        sim = make(device)
        block = block or min(sim.default_block_size(), n)
        out.append((name, sim, port.LoadModel(kind="open", qps=qps), n,
                    block, make))
    return out


def panic_share(port, sim, load, n, block):
    """The share of ``svc-0-2``'s hops that fast-fail among those of
    requests arriving in the kill window, and outside it, over the
    panic run's blocks on the card (draws of the timed run)."""
    svc = list(sim.compiled.services.names).index(LB_KILL["service"])
    hops = torch.tensor(np.nonzero(sim.compiled.hop_service == svc)[0],
                        device=sim.device)
    counts = torch.zeros(4, dtype=torch.float64, device=sim.device)
    for res in sim.run_blocks(load, n, port.TorchDraws(0, sim.device),
                              block_size=block):
        t = res.client_start
        inside = ((t >= LB_KILL["start_s"]) & (t < LB_KILL["end_s"]))[:, None]
        sent = res.hop_sent[:, hops]
        failed = res.hop_error[:, hops]
        counts += torch.stack([
            (failed & inside).sum(), (sent & inside).sum(),
            (failed & ~inside).sum(), (sent & ~inside).sum(),
        ]).double()
    f_in, s_in, f_out, s_out = counts.tolist()
    share = f_in / s_in
    log(f"panic: {LB_KILL['service']} {int(f_in)} of {int(s_in)} hops "
        f"fast-failed in [{LB_KILL['start_s']:g} s, {LB_KILL['end_s']:g} s)"
        f" ({share:.4%}; 40 of 100 replicas healthy, threshold 50%), "
        f"{int(f_out)} of {int(s_out)} outside")
    if abs(share - LB_PANIC_SHARE) > LB_PANIC_BAND or f_out:
        raise AssertionError(f"panic share {share:.4%} or {f_out} outside")
    prof = sim._lb_profile_np
    ring = list(sim.compiled.services.names).index("svc-0-0")
    hot = prof[ring, 0] / prof[ring, :100].sum()
    log(f"panic run: svc-0-0's hottest ring backend takes {hot:.4f} of "
        f"{load.qps:g}/s, rho {hot * load.qps / sim._mu:.4f}"
        f" against one replica")


def census_only_configs(port, device="cuda"):
    """(name, simulator, default block) of the topologies whose census
    calls phase 3 holds and times beside the main path's."""
    out = []
    for name in CENSUS_ONLY_TOPOLOGIES:
        sim = port.Simulator(
            port.compile_graph(port.ServiceGraph.from_yaml_file(
                TOPOLOGIES / f"{name}.yaml")),
            device=device,
        )
        out.append((name, sim, sim.default_block_size()))
    return out


def main_path_run(port, name, sim, load, n, block, census_ms=None):
    """One timed run; returns its summary and census launches.
    ``census_ms``: the census device time per block of phase 3, printed
    when given."""
    torch.cuda.synchronize()
    port.census.launches = 0
    t = time.perf_counter()
    summary = sim.run_summary(
        load, n, port.TorchDraws(0, "cuda"), block_size=block, trim=True
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = port.census.launches
    count = int(summary.count)
    blocks = max(1, -(-n // block))
    hop_events = float(summary.hop_events)
    qs = summary.quantiles_s((0.5, 0.9, 0.99))
    # run_summary rounds the requests up to whole blocks
    if count != blocks * block:
        raise AssertionError(
            f"{name}: count {count} != {blocks} blocks x {block}"
        )
    if not np.all(np.isfinite(qs)) or not np.all(qs > 0):
        raise AssertionError(f"{name}: bad quantiles {qs}")
    per_block = len(sim.census_shapes(block))
    if launches != blocks * per_block:
        raise AssertionError(
            f"{name}: {launches} census launches, expected {blocks} "
            f"blocks x {per_block}"
        )
    rate = (
        load.qps if load.kind == "open"
        else sim.solve_closed_rate(load, n, port.TorchDraws(0, "cuda"))
    )
    if getattr(sim, "has_chaos", False):
        windows = sim._windows_arg(rate, sim._saturated(load)).cpu().numpy()
        log(f"main path {name}: phase windows (start s, row) " + ", ".join(
            f"({b:.6g}, {int(r)})" for b, r in zip(*windows)))
    log(f"main path {name}: {count} requests in {blocks} blocks, offered "
        f"{rate:.6g} qps, {wall / blocks * 1e3:.2f} ms per block, "
        f"{hop_events / wall:.4e} hop-events/s, p50/p90/p99 "
        f"{qs[0] * 1e3:.4f}/{qs[1] * 1e3:.4f}/{qs[2] * 1e3:.4f} ms, "
        f"{int(summary.error_count)} client errors, census launches "
        f"{launches} ({per_block} per block)" + (
            "" if census_ms is None
            else f", census device {census_ms:.4f} ms per block (phase 3)"
        ))
    return summary, launches, wall / blocks


def main_path_phase(port, runs, build_s, census_ms=None):
    """Each run once, after one warm-up block of each; returns the census
    launches per run.  ``census_ms``: phase 3's census device time per
    block of each run, printed when given."""
    # the saturated tables and rate first, timed as host planning (their
    # fork-join pilots run on the card)
    for name, sim, load, n, _ in runs:
        if load.kind == "closed" and load.qps is None:
            t = time.perf_counter()
            sim.solve_closed_rate(load, n, port.TorchDraws(0, "cuda"))
            torch.cuda.synchronize()
            build_s[f"{name} tables"] = time.perf_counter() - t
    log("host build: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in build_s.items()
    ))
    # one block of each first, so the timed runs do not pay the caching
    # allocator's first growth and the first launches; the same seed as
    # the timed runs, so the closed loop's cached rate is that run's own
    for _, sim, load, _, block in runs:
        sim.run_summary(load, block, port.TorchDraws(0, "cuda"),
                        block_size=block)
    torch.cuda.synchronize()

    launches = {}
    walls = {}
    for run in runs:
        summary, launches[run[0]], walls[run[0]] = main_path_run(
            port, *run, None if census_ms is None else census_ms[run[0]]
        )
        if run[0] == "flagship" and (
            float(summary.hop_events) != 121 * int(summary.count)
        ):
            raise AssertionError(
                f"flagship: hop_events {float(summary.hop_events)} != "
                f"121 x {int(summary.count)}"
            )
    if "lb-1000svc-lr" in walls:
        log(f"lb-1000svc-lr against its fifo twin: "
            f"{walls['lb-1000svc-lr'] * 1e3:.2f} / "
            f"{walls['1000-svc_2000-end'] * 1e3:.2f} ms per block = "
            f"{walls['lb-1000svc-lr'] / walls['1000-svc_2000-end']:.3f}x")
    log(f"census launches on the main path: {sum(launches.values())} "
        f"{launches}")
    return launches


# -- phase 6: the CLI --------------------------------------------------------


def cli(*args, ok_codes=(0,)):
    out = subprocess.run(
        [sys.executable, "-m", "isotope_tpu_torch", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    if out.returncode not in ok_codes:
        raise AssertionError(
            f"CLI {' '.join(args)} exited {out.returncode}:\n{out.stderr}"
        )
    return out


def check_lines(err: str):
    """(text, values) of a check's stderr lines, the numbers cut out."""
    number = re.compile(r"-?\d+\.\d+(?:e[-+]?\d+)?")
    lines = [line for line in err.splitlines() if line.strip()]
    return ([number.sub("#", line) for line in lines],
            [[float(x) for x in number.findall(line)] for line in lines])


def cli_phase():
    canonical = str(TOPOLOGIES / "canonical.yaml")
    out = cli("simulate", canonical, "--qps", "1000", "--duration", "10s",
              "--load-kind", "open")
    doc = json.loads(out.stdout)
    count = doc["DurationHistogram"]["Count"]
    if count != 10_000:
        raise AssertionError(f"CLI: Count {count} != 10000")
    log(f"cli ok: {count} requests, p99 "
        f"{doc['DurationHistogram']['Percentiles'][3]['Value'] * 1e3:.4f} ms")

    # check: card against CPU, same verdict and alarm lines.  The two
    # runs draw from different generators (TorchDraws on the card's and
    # on the CPU's torch generator), so only values that do not depend
    # on the draws are held to CHECK_RTOL: those of the alarm lines here
    # (the CPU alarm: utilization x replicas); the --debug query lines
    # of the memory and request-rate estimates are printed, not compared
    runs = {}
    for device in ("cuda", "cpu"):
        t = time.perf_counter()
        out = cli("check", canonical, "--max-requests", str(CLI_REQUESTS),
                  "--debug", "--device", device, ok_codes=(0, 1))
        verdict = "\n".join(
            line for line in out.stderr.splitlines()
            if line.startswith("ALARM:") or "checks passed" in line
        )
        runs[device] = (out.returncode, verdict, out.stderr,
                        time.perf_counter() - t)
    (rc_card, v_card, err_card, s_card), (rc_cpu, v_cpu, err_cpu, s_cpu) = (
        runs["cuda"], runs["cpu"]
    )
    text_card, values_card = check_lines(v_card)
    text_cpu, values_cpu = check_lines(v_cpu)
    if rc_card != rc_cpu or text_card != text_cpu:
        raise AssertionError(
            f"check: card (rc {rc_card}) and cpu (rc {rc_cpu}) differ:\n"
            f"{err_card}\n{err_cpu}"
        )
    for a, b in zip(values_card, values_cpu):
        np.testing.assert_allclose(a, b, rtol=CHECK_RTOL)
    log(f"cli check ok: exit code {rc_card} on the card and on the cpu "
        f"({s_card:.1f} s / {s_cpu:.1f} s), alarm lines equal, values "
        f"within rtol {CHECK_RTOL:g}")
    log("cli check on the card: " + " | ".join(err_card.splitlines()))
    log("cli check on the cpu: " + " | ".join(err_cpu.splitlines()))

    for device in ("cuda", "cpu"):
        out = cli("simulate", canonical, "--qps", "max", "--max-requests",
                  str(CLI_REQUESTS), "--device", device)
        doc = json.loads(out.stdout)
        if doc["RequestedQPS"] != "max" or not (
            doc["DurationHistogram"]["Count"] >= CLI_REQUESTS
        ):
            raise AssertionError(f"simulate --qps max on {device}: {doc}")
        log(f"cli simulate --qps max ok on {device}: "
            f"{doc['DurationHistogram']['Count']} requests, ActualQPS "
            f"{doc['ActualQPS']:.6g}")

    # a sidecar environment over two clusters' edge classes: the
    # draw-independent values of the two documents agree
    two = str(TOPOLOGIES / "two-cluster-canonical.yaml")
    docs = {}
    for device in ("cuda", "cpu"):
        out = cli("simulate", two, "--environment", "ISTIO", "--qps", "1000",
                  "--duration", "10s", "--load-kind", "open", "--device",
                  device)
        doc = json.loads(out.stdout)
        hist = doc["DurationHistogram"]
        docs[device] = {
            "Labels": doc["Labels"], "RequestedQPS": doc["RequestedQPS"],
            "RequestedDuration": doc["RequestedDuration"],
            "NumThreads": doc["NumThreads"], "RetCodes": doc["RetCodes"],
            "Count": hist["Count"],
        }
        log(f"cli simulate --environment ISTIO on {device}: {docs[device]}, "
            f"p50 {hist['Percentiles'][0]['Value'] * 1e3:.4f} ms")
    if docs["cuda"] != docs["cpu"] or (
        docs["cuda"]["Labels"] != "two-cluster-canonical_istio_1000qps_64c"
    ):
        raise AssertionError(f"simulate --environment ISTIO: {docs}")
    cli_lb_phase()


def cli_lb_phase(devices=("cuda", "cpu")):
    """The lb topology through the CLI on each of ``devices``: its laws
    apply with no flag, ``--lb-out`` writes them, the draw-independent
    values agree, and ``--qps max`` is refused."""
    import yaml

    with tempfile.TemporaryDirectory() as tmp:
        topo = pathlib.Path(tmp) / "lb-10svc-100r.yaml"
        topo.write_text(
            (TOPOLOGIES / "10-svc_1000-end.yaml").read_text()
            + yaml.safe_dump({"policies": LB_PANIC_POLICIES})
        )
        docs = {}
        for i, device in enumerate(devices):
            lb_json = pathlib.Path(tmp) / f"lb-{i}.json"
            out = cli("simulate", str(topo), "--qps", "30000", "--duration",
                      "2s", "--load-kind", "open", "--lb-out", str(lb_json),
                      "--device", device)
            doc = json.loads(out.stdout)
            hist = doc["DurationHistogram"]
            docs[i] = {
                "Labels": doc["Labels"], "RetCodes": doc["RetCodes"],
                "Count": hist["Count"], "lb": json.loads(lb_json.read_text()),
            }
            if "least_request" not in out.stderr or "ring_hash" not in (
                out.stderr
            ):
                raise AssertionError(f"simulate lb on {device}: {out.stderr}")
            log(f"cli simulate lb on {device}: {doc['Labels']}, "
                f"{hist['Count']} requests, RetCodes {doc['RetCodes']}, p50 "
                f"{hist['Percentiles'][0]['Value'] * 1e3:.4f} ms, lb table "
                f"of {len(out.stderr.splitlines())} lines, its first: "
                f"{out.stderr.splitlines()[1][:120]}")
        if docs[0] != docs[1] or docs[0]["Count"] != 60_000:
            raise AssertionError(f"simulate lb: {docs}")
        out = cli("simulate", str(topo), "--qps", "max", "--device",
                  devices[0], ok_codes=(1,))
        if "-qps max" not in out.stderr:
            raise AssertionError(f"simulate lb --qps max: {out.stderr}")
        log("cli simulate lb --qps max refused: "
            + out.stderr.strip().splitlines()[-1])


# -- phase 7: the DES oracle ------------------------------------------------------


def oracle_phase(port, device="cuda", scale=1):
    """The engine on the card against the DES oracle: exact parity
    cases, then the fidelity cases (their oracle runs in threads on the
    host while the card runs the engine), each at its requests over
    ``scale``."""
    from concurrent.futures import ThreadPoolExecutor

    from isotope_tpu_torch.native.host import load_library
    from isotope_tpu_torch.sim.oracle import OracleSimulator

    t = time.perf_counter()
    load_library("des_oracle")
    log(f"build: des_oracle (g++) in {time.perf_counter() - t:.2f} s")
    det = port.SimParams(service_time="deterministic")
    quiet = port.LoadModel(kind="open", qps=0.001, duration_s=1.0)
    for name, text in PARITY.items():
        graph = port.ServiceGraph.from_yaml(text)
        chaos = (
            (port.ChaosEvent(service="b", start_s=0.0, end_s=1e9),)
            if name == "chaos-total-outage" else ()
        )
        res_e = port.Simulator(port.compile_graph(graph), det, chaos,
                               device=device).run(
            quiet, 32, port.TorchDraws(0, device))
        res_o = OracleSimulator(graph, det, chaos).run(quiet, 32, seed=0)
        lat_e = res_e.client_latency.double().cpu().numpy()
        np.testing.assert_allclose(res_o.client_latency, lat_e,
                                   rtol=PARITY_RTOL, err_msg=name)
        np.testing.assert_array_equal(
            res_o.client_error, res_e.client_error.cpu().numpy(), name)
        if res_o.hop_events != int(res_e.hop_events):
            raise AssertionError(f"oracle parity {name}: hop events")
        rel = float(np.max(np.abs(lat_e / res_o.client_latency - 1.0)))
        log(f"oracle parity ok {name}: 32 requests, largest relative "
            f"difference {rel:.3e}, {int(res_o.client_error.sum())} errors,"
            f" {res_o.hop_events} hop events")

    mu = 1.0 / port.SimParams().cpu_time_s
    cases = [
        (f"{name} open rho {rho:g}", text,
         port.LoadModel(kind="open", qps=rho * mu), 200_000 // scale,
         1_000_000 // scale)
        for name, text in (("chain3", CHAIN3), ("tree13", TREE13),
                           ("star9", STAR9))
        for rho in (0.3, 0.7)
    ] + [("chain3 paced closed c=64", CHAIN3,
          port.LoadModel(kind="closed", qps=0.5 * mu, connections=64),
          128_000 // scale, 512_000 // scale)]
    with ThreadPoolExecutor(max_workers=len(cases)) as pool:
        t = time.perf_counter()
        futures = [
            pool.submit(OracleSimulator(port.ServiceGraph.from_yaml(text))
                        .run, load, n_o, 0)
            for _, text, load, _, n_o in cases
        ]
        for (name, text, load, n_e, n_o), fut in zip(cases, futures):
            engine = port.Simulator(
                port.compile_graph(port.ServiceGraph.from_yaml(text)),
                device=device)
            res_e = engine.run(load, n_e, port.TorchDraws(0, device))
            lat_e = res_e.client_latency.double().cpu().numpy()
            res_o = fut.result()
            lat_o = res_o.client_latency[
                res_o.client_start >= ORACLE_WARMUP_S]
            rels = [float(np.quantile(lat_e, q) / np.quantile(lat_o, q)
                          - 1.0) for q in (0.5, 0.99)]
            line = (f"oracle fidelity {name}: engine {n_e} on the card, "
                    f"oracle {n_o}; p50 {rels[0]:+.4%}, p99 {rels[1]:+.4%}")
            bad = any(abs(r) > FIDELITY_BAND for r in rels)
            if load.kind == "closed":
                thr_o = len(res_o.client_latency) / float(
                    res_o.client_end.max())
                thr = float(res_e.offered_qps) / thr_o - 1.0
                line += f", throughput {thr:+.4%}"
                bad = bad or abs(thr) > THROUGHPUT_BAND
            log(line)
            if bad:
                raise AssertionError(f"oracle fidelity {name} out of band")
        log(f"oracle fidelity: {len(cases)} cases in "
            f"{time.perf_counter() - t:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from isotope_tpu_torch.compiler import compile_graph, compile_lb
    from isotope_tpu_torch.models.generators import (
        realistic_topology,
        tree_topology,
        with_call_policy,
    )
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.native import census as census_mod
    from isotope_tpu_torch.runner.config import DEFAULT_ENVIRONMENTS
    from isotope_tpu_torch.sim import (
        LoadModel,
        SimParams,
        Simulator,
        TorchDraws,
    )
    from isotope_tpu_torch.sim.config import (
        ChaosEvent,
        MtlsSchedule,
        TrafficSplit,
        bounce_schedule,
    )

    # the port's entry points, as a user calls them
    port = SimpleNamespace(
        compile_graph=compile_graph, compile_lb=compile_lb,
        ServiceGraph=ServiceGraph,
        LoadModel=LoadModel, Simulator=Simulator, TorchDraws=TorchDraws,
        census=census_mod.census, realistic_topology=realistic_topology,
        with_call_policy=with_call_policy, SimParams=SimParams,
        ChaosEvent=ChaosEvent, TrafficSplit=TrafficSplit,
        MtlsSchedule=MtlsSchedule, bounce_schedule=bounce_schedule,
        DEFAULT_ENVIRONMENTS=DEFAULT_ENVIRONMENTS,
    )

    # full-precision float32 products everywhere (the copula matmul)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name_power = card()
    log(name_power)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t = time.perf_counter()
    lib = census_mod.LIBRARY.build()
    log(f"build: {lib.name} in {time.perf_counter() - t:.2f} s")
    log(census_mod.LIBRARY.build_log.strip())

    flagship_graph = ServiceGraph.decode(tree_topology(
        num_levels=5, num_branches=3, request_size=1024, response_size=1024,
    ))
    build_s = {}
    runs = main_path_runs(port, flagship_graph, build_s=build_s)
    scenarios = scenario_runs(port, build_s) + lb_runs(port)
    runs += [run[:5] for run in scenarios]
    timing = kernel_phase(census_mod, runs, census_only_configs(port))

    def plain(graph):
        compiled = compile_graph(graph)
        return lambda device: Simulator(compiled, device=device)

    def open_case(name, graph, qps, n=16_384, rtol=RESULT_RTOL):
        return (name, plain(graph), LoadModel(kind="open", qps=qps), n,
                None, rtol, RESULT_ATOL)

    scenario_tol = {
        "svc100k-chaos": (RESULT_RTOL, RESULT_ATOL),
        "canonical-2r-storm": (RESULT_RTOL, STORM_ATOL),
        "canonical-2r-qps-max-bounce": (SAT_RTOL, SAT_ATOL),
        "lb-10svc-100r-panic": (RESULT_RTOL, RESULT_ATOL),
    }
    in_situ_phase(port, [
        open_case("flagship", flagship_graph, 1e3),
        open_case("census-test", ServiceGraph.from_yaml(CENSUS_YAML), 500.0),
        open_case("realistic-powerlaw-100", ServiceGraph.from_yaml_file(
            TOPOLOGIES / "realistic-powerlaw-100.yaml"), 6500.0),
        open_case("star-10k-timeouts", star10k_graph(port), STAR10K_QPS,
                  n=3355, rtol=STAR_RTOL),
        ("canonical-qps-max", plain(ServiceGraph.from_yaml_file(
            TOPOLOGIES / "canonical.yaml")),
         LoadModel(kind="closed", qps=None, connections=64), 16_384, None,
         SAT_RTOL, SAT_ATOL),
    ] + [
        # svc100k: its first two blocks; the canonical runs and the panic
        # run: every block
        (name, make, load, min(n, 2 * block), block, *scenario_tol[name])
        for name, _, load, n, block, make in scenarios
        if name in scenario_tol
    ] + [
        (name, make, load, 16_384, None, RESULT_RTOL, RESULT_ATOL)
        for name, _, load, _, _, make in scenarios
        if name == "lb-1000svc-lr"
    ])

    by_path = main_path_phase(port, runs, build_s, timing["ms_per_block"])
    launches = sum(by_path.values())
    panic_share(port, *[run[1:5] for run in runs
                        if run[0] == "lb-10svc-100r-panic"][0])
    cli_phase()
    oracle_phase(port)

    kernels = [{
        "name": "census",
        "route": "cuda",
        "source": "isotope_tpu_torch/native/csrc/census.cu",
        "replaces": "isotope_tpu/native/census_pallas.py:146",
        "launches": launches,
        "launches_by_path": by_path,
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"],
        "ms_per_block": timing["ms_per_block"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]
    if not all(math.isfinite(k["ms"]) for k in kernels) or launches <= 0:
        raise AssertionError("kernel table incomplete")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(name_power)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
