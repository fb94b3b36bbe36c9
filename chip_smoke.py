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
   at every census shape of the main path (each level with children of
   the four runs of phase 5 and of the closed loop's rate pilot, as
   ``Simulator.census_shapes`` gives them), at the default blocks of
   ``realistic-star-50.yaml`` and ``realistic-star-auxiliary-50.yaml``
   and at fixture shapes, among them a 4,096-step axis (rtol 1e-5: the
   plain version's ``cumsum`` may associate differently), and bit for
   bit against ``census_sequential``, the kernel's own order of
   operations in plain torch.  Then, per census call of one block of each
   of those six configurations, print the kernel's device-only time
   (``torch.profiler``'s device time for the kernel's own name, L2
   flushed before every launch), its bound and share of bound, the
   wrapper's host cost (host clock over a few hundred enqueues) and the
   plain version's time, and per block the sums;
4. in situ: one block of 16,384 requests of the flagship tree (1000 qps),
   of the retry/timeout/error topology (500 qps) and of
   ``realistic-powerlaw-100.yaml`` (6,500 qps), with the same draws, on
   the card (kernel) and on the CPU (plain version), compared like the
   CPU tests compare the port with the JAX package;
5. main path at full size, after one warm-up block of each run (the
   warm-up also solves and caches the closed loop's rate from the same
   seed, so the timed closed-loop run skips the pilot): the flagship
   (121 hops) open loop at 100k qps in 4 blocks of 262,144 requests,
   ``1000-svc_2000-end.yaml`` open loop at 10k qps in blocks of 32,768,
   ``canonical.yaml`` paced closed loop at the CLI defaults, and
   ``realistic-powerlaw-100.yaml`` open loop at 6,500 qps (half its
   capacity) in 2 blocks of its default 335,544; the launch count is set
   to 0 just before each run and must equal its blocks times its census
   calls per block just after;
6. the CLI once on the card, as a subprocess.

It then prints the kernel table as one JSON line and, last, the result
line ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
with code 1 and prints no result.
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
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


def device_ms(fn, flush, reps=20):
    """Mean device-only time of the census kernel in ``fn``: the
    profiler's device time for kernels whose name holds ``census``, over
    ``reps`` calls, each after an L2 flush."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
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
    if count != reps or total_us <= 0:
        raise AssertionError(
            f"profiler: {count} census kernels with {total_us} us of device "
            f"time, expected {reps} launches"
        )
    return total_us / count / 1e3


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
            shapes += sim.census_shapes(PILOT_N)
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


def compare_results(got, want, what):
    for name in ("hop_sent", "hop_error", "client_error", "unstable"):
        a = getattr(got, name).cpu()
        b = getattr(want, name).cpu()
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} differs")
    for name in ("client_start", "client_latency", "hop_latency",
                 "hop_start", "utilization"):
        torch.testing.assert_close(
            getattr(got, name).cpu(), getattr(want, name).cpu(),
            rtol=RESULT_RTOL, atol=RESULT_ATOL, msg=lambda m: f"{what}: {m}",
        )


def in_situ_phase(port, graphs):
    for name, graph, qps in graphs:
        compiled = port.compile_graph(graph)
        source = port.TorchDraws(11, "cuda")
        load = port.LoadModel(kind="open", qps=qps)
        before = port.census.launches
        on_card = port.Simulator(compiled, device="cuda").run(
            load, 16_384, source
        )
        torch.cuda.synchronize()
        if port.census.launches == before:
            raise AssertionError(f"in situ {name}: kernel never launched")
        on_cpu = port.Simulator(compiled, device="cpu").run(
            load, 16_384, source
        )
        compare_results(on_card, on_cpu, f"in situ {name}")
        log(f"in situ ok {name}: card (kernel) == cpu (plain), "
            f"{int(on_card.hop_events)} hop events")


# -- phase 5: the main path at full size -----------------------------------------


def main_path_runs(port, flagship_graph, device="cuda"):
    """The four runs of the main path: (name, simulator, load,
    requests, block size)."""
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
    return [
        ("flagship", flagship, port.LoadModel(kind="open", qps=1e5),
         4 * 262_144, 262_144),
        ("1000-svc_2000-end", svc1000, port.LoadModel(kind="open", qps=1e4),
         262_144, 32_768),
        ("canonical closed c=64", canonical, closed, closed_n, closed_block),
        ("realistic-powerlaw-100", powerlaw,
         port.LoadModel(kind="open", qps=powerlaw.capacity_qps() / 2),
         2 * powerlaw_block, powerlaw_block),
    ]


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


def main_path_run(port, name, sim, load, n, block):
    """One timed run; returns its census launches."""
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
    if count != n:
        raise AssertionError(f"{name}: count {count} != requests {n}")
    if not np.all(np.isfinite(qs)) or not np.all(qs > 0):
        raise AssertionError(f"{name}: bad quantiles {qs}")
    per_block = len(sim.census_shapes(block))
    if launches != blocks * per_block:
        raise AssertionError(
            f"{name}: {launches} census launches, expected {blocks} "
            f"blocks x {per_block}"
        )
    log(f"main path {name}: {count} requests in {blocks} blocks, "
        f"{wall / blocks * 1e3:.2f} ms per block, "
        f"{hop_events / wall:.4e} hop-events/s, p50/p90/p99 "
        f"{qs[0] * 1e3:.4f}/{qs[1] * 1e3:.4f}/{qs[2] * 1e3:.4f} ms, "
        f"census launches {launches} ({per_block} per block)")
    return summary, launches


def main_path_phase(port, runs):
    """Each run once, after one warm-up block of each; returns the census
    launches per run."""
    # one block of each first, so the timed runs do not pay the caching
    # allocator's first growth and the first launches; the same seed as
    # the timed runs, so the closed loop's cached rate is that run's own
    for _, sim, load, _, block in runs:
        sim.run_summary(load, block, port.TorchDraws(0, "cuda"),
                        block_size=block)
    torch.cuda.synchronize()

    launches = {}
    for run in runs:
        summary, launches[run[0]] = main_path_run(port, *run)
        if run[0] == "flagship" and (
            float(summary.hop_events) != 121 * int(summary.count)
        ):
            raise AssertionError(
                f"flagship: hop_events {float(summary.hop_events)} != "
                f"121 x {int(summary.count)}"
            )
    log(f"census launches on the main path: {sum(launches.values())} "
        f"{launches}")
    return launches


def cli_phase():
    out = subprocess.run(
        [sys.executable, "-m", "isotope_tpu_torch", "simulate",
         str(TOPOLOGIES / "canonical.yaml"), "--qps", "1000",
         "--duration", "10s", "--load-kind", "open"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    if out.returncode != 0:
        raise AssertionError(f"CLI failed:\n{out.stderr}")
    doc = json.loads(out.stdout)
    count = doc["DurationHistogram"]["Count"]
    if count != 10_000:
        raise AssertionError(f"CLI: Count {count} != 10000")
    log(f"cli ok: {count} requests, p99 "
        f"{doc['DurationHistogram']['Percentiles'][3]['Value'] * 1e3:.4f} ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.models.generators import tree_topology
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.native import census as census_mod
    from isotope_tpu_torch.sim import LoadModel, Simulator, TorchDraws

    # the port's entry points, as a user calls them
    port = SimpleNamespace(
        compile_graph=compile_graph, ServiceGraph=ServiceGraph,
        LoadModel=LoadModel, Simulator=Simulator, TorchDraws=TorchDraws,
        census=census_mod.census,
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
    runs = main_path_runs(port, flagship_graph)
    timing = kernel_phase(census_mod, runs, census_only_configs(port))

    in_situ_phase(port, [
        ("flagship", flagship_graph, 1e3),
        ("census-test", ServiceGraph.from_yaml(CENSUS_YAML), 500.0),
        ("realistic-powerlaw-100", ServiceGraph.from_yaml_file(
            TOPOLOGIES / "realistic-powerlaw-100.yaml"), 6500.0),
    ])

    by_path = main_path_phase(port, runs)
    launches = sum(by_path.values())
    cli_phase()

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
