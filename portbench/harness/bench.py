"""One run of one cell: set-up, the measured window, the check, the line.

The window runs simulated experiments back to back, each one call of
the cell's entry under its own streams (``BenchSource(seed, (k,))``),
and ends at the first experiment boundary after ``--seconds``; every
experiment ends with a host read of its summaries.  With ``--trace 1``
a few whole experiments inside the window run under the profiler, and
the cell's per-layer metrics are read from them; without it, its
end-to-end metrics are.  After the window the program's state is freed
and sampled experiments are held against the plain reference.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import List, Optional

import numpy as np
import torch

from portbench.harness import cells, check, trace
from portbench.harness.roofline import CensusWork
from portbench.harness.source import BenchSource
from portbench.reference.sim import Model

#: modules that must not be loaded in the process that prints the result
FORBIDDEN = ("jax", "jaxlib", "flax", "isotope_tpu")
#: the experiment path of the set-up's warm-up runs, never a window's
WARM_PATH = (1 << 40,)


def program() -> SimpleNamespace:
    """The program under test: the entry points the benchmark drives."""
    from isotope_tpu_torch.compiler.compile import compile_graph
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.native import census
    from isotope_tpu_torch.sim import (
        Draws, LoadModel, NetworkModel, SimParams, Simulator,
    )
    from isotope_tpu_torch.sim.ensemble import EnsembleSpec

    return SimpleNamespace(
        compile_graph=compile_graph, ServiceGraph=ServiceGraph,
        census=census, Draws=Draws, LoadModel=LoadModel,
        NetworkModel=NetworkModel, SimParams=SimParams,
        Simulator=Simulator, EnsembleSpec=EnsembleSpec,
    )


def sim_params(port, params: dict, **extra):
    """The program's model parameters from a configuration file."""
    return port.SimParams(
        cpu_time_s=params["cpu_time_s"],
        service_time=params["service_time"],
        network=port.NetworkModel(
            base_latency_s=params["network_base_latency_s"],
            bytes_per_second=params["network_bytes_per_second"],
        ),
        sibling_copula_r=params["sibling_copula_r"],
        retry_copula_r=params["retry_copula_r"],
        hierarchical_copula_gamma=params["hierarchical_copula_gamma"],
        **extra,
    )


@dataclasses.dataclass
class Ctx:
    """What an entry and a metric reader see of one run."""

    cell: cells.Cell
    port: SimpleNamespace
    device: torch.device
    seed: int
    sim: object = None
    plan_build_s: float = 0.0
    setup_s: float = 0.0
    window_s: float = 0.0
    hop_events: float = 0.0
    peak_bytes: int = 0
    device_name: str = "cpu"
    trace: Optional[trace.Trace] = None
    profiled_experiments: int = 0
    census_work: Optional[CensusWork] = None

    @property
    def workload(self) -> dict:
        return self.cell.workload

    def load(self):
        """The program's load of one experiment, as the entry makes it."""
        return self.cell.entry.load(self)

    def source(self, path):
        return BenchSource(self.seed, path, self.device, self.port.Draws)

    def warm_source(self):
        """The streams of set-up's warm-up runs, never a window's."""
        return self.source(WARM_PATH)

    def blocks(self) -> int:
        """Blocks of one experiment (a fleet's fold counts once)."""
        return self.cell.entry.blocks(self)

    def host_runs(self, summary, members: int = 0) -> List[check.Run]:
        """One host read of a RunSummary (``members``: its leaves carry
        a leading member axis) as one ``check.Run`` a member."""
        m = max(members, 1)
        leaves = [summary.count, summary.error_count, summary.hop_events,
                  summary.latency_sum, summary.latency_hist,
                  summary.utilization]
        flat = torch.cat([x.reshape(m, -1).to(torch.float64)
                          for x in leaves], 1).cpu().numpy()
        nb = summary.latency_hist.shape[-1]
        return [check.Run(count=r[0], errors=r[1], hop_events=r[2],
                          latency_sum=r[3], hist=r[4:4 + nb],
                          utilization=r[4 + nb:]) for r in flat]


def build(ctx: Ctx) -> None:
    """Build the program's simulator for the cell (timed: plan)."""
    port = ctx.port
    extra = getattr(ctx.cell.entry, "params", lambda c: {})(ctx)
    params = sim_params(port, ctx.cell.config["params"], **extra)
    t = time.perf_counter()
    graph = port.ServiceGraph.decode(ctx.cell.config["topology"])
    ctx.sim = port.Simulator(port.compile_graph(graph), params=params,
                             device=ctx.device)
    ctx.plan_build_s = time.perf_counter() - t


def _profiled(ctx: Ctx, first: int, count: int):
    """Run ``count`` experiments from ``first`` under the profiler, and
    check that it recorded every census launch they made."""
    launches = ctx.port.census.census.launches

    def experiments():
        out = []
        for k in range(first, first + count):
            with torch.profiler.record_function(trace.LABEL):
                out.append(ctx.cell.entry.run(ctx, ctx.source((k,))))
        return out

    runs, tr = trace.capture(experiments)
    made = ctx.port.census.census.launches - launches
    return runs, tr, tr.count("census") == made, made


def window(ctx: Ctx, seconds: float, traced: bool) -> List[List[check.Run]]:
    """The measured window; sets the context's window readings."""
    dev = ctx.device
    w = ctx.workload
    to_profile = w.get("profile_experiments", 1) if traced else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    runs: List[List[check.Run]] = []
    t0 = time.perf_counter()
    while True:
        k = len(runs)
        if to_profile and k >= 1 and ctx.trace is None:
            for _ in range(2):
                got, tr, whole, made = _profiled(ctx, k, to_profile)
                runs += got
                k = len(runs)
                if whole:
                    ctx.trace = tr
                    ctx.profiled_experiments = to_profile
                    break
                print(f"profiler: {tr.count('census')} census kernels "
                      f"recorded of {made} launched", file=sys.stderr)
            else:
                raise RuntimeError("the profiler dropped census launches "
                                   "twice; no traced reading")
        else:
            runs.append(ctx.cell.entry.run(ctx, ctx.source((k,))))
        if time.perf_counter() - t0 >= seconds and (
                not to_profile or ctx.trace is not None):
            break
    ctx.window_s = time.perf_counter() - t0
    if dev.type == "cuda":
        ctx.peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    ctx.hop_events = float(sum(r.hop_events for rs in runs for r in rs))
    return runs


def reference_run(ctx: Ctx, model: Model, seed: int, k: int, prefix,
                  judged: Optional[check.Run] = None) -> check.Run:
    """The reference's run of experiment ``k``'s member at ``prefix``,
    judging ``judged`` where given."""
    return ctx.cell.entry.reference(ctx, model, seed, (k,) + tuple(prefix),
                                    judged)


def judge(ctx: Ctx, runs: List[List[check.Run]]):
    """Hold sampled experiments against the reference; frees the
    program's simulator first."""
    w = ctx.workload
    ctx.sim = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng([ctx.seed, 0xC3EC])
    picks = rng.choice(len(runs), size=min(w.get("check_experiments", 1),
                                           len(runs)), replace=False)
    model = Model(ctx.cell.config, ctx.device)
    readings = []
    for k in sorted(int(p) for p in picks):
        for prog, prefix in zip(runs[k], ctx.cell.entry.prefixes(ctx)):
            ref = reference_run(ctx, model, ctx.seed, k, prefix, prog)
            readings.append(check.entry_gaps(ctx.cell.entry, prog, ref))
    failed = sum(not check.judge(r, w["limits"])[0] for r in readings)
    ok, checks = check.judge(check.worst(readings), w["limits"])
    return ok, checks, failed


def metrics(ctx: Ctx, traced: bool) -> dict:
    out = {}
    for m in (ctx.cell.per_layer if traced else ctx.cell.end_to_end):
        v = m.read(ctx)
        if v is not None:
            out[m.name] = {"value": float(v), "unit": m.unit}
    return out


def power_line() -> str:
    try:
        p = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return p.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def forbidden_modules() -> List[str]:
    loaded = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             t_start: float, device="cuda", bench: Optional[dict] = None,
             base=cells.BASE) -> dict:
    """One run; returns the result line's object (``correct`` etc.)."""
    bench = bench if bench is not None else cells.load_bench()
    cell = cells.load_cell(name, bench, base)
    dev = torch.device(device)
    ctx = Ctx(cell=cell, port=program(), device=dev, seed=seed)
    if dev.type == "cuda":
        ctx.port.census.LIBRARY.get()   # nvcc, once a checkout
        ctx.device_name = torch.cuda.get_device_name(dev)
    build(ctx)
    cell.entry.warm(ctx)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ctx.setup_s = time.perf_counter() - t_start
    runs = window(ctx, seconds, traced)
    ctx.census_work = CensusWork(cell.config)
    line_metrics = metrics(ctx, traced)
    ok, checks, failed = judge(ctx, runs)
    result = {
        "correct": ok,
        "attempted": sum(len(rs) for rs in runs),
        "failed": failed,
        "metrics": line_metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": ctx.device_name,
            "count": 1,
            "memory_peak_bytes": ctx.peak_bytes,
        },
    }
    if traced:
        tr = ctx.trace
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = cells.load_bench()
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(
        args.workload)
    if chips is None:
        print(f"no cell {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # the streams' generator takes a non-negative seed of up to 64 bits
    result = run_cell(args.workload, args.seed % 2**64, args.seconds,
                      bool(args.trace), t_start, bench=bench)
    found = forbidden_modules()
    if found:
        print("loaded in the measuring process: " + ", ".join(found),
              file=sys.stderr)
        return 3
    print(f"device: {result['device']['kind']} x {result['device']['count']}"
          f"; nvidia-smi name, power limit: {power_line()}", file=sys.stderr)
    for k, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {k} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

