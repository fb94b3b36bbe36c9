"""Profiler capture: the backend of ``telemetry --xla-trace`` and of
``sweep --profile``.

The port of ``isotope_tpu.telemetry.profile``: where the reference
captures a ``jax.profiler`` trace (TensorBoard/XProf), the port captures
a ``torch.profiler`` one and writes it as a Chrome trace
(``chrome://tracing``, Perfetto), with the CUDA activity when the run is
on the card.
"""
from __future__ import annotations

import contextlib
import pathlib
from typing import Iterator, List, Optional


def build_simulator(topology: Optional[str] = None, device=None):
    """A Simulator for ``topology`` (YAML path), or the flagship
    ~120-service tree (the bench headline) when ``None``."""
    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.sim import Simulator

    if topology is None:
        from isotope_tpu_torch.models.generators import tree_topology

        graph = ServiceGraph.decode(tree_topology(
            num_levels=5, num_branches=3, request_size=1024,
            response_size=1024,
        ))
    else:
        graph = ServiceGraph.from_yaml_file(topology)
    return Simulator(compile_graph(graph), device=device)


@contextlib.contextmanager
def torch_trace(out_dir) -> Iterator[None]:
    """Profile the body with ``torch.profiler`` (CPU activity, and CUDA
    activity when a card is present) and write ``trace.json`` (Chrome
    trace format) under ``out_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


def capture_torch_trace(
    out_dir: str,
    topology: Optional[str] = None,
    num_requests: int = 65_536,
    qps: float = 100_000.0,
    steps: int = 3,
    seed: int = 0,
    sim=None,
) -> List[str]:
    """Capture a profiler trace of ``steps`` warmed summary runs.

    Pass an already-built ``sim`` to skip building the topology again
    (the ``telemetry`` command does); otherwise ``topology`` selects the
    graph as in :func:`build_simulator`.  The first run happens OUTSIDE
    the capture window so the trace shows steady-state device work.
    Step ``i`` draws from ``RootedSource(TorchDraws(seed), 1 + i)``.
    Returns the trace files written under ``out_dir``.
    """
    from isotope_tpu_torch.sim import LoadModel, TorchDraws
    from isotope_tpu_torch.sim.draws import RootedSource

    if sim is None:
        sim = build_simulator(topology)
    load = LoadModel(kind="open", qps=qps)
    block = min(sim.default_block_size(), num_requests)
    source = TorchDraws(seed, sim.device)

    def step(src):
        return sim.run_summary(load, num_requests, src, block_size=block)

    float(step(source).count)  # warm-up, outside the capture
    with torch_trace(out_dir):
        out = None
        for i in range(steps):
            out = step(RootedSource(source, 1 + i))
        float(out.count)
    return sorted(str(p) for p in pathlib.Path(out_dir).glob("**/*.json"))
