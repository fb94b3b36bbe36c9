"""The run supervisor and engine telemetry on the card.

These tests need a CUDA device and skip without one (a real CUDA
out-of-memory error and the card's fences have no CPU mode).  They
import nothing of JAX, so they also run on a machine without it:
``python -m pytest --noconftest -m cuda tests/test_torch_runner_cuda.py``.
"""
import pathlib

import pytest
import torch

from isotope_tpu_torch import telemetry
from isotope_tpu_torch.compiler import compile_graph
from isotope_tpu_torch.models.graph import ServiceGraph
from isotope_tpu_torch.resilience import (
    RESOURCE_EXHAUSTED,
    ResiliencePolicy,
    classify,
    execution_rungs,
    run_ladder,
)
from isotope_tpu_torch.sim import LoadModel, Simulator, TorchDraws

CANONICAL = pathlib.Path(__file__).resolve().parents[1] / (
    "examples/topologies/canonical.yaml")
OPEN = LoadModel(kind="open", qps=2000.0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a real CUDA OOM and the card's "
                    "fences have no CPU mode")
    yield
    telemetry.reset()
    telemetry.disable()


def _too_big():
    """A real allocation failure of the caching allocator."""
    free, total = torch.cuda.mem_get_info()
    return torch.empty(4 * total, dtype=torch.uint8, device="cuda")


@pytest.mark.cuda
def test_a_real_cuda_oom_is_resource_exhausted(card):
    with pytest.raises(torch.cuda.OutOfMemoryError) as err:
        _too_big()
    assert classify(err.value) == RESOURCE_EXHAUSTED
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_ladder_serves_a_case_whose_first_rung_runs_out_of_memory(card):
    """The first rung raises a real ``torch.cuda.OutOfMemoryError``; the
    ladder degrades to ``half-block`` on the card and serves the run,
    equal to a half-block run of the same draws."""
    sim = Simulator(compile_graph(ServiceGraph.from_yaml_file(CANONICAL)),
                    device="cuda")
    source = TorchDraws(5, "cuda")
    rungs = execution_rungs(sim, OPEN, 4096, source, 2048)
    first = rungs[0][1]

    def oom_then_run():
        _too_big()
        return first()

    rungs[0] = ("scan", oom_then_run)
    (summary, _), degraded = run_ladder(
        rungs, ResiliencePolicy(sleep=lambda s: None))
    assert degraded == "half-block"
    assert summary.count.device.type == "cuda"
    want = sim.run_summary(OPEN, 4096, source, block_size=1024, trim=True)
    assert torch.equal(summary.latency_hist, want.latency_hist)
    assert telemetry.counter_get("degradations_total") == 1.0


@pytest.mark.cuda
def test_detail_fences_synchronize_the_card(card, monkeypatch):
    sim = Simulator(compile_graph(ServiceGraph.from_yaml_file(CANONICAL)),
                    device="cuda")
    calls = []
    sync = torch.cuda.synchronize

    def counting(*a):
        calls.append(a)
        return sync(*a)

    monkeypatch.setattr(torch.cuda, "synchronize", counting)
    sim.run_summary(OPEN, 1024, TorchDraws(0, "cuda"), block_size=1024)
    assert calls == []  # telemetry off: no fence
    telemetry.enable(detail=True)
    sim.run_summary(OPEN, 1024, TorchDraws(0, "cuda"), block_size=1024)
    fences = telemetry.counter_get("engine_fences")
    assert fences == 2 * len(sim._levels) and len(calls) == fences
    assert telemetry.record_device_memory() > 0
