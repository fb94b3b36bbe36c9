"""The CUDA blame-sweep kernel against its plain twin, on the card.

These tests need a CUDA device and skip without one (the kernel has no
CPU mode).  They import nothing of JAX, so they also run on a machine
without it: ``python -m pytest --noconftest -m cuda
tests/test_torch_blame_cuda.py``.

The kernel equals ``attribution.blame_sweep_sequential`` (its own order
of summation) bit for bit, block after block into one accumulator.
"""
import numpy as np
import pytest
import torch
import yaml

from isotope_tpu_torch.compiler import compile_graph
from isotope_tpu_torch.metrics import attribution
from isotope_tpu_torch.models.generators import (
    tree_topology,
    with_call_policy,
)
from isotope_tpu_torch.models.graph import ServiceGraph
from isotope_tpu_torch.native import blame
from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator, TorchDraws
from isotope_tpu_torch.sim.config import ChaosEvent

RETRY_YAML = """
services:
- name: entry
  isEntrypoint: true
  errorRate: 2%
  script:
  - call: {service: mid, timeout: 400us, retries: 2}
  - sleep: 1ms
- name: mid
  errorRate: 5%
  numReplicas: 2
  script:
  - - call: {service: leaf, probability: 60}
    - call: leaf2
  - call: {service: leaf, timeout: 2ms}
- name: leaf
- name: leaf2
"""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _sim(name):
    if name == "1000-svc-retries":
        # every call retried twice: a last level of 60,021 hops
        with open("examples/topologies/1000-svc_2000-end.yaml") as f:
            doc = with_call_policy(yaml.safe_load(f), timeout="15s",
                                   retries=2)
        return Simulator(compile_graph(ServiceGraph.decode(doc)),
                         SimParams(attribution=True), device="cuda")
    if name == "retries-timeouts":
        return Simulator(
            compile_graph(ServiceGraph.from_yaml(RETRY_YAML)),
            SimParams(attribution=True),
            (ChaosEvent("leaf2", 0.2, 0.6, replicas_down=None,
                        drain=False),),
            device="cuda",
        )
    return Simulator(compile_graph(ServiceGraph.decode(tree_topology(
        num_levels=5, num_branches=3, request_size=1024, response_size=1024,
    ))), SimParams(attribution=True), device="cuda")


def same_summary(got, want):
    """Equal field by field (``torch.equal``: +0 and -0 alike, as a new
    accumulator adds its first block to 0)."""
    for name in attribution.AttributionSummary._fields:
        a, b = getattr(got, name), getattr(want, name)
        if a is None:
            assert b is None, name
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.equal(a, b), name


# (topology, qps, rows a member, members, blocks, tail)
CASES = [
    ("tree121", 1e4, 262_144, 0, 2, True),    # the flagship cell's block
    ("tree121", 1e4, 8_192, 0, 1, False),     # the tail pilot's
    ("tree121", 1e4, 8_192, 4, 2, True),      # a folded fleet block
    ("retries-timeouts", 2000.0, 3_000, 0, 2, True),
    ("retries-timeouts", 2000.0, 1_000, 3, 1, False),
    # a level of 60,021 hops: the crit bits in device memory
    ("1000-svc-retries", 1e4, 2_048, 0, 2, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("topo,qps,rows,members,blocks,tail", CASES)
def test_kernel_equals_sequential(card, topo, qps, rows, members, blocks,
                                  tail):
    sim = _sim(topo)
    tables = sim._attribution_tables()
    load = LoadModel(kind="open", qps=qps)
    n = rows * max(members, 1)
    shape = (members, tables.num_hops, tables.num_services)
    acc = attribution.accumulator(*shape, "cuda")
    bufs = attribution._acc_buffers(acc, *shape, acc.wait_blame.device)
    want = cut = None
    start = blame.blame_sweep.launches
    for b in range(blocks):
        res = sim.run(load, n, TorchDraws(b, "cuda"))
        if tail and cut is None:
            cut = float(np.quantile(res.client_latency.cpu().numpy(), 0.99))
        blame.blame_sweep(res, tables, *bufs, tail_cut=cut, members=members)
        want = attribution.blame_sweep_sequential(
            res, tables, tail_cut=cut, members=members, acc=want)
    torch.cuda.synchronize()
    assert blame.blame_sweep.launches - start == blocks
    same_summary(acc, want)
    assert int(acc.crit_count.sum()) > 0


@pytest.mark.cuda
def test_attribute_block_goes_through_the_kernel(card):
    sim = _sim("tree121")
    tables = sim._attribution_tables()
    res = sim.run(LoadModel(kind="open", qps=1e4), 4096,
                  TorchDraws(0, "cuda"))
    start = blame.blame_sweep.launches
    got, _ = attribution.attribute_block(res, tables, tail_cut=0.002)
    assert blame.blame_sweep.launches == start + 1
    same_summary(got, attribution.blame_sweep_sequential(res, tables,
                                                         tail_cut=0.002))


@pytest.mark.cuda
def test_kernel_refuses_a_foreign_accumulator(card):
    sim = _sim("tree121")
    tables = sim._attribution_tables()
    res = sim.run(LoadModel(kind="open", qps=1e4), 1024,
                  TorchDraws(0, "cuda"))
    chain = attribution.blame_sweep_sequential(res, tables)
    with pytest.raises(ValueError, match="not a view"):
        attribution.attribute_block(res, tables, acc=chain)
