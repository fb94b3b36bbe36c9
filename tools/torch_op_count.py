"""Count the torch ops (host launches) of a protected block, on the CPU.

    python3 tools/torch_op_count.py

For each protected run of ``chip_smoke.py`` (policies-1000svc-kill,
rollouts-multitier-1000-clean, policies-smoke), at a small block of the
same hops (the count of ops a block does not depend on its requests),
prints the ops of one block of the plain run (``run_summary``), of the
recorded run (``run_timeline``) and of the protected run
(``run_policies`` / ``run_rollouts``) while no window completes, and the
ops of the control law per completed window (``advance`` over one
window).  Every op a block dispatches is one launch on the card.  Ops
are counted with a ``TorchDispatchMode``; runs on the CPU, needs no
card.
"""
from __future__ import annotations

import pathlib
import sys
from types import SimpleNamespace

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: requests of a counted block, and the window that no block completes
BLOCK, WINDOW_S = 64, 1e3


class OpLog(TorchDispatchMode):
    """The names of the torch ops dispatched inside the ``with`` block
    (``tests/test_torch_policies.py`` pins a plain block's by them)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    @property
    def count(self) -> int:
        return len(self.ops)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def _per_block(fn, blocks=2):
    fn(BLOCK)  # fill the caches
    with OpLog() as ops:
        fn(blocks * BLOCK)
    return ops.count / blocks


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from isotope_tpu_torch.compiler import (
        compile_graph,
        compile_policies,
        compile_rollouts,
    )
    from isotope_tpu_torch.metrics import timeline as timeline_mod
    from isotope_tpu_torch.models.generators import (
        realistic_topology,
        with_call_policy,
    )
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.runner.run import protected_window_block
    from isotope_tpu_torch.sim import LoadModel, SimParams, Simulator
    from isotope_tpu_torch.sim import TorchDraws
    from isotope_tpu_torch.sim import policies as policies_mod
    from isotope_tpu_torch.sim import rollout as rollout_mod
    from isotope_tpu_torch.sim.config import ChaosEvent

    port = SimpleNamespace(
        compile_graph=compile_graph, compile_policies=compile_policies,
        compile_rollouts=compile_rollouts, ServiceGraph=ServiceGraph,
        LoadModel=LoadModel, Simulator=Simulator, SimParams=SimParams,
        ChaosEvent=ChaosEvent, realistic_topology=realistic_topology,
        with_call_policy=with_call_policy,
        protected_window_block=protected_window_block,
    )
    runs = chip_smoke.protected_runs(port, device="cpu")
    for name, sim, load, _, _, _, roll, _ in runs:
        if name == "rollouts-multitier-1000-bad":
            continue
        src = TorchDraws(0, "cpu")
        plain = _per_block(lambda n: sim.run_summary(
            load, n, src, block_size=BLOCK))
        recorded = _per_block(lambda n: sim.run_timeline(
            load, n, src, block_size=BLOCK, window_s=WINDOW_S))
        run = sim.run_rollouts if roll else sim.run_policies
        protected = _per_block(lambda n: run(
            load, n, src, block_size=BLOCK, window_s=WINDOW_S))
        # the control laws over one completed window
        spec = timeline_mod.build_spec(sim.compiled, 2, 1.0)
        S = sim.compiled.num_services
        laws = []
        one = torch.tensor(1.0)
        if sim._policies is not None:
            pd = policies_mod.device_tables(sim._policies)
            tl = timeline_mod.zeros_summary(spec)
            retry = torch.zeros((S, 2))
            with OpLog() as ops:
                policies_mod.advance(policies_mod.init_state(pd), pd, tl,
                                     retry, one, spec)
            laws.append(f"policy law {ops.count} per window")
        if roll:
            rd = rollout_mod.device_tables(sim._rollouts)
            obs = torch.zeros((S, 2, 2, 4))
            with OpLog() as ops:
                rollout_mod.advance(rollout_mod.init_state(rd), rd, obs,
                                    one, spec)
            laws.append(f"rollout law {ops.count} per window")
        print(f"{name}: {sim.compiled.num_hops} hops; ops per block: "
              f"plain {plain:g}, recorded {recorded:g}, protected "
              f"{protected:g} (no window completed); "
              + ", ".join(laws), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
