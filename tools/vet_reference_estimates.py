"""The JAX package's pre-flight estimate for ``chip_smoke.py`` phase 10's
topologies, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/vet_reference_estimates.py [NAME ...]

For each of phase 10's six full-size topologies (flagship,
``1000-svc_2000-end``, star-10k-timeouts, svc100k-chaos,
lb-10svc-100r-panic, policies-1000svc-kill), built by the reference
package as phase 5 builds it in the port, prints one JSON line: the
reference's ``vet_simulator`` cost meta (traced: its jaxpr at 8
requests scaled to the block; and ``--no-trace``: the plan table) at the
block the port's gate estimates (phase 5's block, capped by the
runner's default block), and the seconds the reference's vet took.

The reference reads ``jax.core.Literal`` / ``ClosedJaxpr`` / ``Jaxpr``,
which jax 0.9 moved to ``jax.extend.core``: this script aliases the
three names (and ``jax.experimental.enable_x64``) before it imports the
package, as ``tests/test_torch_vet.py``'s fixture does for one test.
Nothing of the port is imported; the reference is not edited.
"""
from __future__ import annotations

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOPOLOGIES = ROOT / "examples" / "topologies"


def _alias() -> None:
    import jax
    import jax.extend.core as jec

    for name in ("Literal", "ClosedJaxpr", "Jaxpr"):
        setattr(jax.core, name, getattr(jec, name))
    jax.experimental.enable_x64 = lambda: jax.enable_x64(True)


def cases():
    """``(name, make)``: ``make()`` builds ``(simulator, load, block)``
    with the reference's package, at phase 5's sizes (``chip_smoke``'s
    constants)."""
    import yaml

    import chip_smoke as cs
    from isotope_tpu.compiler import (
        compile_graph,
        compile_lb,
        compile_policies,
    )
    from isotope_tpu.models.generators import (
        realistic_topology,
        tree_topology,
        with_call_policy,
    )
    from isotope_tpu.models.graph import ServiceGraph
    from isotope_tpu.sim.config import ChaosEvent, LoadModel, SimParams
    from isotope_tpu.sim.engine import Simulator

    def gate_block(sim, n):
        return min(sim.default_block_size(), n)

    def flagship():
        g = ServiceGraph.decode(tree_topology(
            num_levels=5, num_branches=3, request_size=1024,
            response_size=1024))
        sim = Simulator(compile_graph(g))
        return sim, LoadModel(kind="open", qps=1e5), gate_block(sim, 262_144)

    def svc1000():
        g = ServiceGraph.from_yaml_file(TOPOLOGIES / "1000-svc_2000-end.yaml")
        sim = Simulator(compile_graph(g))
        return sim, LoadModel(kind="open", qps=1e4), gate_block(sim, 32_768)

    def star10k():
        g = ServiceGraph.decode(with_call_policy(
            realistic_topology(10_000, archetype="star", seed=0),
            timeout="30s"))
        sim = Simulator(compile_graph(g))
        block = sim.default_block_size()
        return sim, LoadModel(kind="open", qps=cs.STAR10K_QPS), block

    def svc100k():
        g = ServiceGraph.decode(
            realistic_topology(100_000, archetype="multitier", seed=0))
        sim = Simulator(
            compile_graph(g),
            SimParams(service_time="pareto", service_time_param=2.5),
            (ChaosEvent("mock-7", 5.0, 15.0, replicas_down=None),),
        )
        block = sim.default_block_size()
        return sim, LoadModel(kind="open", qps=cs.SVC100K_QPS), block

    def lb_panic():
        g = ServiceGraph.from_yaml_file(TOPOLOGIES / "10-svc_1000-end.yaml")
        g.policies = dict(cs.LB_PANIC_POLICIES)
        c = compile_graph(g)
        sim = Simulator(c, chaos=(ChaosEvent(**cs.LB_KILL),),
                        lb=compile_lb(g, c))
        n = int(cs.LB_PANIC_QPS * cs.LB_PANIC_S)
        return (sim, LoadModel(kind="open", qps=cs.LB_PANIC_QPS),
                gate_block(sim, min(sim.default_block_size(), n)))

    def policies():
        doc = with_call_policy(
            yaml.safe_load(
                (TOPOLOGIES / "1000-svc_2000-end.yaml").read_text()),
            timeout=cs.POLICY_TIMEOUT, retries=cs.POLICY_RETRIES,
        )
        doc["policies"] = cs.PROTECTED_POLICIES
        g = ServiceGraph.decode(doc)
        c = compile_graph(g)
        sim = Simulator(c, SimParams(timeline=True),
                        (ChaosEvent(**cs.POLICY_KILL),),
                        policies=compile_policies(g, c))
        load = LoadModel(kind="open", qps=cs.PROTECTED_QPS,
                         duration_s=cs.PROTECTED_S)
        return sim, load, sim.default_block_size()

    return [
        ("flagship", flagship),
        ("1000-svc_2000-end", svc1000),
        ("star-10k-timeouts", star10k),
        ("svc100k-chaos", svc100k),
        ("lb-10svc-100r-panic", lb_panic),
        ("policies-1000svc-kill", policies),
    ]


def main(argv) -> int:
    sys.path.insert(0, str(ROOT))
    _alias()
    from isotope_tpu.analysis.vet import vet_simulator

    want = set(argv)
    for name, make in cases():
        if want and name not in want:
            continue
        t = time.perf_counter()
        sim, load, block = make()
        t_build = time.perf_counter() - t
        out = {"name": name, "block": block, "build_s": t_build}
        for trace in (True, False):
            t = time.perf_counter()
            rep = vet_simulator(sim, load, block_requests=block,
                                trace=trace, device_bytes=8.0e10)
            cost = rep.meta["cost"]
            key = "traced" if trace else "plan_only"
            out[key] = {
                "peak_bytes_at_block": cost["peak_bytes_at_block"],
                "flops_at_block": cost["flops_at_block"],
                "critical_path": cost["critical_path"],
                "num_segments": cost["num_segments"],
                "vet_s": time.perf_counter() - t,
                "rules": sorted({f.rule for f in rep.findings}),
            }
        print(json.dumps(out), flush=True)
        del sim
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
