"""Gradient-flow audit: taint analysis from design knobs to objectives.

The port of ``isotope_tpu.analysis.grad_audit``.  The reference traces
its engine's universal member body with the jitter scales armed and
runs a forward taint over the jaxpr; the port runs the same forward
taint over the op log of a **knob-armed pilot block**
(``analysis/oplog.py``: ``Simulator._simulate_core`` with ``cpu_scale``
and ``err_scale`` passed, reduced to its ``RunSummary`` as the member
body is).  No autograd is involved: the JAX census has no VJP, and the
reference's audit is a static taint.

- **seed** taint at the ``_simulate_core`` arguments that carry the
  registered design parameters (:data:`GRAD_INVARS`,
  :data:`~isotope_tpu_torch.sim.config.DESIGN_PARAMS`);
- **propagate** through every op in order (an eager block has no loop
  to reach a fixpoint over: its loops ran);
- **kill** liveness where the chain rule dies: :data:`KILLER_OPS`, any
  non-inexact output (comparisons, integer casts, boolean coins), and a
  ``where`` / ``masked_fill`` whose only taint arrives through its
  condition;
- the ``census`` entry carries the union of its float inputs' taint.

Kill sites are aten names (``aten.lt``), not jaxpr paths
(``scan/body/lt``).  Every knob lands in one of the reference's three
classes, reported as the VET-G rules and as the
``isotope-gradaudit/v1`` document.  ``$ISOTOPE_VET_INJECT=graddead``
routes ``cpu_scale`` through a ``floor`` before the block sees it.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from isotope_tpu_torch.analysis.findings import (
    SEV_INFO,
    SEV_WARN,
    Finding,
)
from isotope_tpu_torch.analysis.op_audit import inject_spec

SCHEMA = "isotope-gradaudit/v1"

CLASS_DIFFERENTIABLE = "differentiable"
CLASS_DEAD = "gradient-dead"
CLASS_CONSTANT = "trace-constant"

#: the ten traced invars of the reference's universal member body, in
#: position order; DESIGN_PARAMS entries name these to say where their
#: taint seeds (the port's pilot passes each as a ``_simulate_core``
#: argument; ``key``, ``win_lo`` and ``win_hi`` seed no knob)
GRAD_INVARS = (
    "key",
    "offered_qps",
    "pace_gap",
    "nominal_gap",
    "win_lo",
    "win_hi",
    "visits_pc",
    "phase_windows",
    "cpu_scale",
    "err_scale",
)

#: the aten counterparts of the reference's ``KILLER_PRIMITIVES``
#: (floor, ceil, round, sign, stop_gradient, argmax, argmin): live
#: taint crossing one dies
KILLER_OPS = frozenset({
    "aten.floor",
    "aten.ceil",
    "aten.round",
    "aten.sign",
    "aten.sgn",
    "aten.detach",
    "aten.argmax",
    "aten.argmin",
})

#: the selects whose first tensor argument is a condition
_SELECT_OPS = frozenset({"aten.where", "aten.masked_fill"})

#: the SLO objectives ``optimize`` would target (RunSummary leaves)
OBJECTIVE_LEAVES = ("latency_sum", "latency_hist", "error_count")


def _merge(a: tuple, b: tuple) -> tuple:
    """Join two taint values ``(live, killer)``: live wins; a dead
    result keeps the first recorded killer."""
    live = a[0] or b[0]
    return (live, None if live else (a[1] or b[1]))


def _union(ts) -> dict:
    out: dict = {}
    for t in ts:
        for k, tv in t.items():
            out[k] = _merge(out[k], tv) if k in out else tv
    return out


class _TaintState:
    """Accumulators of one analysis run."""

    def __init__(self):
        # knob -> ordered distinct kill sites (where live taint died)
        self.kills: Dict[str, Dict[str, None]] = {}
        # knob -> ordered distinct float scatter-add sites crossed live
        self.scatter: Dict[str, Dict[str, None]] = {}

    def record_kill(self, knob: str, site: str) -> None:
        self.kills.setdefault(knob, {})[site] = None

    def record_scatter(self, knob: str, site: str) -> None:
        self.scatter.setdefault(knob, {})[site] = None


def _inexact(dtype) -> bool:
    return dtype.is_floating_point or dtype.is_complex


def analyze_log(log, seeds: Dict[int, dict], state: _TaintState
                ) -> Dict[int, dict]:
    """Forward taint over an op log: ``seeds`` maps value ids to their
    taint (``knob -> (live, killer)``); returns the taint of every
    value that carries any."""
    from isotope_tpu_torch.analysis.oplog import ALIAS, CENSUS
    from isotope_tpu_torch.analysis.op_audit import SCATTER_ACCUM_OPS

    env: Dict[int, dict] = {v: dict(t) for v, t in seeds.items()}
    for op in log.ops:
        ins = [env.get(v, {}) for v in op.ins]
        if not any(ins):
            continue
        if op.name == ALIAS:
            env[op.outs[0]] = _union(ins)
            continue
        site = op.packet
        if op.name == CENSUS:
            # the union of its float inputs' taint
            union = _union(
                t for t, v in zip(ins, op.ins)
                if _inexact(log.values[v].dtype)
            )
            for v in op.outs:
                if union:
                    env[v] = dict(union)
            continue
        if op.packet in _SELECT_OPS:
            # the condition is routing: a knob arriving ONLY through it
            # is dead, named after the comparison that fed it
            if op.packet == "aten.where":
                pred, br_ins = ins[0], ins[1:]
            else:  # masked_fill(self, mask[, value])
                pred, br_ins = ins[1], [ins[0]] + ins[2:]
            out_t: dict = {}
            for k in set().union(*ins):
                br_ts = [t[k] for t in br_ins if k in t]
                if br_ts:
                    tv = br_ts[0]
                    for o in br_ts[1:]:
                        tv = _merge(tv, o)
                    if not tv[0] and k in pred and tv[1] is None:
                        tv = (False, pred[k][1] or site)
                else:
                    pk = pred[k][1]
                    kill_site = f"{site}←{pk or 'pred'}"
                    if pred[k][0]:
                        state.record_kill(k, kill_site)
                    tv = (False, kill_site)
                out_t[k] = tv
            for v in op.outs:
                env[v] = dict(out_t)
            continue
        union = _union(ins)
        kills = op.packet in KILLER_OPS
        if (op.packet in SCATTER_ACCUM_OPS or op.accumulate) and any(
            _inexact(dt) for dt in op.out_dtypes
        ):
            for k, tv in union.items():
                if tv[0]:
                    state.record_scatter(k, site)
        for v in op.outs:
            out_t = {}
            for k, tv in union.items():
                if tv[0]:
                    if kills or not _inexact(log.values[v].dtype):
                        state.record_kill(k, site)
                        out_t[k] = (False, site)
                    else:
                        out_t[k] = (True, None)
                else:
                    out_t[k] = tv
            env[v] = out_t
    return env


def _graddead(cpu_scale):
    """The ``graddead`` defect: ``cpu_scale`` quantized by a floor."""
    import torch

    return torch.floor(cpu_scale * 1048576.0) / 1048576.0


def grad_trace_entry(sim, load, num_requests: int = 8):
    """The knob-armed pilot (``oplog.run_pilot(armed=True)``): the block
    of ``load`` with the fleets' ``cpu_scale`` / ``err_scale`` passed,
    reduced to its ``RunSummary``."""
    from isotope_tpu_torch.analysis import oplog

    arm = _graddead if "graddead" in inject_spec() else None
    return oplog.run_pilot(sim, load, num_requests, armed=True, arm=arm)


def analyze_design_taint(pilot) -> dict:
    """Run the taint analysis and classify every registered knob: the
    ``isotope-gradaudit/v1`` body (sans topology header)."""
    from isotope_tpu_torch.analysis.oplog import out_values
    from isotope_tpu_torch.sim.config import DESIGN_PARAMS

    log = pilot.log
    state = _TaintState()
    seeds: Dict[int, dict] = {}
    for p in DESIGN_PARAMS:
        for invar in p.invars:
            vid = pilot.seeds.get(invar)
            if vid is not None:
                seeds.setdefault(vid, {})[p.name] = (True, None)
    env = analyze_log(log, seeds, state)
    leaves = out_values(log, pilot.out)
    names = [nm for nm, _ in leaves]
    out_taints = [env.get(v, {}) for _, v in leaves]

    knobs = []
    live_by_leaf: Dict[str, List[str]] = {nm: [] for nm in names}
    for p in DESIGN_PARAMS:
        if not p.traced:
            knobs.append({
                "name": p.name,
                "class": CLASS_CONSTANT,
                "doc": p.doc,
                "invars": [],
                "constant_site": p.constant_site,
                "live_outputs": [],
                "kills": [],
                "scatter_sites": [],
                "partial": p.partial,
            })
            continue
        live_outputs = []
        dead_killers: Dict[str, None] = {}
        for nm, t in zip(names, out_taints):
            tv = t.get(p.name)
            if tv is None:
                continue
            if tv[0]:
                live_outputs.append(nm)
                live_by_leaf[nm].append(p.name)
            elif tv[1]:
                dead_killers[tv[1]] = None
        kills = list(state.kills.get(p.name, {}))
        # prefer kill sites observed on output-reaching paths
        ordered_kills = list(dead_killers) + [
            k for k in kills if k not in dead_killers
        ]
        knobs.append({
            "name": p.name,
            "class": (
                CLASS_DIFFERENTIABLE if live_outputs else CLASS_DEAD
            ),
            "doc": p.doc,
            "invars": list(p.invars),
            "constant_site": p.constant_site,
            "live_outputs": live_outputs,
            "kills": ordered_kills,
            "scatter_sites": list(state.scatter.get(p.name, {})),
            "partial": p.partial,
        })

    vacuous = [
        nm for nm in OBJECTIVE_LEAVES
        if nm in live_by_leaf and not live_by_leaf[nm]
    ]
    return {
        "schema": SCHEMA,
        "invars": list(GRAD_INVARS),
        "knobs": knobs,
        "objectives": {
            nm: sorted(live_by_leaf[nm]) for nm in names
        },
        "vacuous_objectives": vacuous,
    }


def grad_findings(doc: dict) -> List[Finding]:
    """VET-G findings from one gradient-audit document."""
    findings: List[Finding] = []
    for k in doc["knobs"]:
        if k["class"] == CLASS_CONSTANT:
            findings.append(Finding(
                "VET-G002", SEV_INFO,
                f"design knob {k['name']!r} is a trace constant: "
                f"baked into {k['constant_site'] or 'the block'}; "
                "every new value recompiles and no relaxation "
                "recovers a gradient",
                path=k["constant_site"],
            ))
            continue
        if k["class"] == CLASS_DEAD:
            if k["kills"]:
                killer = k["kills"][0]
                findings.append(Finding(
                    "VET-G001", SEV_WARN,
                    f"design knob {k['name']!r} is gradient-dead: "
                    "every tainted path to the objective crosses a "
                    f"non-differentiable primitive (first kill: "
                    f"{killer})",
                    path=killer,
                ))
            else:
                findings.append(Finding(
                    "VET-G001", SEV_WARN,
                    f"design knob {k['name']!r} is gradient-dead: "
                    "its traced value never reaches an objective "
                    "output under this configuration (the knob is "
                    "inert here, not relaxable)",
                    path=",".join(k["invars"]),
                ))
        for site in k["scatter_sites"]:
            findings.append(Finding(
                "VET-G003", SEV_INFO,
                f"design knob {k['name']!r} crosses a float "
                "scatter-add: its gradient accumulates in "
                "backend-dependent order",
                path=site,
            ))
    if doc["vacuous_objectives"]:
        findings.append(Finding(
            "VET-G004", SEV_WARN,
            "objective output(s) with zero live design-taint: "
            f"{', '.join(doc['vacuous_objectives'])} — planning over "
            "them is vacuous until a soft relaxation replaces their "
            "integer/comparison paths",
            path=",".join(doc["vacuous_objectives"]),
        ))
    return findings


def audit_grad(sim, load, num_requests: int = 8
               ) -> Tuple[List[Finding], dict]:
    """The full gradient audit of one Simulator under one load."""
    from isotope_tpu_torch.analysis.oplog import ALIAS

    pilot = grad_trace_entry(sim, load, num_requests)
    doc = analyze_design_taint(pilot)
    doc["traced_requests"] = pilot.n
    doc["eqns_walked"] = sum(1 for op in pilot.log.ops if op.name != ALIAS)
    doc["classes"] = {
        k["name"]: k["class"] for k in doc["knobs"]
    }
    return grad_findings(doc), doc
