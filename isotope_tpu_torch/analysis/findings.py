"""Vet findings: structured diagnostics with rule ids and severities.

Every defect the static passes (topology linter, jaxpr auditor,
pre-flight cost model — see :mod:`isotope_tpu_torch.analysis`) can report is
a :class:`Finding`: a stable rule id, a severity, the config/program
path it anchors to, and a message.  The :class:`Report` aggregates
findings across passes, applies suppressions, and decides the exit
status — ``vet`` exits nonzero on errors, ``strict`` mode promotes
warnings to blocking.

The port of ``isotope_tpu.analysis.findings``: the catalog is the
reference's, its jaxpr and gradient audit rules among them, though the
port runs only the topology linter so far (ROADMAP item 13).

Rule ids are stable API (suppression patterns, bench gates, and alert
rules key on them): never renumber an existing rule; retire ids by
leaving a tombstone in :data:`RULES`.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
from typing import Dict, Iterable, List, Optional, Sequence

SEV_ERROR = "error"
SEV_WARN = "warn"
SEV_INFO = "info"

_SEV_ORDER = {SEV_ERROR: 0, SEV_WARN: 1, SEV_INFO: 2}

#: rule id -> one-line description (the README table is generated from
#: the same text; suppression validation checks membership here)
RULES: Dict[str, str] = {
    # -- topology / service-graph linter (host-only) ----------------------
    "VET-T001": "service is unreachable from the entrypoint",
    "VET-T002": "call graph contains a cycle reachable from the "
                "entrypoint (the unroll cannot terminate)",
    "VET-T003": "no entrypoint service (or unknown --entry override)",
    "VET-T004": "numReplicas < 1: a zero-capacity queueing station",
    "VET-T005": "errorRate >= 100%: the service fails every request",
    "VET-T006": "payload size exceeds the plausible wire budget",
    "VET-T007": "hop count forces the request block under its floor — "
                "event tensors exceed the HBM element budget",
    "VET-T008": "bucket-plan padding waste exceeds level_bucket_waste",
    # -- policy / rollout / lb config linter --------------------------------
    "VET-T010": "circuit-breaker cap (max_pending / max_connections) "
                "sits below the steady-state queue depth or "
                "concurrency at the planned qps — the breaker sheds "
                "healthy traffic permanently",
    "VET-T011": "autoscaler min_replicas > max_replicas: the "
                "desired-count clamp is empty",
    "VET-T012": "retry_budget of 0 while calls to the service set "
                "retries > 0: every retry is suppressed",
    "VET-T013": "autoscaler sync_period shorter than the timeline "
                "window: the control loop reads stale signals",
    "VET-T014": "policies block does not decode",
    "VET-T015": "rollouts block does not decode, or a step schedule "
                "is not strictly increasing / never reaches 100%",
    "VET-T016": "canary bake shorter than the recorder window: a step "
                "can promote before one completed window of it",
    "VET-T017": "canary gate min_samples is unreachable within one "
                "bake at the planned qps (the rollout holds forever)",
    "VET-T018": "canary overrides declared without a step schedule: "
                "the rollout never actuates",
    "VET-T019": "lb choices_d exceeds the replica count: power-of-d "
                "degenerates to full-pool least-request",
    "VET-T020": "ring_hash with a single replica: hash stickiness is "
                "a no-op",
    "VET-T021": "lb panic_threshold >= 1.0 or unreachable via outlier "
                "ejection",
    "VET-T022": "lb entries do not decode",
    # -- experiment-config linter -----------------------------------------
    "VET-C001": "topology file is missing or unreadable",
    "VET-C002": "duplicate run labels in the sweep grid",
    "VET-C003": "chaos/churn schedule targets an unknown service or "
                "matches no churnable edge",
    "VET-C004": "chaos/churn/mtls schedule lies beyond the run duration "
                "(it never fires)",
    "VET-C005": "open-loop qps meets or exceeds the static capacity "
                "(unstable queues)",
    "VET-C006": "level falls back to the residual sparse call-slot "
                "path (script wider than the tile cap) — un-tiled "
                "slots run the serial gather/cumsum sweep",
    # -- jaxpr auditor ------------------------------------------------------
    "VET-J001": "host callback / device-to-host sync primitive in the "
                "hot path",
    "VET-J002": "float64/complex128 dtype leak in the traced program",
    "VET-J003": "float scatter-add accumulation (order-nondeterministic "
                "on parallel backends)",
    "VET-J004": "executable-cache signature component is unhashable or "
                "has an id-based repr (retrace hazard: the AOT cache "
                "key changes every process)",
    # -- pre-flight cost model ---------------------------------------------
    "VET-M001": "memory estimate exceeds device capacity on every "
                "on-device ladder rung (predictable OOM)",
    "VET-M002": "memory estimate exceeds device capacity at the default "
                "rung; the resilience ladder should start degraded",
    "VET-M003": "timeline recorder carries (O(services x windows) per "
                "scan block) take a large share of device capacity; "
                "the window planner will clamp or widen windows",
    # -- scenario ensembles (sim/ensemble.py) ------------------------------
    "VET-T023": "ensemble spec has zero members or duplicate member "
                "seeds (duplicated members are bit-identical copies, "
                "not extra Monte Carlo samples)",
    "VET-M004": "ensemble members x peak-bytes exceed device capacity; "
                "the fleet runs in pre-computed member chunks",
    # -- chaos fleets (sim/splitting.py) ----------------------------------
    "VET-T024": "importance-splitting config is undecodable, keeps no "
                "(or every) member per level, or budgets fewer than "
                "one survivor per level",
    "VET-T025": "protected fleet members x (peak-bytes + stacked "
                "policy/rollout/timeline carry) exceed device "
                "capacity; the fleet runs in carry-aware member "
                "chunks",
    # -- on-device config search (sim/search.py) ---------------------------
    "VET-T026": "search spec is undecodable, or the bracket is "
                "degenerate (population cannot support the rungs, "
                "non-power-of-eta padding, rank needs uncarried "
                "timelines)",
    "VET-M005": "search bracket's widest rung x peak-bytes exceed "
                "device capacity; the rung runs in member chunks",
    "VET-M006": "observed fleet members x (peak-bytes + stacked "
                "blame/timeline carry) exceed device capacity; the "
                "fleet runs in member chunks",
    # -- trace-driven ingest (ingest/, analysis/topo_lint.lint_ingest) ----
    "VET-T027": "fitted qps schedule exceeds the fitted capacity at "
                "the observed window peak (the reconstructed replay "
                "will saturate where the source mesh did not)",
    "VET-T028": "degenerate fit: a service with zero observed samples "
                "was emitted into the topology (its timing/error "
                "knobs are defaults, not measurements)",
    # -- gradient audit (analysis/grad_audit.py) ---------------------------
    "VET-G001": "design knob is gradient-dead: every tainted path to "
                "the objective crosses a non-differentiable primitive "
                "(the finding names the killer and its jaxpr path)",
    "VET-G002": "design knob is a trace constant: it never enters the "
                "jaxpr, so every new value recompiles and no soft "
                "relaxation recovers a gradient",
    "VET-G003": "design knob's gradient crosses a float scatter-add "
                "(accumulation order is backend-dependent)",
    "VET-G004": "objective output carries zero live design-taint: "
                "planning over it is vacuous until a soft relaxation "
                "replaces its integer/comparison paths",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One static-analysis diagnostic."""

    rule: str          # stable id, e.g. "VET-T001"
    severity: str      # error | warn | info
    message: str
    path: str = ""     # config path ("services[3].script[1]") or site

    def render(self) -> str:
        where = f" {self.path}" if self.path else ""
        return f"{self.severity:5s} {self.rule}{where}: {self.message}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def suppression_patterns(spec: Optional[str]) -> List[str]:
    """Parse a comma-separated suppression spec (``--suppress`` /
    ``$ISOTOPE_VET_SUPPRESS``) into fnmatch patterns over rule ids."""
    if not spec:
        return []
    pats = [p.strip() for p in spec.split(",") if p.strip()]
    for p in pats:
        if "*" not in p and "?" not in p and p not in RULES:
            raise ValueError(
                f"unknown vet rule in suppression: {p!r} "
                f"(known rules: {', '.join(sorted(RULES))})"
            )
    return pats


class Report:
    """Aggregated vet findings plus the suppression bookkeeping."""

    def __init__(self, suppress: Sequence[str] = ()):
        self.findings: List[Finding] = []
        self.suppressed: List[Finding] = []
        self._patterns = list(suppress)
        self.meta: Dict[str, object] = {}  # cost estimates, rung advice

    def add(self, finding: Finding) -> None:
        if any(fnmatch.fnmatchcase(finding.rule, p)
               for p in self._patterns):
            self.suppressed.append(finding)
        else:
            self.findings.append(finding)

    def extend(self, findings: Iterable[Finding]) -> None:
        for f in findings:
            self.add(f)

    def by_severity(self, severity: str) -> List[Finding]:
        return [f for f in self.findings if f.severity == severity]

    @property
    def errors(self) -> List[Finding]:
        return self.by_severity(SEV_ERROR)

    @property
    def warnings(self) -> List[Finding]:
        return self.by_severity(SEV_WARN)

    def blocking(self, strict: bool = False,
                 nonblocking_rules: Sequence[str] = ()) -> List[Finding]:
        """The findings that make vet fail: errors, plus warns under
        ``strict``.  ``nonblocking_rules`` exempts rules another layer
        already handles (the runner exempts the VET-M* memory rules
        when the degradation ladder is armed — the rung pre-selection
        IS the recovery, so the finding informs instead of blocking).
        """
        sevs = (SEV_ERROR, SEV_WARN) if strict else (SEV_ERROR,)
        return [
            f for f in self.findings
            if f.severity in sevs and f.rule not in nonblocking_rules
        ]

    def sorted(self) -> List[Finding]:
        return sorted(
            self.findings,
            key=lambda f: (_SEV_ORDER.get(f.severity, 9), f.rule, f.path),
        )

    def summary_line(self) -> str:
        n_err = len(self.errors)
        n_warn = len(self.warnings)
        n_info = len(self.by_severity(SEV_INFO))
        extra = (
            f", {len(self.suppressed)} suppressed" if self.suppressed
            else ""
        )
        return (
            f"vet: {n_err} error(s), {n_warn} warning(s), "
            f"{n_info} info{extra}"
        )

    def to_dict(self) -> dict:
        return {
            "findings": [f.to_dict() for f in self.sorted()],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "meta": self.meta,
            "summary": self.summary_line(),
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)
