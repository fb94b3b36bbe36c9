"""Static program & config analysis (``vet``): the port of
``isotope_tpu.analysis``.

- :mod:`~isotope_tpu_torch.analysis.topo_lint` — the topology & sweep
  config linter;
- :mod:`~isotope_tpu_torch.analysis.op_audit` — the op auditor over one
  pilot block's op log (:mod:`~isotope_tpu_torch.analysis.oplog`), in
  place of the reference's jaxpr auditor;
- :mod:`~isotope_tpu_torch.analysis.costmodel` — the pre-flight cost
  model (flops, peak bytes, critical path; the memory verdict that
  picks the ladder rung a run starts on);
- :mod:`~isotope_tpu_torch.analysis.grad_audit` — the gradient audit
  (``vet --grad``).

Surfaced as the ``vet`` command and the opt-in ``--vet`` /
``$ISOTOPE_VET`` gate on simulate, sweep and suite.  With the gate off
nothing here runs.
"""
from isotope_tpu_torch.analysis.findings import (  # noqa: F401
    RULES,
    SEV_ERROR,
    SEV_INFO,
    SEV_WARN,
    Finding,
    Report,
    suppression_patterns,
)
from isotope_tpu_torch.analysis.grad_audit import (  # noqa: F401
    CLASS_CONSTANT,
    CLASS_DEAD,
    CLASS_DIFFERENTIABLE,
    GRAD_INVARS,
    audit_grad,
)
from isotope_tpu_torch.analysis.vet import (  # noqa: F401
    ENV_VET,
    ENV_VET_SUPPRESS,
    MEMORY_RULES,
    VetError,
    default_suppressions,
    vet_config_path,
    vet_mode,
    vet_simulator,
    vet_topology_path,
)

__all__ = [
    "RULES",
    "SEV_ERROR",
    "SEV_INFO",
    "SEV_WARN",
    "Finding",
    "Report",
    "suppression_patterns",
    "CLASS_CONSTANT",
    "CLASS_DEAD",
    "CLASS_DIFFERENTIABLE",
    "GRAD_INVARS",
    "audit_grad",
    "ENV_VET",
    "ENV_VET_SUPPRESS",
    "MEMORY_RULES",
    "VetError",
    "default_suppressions",
    "vet_config_path",
    "vet_mode",
    "vet_simulator",
    "vet_topology_path",
]
