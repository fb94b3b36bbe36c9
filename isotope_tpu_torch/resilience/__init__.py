"""Resilient execution of the engine itself.

The port of ``isotope_tpu.resilience``:

- :mod:`~isotope_tpu_torch.resilience.taxonomy` classifies exceptions
  (torch and CUDA errors included) into transient /
  resource-exhausted / deterministic;
- :mod:`~isotope_tpu_torch.resilience.supervisor` retries transients
  with exponential backoff + deterministic jitter and walks the OOM
  degradation ladder (halve the block, on the same device);
- :mod:`~isotope_tpu_torch.resilience.sentinels` validates run outputs
  (finite, non-negative latencies) post-run;
- :mod:`~isotope_tpu_torch.resilience.faults` injects deterministic
  faults (``ISOTOPE_FAULT_INJECT=oom:engine.run:1,nan:segment:2``) so
  all of the above is testable on the CPU, and holds the fleets' chaos
  jitter.
"""
from isotope_tpu_torch.resilience.taxonomy import (  # noqa: F401
    DETERMINISTIC,
    RESOURCE_EXHAUSTED,
    TRANSIENT,
    InjectedFault,
    NumericSentinelError,
    classify,
    is_cache_corruption,
    is_sticky_cuda_error,
)
from isotope_tpu_torch.resilience import faults  # noqa: F401
from isotope_tpu_torch.resilience.supervisor import (  # noqa: F401
    ResiliencePolicy,
    backoff_seconds,
    call_with_retries,
    execution_rungs,
    run_ladder,
)
from isotope_tpu_torch.resilience.sentinels import (  # noqa: F401
    check_results,
    check_summary,
)
