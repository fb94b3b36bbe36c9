"""Error taxonomy: classify engine-phase exceptions by recovery action.

The port of ``isotope_tpu.resilience.taxonomy``.  WHAT failed matters
less than WHAT TO DO NEXT:

- ``TRANSIENT`` — retry with backoff: infrastructure hiccups (RPC
  deadline, socket reset, preempted device, interrupted syscall) that
  a later identical attempt is expected to survive.
- ``RESOURCE_EXHAUSTED`` — degrade, don't retry: the same program at
  the same shape will run out of memory again; the supervisor walks
  the degradation ladder instead (a smaller block on the same device).
  ``torch.cuda.OutOfMemoryError`` is this class.
- ``DETERMINISTIC`` — fail the case, keep the sweep: shape errors,
  invalid arguments, numeric-sentinel violations.  Retrying reproduces
  the same traceback, so the case is recorded as failed in the
  checkpoint and the sweep continues.  A *sticky* CUDA error (an
  illegal memory access, an unspecified launch failure, a device-side
  assert) is this class too, whatever else its text says: the CUDA
  context is lost after one, so no retry and no rung on the same
  process can succeed (:func:`is_sticky_cuda_error`).

Classification is by exception *type* where Python gives one
(``ConnectionError``, ``TimeoutError``, ``MemoryError``, torch's OOM)
and by message pattern otherwise: the reference's XLA status strings
(``RESOURCE_EXHAUSTED: ...``, ``UNAVAILABLE: ...``), which the injected
faults imitate, and the CUDA runtime's phrasings.

Kept import-light: torch is looked up only if it is already imported.
"""
from __future__ import annotations

import re
import sys

#: retry with exponential backoff + deterministic jitter
TRANSIENT = "transient"
#: walk the degradation ladder (never naively retried)
RESOURCE_EXHAUSTED = "resource_exhausted"
#: record the case as failed; the sweep continues
DETERMINISTIC = "deterministic"

# the reference's XLA status codes (which the injected faults imitate),
# the allocator phrasings, and the CUDA caching allocator's
# "CUDA out of memory. Tried to allocate ..."
_RESOURCE_RE = re.compile(
    r"RESOURCE_EXHAUSTED|OUT_OF_MEMORY|out of memory|out-of-memory"
    r"|\bOOM\b|[Ff]ailed to allocate|[Aa]llocation .* exceeds"
    r"|exceeds the memory|[Ii]nsufficient memory",
)
_TRANSIENT_RE = re.compile(
    r"UNAVAILABLE|DEADLINE_EXCEEDED|\bABORTED\b|\bCANCELLED\b"
    r"|[Cc]onnection reset|[Ss]ocket closed|[Tt]emporarily unavailable"
    r"|[Tt]ry again|[Pp]reempt"
    # multi-host collective and coordination failures: a retry against
    # healthy peers is expected to succeed
    r"|[Mm]ega[Ss]cale|\bDCN\b"
    r"|[Cc]ollective (?:operation|permute)? ?timed out"
    r"|[Bb]arrier timed out|[Hh]eartbeat timeout"
    r"|[Cc]oordination service (?:agent|error|is unavailable)"
    r"|failed to connect to all addresses"
    r"|[Tt]ransfer server|[Pp]eer task .* (?:failed|disconnected)",
)
# CUDA errors after which the context is unusable: every later call on
# the device fails too, so they are never retried and never degraded
_STICKY_CUDA_RE = re.compile(
    r"illegal memory access|unspecified launch failure"
    r"|misaligned address|illegal instruction|device-side assert"
    r"|hardware stack error|uncorrectable ECC error"
    r"|cudaErrorIllegalAddress|cudaErrorLaunchFailure",
)
_CORRUPT_RE = re.compile(
    r"unpickl|[Cc]orrupt|[Dd]igest mismatch|deserial|[Bb]ad cache entry"
    r"|[Tt]runcated cache|zstd|[Ii]nvalid compilation cache",
)


class InjectedFault(RuntimeError):
    """A deterministic fault raised by :mod:`resilience.faults`.

    Carries its class explicitly so injected faults classify exactly
    like the real exception they imitate, whatever the message says.
    """

    def __init__(self, message: str, fault_class: str):
        super().__init__(message)
        self.fault_class = fault_class


class NumericSentinelError(RuntimeError):
    """A run produced non-finite or negative outputs (sentinels.py).

    Deterministic by definition: the same program on the same inputs
    reproduces the same NaN, so the supervisor fails the case instead
    of retrying.
    """

    fault_class = DETERMINISTIC


def _is_torch_oom(exc: BaseException) -> bool:
    torch = sys.modules.get("torch")
    oom = getattr(getattr(torch, "cuda", None), "OutOfMemoryError", None)
    return oom is not None and isinstance(exc, oom)


def is_sticky_cuda_error(exc: BaseException) -> bool:
    """Whether ``exc`` is a CUDA error that leaves the context unusable
    (an illegal memory access, an unspecified launch failure, ...)."""
    return bool(_STICKY_CUDA_RE.search(f"{type(exc).__name__}: {exc}"))


def classify(exc: BaseException) -> str:
    """Map an exception to its recovery class (see module docstring)."""
    explicit = getattr(exc, "fault_class", None)
    if explicit in (TRANSIENT, RESOURCE_EXHAUSTED, DETERMINISTIC):
        return explicit
    if is_sticky_cuda_error(exc):
        return DETERMINISTIC
    if isinstance(exc, (ConnectionError, TimeoutError, InterruptedError)):
        return TRANSIENT
    if isinstance(exc, MemoryError) or _is_torch_oom(exc):
        return RESOURCE_EXHAUSTED
    text = f"{type(exc).__name__}: {exc}"
    if _RESOURCE_RE.search(text):
        return RESOURCE_EXHAUSTED
    if _TRANSIENT_RE.search(text):
        return TRANSIENT
    return DETERMINISTIC


def is_cache_corruption(exc: BaseException) -> bool:
    """Whether ``exc`` looks like a corrupted persistent-cache entry
    (digest mismatch / unpickle failure) — the one deterministic error
    with a better move than failing: evict the entry and retrace."""
    return bool(_CORRUPT_RE.search(f"{type(exc).__name__}: {exc}"))
