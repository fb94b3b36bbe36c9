"""Engine self-telemetry (see telemetry/core.py for the design notes).

``isotope_tpu_torch.telemetry.profile`` (the ``torch.profiler`` capture)
is NOT imported here: it depends on the engine, which itself imports
this package — command handlers import it lazily.
"""
from isotope_tpu_torch.telemetry.core import (  # noqa: F401
    SCHEMA,
    RunTelemetry,
    counter_get,
    counter_inc,
    detail_enabled,
    disable,
    emitting,
    enable,
    fence_reset,
    gauge_get,
    gauge_max,
    gauge_set,
    get_meta,
    iter_jsonl,
    phase,
    phase_add,
    phase_seconds,
    prometheus_text,
    record_device_memory,
    reset,
    segment_fence,
    set_meta,
    snapshot,
    span,
    summary_block,
    summary_line,
    validate_jsonl,
)
