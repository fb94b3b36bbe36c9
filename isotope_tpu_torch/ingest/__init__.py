"""Trace-driven ingest: compile real mesh telemetry into topologies.

The reference repo's upper layers exist to *measure* real meshes —
Fortio drives load, Prometheus scrapes the proxies, the benchmark
runner aggregates (perf/benchmark/runner/prom.py).  The simulator so
far only *emitted* that telemetry (metrics/prometheus.py exposition,
metrics/timeline.py timestamped windows); this package closes the loop
by consuming it:

- :mod:`readers` parse Prometheus/OpenMetrics expositions (including
  our own timestamped timeline series), Envoy ``/stats``-style cluster
  JSON, and a documented CSV trace schema (caller, callee, timestamp,
  rt, status) into one :class:`~isotope_tpu_torch.ingest.readers.Observation`
  IR with per-input coverage accounting — nothing is dropped silently.
- :mod:`fit` estimates per-service self-time (→ script ``sleep``),
  ``errorRate``, fan-out call graphs (with concurrent-group inference
  from overlapping spans), payload sizes, replica counts, and a
  windowed qps schedule, emitted as standard topology YAML + ``[sim]``
  TOML through the existing ``models/`` decoders.
- :mod:`report` records the fit-fidelity evidence as an
  ``isotope-ingest/v1`` artifact (``<label>.ingest.json``) and checks
  the self-closure loop: simulate a known topology, export its
  exposition, ingest it back, and pin the reconstruction against the
  source within stated tolerances.

The port of ``isotope_tpu.ingest``.  Host-only: nothing in this package
runs on a device.
"""
from isotope_tpu_torch.ingest.readers import (  # noqa: F401
    Observation,
    InputCoverage,
    read_prometheus,
    read_envoy,
    read_csv_trace,
    read_path,
)
from isotope_tpu_torch.ingest.fitters import FitOptions, FitResult, fit  # noqa: F401
from isotope_tpu_torch.ingest.report import (  # noqa: F401
    DOC_SCHEMA,
    check_doc,
    load_doc,
    format_report,
    closure_check,
    CLOSURE_TOLERANCES,
)
