"""Subcommands of ``python -m isotope_tpu_torch`` beyond ``cli.py``'s
``simulate``, ``check``, ``sweep``, ``timeline`` and ``search``: the
ports of ``isotope_tpu.commands``' ``suite``, ``report``, ``telemetry``,
``fidelity``, ``ingest``, ``explain``, the converters (``kubernetes``,
``graphviz``, ``security-policies``), ``generate``, ``pilot-load`` and
``plot``, each with a ``register(sub)``.  Optional packages
(matplotlib, pandas, cryptography) are imported by the handlers that
need them."""
