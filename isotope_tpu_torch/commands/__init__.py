"""Subcommands of ``python -m isotope_tpu_torch`` beyond ``cli.py``'s
``simulate``, ``check``, ``sweep``, ``timeline`` and ``search``: the
ports of ``isotope_tpu.commands``' ``suite``, ``report`` and
``telemetry``, each with a ``register(sub)``."""
