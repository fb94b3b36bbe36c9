"""Shared flag plumbing for run-executing subcommands.

The port of ``isotope_tpu.commands.common``.  :func:`arm_telemetry` is
the single composition point of detail-mode arming: detail requests OR
together (a later caller can add detail, never remove it), so
``--telemetry=detail`` and the ``telemetry`` probe's ``--detail``
compose in one process.  The reference's ``default_compile_cache``
configures XLA's compilation cache; the port has none, and its commands
accept ``--compile-cache`` and ignore it (:func:`ignore_compile_cache`).
The run supervisor's and telemetry's flags are added here for every
run-executing subcommand.
"""
from __future__ import annotations

import sys
from typing import Optional


def add_resilience_args(parser) -> None:
    """The run supervisor's knobs (resilience/supervisor.py), shared by
    every run-executing subcommand."""
    parser.add_argument(
        "--max-retries", type=int, default=None, metavar="N",
        help="transient-failure retries per phase before the case "
             "fails (default: $ISOTOPE_MAX_RETRIES or 3; backoff is "
             "exponential with deterministic jitter)")
    parser.add_argument(
        "--no-degrade", action="store_true",
        help="disable the OOM degradation ladder (halve the block, on "
             "the same device); an OOM then fails the case at once")


def resilience_policy(args):
    """The supervisor's policy of :func:`add_resilience_args`' flags."""
    from isotope_tpu_torch.resilience import ResiliencePolicy

    return ResiliencePolicy.from_env(
        max_retries=args.max_retries,
        degrade=False if args.no_degrade else None,
    )


def add_telemetry_arg(parser, what: str) -> None:
    parser.add_argument(
        "--telemetry", nargs="?", const="on", choices=("on", "detail"),
        default=None,
        help=f"emit engine self-telemetry: isotope_engine_* series {what}"
             " ('detail' adds a card fence at every level of the "
             "block's sweeps — diagnosis, not benchmarking)")


def ignore_compile_cache(args) -> None:
    if args.compile_cache is not None:
        print("note: --compile-cache configures XLA's compilation cache; "
              "the torch port has none and ignores it", file=sys.stderr)


def arm_telemetry(mode: Optional[str] = None,
                  detail: bool = False) -> bool:
    """Arm engine telemetry emission/detail from command flags.

    ``mode`` is a ``--telemetry`` value (``None`` / ``"on"`` /
    ``"detail"``); ``detail`` is an independent detail request (the
    ``telemetry`` subcommand's ``--detail``).  Returns whether detail
    fencing is armed after this call.
    """
    from isotope_tpu_torch import telemetry

    want_detail = bool(detail) or mode == "detail"
    if mode or want_detail:
        # compose, never strip: an earlier caller's detail request
        # survives a later plain --telemetry
        telemetry.enable(
            detail=want_detail or telemetry.detail_enabled()
        )
    return telemetry.detail_enabled()


def add_vet_arg(parser) -> None:
    """The static pre-flight gate (``analysis/``), shared by every
    run-executing command."""
    parser.add_argument(
        "--vet", nargs="?", const="on", choices=("on", "strict"),
        default=None,
        help="pre-flight static analysis before each case (also env "
             "ISOTOPE_VET=1|strict): lint the topology/config, audit "
             "a pilot block of the engine, and let the pre-flight "
             "memory verdict pick the ladder's starting rung.  "
             "Blocking findings fail the case; 'strict' promotes "
             "warnings")
