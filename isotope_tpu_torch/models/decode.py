"""Shared scalar decoders for the topology control-plane YAML blocks.

``sim/policies.py`` (the ``policies:`` block) and ``sim/rollout.py``
(the ``rollouts:`` block) validate their configuration with the same
scalar vocabulary — durations ("30s" or seconds), fractions ("5%" or
0.05), plain numbers, integers — and the same optional-field idiom:
an absent or explicit-``null`` key falls back to the default, a
present value decodes under a key-pathed error context
(``models.errors.config_path``).  One copy here keeps the two blocks'
validation behavior from silently diverging.
"""
from __future__ import annotations

from isotope_tpu_torch.models.errors import config_path
from isotope_tpu_torch.models.pct import Percentage
from isotope_tpu_torch.utils import duration as dur


def duration_s(value) -> float:
    """Seconds from a duration string ("250ms", "30s") or a number."""
    if isinstance(value, str):
        return dur.parse_duration_seconds(value)
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise ValueError(f"expected a duration: {value!r}")
    return float(value)


def fraction(value) -> float:
    """A fraction in [0, 1]: a number, or a percent string ("60%")."""
    return float(Percentage.decode(value))


def number(value) -> float:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise ValueError(f"expected a number: {value!r}")
    return float(value)


def integer(value) -> int:
    if isinstance(value, bool) or not isinstance(value, int):
        raise ValueError(f"expected an integer: {value!r}")
    return value


def keyword(value, options) -> str:
    """A string drawn from a closed vocabulary (e.g. the ``lb:`` law
    names) — anything else names the valid options in the error."""
    if not isinstance(value, str) or value not in options:
        raise ValueError(
            f"expected one of {'/'.join(options)}: {value!r}"
        )
    return value


def field(mapping: dict, key: str, decode, fallback):
    """Decode ``mapping[key]`` under a key-pathed error context, or the
    fallback when the key is absent or explicitly ``null``."""
    if key not in mapping or mapping[key] is None:
        return fallback
    with config_path(key):
        return decode(mapping[key])
