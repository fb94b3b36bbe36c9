"""Percentage value type.

Semantics match the reference's ``pct.Percentage``
(isotope/convert/pkg/graph/pct/percentage.go:26-93): a float in [0, 1],
decodable from a JSON/YAML number in [0, 1] or a string like "12.5%"
(interpreted as value/100, which must land in [0, 1]).
"""
from __future__ import annotations


class InvalidPercentageStringError(ValueError):
    def __init__(self, s: str):
        self.string = s
        super().__init__(f'invalid percentage string "{s}"')


class OutOfRangeError(ValueError):
    def __init__(self, f: float):
        self.value = f
        super().__init__(f"percentage out of range [0, 1]: {f}")


class Percentage(float):
    """A float between 0 and 1, renderable as "X.XX%"."""

    def __str__(self) -> str:  # percentage.go:28-30
        return f"{float(self) * 100:.2f}%"

    @classmethod
    def from_string(cls, s: str) -> "Percentage":
        # percentage.go:69-81: require a '%', parse the prefix, divide by 100.
        idx = s.find("%")
        if idx < 0:
            raise InvalidPercentageStringError(s)
        try:
            f = float(s[:idx])
        except ValueError:
            raise InvalidPercentageStringError(s) from None
        return cls.from_float(f / 100)

    @classmethod
    def from_float(cls, f: float) -> "Percentage":
        # percentage.go:84-93: valid iff 0 <= f <= 1.
        if 0 <= f <= 1:
            return cls(f)
        raise OutOfRangeError(f)

    @classmethod
    def decode(cls, value) -> "Percentage":
        """Decode from a parsed YAML/JSON value (str or number)."""
        if isinstance(value, str):
            return cls.from_string(value)
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise InvalidPercentageStringError(repr(value))
        return cls.from_float(float(value))

    def encode(self) -> float:
        """Marshal as a JSON number (percentage.go:33-35)."""
        return float(self)
