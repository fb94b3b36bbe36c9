"""ByteSize value type.

Semantics match the reference's ``size.ByteSize``
(isotope/convert/pkg/graph/size/byte_size.go:25-83), which delegates string
parsing to docker/go-units ``RAMInBytes`` (binary, 1024-based, suffixes
b/k/m/g/t/p with optional "b"/"ib") and formats with ``BytesSize``
(4-significant-digit binary units: "1KiB", "1.5MiB").
"""
from __future__ import annotations

import re

_RAM_RE = re.compile(r"^(\d+(?:\.\d+)*) ?([kKmMgGtTpP])?([iI])?[bB]?$")

_EXP = {"": 0, "k": 1, "m": 2, "g": 3, "t": 4, "p": 5}

_BINARY_ABBRS = ["B", "KiB", "MiB", "GiB", "TiB", "PiB", "EiB", "ZiB", "YiB"]


class InvalidSizeStringError(ValueError):
    def __init__(self, s: str):
        self.string = s
        super().__init__(f"invalid size: '{s}'")


class NegativeSizeError(ValueError):
    def __init__(self, x: int):
        self.value = x
        super().__init__(f"size must be non-negative: {x}")


class ByteSize(int):
    """A non-negative number of bytes."""

    def __str__(self) -> str:
        # go-units BytesSize: binary units, %.4g precision.
        size = float(int(self))
        i = 0
        while size >= 1024.0 and i < len(_BINARY_ABBRS) - 1:
            size /= 1024.0
            i += 1
        return f"{size:.4g}{_BINARY_ABBRS[i]}"

    @classmethod
    def from_string(cls, s: str) -> "ByteSize":
        # go-units RAMInBytes: "10k" == 10 KiB == 10240; "16 MiB"; "32".
        m = _RAM_RE.match(s.strip())
        if m is None:
            raise InvalidSizeStringError(s)
        try:
            value = float(m.group(1))
        except ValueError:
            # go-units' regex admits "32.3.4" but ParseFloat then rejects it.
            raise InvalidSizeStringError(s) from None
        unit = (m.group(2) or "").lower()
        return cls.from_int(int(value * 1024 ** _EXP[unit]))

    @classmethod
    def from_int(cls, x: int) -> "ByteSize":
        # byte_size.go:76-83: non-negative only.
        if x < 0:
            raise NegativeSizeError(x)
        return cls(x)

    @classmethod
    def decode(cls, value) -> "ByteSize":
        """Decode from a parsed YAML/JSON value (str or integer)."""
        if isinstance(value, str):
            return cls.from_string(value)
        if isinstance(value, bool) or not isinstance(value, int):
            if isinstance(value, float) and value.is_integer():
                value = int(value)
            else:
                raise InvalidSizeStringError(repr(value))
        return cls.from_int(value)

    def encode(self):
        """Marshal for YAML/JSON (byte_size.go:33-36).

        go-units' %.4g formatting is lossy for non-round sizes ("120.6KiB"
        re-decodes to a different byte count), which would silently perturb
        payload sizes on a load/save/deploy cycle.  Emit the pretty string
        only when it round-trips exactly; otherwise emit the plain integer
        (also valid input, byte_size.go:44-52).
        """
        pretty = str(self)
        if int(ByteSize.from_string(pretty)) == int(self):
            return pretty
        return int(self)
