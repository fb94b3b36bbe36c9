"""ServiceType enum.

Mirrors ``svctype.ServiceType`` (isotope/convert/pkg/graph/svctype/
service_type.go:26-85): {unknown, http, grpc}, decoded from the lowercase
strings "http" / "grpc".
"""
from __future__ import annotations

import enum


class InvalidServiceTypeStringError(ValueError):
    def __init__(self, s: str):
        self.string = s
        super().__init__(f"unknown service type: {s}")


class ServiceType(enum.IntEnum):
    UNKNOWN = 0
    HTTP = 1
    GRPC = 2

    def __str__(self) -> str:
        if self is ServiceType.HTTP:
            return "HTTP"
        if self is ServiceType.GRPC:
            return "gRPC"
        return ""

    @classmethod
    def from_string(cls, s: str) -> "ServiceType":
        if s == "http":
            return cls.HTTP
        if s == "grpc":
            return cls.GRPC
        raise InvalidServiceTypeStringError(s)

    @classmethod
    def decode(cls, value) -> "ServiceType":
        if isinstance(value, cls):
            return value
        if not isinstance(value, str):
            raise InvalidServiceTypeStringError(repr(value))
        return cls.from_string(value)

    def encode(self) -> str:
        return str(self).lower()
