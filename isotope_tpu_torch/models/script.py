"""Script / command grammar.

Mirrors the reference's polymorphic command decode
(isotope/convert/pkg/graph/script/command.go:73-105):

- a YAML list is a ``ConcurrentCommand`` (all sub-commands fan out in
  parallel);
- a single-key mapping is either ``{sleep: <Go duration>}`` or
  ``{call: <service name | {service, size, probability}>}``;
- multiple keys or unknown keys are errors.

A ``Script`` is an ordered list of commands executed sequentially
(script.go:22; srv/handler.go:66-76).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Union

from isotope_tpu_torch.models.errors import config_path
from isotope_tpu_torch.models.size import ByteSize
from isotope_tpu_torch.utils import duration

SLEEP_COMMAND_KEY = "sleep"
REQUEST_COMMAND_KEY = "call"


class MultipleKeysInCommandError(ValueError):
    def __init__(self, mapping):
        super().__init__(f"multiple keys for command: {mapping}")


class UnknownCommandKeyError(ValueError):
    def __init__(self, key):
        self.key = key
        super().__init__(f"unknown command: {key}")


class InvalidCommandError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class SleepCommand:
    """Pause script execution (sleep_command.go:23-38).

    ``seconds`` holds the parsed Go duration.
    """

    seconds: float

    def __str__(self) -> str:
        return duration.format_duration_seconds(self.seconds)

    @classmethod
    def decode(cls, value: str) -> "SleepCommand":
        if not isinstance(value, str):
            raise InvalidCommandError(f"sleep duration must be a string: {value!r}")
        return cls(duration.parse_duration_seconds(value))

    def encode(self):
        return {SLEEP_COMMAND_KEY: str(self)}


@dataclasses.dataclass(frozen=True)
class RequestCommand:
    """Call another service (request_command.go:26-66).

    ``probability`` is an int percentage in [0, 100]; 0 means "always send"
    (matching srv/executable.go:84-90's shouldSkipRequest).

    ``timeout`` (seconds) and ``retries`` are extensions beyond the
    reference's call grammar: the reference delegates both to Istio
    VirtualService policy outside the topology spec, while the simulator
    models them at the call site.  ``timeout=None`` means no timeout;
    ``retries`` counts extra attempts after a failed one (a failure is a
    5xx response, a connection failure, or a timeout — Envoy's
    ``retry-on`` defaults).
    """

    service_name: str
    size: ByteSize = ByteSize(0)
    probability: int = 0
    timeout: float | None = None
    retries: int = 0

    @classmethod
    def decode(cls, value, default: "RequestCommand") -> "RequestCommand":
        # String form: just the service name, defaults fill the rest
        # (request_command.go:43-50).
        if isinstance(value, str):
            return cls(
                service_name=value,
                size=default.size,
                probability=default.probability,
                timeout=default.timeout,
                retries=default.retries,
            )
        if not isinstance(value, dict):
            raise InvalidCommandError(f"invalid call command: {value!r}")
        unknown = set(value) - {
            "service", "size", "probability", "timeout", "retries",
        }
        if unknown:
            raise InvalidCommandError(f"unknown call fields: {sorted(unknown)}")
        size = (
            ByteSize.decode(value["size"]) if "size" in value else default.size
        )
        probability = value.get("probability", default.probability)
        if (
            isinstance(probability, bool)
            or not isinstance(probability, int)
            or not 0 <= probability <= 100
        ):
            # request_command.go:60-62
            raise InvalidCommandError(
                "math: invalid probability, outside range: [0,100]"
            )
        if "timeout" in value:
            if not isinstance(value["timeout"], str):
                raise InvalidCommandError(
                    f"timeout must be a duration string: {value['timeout']!r}"
                )
            timeout = duration.parse_duration_seconds(value["timeout"])
            if timeout <= 0:
                raise InvalidCommandError("timeout must be positive")
        else:
            timeout = default.timeout
        retries = value.get("retries", default.retries)
        if (
            isinstance(retries, bool)
            or not isinstance(retries, int)
            or retries < 0
        ):
            raise InvalidCommandError(
                f"retries must be a non-negative integer: {retries!r}"
            )
        return cls(
            service_name=value.get("service", default.service_name),
            size=size,
            probability=probability,
            timeout=timeout,
            retries=retries,
        )

    def encode(self):
        body: dict = {"service": self.service_name, "size": self.size.encode()}
        if self.probability:
            body["probability"] = self.probability
        if self.timeout is not None:
            body["timeout"] = duration.format_duration_seconds(self.timeout)
        if self.retries:
            body["retries"] = self.retries
        return {REQUEST_COMMAND_KEY: body}

    @property
    def send_probability(self) -> float:
        """Chance the call is made, in [0, 1]. probability==0 => always."""
        return 1.0 if self.probability == 0 else self.probability / 100.0


class ConcurrentCommand(list):
    """A list of commands that fan out in parallel (concurrent_command.go:19).

    May not contain another ConcurrentCommand (validation.go:48-55).
    """

    def encode(self):
        return [cmd.encode() for cmd in self]


Command = Union[SleepCommand, RequestCommand, ConcurrentCommand]


def decode_command(value: Any, default_request: RequestCommand) -> Command:
    if isinstance(value, list):
        out = ConcurrentCommand()
        for i, v in enumerate(value):
            with config_path(f"[{i}]"):
                out.append(decode_command(v, default_request))
        return out
    if isinstance(value, dict):
        if len(value) > 1:
            raise MultipleKeysInCommandError(value)
        if len(value) == 0:
            raise InvalidCommandError("empty command mapping")
        (key, body), = value.items()
        if key == SLEEP_COMMAND_KEY:
            with config_path(SLEEP_COMMAND_KEY):
                return SleepCommand.decode(body)
        if key == REQUEST_COMMAND_KEY:
            with config_path(REQUEST_COMMAND_KEY):
                return RequestCommand.decode(body, default_request)
        raise UnknownCommandKeyError(key)
    raise InvalidCommandError(f"invalid command: {value!r}")


class Script(list):
    """Ordered list of commands executed sequentially."""

    @classmethod
    def decode(cls, value, default_request: RequestCommand) -> "Script":
        if value is None:
            return cls()
        if not isinstance(value, list):
            raise InvalidCommandError(f"script must be a list: {value!r}")
        out = cls()
        for i, v in enumerate(value):
            with config_path(f"[{i}]"):
                out.append(decode_command(v, default_request))
        return out

    def encode(self):
        return [cmd.encode() for cmd in self]
