from isotope_tpu_torch.models.pct import Percentage
from isotope_tpu_torch.models.size import ByteSize
from isotope_tpu_torch.models.svctype import ServiceType
from isotope_tpu_torch.models.script import (
    Command,
    ConcurrentCommand,
    RequestCommand,
    Script,
    SleepCommand,
)
from isotope_tpu_torch.models.service import Service
from isotope_tpu_torch.models.graph import ServiceGraph

__all__ = [
    "Percentage",
    "ByteSize",
    "ServiceType",
    "Command",
    "SleepCommand",
    "RequestCommand",
    "ConcurrentCommand",
    "Script",
    "Service",
    "ServiceGraph",
]
