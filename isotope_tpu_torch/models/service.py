"""Service node type.

Mirrors ``svc.Service`` (isotope/convert/pkg/graph/svc/service.go:25-51):
name, type, numReplicas, isEntrypoint, errorRate, responseSize, script,
numRbacPolicies — with defaults applied from the graph-level ``defaults``
block during decode (svc/unmarshal.go:29-41).
"""
from __future__ import annotations

import dataclasses

from isotope_tpu_torch.models.errors import config_path
from isotope_tpu_torch.models.pct import Percentage
from isotope_tpu_torch.models.script import RequestCommand, Script
from isotope_tpu_torch.models.size import ByteSize
from isotope_tpu_torch.models.svctype import ServiceType


class EmptyNameError(ValueError):
    def __init__(self):
        super().__init__("services must have a name")


_FIELDS = {
    "name",
    "type",
    "numReplicas",
    "isEntrypoint",
    "errorRate",
    "responseSize",
    "script",
    "numRbacPolicies",
    "cluster",
}


@dataclasses.dataclass
class Service:
    name: str
    type: ServiceType = ServiceType.HTTP
    num_replicas: int = 1
    is_entrypoint: bool = False
    error_rate: Percentage = Percentage(0.0)
    response_size: ByteSize = ByteSize(0)
    script: Script = dataclasses.field(default_factory=Script)
    num_rbac_policies: int = 0
    # Extension beyond svc.Service: the reference splits one service
    # graph across cluster1/cluster2 (+ VM workloads) at the helm layer
    # (perf/load/templates/service-graph.gen.yaml:1-3, common.sh:36-42)
    # so cross-cluster edges traverse egress/ingress gateways.  Here the
    # placement is a first-class topology field; "" = the default
    # cluster.  Cross-cluster edges pay NetworkModel's cross-cluster
    # latency/bandwidth class.
    cluster: str = ""

    @classmethod
    def decode(
        cls,
        value: dict,
        default: "Service",
        default_request: RequestCommand,
    ) -> "Service":
        if not isinstance(value, dict):
            raise ValueError(f"service must be a mapping: {value!r}")
        unknown = set(value) - _FIELDS
        if unknown:
            raise ValueError(f"unknown service fields: {sorted(unknown)}")
        name = value.get("name", "")
        if not name:
            raise EmptyNameError()

        def field(key, decode, fallback):
            if key not in value:
                return fallback
            with config_path(key):
                return decode(value[key])

        return cls(
            name=name,
            type=field("type", ServiceType.decode, default.type),
            num_replicas=field(
                "numReplicas",
                lambda v: decode_strict_int(v, "numReplicas"),
                default.num_replicas,
            ),
            is_entrypoint=bool(value.get("isEntrypoint", default.is_entrypoint)),
            error_rate=field(
                "errorRate", Percentage.decode, default.error_rate
            ),
            response_size=field(
                "responseSize", ByteSize.decode, default.response_size
            ),
            script=field(
                "script",
                lambda v: Script.decode(v, default_request),
                Script(default.script),
            ),
            num_rbac_policies=field(
                "numRbacPolicies",
                lambda v: decode_strict_int(v, "numRbacPolicies"),
                default.num_rbac_policies,
            ),
            cluster=field("cluster", decode_cluster, default.cluster),
        )

    def encode(self, default: "Service | None" = None) -> dict:
        """Marshal to a plain dict, omitting fields equal to ``default``.

        ``default`` must be the same effective default Service the graph was
        decoded with so that decode(encode(g)) round-trips even when the
        graph-level ``defaults`` block overrides built-in defaults.
        """
        if default is None:
            default = DEFAULT_SERVICE
        out: dict = {"name": self.name}
        if self.type != default.type:
            out["type"] = self.type.encode()
        if self.num_replicas != default.num_replicas:
            out["numReplicas"] = self.num_replicas
        if self.is_entrypoint:
            out["isEntrypoint"] = True
        if float(self.error_rate) != float(default.error_rate):
            out["errorRate"] = self.error_rate.encode()
        if int(self.response_size) != int(default.response_size):
            out["responseSize"] = self.response_size.encode()
        if list(self.script) != list(default.script):
            out["script"] = self.script.encode()
        if self.num_rbac_policies != default.num_rbac_policies:
            out["numRbacPolicies"] = self.num_rbac_policies
        if self.cluster != default.cluster:
            out["cluster"] = self.cluster
        return out


def decode_strict_int(value, field: str) -> int:
    """Reject bools and non-integers (YAML typos should fail loudly)."""
    if isinstance(value, bool) or not isinstance(value, int):
        raise ValueError(f"{field} must be an integer: {value!r}")
    return value


def decode_cluster(value) -> str:
    if not isinstance(value, str):
        raise ValueError(f"cluster must be a string: {value!r}")
    return value


DEFAULT_SERVICE = Service(name="", type=ServiceType.HTTP, num_replicas=1)
