"""Kubernetes manifest generation from a ServiceGraph.

Capability parity with the reference converter
(isotope/convert/pkg/kubernetes/kubernetes.go:56-137): emits a Namespace
with istio-injection enabled (:150-157), a ConfigMap embedding the whole
topology YAML (:159-175), and per service a Service (:177-187) plus a
Deployment (:189-270) that mounts the config at
/etc/config/service-graph.yaml, sets SERVICE_NAME and downward-API env vars,
and carries the prometheus scrape annotation. A Fortio client
Deployment+Service is appended (fortio_client.go:28-78), and when the
environment is ISTIO, per-service RBAC policies (rbac.go:25-71).

The manifests target real clusters; in this framework they exist so users of
the reference can still deploy a topology for ground-truth runs to validate
the simulator against.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import yaml

from isotope_tpu_torch.models.graph import ServiceGraph
from isotope_tpu_torch.models.svctype import ServiceType

# consts/consts.go:22-46
SERVICE_GRAPH_NAMESPACE = "service-graph"
SERVICE_GRAPH_CONFIG_MAP = "service-graph-config"
CONFIG_PATH = "/etc/config"
SERVICE_GRAPH_YAML_KEY = "service-graph.yaml"
SERVICE_PORT = 8080
SERVICE_NAME_ENV = "SERVICE_NAME"
FORTIO_METRICS_PORT = 42422

DEFAULT_SERVICE_IMAGE = "istio.io/isotope-service:latest"
DEFAULT_CLIENT_IMAGE = "fortio/fortio"


@dataclasses.dataclass
class ConvertOptions:
    service_image: str = DEFAULT_SERVICE_IMAGE
    client_image: str = DEFAULT_CLIENT_IMAGE
    environment_name: str = "NONE"  # NONE | ISTIO (cmd/kubernetes.go:78)
    service_node_selector: Optional[dict] = None
    client_node_selector: Optional[dict] = None
    max_idle_connections_per_host: int = 0
    # multicluster: emit only this cluster's Deployments/Services (the
    # per-context apply of the reference's multicluster split,
    # perf/load/common.sh:36-42); None = everything.  The ConfigMap
    # always embeds the FULL topology — every pod needs the whole graph
    # — and the load client deploys only alongside the entrypoint's
    # cluster.
    cluster: Optional[str] = None


def service_graph_to_manifests(
    graph: ServiceGraph,
    topology_yaml: str,
    opts: Optional[ConvertOptions] = None,
) -> List[dict]:
    opts = opts if opts is not None else ConvertOptions()
    if opts.cluster is not None:
        known = {getattr(s, "cluster", "") for s in graph.services}
        if opts.cluster not in known:
            raise ValueError(
                f"no service is placed in cluster {opts.cluster!r}; "
                f"topology clusters: {sorted(known)}"
            )
    manifests: List[dict] = [
        _namespace(),
        _config_map(topology_yaml),
    ]
    for svc in graph.services:
        if opts.cluster is not None and (
            getattr(svc, "cluster", "") != opts.cluster
        ):
            continue
        manifests.append(_k8s_service(svc.name))
        manifests.append(_deployment(svc, opts))
    entry_cluster = next(
        (getattr(s, "cluster", "") for s in graph.services
         if s.is_entrypoint),
        "",
    )
    if opts.cluster is None or opts.cluster == entry_cluster:
        manifests.extend(_fortio_client(opts))
    if opts.environment_name == "ISTIO":
        manifests.extend(_rbac_policies(graph, opts.cluster))
    return manifests


def manifests_to_yaml(manifests: List[dict]) -> str:
    return "\n---\n".join(
        yaml.safe_dump(m, default_flow_style=False, sort_keys=False)
        for m in manifests
    )


def _namespace() -> dict:
    # kubernetes.go:150-157: istio-injection=enabled label.
    return {
        "apiVersion": "v1",
        "kind": "Namespace",
        "metadata": {
            "name": SERVICE_GRAPH_NAMESPACE,
            "labels": {"istio-injection": "enabled"},
        },
    }


def _config_map(topology_yaml: str) -> dict:
    # kubernetes.go:159-175: the full topology YAML is the single source of
    # truth, mounted into every pod.
    return {
        "apiVersion": "v1",
        "kind": "ConfigMap",
        "metadata": {
            "name": SERVICE_GRAPH_CONFIG_MAP,
            "namespace": SERVICE_GRAPH_NAMESPACE,
        },
        "data": {SERVICE_GRAPH_YAML_KEY: topology_yaml},
    }


def _k8s_service(name: str) -> dict:
    # kubernetes.go:177-187.
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": name,
            "namespace": SERVICE_GRAPH_NAMESPACE,
            "labels": {"app": name},
        },
        "spec": {
            "ports": [{"port": SERVICE_PORT, "name": "http"}],
            "selector": {"app": name},
        },
    }


def _deployment(svc, opts: ConvertOptions) -> dict:
    # kubernetes.go:189-270.
    args = []
    if opts.max_idle_connections_per_host > 0:
        args = [
            f"--max-idle-connections-per-host={opts.max_idle_connections_per_host}"
        ]
    container = {
        "name": "mock-service",
        "image": opts.service_image,
        "args": args,
        "ports": [{"containerPort": SERVICE_PORT}],
        "env": [
            {"name": SERVICE_NAME_ENV, "value": svc.name},
            _downward("PODNAME", "metadata.name"),
            _downward("PODIP", "status.podIP"),
            _downward("NAMESPACE", "metadata.namespace"),
            _downward("NODENAME", "spec.nodeName"),
        ],
        "volumeMounts": [
            {"name": "config-volume", "mountPath": CONFIG_PATH}
        ],
    }
    spec = {
        "replicas": svc.num_replicas,
        "selector": {"matchLabels": {"app": svc.name}},
        "template": {
            "metadata": {
                "labels": {"app": svc.name},
                "annotations": {
                    # kubernetes.go:49-52: prometheus scrape annotations.
                    "prometheus.io/scrape": "true",
                    "prometheus.io/port": str(SERVICE_PORT),
                },
            },
            "spec": {
                "containers": [container],
                "volumes": [
                    {
                        "name": "config-volume",
                        "configMap": {"name": SERVICE_GRAPH_CONFIG_MAP},
                    }
                ],
            },
        },
    }
    if opts.service_node_selector:
        spec["template"]["spec"]["nodeSelector"] = dict(
            opts.service_node_selector
        )
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {
            "name": svc.name,
            "namespace": SERVICE_GRAPH_NAMESPACE,
            "labels": {"app": svc.name},
        },
        "spec": spec,
    }


def _downward(name: str, field_path: str) -> dict:
    return {
        "name": name,
        "valueFrom": {"fieldRef": {"fieldPath": field_path}},
    }


def _fortio_client(opts: ConvertOptions) -> List[dict]:
    # fortio_client.go:28-78: client Deployment + Service, ports 8080 and
    # a separate metrics port 42422.
    name = "client"
    deployment = {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {
            "name": name,
            "namespace": SERVICE_GRAPH_NAMESPACE,
            "labels": {"app": name},
        },
        "spec": {
            "replicas": 1,
            "selector": {"matchLabels": {"app": name}},
            "template": {
                "metadata": {"labels": {"app": name}},
                "spec": {
                    "containers": [
                        {
                            "name": "fortio-client",
                            "image": opts.client_image,
                            "args": ["server"],
                            "ports": [
                                {"containerPort": SERVICE_PORT},
                                {"containerPort": FORTIO_METRICS_PORT},
                            ],
                        }
                    ]
                },
            },
        },
    }
    if opts.client_node_selector:
        deployment["spec"]["template"]["spec"]["nodeSelector"] = dict(
            opts.client_node_selector
        )
    service = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": name,
            "namespace": SERVICE_GRAPH_NAMESPACE,
            "labels": {"app": name},
        },
        "spec": {
            "ports": [
                {"port": SERVICE_PORT, "name": "http"},
                {"port": FORTIO_METRICS_PORT, "name": "metrics"},
            ],
            "selector": {"app": name},
        },
    }
    return [deployment, service]


def _rbac_policies(
    graph: ServiceGraph, cluster: Optional[str] = None
) -> List[dict]:
    # rbac.go:25-71 + kubernetes.go:107-133: per-service ServiceRole +
    # ServiceRoleBinding fan-out, plus an allow-all role and RbacConfig.
    # ``cluster`` mirrors the Deployment/Service filter: a per-context
    # apply (the reference's common.sh:36-42 flow) must only carry
    # policies for the workloads that live in that cluster.
    manifests: List[dict] = [
        {
            "apiVersion": "rbac.istio.io/v1alpha1",
            "kind": "RbacConfig",
            "metadata": {"name": "default"},
            "spec": {
                "mode": "ON_WITH_INCLUSION",
                "inclusion": {"namespaces": [SERVICE_GRAPH_NAMESPACE]},
            },
        }
    ]
    for svc in graph.services:
        if cluster is not None and getattr(svc, "cluster", "") != cluster:
            continue
        for i in range(svc.num_rbac_policies):
            role_name = f"{svc.name}-role-{i}"
            manifests.append(
                {
                    "apiVersion": "rbac.istio.io/v1alpha1",
                    "kind": "ServiceRole",
                    "metadata": {
                        "name": role_name,
                        "namespace": SERVICE_GRAPH_NAMESPACE,
                    },
                    "spec": {
                        "rules": [
                            {
                                "services": [
                                    f"{svc.name}.{SERVICE_GRAPH_NAMESPACE}.svc.cluster.local"
                                ],
                                "methods": ["GET"],
                            }
                        ]
                    },
                }
            )
            manifests.append(
                {
                    "apiVersion": "rbac.istio.io/v1alpha1",
                    "kind": "ServiceRoleBinding",
                    "metadata": {
                        "name": role_name,
                        "namespace": SERVICE_GRAPH_NAMESPACE,
                    },
                    "spec": {
                        "subjects": [{"user": "*"}],
                        "roleRef": {"kind": "ServiceRole", "name": role_name},
                    },
                }
            )
    return manifests


def validate_service_types(graph: ServiceGraph) -> None:
    """The deployable runtime is HTTP-only (service/main.go:191-203)."""
    for svc in graph.services:
        if svc.type is ServiceType.GRPC:
            raise ValueError(
                f"service {svc.name}: grpc services are not supported by the "
                "mock-service runtime in this fork"
            )
