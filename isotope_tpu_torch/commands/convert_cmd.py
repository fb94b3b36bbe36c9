"""``kubernetes``, ``graphviz`` and ``security-policies`` subcommands (the
port of ``isotope_tpu.commands.convert_cmd``).

Mirror the reference converter CLI (isotope/convert/cmd/kubernetes.go:30-90,
cmd/graphviz.go:28-48).
"""
from __future__ import annotations

import sys

from isotope_tpu_torch.convert import graphviz as graphviz_mod
from isotope_tpu_torch.convert import kubernetes as k8s_mod
from isotope_tpu_torch.models.graph import ServiceGraph


def register(sub) -> None:
    k8s = sub.add_parser(
        "kubernetes",
        help="convert a topology YAML to Kubernetes manifests (stdout)",
    )
    k8s.add_argument("topology", help="path to the service graph YAML")
    k8s.add_argument(
        "--service-image", default=k8s_mod.DEFAULT_SERVICE_IMAGE
    )
    k8s.add_argument("--client-image", default=k8s_mod.DEFAULT_CLIENT_IMAGE)
    k8s.add_argument(
        "--environment-name",
        default="NONE",
        choices=["NONE", "ISTIO"],
        help="mesh environment (cmd/kubernetes.go:78)",
    )
    k8s.add_argument(
        "--max-idle-connections-per-host", type=int, default=0
    )
    k8s.add_argument(
        "--cluster", default=None,
        help="emit only this cluster's Deployments/Services (the "
             "per-context apply of the reference's multicluster split, "
             "perf/load/common.sh:36-42); the ConfigMap always embeds "
             "the full topology",
    )
    k8s.set_defaults(func=run_kubernetes)

    gv = sub.add_parser(
        "graphviz", help="convert a topology YAML to Graphviz DOT"
    )
    gv.add_argument("topology")
    gv.add_argument(
        "output", nargs="?", help="output file (default: stdout)"
    )
    gv.set_defaults(func=run_graphviz)

    sec = sub.add_parser(
        "security-policies",
        help="generate large-scale AuthorizationPolicy / PeerAuthentication"
             " / RequestAuthentication manifests from a JSON config "
             "(perf/benchmark/security/generate_policies parity)",
    )
    sec.add_argument(
        "config", nargs="?",
        help="JSON config (README 'Config file' schema); default: "
             "empty config",
    )
    sec.add_argument("-o", "--output",
                     help="manifest output file (default: stdout)")
    sec.add_argument("--token-out", metavar="FILE",
                     help="write the signed bearer token here")
    sec.set_defaults(func=run_security)


def run_kubernetes(args) -> int:
    with open(args.topology) as f:
        topology_yaml = f.read()
    graph = ServiceGraph.from_yaml(topology_yaml)
    k8s_mod.validate_service_types(graph)
    opts = k8s_mod.ConvertOptions(
        service_image=args.service_image,
        client_image=args.client_image,
        environment_name=args.environment_name,
        max_idle_connections_per_host=args.max_idle_connections_per_host,
        cluster=args.cluster,
    )
    manifests = k8s_mod.service_graph_to_manifests(graph, topology_yaml, opts)
    sys.stdout.write(k8s_mod.manifests_to_yaml(manifests))
    return 0


def run_graphviz(args) -> int:
    graph = ServiceGraph.from_yaml_file(args.topology)
    dot = graphviz_mod.to_dot(graph)
    if args.output:
        with open(args.output, "w") as f:
            f.write(dot)
    else:
        sys.stdout.write(dot)
    return 0


def run_security(args) -> int:
    from isotope_tpu_torch.convert.security import (
        SecurityPolicyConfig,
        generate_policies,
    )

    if args.config:
        with open(args.config) as f:
            cfg = SecurityPolicyConfig.from_json(f.read())
    else:
        cfg = SecurityPolicyConfig()
    manifests, token = generate_policies(cfg)
    if args.output:
        with open(args.output, "w") as f:
            f.write(manifests)
    else:
        sys.stdout.write(manifests)
    if args.token_out:
        if token is None:
            print("no RequestAuthentication policies: no token generated",
                  file=sys.stderr)
        else:
            with open(args.token_out, "w") as f:
                f.write(token)
    return 0
