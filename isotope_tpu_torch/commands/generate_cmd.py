"""``generate`` (synthetic topologies) and ``pilot-load`` subcommands
(the port of ``isotope_tpu.commands.generate_cmd``).

Mirrors isotope/create_tree_topology.py and create_realistic_topology.py,
with the constants promoted to flags (the reference Makefile passes --type
flags the scripts never parsed — isotope/Makefile:30-72 vs
create_realistic_topology.py:159-165; here they work).
"""
from __future__ import annotations

import sys

import yaml

from isotope_tpu_torch.models import generators


def register(sub) -> None:
    gen = sub.add_parser("generate", help="generate a topology YAML")
    kind = gen.add_subparsers(dest="kind", required=True)

    tree = kind.add_parser("tree", help="BFS-complete tree topology")
    tree.add_argument("--levels", type=int, default=3)
    tree.add_argument("--branches", type=int, default=3)
    tree.add_argument("--request-size", type=int, default=128)
    tree.add_argument("--response-size", type=int, default=128)
    tree.add_argument("--num-replicas", type=int, default=1)
    tree.add_argument(
        "--sleep", default=None, help='per-service sleep, e.g. "10ms"'
    )
    tree.add_argument(
        "--num-services", type=int, default=None,
        help="cap the tree at exactly this many services",
    )
    tree.add_argument(
        "--instances", type=int, default=1,
        help="replicate the topology N times with namespaced service "
             "names (perf/load/common.sh's N-namespace fan-out)",
    )
    tree.add_argument("-o", "--output", default=None)
    tree.set_defaults(func=run_tree)

    real = kind.add_parser(
        "realistic", help="scale-free Barabasi-Albert topology"
    )
    real.add_argument("--services", type=int, default=10)
    real.add_argument(
        "--type",
        dest="archetype",
        default="multitier",
        choices=sorted(generators.ARCHETYPES),
    )
    real.add_argument("--request-size", type=int, default=128)
    real.add_argument("--response-size", type=int, default=128)
    real.add_argument("--num-replicas", type=int, default=1)
    real.add_argument("--seed", type=int, default=0)
    real.add_argument(
        "--instances", type=int, default=1,
        help="replicate the topology N times with namespaced service "
             "names (perf/load/common.sh's N-namespace fan-out)",
    )
    real.add_argument("-o", "--output", default=None)
    real.set_defaults(func=run_realistic)

    pl = kind.add_parser(
        "powerlaw",
        help="Zipf out-degree topology (production-shaped fan-out "
             "skew; the ingest self-closure fixture family)",
    )
    pl.add_argument("--services", type=int, default=100)
    pl.add_argument("--exponent", type=float, default=2.0)
    pl.add_argument("--max-degree", type=int, default=None)
    pl.add_argument("--request-size", type=int, default=128)
    pl.add_argument("--response-size", type=int, default=128)
    pl.add_argument("--num-replicas", type=int, default=1)
    pl.add_argument("--seed", type=int, default=0)
    pl.add_argument(
        "--sleep-choices", default=None,
        help='comma-separated per-service sleep pool, e.g. "1ms,4ms"',
    )
    pl.add_argument(
        "--error-rate-choices", default=None,
        help='comma-separated errorRate pool, e.g. "0%%,1%%,2%%"',
    )
    pl.add_argument("-o", "--output", default=None)
    pl.set_defaults(func=run_powerlaw)


def _emit(doc: dict, output) -> int:
    text = yaml.safe_dump(doc, default_flow_style=False, sort_keys=False)
    if output:
        with open(output, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    return 0


def run_tree(args) -> int:
    doc = generators.tree_topology(
        num_levels=args.levels,
        num_branches=args.branches,
        request_size=args.request_size,
        response_size=args.response_size,
        num_replicas=args.num_replicas,
        sleep=args.sleep,
        num_services=args.num_services,
    )
    return _emit(
        generators.replicate_topology(doc, args.instances), args.output
    )


def run_realistic(args) -> int:
    doc = generators.realistic_topology(
        num_services=args.services,
        archetype=args.archetype,
        request_size=args.request_size,
        response_size=args.response_size,
        num_replicas=args.num_replicas,
        seed=args.seed,
    )
    return _emit(
        generators.replicate_topology(doc, args.instances), args.output
    )


def run_powerlaw(args) -> int:
    doc = generators.powerlaw_topology(
        num_services=args.services,
        exponent=args.exponent,
        max_degree=args.max_degree,
        request_size=args.request_size,
        response_size=args.response_size,
        num_replicas=args.num_replicas,
        seed=args.seed,
        sleep_choices=(
            args.sleep_choices.split(",") if args.sleep_choices else None
        ),
        error_rate_choices=(
            args.error_rate_choices.split(",")
            if args.error_rate_choices else None
        ),
    )
    return _emit(doc, args.output)


def register_pilot(sub) -> None:
    p = sub.add_parser(
        "pilot-load",
        help="model config-push convergence vs ServiceEntry count "
             "(perf/load/pilot/load_test.py analogue)",
    )
    p.add_argument("--entries", default="10,100,1000",
                   help="comma-separated ServiceEntry counts")
    p.add_argument("--endpoints", type=int, default=10,
                   help="endpoints per entry")
    p.add_argument("--proxies", type=int, default=100,
                   help="number of sidecars receiving pushes")
    p.add_argument("--push-throttle", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without a GPU)")
    p.set_defaults(func=run_pilot_load)


def run_pilot_load(args) -> int:
    import json as _json
    import sys as _sys

    from isotope_tpu_torch.sim.controlplane import (
        PilotModel,
        convergence_sweep,
    )
    from isotope_tpu_torch.sim.engine import resolve_device

    model = PilotModel(push_throttle=args.push_throttle)
    rows = convergence_sweep(
        model,
        [int(x) for x in args.entries.split(",") if x.strip()],
        args.endpoints,
        args.proxies,
        seed=args.seed,
        device=resolve_device(args.device),
    )
    for row in rows:
        _sys.stdout.write(_json.dumps(row) + "\n")
    return 0
