"""``fidelity``: diff the sim against a real Fortio run (the port of
``isotope_tpu.commands.fidelity_cmd``).

The ground-truth workflow for the north star's "p99 within 5% of a
real Fortio run" clause (BASELINE.json): take an actual ``fortio load
-json`` artifact from the cluster (the schema
perf/benchmark/runner/fortio.py:38-75 flattens), point this command at
it plus the topology the cluster ran, and it reconstructs the load
(closed-loop workers at the artifact's NumThreads/RequestedQPS),
simulates on the device (``--device``, CUDA by default), and reports
per-percentile deltas against the clause.  Exit code 0 when every
percentile is inside the tolerance, 1 otherwise.
"""
from __future__ import annotations

import json

from isotope_tpu_torch.utils import duration as dur


def register(sub) -> None:
    f = sub.add_parser(
        "fidelity",
        help="diff simulated percentiles against a real fortio "
             "load -json artifact",
    )
    f.add_argument("topology", help="path to the service graph YAML "
                                    "the cluster ran")
    f.add_argument("--fortio", required=True,
                   help="path to the fortio load -json result")
    f.add_argument("--tolerance", type=float, default=0.05,
                   help="relative per-percentile tolerance "
                        "(default 0.05 — the north-star clause)")
    f.add_argument("--max-requests", type=int, default=1_000_000)
    f.add_argument("--service-time",
                   choices=["exponential", "deterministic", "lognormal",
                            "pareto"],
                   default="exponential")
    f.add_argument("--service-time-param", type=float, default=None)
    f.add_argument("--cpu-time", default=None,
                   help='per-request CPU demand, e.g. "77us"')
    f.add_argument("--entry", default=None)
    f.add_argument("--seed", type=int, default=0)
    f.add_argument("--json", action="store_true", dest="as_json",
                   help="print a machine-readable report instead")
    f.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without a GPU)")
    f.set_defaults(func=run_fidelity)


def run_fidelity(args) -> int:
    from isotope_tpu_torch.metrics.fidelity import check_fidelity
    from isotope_tpu_torch.sim.config import SimParams

    with open(args.fortio) as fh:
        doc = json.load(fh)
    with open(args.topology) as fh:
        topology_yaml = fh.read()

    extra = {}
    if args.cpu_time is not None:
        extra["cpu_time_s"] = dur.parse_duration_seconds(args.cpu_time)
    if args.service_time_param is not None:
        extra["service_time_param"] = args.service_time_param
    elif args.service_time == "pareto":
        extra["service_time_param"] = 1.5
    params = SimParams(service_time=args.service_time, **extra)

    report = check_fidelity(
        doc,
        topology_yaml,
        params=params,
        tolerance=args.tolerance,
        max_requests=args.max_requests,
        entry=args.entry,
        seed=args.seed,
        device=args.device,
    )
    if args.as_json:
        print(json.dumps({
            "ok": report.ok,
            "tolerance": report.tolerance,
            "actual_qps": {"fortio": report.actual_qps_fortio,
                           "sim": report.actual_qps_sim},
            "error_percent": {"fortio": report.error_percent_fortio,
                              "sim": report.error_percent_sim},
            "percentiles": [
                {"percentile": d.percentile, "fortio_s": d.fortio_s,
                 "sim_s": d.sim_s, "rel_err": d.rel_err}
                for d in report.deltas
            ],
        }))
    else:
        for line in report.lines():
            print(line)
    return 0 if report.ok else 1
