#!/usr/bin/env python3
"""Readings that a cell's limits are set from, in one process.

    python3 portbench/calibrate.py --workload NAME --seeds 1,2,... \
        --control-seeds 1,2,3 [--out FILE]

For each seed it runs as many experiments of the cell as a run judges,
through the program at the cell's own sizes, and holds them against the
float64 reference (the sound readings, whose largest is each number's
lower reading); for each control seed it holds the reference computed in
bfloat16 against the float64 one (the control, whose smallest is each
number's upper reading).  Prints one JSON object: every reading and,
per number, the lower and upper reading.  Not part of a benchmark run.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import faults  # noqa: E402
from portbench.harness import bench, cells, check  # noqa: E402
from portbench.reference.sim import Model  # noqa: E402


def readings(name: str, seeds, control_seeds, device="cuda",
             bench_doc=None, base=cells.BASE, fault_seeds=()) -> dict:
    bench_doc = bench_doc or cells.load_bench()
    cell = cells.load_cell(name, bench_doc, base)
    w = cell.workload
    dev = torch.device(device)
    ctx = bench.Ctx(cell=cell, port=bench.program(), device=dev, seed=0)
    bench.build(ctx)
    cell.entry.warm(ctx)
    experiments = list(range(w.get("check_experiments", 1)))
    def program_runs(s):
        ctx.seed = s
        return [cell.entry.run(ctx, ctx.source((k,))) for k in experiments]

    prog = {s: program_runs(s) for s in seeds}
    planted = {}
    for f, plant in faults.planted(w).items():
        for s in fault_seeds:
            with plant():
                planted[f, s] = program_runs(s)
    prefixes = cell.entry.prefixes(ctx)
    ctx.sim = None
    gc.collect()
    ref64 = Model(cell.config, dev)
    ref16 = Model(cell.config, dev, torch.bfloat16)

    def ref_runs(model, s, judged=None):
        """The reference's runs of seed ``s``, each judging ``judged``'s
        run at the same place (none: on its own)."""
        return [[bench.reference_run(
            ctx, model, s, k, p,
            judged[i][j] if judged is not None else None)
            for j, p in enumerate(prefixes)]
            for i, k in enumerate(experiments)]

    def worst(runs, refs):
        return check.worst(check.entry_gaps(cell.entry, p, r)
                           for pk, rk in zip(runs, refs)
                           for p, r in zip(pk, rk))

    sound, control = {}, {}
    for s in sorted(set(seeds) | set(control_seeds)):
        if s in prog:
            sound[s] = worst(prog[s], ref_runs(ref64, s, prog[s]))
        if s in control_seeds:
            low = ref_runs(ref16, s)
            control[s] = worst(low, ref_runs(ref64, s, low))
    faulty = {}
    for (f, s), runs in planted.items():
        faulty.setdefault(f, {})[s] = worst(runs, ref_runs(ref64, s, runs))
    lower = check.worst(sound.values())
    upper = {k: min(c[k] for c in control.values())
             for k in lower} if control else {}
    return {"cell": name, "sound": sound, "control": control,
            "faults": faulty, "lower": lower, "upper": upper,
            "fault_least": {f: {k: min(r[k] for r in by.values())
                                for k in lower} for f, by in faulty.items()},
            "device": torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else device,
            "seconds": time.perf_counter() - T_START}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    out = readings(args.workload, ints(args.seeds),
                   ints(args.control_seeds),
                   fault_seeds=ints(args.fault_seeds))
    text = json.dumps(out)
    if args.out:
        pathlib.Path(args.out).write_text(text + "\n")
    print(json.dumps({k: out[k] for k in ("cell", "lower", "upper",
                                           "fault_least", "seconds")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
