"""The benchmark-suite pipeline: run configs -> collect -> publish.

The port of ``isotope_tpu.runner.suite``.  The reference's CI entry (perf/benchmark/run_benchmark_job.sh) stands a
cluster up, runs every enabled config (run_perf_test.conf toggles),
collects CSVs and flame graphs, and uploads the artifact tree to
``gs://istio-build/perf/<date>_<loadgen>_<branch>_<ver>/`` — the id
format the dashboard scrapes (perf_dashboard/helpers/download.py:56-62).

The simulation suite keeps the same pipeline shape without the cluster:
each experiment TOML runs (checkpointed, resumable) into its own
subdirectory of one publish id, every run's metrics are evaluated
against the standard alarm suite into a monitor-status sink, and a
per-config HTML report plus a manifest round out the artifact tree.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from datetime import datetime, timezone
from typing import List, Optional, Sequence

from isotope_tpu_torch.metrics.alarms import (
    requests_sanity,
    standard_queries,
)
from isotope_tpu_torch.metrics.monitor import MonitorSink, monitor_run
from isotope_tpu_torch.metrics.query import MetricStore
from isotope_tpu_torch.runner.config import load_toml
from isotope_tpu_torch.runner.run import run_experiment


def suite_id(
    labels: str = "master",
    loadgen: str = "sim",
    version: str = "dev",
    date: Optional[datetime] = None,
) -> str:
    """``<date>_<loadgen>_<branch>_<ver>`` (download.py:56-62 format)."""
    date = date or datetime.now(timezone.utc)
    return f"{date:%Y%m%d}_{loadgen}_{labels}_{version}"


@dataclasses.dataclass
class SuiteResult:
    publish_dir: pathlib.Path
    manifest: dict


def run_suite(
    config_paths: Sequence[str],
    out_root,
    id: Optional[str] = None,
    labels: str = "master",
    cpu_limit_mcores: float = 50.0,
    mem_limit_mib: float = 64.0,
    progress=None,
    resume: bool = True,
    policy=None,
    vet=None,
    device=None,
) -> SuiteResult:
    """Run every config, publish one artifact tree, monitor every run."""
    cfgs = [(p, load_toml(p)) for p in config_paths]
    # the publish id carries the loadgen name (download.py:56-62:
    # `<date>_<loadgen>_<branch>_<ver>`); a mixed suite is labeled as such
    loadgens = {c.loadgen for _, c in cfgs} or {"sim"}
    loadgen = loadgens.pop() if len(loadgens) == 1 else "mixed"
    sid = id or suite_id(labels=labels, loadgen=loadgen)
    publish = pathlib.Path(out_root) / sid
    publish.mkdir(parents=True, exist_ok=True)
    # the sink is append-only and every invocation re-evaluates all runs
    # (checkpoint-restored included), so a re-run with the same publish
    # id must start from a fresh file or rows duplicate
    sink_path = publish / "monitor_status.jsonl"
    sink_path.unlink(missing_ok=True)
    sink = MonitorSink(sink_path)

    configs_out: List[dict] = []
    total_runs = 0
    for cfg_path, cfg in cfgs:
        stem = pathlib.Path(cfg_path).stem
        out_dir = publish / stem
        results = run_experiment(
            cfg, out_dir=str(out_dir), progress=progress, resume=resume,
            policy=policy, vet=vet, device=device,
        )
        queries = standard_queries(
            stem, cpu_lim=cpu_limit_mcores, mem_lim=mem_limit_mib
        ) + [requests_sanity(stem)]
        alarm_count = 0
        for r in results:
            if not r.prometheus_text:
                continue
            # the fortio JSON carries nanoseconds; the flat CSV field is
            # truncated to integer seconds, which zeroes every rate()
            # for sub-second runs (and with it the CPU/mem alarms)
            duration = (
                float(r.fortio_json.get("ActualDuration", 0) or 0) / 1e9
            )
            store = MetricStore.from_text(r.prometheus_text, duration)
            rows = monitor_run(store, sink, queries, run_label=r.label)
            alarm_count += sum(1 for row in rows if row.status == "ALARM")

        # per-config dashboard page
        from isotope_tpu_torch.report import write_report

        write_report(
            out_dir, out_dir / "report.html",
            title=f"{sid} — {stem}",
        )
        configs_out.append(
            {
                "config": str(cfg_path),
                "name": stem,
                "runs": len(results),
                "discarded": sum(
                    1 for r in results if r.window.discarded
                ),
                "alarms": alarm_count,
                # engine-level resilience outcomes: cases the supervisor
                # could not recover (retried on the next resume) and
                # cases served degraded (counted, never silent)
                "failed": sum(1 for r in results if r.failed),
                "degraded": sum(
                    1 for r in results if r.degraded_to is not None
                ),
            }
        )
        total_runs += len(results)

    manifest = {
        "id": sid,
        "loadgen": loadgen,
        "configs": configs_out,
        "total_runs": total_runs,
        "total_alarms": sum(c["alarms"] for c in configs_out),
        "total_failed": sum(c["failed"] for c in configs_out),
        "total_degraded": sum(c["degraded"] for c in configs_out),
    }
    with open(publish / "manifest.json", "w") as f:
        json.dump(manifest, f, indent=2)
    return SuiteResult(publish_dir=publish, manifest=manifest)
