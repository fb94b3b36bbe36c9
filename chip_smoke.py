"""Drive the PyTorch port on one CUDA card, end to end, and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (any
CUDA card of compute capability 9.0 with ``nvcc``).  Phases, in order;
any failure exits non-zero and nothing is caught:

1. card: name and power limit from ``nvidia-smi``;
2. build: compile the census and wait kernels
   (``isotope_tpu_torch/native/csrc``) with ``nvcc`` for ``sm_90a`` and
   print what ``ptxas -v`` says of each kernel (registers, shared
   memory, spills);
3. kernel: hold the kernel against its plain torch version on the card
   at every census shape of the main path (each dense level with
   children and each tile holding calls of the eleven runs of phase 5,
   and of the closed loops' rate pilots, as ``Simulator.census_shapes``
   gives them: among them the star-10k block's tiles and its 1 x 5,021
   root, every call of the three scenario runs, all with a fail step,
   and the panic run's call with both a fail step and error flags), at
   the default blocks of
   ``realistic-star-50.yaml`` and ``realistic-star-auxiliary-50.yaml``
   and at fixture shapes, among them a 4,096-step axis, and at the
   fleets' calls (ensembleN folded: one call a level of 32 x 8,192 rows
   of ``1000-svc_2000-end``; svc1000-chaosfleet's members at 4,096) and
   the search brackets' folded rungs (search64's 64, 16 and 4 x 4,096
   rows; the planted bracket's 16 and 4 x 64, with error flags) and
   the runner suite's cases (phase 8: ``canonical.yaml`` at each case's
   own block, 2,400 to 240,000 rows, and its rate pilot) and the
   calibration path's (phase 9: ``fidelity``'s 65,536-row blocks and
   rate pilot, the closure's source and twin, the fitted topology's
   sweep at its default block, that topology fitted from a CPU
   recording of 2,048 requests) and phase 10's (each pilot block, each
   vetted run's block, the flagship's half-block rung, and
   ``canonical.yaml``'s pilot and 2,000-request block)
   (rtol 1e-5: the
   plain version's ``cumsum`` may associate differently), and bit for
   bit against ``census_sequential``, the kernel's own order of
   operations in plain torch.  Then, per census call of one block of each
   of those configurations, print the kernel's device-only time
   (``torch.profiler``'s device time for the kernel's own name, L2
   flushed before every launch), its bound and share of bound, the
   wrapper's host cost (host clock over a few hundred enqueues) and the
   plain version's time, and per block the sums; then every level on
   the ragged census (a dense level more than 4x padded: star-10k's
   levels 2 and 3, the realistic topologies' wide levels) at its block,
   the ragged kernel against the dense site's chain on the card bit for
   bit, its device time beside its bound, the chain's time and the
   plain version's; (after phase 5's runs, whose saturated runs each
   launch the finite-population wait kernel once a block, counted
   exactly) the wait kernel (``native/satwait.py``) at multitier1k's
   30,000 x 1,000 block with 11 coefficients (synthetic tables) and at
   the calls of the saturated runs (``canonical-qps-max``'s blocks and
   fork-join pilots, canonical-2r-qps-max-bounce's phased blocks, with
   their own tables and rows): bit for bit against
   ``saturated_wait_sequential``, within rtol 1e-4 / atol 1e-5 s of the
   plain chain (its largest difference printed), its device time beside
   its bound (8 B a hop-row), the plain chain's time and its host cost;
4. in situ: one block of the flagship tree (1000 qps), of the
   retry/timeout/error topology (500 qps) and of
   ``realistic-powerlaw-100.yaml`` (6,500 qps), 16,384 requests each, of
   the star-10k graph with 30 s timeouts (3,355 requests at 6,500 qps)
   and of ``canonical.yaml`` under ``-qps max`` (16,384 requests, 64
   connections; its tables and rate solved once on the CPU and used by
   both sides), and every block of the three scenario runs of phase 5
   (svc100k-chaos, canonical-2r-storm, canonical-2r-qps-max-bounce), the
   whole lb-10svc-100r-panic run and one block of 16,384 requests of
   lb-1000svc-lr, with the same draws, on the card (kernel) and on the
   CPU (plain version), compared like the CPU tests compare the port
   with the JAX package; then the attribution sweep
   (``metrics/attribution.py``): each block of the flagship (tail, its
   cut from the pilot), of the retry/timeout/error topology (mean), of
   svc100k-chaos (its first two blocks) and of the protected policy
   twin (tail) is attributed on the card and, moved to the CPU, by the
   CPU's sweep: counts and blame histograms equal, seconds within rtol
   1e-5 / atol 1e-9 s, residuals within 16 float32 spacings of the
   latency sum, exemplars equal; and the flagship's and the
   retry/timeout topology's whole attributed runs, card against CPU
   each on its own results (summaries, attributed and tail counts, total
   blame, crit counts within 1e-4 of their total: winner ties); then
   the fleets (``fleet_in_situ``): a jittered fleet of 4 x 4,096 of the
   retry/timeout/error topology, open and paced, folded and member by
   member on the card against the CPU's member by member (counts and
   hop events exactly, histograms within one bucket for at most 1e-3 of
   their counts, sums within rtol 1e-5), a chaos fleet (each member's
   outage jittered) card against CPU, a protected fleet's member under
   its own jittered kill against the card's solo run of it (bit for
   bit) and block by block against the CPU's under the card's control
   effects, and an observed fleet's members' blame, each block
   attributed on the card and by the CPU's sweep; then the planted
   bracket (``planted_in_situ``, the reference's ``tools/search_smoke.py``
   size): its rungs ranked by (severity, tie-break), candidate 5 the
   least severe of every rung it runs in, rung 0 equal to
   ``run_ensemble`` at the screening horizon and the winner's carried
   segments to the unbroken fleet's row (exact fields), the card's
   folded bracket equal to the CPU's in lineage and counts;
5. main path at full size, after one warm-up block of each run (the
   warm-up also solves and caches the closed loops' rates from the same
   seed, so the timed closed-loop runs skip their pilots and tables): the
   flagship (121 hops) open loop at 100k qps in 4 blocks of 262,144
   requests, ``1000-svc_2000-end.yaml`` open loop at 10k qps in blocks
   of 32,768, ``canonical.yaml`` paced closed loop at the CLI defaults,
   ``realistic-powerlaw-100.yaml`` open loop at 6,500 qps (half its
   capacity) in 2 blocks of its default 335,544, the 10,000-service star
   graph with 30 s timeouts (BASELINE configs[3]) open loop at 6,500 qps
   (half its capacity) in 4 blocks of its default 3,355, and
   ``canonical.yaml`` under ``-qps max`` (64 connections, 240 s, capped
   at 1,000,000 requests: 2 blocks of 524,288); then the scenario
   runs: svc100k-chaos (BASELINE configs[4]: the 100,000-service
   multitier graph, Pareto service times, a total outage of ``mock-7``
   in [5 s, 15 s), open loop at 100 qps, 4 blocks of its default 335),
   canonical-2r-storm (``canonical-2-replicas.yaml`` under ``ISTIO``, open
   loop at 10,000 qps in 2 blocks of 262,144: one of b's two replicas
   killed ungracefully in [10 s, 20 s), the canary rotation of c's
   traffic every 30 s, an mTLS tax of 0 / 1 ms every 20 s) and
   canonical-2r-qps-max-bounce (the same graph under ``-qps max``, 64
   connections, 2 blocks of 524,288, b bounced to one replica for 10 s
   every 60 s from 30 s); then the lb runs: lb-10svc-100r-panic
   (``10-svc_1000-end.yaml``, 10 services of 100 replicas, under
   least_request with d = 2 and a 50% panic threshold, a ring hash of
   skew 1.2 on ``svc-0-0`` and wrr 3:1:1:1 on ``svc-0-1``, 60 of
   ``svc-0-2``'s replicas killed in [2 s, 6 s), open loop at 30,000 qps
   for 8 s in its default block) and lb-1000svc-lr
   (``1000-svc_2000-end.yaml`` under least_request, the 1000-svc run's
   load); the host build times (graph, compile, ``Simulator(...)``, the
   saturated tables) are printed, the launch count is set to 0 just
   before each run and must equal its blocks times its census calls per
   block just after; the share of ``svc-0-2``'s hops that fast-fail in
   the kill window is printed and must be 60% (+-1%), and 0 outside;
   then the attributed runs (``run_attributed``; ``run_policies(
   attribution=True)``): the flagship (tail, top-K 8),
   ``1000-svc_2000-end`` (mean), svc100k-chaos (mean) and
   policies-smoke (tail), each with its wall per block beside its
   unattributed twin's, its torch ops a block beside the twin's (counted
   on the card), its peak device memory, its census launches (its blocks
   and its tail pilot's) and the telescoping check: the charges plus the
   residual equal the latency sum within rtol 1e-5; then the fleets, at
   the reference bench's shapes: ensembleN (``1000-svc_2000-end.yaml``
   open loop at 10,000 qps, 32 seed members x 8,192 requests in blocks
   of 8,192) folded, member by member and as 32 solo runs on the same
   member sources (the map members bit-equal to the solos, the folded
   fleet equal to the map fleet as in phase 4), svc1000-chaosfleet (the
   same graph with a 25% retry budget, one replica of ``services[1]``
   down in [0.05 s, 0.25 s) under ``ChaosJitterSpec(time=0.3,
   magnitude=0.5, seed=0)``: ``run_policies_ensemble``, 8 members x
   8,192 in blocks of 4,096, 50 ms windows; the worst member's severity)
   and ensembleN-observed (8 members, mean attribution and the
   recorder, then ``fleetblame.to_doc``) beside its unobserved twin,
   each with its wall, aggregate hop-events/s, census launches (set to
   0 just before, checked just after) and peak device memory; then the
   brackets (``search_phase``): search64 (64 jittered candidates of
   ``1000-svc_2000-end`` at 10,000 qps, eta 4, growth 2, 3 rungs of 1, 2
   and 4 blocks of 4,096) beside the sequential sweep of 64 + 16 + 4 solo
   ``run_summary`` runs it replaces, the protected bracket (16 candidates
   on svc1000-chaosfleet's Simulator ranked by trips: rung 0 equal to
   ``run_policies_ensemble`` and the winner's resume to the unbroken
   fleet's row, bit for bit) and the splitting estimate at
   svc1000-chaosfleet (3 levels of 8 protected members, err_peak past
   ``max(2 x worst, 0.2)``), with its compressed twin (1,024 requests)
   on the card and the CPU, whose documents must be equal;
6. the CLI as a subprocess: ``simulate`` once on the card; ``check`` on
   ``canonical.yaml`` and ``simulate --qps max`` (50,000 requests each),
   on the card and with ``--device cpu``: both ``check`` runs must give
   the same exit code and alarm lines (values within rtol 1e-4), both
   ``simulate`` runs a Fortio document; ``simulate --environment ISTIO``
   on ``two-cluster-canonical.yaml``, on the card and with ``--device
   cpu``, whose draw-independent values (label, requested load, count,
   return codes) must agree; ``simulate --lb-out`` on the lb topology
   (written to a temporary YAML), on the card and with ``--device cpu``,
   whose draw-independent values and lb documents must agree, and
   ``simulate --qps max`` on it, which must exit non-zero; in this
   process on one draw source, on the card and with ``--device cpu``:
   ``simulate --timeline --timeline-perfetto``, ``--policies
   --rollouts``, ``--attribution tail --blame-out --flamegraph
   --perfetto-blame --exemplar-trace``, ``--trace`` in both formats and
   the ``timeline`` command with ``--controlplane 100:10:500 --alarms``,
   whose documents, exit codes and alarm onsets must agree; and
   ``simulate --ensemble 8 --ensemble-jitter qps=0.1,cpu=0.05,error=0.2
   --ensemble-slo 250ms --ensemble-out`` and ``--policies --rollouts
   --ensemble 4 --ensemble-chaos-jitter ...`` the same way (the card
   folds the plain fleet, the CPU runs it member by member), whose
   Fortio and ensemble documents must agree; and ``search`` (16
   candidates, ``--json``) and ``simulate --ensemble 8
   --ensemble-chaos-jitter ... --ensemble-split ... --split-horizon
   0.5`` the same way, whose search documents (but for their mode) and
   ensemble documents with their splitting blocks must agree;
7. oracle: build the DES oracle (``isotope_tpu_torch/native/
   des_oracle.cpp``) with ``g++`` and hold the engine on the card to
   it: the six exact interpreter-parity cases of the reference's
   ``tests/test_oracle.py`` (deterministic service times, 32 quiet
   requests: client latency within rtol 1e-5, errors and hop events
   equal), the six open-loop fidelity cases (chain3, tree13, star9 at
   rho 0.3 and 0.7: 200,000 requests on the card, 1,000,000 in the
   oracle, warm-up 0.5 s; p50 and p99 within 5%) and the paced closed
   case (chain3, 64 connections at half capacity, 128,000 / 512,000:
   p50 and p99 within 5%, throughput within 2%); then the reference's
   remaining gates (``oracle_gates``), at its sizes and bands: saturated
   throughput, fidelity per topology (star9's asymmetric band),
   probabilistic chain, mixed replicas, chaos phases, heavy tails and
   fork-join throughput, the retry-storm collapse with its
   feedback-blind twin, the error-rate and call-probability fractions
   and the open high-rho envelope; each relative error is printed.

8. the experiment runner, through the port's entry points in this
   process (``cli.main``, the default device ``cuda``): ``suite
   configs/latency.toml configs/cpu_mem.toml`` at the configs' own sizes
   (30 + 12 cases, 240,000 requests a latency case) into a temporary
   publish root: no case failed or degraded, each case's Fortio JSON,
   ``.prom`` and flat row written, 30 + 12 CSV rows, and exit code 1
   exactly when the manifest counts alarms; the same suite again (the
   resume: no Simulator built, no census launch, every CSV byte for
   byte) and with ``--fresh`` (every CSV equal but for the wall-clock
   StartTime column); a ``sweep`` of a reduced twin (latency.toml's
   ``baseline`` and ``both`` x 2 and 64 connections, 24,000 requests)
   on the card and with ``--device cpu`` on one draw source, rows within
   phase 4's tolerances with labels, columns and checkpoint keys equal;
   the supervisor: ``ISOTOPE_FAULT_INJECT=oom:engine.run:1`` on that
   twin (``python -m isotope_tpu_torch sweep``) serves one case from the
   ``half-block`` rung, reported ``DEGRADED``, and a ``nan:segment:0``
   case is recorded FAILED while the sweep goes on.  It prints the
   suite's wall, the wall per case (median, max), the sum of the cases'
   ``run_summary`` walls, the runner's host share, the census launches
   and the peak device memory.

9. the calibration path, through the port's entry points in this process
   (``cli.main``): ``fidelity canonical.yaml --fortio
   tests/data/fortio_canonical_sample.json --json`` on the card (the
   vendored artifact: closed loop, 16 connections, 1000 qps, 262,143
   requests in blocks of 65,536) must exit 0 as a user runs it (its own
   draws on the card: the timed run whose launches count), the card and
   ``--device cpu`` on one CPU draw source must give the same
   percentiles within phase 4's tolerances, and the artifact with every
   percentile x 1.2 must exit 1 on the card; then the ingest closure at
   a user's size:
   ``1000-svc_2000-end.yaml`` open loop at 10,000 qps, 8 x 32,768,
   recorded on the card by ``run_timeline`` with 1 s windows and a
   ``MetricsCollector``, its two expositions fitted by ``ingest``
   (host), the fit held to its source by ``closure_check`` (no service
   or edge dropped, the degree sequence equal, the verdict PASS: the JAX
   package's own closure passes on this source), and a 16,384-request
   twin on the card and the CPU on one CPU draw source whose fitted
   documents agree within rtol 1e-5 (YAML and TOML line by line up to
   float formatting); last, a ``sweep`` of the fitted TOML on the card
   into the fit's directory (no case failed or degraded; its census
   calls among those phase 3 checked) and ``explain`` on that directory
   and on the ``.ingest.json``, which must render the ingest section
   with the closure's verdict.  It prints the fidelity run's wall,
   launches and relative errors, the recorded run's wall and the host
   seconds of the one ``ingest`` call, each closure check, and the fitted
   sweep's wall and launches.

10. ``vet`` on the card (``vet_phase``): ``vet_simulator`` of phase 5's
   own Simulators of flagship, ``1000-svc_2000-end``, star-10k-timeouts,
   svc100k-chaos, lb-10svc-100r-panic and policies-1000svc-kill at
   their blocks, with the card's own capacity: the topology lint, one
   pilot block of 8 requests recorded op by op (``analysis/oplog.py``)
   and audited, the cost model; each beside a CPU twin of the same
   compiled graph vetted at the card's capacity (findings, estimate,
   flops, critical path and census calls equal), with its wall split
   into lint, pilot and cost model; ``vet --grad`` of the flagship and
   ``canonical-errors.yaml``, whose ``isotope-gradaudit/v1`` documents
   must equal the CPU's; the pilots' census launches (path ``vet``,
   each at a shape phase 3 holds).  Then ``run_experiment(vet="on")``
   of each of the six (one of phase 5's blocks; four of the protected
   run's) after ``torch.cuda.reset_peak_memory_stats()``, over the
   Simulators phase 5 built, beside the same case un-vetted: the
   gate's estimate, the measured ``max_memory_allocated``, the
   ``vet_peak_bytes_measured_ratio`` gauge and the case's own peak
   (less what was resident at the reset) against the estimate, a vet
   miss where the estimate lies below that peak over
   ``CAPACITY_FILL``; the summaries must be equal; the flagship with
   ``ISOTOPE_VET_DEVICE_BYTES`` between one and two budgets must get
   VET-M002 and be served on ``half-block``, recorded degraded, and
   with 65,536 bytes VET-M001 must block it before a block runs (path
   ``vet-gate``: the vetted runs' launches).  Last the policy and lb
   fault sites: the smoke topology's protected run under
   ``stuck:policies.stuck_breaker`` block by block against its CPU
   twin under the card's control effects (as phase 4), and
   lb-10svc-100r-panic under ``degrade:lb.degraded_backend:0`` card
   against CPU (as phase 4) beside its clean run.  Then the user's vet
   entry points in this process (``cli.main``; path ``vet-cli``):
   ``vet canonical.yaml --grad --json`` with the card's capacity beside
   its ``--device cpu`` twin at that capacity (the documents equal but
   for their timings; its ``mesh_layout`` block the layout search's
   ``data=1,svc=1`` with its cost rows), ``simulate canonical.yaml --vet`` (open 1,000
   qps for 2 s), its document equal to the un-vetted run's, and the
   same under ``ISOTOPE_VET_DEVICE_BYTES=65536``, which must exit 1
   with ``error: vet found`` (VET-M001) before a block runs.

11. the device mesh (``mesh_phase``, ``isotope_tpu_torch/parallel/``) on
   the reference dryrun's topology at its full width
   (``tree_topology(num_branches=4, num_services=1024)``, 1,024 hops,
   open loop at 500 qps, blocks of 32,768 requests): a world of one
   over NCCL (``build_mesh(MeshSpec(1, 1), device="cuda")``) runs 2
   blocks of ``run``, ``run`` with ``overlap=True``, ``run_attributed``
   (``tail``) and ``run_timeline``, each bit-equal to its ``*_emulated``
   twin over ``EmulatedMesh(MeshSpec(1, 1))`` on the card (the overlapped
   run within the reference's ``test_overlap_equivalence`` bounds of the
   plain one), each wall per block printed beside a solo
   ``run_summary`` of the same topology and block (path ``mesh``: their
   census launches, counted exactly, the tail pilot's included); the
   emulated twin of ``MeshSpec(data=2, svc=2, slices=2)``, 8 shards x 2
   blocks x 32,768 requests on the card (path ``mesh-emulated``): count,
   ``hop_events = count x hops``, each service's duration histogram
   summing to its incoming total, its peak memory within 1.1x of the
   one-shard run's, and the same twin at 8 shards x 1 block x 2,048
   requests card against CPU (phase 4's tolerances); the degradation
   ladder under ``oom:sharded.gather:2`` on the world-of-one mesh, which
   must end on ``single-device`` within one float32 spacing of the clean
   run; ``--mesh auto`` through ``run_experiment`` (path ``mesh auto``:
   2 blocks of the tree), which must resolve to ``data=1,svc=1`` in the
   world of one and equal the explicit ``1x1`` run (documents but
   StartTime, census launches exactly); and ``simulate --mesh 2x1`` in
   this process, which must exit 1 with the reference's ``needs 2
   devices, have 1`` before a block runs.
   Phase 3 holds the census at the phase's shapes (its blocks, the
   half-block rung's 16,384, the tail pilot's 8,192, the CPU twin's
   2,048; ``mesh_census_runs``, ``mesh_extra_shapes``).  Then the
   mesh-served runs (``mesh_served_runs``), each its own path (census
   launches set to 0 just before, read just after): ensembleN (32 x
   8,192) and ensembleN-observed (8 x 8,192, blame and recorder) over
   the world of one, each bit-equal to its twin over
   ``EmulatedMesh(MeshSpec(1, 1))`` and timed beside the solo folded
   fleet, and over the emulated ``MeshSpec(2, 2, 2)`` twin (4 and 1
   members a shard), held to the world of one's fleet within the folded
   fleets' tolerances; search64 over the 2x2x2 twin (rungs of 8 / 2 / 1
   members a shard); ``run_policies`` on policies-1000svc-kill and
   ``run_rollouts`` on rollouts-multitier-1000-bad, 3 windows deep, over
   the world of one (bit-equal to its twin, timed beside the solo run a
   block) and the emulated ``MeshSpec(4, 1, 2)`` twin (blocks of
   ``protected_window_block(..., shards=8)``), whose own peak must stay
   within 1.1x of one shard's (the 1x1 twin at the same block: the
   ladder's ``single-device`` rung fits where a shard fits); svc1000-chaosfleet's
   protected fleet and its splitting estimate over the world of one
   (equal to the solo fleet and the solo estimate).  Each twin is held
   to its CPU twin at a small size within phase 4's tolerances
   (``mesh_served_cpu``; the policy twin on policies-smoke's topology),
   and phase 3 holds the census at the twins'
   shapes (``mesh_served_census_runs``).

It then prints the kernel table as one JSON line and, last, the result
line ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
with code 1 and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import pathlib
import re
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Callable, NamedTuple

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
TOPOLOGIES = ROOT / "examples" / "topologies"

# H100 SXM data sheet: HBM3 rate and the float32 rate outside the tensor
# cores (the census kernel does plain f32 arithmetic)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

KERNEL_RTOL = 1e-5
RESULT_RTOL, RESULT_ATOL = 1e-5, 1e-9
# saturated closed loop: the finite-population law's quantile map
# v = -log1p(-u') magnifies one-ULP differences of its normals in the
# far tail (tests/test_torch_closed.py)
SAT_RTOL, SAT_ATOL = 1e-4, 1e-5
# star-10k: the root's busy time is a float32 sum over 5,021 steps,
# left to right in the kernel and vectorized in the CPU's plain version;
# the two roundings drift apart by ~sqrt(5021) * 6e-8 = 4e-6 typically,
# 2.0e-5 at most over 3,355 requests as measured on an H100
STAR_RTOL = 1e-4
# check alarm values, card against CPU (utilization x replicas)
CHECK_RTOL = 1e-4
# requests of the check and -qps max CLI runs (phase 6)
CLI_REQUESTS = 50_000

# the retry/timeout/error topology of tests/test_census_pallas.py
CENSUS_YAML = """
services:
- name: entry
  isEntrypoint: true
  errorRate: 2%
  script:
  - call: {service: mid, timeout: 30ms, retries: 2}
  - sleep: 1ms
- name: mid
  errorRate: 5%
  script:
  - - call: {service: leaf, timeout: 10ms, retries: 1}
    - call: {service: leaf2, probability: 60}
- name: leaf
  errorRate: 3%
- name: leaf2
  script:
  - call: deep
- name: deep
"""

FIXTURE_SHAPES = (
    [((13, 37, 5), f, e) for f in (False, True) for e in (False, True)]
    + [((4096, 512, 64), True, True)]
    # a step axis far past any tile the kernel stages whole
    + [((64, 3, 4096), True, True)]
)

# configurations whose census calls phase 3 checks and times but that
# phase 5 does not run, at their default blocks
CENSUS_ONLY_TOPOLOGIES = ("realistic-star-50", "realistic-star-auxiliary-50")

# the closed-loop rate pilot's block (``Simulator.solve_closed_rate``)
PILOT_N = 2048
# the saturated tables' fork-join pilots (``Simulator._sat_pilot``)
SAT_PILOT_N = 32_768
# BASELINE configs[3]: the 10k realistic star graph with 30 s timeouts
STAR10K_QPS = 6500.0
# BASELINE configs[4], the reference's svc100k_chaos case: the 100k
# multitier graph at 100 qps, mock-7 down in [5 s, 15 s)
SVC100K_QPS = 100.0
SVC100K_BLOCKS = 4
# the storm: canonical-2-replicas.yaml at 10k qps, 2 blocks of 262,144
STORM_QPS = 10_000.0
STORM_BLOCK = 262_144
# in situ, the storm's kill phase overloads b (15,750 visits/s against
# one replica's 13,000/s): the wait law clamps rho at 0.9999, its rate
# is 1.3/s, and a wait -log(u / p) / 1.3 near u = p moves by 9e-8 s per
# float32 spacing of u (one ULP of erfc or log, which the card and the
# CPU round differently); floats are held to four such spacings there
STORM_ATOL = 4.0 * 2.0**-23 / 1.3

# lb-10svc-100r-panic: 10-svc_1000-end.yaml (100 replicas a service)
# under Istio's default balancer (least_request, d = 2) with Envoy's
# default healthy-panic threshold, a skewed ring and a weighted round
# robin; 60 of svc-0-2's 100 replicas are killed in [2 s, 6 s), which
# leaves 40% healthy, below the threshold, so 60% of its hops there
# fast-fail
LB_PANIC_POLICIES = {
    "defaults": {"lb": {"policy": "least_request", "choices_d": 2,
                        "panic_threshold": "50%"}},
    "svc-0-0": {"lb": {"policy": "ring_hash", "hash_skew": 1.2}},
    "svc-0-1": {"lb": {"policy": "wrr", "weights": [3, 1, 1, 1]}},
}
LB_PANIC_QPS = 30_000.0
LB_PANIC_S = 8.0
LB_KILL = dict(service="svc-0-2", start_s=2.0, end_s=6.0, replicas_down=60)
LB_PANIC_SHARE, LB_PANIC_BAND = 0.6, 0.01
# lb-1000svc-lr: 1000-svc_2000-end.yaml under least_request at the
# 1000-svc run's load
LB_LR_POLICIES = {"defaults": {"lb": "least_request"}}

# the protected runs (phases 3-6).  policies-1000svc-kill:
# 1000-svc_2000-end.yaml with Envoy's default route timeout (15 s) and
# Istio's default two retries on every call (the attempts unroll into a
# tree of 66,196 hops, so its memory-sized block is 506 requests), the
# reference bench's svc1000_chaosfleet retry
# budget (25%) on the defaults, plus a breaker at the pending cap of
# Istio's circuit-breaking task (http1MaxPendingRequests: 1) and an HPA
# at the Kubernetes defaults (15 s sync period, scale-down
# stabilization) between 2 and 4 replicas; one of the two replicas of
# the mid-tier svc-0-2-3 down for the middle third of a 30 s run
PROTECTED_POLICIES = {"defaults": {
    "retry_budget": {"budget_percent": "25%"},
    "breaker": {"max_pending": 1},
    "autoscaler": {"min_replicas": 2, "max_replicas": 4,
                   "target_utilization": "60%", "sync_period": "15s",
                   "stabilization_window": "300s"},
}}
POLICY_TIMEOUT, POLICY_RETRIES = "15s", 2
POLICY_KILL = dict(service="svc-0-2-3", start_s=10.0, end_s=20.0,
                   replicas_down=1)
PROTECTED_QPS = 10_000.0
PROTECTED_S = 30.0
PROTECTED_WINDOW_S = 1.0
# phase 4 holds policies-1000svc-kill through a compressed twin: its 593
# blocks of 506 x 66,196 hops would take most of an hour on the card
# machine's CPU, so the twin runs 6 blocks (0.3 s) with the kill from
# 0 s to 0.15 s and 10 ms windows (the breaker trips, sheds and
# recovers inside it); the other protected runs are held whole
POLICY_TWIN_S, POLICY_TWIN_KILL_S, POLICY_TWIN_WINDOW_S = 0.3, 0.15, 0.01
# the phase-4 runs whose breaker must trip, shed at admission and
# recover (checked from the policy series and the blocks' error flags)
SHED_CHECKED = ("policies-1000svc-kill", "policies-smoke")
# rollouts-multitier-1000: the reference bench's rollout50 schedule on
# services[1] of the 1000-service multitier graph, composed with the
# svc1000_chaosfleet retry budget; the bad canary 500s a fifth of its
# hops
ROLLOUT = {"steps": ["5%", "25%", "100%"], "bake": "2s",
           "gates": {"min_samples": 50}}
ROLLOUT_POLICIES = {"defaults": {"retry_budget": {"budget_percent": "25%"}}}
BAD_CANARY = {"error_rate": "20%"}
# policies-smoke: the reference's acceptance scenario
# (tools/policies_smoke.py) at its own size, protected and not
SMOKE_TOPOLOGY = """
services:
- name: entry
  isEntrypoint: true
  numReplicas: 4
  script:
  - call: {service: worker, timeout: 850us, retries: 2}
- name: worker
  numReplicas: 4
policies:
  worker:
    breaker: {max_pending: 6, max_connections: 48}
    retry_budget: {budget_percent: 20%, min_retries_concurrent: 2}
    autoscaler:
      min_replicas: 4
      max_replicas: 12
      target_utilization: 50%
      sync_period: 1s
      stabilization_window: 10s
      scale_up_step: 2
"""
SMOKE_KILL = dict(service="worker", start_s=3.0, end_s=8.0, replicas_down=3)
SMOKE_QPS = 0.325 * 4 * 13_000.0
SMOKE_N, SMOKE_BLOCK = 270_000, 8192
# in situ, the policy series that are continuous functions of the
# recorder's float32 occupancy integrals (the breaker's shed) or of its
# window counts (the budget's retry allow) are held to this relative
# tolerance, card against CPU; the others are counts, states and steps
SHED_RTOL = 1e-3
# in situ, a window-binned count: a hop that starts (or a request that
# ends) within float32 spacings of a window boundary lands on either
# side, card against CPU (~0.01 such events a window at these loads),
# so each (service, window) count is held to WINDOW_COUNT_ATOL events
# and every total over the windows exactly
WINDOW_COUNT_ATOL = 2

# the reference's oracle fixtures (tests/test_oracle.py)
CHAIN3 = """
services:
- name: a
  isEntrypoint: true
  script: [{call: b}]
- name: b
  script: [{call: c}]
- name: c
"""
TREE13 = """
services:
- name: entry
  isEntrypoint: true
  script:
  - [{call: c0}, {call: c1}, {call: c2}]
""" + "".join(
    f"- name: c{i}\n  script: [[{{call: l{i}0}}, {{call: l{i}1}}, "
    f"{{call: l{i}2}}]]\n" for i in range(3)
) + "".join(f"- name: l{i}{j}\n" for i in range(3) for j in range(3))
STAR9 = """
services:
- name: entry
  isEntrypoint: true
  script:
  - [{call: s0}, {call: s1}, {call: s2}, {call: s3},
     {call: s4}, {call: s5}, {call: s6}, {call: s7}]
""" + "".join(f"- name: s{i}\n" for i in range(8))
PARITY = {
    "sequential-sleeps-and-calls": """
services:
- name: entry
  isEntrypoint: true
  script:
  - sleep: 10ms
  - call: leaf
  - sleep: 5ms
- name: leaf
""",
    "concurrent-join-with-sleep": """
services:
- name: entry
  isEntrypoint: true
  script:
  - [{sleep: 30ms}, {call: fast}, {call: slow}]
- name: fast
- name: slow
  script: [{sleep: 50ms}]
""",
    "error-rate-fast-500-skips-script": """
services:
- name: entry
  isEntrypoint: true
  script: [{call: flaky}]
- name: flaky
  errorRate: 100%
  script: [{sleep: 80ms}]
""",
    "retries-exhausted-by-500s": """
services:
- name: entry
  isEntrypoint: true
  script:
  - call: {service: flaky, retries: 2}
- name: flaky
  errorRate: 100%
""",
    "timeout-is-transport-and-truncates": """
services:
- name: entry
  isEntrypoint: true
  script:
  - call: {service: slow, timeout: 10ms}
  - sleep: 40ms
- name: slow
  script: [{sleep: 60ms}]
""",
    # b down for the whole run
    "chaos-total-outage": CHAIN3,
}
PARITY_RTOL = 1e-5
FIDELITY_BAND = 0.05   # p50 and p99, engine against oracle
THROUGHPUT_BAND = 0.02  # the paced closed loop's solved rate
ORACLE_WARMUP_S = 0.5

# the reference's remaining fidelity gates (tests/test_oracle.py), at its
# own sizes and bands: each gate is (name, engine run, oracle run,
# check), the check returning its line and raising out of band
SAT_RETRY_STORM = """
services:
- name: entry
  isEntrypoint: true
  numReplicas: 4
  script:
  - call: {service: worker, timeout: 850us, retries: 2}
- name: worker
  numReplicas: 4
"""
PROB_CHAIN = """
services:
- name: a
  isEntrypoint: true
  script: [{call: b}]
- name: b
  script:
  - call: {service: c, probability: 50}
- name: c
"""
MIXED_REPLICAS = """
services:
- name: a
  isEntrypoint: true
  numReplicas: 2
  script: [{call: b}]
- name: b
  numReplicas: 1
  script: [{call: c}]
- name: c
  numReplicas: 2
"""
CHAIN3_2R = MIXED_REPLICAS.replace("numReplicas: 1", "numReplicas: 2")
ERROR_RATES = """
services:
- name: entry
  isEntrypoint: true
  errorRate: 10%
  script: [{call: leaf}]
- name: leaf
  errorRate: 50%
"""
CALL_PROBABILITY = """
services:
- name: entry
  isEntrypoint: true
  script:
  - call: {service: maybe, probability: 50}
- name: maybe
  script: [{sleep: 20ms}]
"""


class Gate(NamedTuple):
    """One fidelity gate: ``engine(port, device)`` and ``oracle(port)``
    return what ``check(engine result, oracle result)`` compares; the
    check returns the gate's line and raises out of band."""

    name: str
    engine: Callable
    oracle: Callable
    check: Callable


def _engine_run(text, load, n, params=None, chaos=(), seed=0,
                feedback=True):
    """An engine run as the reference's gates make it, on the host:
    (start, latency float64, error, offered rate, unstable)."""
    def run(port, device):
        p = params(port) if callable(params) else port.SimParams()
        sim = port.Simulator(
            port.compile_graph(port.ServiceGraph.from_yaml(text)), p,
            tuple(port.ChaosEvent(**c) for c in chaos), device=device,
        )
        if not feedback:
            sim._feedback = None
        res = sim.run(load(port), n, port.TorchDraws(seed, device))
        return SimpleNamespace(
            start=res.client_start.double().cpu().numpy(),
            latency=res.client_latency.double().cpu().numpy(),
            error=res.client_error.cpu().numpy(),
            offered=float(res.offered_qps),
            unstable=res.unstable.cpu().numpy(),
            has_feedback=sim._feedback is not None,
        )
    return run


def _oracle_run(text, load, n, params=None, chaos=(), seed=0):
    def run(port):
        p = params(port) if callable(params) else port.SimParams()
        from isotope_tpu_torch.sim.oracle import OracleSimulator

        return OracleSimulator(
            port.ServiceGraph.from_yaml(text), p,
            tuple(port.ChaosEvent(**c) for c in chaos),
        ).run(load(port), n, seed)
    return run


def _band(rel, tol):
    lo, hi = tol if isinstance(tol, tuple) else (-tol, tol)
    return lo <= rel <= hi, f"[{lo:+.0%}, {hi:+.0%}]"


def _throughput(e, o):
    return e.offered / (len(o.client_latency) / float(o.client_end.max())) \
        - 1.0


def _quantile_check(name, tol_p50, tol_p99, warmup=ORACLE_WARMUP_S,
                    thr_band=None, mean_band=None):
    def check(e, o):
        lat_o = o.client_latency[o.client_start >= warmup]
        parts, ok = [], True
        for q, tol in ((0.5, tol_p50), (0.99, tol_p99)):
            if tol is None:
                continue
            rel = np.quantile(e.latency, q) / np.quantile(lat_o, q) - 1.0
            good, band = _band(rel, tol)
            ok &= good
            parts.append(f"p{int(q * 100)} {rel:+.4%} in {band}")
        if mean_band is not None:
            rel = e.latency.mean() / o.client_latency.mean() - 1.0
            good, band = _band(rel, mean_band)
            ok &= good
            parts.append(f"mean {rel:+.4%} in {band}")
        if thr_band is not None:
            rel = _throughput(e, o)
            good, band = _band(rel, thr_band)
            ok &= good
            parts.append(f"throughput {rel:+.4%} in {band}")
        line = f"oracle gate {name}: " + ", ".join(parts)
        if not ok:
            raise AssertionError(line)
        return line
    return check


def _window_check(name, windows, qs):
    """Quantile bands per arrival window (engine start, oracle start)."""
    def check(e, o):
        parts, ok = [], True
        for lo, hi, tag, tols in windows:
            m_e = (e.start >= lo) & (e.start <= hi)
            m_o = (o.client_start >= lo) & (o.client_start <= hi)
            for q, tol in zip(qs, tols):
                rel = (np.quantile(e.latency[m_e], q)
                       / np.quantile(o.client_latency[m_o], q) - 1.0)
                good, band = _band(rel, tol)
                ok &= good
                parts.append(f"{tag} p{int(q * 100)} {rel:+.4%} in {band}")
        line = f"oracle gate {name}: " + ", ".join(parts)
        if not ok:
            raise AssertionError(line)
        return line
    return check


def oracle_gates():
    """The gates of ``tests/test_oracle.py`` not in the parity and
    open-loop cases, at its sizes (engine / oracle requests) and bands:
    saturated (``-qps max``, 64 connections) throughput, fidelity per
    topology (star9's asymmetric band, ``ORACLE.md:35``), probabilistic
    chain, mixed replicas, chaos phases, heavy tails and fork-join
    throughput; the retry-storm collapse with its feedback-blind twin;
    the error-rate and call-probability fractions; the open high-rho
    envelope."""
    def sat(port):
        return port.LoadModel(kind="closed", qps=None, connections=64)

    def open_at(rho):
        return lambda port: port.LoadModel(
            kind="open", qps=rho / port.SimParams().cpu_time_s)

    def quiet(port):
        return port.LoadModel(kind="open", qps=0.001, duration_s=1.0)

    def det(port):
        return port.SimParams(service_time="deterministic")

    gates = []

    def add(name, text, load, n_e, n_o, check, params=None, chaos=(),
            seed_e=0, seed_o=0):
        gates.append(Gate(
            name, _engine_run(text, load, n_e, params, chaos, seed_e),
            _oracle_run(text, load, n_o, params, chaos, seed_o), check,
        ))

    add("saturated throughput chain3", CHAIN3, sat, 128_000, 512_000,
        _quantile_check("saturated throughput chain3", None, None,
                        thr_band=0.02, mean_band=0.05))
    for name, text, t50, t99 in (
        ("chain3", CHAIN3, 0.03, 0.05),
        ("tree13", TREE13, 0.09, 0.04),
        ("star9", STAR9, (-0.23, 0.03), (-0.16, 0.03)),
    ):
        add(f"saturated fidelity {name}", text, sat, 128_000, 512_000,
            _quantile_check(f"saturated fidelity {name}", t50, t99))
    add("saturated probabilistic chain", PROB_CHAIN, sat, 128_000, 512_000,
        _quantile_check("saturated probabilistic chain", 0.03, 0.08,
                        thr_band=0.02))
    add("saturated mixed replicas", MIXED_REPLICAS, sat, 64_000, 256_000,
        _quantile_check("saturated mixed replicas", 0.03, 0.04,
                        thr_band=0.02))
    add("saturated chaos phases", CHAIN3_2R, sat, 128_000, 256_000,
        _window_check("saturated chaos phases", [
            (0.2, 1.0, "pre", (0.03, 0.05)),
            (1.15, 3.0, "chaos", (0.03, 0.05)),
            (3.3, 1e9, "post", (0.03, 0.05)),
        ], (0.5, 0.99)),
        chaos=(dict(service="b", start_s=1.0, end_s=3.0, replicas_down=1),),
        seed_e=9)
    for kind, param, t50, t99 in (("lognormal", 1.0, 0.05, 0.08),
                                  ("pareto", 2.5, 0.06, 0.08),
                                  ("deterministic", 1.0, 0.03, 0.05)):
        add(f"saturated heavy tail {kind}", CHAIN3, sat, 64_000, 256_000,
            _quantile_check(f"saturated heavy tail {kind}", t50, t99),
            params=lambda port, kind=kind, param=param: port.SimParams(
                service_time=kind, service_time_param=param))
    for name, text in (("tree13", TREE13), ("star9", STAR9)):
        add(f"saturated fork-join throughput {name}", text, sat, 64_000,
            256_000, _quantile_check(
                f"saturated fork-join throughput {name}", None, None,
                thr_band=(-0.03, 0.08)))
    add("error-rate fidelity", ERROR_RATES, open_at(0.3), 100_000, 200_000,
        _fraction_check("error-rate fidelity", lambda lat, err: err, 0.10,
                        0.01))
    add("call-probability fidelity", CALL_PROBABILITY, quiet, 4000, 4000,
        _fraction_check("call-probability fidelity",
                        lambda lat, err: lat > 0.02, 0.5, 0.03),
        params=det)
    for name, text, rho, t50, t99 in (
        ("chain3", CHAIN3, 0.85, 0.03, 0.03),
        ("chain3", CHAIN3, 0.90, 0.03, 0.03),
        ("tree13", TREE13, 0.85, 0.04, 0.04),
        ("tree13", TREE13, 0.90, 0.05, 0.05),
    ):
        tag = f"open high-rho {name} rho {rho:g}"
        add(tag, text, open_at(rho), 300_000, 1_500_000,
            _quantile_check(tag, t50, t99, warmup=2.0))
    gates.append(retry_storm_gate())
    return gates


def _fraction_check(name, predicate, target, band):
    """Both the engine's and the oracle's share of requests meeting
    ``predicate(latency, error)`` within ``band`` of ``target``."""
    def check(e, o):
        f_e = float(np.mean(predicate(e.latency, e.error)))
        f_o = float(np.mean(predicate(o.client_latency, o.client_error)))
        line = (f"oracle gate {name}: engine {f_e:.4f}, oracle {f_o:.4f} "
                f"(target {target:g} +- {band:g})")
        if abs(f_e - target) > band or abs(f_o - target) > band:
            raise AssertionError(line)
        return line
    return check


def retry_storm_gate():
    """The retry-storm collapse: killing 2 of 4 workers pushes waits past
    the 850 us timeout; the feedback fixed point finds the storm branch
    and flags the worker unstable, and the latencies track the oracle
    before, in and after the kill; the feedback-blind twin misses it
    (chaos-window p50 under 0.6 of the oracle's, nothing flagged)."""
    def load(port):
        return port.LoadModel(kind="open",
                              qps=0.325 * 4 / port.SimParams().cpu_time_s)

    chaos = (dict(service="worker", start_s=2.0, end_s=15.0,
                  replicas_down=2),)
    storm = _engine_run(SAT_RETRY_STORM, load, 400_000, chaos=chaos)
    blind = _engine_run(SAT_RETRY_STORM, load, 400_000, chaos=chaos,
                        feedback=False)
    windows = _window_check("retry-storm collapse", [
        (0.5, 2.0, "pre", (0.03, 0.03)),
        (2.2, 15.0, "storm", (0.03, 0.03)),
        (16.0, 23.0, "post", (0.04, 0.04)),
    ], (0.5, 0.99))

    def engine(port, device):
        return storm(port, device), blind(port, device)

    def check(e, o):
        e, b = e
        line = windows(e, o)
        m_b = (b.start >= 2.2) & (b.start <= 15.0)
        m_o = (o.client_start >= 2.2) & (o.client_start <= 15.0)
        ratio = (np.quantile(b.latency[m_b], 0.5)
                 / np.quantile(o.client_latency[m_o], 0.5))
        line += (f"; worker unstable {bool(e.unstable[1])}; blind twin "
                 f"storm p50 {ratio:.4f} of the oracle's, unstable "
                 f"{bool(b.unstable.any())}")
        if not (e.has_feedback and e.unstable[1] and ratio < 0.6
                and not b.unstable.any()):
            raise AssertionError(line)
        return line

    return Gate("retry-storm collapse", engine,
                _oracle_run(SAT_RETRY_STORM, load, 600_000, chaos=chaos),
                check)


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return out


# -- phase 3: the kernel against its plain version -------------------------


def census_inputs(n, b, p, with_fail, with_err, seed=0):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    kw = dict(device="cuda", generator=g)
    base = torch.rand((b, p), **kw)
    mask = (torch.rand((b, p), **kw) > 0.3).float()
    agg = torch.rand((n, b, p), **kw) * 2.0
    fail = (
        torch.randint(0, p + 1, (n, b), dtype=torch.int32, **kw)
        if with_fail else None
    )
    err = torch.rand((n, b), **kw) > 0.7 if with_err else None
    return base, mask, agg, fail, err


def census_bound_ms(n, b, p, with_fail, with_err):
    """Least time for one census call: each input read once, each output
    written once, over the HBM rate (the ~4 f32 operations per element
    are far below the compute bound)."""
    nbytes = 4 * (n * b * p)          # agg
    nbytes += 2 * 4 * (b * p)         # base, mask
    nbytes += 4 * n * b if with_fail else 0
    nbytes += n * b if with_err else 0
    nbytes += 4 * n * b + 4 * n * b * p   # busy, excl
    ops = 4 * n * b * p
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3


def time_ms(fn, flush, reps=20):
    """Mean time of ``fn`` over ``reps`` calls, each after an L2 flush,
    with CUDA events around the call only: device time plus whatever
    host time the call's launches leave the device idle."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def device_ms(fn, flush, reps=20, attempts=5, kernel="census"):
    """Mean device-only time of the census kernel in ``fn``: the
    profiler's device time for kernels whose name holds ``kernel``, over
    ``reps`` calls, each after an L2 flush.  A profiled pass that
    records fewer than its ``reps`` launches (seen a few times in a run
    of a few hundred passes, in bursts) is repeated; after ``attempts``
    such passes the time is taken with CUDA events around each call
    instead, which adds the launch gap, and the line says so."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        kernels = [
            e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and kernel in e.key
        ]
        count = sum(e.count for e in kernels)
        total_us = sum(
            getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
            for e in kernels
        )
        if count == reps and total_us > 0:
            return total_us / count / 1e3
        log(f"profiled pass {attempt + 1} recorded {count} {kernel} "
            f"kernels with {total_us} us of device time, expected {reps}")
    ms = time_ms(fn, flush, reps)
    log(f"profiler recorded no full pass in {attempts}: {ms:.4f} ms "
        f"per call from CUDA events around each call")
    return ms


def host_us(fn, reps=300):
    """The wrapper's host cost per call: host clock over ``reps``
    enqueues, without waiting for the device, divided by the count."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t) / reps * 1e6
    torch.cuda.synchronize()
    return us


def census_calls(sim, block):
    """The census calls of one block of ``sim``: a Simulator carrying
    policy tables runs protected, its breaker sheds on the error path."""
    return sim.census_shapes(block, policy=sim._policies is not None)


def census_check_shapes(runs, census_only, extra=()):
    """Every census shape phase 3 checks, in order, without repeats: the
    main path's (with the closed loop's rate pilot), the census-only
    configurations', ``extra`` (shapes checked but not timed: phase
    10's) and the fixtures."""
    shapes = []
    for _, sim, load, _, block in runs:
        shapes += census_calls(sim, block)
        if load.kind == "closed":
            shapes += sim.census_shapes(
                SAT_PILOT_N if load.qps is None else PILOT_N
            )
    for _, sim, block in census_only:
        shapes += sim.census_shapes(block)
    shapes += list(extra)
    shapes += [(n, b, p, f, e) for (n, b, p), f, e in FIXTURE_SHAPES]
    return list(dict.fromkeys(shapes))


def kernel_phase(census_mod, runs, census_only, extra=()):
    """Check the kernel at every census shape of ``runs``,
    ``census_only`` and ``extra`` and at the fixtures; time it per call
    and per block of ``runs`` and ``census_only``.  Returns the largest
    error, the times per flagship block (the first run) and the device
    ms per block of each."""
    max_err = 0.0
    for n, b, p, with_fail, with_err in census_check_shapes(
        runs, census_only, extra
    ):
        args = census_inputs(n, b, p, with_fail, with_err)
        busy, excl = census_mod.census(*args)
        ref_busy, ref_excl = census_mod.census_reference(*args)
        seq_busy, seq_excl = census_mod.census_sequential(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(busy, ref_busy, rtol=KERNEL_RTOL, atol=0)
        torch.testing.assert_close(excl, ref_excl, rtol=KERNEL_RTOL, atol=0)
        if not (torch.equal(busy, seq_busy) and torch.equal(excl, seq_excl)):
            raise AssertionError(
                f"kernel {n}x{b}x{p}: differs from its sequential twin"
            )
        err = max(
            float((busy - ref_busy).abs().max()),
            float((excl - ref_excl).abs().max()),
        )
        max_err = max(max_err, err)
        log(f"kernel ok {n}x{b}x{p} fail={with_fail} err={with_err} "
            f"max_abs_err={err:.3e} (bit-equal to the sequential twin)")

    # time each configuration's census calls of one block, L2 flushed
    # before each launch
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    blocks = [(name, sim, block) for name, sim, _, _, block in runs]
    per_block = []
    for name, sim, block in blocks + list(census_only):
        ms = plain_ms = bound_ms = 0.0
        calls = dense_calls(sim, block)
        for shape in calls:
            args = census_inputs(*shape, seed=1)
            k = device_ms(lambda: census_mod.census(*args), flush)
            host = host_us(lambda: census_mod.census(*args))
            r = time_ms(lambda: census_mod.census_reference(*args), flush,
                        reps=5)
            bd = census_bound_ms(*shape)
            n, b, p, f, e = shape
            log(f"kernel time {n}x{b}x{p} fail={f} err={e}: device "
                f"{k:.4f} ms (profiler), bound {bd:.4f} ms (bytes), "
                f"{bd / k:.1%} of bound; plain {r:.4f} ms")
            log(f"kernel host {n}x{b}x{p}: {host:.1f} us per call "
                f"(wrapper, host clock over 300 enqueues)")
            ms += k
            plain_ms += r
            bound_ms += bd
        log(f"kernel time per {name} block "
            f"({len(calls)} calls): device {ms:.4f} ms,"
            f" bound {bound_ms:.4f} ms, {bound_ms / ms:.1%} of bound; "
            f"plain {plain_ms:.4f} ms")
        per_block.append((name, ms, plain_ms, bound_ms))
    _, ms, plain_ms, bound_ms = per_block[0]
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                ms_per_block={name: t for name, t, _, _ in per_block},
                bound_per_block={name: b for name, _, _, b in per_block})


def ragged_bound_ms(plan, n, with_fail, with_err):
    """Least time of one ragged census call: the calls' durations (and
    transport flags) and the error flags read once, busy (and the fail
    step) and the children's offsets written once, over the HBM rate."""
    nbytes = n * plan.num_calls * (4 + with_fail)
    nbytes += n * plan.size * (4 + 4 * with_fail + with_err)
    nbytes += 4 * n * plan.num_children
    return nbytes / HBM_BYTES_PER_S * 1e3


def ragged_inputs(plan, n, with_fail, with_err, seed=0):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    kw = dict(device="cuda", generator=g)
    dur = torch.rand((n, plan.num_calls), **kw) * 2.0
    transport = (torch.rand((n, plan.num_calls), **kw) < 0.05
                 if with_fail else None)
    err = torch.rand((n, plan.size), **kw) < 0.2 if with_err else None
    return dur, transport, err


def dense_calls(sim, block):
    """``census_calls`` without the levels on the ragged census, whose
    launches :func:`ragged_phase` times."""
    calls = census_calls(sim, block)
    for d, shape in level_calls(sim, block).items():
        if sim._levels[d].join.kind == "ragged":
            calls.remove(shape)
    return calls


def level_calls(sim, block):
    """The census call of each dense or ragged level, by level:
    ``census_calls`` without the tiles' calls."""
    calls = iter(census_calls(sim, block))
    out = {}
    for d in reversed(range(len(sim._levels))):
        join = sim._levels[d].join
        mine = [next(calls) for _ in join.census_calls(block, False, False)]
        if join.kind in ("dense", "ragged"):
            out[d] = mine[0]
    return out


def ragged_phase(census_mod, runs, census_only, timing):
    """Every level on the ragged census among ``runs`` and
    ``census_only``, at its block: the kernel against the dense site's
    chain on the card (``_slot_max``, ``_fail_min``, the sequential join,
    the children's gather) bit for bit, then its device time (L2 flushed
    before each launch) beside its bound, the dense chain's time with the
    census kernel as its join and the plain version's (CUDA events) and
    its wrapper's host cost.  Adds each configuration's device time and
    bound to :func:`kernel_phase`'s per block (``timing``)."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    seen = set()
    per_block = timing["ms_per_block"]
    bound_per_block = timing["bound_per_block"]
    for name, sim, block in ([(r[0], r[1], r[4]) for r in runs]
                             + list(census_only)):
        if (id(sim), block) in seen:
            continue
        seen.add((id(sim), block))
        shapes = level_calls(sim, block)
        for d, lvl in enumerate(sim._levels):
            if lvl.join.kind != "ragged":
                continue
            plan = lvl.join.plan
            n, _, _, with_fail, with_err = shapes[d]
            args = ragged_inputs(plan, n, with_fail, with_err)
            got = census_mod.census_ragged(plan, *args)
            want = census_mod.census_ragged_reference(
                plan, *args, join=census_mod.census_sequential)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                if (a is None) != (b is None) or (
                        a is not None and not torch.equal(a, b)):
                    raise AssertionError(
                        f"ragged {name} level {d}: differs from the dense "
                        f"chain")
            k = device_ms(lambda: census_mod.census_ragged(plan, *args),
                          flush)
            chain = time_ms(lambda: census_mod.census_ragged_reference(
                plan, *args, join=census_mod.census), flush, reps=5)
            plain = time_ms(lambda: census_mod.census_ragged_reference(
                plan, *args), flush, reps=5)
            host = host_us(lambda: census_mod.census_ragged(plan, *args))
            bd = ragged_bound_ms(plan, n, with_fail, with_err)
            per_block[name] = per_block.get(name, 0.0) + k
            bound_per_block[name] = bound_per_block.get(name, 0.0) + bd
            log(f"ragged ok {name} level {d}: {n} x {plan.size} x "
                f"{plan.pmax}, {plan.num_steps} real steps, "
                f"{plan.num_calls} calls, {plan.num_children} children, "
                f"fail={with_fail} err={with_err} (bit-equal to the dense "
                f"chain); device {k:.4f} ms (profiler), bound {bd:.4f} ms "
                f"(bytes), {bd / k:.1%} of bound; dense chain {chain:.4f} "
                f"ms, plain {plain:.4f} ms (events); host {host:.1f} us "
                f"per call")


# -- phase 3, the saturated waits: the wait kernel against its chain ----------

#: float operations a hop-row of the finite-population wait takes (erfc,
#: log1p, the Horner pass's multiply-adds, a divide, the copula)
SATWAIT_OPS = 80
#: multitier1k's block under -qps max (``multitier1k.qps-max-c10k``)
SATWAIT_CELL = (30_000, 1000, 11)


def satwait_bound_ms(n, h):
    """Least time of one wait call: ``z`` read once and the wait written
    once, 8 B a hop-row, over the HBM rate (the tables stay in L2, and
    the operations are far below the float32 rate)."""
    return max(8 * n * h / HBM_BYTES_PER_S,
               SATWAIT_OPS * n * h / F32_OPS_PER_S) * 1e3


def satwait_tables(n, h, d, seed=0, device="cuda"):
    """One row of tables shaped like the finite-population law's (zero-
    wait masses in [0.05, 0.6]; quantile polynomials fitted over ``v`` in
    [0, 16] to ``v / rate + a * log1p(v)``, an exponential tail of rate
    200 to 2,000 per second bent by at most 2 ms, as ``sim/closed.py``
    fits its waits' quantiles; a unit projection vector, its centre and
    variance scale) and ``(n, h)`` normals."""
    rng = np.random.default_rng(seed)
    v = np.linspace(0.0, 16.0, 200)
    w = (v[:, None] / rng.uniform(200.0, 2000.0, h)
         + rng.uniform(0.0, 2e-3, h) * np.log1p(v)[:, None])
    coef = np.polynomial.polynomial.polyfit(v, w, d - 1)[None]
    e = np.abs(rng.normal(0, 1, (1, h)))
    e /= np.sqrt((e**2).sum())
    c = np.full(1, 0.5)
    scale = 1.0 / np.sqrt(1.0 - (2 * c[0] - c[0] ** 2) * e**2)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32,
                               device=device)

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    z = torch.randn((n, h), device=device, generator=g)
    return z, None, tuple(t(x) for x in (
        rng.uniform(0.05, 0.6, (1, h)), coef, e, c, scale)), True


class SatwaitCalls:
    """The wait kernel's calls as the engine makes them, recorded while
    the context is open: the first call of each shape, with its rows,
    tables and copula, under ``label``."""

    def __init__(self):
        self.calls = {}
        self.label = ""

    def __enter__(self):
        from isotope_tpu_torch.sim import engine

        self._engine, self._real = engine, engine.saturated_wait
        engine.saturated_wait = self._record
        return self

    def __exit__(self, *exc):
        self._engine.saturated_wait = self._real

    def _record(self, z, rows, *tables, copula=True):
        key = (tuple(z.shape), rows is not None, copula,
               tuple(tables[1].shape))
        self.calls.setdefault(key, (self.label, rows, tables, copula))
        return self._real(z, rows, *tables, copula=copula)


def satwait_calls(port, runs, device="cuda"):
    """The wait calls of the main path's saturated runs (each block, as
    one block of the run makes it) and of the unphased ``-qps max`` run's
    fork-join pilots (its tables solved again on a fresh Simulator)."""
    rec = SatwaitCalls()
    with rec:
        for name, sim, load, n, block in runs:
            if not sim._saturated(load):
                continue
            rec.label = f"{name} block"
            sim.run_summary(load, block, port.TorchDraws(0, device),
                            block_size=block)
            if not sim.has_chaos:
                rec.label = f"{name} pilot"
                port.Simulator(sim.compiled, device=device).solve_closed_rate(
                    load, n, port.TorchDraws(0, device))
    torch.cuda.synchronize()
    return [(label, shape, rows, tables, copula)
            for (shape, *_), (label, rows, tables, copula)
            in rec.calls.items()]


def satwait_phase(satwait_mod, calls, device="cuda"):
    """The wait kernel at multitier1k's block (synthetic tables) and at
    each recorded call (the engine's own tables and rows, fresh normals):
    bit for bit against ``saturated_wait_sequential``, within the
    saturated runs' tolerance of the plain chain, then its device time
    (L2 flushed before each launch) beside its bound, the plain chain's
    time (CUDA events) and the wrapper's host cost.  Returns the numbers
    of the kernel table at multitier1k's block."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=device)
    cases = [("multitier1k block (synthetic tables)",
              *satwait_tables(*SATWAIT_CELL, device=device))]
    g = torch.Generator(device=device)
    g.manual_seed(7)
    for label, shape, rows, tables, copula in calls:
        cases.append((label, torch.randn(shape, device=device, generator=g),
                      rows, tables, copula))
    out = {}
    max_err = 0.0
    for label, z, rows, tables, copula in cases:
        got = satwait_mod.saturated_wait(z, rows, *tables, copula=copula)
        seq = satwait_mod.saturated_wait_sequential(z, rows, *tables, copula)
        ref = satwait_mod.saturated_wait_reference(z, rows, *tables, copula)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), seq.view(torch.int32)):
            raise AssertionError(
                f"satwait {label}: differs from its sequential twin")
        torch.testing.assert_close(got, ref, rtol=SAT_RTOL, atol=SAT_ATOL)
        err = float((got - ref).abs().max())
        max_err = max(max_err, err)
        k = device_ms(lambda: satwait_mod.saturated_wait(
            z, rows, *tables, copula=copula), flush, kernel="satwait")
        plain = time_ms(lambda: satwait_mod.saturated_wait_reference(
            z, rows, *tables, copula), flush, reps=5)
        host = host_us(lambda: satwait_mod.saturated_wait(
            z, rows, *tables, copula=copula))
        n, h = z.shape
        r, d = tables[1].shape[:2]
        bd = satwait_bound_ms(n, h)
        log(f"satwait ok {label}: {n} x {h}, D = {d}, {r} table rows"
            f"{', rows gathered' if rows is not None else ''}, copula "
            f"{copula}; max_abs_err {err:.3e} s against the plain chain "
            f"(bit-equal to the sequential twin); device {k:.4f} ms "
            f"(profiler), bound {bd:.4f} ms (bytes), {bd / k:.1%} of "
            f"bound; plain chain {plain:.4f} ms (events); host "
            f"{host:.1f} us per call")
        if not out:
            out = dict(ms=k, plain_ms=plain, bound_ms=bd)
    out["max_abs_err"] = max_err
    return out


# -- phase 4: in situ, card against CPU ---------------------------------------


def compare_results(got, want, what, rtol=RESULT_RTOL, atol=RESULT_ATOL):
    """Booleans exactly, float fields within ``rtol``/``atol``; returns
    the largest difference of the float fields as a share of its
    tolerance ``atol + rtol * |want|`` (at most 1)."""
    for name in ("hop_sent", "hop_error", "client_error", "unstable"):
        a = getattr(got, name).cpu()
        b = getattr(want, name).cpu()
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {name} differs")
    worst = 0.0
    for name in ("client_start", "client_latency", "hop_latency",
                 "hop_start", "utilization"):
        a = getattr(got, name).cpu().double()
        b = getattr(want, name).cpu().double()
        torch.testing.assert_close(
            a, b, rtol=rtol, atol=atol,
            msg=lambda m, name=name: f"{what} {name}: {m}",
        )
        worst = max(worst, float(((a - b).abs() / (
            atol + rtol * b.abs())).max()))
    return worst


def share_closed_tables(src, dst, connections):
    """Hand ``src``'s saturated tables (solved once) to ``dst``, on its
    device, so both runs sample the same finite-population law."""
    dst._closed_cache[connections] = tuple(
        x.to(dst.device) if isinstance(x, torch.Tensor) else x
        for x in src._closed_tables(connections)
    )


def in_situ_phase(port, cases):
    """``cases``: (name, make, load, requests, block, rtol, atol), where
    ``make(device)`` builds the case's Simulator on a device; ``block``
    None runs the requests as one block (``Simulator.run``), else each
    block of ``Simulator.run_blocks`` is compared."""
    for name, make, load, n, block, rtol, atol in cases:
        source = port.TorchDraws(11, "cuda")
        on_cpu_sim = make("cpu")
        card_sim = make("cuda")
        if load.kind == "closed" and load.qps is None:
            on_cpu_sim.solve_closed_rate(load, n, source)
            share_closed_tables(on_cpu_sim, card_sim, load.connections)
        before = port.census.launches
        if block is None:
            on_card = [card_sim.run(load, n, source)]
        else:
            on_card = list(card_sim.run_blocks(load, n, source,
                                               block_size=block))
        torch.cuda.synchronize()
        if port.census.launches == before:
            raise AssertionError(f"in situ {name}: kernel never launched")
        on_cpu = (
            [on_cpu_sim.run(load, n, source)] if block is None
            else on_cpu_sim.run_blocks(load, n, source, block_size=block)
        )
        worst = 0.0
        events = errors = 0
        for b, (got, want) in enumerate(zip(on_card, on_cpu)):
            worst = max(worst, compare_results(
                got, want, f"in situ {name} block {b}", rtol, atol))
            events += int(got.hop_events)
            errors += int(got.client_error.sum())
        log(f"in situ ok {name}: card (kernel) == cpu (plain), "
            f"{len(on_card)} block(s), {events} hop events, {errors} client "
            f"errors, largest difference {worst:.3f} of its tolerance "
            f"(rtol {rtol:g}, atol {atol:g} s)")


# -- phase 5: the main path at full size --------------------------------------


def star10k_graph(port):
    """BASELINE configs[3]: the 10,000-service realistic star graph with
    30 s call timeouts."""
    return port.ServiceGraph.decode(port.with_call_policy(
        port.realistic_topology(10_000, archetype="star", seed=0),
        timeout="30s",
    ))


def main_path_runs(port, flagship_graph, device="cuda", build_s=None):
    """The six runs of the main path: (name, simulator, load, requests,
    block size).  ``build_s`` collects the host seconds of the star-10k
    graph's generation, compilation and ``Simulator``."""
    flagship = port.Simulator(port.compile_graph(flagship_graph),
                              device=device)
    svc1000 = port.Simulator(
        port.compile_graph(port.ServiceGraph.from_yaml_file(
            TOPOLOGIES / "1000-svc_2000-end.yaml")),
        device=device,
    )
    canonical = port.Simulator(
        port.compile_graph(port.ServiceGraph.from_yaml_file(
            TOPOLOGIES / "canonical.yaml")),
        device=device,
    )
    conns = 64
    closed = port.LoadModel(kind="closed", qps=1000.0, connections=conns,
                            duration_s=240.0)
    closed_n = min(int(min(1000.0, canonical.capacity_qps()) * 240.0),
                   1_000_000)
    # run_summary's closed-loop block: a whole number per connection
    closed_block = (
        min(canonical.default_block_size(), closed_n) // conns * conns
    )
    powerlaw = port.Simulator(
        port.compile_graph(port.ServiceGraph.from_yaml_file(
            TOPOLOGIES / "realistic-powerlaw-100.yaml")),
        device=device,
    )
    powerlaw_block = powerlaw.default_block_size()
    t = time.perf_counter()
    star_graph = star10k_graph(port)
    t_graph = time.perf_counter()
    star_compiled = port.compile_graph(star_graph)
    t_compile = time.perf_counter()
    star = port.Simulator(star_compiled, device=device)
    t_sim = time.perf_counter()
    if build_s is not None:
        build_s.update(star10k_graph=t_graph - t,
                       star10k_compile=t_compile - t_graph,
                       star10k_simulator=t_sim - t_compile)
    star_block = star.default_block_size()
    # -qps max: its own Simulator, so its tables are built (and timed)
    # apart from the paced run's
    sat = port.Simulator(canonical.compiled, device=device)
    sat_load, sat_n, sat_block = qps_max_load(port, sat)
    return [
        ("flagship", flagship, port.LoadModel(kind="open", qps=1e5),
         4 * 262_144, 262_144),
        ("1000-svc_2000-end", svc1000, port.LoadModel(kind="open", qps=1e4),
         262_144, 32_768),
        ("canonical closed c=64", canonical, closed, closed_n, closed_block),
        ("realistic-powerlaw-100", powerlaw,
         port.LoadModel(kind="open", qps=powerlaw.capacity_qps() / 2),
         2 * powerlaw_block, powerlaw_block),
        ("star-10k-timeouts", star,
         port.LoadModel(kind="open", qps=STAR10K_QPS), 4 * star_block,
         star_block),
        ("canonical-qps-max", sat, sat_load, sat_n, sat_block),
    ]


def qps_max_load(port, sim, conns=64):
    """``-qps max`` at the CLI defaults (64 connections, 240 s) capped at
    1,000,000 requests: (load, requests, block)."""
    load = port.LoadModel(kind="closed", qps=None, connections=conns,
                          duration_s=240.0)
    n = min(int(sim.capacity_qps() * 240.0), 1_000_000)
    return load, n, min(sim.default_block_size(), n) // conns * conns


def scenario_runs(port, build_s, device="cuda"):
    """The three scenario runs of the main path: (name, simulator on
    ``device``, load, requests, block, make), ``make(device)`` building
    the same Simulator (compiled graph, parameters, schedules) on
    another device.  ``build_s`` collects the host seconds of the
    svc100k graph's generation, compilation and ``Simulator``."""
    t = time.perf_counter()
    graph = port.ServiceGraph.decode(
        port.realistic_topology(100_000, archetype="multitier", seed=0)
    )
    t_graph = time.perf_counter()
    svc100k = port.compile_graph(graph)
    t_compile = time.perf_counter()
    pareto = port.SimParams(service_time="pareto", service_time_param=2.5)
    outage = (port.ChaosEvent("mock-7", 5.0, 15.0, replicas_down=None),)

    def make_svc100k(device, attribution=False):
        params = dataclasses.replace(pareto, attribution=attribution)
        return port.Simulator(svc100k, params, outage, device=device)

    make_svc100k.graph = graph  # phase 10's topology lint

    big = make_svc100k(device)
    build_s.update(svc100k_graph=t_graph - t,
                   svc100k_compile=t_compile - t_graph,
                   svc100k_simulator=time.perf_counter() - t_compile)
    big_block = big.default_block_size()

    canon2 = port.compile_graph(port.ServiceGraph.from_yaml_file(
        TOPOLOGIES / "canonical-2-replicas.yaml"))
    istio = port.DEFAULT_ENVIRONMENTS["ISTIO"].apply(port.SimParams())
    storm = dict(
        chaos=(port.ChaosEvent("b", 10.0, 20.0, replicas_down=1,
                               drain=False),),
        # the reference's canary rotation (100/70/40/20) of c's traffic
        churn=(port.TrafficSplit("c", 30.0, (1.0, 0.7, 0.4, 0.2)),),
        mtls=port.MtlsSchedule(20.0, (0.0, 1e-3)),
    )

    def make_storm(device):
        return port.Simulator(canon2, istio, device=device, **storm)

    bounce = port.bounce_schedule("b", period_s=60.0, down_s=10.0, count=4,
                                  start_s=30.0, replicas_down=1)

    def make_bounce(device):
        return port.Simulator(canon2, chaos=bounce, device=device)

    sat = make_bounce(device)
    sat_load, sat_n, sat_block = qps_max_load(port, sat)
    return [
        ("svc100k-chaos", big, port.LoadModel(kind="open", qps=SVC100K_QPS),
         SVC100K_BLOCKS * big_block, big_block, make_svc100k),
        ("canonical-2r-storm", make_storm(device),
         port.LoadModel(kind="open", qps=STORM_QPS), 2 * STORM_BLOCK,
         STORM_BLOCK, make_storm),
        ("canonical-2r-qps-max-bounce", sat, sat_load, sat_n, sat_block,
         make_bounce),
    ]


def with_policies(port, path, policies):
    """The graph of ``path`` with a ``policies:`` block attached."""
    graph = port.ServiceGraph.from_yaml_file(path)
    graph.policies = dict(policies)
    return graph


def lb_runs(port, device="cuda"):
    """The two lb runs of the main path: (name, simulator on
    ``device``, load, requests, block, make), as :func:`scenario_runs`."""
    out = []
    for name, topo, policies, chaos, qps, n, block in (
        ("lb-10svc-100r-panic", "10-svc_1000-end.yaml", LB_PANIC_POLICIES,
         (port.ChaosEvent(**LB_KILL),), LB_PANIC_QPS,
         int(LB_PANIC_QPS * LB_PANIC_S), None),
        ("lb-1000svc-lr", "1000-svc_2000-end.yaml", LB_LR_POLICIES, (),
         1e4, 262_144, 32_768),
    ):
        graph = with_policies(port, TOPOLOGIES / topo, policies)
        compiled = port.compile_graph(graph)
        tables = port.compile_lb(graph, compiled)

        def make(device, compiled=compiled, chaos=chaos, tables=tables):
            return port.Simulator(compiled, chaos=chaos, lb=tables,
                                  device=device)

        make.graph = graph  # phase 10's topology lint
        sim = make(device)
        block = block or min(sim.default_block_size(), n)
        out.append((name, sim, port.LoadModel(kind="open", qps=qps), n,
                    block, make))
    return out


def panic_share(port, sim, load, n, block):
    """The share of ``svc-0-2``'s hops that fast-fail among those of
    requests arriving in the kill window, and outside it, over the
    panic run's blocks on the card (draws of the timed run)."""
    svc = list(sim.compiled.services.names).index(LB_KILL["service"])
    hops = torch.tensor(np.nonzero(sim.compiled.hop_service == svc)[0],
                        device=sim.device)
    counts = torch.zeros(4, dtype=torch.float64, device=sim.device)
    for res in sim.run_blocks(load, n, port.TorchDraws(0, sim.device),
                              block_size=block):
        t = res.client_start
        inside = ((t >= LB_KILL["start_s"]) & (t < LB_KILL["end_s"]))[:, None]
        sent = res.hop_sent[:, hops]
        failed = res.hop_error[:, hops]
        counts += torch.stack([
            (failed & inside).sum(), (sent & inside).sum(),
            (failed & ~inside).sum(), (sent & ~inside).sum(),
        ]).double()
    f_in, s_in, f_out, s_out = counts.tolist()
    share = f_in / s_in
    log(f"panic: {LB_KILL['service']} {int(f_in)} of {int(s_in)} hops "
        f"fast-failed in [{LB_KILL['start_s']:g} s, {LB_KILL['end_s']:g} s)"
        f" ({share:.4%}; 40 of 100 replicas healthy, threshold 50%), "
        f"{int(f_out)} of {int(s_out)} outside")
    if abs(share - LB_PANIC_SHARE) > LB_PANIC_BAND or f_out:
        raise AssertionError(f"panic share {share:.4%} or {f_out} outside")
    prof = sim._lb_profile_np
    ring = list(sim.compiled.services.names).index("svc-0-0")
    hot = prof[ring, 0] / prof[ring, :100].sum()
    log(f"panic run: svc-0-0's hottest ring backend takes {hot:.4f} of "
        f"{load.qps:g}/s, rho {hot * load.qps / sim._mu:.4f}"
        f" against one replica")


def protected_runs(port, device="cuda"):
    """The protected runs: (name, simulator on ``device``, load,
    requests, block, window, rollouts, make), ``make(device)`` building
    the same Simulator on another device; the block is
    ``runner/run.protected_window_block``'s for 1 s windows, as
    ``simulate --policies --timeline 1s`` sizes it."""
    import yaml

    out = []

    def add(name, graph, params, chaos, load, n, roll):
        compiled = port.compile_graph(graph)
        pol = port.compile_policies(graph, compiled)
        ro = port.compile_rollouts(graph, compiled) if roll else None

        def make(device, compiled=compiled, pol=pol, ro=ro):
            return port.Simulator(compiled, params, chaos, policies=pol,
                                  rollouts=ro, device=device)

        make.graph = graph  # phase 10's topology lint
        sim = make(device)
        window, block = port.protected_window_block(
            sim, load, sim.default_block_size(), params.timeline_window_s,
            PROTECTED_WINDOW_S,
        )
        out.append((name, sim, load, n, block, window, roll, make))

    doc = port.with_call_policy(
        yaml.safe_load((TOPOLOGIES / "1000-svc_2000-end.yaml").read_text()),
        timeout=POLICY_TIMEOUT, retries=POLICY_RETRIES,
    )
    doc["policies"] = PROTECTED_POLICIES
    add("policies-1000svc-kill", port.ServiceGraph.decode(doc),
        port.SimParams(timeline=True), (port.ChaosEvent(**POLICY_KILL),),
        port.LoadModel(kind="open", qps=PROTECTED_QPS,
                       duration_s=PROTECTED_S),
        int(PROTECTED_QPS * PROTECTED_S), False)
    for kind, canary in (("clean", {}), ("bad", {"canary": BAD_CANARY})):
        doc = port.realistic_topology(1000, archetype="multitier", seed=0)
        doc["rollouts"] = {doc["services"][1]["name"]: {**ROLLOUT, **canary}}
        doc["policies"] = ROLLOUT_POLICIES
        graph = port.ServiceGraph.decode(doc)
        qps = port.Simulator(port.compile_graph(graph),
                             device=device).capacity_qps() / 2
        add(f"rollouts-multitier-1000-{kind}", graph,
            port.SimParams(timeline=True), (),
            port.LoadModel(kind="open", qps=qps, duration_s=PROTECTED_S),
            int(qps * PROTECTED_S), True)
    graph = port.ServiceGraph.from_yaml(SMOKE_TOPOLOGY)
    smoke_params = port.SimParams(timeline=True, timeline_window_s=1.0)
    add("policies-smoke", graph, smoke_params,
        (port.ChaosEvent(**SMOKE_KILL),),
        port.LoadModel(kind="open", qps=SMOKE_QPS), SMOKE_N, False)
    # the reference tool's own blocks, not one window's
    name, sim, load, n, _, window, roll, make = out[-1]
    out[-1] = (name, sim, load, n, SMOKE_BLOCK, window, roll, make)
    return out


def protected_call(port, sim, load, n, block, window, roll, seed=0):
    """``run_rollouts`` / ``run_policies`` as ``simulate`` calls them."""
    fn = sim.run_rollouts if roll else sim.run_policies
    return fn(load, n, port.TorchDraws(seed, sim.device), block_size=block,
              trim=True, window_s=window)


class _Recording:
    """A protected run's carry that remembers the effects each block ran
    under (for the CPU twin of phase 4)."""

    def __init__(self, ctl):
        self.ctl, self.last = ctl, None

    def effects(self):
        self.last = self.ctl.effects()
        return self.last

    def observe(self, res, t_done):
        self.ctl.observe(res, t_done)


class _Mirror:
    """The CPU twin's carry: its blocks run under the card's effects
    (so both draw the same coins against the same thresholds), and its
    own control laws advance from its own observations."""

    def __init__(self, ctl, card, device):
        self.ctl, self.card, self.device = ctl, card, device

    def effects(self):
        return tuple(
            None if fx is None else type(fx)(*(
                None if x is None else x.to(self.device) for x in fx
            ))
            for fx in self.card.last
        )

    def observe(self, res, t_done):
        self.ctl.observe(res, t_done)


def _same(a, b, what, rtol=0.0, atol=0.0):
    a, b = a.detach().cpu().double(), b.detach().cpu().double()
    if rtol == 0.0 and atol == 0.0:
        if not torch.equal(a, b):
            raise AssertionError(f"{what} differs")
    else:
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol,
                                   msg=lambda m: f"{what}: {m}")


def _same_counts(a, b, what):
    """Window-binned counts: totals exactly, each bin within
    WINDOW_COUNT_ATOL events (a boundary's float32 spacing)."""
    _same(a.sum(-1), b.sum(-1), f"{what} totals")
    _same(a, b, what, atol=WINDOW_COUNT_ATOL)


#: the recorder's fixed-point time unit (metrics/timeline.TIME_UNIT)
TIME_UNIT = 2.0 ** -28


def event_time_gap(got, want):
    """The largest difference, card against CPU, of a sent hop's start,
    busy start (start + wait) and end (start + latency) in one block,
    in seconds: the event times the recorder's occupancy integrals sum
    (float32 differences of nearby float32 values are exact)."""
    sent = want.hop_sent.cpu()
    gap = 0.0
    for t in (lambda r: r.hop_start,
              lambda r: r.hop_start + r.hop_wait,
              lambda r: r.hop_start + r.hop_latency):
        d = (t(got).cpu() - t(want).cpu()).abs()
        gap = max(gap, float(torch.where(sent, d, 0.0).max()))
    return gap


def occupancy_bound(tl, gap, blocks):
    """(S, W) float64 bound on the card-against-CPU difference of a
    recorded run's occupancy integrals, from what can differ: a hop's
    overlap with a window moves by at most the moves of its two ends,
    each at most ``gap`` (the run's largest event-time difference,
    ``event_time_gap``) plus a float32 spacing of the horizon (the
    window index of an event at a boundary) plus the fixed-point
    rounding (TIME_UNIT / 2 a time, on each side); only the hops that
    meet the window move it (those that start in it and those in
    flight at its start, from ``tl``'s counts, plus WINDOW_COUNT_ATOL
    that cross a boundary on one side only); and each of ``blocks``
    float32 partial sums rounds once."""
    arr = tl.svc_arrivals.detach().cpu().double()
    net = arr - tl.svc_completions.detach().cpu().double()
    open_at_start = torch.cumsum(net, dim=1) - net
    touching = arr + open_at_start + 2 * WINDOW_COUNT_ATOL
    horizon = tl.num_windows * float(tl.window_s)
    per_hop = 2.0 * (gap + float(np.spacing(np.float32(horizon)))
                     + TIME_UNIT)
    return touching * per_hop, (blocks + 1) * 2.0 ** -23


def compare_timelines(got, want, what, lat_max, gap, blocks):
    """The recorder, card against CPU: the request count exactly, the
    window-binned counts as ``_same_counts``, the latency sums at the
    engine's tolerance plus WINDOW_COUNT_ATOL requests of ``lat_max``
    (a boundary request's latency moves with its count), the occupancy
    integrals within ``occupancy_bound``.  Returns the largest
    occupancy difference as a share of its bound, and the median bound
    as a share of its busy integral (how tight the bound is)."""
    _same(got.count, want.count, f"{what} count")
    for name in ("arrivals", "completions", "errors", "latency_hist",
                 "svc_arrivals", "svc_completions", "svc_errors"):
        _same_counts(getattr(got, name), getattr(want, name),
                     f"{what} {name}")
    _same(got.latency_sum, want.latency_sum, f"{what} latency_sum",
          rtol=RESULT_RTOL, atol=WINDOW_COUNT_ATOL * lat_max)
    atol, rtol = occupancy_bound(want, gap, blocks)
    worst = 0.0
    for name in ("svc_inflight_s", "svc_busy_s"):
        a = getattr(got, name).detach().cpu().double()
        w = getattr(want, name).detach().cpu().double()
        share = (a - w).abs() / (atol + rtol * w.abs())
        worst = max(worst, float(share.max()))
        if worst > 1.0:
            raise AssertionError(
                f"{what} {name}: {float((a - w).abs().max()):.3e} s off, "
                f"{worst:.3f} of its bound (event-time gap {gap:.3e} s)")
    busy = want.svc_busy_s.detach().cpu().double()
    tight = float(((atol + rtol * busy) / busy)[busy > 0].median())
    return worst, tight


def shed_path(card_fx, res, hop_service):
    """The hops one block shed, from the policy effects it ran under:
    (errored hops at a shedding service that never queued, errored
    hops elsewhere)."""
    shedding = (card_fx.shed.cpu() > 0.0)[hop_service]
    err = res.hop_error & res.hop_sent
    shed = err & shedding[None, :] & (res.hop_wait == 0.0)
    return int(shed.sum()), int((err & ~shed).sum())


def check_breaker_cycle(pacc, what):
    """A policy run whose breaker must trip, shed and recover: returns
    (trips, largest shed, services that recovered)."""
    trips = float(pacc.trips.sum())
    shed = float(pacc.shed.max())
    done = pacc.windows_done.cpu() > 0
    opened = pacc.breaker_open.cpu()[:, done] > 0
    # recovered: a window with the breaker closed after one with it open
    seen = torch.cumsum(opened.int(), dim=1) > 0
    recovered = int(((seen[:, :-1] & ~opened[:, 1:]).any(1)).sum())
    if trips < 1 or shed <= 0.0 or recovered < 1:
        raise AssertionError(
            f"{what}: the breaker must trip, shed and recover (trips "
            f"{trips:g}, largest shed {shed:g}, {recovered} recovered)")
    return trips, shed, recovered


def in_situ_twins(port, runs):
    """The runs phase 4 holds: each protected run whole, except
    policies-1000svc-kill, held through its compressed twin."""
    out = []
    for name, sim, load, n, block, window, roll, make in runs:
        if name == "policies-1000svc-kill":
            kill = (port.ChaosEvent(**{**POLICY_KILL, "start_s": 0.0,
                                       "end_s": POLICY_TWIN_KILL_S}),)

            def make(device, sim=sim, kill=kill):
                return port.Simulator(sim.compiled, attributed_params(sim),
                                      kill, policies=sim._policies,
                                      device=device)

            name = f"{name} (twin: {POLICY_TWIN_S:g} s)"
            n = int(load.qps * POLICY_TWIN_S)
            n = -(-n // block) * block
            window = POLICY_TWIN_WINDOW_S
        out.append((name, sim, load, n, block, window, roll, make))
    return out


def protected_in_situ(port, runs, source=None):
    """Each protected run on the card and on the CPU with the same
    draws, block by block in lockstep: every CPU block runs under the
    effects the card's block ran under, so booleans and counts are
    exact and floats within the engine's tolerance; each side advances
    its own control laws from its own observations, and their series
    must agree: states and steps exactly, the breaker's shed and the
    budget's retry allow (continuous functions of the recorder's
    integrals and counts) within SHED_RTOL, window-binned counts as
    ``_same_counts``.  ``source``: the draws (a fleet member's);
    ``TorchDraws(11)`` by default."""
    for name, _, load, n, block, window, roll, make in runs:
        if source is None:
            source = port.TorchDraws(11, "cuda")
        card, cpu = make("cuda"), make("cpu")
        pol = card._policies is not None
        rec = _Recording(card._control(load, n, source, block, window,
                                       pol, roll))
        mirror = _Mirror(cpu._control(load, n, source, block, window, pol,
                                      roll), rec, "cpu")
        worst, blocks, events = 0.0, 0, 0
        lat_max = hop_max = gap = 0.0
        shed_hops = other_errors = 0
        hop_service = torch.as_tensor(card.compiled.hop_service).long()
        # the policy twin's blocks also attributed, tail armed at the cut
        # of an unprotected pilot (as run_policies(attribution=True,
        # tail=True) takes it)
        attributed = (
            AttributedBlocks(port, card, f"attributed {name}",
                             card.estimate_tail_cut(load, n, source,
                                                    block_size=block))
            if name.startswith("policies-1000svc-kill") else None
        )
        t = time.perf_counter()
        for b, (got, want) in enumerate(zip(
            card.run_blocks(load, n, source, block_size=block,
                            control=rec),
            cpu.run_blocks(load, n, source, block_size=block,
                           control=mirror),
        )):
            worst = max(worst, compare_results(
                got, want, f"in situ {name} block {b}"))
            for field in ("hop_canary", "hop_refused"):
                a, w = getattr(got, field), getattr(want, field)
                if (a is None) != (w is None):
                    raise AssertionError(f"in situ {name}: {field}")
                if a is not None:
                    _same(a, w, f"in situ {name} block {b} {field}")
            if attributed is not None:
                attributed.block(got)
            blocks += 1
            events += int(got.hop_events)
            lat_max = max(lat_max, float(want.client_latency.max()))
            hop_max = max(hop_max, float(want.hop_latency.max()))
            gap = max(gap, event_time_gap(got, want))
            if pol:
                shed, other = shed_path(rec.last[0], want, hop_service)
                shed_hops, other_errors = (shed_hops + shed,
                                           other_errors + other)
        if attributed is not None:
            attributed.finish()
            attributed.same_run(card.run_policies(
                load, n, source, block_size=block, window_s=window,
                attribution=True, tail=True, tail_cut=attributed.cut)[-1])
        occ, tight = compare_timelines(
            rec.ctl.tl_acc, mirror.ctl.tl_acc, f"in situ {name} timeline",
            lat_max, gap, blocks)
        log(f"in situ {name}: occupancy integrals within {occ:.4f} of "
            f"their bound (median bound {tight:.4f} of a busy integral),"
            f" largest event-time gap {gap:.3e} s")
        if name.startswith(SHED_CHECKED):
            trips, shed, recovered = check_breaker_cycle(
                rec.ctl.pacc, f"in situ {name}")
            if shed_hops < 1:
                raise AssertionError(
                    f"in situ {name}: no errored hop came from a shed")
            log(f"in situ {name}: breaker trips {trips:g}, largest shed "
                f"{shed:.4f}, {recovered} service(s) recovered; "
                f"{shed_hops} errored hops shed at admission (wait 0 at a"
                f" shedding service), {other_errors} other errored hops")
        if pol:
            a, w = rec.ctl.pacc, mirror.ctl.pacc
            for field in a._fields:
                tol = ({"rtol": SHED_RTOL, "atol": 1e-6}
                       if field in ("shed", "retry_allow") else {})
                _same(getattr(a, field), getattr(w, field),
                      f"in situ {name} policy {field}", **tol)
        if roll:
            a, w = rec.ctl.rollout_summary(), mirror.ctl.rollout_summary()
            for field in a._fields:
                what = f"in situ {name} rollout {field}"
                if field in ("ver_arrivals", "ver_errors"):
                    _same_counts(getattr(a, field), getattr(w, field), what)
                elif field == "ver_latency_s":
                    # a boundary hop's latency moves with its count
                    _same(a.ver_latency_s.sum(-1), w.ver_latency_s.sum(-1),
                          f"{what} totals", rtol=RESULT_RTOL, atol=1e-6)
                    _same(a.ver_latency_s, w.ver_latency_s, what,
                          rtol=RESULT_RTOL, atol=WINDOW_COUNT_ATOL * hop_max)
                else:
                    _same(getattr(a, field), getattr(w, field), what)
        log(f"in situ ok {name}: card (kernel) == cpu (plain), {blocks} "
            f"blocks under the same control effects, {events} hop events,"
            f" largest difference {worst:.3f} of its tolerance; recorder "
            f"and control series agree (shed and retry allow within rtol "
            f"{SHED_RTOL:g}, window counts within {WINDOW_COUNT_ATOL})"
            f" ({time.perf_counter() - t:.1f} s)")


def protected_outcome(port, name, sim, out, roll):
    """Print a protected run's policy and rollout outcomes and check
    them; returns the documents."""
    docs = {}
    rest = list(out[2:])
    if roll:
        doc = port.rollout_mod.to_doc(sim.compiled, rest.pop(0),
                                      sim._rollouts)
        docs["rollouts"] = doc
        for svc, r in doc["services"].items():
            log(f"protected {name}: rollout {svc} state {r['state']}, "
                f"final weight {r['final_weight']}, weights "
                f"{r['weight'][:12]}, promotions {r['promotions']:g} at "
                f"{r['promote_onsets_s']}, holds {r['holds']:g}, rollbacks "
                f"{r['rollbacks']:g} at {r['rollback_onsets_s']}, canary "
                f"samples {r['canary_samples']:g}")
    if sim._policies is not None:
        doc = port.policies_mod.to_doc(sim.compiled, rest.pop(0),
                                       sim._policies)
        docs["policies"] = doc
        svcs = doc["services"]
        tripped = {k: v for k, v in svcs.items() if v["breaker_trips"]}
        scaled = {k: v for k, v in svcs.items() if v["scale_events"]}
        capped = {k: min(v["retry_allow"]) for k, v in svcs.items()
                  if v["retry_allow"] and min(v["retry_allow"]) < 1.0}
        log(f"protected {name}: {doc['windows_done']} of "
            f"{doc['num_windows']} windows; {len(tripped)} breaker(s) "
            f"tripped, {len(scaled)} service(s) scaled, {len(capped)} "
            f"retry budget(s) capped")
        for svc, v in list(tripped.items())[:4]:
            log(f"protected {name}: breaker {svc} trips "
                f"{v['breaker_trips']:g}, onset {v['breaker_trip_onset_s']}"
                f" s, recovery {v['breaker_recovery_s']} s, shed "
                f"{[round(x, 3) for x in v['shed']]}")
        for svc, v in list(scaled.items())[:3]:
            log(f"protected {name}: autoscaler {svc} first scale "
                f"{v['first_scale_onset_s']} s, replicas {v['replicas']}")
        for svc, a in list(capped.items())[:3]:
            log(f"protected {name}: retry budget {svc} min allow {a:.4f}")
    return docs


def protected_phase(port, runs, census_ms):
    """Each protected run once after a one-block warm-up: wall per
    block, hop events per second, census launches (blocks x calls per
    block) and its outcomes; the policies-1000svc-kill run twice, bit
    for bit; the smoke's unprotected twin; the recorder's peak memory at
    the 1000-service run's own block."""
    for _, sim, load, _, block, window, roll, _ in runs:
        protected_call(port, sim, load, block, block, window, roll)
    torch.cuda.synchronize()
    launches, walls, outs = {}, {}, {}
    for name, sim, load, n, block, window, roll, _ in runs:
        torch.cuda.synchronize()
        port.census.launches = 0
        t = time.perf_counter()
        out = protected_call(port, sim, load, n, block, window, roll)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        blocks = max(1, -(-n // block))
        per_block = len(census_calls(sim, block))
        launches[name] = port.census.launches
        if launches[name] != blocks * per_block:
            raise AssertionError(
                f"{name}: {launches[name]} census launches, expected "
                f"{blocks} x {per_block}")
        summary = out[0]
        qs = summary.quantiles_s((0.5, 0.99))
        if not np.all(np.isfinite(qs)) or int(summary.count) != (
            blocks * block
        ):
            raise AssertionError(f"{name}: bad summary")
        walls[name] = wall / blocks
        log(f"protected {name}: {int(summary.count)} requests in {blocks} "
            f"blocks of {block} ({window:g} s windows), offered "
            f"{load.qps:.6g} qps, {wall / blocks * 1e3:.2f} ms per block, "
            f"{float(summary.hop_events) / wall:.4e} hop-events/s, p50/p99 "
            f"{qs[0] * 1e3:.4f}/{qs[1] * 1e3:.4f} ms, "
            f"{int(summary.error_count)} client errors, census launches "
            f"{launches[name]} ({per_block} per block), census device "
            f"{census_ms[name]:.4f} ms per block (phase 3)")
        outs[name] = (out, protected_outcome(port, name, sim, out, roll))
    check_protected_outcomes(outs)
    smoke_twin(port, runs, outs)
    repeat_bit_for_bit(port, runs, outs)
    recorder_peak_memory(port)
    return launches, walls


def check_protected_outcomes(outs):
    """The outcomes the protected runs are built to show."""
    pol = outs["policies-1000svc-kill"][1]["policies"]["services"]
    killed = pol[POLICY_KILL["service"]]
    if not (POLICY_KILL["start_s"] <= (killed["breaker_trip_onset_s"]
                                       or -1) < POLICY_KILL["end_s"]
            and killed["breaker_recovery_s"] is not None
            and any(min(v["retry_allow"]) < 1.0 for v in pol.values())
            and any(v["scale_events"] >= 1 for v in pol.values())):
        raise AssertionError(f"policies-1000svc-kill: {killed}")
    canary = lambda kind: next(iter(  # noqa: E731
        outs[f"rollouts-multitier-1000-{kind}"][1]["rollouts"][
            "services"].values()))
    clean, bad = canary("clean"), canary("bad")
    if clean["state"] != "done" or clean["final_weight"] != 1.0:
        raise AssertionError(f"clean canary: {clean}")
    bake = float(ROLLOUT["bake"][:-1])
    if not (bad["state"] == "failed" and bad["final_weight"] == 0.0
            and bad["rollback_onsets_s"][0] <= bake):
        raise AssertionError(f"bad canary: {bad}")
    log(f"protected rollouts: the clean canary reached done at weight 1, "
        f"the bad one rolled back at {bad['rollback_onsets_s'][0]:g} s "
        f"(bake {bake:g} s) and ended failed at weight 0")


def smoke_twin(port, runs, outs):
    """The policies smoke against its unprotected twin, same draws."""
    name, sim, load, n, block, window, _, make = [
        r for r in runs if r[0] == "policies-smoke"][0]
    s_p, tl_p, pol_p = outs[name][0]
    twin = port.Simulator(sim.compiled, sim.params, (port.ChaosEvent(
        **SMOKE_KILL),), device="cuda")
    s_u, _ = twin.run_timeline(load, n, port.TorchDraws(0, "cuda"),
                               block_size=block, trim=True, window_s=window)
    w = outs[name][1]["policies"]["services"]["worker"]
    share_p = float(s_p.error_count) / float(s_p.count)
    share_u = float(s_u.error_count) / float(s_u.count)
    reps = w["replicas"]
    ok = (float(s_p.hop_events) < float(s_u.hop_events)
          and share_p < share_u
          and w["breaker_trip_onset_s"] is not None
          and SMOKE_KILL["start_s"] <= w["breaker_trip_onset_s"] <= 6.0
          and w["breaker_recovery_s"] is not None
          and min(w["retry_allow"]) < 1.0
          and max(reps) > reps[0] and w["scale_events"] >= 1)
    log(f"policies-smoke: protected {float(s_p.hop_events):.0f} hop events"
        f" / {share_p:.4%} client errors, unprotected "
        f"{float(s_u.hop_events):.0f} / {share_u:.4%}; worker trip "
        f"{w['breaker_trip_onset_s']} s, recovery {w['breaker_recovery_s']}"
        f" s, min retry allow {min(w['retry_allow']):.4f}, replicas "
        f"{reps[0]:g} -> peak {max(reps):g}")
    if not ok:
        raise AssertionError("policies-smoke acceptance failed")


def repeat_bit_for_bit(port, runs, outs):
    """The first protected run again on the card: bit for bit."""
    name, sim, load, n, block, window, roll, _ = runs[0]
    again = protected_call(port, sim, load, n, block, window, roll)
    first = outs[name][0]
    for part_a, part_b in zip(first, again):
        for field, a in part_a._asdict().items():
            b = getattr(part_b, field)
            if isinstance(a, torch.Tensor) and not torch.equal(a, b):
                raise AssertionError(f"{name} repeat: {field} differs")
    log(f"protected {name}: repeated on the card, summary, recorder and "
        f"policy series equal bit for bit")


def recorder_peak_memory(port):
    """``run_timeline`` at the 1000-service run's own block: its wall
    per block and the card's peak memory."""
    rec = port.Simulator(port.compile_graph(port.ServiceGraph.from_yaml_file(
        TOPOLOGIES / "1000-svc_2000-end.yaml")),
        port.SimParams(timeline=True), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    _, tl = rec.run_timeline(port.LoadModel(kind="open", qps=1e4), 262_144,
                             port.TorchDraws(0, "cuda"), block_size=32_768,
                             window_s=PROTECTED_WINDOW_S)
    torch.cuda.synchronize()
    log(f"run_timeline 1000-svc_2000-end: 8 blocks of 32,768, "
        f"{tl.num_windows} windows, {(time.perf_counter() - t) / 8 * 1e3:.2f}"
        f" ms per block, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")


def census_only_configs(port, device="cuda"):
    """(name, simulator, default block) of the topologies whose census
    calls phase 3 holds and times beside the main path's."""
    out = []
    for name in CENSUS_ONLY_TOPOLOGIES:
        sim = port.Simulator(
            port.compile_graph(port.ServiceGraph.from_yaml_file(
                TOPOLOGIES / f"{name}.yaml")),
            device=device,
        )
        out.append((name, sim, sim.default_block_size()))
    return out


def main_path_run(port, name, sim, load, n, block, census_ms=None):
    """One timed run; returns its summary and census launches.
    ``census_ms``: the census device time per block of phase 3, printed
    when given.  A saturated run launches the wait kernel once a
    block."""
    torch.cuda.synchronize()
    port.census.launches = 0
    port.saturated_wait.launches = 0
    t = time.perf_counter()
    summary = sim.run_summary(
        load, n, port.TorchDraws(0, "cuda"), block_size=block, trim=True
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = port.census.launches
    sat_launches = port.saturated_wait.launches
    count = int(summary.count)
    blocks = max(1, -(-n // block))
    if sat_launches != (blocks if sim._saturated(load) else 0):
        raise AssertionError(
            f"{name}: {sat_launches} wait kernel launches in {blocks} "
            f"blocks")
    hop_events = float(summary.hop_events)
    qs = summary.quantiles_s((0.5, 0.9, 0.99))
    # run_summary rounds the requests up to whole blocks
    if count != blocks * block:
        raise AssertionError(
            f"{name}: count {count} != {blocks} blocks x {block}"
        )
    if not np.all(np.isfinite(qs)) or not np.all(qs > 0):
        raise AssertionError(f"{name}: bad quantiles {qs}")
    per_block = len(sim.census_shapes(block))
    if launches != blocks * per_block:
        raise AssertionError(
            f"{name}: {launches} census launches, expected {blocks} "
            f"blocks x {per_block}"
        )
    rate = (
        load.qps if load.kind == "open"
        else sim.solve_closed_rate(load, n, port.TorchDraws(0, "cuda"))
    )
    if getattr(sim, "has_chaos", False):
        windows = sim._windows_arg(rate, sim._saturated(load)).cpu().numpy()
        log(f"main path {name}: phase windows (start s, row) " + ", ".join(
            f"({b:.6g}, {int(r)})" for b, r in zip(*windows)))
    log(f"main path {name}: {count} requests in {blocks} blocks, offered "
        f"{rate:.6g} qps, {wall / blocks * 1e3:.2f} ms per block, "
        f"{hop_events / wall:.4e} hop-events/s, p50/p90/p99 "
        f"{qs[0] * 1e3:.4f}/{qs[1] * 1e3:.4f}/{qs[2] * 1e3:.4f} ms, "
        f"{int(summary.error_count)} client errors, census launches "
        f"{launches} ({per_block} per block), wait kernel launches "
        f"{sat_launches}" + (
            "" if census_ms is None
            else f", census device {census_ms:.4f} ms per block (phase 3)"
        ))
    return summary, launches, wall / blocks


def main_path_phase(port, runs, build_s, census_ms=None, walls=None):
    """Each run once, after one warm-up block of each; returns the census
    launches per run.  ``census_ms``: phase 3's census device time per
    block of each run, printed when given; ``walls`` collects each run's
    wall per block."""
    # the saturated tables and rate first, timed as host planning (their
    # fork-join pilots run on the card)
    for name, sim, load, n, _ in runs:
        if load.kind == "closed" and load.qps is None:
            t = time.perf_counter()
            sim.solve_closed_rate(load, n, port.TorchDraws(0, "cuda"))
            torch.cuda.synchronize()
            build_s[f"{name} tables"] = time.perf_counter() - t
    log("host build: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in build_s.items()
    ))
    # one block of each first, so the timed runs do not pay the caching
    # allocator's first growth and the first launches; the same seed as
    # the timed runs, so the closed loop's cached rate is that run's own
    for _, sim, load, _, block in runs:
        sim.run_summary(load, block, port.TorchDraws(0, "cuda"),
                        block_size=block)
    torch.cuda.synchronize()

    launches = {}
    walls = {} if walls is None else walls
    for run in runs:
        summary, launches[run[0]], walls[run[0]] = main_path_run(
            port, *run, None if census_ms is None else census_ms[run[0]]
        )
        if run[0] == "flagship" and (
            float(summary.hop_events) != 121 * int(summary.count)
        ):
            raise AssertionError(
                f"flagship: hop_events {float(summary.hop_events)} != "
                f"121 x {int(summary.count)}"
            )
    if "lb-1000svc-lr" in walls:
        log(f"lb-1000svc-lr against its fifo twin: "
            f"{walls['lb-1000svc-lr'] * 1e3:.2f} / "
            f"{walls['1000-svc_2000-end'] * 1e3:.2f} ms per block = "
            f"{walls['lb-1000svc-lr'] / walls['1000-svc_2000-end']:.3f}x")
    log(f"census launches on the main path: {sum(launches.values())} "
        f"{launches}")
    return launches


# -- phase 6: the CLI --------------------------------------------------------


def cli(*args, ok_codes=(0,)):
    out = subprocess.run(
        [sys.executable, "-m", "isotope_tpu_torch", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    if out.returncode not in ok_codes:
        raise AssertionError(
            f"CLI {' '.join(args)} exited {out.returncode}:\n{out.stderr}"
        )
    return out


def check_lines(err: str):
    """(text, values) of a check's stderr lines, the numbers cut out."""
    number = re.compile(r"-?\d+\.\d+(?:e[-+]?\d+)?")
    lines = [line for line in err.splitlines() if line.strip()]
    return ([number.sub("#", line) for line in lines],
            [[float(x) for x in number.findall(line)] for line in lines])


def cli_phase():
    canonical = str(TOPOLOGIES / "canonical.yaml")
    out = cli("simulate", canonical, "--qps", "1000", "--duration", "10s",
              "--load-kind", "open")
    doc = json.loads(out.stdout)
    count = doc["DurationHistogram"]["Count"]
    if count != 10_000:
        raise AssertionError(f"CLI: Count {count} != 10000")
    log(f"cli ok: {count} requests, p99 "
        f"{doc['DurationHistogram']['Percentiles'][3]['Value'] * 1e3:.4f} ms")

    # check: card against CPU, same verdict and alarm lines.  The two
    # runs draw from different generators (TorchDraws on the card's and
    # on the CPU's torch generator), so only values that do not depend
    # on the draws are held to CHECK_RTOL: those of the alarm lines here
    # (the CPU alarm: utilization x replicas); the --debug query lines
    # of the memory and request-rate estimates are printed, not compared
    runs = {}
    for device in ("cuda", "cpu"):
        t = time.perf_counter()
        out = cli("check", canonical, "--max-requests", str(CLI_REQUESTS),
                  "--debug", "--device", device, ok_codes=(0, 1))
        verdict = "\n".join(
            line for line in out.stderr.splitlines()
            if line.startswith("ALARM:") or "checks passed" in line
        )
        runs[device] = (out.returncode, verdict, out.stderr,
                        time.perf_counter() - t)
    (rc_card, v_card, err_card, s_card), (rc_cpu, v_cpu, err_cpu, s_cpu) = (
        runs["cuda"], runs["cpu"]
    )
    text_card, values_card = check_lines(v_card)
    text_cpu, values_cpu = check_lines(v_cpu)
    if rc_card != rc_cpu or text_card != text_cpu:
        raise AssertionError(
            f"check: card (rc {rc_card}) and cpu (rc {rc_cpu}) differ:\n"
            f"{err_card}\n{err_cpu}"
        )
    for a, b in zip(values_card, values_cpu):
        np.testing.assert_allclose(a, b, rtol=CHECK_RTOL)
    log(f"cli check ok: exit code {rc_card} on the card and on the cpu "
        f"({s_card:.1f} s / {s_cpu:.1f} s), alarm lines equal, values "
        f"within rtol {CHECK_RTOL:g}")
    log("cli check on the card: " + " | ".join(err_card.splitlines()))
    log("cli check on the cpu: " + " | ".join(err_cpu.splitlines()))

    for device in ("cuda", "cpu"):
        out = cli("simulate", canonical, "--qps", "max", "--max-requests",
                  str(CLI_REQUESTS), "--device", device)
        doc = json.loads(out.stdout)
        if doc["RequestedQPS"] != "max" or not (
            doc["DurationHistogram"]["Count"] >= CLI_REQUESTS
        ):
            raise AssertionError(f"simulate --qps max on {device}: {doc}")
        log(f"cli simulate --qps max ok on {device}: "
            f"{doc['DurationHistogram']['Count']} requests, ActualQPS "
            f"{doc['ActualQPS']:.6g}")

    # a sidecar environment over two clusters' edge classes: the
    # draw-independent values of the two documents agree
    two = str(TOPOLOGIES / "two-cluster-canonical.yaml")
    docs = {}
    for device in ("cuda", "cpu"):
        out = cli("simulate", two, "--environment", "ISTIO", "--qps", "1000",
                  "--duration", "10s", "--load-kind", "open", "--device",
                  device)
        doc = json.loads(out.stdout)
        hist = doc["DurationHistogram"]
        docs[device] = {
            "Labels": doc["Labels"], "RequestedQPS": doc["RequestedQPS"],
            "RequestedDuration": doc["RequestedDuration"],
            "NumThreads": doc["NumThreads"], "RetCodes": doc["RetCodes"],
            "Count": hist["Count"],
        }
        log(f"cli simulate --environment ISTIO on {device}: {docs[device]}, "
            f"p50 {hist['Percentiles'][0]['Value'] * 1e3:.4f} ms")
    if docs["cuda"] != docs["cpu"] or (
        docs["cuda"]["Labels"] != "two-cluster-canonical_istio_1000qps_64c"
    ):
        raise AssertionError(f"simulate --environment ISTIO: {docs}")
    cli_lb_phase()


def cli_lb_phase(devices=("cuda", "cpu")):
    """The lb topology through the CLI on each of ``devices``: its laws
    apply with no flag, ``--lb-out`` writes them, the draw-independent
    values agree, and ``--qps max`` is refused."""
    import yaml

    with tempfile.TemporaryDirectory() as tmp:
        topo = pathlib.Path(tmp) / "lb-10svc-100r.yaml"
        topo.write_text(
            (TOPOLOGIES / "10-svc_1000-end.yaml").read_text()
            + yaml.safe_dump({"policies": LB_PANIC_POLICIES})
        )
        docs = {}
        for i, device in enumerate(devices):
            lb_json = pathlib.Path(tmp) / f"lb-{i}.json"
            out = cli("simulate", str(topo), "--qps", "30000", "--duration",
                      "2s", "--load-kind", "open", "--lb-out", str(lb_json),
                      "--device", device)
            doc = json.loads(out.stdout)
            hist = doc["DurationHistogram"]
            docs[i] = {
                "Labels": doc["Labels"], "RetCodes": doc["RetCodes"],
                "Count": hist["Count"], "lb": json.loads(lb_json.read_text()),
            }
            if "least_request" not in out.stderr or "ring_hash" not in (
                out.stderr
            ):
                raise AssertionError(f"simulate lb on {device}: {out.stderr}")
            log(f"cli simulate lb on {device}: {doc['Labels']}, "
                f"{hist['Count']} requests, RetCodes {doc['RetCodes']}, p50 "
                f"{hist['Percentiles'][0]['Value'] * 1e3:.4f} ms, lb table "
                f"of {len(out.stderr.splitlines())} lines, its first: "
                f"{out.stderr.splitlines()[1][:120]}")
        if docs[0] != docs[1] or docs[0]["Count"] != 60_000:
            raise AssertionError(f"simulate lb: {docs}")
        out = cli("simulate", str(topo), "--qps", "max", "--device",
                  devices[0], ok_codes=(1,))
        if "-qps max" not in out.stderr:
            raise AssertionError(f"simulate lb --qps max: {out.stderr}")
        log("cli simulate lb --qps max refused: "
            + out.stderr.strip().splitlines()[-1])


#: the CLI's protected topology: canonical.yaml with a retry budget and
#: an autoscaler on the defaults and a canary schedule on b
CLI_PROTECTED = {
    "policies": {"defaults": {
        "retry_budget": {"budget_percent": "25%"},
        "autoscaler": {"min_replicas": 1, "max_replicas": 2,
                       "sync_period": "1s"},
    }},
    "rollouts": {"b": {"steps": ["10%", "50%", "100%"], "bake": "1s",
                       "gates": {"min_samples": 20}}},
}
#: timeline-document entries derived from the occupancy integrals
#: (held by ``timeline_doc_close``), and the convoy quotients of them
#: (not compared: their series are)
_OCCUPANCY_KEYS = {"utilization", "queue_depth", "in_flight",
                   "peak_utilization"}
#: ...and the argmax of a utilization series (its value, peak_utilization,
#: is compared): two windows within that tolerance may swap
_CONVOY_FLOATS = {"entry_wait_share", "leaf_busy_share", "correlation",
                  "peak_window"}
#: per-window counts of the documents, held as phase 4 holds the
#: recorder's (WINDOW_COUNT_ATOL: a boundary event lands on either side)
_WINDOW_COUNT_KEYS = {"arrivals", "completions", "errors", "qps"}
#: the documents' other floats, card against CPU (rounded to 6-9
#: digits, and quotients of the window counts)
DOC_RTOL = 1e-4


#: keys docs_close skips by default: the wall clock's ``StartTime``, the
#: convoy quotients and the occupancy-derived entries
_DOC_SKIP = {"StartTime"} | _CONVOY_FLOATS | _OCCUPANCY_KEYS


def docs_close(got, want, path="", window_s=1.0, rtol=DOC_RTOL,
               skip=_DOC_SKIP, counts=_WINDOW_COUNT_KEYS):
    """Two documents agree: keys, strings, booleans and integers
    exactly; floats under a key in ``counts`` (per-window counts) within
    WINDOW_COUNT_ATOL events, other floats within ``rtol`` and
    RESULT_ATOL (card against CPU on the same draws); keys in ``skip``
    not compared (by default the wall clock, the convoy quotients and
    the occupancy-derived entries, which ``timeline_doc_close`` holds).
    Returns the largest float difference as a share of its tolerance."""
    def close(g, w, at):
        return docs_close(g, w, at, window_s, rtol, skip, counts)

    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise AssertionError(f"{path}: keys differ")
        return max([close(got[k], want[k], f"{path}.{k}")
                    for k in want if k not in skip] + [0.0])
    if isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            raise AssertionError(f"{path}: lengths differ")
        return max([close(g, w, f"{path}[{i}]")
                    for i, (g, w) in enumerate(zip(got, want))] + [0.0])
    if isinstance(want, float):
        key = path.split(".")[-1].split("[")[0]
        if key in counts:
            tol = WINDOW_COUNT_ATOL / (window_s if key == "qps" else 1.0)
        else:
            tol = rtol * abs(want) + RESULT_ATOL
        if abs(got - want) > tol:
            raise AssertionError(f"{path}: {got} != {want}")
        return abs(got - want) / tol
    if got != want:
        raise AssertionError(f"{path}: {got!r} != {want!r}")
    return 0.0


def timeline_doc_close(got, want, compiled, tl, bound, path):
    """The timeline document's occupancy-derived entries (to_doc's
    utilization, queue depth and in-flight per service and window, and
    the peak utilization), card against CPU, within ``bound``
    (``occupancy_bound`` of the CPU's summary ``tl``) carried through
    to_doc's formulas, plus 1e-6 for the documents' rounding to 6
    digits."""
    atol, rtol = bound
    dt = float(tl.window_s)
    names = list(compiled.services.names)
    reps = np.asarray(compiled.services.replicas, np.float64)
    busy = tl.svc_busy_s.detach().cpu().double()
    inflight = tl.svc_inflight_s.detach().cpu().double()
    for name, w in want["services"].items():
        s = names.index(name)
        tb = (atol[s] + rtol * busy[s].abs()).numpy()
        ti = (atol[s] + rtol * inflight[s].abs()).numpy()
        util_tol = tb / (dt * max(float(reps[s]), 1.0)) + 1e-6
        tols = {"utilization": util_tol,
                "queue_depth": (tb + ti) / dt + 1e-6,
                "in_flight": ti / dt + 1e-6}
        g = got["services"][name]
        for key, tol in tols.items():
            diff = np.abs(np.subtract(g[key], w[key]))
            if (diff > tol).any():
                raise AssertionError(f"{path}.services.{name}.{key}: "
                                     f"{diff.max():.3g} off")
        if abs(g["peak_utilization"] - w["peak_utilization"]) > \
                util_tol.max():
            raise AssertionError(
                f"{path}.services.{name}.peak_utilization differs")


def perfetto_timeline_close(got, want, compiled, tl, bound):
    """``--timeline-perfetto`` documents, card against CPU: the same
    tracks at the same times; client qps and errors within
    WINDOW_COUNT_ATOL requests of a window, each service's utilization
    and queue depth within ``bound`` carried through their formulas (as
    ``timeline_doc_close``), plus the documents' rounding."""
    atol, rtol = bound
    dt = float(tl.window_s)
    names = list(compiled.services.names)
    reps = np.asarray(compiled.services.replicas, np.float64)
    busy = tl.svc_busy_s.detach().cpu().double()
    inflight = tl.svc_inflight_s.detach().cpu().double()
    ev_g, ev_w = got["traceEvents"], want["traceEvents"]
    if [(e["name"], e.get("ts")) for e in ev_g] != [
        (e["name"], e.get("ts")) for e in ev_w
    ]:
        raise AssertionError("timeline perfetto: tracks differ")
    worst = 0.0
    for g, w in zip(ev_g[1:], ev_w[1:]):
        name = w["name"]
        (key, v), = w["args"].items()
        w_idx = int(round(w["ts"] / (dt * 1e6)))
        if name.startswith("client"):
            tol = WINDOW_COUNT_ATOL / (dt if key == "qps" else 1.0)
        else:
            s = names.index(name.split(" ", 1)[1])
            tb = float(atol[s, w_idx] + rtol * busy[s, w_idx].abs())
            ti = float(atol[s, w_idx] + rtol * inflight[s, w_idx].abs())
            tol = (tb / (dt * max(float(reps[s]), 1.0)) if key ==
                   "utilization" else (tb + ti) / dt) + 1e-6
        diff = abs(g["args"][key] - v)
        worst = max(worst, diff / tol)
        if diff > tol:
            raise AssertionError(f"timeline perfetto {name} @{w['ts']}: "
                                 f"{g['args'][key]} != {v}")
    log(f"cli timeline perfetto: {len(ev_w)} counter events agree, card "
        f"against CPU, within {worst:.4f} of their tolerance")


@contextlib.contextmanager
def cli_capture(source):
    """Inside: the CLI's draw source (``TorchDraws``) is ``source``, so
    the card and the CPU run on the same draws, and every block that a
    recorded or protected run observes is kept as ``(carry, block)``."""
    import isotope_tpu_torch.sim as sim_pkg
    from isotope_tpu_torch.sim import engine

    kept = []
    observe = engine._BlockControl.observe

    def keep(carry, res, t_done):
        observe(carry, res, t_done)
        kept.append((carry, res))

    draws = sim_pkg.TorchDraws
    sim_pkg.TorchDraws = lambda seed, device: source
    engine._BlockControl.observe = keep
    try:
        yield kept
    finally:
        sim_pkg.TorchDraws = draws
        engine._BlockControl.observe = observe


def cli_protected_phase():
    """``simulate --timeline --timeline-out`` on canonical.yaml, and
    ``--policies --policies-out --rollouts --rollouts-out --timeline-out``
    on its protected variant, on the card and with ``--device cpu``,
    called in this process (``cli.main``) with one draw source on the
    CPU handed to both (``cli_capture``): the recorders' summaries agree
    as phase 4 holds them (``compare_timelines``), and so do the
    documents (``docs_close``, ``timeline_doc_close``)."""
    import io

    import yaml

    from isotope_tpu_torch import cli as port_cli
    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.sim import TorchDraws

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        topo = tmp / "canonical-protected.yaml"
        topo.write_text((TOPOLOGIES / "canonical.yaml").read_text()
                        + yaml.safe_dump(CLI_PROTECTED))
        cases = {
            "timeline": (TOPOLOGIES / "canonical.yaml",
                         ["--timeline", "1s"], ("timeline",)),
            "protected": (topo, ["--policies", "--rollouts"],
                          ("timeline", "policies", "rollouts")),
        }
        for case, (path, flags, outs) in cases.items():
            docs, kept = {}, {}
            for device in ("cuda", "cpu"):
                args = ["simulate", str(path), "--qps", "1000",
                        "--duration", "10s", "--load-kind", "open",
                        "--device", device, *flags]
                for o in outs:
                    args += [f"--{o}-out", str(tmp / f"{case}-{o}-{device}")]
                if case == "timeline":
                    args += ["--timeline-perfetto",
                             str(tmp / f"perfetto-{device}")]
                t = time.perf_counter()
                out = SimpleNamespace(stdout=io.StringIO(),
                                      stderr=io.StringIO())
                with contextlib.redirect_stdout(out.stdout), \
                        contextlib.redirect_stderr(out.stderr), \
                        cli_capture(TorchDraws(0, "cpu")) as blocks:
                    rc = port_cli.main(args)
                if rc != 0:
                    raise AssertionError(f"simulate {flags} on {device}")
                kept[device] = blocks
                out.stdout, out.stderr = (out.stdout.getvalue(),
                                          out.stderr.getvalue())
                doc = json.loads(out.stdout)
                # the Fortio document's histogram and durations move by
                # a bucket or a nanosecond with the last bits of a
                # latency: its counts and labels are compared
                docs[device] = {"fortio": {
                    k: doc[k] for k in ("Labels", "RequestedQPS",
                                        "RequestedDuration", "NumThreads",
                                        "RetCodes")
                } | {"Count": doc["DurationHistogram"]["Count"]}}
                for o in outs:
                    docs[device][o] = json.loads(
                        (tmp / f"{case}-{o}-{device}").read_text())
                log(f"cli simulate {' '.join(flags)} on {device}: "
                    f"{docs[device]['fortio']['Count']}"
                    f" requests, {time.perf_counter() - t:.1f} s; stderr "
                    + " | ".join(out.stderr.splitlines()[:3]))
            card, cpu = kept["cuda"], kept["cpu"]
            if not cpu or len(card) != len(cpu):
                raise AssertionError(f"cli {case}: blocks differ")
            gap = max(event_time_gap(g, w) for (_, g), (_, w)
                      in zip(card, cpu))
            lat_max = max(float(w.client_latency.max()) for _, w in cpu)
            tl = cpu[-1][0].tl_acc
            occ, tight = compare_timelines(card[-1][0].tl_acc, tl,
                                           f"cli {case} timeline", lat_max,
                                           gap, len(cpu))
            for key, want in docs["cpu"].items():
                docs_close(docs["cuda"][key], want, f"{case}.{key}",
                           window_s=want.get("window_s", 1.0))
            compiled = compile_graph(ServiceGraph.from_yaml_file(str(path)))
            bound = occupancy_bound(tl, gap, len(cpu))
            timeline_doc_close(
                docs["cuda"]["timeline"], docs["cpu"]["timeline"],
                compiled, tl, bound, f"{case}.timeline")
            if case == "timeline":
                perfetto_timeline_close(
                    *(json.loads((tmp / f"perfetto-{d}").read_text())
                      for d in ("cuda", "cpu")), compiled, tl, bound)
            extra = ""
            if "rollouts" in docs["cpu"]:
                r = docs["cpu"]["rollouts"]["services"]["b"]
                p = docs["cpu"]["policies"]["services"]
                extra = (f"; rollout b {r['state']} (promotions "
                         f"{r['promotions']:g}), scale events "
                         f"{sum(v['scale_events'] for v in p.values()):g}")
            log(f"cli {case}: documents {sorted(docs['cpu'])} agree, card "
                f"against CPU; occupancy within {occ:.4f} of its bound "
                f"(median bound {tight:.4f} of a busy integral, event-time"
                f" gap {gap:.3e} s)" + extra)


# -- attribution: phases 4, 5 and 6 -------------------------------------------

#: the telescoping check of an attributed run: the charges plus the
#: residual sum to the client latency within float32 accumulation
TELESCOPE_RTOL = 1e-5
#: float32 spacings of a run's latency sum that the residuals (rounding
#: noise of each request's sum of up to 2H + 1 charges) may differ by,
#: card against CPU on the same results
RESID_ULPS = 16
#: whole attributed runs, card against CPU (each on its own results): a
#: winner whose duration ties another's within float32 spacings may
#: flip, so the crit counts may move by this share of their total
CRIT_FLIP_SHARE = 1e-4


def _cpu(res):
    """A SimResults (or any tuple of tensors) on the CPU."""
    return type(res)(*(
        x.cpu() if isinstance(x, torch.Tensor) else x for x in res
    ))


def compare_attribution(got, want, what, latency_sum):
    """Two AttributionSummaries of the same results: counts and blame
    histograms equal, seconds within the engine's tolerance, the
    residuals within RESID_ULPS spacings of ``latency_sum``.  Returns
    the largest seconds difference as a share of its tolerance."""
    for name in ("count", "tail_count", "crit_count", "error_count",
                 "tail_crit_count", "hist", "tail_hist"):
        _same(getattr(got, name), getattr(want, name), f"{what} {name}")
    worst = 0.0
    for name in ("wait_blame", "self_blame", "net_blame", "timeout_blame",
                 "tail_wait_blame", "tail_self_blame", "tail_net_blame",
                 "tail_timeout_blame"):
        a = getattr(got, name).detach().cpu().double()
        b = getattr(want, name).detach().cpu().double()
        _same(a, b, f"{what} {name}", rtol=RESULT_RTOL, atol=RESULT_ATOL)
        if a.numel():
            worst = max(worst, float(((a - b).abs() / (
                RESULT_ATOL + RESULT_RTOL * b.abs())).max()))
    bound = RESID_ULPS * float(np.spacing(np.float32(latency_sum)))
    for name in ("residual", "residual_abs"):
        d = abs(float(getattr(got, name)) - float(getattr(want, name)))
        if d > bound:
            raise AssertionError(f"{what} {name}: {d:.3e} s > {bound:.3e}")
    return worst


def compare_exemplars(got, want, what):
    for name, a in got._asdict().items():
        _same(a, getattr(want, name), f"{what} exemplars {name}")


def blame_launches(what, before, expected):
    """``expected`` blame_sweep launches since ``before``."""
    from isotope_tpu_torch.native import blame

    got = blame.blame_sweep.launches - before
    if got != expected:
        raise AssertionError(f"{what}: {got} blame_sweep launches, "
                             f"expected {expected}")


def same_blame_bits(got, want, what):
    """Two AttributionSummaries of one block equal bit for bit (floats
    as their bits; a zero's sign aside)."""
    for name, a in got._replace(exemplars=None)._asdict().items():
        b = getattr(want, name)
        if a is None:
            continue
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{what} {name}: the kernel differs from "
                                 "blame_sweep_sequential")


class AttributedBlocks:
    """Phase 4's attribution check of one run: each card block attributed
    on the card and, moved to the CPU, by the CPU's sweep: the same
    results, so the same answer (``compare_attribution``)."""

    def __init__(self, port, sim, what, tail_cut=None):
        from isotope_tpu_torch.metrics import attribution

        self.attr = attribution
        self.what, self.cut = what, tail_cut
        self.k = sim.params.attribution_top_k
        self.tables = {
            dev: attribution.build_tables(sim.compiled, sim.params.network,
                                          dev)
            for dev in ("cuda", "cpu")
        }
        self.ex = {"cuda": None, "cpu": None}
        self.blocks, self.worst, self.crit = 0, 0.0, 0
        self.acc, self.latency_sum = None, 0.0

    def block(self, res):
        from isotope_tpu_torch.native import blame

        out = {}
        before = blame.blame_sweep.launches
        for dev, r in (("cuda", res), ("cpu", _cpu(res))):
            out[dev], self.ex[dev] = self.attr.attribute_block(
                r, self.tables[dev], tail_cut=self.cut, top_k=self.k,
                ex_state=self.ex[dev],
            )
        blame_launches(f"{self.what} block {self.blocks}", before, 1)
        same_blame_bits(out["cuda"], self.attr.blame_sweep_sequential(
            res, self.tables["cuda"], tail_cut=self.cut),
            f"{self.what} block {self.blocks}")
        self.acc = self.attr.accumulate(self.acc, out["cuda"])
        self.latency_sum += float(res.client_latency.sum())
        self.worst = max(self.worst, compare_attribution(
            out["cuda"], out["cpu"], f"{self.what} block {self.blocks}",
            float(res.client_latency.sum())))
        self.blocks += 1
        self.crit += int(out["cpu"].crit_count.sum())

    def finish(self):
        compare_exemplars(self.ex["cuda"], self.ex["cpu"], self.what)
        log(f"in situ ok {self.what}: {self.blocks} block(s) attributed on "
            f"the card (one blame_sweep launch each, bit for bit its "
            f"sequential twin's) and by the CPU's sweep on the card's results: "
            f"counts and blame histograms equal ({self.crit} crit-path "
            f"hops), seconds within {self.worst:.3f} of rtol "
            f"{RESULT_RTOL:g} / atol {RESULT_ATOL:g} s, residuals within "
            f"{RESID_ULPS} float32 spacings of the latency sum, "
            f"exemplars equal" + (
                "" if self.cut is None else f" (tail cut {self.cut:.6g} s)"
            ))

    def same_run(self, attr):
        """The run's own AttributionSummary (an entry point's, on the
        card) equals the card's blocks attributed one by one."""
        compare_attribution(attr, self.acc, f"{self.what} run",
                            self.latency_sum)
        compare_exemplars(attr.exemplars, self.ex["cuda"], self.what)
        log(f"in situ ok {self.what}: the entry point's attribution equals"
            f" the card's blocks attributed one by one (tail requests "
            f"{int(attr.tail_count)} of {int(attr.count)})")


def attribution_in_situ(port, cases):
    """Phase 4 for attributed runs.  ``cases``: (name, make, load,
    requests, block, tail), ``make(device)`` building the attributed
    Simulator.  Each block of the card's run is attributed on the card
    and on the CPU (``AttributedBlocks``); then the whole attributed run
    on the card is held against the CPU's (each on its own results):
    the summary's counts exactly and sums at the engine's tolerance, the
    requests attributed and tail requests exactly, the total blame at
    TELESCOPE_RTOL, the crit counts within CRIT_FLIP_SHARE."""
    for name, make, load, n, block, tail in cases:
        source = port.TorchDraws(11, "cuda")
        card, cpu = make("cuda"), make("cpu")
        cut = (card.estimate_tail_cut(load, n, source, block_size=block)
               if tail else None)
        check = AttributedBlocks(port, card, f"attributed {name}", cut)
        for res in card.run_blocks(load, n, source, block_size=block):
            check.block(res)
        check.finish()
        from isotope_tpu_torch.native import blame

        before = blame.blame_sweep.launches
        s_a, a_a = card.run_attributed(load, n, source, block_size=block,
                                       tail=tail, tail_cut=cut)
        blame_launches(f"attributed {name}", before, -(-n // block))
        s_b, a_b = cpu.run_attributed(load, n, source, block_size=block,
                                      tail=tail, tail_cut=cut)
        for f in ("count", "error_count", "hop_events"):
            _same(getattr(s_a, f), getattr(s_b, f), f"{name} summary {f}")
        _same(s_a.latency_sum, s_b.latency_sum, f"{name} latency_sum",
              rtol=RESULT_RTOL)
        _same(a_a.count, a_b.count, f"{name} attributed count")
        if abs(a_a.total_blame_s / a_b.total_blame_s - 1.0) > (
            TELESCOPE_RTOL
        ):
            raise AssertionError(f"{name}: total blame differs")
        moved = int((a_a.crit_count.cpu() - a_b.crit_count.cpu()).abs().sum())
        total = int(a_b.crit_count.sum())
        if moved > CRIT_FLIP_SHARE * total:
            raise AssertionError(f"{name}: {moved} crit counts moved")
        log(f"in situ ok attributed {name}: whole run card against CPU, "
            f"summaries agree, total blame {a_a.total_blame_s:.6g} / "
            f"{a_b.total_blame_s:.6g} s, tail requests "
            f"{int(a_a.tail_count)} / {int(a_b.tail_count)}, {moved} of "
            f"{total} crit counts moved (winner ties)")


def attributed_params(sim, **kw):
    return dataclasses.replace(sim.params, attribution=True, **kw)


def ops_per_block(run, block):
    """Torch ops (launches, the census's aside) of one block of ``run``
    (counted with ``tools/torch_op_count.OpLog`` over two blocks after
    one to fill the caches)."""
    from tools.torch_op_count import OpLog

    run(block)
    with OpLog() as ops:
        run(2 * block)
    return ops.count / 2


def attributed_phase(port, runs, walls, op_block=64):
    """Phase 5 for attributed runs: each at full size after a warm-up
    block, with its wall per block beside its unattributed twin's
    (``walls``, from the same phase), its torch ops a block beside the
    twin's (counted on the card at blocks of ``op_block``), its peak
    device memory, its census launches, and the telescoping check (the
    charges plus the residual equal the latency sum within
    TELESCOPE_RTOL).  ``runs``: (name, twin name, Simulator, load,
    requests, block, mode, window) with mode "mean" or "tail" and window
    the protected run's (None: ``run_attributed``).  Returns the census
    launches per run."""
    launches = {}
    for name, twin, sim, load, n, block, mode, window in runs:
        tail = mode == "tail"
        src = port.TorchDraws(0, "cuda")
        if window is None:
            def plain(m, b):
                return sim.run_summary(load, m, src, block_size=b)

            def attributed(m, b, cut, trim=False):
                return sim.run_attributed(load, m, src, block_size=b,
                                          trim=trim, tail=tail,
                                          tail_cut=cut)
        else:
            def plain(m, b):
                return sim.run_policies(load, m, src, block_size=b,
                                        window_s=1e3)

            def attributed(m, b, cut, trim=False):
                out = sim.run_policies(load, m, src, block_size=b,
                                       trim=trim, window_s=window,
                                       attribution=True, tail=tail,
                                       tail_cut=cut)
                return out[0], out[-1]
        attributed(block, block, None)  # warm-up block, mean only
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        port.census.launches = 0
        from isotope_tpu_torch.native import blame

        sweeps = blame.blame_sweep.launches
        t0 = time.perf_counter()
        cut = (sim.estimate_tail_cut(load, n, src, block_size=block)
               if tail else None)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        summary, attr = attributed(n, block, cut, trim=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated() / 2**30
        blocks = max(1, -(-n // block))
        blame_launches(f"{name} attributed", sweeps, blocks)
        per_block = len(census_calls(sim, block))
        pilot_n = min(n, 8_192)
        pilot = (-(-pilot_n // min(block, pilot_n))
                 if load.kind == "open" else 1) if tail else 0
        launches[f"{name} attributed"] = port.census.launches
        if port.census.launches != (blocks + pilot) * per_block:
            raise AssertionError(
                f"{name} attributed: {port.census.launches} census "
                f"launches, expected ({blocks} + {pilot}) x {per_block}")
        lat = float(summary.latency_sum)
        total = attr.total_blame_s + float(attr.residual)
        if abs(total / lat - 1.0) > TELESCOPE_RTOL:
            raise AssertionError(
                f"{name} attributed: charges + residual {total} != "
                f"latency sum {lat}")
        if int(attr.count) != int(summary.count) or (
            int(attr.hist.sum()) != int(attr.crit_count.sum())
        ):
            raise AssertionError(f"{name} attributed: counts")
        plain_ops = ops_per_block(lambda m: plain(m, op_block), op_block)
        attr_ops = ops_per_block(lambda m: attributed(m, op_block, cut),
                                 op_block)
        wall = (t2 - t1) / blocks
        top = f", top-K {sim.params.attribution_top_k}" if tail else ""
        log(f"attributed {name} ({mode}{top}): {int(summary.count)} "
            f"requests in {blocks} blocks of {block}, {wall * 1e3:.2f} ms "
            f"per block against {walls[twin] * 1e3:.2f} unattributed "
            f"({wall / walls[twin]:.3f}x)"
            + (f", tail pilot {(t1 - t0) * 1e3:.1f} ms" if tail else "")
            + f"; torch ops a block {attr_ops:g} against {plain_ops:g} "
            f"(+{attr_ops - plain_ops:g}); peak device memory {peak:.3f} "
            f"GiB; census launches {launches[f'{name} attributed']} "
            f"(({blocks} + "
            f"{pilot} pilot) x {per_block}); charges + residual "
            f"{total:.9g} s against the latency sum {lat:.9g} s "
            f"({total / lat - 1.0:+.3e}); residual "
            f"{float(attr.residual_abs) / int(attr.count) * 1e9:.4f} ns a "
            f"request; crit-path hops {int(attr.crit_count.sum())}"
            + ("" if not tail else
               f"; tail cut {float(attr.tail_cut) * 1e3:.4f} ms, "
               f"{int(attr.tail_count)} requests past it, slowest exemplar"
               f" {float(attr.exemplars.latency[0]) * 1e3:.4f} ms"))
    return launches


def attr_docs_close(got, want, path=""):
    """Attribution documents (blame tables, traces, counter tracks),
    card against CPU, each side from its own results: keys, strings and
    booleans exactly; integer microseconds within one plus DOC_RTOL; the
    per-request residuals (float32 rounding noise) within RESULT_ATOL;
    other floats within DOC_RTOL; a perfetto document's ``blame dist``
    tracks through ``blame_dist_close``."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise AssertionError(f"{path}: keys differ")
        if "traceEvents" in want and any(
            str(e.get("name", "")).startswith("blame dist ")
            for e in want["traceEvents"]
        ):
            blame_dist_close(got["traceEvents"], want["traceEvents"], path)
            got = dict(got, traceEvents=[
                e for e in got["traceEvents"]
                if not e["name"].startswith("blame dist ")])
            want = dict(want, traceEvents=[
                e for e in want["traceEvents"]
                if not e["name"].startswith("blame dist ")])
        for k in want:
            attr_docs_close(got[k], want[k], f"{path}.{k}")
        return
    if isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            raise AssertionError(f"{path}: lengths differ")
        for i, (g, w) in enumerate(zip(got, want)):
            attr_docs_close(g, w, f"{path}[{i}]")
        return
    if isinstance(want, bool) or isinstance(want, str) or want is None:
        if got != want:
            raise AssertionError(f"{path}: {got!r} != {want!r}")
        return
    if isinstance(want, int):
        if abs(got - want) > 1 + DOC_RTOL * abs(want):
            raise AssertionError(f"{path}: {got} != {want}")
        return
    tol = (RESULT_ATOL if "residual" in path
           else DOC_RTOL * abs(want) + RESULT_ATOL)
    if abs(got - want) > tol:
        raise AssertionError(f"{path}: {got} != {want}")


def blame_dist_close(got, want, path):
    """The per-service blame histograms of two perfetto documents: each
    service's total equal, counts moved only to an adjacent bucket, at
    most a thousandth of them (the float32 log of the JAX package aside,
    the card and the CPU bucket the same float64 log of each side's own
    contributions: a contribution within its float32 difference of an
    edge lands one bucket over)."""
    def hists(events):
        out = {}
        for e in events:
            if e["name"].startswith("blame dist "):
                out.setdefault(e["name"], {})[e["ts"]] = e["args"][
                    "requests"]
        return out

    g, w = hists(got), hists(want)
    if set(g) != set(w):
        raise AssertionError(f"{path}: blame dist tracks differ")
    moved = total = 0.0
    for name in w:
        ts = sorted(set(g[name]) | set(w[name]))
        d = np.array([g[name].get(t, 0.0) - w[name].get(t, 0.0)
                      for t in ts])
        emd = float(np.abs(np.cumsum(d)).sum())
        if abs(d.sum()) > 0 or 2 * emd != float(np.abs(d).sum()):
            raise AssertionError(f"{path}: {name} moved off its neighbours")
        moved += emd
        total += sum(w[name].values())
    if moved > 1e-3 * max(total, 1.0):
        raise AssertionError(f"{path}: {moved} of {total} blame counts moved")


def _in_process(args, source):
    """``cli.main(args)`` in this process with ``source`` as its draws:
    (exit code, stdout, stderr, kept blocks)."""
    with cli_capture(source) as blocks:
        rc, out, err = _port_out(args)
    return rc, out, err, blocks


def cli_attribution_phase():
    """``simulate --attribution tail --blame-out --flamegraph
    --perfetto-blame --exemplar-trace`` and ``simulate --trace`` in both
    formats on canonical.yaml, and ``timeline --controlplane 100:10:500
    --alarms`` on it, each on the card and with ``--device cpu`` in this
    process on one draw source on the CPU (``cli_capture``; the push's
    normals drawn on the CPU for both): the documents agree
    (``attr_docs_close``, ``docs_close``), and so do the exit codes and
    the alarm onsets."""
    from isotope_tpu_torch.sim import TorchDraws
    from isotope_tpu_torch.sim import controlplane

    canonical = str(TOPOLOGIES / "canonical.yaml")
    base = ["--qps", "1000", "--duration", "10s", "--load-kind", "open"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        cases = {
            "attribution": (["simulate", canonical, *base, "--attribution",
                             "tail"],
                            ("blame-out", "flamegraph", "perfetto-blame",
                             "exemplar-trace")),
            "trace chrome": (["simulate", canonical, *base,
                              "--trace-format", "chrome"], ("trace",)),
            "trace jaeger": (["simulate", canonical, *base,
                              "--trace-format", "jaeger"], ("trace",)),
        }
        for case, (args, files) in cases.items():
            docs = {}
            for device in ("cuda", "cpu"):
                argv = list(args) + ["--device", device]
                for f in files:
                    argv += [f"--{f}", str(tmp / f"{case}-{f}-{device}")]
                t = time.perf_counter()
                rc, _, err, _ = _in_process(argv, TorchDraws(0, "cpu"))
                if rc != 0:
                    raise AssertionError(f"cli {case} on {device}: {err}")
                docs[device] = {}
                for f in files:
                    text = (tmp / f"{case}-{f}-{device}").read_text()
                    docs[device][f] = (
                        text if f == "flamegraph" else json.loads(text))
                log(f"cli {case} on {device}: {time.perf_counter() - t:.1f}"
                    f" s; stderr " + " | ".join(err.splitlines()[:4]))
            for f in files:
                got, want = docs["cuda"][f], docs["cpu"][f]
                if f == "flamegraph":
                    got, want = (
                        {ln.rpartition(" ")[0]: int(ln.rpartition(" ")[2])
                         for ln in x.splitlines()} for x in (got, want))
                attr_docs_close(got, want, f"cli {case} {f}")
            log(f"cli {case}: documents {list(files)} agree, card against "
                f"CPU")

        # the timeline command with the control-plane projection and
        # the per-window alarms
        normals = controlplane.push_normals
        controlplane.push_normals = (
            lambda p, seed, device: normals(p, seed, "cpu").to(device))
        try:
            docs = {}
            for device in ("cuda", "cpu"):
                sink = tmp / f"sink-{device}.jsonl"
                argv = ["timeline", canonical, "--qps", "1000",
                        "--duration", "10s", "--window", "1s",
                        "--controlplane", "100:10:500", "--alarms",
                        "--alarm-sink", str(sink), "--json", "--device",
                        device]
                t = time.perf_counter()
                rc, out, err, kept = _in_process(argv, TorchDraws(0, "cpu"))
                onset = [line for line in err.splitlines()
                         if line.startswith(("ALARM onset", "alarms:"))]
                rows = [json.loads(line) for line in
                        sink.read_text().splitlines()]
                docs[device] = (rc, json.loads(out), onset, rows)
                log(f"cli timeline --controlplane --alarms on {device}: exit"
                    f" {rc}, {time.perf_counter() - t:.1f} s; "
                    + " | ".join(onset))
        finally:
            controlplane.push_normals = normals
        (rc_a, doc_a, on_a, rows_a), (rc_b, doc_b, on_b, rows_b) = (
            docs["cuda"], docs["cpu"])
        cp_a, cp_b = doc_a.pop("controlplane"), doc_b.pop("controlplane")
        if rc_a != rc_b or [o.split(" = ")[0] for o in on_a] != [
            o.split(" = ")[0] for o in on_b
        ] or [(r["monitor"], r["status"], r["window_index"]) for r in rows_a
              ] != [(r["monitor"], r["status"], r["window_index"])
                    for r in rows_b]:
            raise AssertionError(f"cli timeline alarms: {on_a} / {on_b}")
        if cp_a["proxies"] != 500 or cp_a["converged_window"] != cp_b[
            "converged_window"
        ] or max(abs(a - b) for a, b in zip(cp_a["acks"], cp_b["acks"])) > (
            WINDOW_COUNT_ATOL
        ):
            raise AssertionError(f"cli timeline controlplane: {cp_a} {cp_b}")
        docs_close(doc_a, doc_b, "cli timeline", window_s=1.0)
        log(f"cli timeline: documents, control-plane projection (push "
            f"converged in window {cp_a['converged_window']}, acks "
            f"{cp_a['acks'][:3]}...) and {len(rows_a)} monitor rows agree, "
            f"card against CPU; exit code {rc_a}")


# -- fleets: phases 3, 4, 5 and 6 ---------------------------------------------

#: the reference bench's ensembleN (bench.py:483-556):
#: 1000-svc_2000-end.yaml open loop at 10,000 qps, 32 seed members of
#: 8,192 requests, block 8,192; the observed twin at 8 members
ENS_MEMBERS, ENS_N, ENS_QPS = 32, 8_192, 10_000.0
ENS_OBSERVED = 8
#: svc1000-chaosfleet (bench.py:693-745): the same graph with a 25%
#: retry budget, one replica of services.names[1] down in
#: [0.05 s, 0.25 s), jittered per member; 8 members x 8,192 requests in
#: blocks of 4,096, 50 ms windows
CHAOSFLEET = dict(members=8, n=8_192, block=4_096, window_s=0.05,
                  qps=10_000.0, kill=(0.05, 0.25),
                  jitter=dict(time=0.3, magnitude=0.5, seed=0))
#: a fleet's latency histograms card against CPU (or folded against
#: member by member on the card, whose float64 clock scans associate
#: per shape): the share of counts that may move to an adjacent bucket
HIST_MOVED = 1e-3
#: phase 4's small fleets (card against CPU)
FLEET_JITTER = "qps=0.1,cpu=0.05,error=0.2"
FLEET_SMALL = dict(members=4, n=4_096, block=2_048)


def ensemble_sim(runs):
    """ensembleN's Simulator: the main path's 1000-svc one."""
    return [r[1] for r in runs if r[0] == "1000-svc_2000-end"][0]


def chaosfleet_sim(port, device="cuda"):
    """svc1000-chaosfleet's Simulator (the reference bench's)."""
    import yaml

    doc = yaml.safe_load((TOPOLOGIES / "1000-svc_2000-end.yaml").read_text())
    doc.setdefault("policies", {})["defaults"] = {
        "retry_budget": {"budget_percent": "25%"},
    }
    graph = port.ServiceGraph.decode(doc)
    compiled = port.compile_graph(graph)
    lo, hi = CHAOSFLEET["kill"]
    chaos = (port.ChaosEvent(compiled.services.names[1], lo, hi,
                             replicas_down=1),)
    return port.Simulator(compiled, port.SimParams(timeline=True), chaos,
                          policies=port.compile_policies(graph, compiled),
                          device=device)


def fleet_census_runs(runs, chaos_sim):
    """The fleets' census calls for phase 3, as runs: ensembleN folded
    (one call a level of 32 x 8,192 rows); svc1000-chaosfleet's members
    at their solo shapes (block 4,096, protected: the map twin's) and
    folded (8 x 4,096 rows with fail steps and error flags: the fleet,
    its observed twin and the splitting levels); ensembleN-observed
    folded (8 x 8,192)."""
    open_load = SimpleNamespace(kind="open", qps=ENS_QPS)
    m, block = CHAOSFLEET["members"], CHAOSFLEET["block"]
    return [
        (f"ensembleN ({ENS_MEMBERS} folded)", ensemble_sim(runs),
         open_load, ENS_MEMBERS * ENS_N, ENS_MEMBERS * ENS_N),
        ("svc1000-chaosfleet", chaos_sim, open_load, CHAOSFLEET["n"],
         block),
        (f"svc1000-chaosfleet ({m} folded)", chaos_sim, open_load,
         m * block, m * block),
        (f"ensembleN-observed ({ENS_OBSERVED} folded)", ensemble_sim(runs),
         open_load, ENS_OBSERVED * ENS_N, ENS_OBSERVED * ENS_N),
    ]


def fleet_pilot_shapes(port, runs, chaos_sim, storm, device="cuda"):
    """The census shapes of the folded pilots the fleets' auto chunks
    are sized from (``analysis/costmodel.fleet_member_bytes``: one
    member's blocks of the pilot sizes, 8 and 16 requests, a closed
    loop's one and two per connection), for phase 3: ensembleN's graph
    open and at 64 connections, svc1000-chaosfleet's and the storm's
    protected, and phase 4's census-test graph open and at 16
    connections."""
    census_sim = port.Simulator(port.compile_graph(
        port.ServiceGraph.from_yaml(CENSUS_YAML)), device=device)
    shapes = []
    for sim, sizes in ((ensemble_sim(runs), (8, 16, 64, 128)),
                       (census_sim, (8, 16, 32))):
        for n in sizes:
            shapes += sim.census_shapes(n)
    for sim in (chaos_sim, storm):
        for n in (8, 16):
            shapes += census_calls(sim, n)
    return list(dict.fromkeys(shapes))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def hist_band(got, want, what):
    """Two stacks of latency histograms of the same requests whose
    latencies agree within float32 rounding: each member's total
    exactly, and a count moves only to an adjacent bucket (a latency
    within a spacing of a bucket edge), at most HIST_MOVED of them."""
    g = _np(got).astype(np.int64)
    w = _np(want).astype(np.int64)
    if g.shape != w.shape or not np.array_equal(g.sum(-1), w.sum(-1)):
        raise AssertionError(f"{what}: totals differ")
    d = g - w
    emd = np.abs(np.cumsum(d, axis=-1)).sum()
    if 2 * emd != np.abs(d).sum() or emd > HIST_MOVED * max(w.sum(), 1):
        raise AssertionError(f"{what}: {emd} counts moved")
    return int(emd)


def compare_fleets(got, want, what, rtol=RESULT_RTOL, atol=RESULT_ATOL):
    """Two member-stacked summaries: counts and hop events exactly, the
    latency histograms within ``hist_band``, float sums within ``rtol``
    / ``atol``; returns the counts moved a bucket over."""
    for f in ("count", "error_count", "hop_events", "win_count",
              "win_error_count", "unstable"):
        if not np.array_equal(_np(getattr(got, f)), _np(getattr(want, f))):
            raise AssertionError(f"{what}: {f} differs")
    moved = hist_band(got.latency_hist, want.latency_hist,
                      f"{what}: latency_hist")
    moved += hist_band(got.win_latency_hist, want.win_latency_hist,
                       f"{what}: win_latency_hist")
    for f in ("latency_sum", "latency_m2", "latency_min", "latency_max",
              "end_max", "utilization"):
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   _np(getattr(want, f)), rtol=rtol,
                                   atol=atol, err_msg=f"{what}: {f}")
    return moved


def fleet_in_situ(port):
    """Phase 4 for the fleets, with the same draws on the card and on the
    CPU: (a) a small jittered plain fleet, open and paced, folded
    (``"vmap"``) and member by member (``"map"``) on the card against
    the CPU's ``"map"`` fleet; (b) a chaos fleet (per-member jittered
    outage) on the card against the CPU's; (c) a protected fleet's
    member under its own jittered schedule: on the card it equals the
    card's solo run of its schedule bit for bit, and that run is held
    block by block against the CPU's under the card's control effects
    (``protected_in_situ``); (d) an observed fleet's per-member blame:
    each member's blocks attributed on the card and by the CPU's sweep
    on the card's results (``AttributedBlocks``), and the fleet's
    stacked attribution equal to the card's blocks attributed one by
    one."""
    from isotope_tpu_torch.resilience.faults import ChaosJitterSpec
    from isotope_tpu_torch.sim.draws import RootedSource
    from isotope_tpu_torch.sim.ensemble import (
        EnsembleSpec,
        parse_jitter_spec,
    )

    graph = port.ServiceGraph.from_yaml(CENSUS_YAML)
    compiled = port.compile_graph(graph)
    m, n, block = (FLEET_SMALL[k] for k in ("members", "n", "block"))
    jitter = parse_jitter_spec(FLEET_JITTER)
    for load in (port.LoadModel(kind="open", qps=500.0),
                 port.LoadModel(kind="closed", qps=400.0, connections=16)):
        card, cpu = (port.Simulator(compiled, device=d)
                     for d in ("cuda", "cpu"))
        source = port.TorchDraws(11, "cuda")
        fleets = {}
        for side, sim, mode in (("card vmap", card, "vmap"),
                                ("card map", card, "map"),
                                ("cpu map", cpu, "map")):
            spec = EnsembleSpec.from_jitter(m, mode=mode, **jitter)
            before = port.census.launches
            fleets[side] = sim.run_ensemble(load, n, source, spec,
                                            block_size=block, trim=True)
            torch.cuda.synchronize()
            if sim is card and port.census.launches == before:
                raise AssertionError(f"fleet {side}: kernel never launched")
        calls = len(card.census_shapes(block, members=m))
        moved = [compare_fleets(fleets[side].summaries,
                                fleets["cpu map"].summaries,
                                f"fleet {load.kind} {side} against cpu map")
                 for side in ("card vmap", "card map")]
        log(f"in situ ok fleet {load.kind} ({m} jittered members x {n}, "
            f"block {block}): card vmap (one census call of "
            f"{m * block} rows a level, {calls} a block) and card map == "
            f"cpu map: counts and hop events equal, histograms within one "
            f"bucket ({moved[0]} / {moved[1]} counts moved), float sums "
            f"within rtol {RESULT_RTOL:g}")

    # (b) a chaos fleet: leaf's outage jittered per member
    chaos = (port.ChaosEvent("leaf", 0.5, 2.0, replicas_down=None),)
    spec = EnsembleSpec.of(2)
    jit = ChaosJitterSpec(time=0.3, seed=5)
    load = port.LoadModel(kind="open", qps=500.0)
    source = port.TorchDraws(12, "cuda")
    card, cpu = (port.Simulator(compiled, chaos=chaos, device=d)
                 for d in ("cuda", "cpu"))
    got, want = (sim.run_ensemble(load, n, source, spec, block_size=block,
                                  member_chaos=jit) for sim in (card, cpu))
    moved = compare_fleets(got.summaries, want.summaries, "chaos fleet")
    if got.member_chaos != want.member_chaos or \
            got.member_chaos[0] == got.member_chaos[1]:
        raise AssertionError("chaos fleet: member schedules")
    log(f"in situ ok chaos fleet (leaf down, jittered per member: "
        f"{[(e.start_s, e.end_s) for ev in got.member_chaos for e in ev]})"
        f": card == cpu, {int(_np(got.summaries.error_count).sum())} "
        f"client errors, {moved} histogram counts moved a bucket")

    # (c) a protected fleet's member under its own jittered schedule
    pgraph = port.ServiceGraph.from_yaml(SMOKE_TOPOLOGY)
    pcomp = port.compile_graph(pgraph)
    pol = port.compile_policies(pgraph, pcomp)
    params = port.SimParams(timeline=True, timeline_window_s=1.0)
    kill = (port.ChaosEvent(**{**SMOKE_KILL, "start_s": 0.05,
                               "end_s": 0.15}),)
    psim = port.Simulator(pcomp, params, kill, policies=pol, device="cuda")
    pload = port.LoadModel(kind="open", qps=SMOKE_QPS)
    pn, pblock, pwin = 8_192, 1_024, 0.02
    source = port.TorchDraws(13, "cuda")
    fleet = psim.run_policies_ensemble(
        pload, pn, source, EnsembleSpec.of(2, mode="map"),
        block_size=pblock, window_s=pwin,
        member_chaos=ChaosJitterSpec(time=0.3, seed=2),
    )
    events = fleet.member_chaos[1]

    def make(device):
        return port.Simulator(pcomp, params, events, policies=pol,
                              device=device)

    member_src = RootedSource(source, 1)
    solo = make("cuda").run_policies(pload, pn, member_src,
                                     block_size=pblock, window_s=pwin)
    for f in solo[0]._fields:
        if f != "metrics":
            _same(getattr(fleet.member(1), f), getattr(solo[0], f),
                  f"protected fleet member 1 {f}")
    for a, b in ((fleet.member_timeline(1), solo[1]),
                 (fleet.member_policies(1), solo[2])):
        for f in a._fields:
            _same(getattr(a, f), getattr(b, f), f"protected member {f}")
    log("in situ ok protected fleet: member 1 (its own jittered kill "
        f"{[(e.start_s, e.end_s, e.replicas_down) for e in events]}) == "
        "the card's solo run_policies of its schedule, bit for bit")
    protected_in_situ(port, [("protected fleet member 1", None, pload, pn,
                              pblock, pwin, False, make)],
                      source=member_src)

    # (d) an observed fleet's per-member blame
    asim = port.Simulator(compiled, port.SimParams(attribution=True,
                                                   timeline=True),
                          device="cuda")
    source = port.TorchDraws(14, "cuda")
    obs = asim.run_ensemble(load, n, source, EnsembleSpec.of(2, mode="map"),
                            block_size=block, attribution=True,
                            timeline=True, window_s=1.0)
    for k in range(2):
        check = AttributedBlocks(port, asim, f"observed fleet member {k}")
        for res in asim.run_blocks(load, n, RootedSource(source, k),
                                   block_size=block):
            check.block(res)
        check.finish()
        check.same_run(obs.member_attribution(k))
    folded_in_situ(port, compiled, psim, pload, pn, pblock, pwin)


def compare_folded(got, want, what, rtol=RESULT_RTOL, atol=RESULT_ATOL,
                   cross=False):
    """A folded fleet against its ``"map"`` twin by the folded contract:
    the summaries by ``compare_fleets``; the recorder's, the laws' and
    the blame's counts exactly (the recorder bins integers; a blame
    histogram within ``hist_band``), their float series within ``rtol``
    / ``atol``.  ``cross``: the card against the CPU (clocks rounded on
    another device), phase 4's tolerances: the recorder's window counts
    as ``_same_counts`` (an event within a spacing of a window edge
    lands on either side), its seconds and the laws' continuous series
    (the breaker's shed, the budget's allow) at ``SHED_RTOL`` of the
    occupancy they read; trips, actuations and blame counts exactly.
    Returns the histogram counts moved a bucket over."""
    moved = compare_fleets(got.summaries, want.summaries, what, rtol, atol)
    for name in ("timelines", "policies", "rollouts", "attributions"):
        a, b = getattr(got, name), getattr(want, name)
        if (a is None) != (b is None):
            raise AssertionError(f"{what}: {name} present on one side")
        if a is None:
            continue
        for f in a._fields:
            x, y = getattr(a, f), getattr(b, f)
            if x is None or isinstance(x, tuple):
                continue
            if name == "attributions" and f in ("residual",
                                                "residual_abs"):
                # float32 sums of the members' latencies minus their
                # charges: RESID_ULPS spacings of each latency sum
                bound = RESID_ULPS * np.spacing(
                    _np(want.summaries.latency_sum).astype(np.float32))
                if (np.abs(_np(x) - _np(y)) > bound).any():
                    raise AssertionError(f"{what}: {name}.{f} differs")
                continue
            if cross and name == "timelines" and f in (
                    "arrivals", "completions", "errors", "latency_hist",
                    "svc_arrivals", "svc_completions", "svc_errors"):
                _same_counts(x, y, f"{what}: {name}.{f}")
                continue
            x, y = _np(x), _np(y)
            if cross and x.dtype.kind == "f" and name != "attributions" \
                    and f not in ("trips", "ejections", "scale_events",
                                  "windows_done", "breaker_open",
                                  "promotions", "holds", "rollbacks"):
                np.testing.assert_allclose(
                    x, y, rtol=SHED_RTOL, atol=1e-4,
                    err_msg=f"{what}: {name}.{f}")
                continue
            if f in ("hist", "tail_hist"):
                moved += hist_band(x.reshape(-1, x.shape[-1]),
                                   y.reshape(-1, y.shape[-1]),
                                   f"{what}: {name}.{f}")
            elif x.dtype.kind in "biu" or f in (
                    "trips", "ejections", "scale_events", "windows_done",
                    "breaker_open", "promotions", "holds", "rollbacks",
                    "crit_count", "tail_crit_count", "error_count"):
                if not np.array_equal(x, y):
                    raise AssertionError(f"{what}: {name}.{f} differs")
            else:
                np.testing.assert_allclose(
                    x, y, rtol=rtol, atol=atol,
                    err_msg=f"{what}: {name}.{f}")
    return moved


def folded_in_situ(port, compiled, psim, pload, pn, pblock, pwin):
    """Phase 4 for the folded member axis (ROADMAP item 9.1), on one
    draw source: a chaos fleet (each member's kill jittered), a
    protected fleet under member chaos, a rollout fleet and an observed
    fleet, each folded on the card against its ``"map"`` twin on the
    card and against the CPU's ``"map"`` fleet (``compare_folded``)."""
    from isotope_tpu_torch.resilience.faults import ChaosJitterSpec
    from isotope_tpu_torch.sim.ensemble import EnsembleSpec

    n, block = FLEET_SMALL["n"], FLEET_SMALL["block"]
    chaos = (port.ChaosEvent("leaf", 0.5, 2.0, replicas_down=None),)
    load = port.LoadModel(kind="open", qps=500.0)
    jit = dict(qps_jitter=0.1, cpu_jitter=0.05, error_jitter=0.2)

    def chaos_fleet(device, mode):
        sim = port.Simulator(compiled, chaos=chaos, device=device)
        return sim.run_ensemble(
            load, n, port.TorchDraws(15, "cuda"),
            EnsembleSpec.from_jitter(3, mode=mode, **jit), block_size=block,
            member_chaos=ChaosJitterSpec(time=0.3, seed=5))

    def protected_fleet(device, mode):
        sim = port.Simulator(psim.compiled, psim.params,
                             psim._chaos_events, policies=psim._policies,
                             device=device)
        return sim.run_policies_ensemble(
            pload, pn, port.TorchDraws(16, "cuda"),
            EnsembleSpec.from_jitter(3, mode=mode, **jit),
            block_size=pblock, window_s=pwin,
            member_chaos=ChaosJitterSpec(time=0.3, seed=2))

    rdoc = port.realistic_topology(40, archetype="multitier", seed=0)
    rdoc["rollouts"] = {rdoc["services"][1]["name"]: {
        **ROLLOUT, "bake": "50ms", "canary": BAD_CANARY}}
    rgraph = port.ServiceGraph.decode(rdoc)
    rcomp = port.compile_graph(rgraph)
    rro = port.compile_rollouts(rgraph, rcomp)
    rqps = port.Simulator(rcomp, device="cpu").capacity_qps() / 2

    def rollout_fleet(device, mode):
        sim = port.Simulator(rcomp, port.SimParams(timeline=True),
                             rollouts=rro, device=device)
        return sim.run_rollouts_ensemble(
            port.LoadModel(kind="open", qps=rqps), 8_192,
            port.TorchDraws(17, "cuda"),
            EnsembleSpec.from_jitter(3, mode=mode, **jit), block_size=1_024,
            window_s=0.02)

    def observed_fleet(device, mode):
        sim = port.Simulator(compiled, port.SimParams(attribution=True,
                                                      timeline=True),
                             chaos=chaos, device=device)
        return sim.run_ensemble(
            load, n, port.TorchDraws(18, "cuda"),
            EnsembleSpec.from_jitter(3, mode=mode, **jit), block_size=block,
            attribution=True, timeline=True, window_s=1.0,
            member_chaos=ChaosJitterSpec(time=0.3, seed=5))

    for what, run in (("chaos", chaos_fleet), ("protected", protected_fleet),
                      ("rollout", rollout_fleet),
                      ("observed", observed_fleet)):
        before = port.census.launches
        folded = run("cuda", "vmap")
        torch.cuda.synchronize()
        if port.census.launches == before:
            raise AssertionError(f"folded {what} fleet: kernel never "
                                 "launched")
        mapped, cpu = run("cuda", "map"), run("cpu", "map")
        moved = compare_folded(folded, mapped, f"folded {what} fleet "
                               "against its map twin")
        moved_cpu = compare_folded(folded, cpu, f"folded {what} fleet "
                                   "against the cpu's", cross=True)
        extra = ""
        if folded.policies is not None:
            extra = (f", trips {_np(folded.policies.trips).sum(-1).tolist()}"
                     f", windows done "
                     f"{_np(folded.policies.windows_done).sum(-1).tolist()}")
        if folded.rollouts is not None:
            extra = (f", rollbacks "
                     f"{_np(folded.rollouts.rollbacks).sum((-1, -2)).tolist()}"
                     f", promotions "
                     f"{_np(folded.rollouts.promotions).sum((-1, -2)).tolist()}")
        log(f"in situ ok folded {what} fleet (3 jittered members): card "
            f"vmap == card map by the folded contract (counts, hop "
            f"events, window counts, trips and actuations exactly; "
            f"histograms within one bucket: {moved} counts moved; sums "
            f"and law series within rtol {RESULT_RTOL:g}); == cpu map "
            f"(window counts within {WINDOW_COUNT_ATOL}, totals exactly; "
            f"{moved_cpu} counts moved; law series within {SHED_RTOL:g})"
            f"{extra}")


def fleet_wall(port, what, fn, blocks, members):
    """Time one fleet run: census launches set to 0 just before and read
    just after, peak device memory; returns (result, wall, launches,
    peak GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    port.census.launches = 0
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = port.census.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    return out, wall, launches, peak


def fleet_phase(port, runs, chaos_sim, census_ms):
    """Phase 5 for the fleets, at the reference bench's shapes: ensembleN
    (32 x 8,192 on 1000-svc_2000-end) folded, member by member and as 32
    solo runs on the same member sources; svc1000-chaosfleet;
    ensembleN-observed beside its unobserved twin; and a self-throttling
    paced closed-loop fleet, its members' rate solves timed apart.  Each
    prints its wall
    per fleet, aggregate hop-events/s, census launches and device ms
    (phase 3's time per block) and peak device memory.  Returns the
    census launches of each run."""
    sim = ensemble_sim(runs)
    launches = ensemble_n(port, sim, census_ms)
    launches.update(chaosfleet_run(port, chaos_sim, census_ms))
    launches.update(observed_fleet_run(port, sim, chaos_sim))
    launches.update(closed_fleet_run(port, sim))
    return launches


def closed_fleet_run(port, sim):
    """A self-throttling paced closed-loop fleet on ensembleN's graph
    (64 connections at 30,000 qps, above what they can issue, so the
    rate is a bisection over pilots), 8 members with a 10% qps jitter:
    each member solves its own rate from its own pilots.  That host
    planning is timed apart from the fleet's block loop, which runs
    folded; returns its census launches."""
    from isotope_tpu_torch.compiler.compile import compile_ensemble
    from isotope_tpu_torch.sim.ensemble import EnsembleSpec

    load = port.LoadModel(kind="closed", qps=30_000.0, connections=64)
    spec = EnsembleSpec.from_jitter(8, qps_jitter=0.1)
    source = port.TorchDraws(23, "cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    args = sim._ensemble_args(load, ENS_N, source, spec,
                              compile_ensemble(spec, sim.device),
                              block_size=ENS_N)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t
    kinds = len(sim._fleet_pilots)
    fleet, wall, n_launch, peak = fleet_wall(
        port, "closed", lambda: sim.run_ensemble(
            load, ENS_N, source, spec, block_size=ENS_N), 1, 8)
    calls = len(sim.census_shapes(ENS_N))
    pilots = pilot_launches(sim, kinds, calls)
    if n_launch != pilots + -(-8 // fleet.chunk) * calls:
        raise AssertionError(f"ensembleN-closed: {n_launch} census "
                             f"launches ({pilots} by its pilots)")
    hops = float(_np(fleet.summaries.hop_events).sum())
    if not np.array_equal(fleet.offered_qps, args["offered"]):
        raise AssertionError("closed fleet: rates differ from the plan")
    log(f"fleet ensembleN-closed (64 connections at 30,000 qps, 8 "
        f"members, qps jitter 0.1): the members' rate solves "
        f"{plan_s * 1e3:.1f} ms of host planning (a bisection over "
        f"pilots of {min(ENS_N, PILOT_N)} requests each; solved rates "
        + ", ".join(f"{r:.1f}" for r in args["offered"])
        + f" qps), then the folded fleet {wall * 1e3:.2f} ms "
        f"({hops / wall:.4e} aggregate hop-events/s, rates cached), "
        f"census launches {n_launch} ({pilots} by the folded pilots its "
        f"auto chunk is sized from), peak {peak:.3f} GiB")
    return {"ensembleN-closed": n_launch}


def ensemble_n(port, sim, census_ms=None):
    """ensembleN on ``sim`` (the 1000-svc graph): folded, member by
    member and as 32 solo runs on the same member sources, each after a
    warm-up fleet; ``census_ms``: phase 3's census device time per
    block, printed when given.  Returns the census launches of each."""
    from isotope_tpu_torch.sim.draws import RootedSource
    from isotope_tpu_torch.sim.ensemble import EnsembleSpec

    load = port.LoadModel(kind="open", qps=ENS_QPS)
    source = port.TorchDraws(21, "cuda")
    calls = len(sim.census_shapes(ENS_N))
    launches = {}
    out = {}
    # warm-up: one small fleet of each mode (allocator growth, first
    # launches); the timed fleets below are the bench's
    for mode in ("vmap", "map"):
        sim.run_ensemble(load, ENS_N, source, EnsembleSpec.of(2, mode=mode),
                         block_size=ENS_N)
    plan_chunk = sim.ensemble_chunk_size(ENS_MEMBERS, ENS_N, load=load)
    for mode in ("vmap", "map"):
        spec = EnsembleSpec.of(ENS_MEMBERS, mode=mode)
        fleet, wall, n_launch, peak = fleet_wall(
            port, mode, lambda spec=spec: sim.run_ensemble(
                load, ENS_N, source, spec, block_size=ENS_N),
            1, ENS_MEMBERS)
        hops = float(_np(fleet.summaries.hop_events).sum())
        chunks = -(-ENS_MEMBERS // fleet.chunk) if mode == "vmap" else 0
        want = chunks * calls if mode == "vmap" else ENS_MEMBERS * calls
        if n_launch != want:
            raise AssertionError(f"ensembleN {mode}: {n_launch} census "
                                 f"launches, expected {want}")
        census = ""
        if census_ms is not None and mode == "vmap":
            folded = census_ms[f"ensembleN ({ENS_MEMBERS} folded)"]
            census = (f", census device {folded * chunks:.4f} ms per "
                      f"fleet (phase 3's folded calls)")
        log(f"fleet ensembleN {mode}: {ENS_MEMBERS} members x {ENS_N} "
            f"(chunk {fleet.chunk}; auto chunk {plan_chunk}), "
            f"{wall * 1e3:.2f} ms per fleet, {hops / wall:.4e} aggregate "
            f"hop-events/s, census launches {n_launch}{census}, peak "
            f"device memory {peak:.3f} GiB")
        out[mode] = (fleet, wall)
        launches[f"ensembleN {mode}"] = n_launch
    moved = compare_fleets(out["vmap"][0].summaries,
                           out["map"][0].summaries,
                           "ensembleN vmap against map")
    log(f"fleet ensembleN: vmap == map on the card (counts, hop events; "
        f"{moved} histogram counts a bucket over; sums within rtol "
        f"{RESULT_RTOL:g})")

    def solos():
        return [sim.run_summary(load, ENS_N, RootedSource(source, s),
                                block_size=ENS_N)
                for s in range(ENS_MEMBERS)]

    solo_out, wall, n_launch, peak = fleet_wall(port, "solos", solos, 1,
                                                ENS_MEMBERS)
    hops = sum(float(s.hop_events) for s in solo_out)
    for k, s in enumerate(solo_out):
        for f in ("count", "hop_events", "latency_hist", "latency_sum"):
            _same(getattr(out["map"][0].member(k), f), getattr(s, f),
                  f"ensembleN map member {k} against its solo run {f}")
    log(f"fleet ensembleN as {ENS_MEMBERS} solo runs on the same member "
        f"sources: {wall * 1e3:.2f} ms, {hops / wall:.4e} aggregate "
        f"hop-events/s, census launches {n_launch}, peak "
        f"{peak:.3f} GiB; map members == solo runs bit for bit; "
        f"vmap / map / solos walls {out['vmap'][1] * 1e3:.2f} / "
        f"{out['map'][1] * 1e3:.2f} / {wall * 1e3:.2f} ms")
    launches["ensembleN solos"] = n_launch
    return launches


def pilot_launches(sim, kinds_before, calls):
    """The census launches of the folded pilots a run recorded on
    ``sim`` (``analysis/costmodel.fleet_member_bytes``: for each fleet
    kind new to ``sim``, one unrecorded and two recorded pilots of
    ``FLEET_PILOT_BLOCKS`` blocks of ``calls`` calls)."""
    from isotope_tpu_torch.analysis.oplog import FLEET_PILOT_BLOCKS

    return ((len(sim._fleet_pilots) - kinds_before) * 3
            * FLEET_PILOT_BLOCKS * calls)


def chunk_law(fleet):
    """``(fixed, the chunk's estimate)`` in bytes of a folded fleet's
    auto chunk (``analysis/costmodel.fleet_chunk``: the tables once,
    every member's returned rows, each chunk member's block loop)."""
    sizes = fleet.member_bytes
    if sizes is None:
        raise AssertionError("the auto chunk was not sized on the card")
    return sizes.fixed, (sizes.fixed + fleet.members * sizes.retained
                         + fleet.chunk * sizes.per_member)


def own_peak(fleet, base):
    """A fleet's own high-water in bytes: ``max_memory_allocated``
    since the reset less the ``base`` allocated before it, plus the
    tables its pilots read (already resident)."""
    return (torch.cuda.max_memory_allocated() - base
            + fleet.member_bytes.fixed)


def folded_twins(port, what, make, sim, blocks, members, calls,
                 twin_blocks=None):
    """One folded fleet beside its ``"map"`` twin on the card (phase 5):
    ``make(mode)`` runs it, first once unmeasured (the folded pilots
    its auto chunk is sized from are recorded then, and cached).  Each
    run's census launches are set to 0 just before and checked exactly
    just after (folded: chunks x ``blocks`` x ``calls``; the twin:
    ``members`` x ``twin_blocks`` x ``calls``), torch ops a block are
    counted over a whole run after the timed ones
    (``tools/torch_op_count.OpLog``), and the folded run's own peak
    (:func:`own_peak`) is held against the auto chunk's budget
    (``CAPACITY_FILL`` of the card).  The folded fleet equals its twin
    by the folded contract (``compare_folded``) when the twin runs the
    same blocks.  Returns ``(folded, twin, launches by path)``."""
    from isotope_tpu_torch.analysis import costmodel
    from tools.torch_op_count import OpLog

    twin_blocks = blocks if twin_blocks is None else twin_blocks
    make("vmap")
    out = {}
    for mode in ("vmap", "map"):
        base = torch.cuda.memory_allocated()
        fleet, wall, n_launch, peak = fleet_wall(
            port, mode, lambda mode=mode: make(mode), blocks, members)
        own = own_peak(fleet, base) if mode == "vmap" else None
        chunks = -(-members // fleet.chunk) if mode == "vmap" else members
        nb = blocks if mode == "vmap" else twin_blocks
        if n_launch != chunks * nb * calls:
            raise AssertionError(f"{what} {mode}: {n_launch} census "
                                 f"launches, expected {chunks} x {nb} x "
                                 f"{calls}")
        with OpLog() as ops:
            make(mode)
        out[mode] = (fleet, wall, n_launch, peak, ops.count / nb, own)
    folded, wall, n_launch, peak, ops, own = out["vmap"]
    twin, t_wall, t_launch, t_peak, t_ops, _ = out["map"]
    cap = costmodel.device_capacity_bytes(device=sim.device)
    budget = costmodel.CAPACITY_FILL * cap
    _, est = chunk_law(folded)
    if own > budget:
        raise AssertionError(f"{what}: own peak {own:.6e} B past the auto "
                             f"chunk's budget {budget:.6e} B")
    moved = (compare_folded(folded, twin, f"{what} folded against map")
             if twin_blocks == blocks else None)
    hops = float(_np(folded.summaries.hop_events).sum())
    t_hops = float(_np(twin.summaries.hop_events).sum())
    log(f"{what} folded: {members} members x {blocks} blocks, chunk "
        f"{folded.chunk} (auto), {wall * 1e3:.2f} ms per fleet, "
        f"{hops / wall:.4e} aggregate hop-events/s, {ops:.1f} torch ops "
        f"a block (all members), census launches {n_launch}; own peak "
        f"{own / 2**30:.3f} GiB against the chunk's budget "
        f"{budget / 2**30:.3f} GiB (the chunk law's estimate "
        f"{est / 2**30:.3f} GiB, own / estimate {own / est:.4f}; "
        f"{folded.member_bytes.per_member / 2**30:.4f} GiB a member's "
        f"block loop; device peak {peak:.3f} GiB, the card "
        f"{cap / 2**30:.3f} GiB)")
    log(f"{what} map twin ({members} members x {twin_blocks} blocks): "
        f"{t_wall * 1e3:.2f} ms per fleet, {t_hops / t_wall:.4e} aggregate "
        f"hop-events/s, {t_ops:.1f} torch ops a block of all members, "
        f"census launches {t_launch}, peak {t_peak:.3f} GiB; folded / map "
        f"wall per block {wall / blocks / (t_wall / twin_blocks):.3f}"
        + ("" if moved is None else
           f"; folded == map by the folded contract ({moved} histogram "
           f"counts a bucket over)"))
    return folded, twin, {what: n_launch, f"{what} map twin": t_launch}


def split_chunk_run(port, what, make, folded, blocks, calls):
    """``folded``'s fleet again under a capacity
    (``ISOTOPE_VET_DEVICE_BYTES``) that fits its fixed and retained
    bytes and 3.5 members' block loops: the auto chunk splits it (3, 3
    and 2 of 8), its own peak stays inside that budget, its census
    launches are exactly chunks x ``blocks`` x ``calls``, and its
    summaries equal the one-chunk fleet's by ``compare_fleets`` (a
    chunk changes no count).  Returns its census launches."""
    import os

    from isotope_tpu_torch.analysis import costmodel

    sizes, members = folded.member_bytes, folded.members
    cap = (sizes.fixed + members * sizes.retained
           + 3.5 * sizes.per_member) / costmodel.CAPACITY_FILL
    os.environ[costmodel.ENV_DEVICE_BYTES] = repr(cap)
    try:
        base = torch.cuda.memory_allocated()
        fleet, wall, n_launch, peak = fleet_wall(
            port, what, lambda: make("vmap"), blocks, members)
        own = own_peak(fleet, base)
    finally:
        del os.environ[costmodel.ENV_DEVICE_BYTES]
    budget = costmodel.CAPACITY_FILL * cap
    _, est = chunk_law(fleet)
    chunks = -(-members // fleet.chunk)
    if not 1 < chunks < members or fleet.member_bytes != sizes:
        raise AssertionError(f"{what} split: chunk {fleet.chunk} of "
                             f"{members}")
    if n_launch != chunks * blocks * calls:
        raise AssertionError(f"{what} split: {n_launch} census launches, "
                             f"expected {chunks} x {blocks} x {calls}")
    if own > budget:
        raise AssertionError(f"{what} split: own peak {own:.6e} B past "
                             f"the auto chunk's budget {budget:.6e} B")
    moved = compare_fleets(fleet.summaries, folded.summaries,
                           f"{what} split against one chunk")
    log(f"{what} split: capacity {cap:.6e} B (the fixed and retained "
        f"bytes and 3.5 members' block loops over CAPACITY_FILL), auto "
        f"chunk {fleet.chunk} ({chunks} chunks), {wall * 1e3:.2f} ms, "
        f"census launches {n_launch}; own peak {own:.6e} B against the "
        f"budget {budget:.6e} B ({own / budget:.4f} of it; the chunk "
        f"law's estimate {est:.6e} B, own / estimate {own / est:.4f}); "
        f"summaries equal the one-chunk fleet's ({moved} histogram counts "
        f"a bucket over)")
    return {f"{what} split": n_launch}


def chaosfleet_run(port, chaos_sim, census_ms):
    """svc1000-chaosfleet folded (the card's auto mode) beside its
    ``"map"`` twin, after one warm-up block; returns the census
    launches of both."""
    from isotope_tpu_torch.resilience.faults import ChaosJitterSpec
    from isotope_tpu_torch.sim.ensemble import EnsembleSpec

    cf = CHAOSFLEET
    cload = port.LoadModel(kind="open", qps=cf["qps"])
    jitter = ChaosJitterSpec(**cf["jitter"])
    chaos_sim.run_policies(cload, cf["block"], port.TorchDraws(0, "cuda"),
                           block_size=cf["block"], window_s=cf["window_s"])
    # the members' planner Simulators (host tables of each jittered
    # schedule), timed apart: the fleet below builds them again
    t = time.perf_counter()
    _, _, fx = chaos_sim._resolve_member_chaos(
        jitter, tuple(range(cf["members"])), with_pol=True)
    torch.cuda.synchronize()
    planners_s = time.perf_counter() - t
    blocks = -(-cf["n"] // cf["block"])
    calls = len(census_calls(chaos_sim, cf["block"]))

    def make(mode):
        return chaos_sim.run_policies_ensemble(
            cload, cf["n"], port.TorchDraws(22, "cuda"),
            EnsembleSpec.of(cf["members"], mode=mode),
            block_size=cf["block"], window_s=cf["window_s"],
            member_chaos=jitter)

    fleet, _, launches = folded_twins(
        port, "svc1000-chaosfleet", make, chaos_sim, blocks, cf["members"],
        calls)
    launches.update(split_chunk_run(port, "svc1000-chaosfleet", make,
                                    fleet, blocks, calls))
    sev = fleet.severity()
    worst = int(np.argmax(sev))
    doc = fleet.to_doc("svc1000-chaosfleet")
    folded_calls = census_calls(chaos_sim, fleet.chunk * cf["block"])
    log(f"fleet svc1000-chaosfleet: {cf['members']} protected members x "
        f"{cf['n']} (block {cf['block']}, {cf['window_s']:g} s windows), "
        f"member kills " + ", ".join(
            f"[{e.start_s:.4f}, {e.end_s:.4f}) x{e.replicas_down}"
            for ev in fleet.member_chaos for e in ev)
        + f"; worst member {worst} (seed {doc['worst_member_seed']}) "
        f"severity {sev[worst]:.6f} (peak window error share); the "
        f"members' planners {planners_s * 1e3:.1f} ms of host planning "
        f"inside the fleet's wall; folded census calls "
        f"{folded_calls[0][0]} rows a level, device "
        f"{census_ms['svc1000-chaosfleet (8 folded)'] * blocks:.4f} ms "
        f"per fleet (phase 3)")
    return launches


def observed_fleet_run(port, sim, chaos_sim):
    """ensembleN-observed folded (the card's auto mode) beside its
    ``"map"`` twin and its unobserved twin, then ``fleetblame.to_doc``;
    and a protected observed fleet (svc1000-chaosfleet attributed)
    folded beside its ``"map"`` twin.  Returns their census launches."""
    from isotope_tpu_torch.metrics import fleetblame
    from isotope_tpu_torch.resilience.faults import ChaosJitterSpec
    from isotope_tpu_torch.sim.ensemble import EnsembleSpec

    load = port.LoadModel(kind="open", qps=ENS_QPS)
    source = port.TorchDraws(21, "cuda")
    asim = port.Simulator(sim.compiled, port.SimParams(
        attribution=True, timeline=True), device="cuda")
    spec = EnsembleSpec.of(ENS_OBSERVED)
    asim.run_ensemble(load, ENS_N, source, EnsembleSpec.of(1),
                      block_size=ENS_N, attribution=True, timeline=True)
    twin, twin_wall, twin_launch, twin_peak = fleet_wall(
        port, "twin", lambda: sim.run_ensemble(
            load, ENS_N, source, EnsembleSpec.of(ENS_OBSERVED, mode="vmap"),
            block_size=ENS_N), 1, ENS_OBSERVED)
    calls = len(asim.census_shapes(ENS_N))

    def make(mode):
        return asim.run_ensemble(
            load, ENS_N, source, EnsembleSpec.of(ENS_OBSERVED, mode=mode),
            block_size=ENS_N, attribution=True, timeline=True,
            window_s=0.1)

    obs, _, launches = folded_twins(
        port, "ensembleN-observed", make, asim, 1, ENS_OBSERVED, calls)
    from isotope_tpu_torch.native import blame

    before = blame.blame_sweep.launches
    folded = make("vmap")
    blame_launches("ensembleN-observed folded", before,
                   -(-ENS_OBSERVED // folded.chunk))
    launches.update(split_chunk_run(port, "ensembleN-observed", make, obs,
                                    1, calls))
    t = time.perf_counter()
    doc = fleetblame.to_doc(asim.compiled, obs.attributions, obs.timelines,
                            seeds=spec.seeds, window_s=0.1)
    explain_s = time.perf_counter() - t
    # both fold the same members in one chunk on the same draws: the
    # recorder and the blame sweep change no summary bit
    if obs.chunk != twin.chunk:
        raise AssertionError(f"ensembleN-observed: chunk {obs.chunk}, its "
                             f"unobserved twin's {twin.chunk}")
    compare_fleets(obs.summaries, twin.summaries, "ensembleN-observed "
                   "against its unobserved twin", rtol=0.0, atol=0.0)
    worst = doc["member_blame"][doc["ranking"][0]]
    log(f"fleet ensembleN-observed: its unobserved folded twin "
        f"{twin_wall * 1e3:.2f} ms, census launches {twin_launch}, peak "
        f"{twin_peak:.3f} GiB; summaries equal the twin's (chunk "
        f"{obs.chunk} both, floats bit for bit); "
        f"fleetblame.to_doc {explain_s * 1e3:.1f} ms: member "
        f"{worst['member']} ranks first, top hop "
        f"{worst['top_hops'][0]['service'] if worst['top_hops'] else '-'}")

    # the protected observed fleet: svc1000-chaosfleet with blame
    cf = CHAOSFLEET
    psim = port.Simulator(chaos_sim.compiled, port.SimParams(
        timeline=True, attribution=True), chaos_sim._chaos_events,
        policies=chaos_sim._policies, device="cuda")
    cload = port.LoadModel(kind="open", qps=cf["qps"])
    blocks = -(-cf["n"] // cf["block"])

    def pmake(mode):
        return psim.run_policies_ensemble(
            cload, cf["n"], port.TorchDraws(24, "cuda"),
            EnsembleSpec.of(cf["members"], mode=mode),
            block_size=cf["block"], window_s=cf["window_s"],
            attribution=True,
            member_chaos=ChaosJitterSpec(**cf["jitter"]))

    pobs, _, plaunch = folded_twins(
        port, "svc1000-chaosfleet-observed", pmake, psim, blocks,
        cf["members"], len(census_calls(psim, cf["block"])))
    launches.update(plaunch)
    log(f"fleet svc1000-chaosfleet-observed: crit-path hops "
        f"{_np(pobs.attributions.crit_count).sum(-1).tolist()}, trips "
        f"{_np(pobs.policies.trips).sum(-1).tolist()}")
    return launches


def cli_fleet_phase():
    """``simulate --ensemble 8 --ensemble-jitter ... --ensemble-slo 250ms
    --ensemble-out`` on canonical.yaml, and ``--policies --rollouts
    --ensemble 4 --ensemble-chaos-jitter ... --ensemble-out`` on its
    protected variant, on the card and with ``--device cpu`` in this
    process on one draw source (``cli_capture``): the Fortio documents'
    counts and the ensemble documents agree (``docs_close``); the card
    runs the plain fleet folded, the CPU member by member."""
    import io

    import yaml

    from isotope_tpu_torch import cli as port_cli
    from isotope_tpu_torch.sim import TorchDraws

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        topo = tmp / "canonical-protected.yaml"
        topo.write_text((TOPOLOGIES / "canonical.yaml").read_text()
                        + yaml.safe_dump(CLI_PROTECTED))
        cases = {
            "plain": (TOPOLOGIES / "canonical.yaml", [
                "--ensemble", "8", "--ensemble-jitter", FLEET_JITTER,
                "--ensemble-slo", "250ms"]),
            "protected": (topo, [
                "--policies", "--rollouts", "--ensemble", "4",
                "--ensemble-chaos-jitter", "time=0.3,magnitude=0.5,seed=0",
                "--ensemble-slo", "250ms"]),
        }
        for case, (path, flags) in cases.items():
            docs = {}
            for device in ("cuda", "cpu"):
                out_file = tmp / f"{case}-ens-{device}"
                args = ["simulate", str(path), "--qps", "1000",
                        "--duration", "4s", "--load-kind", "open",
                        "--device", device, *flags,
                        "--ensemble-out", str(out_file)]
                t = time.perf_counter()
                buf, err = io.StringIO(), io.StringIO()
                with contextlib.redirect_stdout(buf), \
                        contextlib.redirect_stderr(err), \
                        cli_capture(TorchDraws(0, "cpu")):
                    rc = port_cli.main(args)
                if rc != 0:
                    raise AssertionError(f"simulate {flags} on {device}")
                doc = json.loads(buf.getvalue())
                docs[device] = {
                    "fortio": {k: doc[k] for k in (
                        "Labels", "RequestedQPS", "NumThreads", "RetCodes")}
                    | {"Count": doc["DurationHistogram"]["Count"]},
                    "ensemble": json.loads(out_file.read_text()),
                }
                line = [ln for ln in err.getvalue().splitlines()
                        if ln.startswith("ensemble:")]
                log(f"cli simulate {' '.join(flags)} on {device}: "
                    f"{docs[device]['fortio']['Count']} requests in "
                    f"{time.perf_counter() - t:.1f} s; {line[0]}")
            for key, want in docs["cpu"].items():
                docs_close(docs["cuda"][key], want, f"{case}.{key}")
            log(f"cli fleet {case}: Fortio and ensemble documents agree, "
                f"card against CPU")


# -- the search brackets and importance splitting ------------------------------

#: search64 (the reference bench's accelerator size, bench.py:573-620):
#: 1000-svc_2000-end open at 10,000 qps, 64 candidates jittered qps 0.2,
#: cpu 0.1, error 0.3; eta 4, 3 rungs, growth 2, blocks of 4,096 and
#: 16,384 requests, so the rungs screen at 1, 2 and 4 blocks
SEARCH64 = dict(members=64, eta=4, rungs=3, growth=2, block=4_096,
                n=16_384, qps=10_000.0)
SEARCH_JITTER = dict(qps_jitter=0.2, cpu_jitter=0.1, error_jitter=0.3)
#: the planted winner (the reference's tools/search_smoke.py, its size
#: and seed number): the 1000-service graph with its entry at 2% errors,
#: 16 candidates whose error scales are >= 0.8 but candidate 5's 1e-3
PLANTED = dict(members=16, best=5, eta=4, rungs=2, n=256, block=64,
               qps=10_000.0, seed=42)
#: the protected bracket: the CPU tests' storm topology
#: (tests/test_torch_folded_fleets.py) past its breakers' caps, 16
#: candidates ranked by trips, 2 rungs of 16 and 4 (2 and 6 blocks of
#: 2,048 requests), 10 ms windows: its breakers trip
STORM_TOPOLOGY = """
services:
- name: entry
  isEntrypoint: true
  numReplicas: 4
  script:
  - call: {service: worker, timeout: 850us, retries: 2}
- name: worker
  numReplicas: 4
  errorRate: 0.5%
policies:
  defaults:
    retry_budget: {budget_percent: 25%}
  worker:
    breaker: {max_pending: 6, max_connections: 64,
              consecutive_errors: 5, base_ejection: 2s}
    autoscaler: {min_replicas: 2, max_replicas: 8,
                 target_utilization: 60%, sync_period: 1s,
                 stabilization_window: 3s}
"""
STORM_BRACKET = dict(members=16, eta=4, rungs=2, n=16_384, block=2_048,
                     qps=8_000.0, window_s=0.01, rank="trips")
#: the splitting estimate at svc1000-chaosfleet (bench.py:700-795) and
#: its compressed twin, held card against CPU
SPLIT_TWIN = dict(n=1_024, block=512)
#: fields a carried segment reproduces exactly
EXACT_FIELDS = ("count", "error_count", "hop_events", "latency_min",
                "latency_max", "latency_hist", "end_max")


def planted_sim(port, device="cuda"):
    """The planted-winner bracket's Simulator: 1000-svc_2000-end with
    its entry at 2% errors."""
    import yaml

    doc = yaml.safe_load((TOPOLOGIES / "1000-svc_2000-end.yaml").read_text())
    doc["services"][0]["errorRate"] = "2%"
    return port.Simulator(port.compile_graph(port.ServiceGraph.decode(doc)),
                          device=device)


def search_census_runs(runs, planted, storm):
    """The brackets' folded census calls for phase 3, as runs: search64's
    rungs (64, 16 and 4 survivors x 4,096 rows a level; rung 0 is
    ensembleN's shape), the planted bracket's (16 and 4 x 64) and the
    protected bracket's on the storm topology (16 and 4 x 2,048, fail
    steps and error flags), with its map twin's solo calls.  The
    splitting levels call it at svc1000-chaosfleet's folded shape."""
    sim = ensemble_sim(runs)
    load = SimpleNamespace(kind="open", qps=SEARCH64["qps"])
    out = [(f"search64 rung {r} ({m} folded)", sim, load,
            m * SEARCH64["block"], m * SEARCH64["block"])
           for r, m in enumerate((64, 16, 4))]
    out += [(f"planted rung {r} ({m} folded)", planted, load,
             m * PLANTED["block"], m * PLANTED["block"])
            for r, m in enumerate((16, 4))]
    c = STORM_BRACKET
    sload = SimpleNamespace(kind="open", qps=c["qps"])
    out += [(f"storm bracket rung {r} ({m} folded)", storm, sload,
             m * c["block"], m * c["block"])
            for r, m in enumerate((c["members"], c["members"] // c["eta"]))]
    out += [("storm bracket member", storm, sload, c["block"], c["block"])]
    return out


def planted_spec(mode=None):
    from isotope_tpu_torch.sim.ensemble import EnsembleSpec
    from isotope_tpu_torch.sim.search import SearchSpec

    m, best = PLANTED["members"], PLANTED["best"]
    err = 0.8 + 0.08 * np.arange(m, dtype=np.float64)
    err[best] = 1e-3
    return SearchSpec(candidates=EnsembleSpec(
        seeds=tuple(range(m)), error_scale=err, mode=mode),
        eta=PLANTED["eta"], rungs=PLANTED["rungs"])


def _lineage_equal(got, want, what):
    if got.winner != want.winner:
        raise AssertionError(f"{what}: winners {got.winner} / {want.winner}")
    for a, b in zip(got.rungs, want.rungs):
        for f in ("candidates", "order", "survivors", "severity"):
            if not np.array_equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"{what} rung {a.rung}: {f} differs")


def _rows_equal(got, want, rows, what, fields=EXACT_FIELDS):
    """Row ``i`` of stack ``got`` against row ``rows[i]`` of ``want``."""
    for f in fields:
        a = _np(getattr(got, f))
        b = _np(getattr(want, f))[np.asarray(rows)]
        if not np.array_equal(a, b):
            raise AssertionError(f"{what}: {f} differs")


def planted_in_situ(port, planted):
    """Phase 4 for the brackets: the planted winner (16 candidates,
    eta 4, 2 rungs, 256 requests in blocks of 64) on the card.  Candidate
    5 (error scale 1e-3 against >= 0.8) has the least severity of every
    rung it runs in, and every rung ranks by the law (severity, then the
    tie-break uniform: ``np.lexsort``), so the winner is candidate 5 or a
    rival tied with it at the least severity that the tie-break puts
    first (at 64 requests a rung, a rival at 1.6% errors shows none with
    probability ~0.36; the reference's draws crown candidate 5:
    ``tests/test_torch_search.py``).  Rung 0 equals ``run_ensemble`` at
    the screening horizon and the winner's carried segments the unbroken
    fleet's row, on the exact fields; the card's bracket equals the
    CPU's on the same draws: the same lineage, counts and hop events
    exactly, histograms within one bucket, sums within rtol."""
    from isotope_tpu_torch.sim.search import tiebreak_draws

    load = port.LoadModel(kind="open", qps=PLANTED["qps"])
    source = port.TorchDraws(PLANTED["seed"], "cuda")
    n, block, best = PLANTED["n"], PLANTED["block"], PLANTED["best"]
    spec = planted_spec()
    before = port.census.launches
    srch = planted.run_search(load, n, source, spec, block_size=block)
    torch.cuda.synchronize()
    if port.census.launches == before or srch.mode != "vmap":
        raise AssertionError("planted bracket: not folded on the kernel")
    tb = tiebreak_draws(spec).numpy()
    for r in srch.rungs:
        cands = [int(x) for x in r.candidates]
        if not np.array_equal(r.order, np.lexsort((tb[cands], r.severity))):
            raise AssertionError(f"planted rung {r.rung}: rank order")
        if best in cands and \
                r.severity[cands.index(best)] != r.severity.min():
            raise AssertionError(f"planted rung {r.rung}: candidate {best}"
                                 " is not the least severe")
    cfg = srch.winner_config()
    err = spec.candidates.error_scale
    if cfg["error_scale"] != float(err[srch.winner]):
        raise AssertionError("planted bracket: winner_config")
    r0 = srch.rungs[0]
    fleet = planted.run_ensemble(load, r0.cum_requests, source,
                                 spec.candidates, block_size=block)
    _rows_equal(r0.summaries, fleet.summaries, r0.candidates,
                "planted rung 0 against run_ensemble")
    full = planted.run_ensemble(load, n, source, spec.candidates,
                                block_size=block)
    won = srch.winner_summary()
    for f in EXACT_FIELDS:
        _same(getattr(won, f), getattr(full.member(srch.winner), f),
              f"planted winner's segments against the unbroken row {f}")
    cpu = planted_sim(port, "cpu").run_search(load, n, source,
                                              planted_spec(),
                                              block_size=block)
    _lineage_equal(srch, cpu, "planted bracket card against cpu")
    moved = [compare_fleets(a.summaries, b.summaries,
                            f"planted rung {a.rung} card against cpu")
             for a, b in zip(srch.rungs, cpu.rungs)]
    log(f"in situ ok planted bracket: winner {srch.winner} (severity "
        f"{srch.winner_severity:.6f}; candidate {best} "
        + ("wins" if srch.winner == best else
           "ties at the least severity and ranks behind by its tie-break")
        + "; lineage " + " -> ".join(str([int(x) for x in r.survivors])
                                     for r in srch.rungs)
        + ", severities " + " / ".join(
            str(np.round(r.severity, 4).tolist()) for r in srch.rungs)
        + "); every rung ranked by (severity, tie-break); rung 0 == "
        f"run_ensemble and the winner's segments == the unbroken row on "
        f"{len(EXACT_FIELDS)} exact fields; card (vmap) == cpu (map): same"
        f" lineage, {moved} histogram counts a bucket over")


def search_phase(port, runs, chaos_sim, storm, timing):
    """Phase 5 for the brackets and the splitting estimate, each its own
    path (census launches set to 0 just before, read just after):
    search64 with the sequential sweep it replaces, the protected bracket
    on svc1000-chaosfleet's Simulator and the splitting estimate at
    svc1000-chaosfleet, then the estimate's compressed twin card against
    CPU.  Returns the census launches of each."""
    launches = search64_run(port, ensemble_sim(runs), timing)
    launches.update(protected_bracket_run(port, storm, timing))
    launches.update(splitting_run(port, chaos_sim, timing))
    return launches


def search64_run(port, sim, timing):
    from isotope_tpu_torch.sim.draws import RootedSource
    from isotope_tpu_torch.sim.ensemble import EnsembleSpec
    from isotope_tpu_torch.sim.search import SearchSpec, plan_bracket

    c = SEARCH64
    spec = SearchSpec(candidates=EnsembleSpec.from_jitter(
        c["members"], **SEARCH_JITTER), eta=c["eta"], rungs=c["rungs"],
        growth=c["growth"])
    load = port.LoadModel(kind="open", qps=c["qps"])
    block, n = c["block"], c["n"]
    plan = plan_bracket(spec, n, block)
    # warm-up: one bracket of the same shape on another seed
    sim.run_search(load, n, port.TorchDraws(30, "cuda"), spec,
                   block_size=block)
    kinds = len(sim._fleet_pilots)
    srch, wall, n_launch, peak = fleet_wall(
        port, "search64", lambda: sim.run_search(
            load, n, port.TorchDraws(31, "cuda"), spec, block_size=block),
        0, 0)
    calls = len(sim.census_shapes(block))
    want = sum(rp.num_blocks * -(-rp.width // r.chunk)
               for rp, r in zip(plan, srch.rungs)) * calls \
        + pilot_launches(sim, kinds, calls)
    if n_launch != want or srch.mode != "vmap":
        raise AssertionError(f"search64: {n_launch} census launches "
                             f"({srch.mode}), expected {want}")
    pooled = srch.pooled()
    hops = float(pooled.hop_events)
    names = [f"search64 rung {r} ({m} folded)"
             for r, m in enumerate((64, 16, 4))]
    dev_ms = sum(timing["ms_per_block"][nm] * rp.num_blocks
                 for nm, rp in zip(names, plan))
    bound = sum(timing["bound_per_block"][nm] * rp.num_blocks
                for nm, rp in zip(names, plan))
    log(f"search64: {c['members']} candidates, eta {c['eta']}, growth "
        f"{c['growth']}, rungs of {[rp.width for rp in plan]} x "
        f"{[rp.num_blocks for rp in plan]} blocks of {block} (chunks "
        f"{[r.chunk for r in srch.rungs]}, {srch.mode}): bracket wall "
        f"{wall * 1e3:.2f} ms, pooled {hops / wall:.4e} hop-events/s "
        f"({hops:.4e} hop events), census launches {n_launch}, census "
        f"device {dev_ms:.4f} ms against a bound of {bound:.4f} ms "
        f"({bound / dev_ms:.1%}; phase 3), peak {peak:.3f} GiB; winner "
        f"{srch.winner} (severity {srch.winner_severity:.6f})")
    scales = spec.candidates.qps_scale
    source = port.TorchDraws(32, "cuda")

    def sweep():
        live = list(range(c["members"]))
        total = 0.0
        for rp in plan:
            sev = []
            for m in live:
                load_m = dataclasses.replace(load,
                                             qps=load.qps * float(scales[m]))
                s = sim.run_summary(load_m, rp.num_blocks * block,
                                    RootedSource(source,
                                                 rp.rung * 1_000 + m),
                                    block_size=block)
                total += float(s.hop_events)
                sev.append((float(s.error_count) / max(float(s.count), 1.0),
                            m))
            sev.sort()
            keep = plan[rp.rung + 1].width if rp.rung + 1 < len(plan) else 1
            live = [m for _, m in sev[:keep]]
        return total

    sweep()  # warm-up
    sweep_hops, sweep_wall, sweep_launch, sweep_peak = fleet_wall(
        port, "sweep", sweep, 0, 0)
    log(f"search64 sequential sweep (the same per-rung budgets as "
        f"{sum(rp.width for rp in plan)} solo run_summary runs, ranked on "
        f"the host): {sweep_wall * 1e3:.2f} ms, "
        f"{sweep_hops / sweep_wall:.4e} hop-events/s, census launches "
        f"{sweep_launch}, peak {sweep_peak:.3f} GiB; bracket / sweep "
        f"wall {wall / sweep_wall:.3f}")
    return {"search64": n_launch, "search64 sweep": sweep_launch}


def storm_sim(port, device="cuda"):
    """The armed bracket's Simulator: the CPU tests' storm topology
    (``tests/test_torch_folded_fleets.py``) with its kill: breakers at
    6 pending, a 25% retry budget and an HPA, 3 of the worker's 4
    replicas down in [0.1 s, 0.3 s)."""
    graph = port.ServiceGraph.from_yaml(STORM_TOPOLOGY)
    compiled = port.compile_graph(graph)
    return port.Simulator(
        compiled, port.SimParams(timeline=True),
        (port.ChaosEvent("worker", 0.1, 0.3, replicas_down=3),),
        policies=port.compile_policies(graph, compiled), device=device)


def protected_bracket_run(port, storm, timing):
    """The protected bracket on the storm topology (16 candidates, eta
    4, 2 rungs, 16,384 requests in blocks of 2,048 at 8,000 qps, 10 ms
    windows, ranked by trips): its breakers trip.  Folded (the card's
    auto mode) beside its ``"map"`` twin: the lineages equal, the rungs
    by the folded contract; rung 0 equals ``run_policies_ensemble`` at
    the screening horizon and the winner's resumed segments the
    unbroken fleet's row."""
    from isotope_tpu_torch.sim.ensemble import EnsembleSpec
    from isotope_tpu_torch.sim.search import SearchSpec

    c = STORM_BRACKET
    load = port.LoadModel(kind="open", qps=c["qps"])
    kw = dict(block_size=c["block"], window_s=c["window_s"])
    calls = len(census_calls(storm, c["block"]))

    def spec(mode):
        return SearchSpec(candidates=EnsembleSpec.from_jitter(
            c["members"], mode=mode, **SEARCH_JITTER), eta=c["eta"],
            rungs=c["rungs"], rank=c["rank"])

    def bracket(mode):
        return storm.run_search_protected(load, c["n"],
                                          port.TorchDraws(33, "cuda"),
                                          spec(mode), **kw)

    bracket("vmap")  # warm-up
    out = {}
    for mode in ("vmap", "map"):
        kinds = len(storm._fleet_pilots)
        srch, wall, n_launch, peak = fleet_wall(
            port, mode, lambda mode=mode: bracket(mode), 0, 0)
        if mode == "vmap":
            want = sum(r.num_blocks * -(-r.width // r.chunk)
                       for r in srch.rungs) * calls
        else:
            want = sum(r.width * r.num_blocks for r in srch.rungs) * calls
        want += pilot_launches(storm, kinds, calls)
        if n_launch != want or srch.mode != mode:
            raise AssertionError(f"protected bracket {mode}: {n_launch} "
                                 f"launches ({srch.mode}), expected {want}")
        out[mode] = (srch, wall, n_launch, peak)
    srch, wall, n_launch, peak = out["vmap"]
    twin, t_wall, t_launch, t_peak = out["map"]
    if srch.winner != twin.winner:
        raise AssertionError("protected bracket: winners differ")
    for a, b in zip(srch.rungs, twin.rungs):
        for f in ("candidates", "severity", "order", "survivors"):
            if not np.array_equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"protected bracket rung {a.rung}: "
                                     f"{f} differs from the map twin's")
        compare_fleets(a.summaries, b.summaries,
                       f"protected bracket rung {a.rung}")
    trips = [np.asarray(r.severity).tolist() for r in srch.rungs]
    if not any(t > 0 for r in trips for t in r):
        raise AssertionError("protected bracket: no breaker tripped")
    source = port.TorchDraws(33, "cuda")
    r0 = srch.rungs[0]
    fleet = storm.run_policies_ensemble(load, r0.cum_requests, source,
                                        spec("vmap").candidates, **kw)
    # both fold the same 16 members in one chunk on the same draws
    if r0.chunk != fleet.chunk:
        raise AssertionError(f"protected rung 0: chunk {r0.chunk}, "
                             f"run_policies_ensemble's {fleet.chunk}")
    for f in fleet.summaries._fields:
        if f != "metrics":
            _same(getattr(r0.summaries, f), getattr(fleet.summaries, f),
                  f"protected rung 0 against run_policies_ensemble {f}")
    full = storm.run_policies_ensemble(load, c["n"], source,
                                       spec("vmap").candidates, **kw)
    for f in ("count", "error_count", "hop_events"):
        _same(getattr(srch.winner_summary(), f),
              getattr(full.member(srch.winner), f),
              f"protected winner's resumed segments {f}")
    hist_band(srch.winner_summary().latency_hist[None],
              full.member(srch.winner).latency_hist[None],
              "protected winner's resumed segments latency_hist")
    hops = float(srch.pooled().hop_events)
    log(f"protected bracket (the storm topology, {c['members']} "
        f"candidates, eta {c['eta']}, rank {c['rank']}, {c['n']} requests "
        f"in blocks of {c['block']} at {c['qps']:g} qps, "
        f"{c['window_s']:g} s windows): folded wall {wall * 1e3:.2f} ms "
        f"(chunks {[r.chunk for r in srch.rungs]}), {hops / wall:.4e} "
        f"pooled hop-events/s, census launches {n_launch}, peak "
        f"{peak:.3f} GiB; map twin {t_wall * 1e3:.2f} ms, census launches "
        f"{t_launch}, peak {t_peak:.3f} GiB; trips a candidate by rung "
        f"{trips}; winner {srch.winner}; the lineages equal, the rungs by "
        f"the folded contract; rung 0 == run_policies_ensemble bit for "
        f"bit (chunk {r0.chunk} both) and the winner's resume == the "
        "unbroken row (counts exactly, histogram within a bucket)")
    return {"protected bracket": n_launch,
            "protected bracket map twin": t_launch}


def _split_estimate(port, chaos_sim, split, n, block, source, mode=None):
    """The reference bench's splitting estimate (bench.py:700-795) on
    ``chaos_sim``: each level one protected fleet of jittered members
    (in ``mode``; None: the device's), member ``w`` on
    ``RootedSource(source, w)``.  Returns ``(document, the levels'
    folded chunks)``."""
    from isotope_tpu_torch.resilience import faults
    from isotope_tpu_torch.sim import splitting as split_mod
    from isotope_tpu_torch.sim.draws import RootedSource
    from isotope_tpu_torch.sim.ensemble import EnsembleSpec

    jitter = faults.ChaosJitterSpec(**CHAOSFLEET["jitter"])
    chaos = tuple(chaos_sim._chaos_events)
    reps = chaos_sim.compiled.services.replicas_by_name()
    load = port.LoadModel(kind="open", qps=CHAOSFLEET["qps"])
    chunks = []

    def evaluate(chaos_seeds, work_seeds):
        mc = [faults.jitter_chaos_events(chaos, jitter, row, reps)
              for row in np.asarray(chaos_seeds)]
        fleet = chaos_sim.run_policies_ensemble(
            load, n, source, EnsembleSpec.of(len(work_seeds), mode=mode),
            block_size=block, window_s=CHAOSFLEET["window_s"],
            member_keys=[RootedSource(source, int(w)) for w in work_seeds],
            member_chaos=mc)
        chunks.append(-(-len(work_seeds) // fleet.chunk))
        return split_mod.severity_scores(split, fleet.summaries,
                                         fleet.timelines)

    doc = split_mod.subset_estimate(evaluate, split,
                                    chaos_components=len(chaos))
    return doc, chunks


def splitting_run(port, chaos_sim, timing):
    """The splitting estimate at svc1000-chaosfleet: 8 protected members
    a level, 3 levels, keep 0.25, err_peak past ``max(2 x worst, 0.2)``
    (the worst of a plain 8-member fleet of the case), its levels
    folded (the card's auto mode) beside its ``"map"`` twin: the
    documents equal; then its compressed twin (1,024 requests in blocks
    of 512) on the card and on the CPU from one draw source: the
    documents equal."""
    from isotope_tpu_torch.resilience import faults
    from isotope_tpu_torch.sim.ensemble import EnsembleSpec
    from isotope_tpu_torch.sim.splitting import SplitSpec

    cf = CHAOSFLEET
    load = port.LoadModel(kind="open", qps=cf["qps"])
    fleet = chaos_sim.run_policies_ensemble(
        load, cf["n"], port.TorchDraws(34, "cuda"),
        EnsembleSpec.of(cf["members"]), block_size=cf["block"],
        window_s=cf["window_s"],
        member_chaos=faults.ChaosJitterSpec(**cf["jitter"]))
    worst = float(fleet.severity().max())
    split = SplitSpec(levels=3, members=cf["members"], keep=0.25,
                      threshold=max(2.0 * worst, 0.2), severity="err_peak")
    blocks = -(-cf["n"] // cf["block"])
    calls = len(census_calls(chaos_sim, cf["block"]))
    out = {}
    for mode in ("vmap", "map"):
        kinds = len(chaos_sim._fleet_pilots)
        (doc, chunks), wall, n_launch, peak = fleet_wall(
            port, f"splitting {mode}", lambda mode=mode: _split_estimate(
                port, chaos_sim, split, cf["n"], cf["block"],
                port.TorchDraws(35, "cuda"), mode), 0, 0)
        want = (sum(chunks) if mode == "vmap" else doc["evaluations"]) \
            * blocks * calls + pilot_launches(chaos_sim, kinds, calls)
        if n_launch != want:
            raise AssertionError(f"splitting {mode}: {n_launch} launches, "
                                 f"expected {want}")
        out[mode] = (doc, wall, n_launch, peak, chunks)
    doc, wall, n_launch, peak, chunks = out["vmap"]
    twin, t_wall, t_launch, t_peak, _ = out["map"]
    if doc != twin:
        raise AssertionError(f"splitting: folded {doc} != map {twin}")
    log(f"splitting at svc1000-chaosfleet (threshold {split.threshold:g}, "
        f"the fleet's worst {worst:.6f}): p {doc['p']:.6g}, CI "
        f"[{doc['ci_lo']:.6g}, {doc['ci_hi']:.6g}], "
        f"{doc['evaluations']} member runs over {len(doc['levels'])} "
        f"level(s) in {len(chunks)} folded fleets ({sum(chunks)} chunks), "
        f"wall {wall * 1e3:.2f} ms, census launches {n_launch} (device ~"
        f"{timing['ms_per_block']['svc1000-chaosfleet (8 folded)'] * sum(chunks) * blocks:.4f}"
        f" ms, phase 3), peak {peak:.3f} GiB; map twin {t_wall * 1e3:.2f} "
        f"ms, census launches {t_launch}, peak {t_peak:.3f} GiB; the "
        f"documents equal")
    twin_split = dataclasses.replace(split, threshold=max(worst, 0.05))
    source = port.TorchDraws(36, "cuda")
    docs = {}
    for device in ("cuda", "cpu"):
        sim = chaos_sim if device == "cuda" else chaosfleet_sim(port, "cpu")
        t = time.perf_counter()
        docs[device], _ = _split_estimate(port, sim, twin_split,
                                          SPLIT_TWIN["n"],
                                          SPLIT_TWIN["block"], source)
        log(f"splitting twin on {device}: {time.perf_counter() - t:.1f} s")
    if docs["cuda"] != docs["cpu"]:
        raise AssertionError(f"splitting twin: card {docs['cuda']} != "
                             f"cpu {docs['cpu']}")
    log(f"splitting twin ({SPLIT_TWIN['n']} requests in blocks of "
        f"{SPLIT_TWIN['block']}, threshold {twin_split.threshold:g}): p "
        f"{docs['cuda']['p']:.6g} in {docs['cuda']['evaluations']} member "
        "runs; card (folded levels) == cpu (map), document for document")
    return {"splitting": n_launch, "splitting map twin": t_launch}


def cli_search_phase():
    """``search`` on canonical.yaml (16 candidates, eta 4, 2 rungs,
    ``--json``) and ``simulate --ensemble 8 --ensemble-jitter ...
    --ensemble-chaos-jitter ... --ensemble-split ... --split-horizon
    0.5`` on it, on the card and with ``--device cpu`` in this process
    on one draw source (``cli_capture``): the search documents agree but
    for their mode (the card folds the rungs), the ensemble documents
    with their splitting blocks agree (``docs_close``)."""
    import io

    from isotope_tpu_torch import cli as port_cli
    from isotope_tpu_torch.sim import TorchDraws

    cases = {
        "search": ["search", str(TOPOLOGIES / "canonical.yaml"), "--qps",
                   "1000", "--duration", "4s", "--candidates", "16",
                   "--eta", "4", "--rungs", "2", "--json"],
        "split": ["simulate", str(TOPOLOGIES / "canonical.yaml"), "--qps",
                  "1000", "--duration", "4s", "--load-kind", "open",
                  "--ensemble", "8", "--ensemble-jitter", FLEET_JITTER,
                  "--ensemble-chaos-jitter", "time=0.3,magnitude=0.5",
                  "--ensemble-split",
                  "levels=3,members=8,keep=0.25,threshold=1.0,sev=p99,"
                  "slo=0.0036", "--split-horizon", "0.5"],
    }
    with tempfile.TemporaryDirectory() as tmp:
        for case, argv in cases.items():
            docs = {}
            for device in ("cuda", "cpu"):
                out_file = pathlib.Path(tmp) / f"{case}-{device}.json"
                extra = (["--ensemble-out", str(out_file)]
                         if case == "split" else [])
                buf, err = io.StringIO(), io.StringIO()
                t = time.perf_counter()
                with contextlib.redirect_stdout(buf), \
                        contextlib.redirect_stderr(err), \
                        cli_capture(TorchDraws(0, "cpu")):
                    rc = port_cli.main(argv + ["--device", device] + extra)
                if rc != 0:
                    raise AssertionError(f"{case} on {device}: rc {rc}")
                docs[device] = (json.loads(out_file.read_text())
                                if case == "split"
                                else json.loads(buf.getvalue()))
                log(f"cli {' '.join(argv[:1] + argv[2:])} on {device}: "
                    f"{time.perf_counter() - t:.1f} s")
            got, want = docs["cuda"], docs["cpu"]
            if case == "search":
                if (got.pop("mode"), want.pop("mode")) != ("vmap", "map"):
                    raise AssertionError("cli search: modes")
                docs_close(got, want, "search")
                log(f"cli search: card (vmap) == cpu (map), winner "
                    f"{got['winner']['candidate']}, lineage "
                    + " -> ".join(str(r['survivors'])
                                  for r in got["lineage"]))
            else:
                docs_close(got, want, "ensemble")
                sp = got["splitting"]
                log(f"cli simulate --ensemble-split: card == cpu, p "
                    f"{sp['p']:.6g} [{sp['ci_lo']:.6g}, {sp['ci_hi']:.6g}]"
                    f" in {sp['evaluations']} member runs")


# -- phase 8: the experiment runner -------------------------------------------

#: the suite of phase 8: the reference's benchmark envelopes, unchanged
RUNNER_CONFIGS = ("configs/latency.toml", "configs/cpu_mem.toml")
RUNNER_ROWS = {"latency": 30, "cpu_mem": 12}
#: the card-against-CPU twin: latency.toml's shape at 2 x 2 cases
RUNNER_TWIN = """
topology_paths = ["{topo}"]
environments = ["baseline", "both"]

[client]
qps = [1000]
num_concurrent_connections = [2, 64]
duration = "240s"
load_kind = "closed"

[sim]
num_requests = 24000
seed = 0
"""


def runner_census_runs(device="cuda", configs=RUNNER_CONFIGS):
    """The suite's census calls for phase 3, as runs: each case of
    ``configs`` on the runner's own Simulator at its own request count
    and block (its closed loop's rate pilot is added by
    ``census_check_shapes``), one run per distinct set of shapes."""
    from isotope_tpu_torch.runner.config import load_toml
    from isotope_tpu_torch.runner.run import (
        _LazyTopology,
        num_requests,
        run_label,
    )
    from isotope_tpu_torch.sim.engine import block_rows

    out, seen = [], set()
    for path in configs:
        config = load_toml(ROOT / path)
        for topo_path in config.topology_paths:
            topo = _LazyTopology(topo_path, config, device)
            for env in config.environments:
                sim = topo.sims(env)
                for load in config.load_models():
                    n = num_requests(load, sim.capacity_qps(),
                                     config.num_requests)
                    block = block_rows(load, n, sim.default_block_size())
                    key = (tuple(census_calls(sim, block)), load.kind,
                           load.qps is None)
                    if key not in seen:
                        seen.add(key)
                        label = run_label(topo_path, env.name, load)
                        out.append((f"runner {label}", sim, load, n, block))
    return out


def _port_out(args):
    """``cli.main(args)`` in this process: (exit code, stdout, stderr)."""
    import io

    from isotope_tpu_torch import cli as port_cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port_cli.main(args)
    return rc, out.getvalue(), err.getvalue()


def _csv_bytes(pub):
    return {stem: (pub / stem / "benchmark.csv").read_bytes()
            for stem in RUNNER_ROWS}


def _without_start(csv: bytes):
    rows = [line.split(",") for line in csv.decode().splitlines()]
    for row in rows:
        del row[1]  # StartTime, the wall clock
    return rows


def _rows_close(got, want, what):
    """Flat rows card against CPU: keys, strings and booleans equal,
    StartTime skipped, floats within phase 4's tolerances, an integer
    the row floors from a float within one unit plus that rtol."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: columns differ")
    for k, w in want.items():
        g = got[k]
        if k == "StartTime":
            continue
        if isinstance(w, (bool, str)) or w is None:
            ok = g == w
        elif isinstance(w, int):
            ok = abs(g - w) <= 1 + RESULT_RTOL * abs(w)
        else:
            ok = abs(g - w) <= RESULT_ATOL + RESULT_RTOL * abs(w)
        if not ok:
            raise AssertionError(f"{what}.{k}: card {g} cpu {w}")


@contextlib.contextmanager
def _timed_cases():
    """Inside: each executed case's wall and each ``run_summary``'s
    (the card synchronized at its end) are recorded."""
    from isotope_tpu_torch.runner import run as run_mod
    from isotope_tpu_torch.sim import engine

    walls = {"case": [], "run_summary": []}
    run_case, run_summary = run_mod._run_case, engine.Simulator.run_summary

    def timed_case(*a, **kw):
        t0 = time.perf_counter()
        out = run_case(*a, **kw)
        walls["case"].append(time.perf_counter() - t0)
        return out

    def timed_summary(self, *a, **kw):
        t0 = time.perf_counter()
        out = run_summary(self, *a, **kw)
        torch.cuda.synchronize()
        walls["run_summary"].append(time.perf_counter() - t0)
        return out

    run_mod._run_case = timed_case
    engine.Simulator.run_summary = timed_summary
    try:
        yield walls
    finally:
        run_mod._run_case = run_case
        engine.Simulator.run_summary = run_summary


def runner_suite(tmp):
    """The suite at the configs' own sizes, its resume and ``--fresh``;
    returns the suite's census launches."""
    from isotope_tpu_torch import telemetry
    from isotope_tpu_torch.native import census as census_mod

    configs = [str(ROOT / c) for c in RUNNER_CONFIGS]
    args = ["suite", *configs, "-o", str(tmp / "pub"), "--id", "runner"]
    pub = tmp / "pub" / "runner"
    torch.cuda.reset_peak_memory_stats()
    census_mod.census.launches = 0
    with _timed_cases() as walls:
        t0 = time.perf_counter()
        rc, _, err = _port_out(args)
        wall = time.perf_counter() - t0
    launches = census_mod.census.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    manifest = json.loads((pub / "manifest.json").read_text())
    log(f"suite: {manifest['total_runs']} runs, {manifest['total_alarms']} "
        f"alarms, {manifest['total_failed']} failed, "
        f"{manifest['total_degraded']} degraded, exit {rc}")
    if (manifest["total_runs"], manifest["total_failed"],
            manifest["total_degraded"]) != (42, 0, 0):
        raise AssertionError(f"suite manifest {manifest}:\n{err}")
    if rc != (1 if manifest["total_alarms"] else 0):
        raise AssertionError(f"suite exit {rc} against {manifest}")
    for stem, n_rows in RUNNER_ROWS.items():
        out = pub / stem
        rows = [json.loads(ln) for ln in
                (out / "results.jsonl").read_text().splitlines()]
        csv = (out / "benchmark.csv").read_text().splitlines()
        if len(rows) != n_rows or len(csv) != 1 + n_rows:
            raise AssertionError(f"{stem}: {len(rows)} rows, "
                                 f"{len(csv) - 1} CSV rows")
        for row in rows:
            for suffix in (".json", ".prom"):
                if not (out / f"{row['Labels']}{suffix}").exists():
                    raise AssertionError(f"{row['Labels']}{suffix} missing")
    case_walls = np.asarray(walls["case"])
    run_walls = float(np.sum(walls["run_summary"]))
    log(f"suite wall {wall:.3f} s, {len(case_walls)} cases: wall per case "
        f"median {np.median(case_walls) * 1e3:.2f} ms, max "
        f"{case_walls.max() * 1e3:.2f} ms; run_summary walls sum "
        f"{run_walls:.3f} s ({len(walls['run_summary'])} calls); runner "
        f"host share {1.0 - run_walls / wall:.4f}; census launches "
        f"{launches}; peak {peak:.3f} GiB")
    if len(case_walls) != 42 or launches <= 0:
        raise AssertionError("the suite did not run its 42 cases")

    csvs = _csv_bytes(pub)
    built = telemetry.counter_get("simulators_built")
    census_mod.census.launches = 0
    t0 = time.perf_counter()
    rc2, _, err = _port_out(args)
    resume_s = time.perf_counter() - t0
    if census_mod.census.launches or \
            telemetry.counter_get("simulators_built") != built:
        raise AssertionError("the resumed suite executed a case")
    if _csv_bytes(pub) != csvs or rc2 != rc:
        raise AssertionError("the resumed suite's CSVs differ")
    t0 = time.perf_counter()
    rc3, _, err = _port_out(args + ["--fresh"])
    fresh_s = time.perf_counter() - t0
    fresh = _csv_bytes(pub)
    for stem in RUNNER_ROWS:
        if _without_start(fresh[stem]) != _without_start(csvs[stem]):
            raise AssertionError(f"--fresh {stem}: the CSV differs")
    log(f"resume {resume_s:.3f} s (no case run, CSVs byte for byte); "
        f"--fresh {fresh_s:.3f} s (CSVs bit for bit but StartTime)")
    return launches


def runner_twin(tmp):
    """The reduced twin swept on the card and the CPU on one draw source
    (``cli_capture``): rows within phase 4's tolerances, labels,
    columns and checkpoint keys equal."""
    from isotope_tpu_torch.sim import TorchDraws

    cfg = tmp / "twin.toml"
    cfg.write_text(RUNNER_TWIN.format(topo=TOPOLOGIES / "canonical.yaml"))
    for device in ("cuda", "cpu"):
        with cli_capture(TorchDraws(0, "cpu")):
            rc, _, err = _port_out(["sweep", str(cfg), "-o",
                                    str(tmp / device), "--device", device])
        if rc != 0:
            raise AssertionError(f"twin sweep on {device}: exit {rc}\n{err}")
    got_csv = (tmp / "cuda" / "benchmark.csv").read_text().splitlines()
    want_csv = (tmp / "cpu" / "benchmark.csv").read_text().splitlines()
    if got_csv[0] != want_csv[0]:
        raise AssertionError("twin: CSV columns differ")
    got = [json.loads(ln) for ln in
           (tmp / "cuda" / "results.jsonl").read_text().splitlines()]
    want = [json.loads(ln) for ln in
            (tmp / "cpu" / "results.jsonl").read_text().splitlines()]
    if [r["Labels"] for r in got] != [r["Labels"] for r in want] or \
            len(got) != 4:
        raise AssertionError("twin: labels differ")
    for g, w in zip(got, want):
        _rows_close(g, w, g["Labels"])
    keys = [[sorted(json.loads(ln)) for ln in
             (tmp / d / "checkpoint.jsonl").read_text().splitlines()[1:]]
            for d in ("cuda", "cpu")]
    if keys[0] != keys[1]:
        raise AssertionError("twin: checkpoint keys differ")
    log(f"twin sweep: 4 cases card == CPU (rtol {RESULT_RTOL}); "
        f"p99 {[r['p99'] for r in got]} us")
    return cfg


def runner_supervisor(tmp, cfg):
    """An injected OOM served degraded (the fault plan from the
    environment, through the module entry), and a poisoned case failed
    while the sweep goes on."""
    import os

    from isotope_tpu_torch.resilience import NumericSentinelError, faults
    from isotope_tpu_torch.runner.config import load_toml
    from isotope_tpu_torch.runner.run import run_experiment

    out = subprocess.run(
        [sys.executable, "-m", "isotope_tpu_torch", "sweep", str(cfg),
         "-o", str(tmp / "oom")],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, ISOTOPE_FAULT_INJECT="oom:engine.run:1"),
    )
    rows = [json.loads(ln) for ln in
            (tmp / "oom" / "results.jsonl").read_text().splitlines()]
    degraded = [r.get("degraded_to") for r in rows]
    if out.returncode != 0 or degraded != ["half-block", None, None, None] \
            or "1 run(s) completed DEGRADED" not in out.stderr:
        raise AssertionError(f"oom sweep: exit {out.returncode}, degraded "
                             f"{degraded}\n{out.stderr}")
    poisoned = "canonical_both_1000qps_2c"

    def poison(label):
        if label == poisoned:
            faults.install("nan:segment:0")
        else:
            faults.clear()

    try:
        results = run_experiment(load_toml(cfg), out_dir=str(tmp / "nan"),
                                 progress=poison)
    finally:
        faults.clear()
    failed = [r.label for r in results if r.failed]
    if failed != [poisoned] or "sentinel" not in results[2].error:
        raise AssertionError(f"nan sweep: failed {failed}")
    if not isinstance(results[2].cause, NumericSentinelError):
        raise AssertionError(f"nan sweep: {results[2].cause!r}")
    log(f"supervisor: oom:engine.run:1 -> {rows[0]['Labels']} DEGRADED to "
        f"half-block (sentinels passed); nan:segment:0 -> {poisoned} "
        "FAILED, the other 3 cases served")


def runner_phase():
    """Phase 8 (see the module docstring); returns the suite's census
    launches."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        launches = runner_suite(tmp)
        cfg = runner_twin(tmp)
        runner_supervisor(tmp, cfg)
        log(f"runner phase {time.perf_counter() - t0:.1f} s")
    return launches


# -- phase 7: the DES oracle --------------------------------------------------


def oracle_phase(port, device="cuda", scale=1):
    """The engine on the card against the DES oracle: exact parity
    cases, then the fidelity cases (their oracle runs in threads on the
    host while the card runs the engine), each at its requests over
    ``scale``."""
    from concurrent.futures import ThreadPoolExecutor

    from isotope_tpu_torch.native.host import load_library
    from isotope_tpu_torch.sim.oracle import OracleSimulator

    t = time.perf_counter()
    load_library("des_oracle")
    log(f"build: des_oracle (g++) in {time.perf_counter() - t:.2f} s")
    det = port.SimParams(service_time="deterministic")
    quiet = port.LoadModel(kind="open", qps=0.001, duration_s=1.0)
    for name, text in PARITY.items():
        graph = port.ServiceGraph.from_yaml(text)
        chaos = (
            (port.ChaosEvent(service="b", start_s=0.0, end_s=1e9),)
            if name == "chaos-total-outage" else ()
        )
        res_e = port.Simulator(port.compile_graph(graph), det, chaos,
                               device=device).run(
            quiet, 32, port.TorchDraws(0, device))
        res_o = OracleSimulator(graph, det, chaos).run(quiet, 32, seed=0)
        lat_e = res_e.client_latency.double().cpu().numpy()
        np.testing.assert_allclose(res_o.client_latency, lat_e,
                                   rtol=PARITY_RTOL, err_msg=name)
        np.testing.assert_array_equal(
            res_o.client_error, res_e.client_error.cpu().numpy(), name)
        if res_o.hop_events != int(res_e.hop_events):
            raise AssertionError(f"oracle parity {name}: hop events")
        rel = float(np.max(np.abs(lat_e / res_o.client_latency - 1.0)))
        log(f"oracle parity ok {name}: 32 requests, largest relative "
            f"difference {rel:.3e}, {int(res_o.client_error.sum())} errors,"
            f" {res_o.hop_events} hop events")

    mu = 1.0 / port.SimParams().cpu_time_s
    cases = [
        (f"{name} open rho {rho:g}", text,
         port.LoadModel(kind="open", qps=rho * mu), 200_000 // scale,
         1_000_000 // scale)
        for name, text in (("chain3", CHAIN3), ("tree13", TREE13),
                           ("star9", STAR9))
        for rho in (0.3, 0.7)
    ] + [("chain3 paced closed c=64", CHAIN3,
          port.LoadModel(kind="closed", qps=0.5 * mu, connections=64),
          128_000 // scale, 512_000 // scale)]
    with ThreadPoolExecutor(max_workers=len(cases)) as pool:
        t = time.perf_counter()
        futures = [
            pool.submit(OracleSimulator(port.ServiceGraph.from_yaml(text))
                        .run, load, n_o, 0)
            for _, text, load, _, n_o in cases
        ]
        for (name, text, load, n_e, n_o), fut in zip(cases, futures):
            engine = port.Simulator(
                port.compile_graph(port.ServiceGraph.from_yaml(text)),
                device=device)
            res_e = engine.run(load, n_e, port.TorchDraws(0, device))
            lat_e = res_e.client_latency.double().cpu().numpy()
            res_o = fut.result()
            lat_o = res_o.client_latency[
                res_o.client_start >= ORACLE_WARMUP_S]
            rels = [float(np.quantile(lat_e, q) / np.quantile(lat_o, q)
                          - 1.0) for q in (0.5, 0.99)]
            line = (f"oracle fidelity {name}: engine {n_e} on the card, "
                    f"oracle {n_o}; p50 {rels[0]:+.4%}, p99 {rels[1]:+.4%}")
            bad = any(abs(r) > FIDELITY_BAND for r in rels)
            if load.kind == "closed":
                thr_o = len(res_o.client_latency) / float(
                    res_o.client_end.max())
                thr = float(res_e.offered_qps) / thr_o - 1.0
                line += f", throughput {thr:+.4%}"
                bad = bad or abs(thr) > THROUGHPUT_BAND
            log(line)
            if bad:
                raise AssertionError(f"oracle fidelity {name} out of band")
        log(f"oracle fidelity: {len(cases)} cases in "
            f"{time.perf_counter() - t:.1f} s")
    run_gates(port, oracle_gates(), device)


def run_gates(port, gates, device="cuda"):
    """Each gate's oracle in a thread on the host while its engine runs
    on ``device``; a gate out of band raises."""
    from concurrent.futures import ThreadPoolExecutor

    t = time.perf_counter()
    with ThreadPoolExecutor(max_workers=8) as pool:
        futures = [pool.submit(g.oracle, port) for g in gates]
        for g, fut in zip(gates, futures):
            log(g.check(g.engine(port, device), fut.result()))
    log(f"oracle gates: {len(gates)} in {time.perf_counter() - t:.1f} s")


# -- phase 9: the calibration path --------------------------------------------

#: the vendored ``fortio load -json`` artifact (closed loop, 16
#: connections, 1000 qps) and its topology
FIDELITY_ARTIFACT = ROOT / "tests" / "data" / "fortio_canonical_sample.json"
FIDELITY_TOPOLOGY = TOPOLOGIES / "canonical.yaml"
#: ``check_fidelity``'s block (``run_summary``'s default)
FIDELITY_BLOCK = 65_536
#: the perturbed artifact: every percentile x 1.2 (tests/test_fidelity.py)
FIDELITY_PERTURB = 1.2
#: the ingest closure's source at a user's size: phase 5's
#: ``1000-svc_2000-end`` run (open loop, 10,000 qps, 8 x 32,768),
#: recorded with 1 s windows
CALIBRATION_TOPOLOGY = TOPOLOGIES / "1000-svc_2000-end.yaml"
CALIBRATION_QPS = 10_000.0
CALIBRATION_BLOCK, CALIBRATION_BLOCKS = 32_768, 8
CALIBRATION_WINDOW_S = 1.0
#: the card-against-CPU twin of the closure
CALIBRATION_TWIN_N = 16_384
#: the CPU recording whose fit gives phase 3 the fitted topology (its
#: structure, hence its census shapes, does not depend on the size: every
#: request of the source visits every service)
CALIBRATION_SHAPE_N = 2_048


def fidelity_case(device="cuda"):
    """``fidelity``'s run as ``check_fidelity`` builds it from the
    artifact: (Simulator, load, requests, block)."""
    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.metrics.fidelity import load_from_artifact
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.sim import Simulator
    from isotope_tpu_torch.sim.engine import block_rows

    doc = json.loads(FIDELITY_ARTIFACT.read_text())
    load, duration_s = load_from_artifact(doc)
    n = int(min(max(float(doc["ActualQPS"]) * duration_s, 10_000),
                1_000_000))
    sim = Simulator(compile_graph(ServiceGraph.from_yaml_file(
        FIDELITY_TOPOLOGY)), device=device)
    return sim, load, n, block_rows(load, n, FIDELITY_BLOCK)


def calibration_sim(device):
    from isotope_tpu_torch.compiler import compile_graph
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.sim import SimParams, Simulator

    graph = ServiceGraph.from_yaml_file(CALIBRATION_TOPOLOGY)
    params = SimParams(timeline=True,
                       timeline_window_s=CALIBRATION_WINDOW_S)
    return graph, Simulator(compile_graph(graph), params, device=device)


def record_source(device, n, block, source):
    """The closure's source run through the flight recorder with a
    ``MetricsCollector``: (graph, Simulator, the two expositions, the
    run's wall on ``device``)."""
    from isotope_tpu_torch.metrics import timeline as timeline_mod
    from isotope_tpu_torch.metrics.prometheus import MetricsCollector
    from isotope_tpu_torch.sim import LoadModel

    graph, sim = calibration_sim(device)
    collector = MetricsCollector(sim.compiled)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary, tl = sim.run_timeline(
        LoadModel(kind="open", qps=CALIBRATION_QPS), n, source,
        collector=collector, window_s=CALIBRATION_WINDOW_S,
        block_size=block)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    texts = (collector.full_text(summary),
             timeline_mod.prometheus_text(sim.compiled, tl))
    return graph, sim, texts, wall


def write_texts(texts, obs_dir):
    """The two expositions written to ``obs_dir``: their paths."""
    obs_dir.mkdir(parents=True, exist_ok=True)
    paths = [obs_dir / "full.prom", obs_dir / "timeline.prom"]
    for path, text in zip(paths, texts):
        path.write_text(text)
    return paths


def fit_paths(paths, label="fit"):
    """The ingest API's fit of the expositions at ``paths``:
    (Observation, FitResult)."""
    from isotope_tpu_torch.ingest import FitOptions, fit, read_path

    obs = None
    for path in paths:
        obs = read_path(str(path), obs=obs)
    return obs, fit(obs, FitOptions(label=label))


def fit_texts(texts, obs_dir, label="fit"):
    """The ingest API's fit of the two expositions (written to
    ``obs_dir``): (paths, Observation, FitResult)."""
    paths = write_texts(texts, obs_dir)
    return (paths, *fit_paths(paths, label))


def calibration_census_runs(device="cuda"):
    """Phase 9's census calls for phase 3, as runs: ``fidelity``'s
    paced closed loop (its rate pilot added by ``census_check_shapes``),
    the closure's source (phase 5's run) and its twin, and the fitted
    configuration's sweep at its default block, the fitted topology
    taken from a CPU recording of ``CALIBRATION_SHAPE_N`` requests (phase
    9 checks that the sweep it runs makes no other call)."""
    from isotope_tpu_torch.runner.config import load_toml
    from isotope_tpu_torch.runner.run import _LazyTopology
    from isotope_tpu_torch.sim import LoadModel, TorchDraws

    sim, load, n, block = fidelity_case(device)
    runs = [("fidelity canonical", sim, load, n, block)]
    _, src = calibration_sim(device)
    open_load = LoadModel(kind="open", qps=CALIBRATION_QPS)
    runs += [("calibration source", src, open_load,
              CALIBRATION_BLOCKS * CALIBRATION_BLOCK, CALIBRATION_BLOCK),
             ("calibration twin", src, open_load, CALIBRATION_TWIN_N,
              CALIBRATION_TWIN_N)]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        _, _, texts, _ = record_source("cpu", CALIBRATION_SHAPE_N,
                                       CALIBRATION_SHAPE_N,
                                       TorchDraws(0, "cpu"))
        _, _, fr = fit_texts(texts, tmp)
        (tmp / "fit.yaml").write_text(fr.graph.to_yaml())
        (tmp / "fit.toml").write_text(fr.toml_text)
        config = load_toml(tmp / "fit.toml")
        topo = _LazyTopology(config.topology_paths[0], config, device)
        fitted = topo.sims(config.environments[0])
    block = fitted.default_block_size()
    runs.append(("calibration fitted sweep", fitted,
                 next(iter(config.load_models())), CALIBRATION_BLOCKS * block,
                 block))
    return runs


def _fidelity_cli(args, source):
    rc, out, err, _ = _in_process(["fidelity", str(FIDELITY_TOPOLOGY),
                                   "--json", *args], source)
    return rc, json.loads(out) if out.strip() else None, err


def fidelity_step(tmp, census_mod):
    """``fidelity`` on the vendored artifact on the card as a user runs
    it (its own draws, on the card: timed, its census launches counted),
    then the card and the CPU on one CPU draw source (the percentiles
    within RESULT_RTOL), and the perturbed artifact on the card; returns
    the user's run's census launches."""
    from isotope_tpu_torch.sim import TorchDraws

    artifact = ["--fortio", str(FIDELITY_ARTIFACT)]
    command = ["fidelity", str(FIDELITY_TOPOLOGY), "--json"]
    census_mod.census.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc, out, err = _port_out(command + artifact)
    wall = time.perf_counter() - t0
    launches = census_mod.census.launches
    card = json.loads(out) if out.strip() else None
    if rc != 0 or not card or not card["ok"]:
        raise AssertionError(f"fidelity on the card: exit {rc}\n{err}")
    _, load, n, block = fidelity_case("cpu")
    rels = ", ".join(f"p{d['percentile']:g} {d['rel_err']:+.4%}"
                     for d in card["percentiles"])
    log(f"fidelity canonical.yaml (closed, {load.connections} connections, "
        f"{load.qps:g} qps, {n} requests in blocks of {block}): exit {rc}, "
        f"wall {wall:.3f} s on the card (its own draws), census launches "
        f"{launches}; {rels}; sim qps {card['actual_qps']['sim']:.3f} "
        f"against {card['actual_qps']['fortio']:.3f}")
    source = TorchDraws(0, "cpu")
    rc, card, err = _fidelity_cli(artifact, source)
    if rc != 0 or not card or not card["ok"]:
        raise AssertionError(f"fidelity on the card, CPU draws: exit {rc}"
                             f"\n{err}")
    rc_cpu, cpu, err = _fidelity_cli(artifact + ["--device", "cpu"], source)
    if rc_cpu != rc or not cpu or [d["percentile"] for d in
                                   cpu["percentiles"]] != [
            d["percentile"] for d in card["percentiles"]]:
        raise AssertionError(f"fidelity on the CPU: exit {rc_cpu}\n{err}")
    worst = 0.0
    for g, w in zip(card["percentiles"], cpu["percentiles"]):
        diff = abs(g["sim_s"] - w["sim_s"])
        worst = max(worst, diff / (RESULT_ATOL + RESULT_RTOL
                                   * abs(w["sim_s"])))
        if diff > RESULT_ATOL + RESULT_RTOL * abs(w["sim_s"]):
            raise AssertionError(f"fidelity p{g['percentile']}: card "
                                 f"{g['sim_s']} cpu {w['sim_s']}")
    log(f"fidelity card == CPU (rtol {RESULT_RTOL}, atol {RESULT_ATOL}: "
        f"largest difference {worst:.3f} of its tolerance)")
    doc = json.loads(FIDELITY_ARTIFACT.read_text())
    for p in doc["DurationHistogram"]["Percentiles"]:
        p["Value"] *= FIDELITY_PERTURB
    perturbed = tmp / "perturbed.json"
    perturbed.write_text(json.dumps(doc))
    rc, out, err = _port_out(command + ["--fortio", str(perturbed)])
    bad = json.loads(out) if out.strip() else None
    if rc != 1 or not bad or bad["ok"]:
        raise AssertionError(f"fidelity, perturbed artifact: exit {rc}")
    log(f"fidelity, every artifact percentile x {FIDELITY_PERTURB}: exit "
        f"{rc} on the card (" + ", ".join(
            f"p{d['percentile']:g} {d['rel_err']:+.2%}"
            for d in bad["percentiles"]) + ")")
    return launches


def _unfloat(text):
    return re.sub(r"\d+(\.\d+)?(e[-+]?\d+)?", "#", text)


def ingest_step(tmp, graph, texts, label="fit"):
    """``ingest`` over the two expositions (in process, the port's
    CLI; its host seconds are this call's alone), then the API's fit of
    the same files, which must equal the CLI's, and its closure against
    the source, stamped into the report: (fit dir, Observation,
    FitResult, closure, host seconds)."""
    from isotope_tpu_torch.ingest import closure_check, report
    from isotope_tpu_torch.sim import SimParams

    fit_dir = tmp / label
    paths = write_texts(texts, tmp / f"{label}-obs")
    t0 = time.perf_counter()
    rc, _, err = _port_out(["ingest", *map(str, paths), "--label", label,
                            "-o", str(fit_dir)])
    host_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"ingest: exit {rc}\n{err}")
    import yaml

    obs, fr = fit_paths(paths, label)
    if (fit_dir / f"{label}.toml").read_text() != fr.toml_text or \
            (fit_dir / f"{label}.yaml").read_text() != yaml.safe_dump(
                fr.topology_doc, default_flow_style=False, sort_keys=False):
        raise AssertionError("ingest: the CLI's fit is not the API's")
    closure = closure_check(graph, SimParams().cpu_time_s,
                            [CALIBRATION_QPS], fr)
    doc_path = fit_dir / f"{label}.ingest.json"
    doc = report.load_doc(str(doc_path))
    doc["closure"] = closure
    report.save_doc(doc, str(doc_path))
    return fit_dir, obs, fr, closure, host_s


def closure_verdict(graph, fr, closure):
    """Log the closure's verdict and every check; the fit must keep every
    service and edge and the source's degree sequence."""
    by = {c["check"]: c for c in closure["checks"]}
    log(f"closure: {'PASS' if closure['ok'] else 'FAIL'}; " + "; ".join(
        f"{c['check']} {'ok' if c['ok'] else 'OUT'} ("
        + ", ".join(f"{k} {v}" for k, v in c.items()
                    if k not in ("check", "ok") and not isinstance(v, list))
        + ")" for c in closure["checks"]))
    if fr.dropped["services"] or fr.dropped["edges"]:
        raise AssertionError(f"closure: the fit dropped {fr.dropped}")
    deg = by["degree_sequence"]
    if not deg["ok"] or deg["source"] != deg["fitted"] or \
            len(fr.graph.services) != len(graph.services):
        raise AssertionError("closure: the degree sequence differs")
    # the JAX package's own closure passes on this source (checked on the
    # CPU at 131,072 requests), so the port's must too
    if not closure["ok"]:
        raise AssertionError("closure: the fit fails its self-closure")


def closure_twin(tmp):
    """The closure at ``CALIBRATION_TWIN_N`` requests on the card and the
    CPU on one CPU draw source: fitted documents within rtol 1e-5, the
    YAML and TOML line by line up to float formatting."""
    from isotope_tpu_torch.ingest import report
    from isotope_tpu_torch.sim import TorchDraws

    fits = {}
    for device in ("cuda", "cpu"):
        _, _, texts, _ = record_source(device, CALIBRATION_TWIN_N,
                                       CALIBRATION_TWIN_N,
                                       TorchDraws(0, "cpu"))
        _, obs, fr = fit_texts(texts, tmp / f"twin-{device}")
        fits[device] = (report.to_doc(fr, obs)["fit"], fr)
    (got, gfr), (want, wfr) = fits["cuda"], fits["cpu"]
    worst = docs_close(got, want, "twin fit", rtol=RESULT_RTOL,
                       skip=(), counts=())
    for a, b in ((gfr.graph.to_yaml(), wfr.graph.to_yaml()),
                 (gfr.toml_text, wfr.toml_text)):
        if a.count("\n") != b.count("\n") or _unfloat(a) != _unfloat(b):
            raise AssertionError("twin: the fitted YAML or TOML differs")
    log(f"closure twin ({CALIBRATION_TWIN_N} requests): fitted documents "
        f"card == CPU (rtol {RESULT_RTOL}: largest difference "
        f"{worst:.3f} of its tolerance), YAML and TOML line by line")


def fitted_sweep(fit_dir, closure, checked, census_mod, label="fit"):
    """``sweep`` of the fitted configuration on the card into the fit's
    directory, then ``explain`` on it and on the report; returns the
    sweep's census launches."""
    toml = fit_dir / f"{label}.toml"
    shapes = census_check_shapes(runner_census_runs(configs=(toml,)), [])
    missing = set(shapes) - set(checked)
    if missing:
        raise AssertionError(f"phase 3 did not check {sorted(missing)}")
    census_mod.census.launches = 0
    t0 = time.perf_counter()
    rc, _, err = _port_out(["sweep", str(toml), "-o", str(fit_dir)])
    wall = time.perf_counter() - t0
    launches = census_mod.census.launches
    rows = [json.loads(ln) for ln in
            (fit_dir / "results.jsonl").read_text().splitlines()]
    bad = [r["Labels"] for r in rows
           if r.get("failed") or r.get("degraded_to")]
    if rc != 0 or not rows or bad or any(
            r.get("_ingest") != label for r in rows):
        raise AssertionError(f"fitted sweep: exit {rc}, {len(rows)} "
                             f"cases, failed or degraded {bad}\n{err}")
    log(f"fitted sweep: {len(rows)} case(s) ({rows[0]['Labels']}, "
        f"{rows[0]['RequestedQPS']} qps), wall {wall:.3f} s on the card, "
        f"census launches {launches}; p50 {rows[0]['p50']} us, p99 "
        f"{rows[0]['p99']} us")
    want = "self-closure: PASS" if closure["ok"] else "self-closure: FAIL"
    for path in (fit_dir, fit_dir / f"{label}.ingest.json"):
        rc, out, err = _port_out(["explain", str(path)])
        if rc != 0 or f"ingest '{label}'" not in out or want not in out:
            raise AssertionError(f"explain {path.name}: exit {rc}\n{out}")
    log(f"explain: the fit's directory and report render the ingest "
        f"section ({want})")
    return launches


def calibration_phase(census_mod, checked):
    """Phase 9 (see the module docstring): ``fidelity``, the ingest
    closure and the fitted sweep, each its own path, counts set to 0
    just before and read just after; ``checked`` holds the census shapes
    phase 3 checked."""
    from isotope_tpu_torch.sim import TorchDraws

    by_path = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        by_path["fidelity"] = fidelity_step(tmp, census_mod)
        census_mod.census.launches = 0
        graph, _, texts, wall = record_source(
            "cuda", CALIBRATION_BLOCKS * CALIBRATION_BLOCK,
            CALIBRATION_BLOCK, TorchDraws(0, "cuda"))
        by_path["ingest-closure"] = census_mod.census.launches
        fit_dir, _, fr, closure, host_s = ingest_step(tmp, graph, texts)
        log(f"closure source {CALIBRATION_TOPOLOGY.name} (open "
            f"{CALIBRATION_QPS:g} qps, {CALIBRATION_BLOCKS} x "
            f"{CALIBRATION_BLOCK}, {CALIBRATION_WINDOW_S:g} s windows): "
            f"recorded run {wall:.3f} s on the card, census launches "
            f"{by_path['ingest-closure']}; ingest {host_s:.3f} s on the "
            f"host ({len(fr.graph.services)} services, qps mean "
            f"{fr.qps_mean:.1f})")
        closure_verdict(graph, fr, closure)
        closure_twin(tmp)
        by_path["fitted-sweep"] = fitted_sweep(fit_dir, closure, checked,
                                               census_mod)
    log(f"calibration phase {time.perf_counter() - t0:.1f} s")
    return by_path


# -- phase 10: vet on the card -------------------------------------------------

#: phase 10's full-size topologies (phase 5's Simulators) and the
#: gradient audit's
VET_TOPOLOGIES = ("flagship", "1000-svc_2000-end", "star-10k-timeouts",
                  "svc100k-chaos", "lb-10svc-100r-panic",
                  "policies-1000svc-kill")
VET_GRAD = ("flagship", "canonical-errors")
#: own peak / estimate of the six gate runs under the one-pilot
#: estimate (the 8-request plain pilot scaled by the block), measured on
#: an NVIDIA H100 80GB HBM3 at 700 W by this script before the two-pilot
#: estimate
VET_ONE_PILOT_RATIOS = {
    "flagship": 0.9391, "1000-svc_2000-end": 0.9364,
    "star-10k-timeouts": 0.9828, "svc100k-chaos": 0.8956,
    "lb-10svc-100r-panic": 0.0633, "policies-1000svc-kill": 1.3967,
}
#: the gate's protected run: a few of its 1 s-window blocks
VET_PROTECTED_BLOCKS = 4
#: the fault-site twins: the smoke's first blocks (the kill starts at
#: 3 s), and one block of the panic topology
VET_STUCK_BLOCKS = 12
VET_DEGRADE_N = 16_384
#: the command-line runs: canonical.yaml, open 1,000 qps for 2 s
VET_CLI_TOPOLOGY = TOPOLOGIES / "canonical.yaml"
VET_CLI_LOAD = ["--qps", "1000", "--duration", "2s", "--load-kind", "open"]
VET_CLI_N = 2_000


class VetCase(NamedTuple):
    name: str
    sim: object          # on the card, built in phase 5
    load: object
    block: int           # phase 5's block
    make: Callable       # the same Simulator on another device
    graph: object        # the ServiceGraph, for the topology lint
    window: float = 0.0  # a protected run's window (0: unprotected)


def vet_cases(port, flagship_graph, runs, scenarios, prot):
    """Phase 10's six topologies, from phase 5's runs."""
    def rebuild(sim):
        return lambda device: port.Simulator(sim.compiled, sim.params,
                                             device=device)

    by_name = {r[0]: r for r in runs}
    graphs = {
        "flagship": flagship_graph,
        "1000-svc_2000-end": port.ServiceGraph.from_yaml_file(
            TOPOLOGIES / "1000-svc_2000-end.yaml"),
        "star-10k-timeouts": star10k_graph(port),
    }
    out = []
    for name in VET_TOPOLOGIES[:3]:
        _, sim, load, _, block = by_name[name]
        out.append(VetCase(name, sim, load, block, rebuild(sim),
                           graphs[name]))
    for name, sim, load, _, block, make in scenarios:
        if name in VET_TOPOLOGIES:
            out.append(VetCase(name, sim, load, block, make, make.graph))
    for name, sim, load, _, block, window, _, make in prot:
        if name in VET_TOPOLOGIES:
            out.append(VetCase(name, sim, load, block, make, make.graph,
                               window))
    assert [c.name for c in out] == list(VET_TOPOLOGIES), out
    return out


def vet_grad_sims(port, cases, device="cuda"):
    """``(name, simulator)`` of the gradient audit's topologies."""
    flagship = cases[0]
    errors = port.compile_graph(port.ServiceGraph.from_yaml_file(
        TOPOLOGIES / "canonical-errors.yaml"))
    return [
        ("flagship", flagship.sim if device == "cuda"
         else flagship.make(device)),
        ("canonical-errors", port.Simulator(errors, device=device)),
    ]


def _gate_n(case):
    """The gate run's requests: one of phase 5's blocks (a few blocks of
    a protected run's)."""
    if case.window:
        return VET_PROTECTED_BLOCKS * case.block
    return case.block


def vet_census_shapes(cases, grad_sims):
    """Every census shape phase 10 launches, for phase 3 to hold: each
    pilot block's (the audited 8 requests and the byte estimate's 16,
    unprotected; a protected case's gate also runs both sizes under its
    control effects), each gate run's block at the runner's default
    block capped by its requests, and the flagship at its half-block
    rung."""
    from isotope_tpu_torch.analysis.oplog import pilot_size
    from isotope_tpu_torch.resilience.supervisor import rung_blocks
    from isotope_tpu_torch.sim.engine import block_rows

    shapes = []
    for case in cases:
        n8 = pilot_size(case.load)
        shapes += case.sim.census_shapes(n8)
        shapes += case.sim.census_shapes(2 * n8)
        n = _gate_n(case)
        if case.window:
            shapes += census_calls(case.sim, n8)
            shapes += census_calls(case.sim, 2 * n8)
            shapes += census_calls(case.sim, case.block)
            continue
        for _, rung in rung_blocks(case.sim.default_block_size()):
            shapes += case.sim.census_shapes(block_rows(case.load, n,
                                                        rung))
            if case.name != "flagship":
                break  # only the flagship's half-block rung serves
    for _, sim in grad_sims:
        shapes += sim.census_shapes(8)
    return list(dict.fromkeys(shapes))


def vet_cli_shapes(port):
    """``(pilot, sizing pilot, run)``: the census shapes of the
    command-line runs' pilot block (8 requests of ``canonical.yaml``),
    of the byte estimate's second pilot (16) and of the simulate run's
    one block (its 2,000 requests)."""
    from isotope_tpu_torch.analysis.oplog import pilot_size
    from isotope_tpu_torch.sim.engine import block_rows

    sim = port.Simulator(port.compile_graph(
        port.ServiceGraph.from_yaml_file(VET_CLI_TOPOLOGY)), device="cuda")
    load = port.LoadModel(kind="open", qps=1000.0)
    return (sim.census_shapes(pilot_size(load)),
            sim.census_shapes(2 * pilot_size(load)),
            sim.census_shapes(block_rows(load, VET_CLI_N,
                                         sim.default_block_size())))


def _findings(report):
    return [(f.rule, f.severity, f.path, f.message) for f in report.findings]


def _cost(report):
    cost = report.meta["cost"]
    return {k: cost.get(k) for k in ("peak_bytes_at_block", "flops_at_block",
                                     "critical_path", "census_calls",
                                     "trace_requests", "oplog")}


def vet_audits(port, cases, grad_sims, device="cuda"):
    """``vet`` of each case on the card (its Simulator from phase 5, the
    card's own capacity), then on a CPU twin of the same compiled graph
    at the card's capacity: findings and cost model equal; ``--grad`` on
    the gradient audit's topologies, card against CPU.  Returns the
    census launches of the card's pilots and the reports."""
    from isotope_tpu_torch.analysis import audit_grad, vet_simulator
    from isotope_tpu_torch.analysis.costmodel import device_capacity_bytes

    launches0 = port.census.launches
    expected = 0
    reports = {}
    for case in cases:
        t = time.perf_counter()
        rep = vet_simulator(case.sim, case.load, block_requests=case.block,
                            graph=case.graph)
        sync(device)
        wall = time.perf_counter() - t
        reports[case.name] = rep
        cost = rep.meta["cost"]
        # the audited pilot and the byte estimate's second size
        expected += cost["census_calls"] + len(
            case.sim.census_shapes(cost["slope_requests"]))
        timings = rep.meta["timings_s"]
        cap = device_capacity_bytes(device=case.sim.device)
        rules = sorted({f.rule for f in rep.findings})
        rung, names = rep.meta["start_rung"], rep.meta["rung_names"]
        log(f"vet {case.name} on {device}: {wall:.3f} s (lint "
            f"{timings['lint']:.3f}, pilot {timings['pilot']:.3f}, cost "
            f"model {timings['cost']:.3f}); {len(rep.findings)} finding(s) "
            f"{rules}, {len(rep.errors)} error(s); pilot "
            f"{cost['trace_requests']} requests, {cost['census_calls']} "
            f"census calls, and {cost['slope_requests']} for the byte "
            f"estimate; estimate {cost['peak_bytes_at_block']:.6e}"
            f" B at a block of {cost['block_requests']} (tables "
            f"{cost['oplog']['external_bytes']:.6e} B, pilot high-water "
            f"{cost['oplog']['peak_bytes']:.6e} B), capacity "
            f"{cap if cap is None else f'{cap:.6e}'} B, start rung "
            f"{names[rung] if rung < len(names) else 'none (blocked)'}")
        if rep.errors:
            raise AssertionError(f"vet {case.name}: {rep.errors}")
        t = time.perf_counter()
        twin = case.make("cpu")
        t_build = time.perf_counter() - t
        t = time.perf_counter()
        cpu_rep = vet_simulator(twin, case.load, block_requests=case.block,
                                graph=case.graph, device_bytes=cap)
        if _findings(cpu_rep) != _findings(rep):
            raise AssertionError(
                f"vet {case.name}: card findings {_findings(rep)} != CPU "
                f"{_findings(cpu_rep)}")
        if _cost(cpu_rep) != _cost(rep):
            raise AssertionError(
                f"vet {case.name}: card cost {_cost(rep)} != CPU "
                f"{_cost(cpu_rep)}")
        log(f"vet {case.name}: card == cpu (findings, estimate, flops, "
            f"critical path, census calls); CPU twin built in {t_build:.3f}"
            f" s, vetted in {time.perf_counter() - t:.3f} s")
        del twin
    for (name, sim), (_, cpu_sim) in zip(grad_sims,
                                         vet_grad_sims(port, cases, "cpu")):
        t = time.perf_counter()
        _, doc = audit_grad(sim, port.LoadModel(kind="open", qps=1000.0))
        sync(device)
        wall = time.perf_counter() - t
        expected += len(sim.census_shapes(doc["traced_requests"]))
        _, cpu_doc = audit_grad(cpu_sim,
                                port.LoadModel(kind="open", qps=1000.0))
        if doc != cpu_doc:
            raise AssertionError(f"vet --grad {name}: card != CPU")
        dead = {k["name"]: k["kills"][:1] for k in doc["knobs"]
                if k["class"] == "gradient-dead"}
        log(f"vet --grad {name} on {device}: {wall:.3f} s, {doc['eqns_walked']}"
            f" ops; classes {doc['classes']}; vacuous "
            f"{doc['vacuous_objectives']}; dead knobs' first kills {dead};"
            f" card == cpu (the whole isotope-gradaudit/v1 document)")
    launches = port.census.launches - launches0
    if device == "cuda" and launches != expected:
        raise AssertionError(
            f"vet: {launches} census launches, the pilots make {expected}")
    log(f"vet: the pilots' census launches {launches}")
    return launches, reports


class _BuiltTopology:
    """A runner topology (``runner/run._LazyTopology``) over a Simulator
    phase 5 built: the gate runs ``run_experiment`` as a user calls it,
    without rebuilding svc100k-chaos or star-10k."""

    def __init__(self, case):
        from isotope_tpu_torch.metrics.prometheus import MetricsCollector

        self.path = case.name
        self.graph = case.graph
        self.compiled = case.sim.compiled
        self.collector = MetricsCollector(self.compiled)
        self.entry_response_size = float(
            self.compiled.services.response_size[self.compiled.entry_service]
        )
        self.policy_tables = case.sim._policies
        self.rollout_tables = case.sim._rollouts
        self.lb_tables = case.sim._lb
        self._sim = case.sim

    def sims(self, env):
        return self._sim

    def sharded(self, env):
        return None  # one card: no mesh


@contextlib.contextmanager
def built_topologies(cases):
    from isotope_tpu_torch.runner import run as run_mod

    built = {c.name: _BuiltTopology(c) for c in cases}
    lazy = run_mod._LazyTopology
    run_mod._LazyTopology = (
        lambda path, config, device=None, mesh_spec=None: built[path]
    )
    try:
        yield
    finally:
        run_mod._LazyTopology = lazy


def gate_config(port, case, **kw):
    """One case of ``case`` as a sweep grid: its load, its requests."""
    from isotope_tpu_torch.runner.config import (
        DEFAULT_ENVIRONMENTS,
        ExperimentConfig,
    )

    n = _gate_n(case)
    protected = bool(case.window)
    # long enough that the requests cap the run: its blocks are phase
    # 5's (a protected run's window and block need the run's duration)
    rate = min(case.load.qps, case.sim.capacity_qps())
    duration = case.load.duration_s if protected else 10.0 * n / rate
    return ExperimentConfig(
        topology_paths=(case.name,),
        environments=(DEFAULT_ENVIRONMENTS["NONE"],),
        qps=(case.load.qps,), connections=(case.load.connections,),
        duration_s=duration,
        load_kind=case.load.kind, num_requests=n,
        policies=protected, timeline=protected,
        timeline_window_s=case.window or 1.0, **kw,
    )


def _gate_run(port, case, vet, device="cuda"):
    """``run_experiment`` of one case after a peak reset: ``(result,
    launches, wall, gauges, resident bytes at the reset)``."""
    from isotope_tpu_torch import telemetry
    from isotope_tpu_torch.runner.run import run_experiment

    sync(device)
    base = torch.cuda.memory_allocated() if device == "cuda" else 0
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    launches0 = port.census.launches
    t = time.perf_counter()
    (res,) = run_experiment(gate_config(port, case), vet=vet,
                            device=device)
    sync(device)
    wall = time.perf_counter() - t
    gauges = {k: telemetry.gauge_get(k) for k in (
        "vet_peak_bytes_estimate", "device_memory_peak_bytes_max",
        "vet_peak_bytes_measured_ratio")}
    return res, port.census.launches - launches0, wall, gauges, base


def _same_case(a, b, what):
    for key in ("DurationHistogram", "ActualQPS", "ErrorsDurationHistogram",
                "RetCodes"):
        if a.fortio_json.get(key) != b.fortio_json.get(key):
            raise AssertionError(f"{what}: {key} differs")
    fa, fb = dict(a.flat, StartTime=None), dict(b.flat, StartTime=None)
    if fa != fb:
        diff = {k: (fa.get(k), fb.get(k)) for k in fa
                if fa.get(k) != fb.get(k)}
        raise AssertionError(f"{what}: flat rows differ {diff}")


def vet_gate(port, cases, reports, device="cuda"):
    """``run_experiment(vet="on")`` of each case after a peak reset,
    beside the same case un-vetted: the estimate, the measured peak and
    the ratio gauge, the summaries equal; then a case whose capacity
    puts the estimate between one and two budgets (VET-M002: served on
    ``half-block``, recorded degraded) and one that does not fit at
    half a block (VET-M001: blocked, never run).  Returns the vetted
    runs' census launches."""
    import os

    from isotope_tpu_torch import telemetry
    from isotope_tpu_torch.analysis import VetError
    from isotope_tpu_torch.analysis.costmodel import CAPACITY_FILL
    from isotope_tpu_torch.analysis.oplog import pilot_size

    launches = 0
    misses = []
    gate_est = {}
    ratios = {}
    telemetry.enable()
    try:
        with built_topologies(cases):
            for case in cases:
                res, n_l, wall, g, base = _gate_run(port, case, "on", device)
                if res.failed or res.degraded_to is not None:
                    raise AssertionError(
                        f"vet gate {case.name}: {res.error or res.degraded_to}")
                launches += n_l
                plain, *_ = _gate_run(port, case, None, device)
                _same_case(res, plain, f"vet gate {case.name}")
                est = gate_est[case.name] = g["vet_peak_bytes_estimate"]
                peak = g["device_memory_peak_bytes_max"] or 0.0
                ext = reports[case.name].meta["cost"]["oplog"][
                    "external_bytes"]
                own = peak - base + ext
                # a miss lets an out-of-memory run through: the gate
                # passes an estimate up to CAPACITY_FILL of the card
                miss = own / est > 1.0 / CAPACITY_FILL
                if miss:
                    misses.append(case.name)
                ratios[case.name] = own / est
                log(f"vet gate {case.name}: {res.label} in {wall:.3f} s, "
                    f"census launches {n_l} (pilot "
                    f"{len(case.sim.census_shapes(pilot_size(case.load)))}); "
                    f"estimate {est:.6e} B, measured peak {peak:.6e} B "
                    f"(max_memory_allocated since the reset; {base:.6e} B "
                    f"resident at the reset), ratio gauge "
                    f"{g['vet_peak_bytes_measured_ratio']}, the case's own "
                    f"peak (peak - resident + the pilot's tables) {own:.6e}"
                    f" B = {own / est:.4f} of the estimate"
                    f"{' VET MISS: own peak past estimate / CAPACITY_FILL' if miss else ''}"
                    f"; summary == the un-vetted run's")
            flagship = cases[0]
            est = gate_est["flagship"]
            os.environ["ISOTOPE_VET_DEVICE_BYTES"] = str(
                est * 0.7 / CAPACITY_FILL)
            try:
                res, n_l, wall, _, _ = _gate_run(port, flagship, "on",
                                                 device)
            finally:
                del os.environ["ISOTOPE_VET_DEVICE_BYTES"]
            if res.failed or res.degraded_to != "half-block":
                raise AssertionError(
                    f"vet gate M002: {res.error} {res.degraded_to}")
            launches += n_l
            log(f"vet gate VET-M002 flagship (capacity {est * 0.7 / CAPACITY_FILL:.6e}"
                f" B): started and served on half-block, recorded degraded "
                f"({res.degraded_to}), {n_l} census launches, {wall:.3f} s")
            os.environ["ISOTOPE_VET_DEVICE_BYTES"] = "65536"
            try:
                res, n_l, wall, _, _ = _gate_run(port, flagship, "on",
                                                 device)
            finally:
                del os.environ["ISOTOPE_VET_DEVICE_BYTES"]
            n8 = pilot_size(flagship.load)
            pilot = len(flagship.sim.census_shapes(n8)) + len(
                flagship.sim.census_shapes(2 * n8))
            if not (res.failed and isinstance(res.cause, VetError)
                    and "VET-M001" in res.error) or n_l != pilot:
                raise AssertionError(f"vet gate M001: {res.error} {n_l}")
            launches += n_l
            log(f"vet gate VET-M001 flagship (capacity 65536 B): blocked, "
                f"not run ({n_l} census launches: the pilots'); {res.error}")
    finally:
        telemetry.disable()
    for name, r in ratios.items():
        log(f"vet gate own peak / estimate {name}: {r:.4f} (one-pilot "
            f"estimate, NVIDIA H100 80GB HBM3 at 700 W: "
            f"{VET_ONE_PILOT_RATIOS[name]:.4f}); 1 / CAPACITY_FILL "
            f"{1.0 / CAPACITY_FILL:.4f}")
    if misses:
        raise AssertionError(f"vet gate: own peak past estimate / "
                             f"CAPACITY_FILL on {misses}: the gate lets "
                             "an out-of-memory run through")
    log("vet gate: vet misses none")
    return launches


def vet_fault_sites(port, prot, scenarios):
    """The policy and lb layers' behavioral fault sites on the card
    against their CPU twins: a protected run of the smoke topology with
    ``stuck:policies.stuck_breaker`` (block by block under the card's
    control effects, as phase 4) and the panic topology with
    ``degrade:lb.degraded_backend:0`` (as phase 4), beside its clean
    run."""
    from isotope_tpu_torch.resilience import faults

    smoke = [r for r in prot if r[0] == "policies-smoke"][0]
    _, sim, load, _, block, window, roll, make = smoke
    try:
        faults.install("stuck:policies.stuck_breaker")
        protected_in_situ(port, [("smoke-stuck-breaker", sim, load,
                                  VET_STUCK_BLOCKS * block, block, window,
                                  roll, make)])
    finally:
        faults.clear()
    panic = [r for r in scenarios if r[0] == "lb-10svc-100r-panic"][0]
    name, _, load, _, _, make = panic
    source = port.TorchDraws(11, "cuda")
    clean = make("cuda").run(load, VET_DEGRADE_N, source)
    try:
        faults.install("degrade:lb.degraded_backend:0")
        in_situ_phase(port, [(f"{name} degraded backend 0", make, load,
                              VET_DEGRADE_N, None, RESULT_RTOL,
                              RESULT_ATOL)])
        degraded = make("cuda").run(load, VET_DEGRADE_N, source)
    finally:
        faults.clear()
    torch.cuda.synchronize()
    log(f"fault site degrade:lb.degraded_backend:0 on {name}: mean client "
        f"latency {float(degraded.client_latency.mean()) * 1e3:.4f} ms "
        f"against {float(clean.client_latency.mean()) * 1e3:.4f} ms clean")


def _vet_doc(out):
    """A ``vet --json`` document without its timings."""
    doc = json.loads(out)
    for meta in doc["meta"].values():
        meta.pop("timings_s", None)
    return doc


def _fortio(out):
    doc = json.loads(out)
    doc.pop("StartTime", None)
    return doc


def vet_cli(port, checked):
    """The user's vet entry points on the card through ``cli.main`` in
    this process: ``vet --grad --json`` (the card's capacity) beside its
    ``--device cpu`` twin at that capacity; ``simulate --vet`` beside
    the un-vetted run; ``simulate --vet`` blocked by a 64 KiB budget.
    Returns the card's vetted runs' census launches (counts set to 0
    after the un-vetted run, read at the end)."""
    import os

    from isotope_tpu_torch.analysis.costmodel import device_capacity_bytes

    pilot, sizing, run = vet_cli_shapes(port)
    missing = set(pilot + sizing + run) - set(checked)
    if missing:
        raise AssertionError(f"phase 3 did not check {sorted(missing)}")
    topo = str(VET_CLI_TOPOLOGY)
    simulate = ["simulate", topo, *VET_CLI_LOAD]
    rc, plain, err = _port_out(simulate)
    if rc != 0:
        raise AssertionError(f"simulate on the card: exit {rc}\n{err}")
    port.census.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    rc, card, err = _port_out(["vet", topo, "--grad", "--json"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    cap = device_capacity_bytes(device="cuda")
    t = time.perf_counter()
    rc_cpu, cpu, err_cpu = _port_out(["vet", topo, "--grad", "--json",
                                      "--device", "cpu", "--device-bytes",
                                      str(cap)])
    wall_cpu = time.perf_counter() - t
    if rc != 0 or rc_cpu != rc:
        raise AssertionError(f"vet: exit {rc} on the card, {rc_cpu} on the "
                             f"CPU\n{err}\n{err_cpu}")
    card, cpu = _vet_doc(card), _vet_doc(cpu)
    meta = card["meta"][topo]
    if meta["cost"]["capacity_bytes"] != cap:
        raise AssertionError(f"vet: capacity {meta['cost']['capacity_bytes']}"
                             f" != the card's {cap}")
    if card != cpu:
        raise AssertionError("vet --grad --json: card != CPU")
    layout = meta.get("mesh_layout", {})
    if (set(layout) != {"mesh", "score_s", "pad_fraction", "comm"}
            or layout["mesh"] != "data=1,svc=1"
            or [r["collective"] for r in layout["comm"]]
            != ["psum_replicated", "psum_scatter_svc"]):
        raise AssertionError(f"vet --json: mesh_layout {layout!r}")
    log(f"cli vet canonical.yaml --grad --json: exit {rc}, {wall:.3f} s on "
        f"the card, {wall_cpu:.3f} s on the CPU; {card['summary']}; "
        f"capacity {cap:.6e} B; grad classes {meta['grad']['classes']}; "
        f"mesh_layout {layout['mesh']} (score {layout['score_s']:g} s, "
        f"{len(layout['comm'])} cost rows); card == cpu (the document but "
        f"its timings)")
    rc, vetted, err = _port_out(simulate + ["--vet"])
    if rc != 0 or _fortio(vetted) != _fortio(plain):
        raise AssertionError(f"simulate --vet: exit {rc}, document "
                             f"differs from the un-vetted run's\n{err}")
    log("cli simulate --vet canonical.yaml: exit 0, document == the "
        "un-vetted run's (but StartTime)")
    os.environ["ISOTOPE_VET_DEVICE_BYTES"] = "65536"
    try:
        rc, out, err = _port_out(simulate + ["--vet"])
    finally:
        del os.environ["ISOTOPE_VET_DEVICE_BYTES"]
    if rc != 1 or out.strip() or "error: vet found 1 blocking finding(s): " \
            "VET-M001" not in err:
        raise AssertionError(f"simulate --vet, 64 KiB: exit {rc}\n{err}")
    log("cli simulate --vet canonical.yaml, ISOTOPE_VET_DEVICE_BYTES=65536:"
        " exit 1, " + err.strip().splitlines()[-1])
    torch.cuda.synchronize()
    launches = port.census.launches
    # vet and its grad audit: a pilot each, vet's byte estimate a
    # second size; simulate --vet: both pilots and the run's block; the
    # blocked run: its pilots only
    expected = 4 * len(pilot) + 3 * len(sizing) + len(run)
    if launches != expected:
        raise AssertionError(f"vet cli: {launches} census launches, "
                             f"expected {expected}")
    log(f"vet cli: census launches {launches}")
    return launches


def sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def vet_phase(port, cases, grad_sims, prot, scenarios, checked):
    """Phase 10: ``vet`` on the card.  Returns the census launches by
    path: ``vet`` (the pilots), ``vet-gate`` (the vetted runs) and
    ``vet-cli`` (the command-line runs); ``checked`` holds the census
    shapes phase 3 checked."""
    t = time.perf_counter()
    port.census.launches = 0
    launches, reports = vet_audits(port, cases, grad_sims)
    out = {"vet": launches}
    if launches <= 0:
        raise AssertionError("vet: the pilots launched no census")
    port.census.launches = 0
    out["vet-gate"] = vet_gate(port, cases, reports)
    vet_fault_sites(port, prot, scenarios)
    out["vet-cli"] = vet_cli(port, checked)
    log(f"vet phase {time.perf_counter() - t:.1f} s")
    return out


# -- phase 11: the device mesh -------------------------------------------------

#: the reference dryrun's topology (``__graft_entry__.py``) at full width
MESH_SERVICES = 1_024
MESH_QPS = 500.0
MESH_BLOCK = 32_768
MESH_BLOCKS = 2
#: the emulated multi-host twin's mesh: 2 slices x 2 x 2
MESH_EMULATED = (2, 2, 2)
#: a shard's requests in the twin's card-against-CPU check
MESH_CPU_BLOCK = 2_048
#: an attributed run's tail pilot: min(requests, 8,192), one block
MESH_PILOT_N = 8_192
#: the emulated twin's peak against the one-shard run's
MESH_PEAK_RATIO = 1.1


def mesh_compiled(port):
    from isotope_tpu_torch.models.generators import tree_topology

    return port.compile_graph(port.ServiceGraph.decode(tree_topology(
        num_branches=4, num_services=MESH_SERVICES,
    )))


def mesh_census_runs(port, device="cuda"):
    """Phase 11's blocks for phase 3, as a run: one shard's 32,768 rows
    (the world of one's and each of the emulated twin's shards)."""
    sim = port.Simulator(mesh_compiled(port), device=device)
    return [("mesh-1024svc", sim, port.LoadModel(kind="open", qps=MESH_QPS),
             MESH_BLOCKS * MESH_BLOCK, MESH_BLOCK)]


def _pilot_blocks(n):
    """``(requests, block)`` of an attributed run's tail pilot
    (``Simulator.estimate_tail_cut``) for a run of ``n``."""
    rows = min(n, MESH_PILOT_N)
    return rows, min(MESH_BLOCK, rows)


def mesh_extra_shapes(runs):
    """Phase 11's other census calls: the half-block rung's, the tail
    pilot's and the CPU twin's blocks."""
    sim = [r for r in runs if r[0] == "mesh-1024svc"][0][1]
    return sum((sim.census_shapes(n) for n in (
        MESH_BLOCK // 2, _pilot_blocks(MESH_BLOCKS * MESH_BLOCK)[1],
        MESH_CPU_BLOCK)), [])


#: the mesh-served fleets' and bracket's emulated twin: 2 x 2 x 2
MESH_FLEET_TWIN = (2, 2, 2)
#: the mesh-served protected runs' emulated twin (svc = 1): 4 x 1 x 2
MESH_PROT_TWIN = (4, 1, 2)
#: the protected runs' depth on the mesh: windows of 1 s
MESH_PROT_WINDOWS = 3
#: the twins' CPU checks: a fleet of 8 members x 512 requests, a bracket
#: of 16 candidates over 2 rungs (blocks of 256), a protected run of
#: 8 shards x 2 blocks of 256 requests in 20 ms windows
MESH_CPU_FLEET = dict(members=8, n=512)
MESH_CPU_BRACKET = dict(members=16, eta=4, rungs=2, n=1_024, block=256)
MESH_CPU_PROT = dict(block=256, blocks=2, window_s=0.02)


def _shards(spec) -> int:
    return int(np.prod(spec))


def mesh_served_census_runs(runs):
    """The mesh-served twins' census calls for phase 3, as runs: the
    2x2x2 twin's folded chunks of ensembleN (4 x 8,192), its observed
    twin (1 x 8,192) and search64 (8 / 2 / 1 x 4,096), the 4x1x2 twin's
    protected blocks (a shard's ``protected_window_block``) and the
    blocks of ``mesh_served_cpu``'s card runs."""
    from isotope_tpu_torch.runner.run import protected_window_block

    sim = ensemble_sim(runs)
    open_load = SimpleNamespace(kind="open", qps=ENS_QPS)
    n8 = _shards(MESH_FLEET_TWIN)
    out = [(f"mesh twin ensembleN ({-(-ENS_MEMBERS // n8)} folded)", sim,
            open_load, -(-ENS_MEMBERS // n8) * ENS_N,
            -(-ENS_MEMBERS // n8) * ENS_N)]
    for m in (64, 16, 4):
        rows = -(-m // n8) * SEARCH64["block"]
        out.append((f"mesh twin search64 ({-(-m // n8)} folded)", sim,
                    open_load, rows, rows))
    for name in ("policies-1000svc-kill", "rollouts-multitier-1000-bad"):
        _, psim, load, _, _ = [r for r in runs if r[0] == name][0][:5]
        _, block = protected_window_block(
            psim, load, psim.default_block_size(),
            psim.params.timeline_window_s, PROTECTED_WINDOW_S,
            shards=_shards(MESH_PROT_TWIN),
        )
        out.append((f"mesh twin {name}", psim, load, block, block))
    # the CPU checks' blocks (mesh_served_cpu)
    rows = MESH_CPU_FLEET["n"] * -(-MESH_CPU_FLEET["members"] // n8)
    out.append(("mesh cpu check fleet", sim, open_load, rows, rows))
    b = MESH_CPU_BRACKET
    for m in (b["members"], b["members"] // b["eta"]):
        rows = -(-m // n8) * b["block"]
        out.append((f"mesh cpu check bracket ({-(-m // n8)} folded)", sim,
                    open_load, rows, rows))
    for name in ("policies-smoke", "rollouts-multitier-1000-bad"):
        _, psim, load, _, _ = [r for r in runs if r[0] == name][0][:5]
        out.append((f"mesh cpu check {name}", psim, load,
                    MESH_CPU_PROT["block"], MESH_CPU_PROT["block"]))
    return out


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in _leaves(v)] if x is not None else []


def bit_equal(got, want, what):
    a, b = _leaves(got), _leaves(want)
    if len(a) != len(b) or not all(
        torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b)
    ):
        raise AssertionError(f"{what}: not bit-equal")


def max_spacings(got, want) -> float:
    """The largest difference of two summaries' leaves in float32
    spacings of the larger value (booleans and integers: 0 or inf)."""
    worst = 0.0
    for x, y in zip(_leaves(got), _leaves(want)):
        a = x.cpu().double().numpy()
        b = y.cpu().double().numpy()
        same = (a == b)
        sp = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
        with np.errstate(invalid="ignore"):
            d = np.abs(a - b) / np.where(sp > 0, sp, 1.0)
        worst = max(worst, float(np.max(np.where(same, 0.0, d),
                                        initial=0.0)))
    return worst


def overlap_close(on, off, what):
    """The reference's ``test_overlap_equivalence`` bounds: integer
    fields and extremes equal, sums and m2 within rtol 1e-5, the
    per-service series within 4 float32 spacings."""
    for f in ("count", "error_count", "hop_events", "win_count",
              "win_error_count", "win_lo", "win_hi", "latency_min",
              "latency_max", "end_max", "latency_hist", "win_latency_hist",
              "utilization", "unstable"):
        if not torch.equal(getattr(on, f), getattr(off, f)):
            raise AssertionError(f"{what}: {f} differs")
    for f in ("latency_sum", "latency_m2"):
        a, b = float(getattr(on, f)), float(getattr(off, f))
        if abs(a - b) > 1e-5 * abs(b):
            raise AssertionError(f"{what}: {f} {a} vs {b}")
    worst = max_spacings(on.metrics, off.metrics)
    if worst > 4.0:
        raise AssertionError(f"{what}: per-service series {worst} spacings")
    return worst


def summary_card_cpu(got, want, what):
    """A summary on the card against its CPU twin, phase 4's tolerances:
    counts and histogram totals equal, seconds within rtol / atol,
    quantiles within one bucket."""
    for f in ("count", "error_count", "hop_events", "win_count"):
        if float(getattr(got, f)) != float(getattr(want, f)):
            raise AssertionError(f"{what}: {f} differs")
    for f in ("latency_sum", "latency_m2", "latency_min", "latency_max",
              "end_max"):
        a, b = float(getattr(got, f)), float(getattr(want, f))
        if abs(a - b) > RESULT_ATOL + RESULT_RTOL * abs(b):
            raise AssertionError(f"{what}: {f} {a} vs {b}")
    from isotope_tpu_torch.metrics.histogram import EDGES

    qs = (0.5, 0.9, 0.99)
    ga = np.searchsorted(EDGES, got.quantiles_s(qs), side="right")
    wa = np.searchsorted(EDGES, want.quantiles_s(qs), side="right")
    if np.any(np.abs(ga - wa) > 1):
        raise AssertionError(f"{what}: quantiles differ by a bucket")
    for f in ("incoming_total", "outgoing_total"):
        if not torch.equal(getattr(got.metrics, f).cpu(),
                           getattr(want.metrics, f).cpu()):
            raise AssertionError(f"{what}: {f} differs")
    if not torch.equal(got.metrics.duration_hist.sum(-1).cpu(),
                       want.metrics.duration_hist.sum(-1).cpu()):
        raise AssertionError(f"{what}: duration rows differ")


def _timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def _own_peak(fn):
    """``fn()``'s result and its own peak device bytes (above what was
    allocated when it started)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def mesh_phase(port, runs, prot, chaos_sim):
    """Phase 11 (module docstring).  Returns the census launches of its
    paths: ``mesh`` (the world of one's four runs), ``mesh-emulated``
    (the 8-shard twin) and the mesh-served runs' (``mesh_served_runs``;
    ``runs``, ``prot`` and ``chaos_sim`` are phase 5's)."""
    import io
    from contextlib import redirect_stderr, redirect_stdout

    import torch.distributed as dist

    from isotope_tpu_torch import cli
    from isotope_tpu_torch.metrics.prometheus import MetricsCollector
    from isotope_tpu_torch.parallel import (
        EmulatedMesh,
        MeshSpec,
        ShardedSimulator,
        build_mesh,
    )
    from isotope_tpu_torch.parallel.mesh import close_world
    from isotope_tpu_torch.resilience import (
        ResiliencePolicy,
        execution_rungs,
        faults,
        run_ladder,
    )

    t_phase = time.perf_counter()
    compiled = mesh_compiled(port)
    H = compiled.num_hops
    load = port.LoadModel(kind="open", qps=MESH_QPS)
    n = MESH_BLOCKS * MESH_BLOCK
    mesh = build_mesh(MeshSpec(1, 1), device="cuda", timeout_s=300)
    log(f"mesh: world of {dist.get_world_size()} over "
        f"{dist.get_backend()}, dims {mesh.mesh_dim_names}; "
        f"tree of {compiled.num_services} services, {H} hops, open "
        f"{MESH_QPS:g} qps, {MESH_BLOCKS} x {MESH_BLOCK} requests")

    def src():
        return port.TorchDraws(0, "cuda")

    kinds = [
        ("run", {}, "run", {}),
        ("run overlap", dict(overlap=True), "run", {}),
        ("run_attributed tail", dict(attribution=True), "run_attributed",
         dict(tail=True)),
        ("run_timeline", dict(timeline=True), "run_timeline", {}),
    ]
    on_mesh, twins = {}, {}
    for name, params, method, kw in kinds:
        on_mesh[name] = ShardedSimulator(compiled, mesh,
                                         port.SimParams(**params))
        twins[name] = ShardedSimulator(
            compiled, EmulatedMesh(MeshSpec(1, 1)),
            port.SimParams(**params), device="cuda",
        )
    solo = port.Simulator(compiled, device="cuda")
    collector = MetricsCollector(compiled)

    def call(sh, method, kw, suffix=""):
        return getattr(sh, method + suffix)(
            load, n, src(), block_size=MESH_BLOCK, trim=True, **kw
        )

    # one unmeasured run of each first (the allocator's growth)
    for name, _, method, kw in kinds:
        call(on_mesh[name], method, kw)
    solo.run_summary(load, n, src(), block_size=MESH_BLOCK,
                     collector=collector, trim=True)
    torch.cuda.synchronize()

    per_block = len(solo.census_shapes(MESH_BLOCK))
    pilot_rows, pilot_block = _pilot_blocks(n)
    pilot = -(-pilot_rows // pilot_block) * len(
        solo.census_shapes(pilot_block))
    by_path = {}
    outs, walls = {}, {}
    port.census.launches = 0
    for name, _, method, kw in kinds:
        if name == "run":
            (outs[name], walls[name]), peak_one = _own_peak(
                lambda: _timed(lambda: call(on_mesh["run"], method, kw))
            )
        else:
            outs[name], walls[name] = _timed(
                lambda: call(on_mesh[name], method, kw)
            )
    by_path["mesh"] = port.census.launches
    want = len(kinds) * MESH_BLOCKS * per_block + pilot
    if by_path["mesh"] != want:
        raise AssertionError(
            f"mesh: {by_path['mesh']} census launches, expected {want}"
        )
    _, solo_wall = _timed(lambda: solo.run_summary(
        load, n, src(), block_size=MESH_BLOCK, collector=collector,
        trim=True,
    ))
    for name, _, method, kw in kinds:
        got = outs[name]
        summary = got if method == "run" else got[0]
        if int(summary.count) != n or float(summary.hop_events) != n * H:
            raise AssertionError(f"mesh {name}: count / hop_events")
        qs = summary.quantiles_s((0.5, 0.9, 0.99))
        twin = call(twins[name], method, kw, "_emulated")
        if name == "run overlap":
            worst = overlap_close(summary, outs["run"], f"mesh {name}")
            overlap_close(summary, twin, f"mesh {name} twin")
            verdict = (f"within the overlap bounds of the plain run and "
                       f"its twin (per-service {worst:.2f} spacings)")
        else:
            bit_equal(got, twin, f"mesh {name}")
            verdict = "bit-equal to its emulated twin"
        log(f"mesh {name}: {walls[name] / MESH_BLOCKS * 1e3:.2f} ms per "
            f"block (solo run_summary {solo_wall / MESH_BLOCKS * 1e3:.2f}),"
            f" {n * H / walls[name]:.4e} hop-events/s, p50/p90/p99 "
            f"{qs[0] * 1e3:.4f}/{qs[1] * 1e3:.4f}/{qs[2] * 1e3:.4f} ms; "
            f"{verdict}")
    log(f"mesh: census launches {by_path['mesh']} ({per_block} a block, "
        f"{pilot} for the tail pilot; exact), one-shard peak "
        f"{peak_one / 2**30:.3f} GiB")

    # the emulated multi-host twin: 8 shards x 2 blocks on the card
    twin8 = ShardedSimulator(compiled, EmulatedMesh(MeshSpec(
        *MESH_EMULATED[:2], slices=MESH_EMULATED[2])), device="cuda")
    n8 = twin8.n_shards * n
    port.census.launches = 0
    (s8, wall8), peak8 = _own_peak(lambda: _timed(
        lambda: twin8.run_emulated(load, n8, src(),
                                   block_size=MESH_BLOCK, trim=True)
    ))
    by_path["mesh-emulated"] = port.census.launches
    want = twin8.n_shards * MESH_BLOCKS * per_block
    if by_path["mesh-emulated"] != want:
        raise AssertionError(
            f"mesh-emulated: {by_path['mesh-emulated']} census launches, "
            f"expected {want}"
        )
    if int(s8.count) != n8 or float(s8.hop_events) != n8 * H:
        raise AssertionError("mesh-emulated: count / hop_events")
    dur = s8.metrics.duration_hist.double().sum((1, 2)).cpu()
    inc = s8.metrics.incoming_total.double().cpu()
    if not torch.equal(dur[:compiled.num_services], inc):
        raise AssertionError("mesh-emulated: duration rows != incoming")
    if peak8 > MESH_PEAK_RATIO * peak_one:
        raise AssertionError(
            f"mesh-emulated: peak {peak8} > {MESH_PEAK_RATIO} x "
            f"{peak_one} (one shard)"
        )
    log(f"mesh emulated {twin8.mesh!r}: {twin8.n_shards} shards x "
        f"{MESH_BLOCKS} blocks in {wall8:.3f} s "
        f"({wall8 / (twin8.n_shards * MESH_BLOCKS) * 1e3:.2f} ms per "
        f"block), census launches {by_path['mesh-emulated']} (exact), "
        f"peak {peak8 / 2**30:.3f} GiB = {peak8 / max(peak_one, 1):.4f} x the "
        f"one-shard run's; count, hop_events and every service's "
        f"duration rows hold")
    small = twin8.n_shards * MESH_CPU_BLOCK
    tw_cpu = ShardedSimulator(compiled, twin8.mesh, device="cpu")
    source = port.TorchDraws(11, "cuda")
    got = twin8.run_emulated(load, small, source, block_size=MESH_CPU_BLOCK,
                             trim=True)
    t = time.perf_counter()
    want_cpu = tw_cpu.run_emulated(load, small, source,
                                   block_size=MESH_CPU_BLOCK, trim=True)
    summary_card_cpu(got, want_cpu, "mesh-emulated card against cpu")
    log(f"mesh emulated card against cpu: {twin8.n_shards} shards x "
        f"{MESH_CPU_BLOCK} requests equal within phase 4's tolerances "
        f"(cpu {time.perf_counter() - t:.1f} s)")

    # the ladder on the card: the gather fault twice, then single-device
    sh = on_mesh["run"]
    clean = outs["run"]
    faults.install("oom:sharded.gather:2")
    try:
        rungs = execution_rungs(sh.sim, load, n, src(), MESH_BLOCK,
                                trim=True, sharded=sh)
        ((summary, _), degraded), wall = _timed(lambda: run_ladder(
            rungs, ResiliencePolicy(sleep=lambda s: None),
            site_prefix="engine",
        ))
    finally:
        faults.clear()
    worst = max_spacings(summary, clean)
    if degraded != "single-device" or worst > 1.0:
        raise AssertionError(
            f"mesh ladder: degraded to {degraded}, {worst} spacings"
        )
    log(f"mesh ladder under oom:sharded.gather:2: degraded to {degraded} "
        f"in {wall:.3f} s, summary within {worst:.1f} float32 spacings of "
        f"the clean run")

    by_path["mesh auto"] = mesh_auto_run(port)
    by_path.update(mesh_served_runs(port, mesh, runs, prot, chaos_sim))

    # the command line: a mesh the world cannot hold, before a block
    err = io.StringIO()
    before = port.census.launches
    with redirect_stdout(io.StringIO()), redirect_stderr(err):
        rc = cli.main(["simulate", str(TOPOLOGIES / "canonical.yaml"),
                       "--qps", "1000", "--duration", "2s", "--load-kind",
                       "open", "--mesh", "2x1"])
    text = err.getvalue()
    if (rc == 0 or "needs 2 devices, have 1" not in text
            or port.census.launches != before):
        raise AssertionError(f"simulate --mesh 2x1: rc {rc}, {text!r}")
    log(f"simulate --mesh 2x1: exit {rc}, {text.strip()!r}, no block run")
    close_world()
    log(f"mesh phase {time.perf_counter() - t_phase:.1f} s")
    return by_path


def _as_fleet(out, roll: bool):
    """A protected run's ``(summary, timeline[, rollout], policy)`` as a
    one-member fleet, for ``compare_folded``."""
    from isotope_tpu_torch.sim.ensemble import tree_stack

    rest = list(out[2:])
    ro = rest.pop(0) if roll else None
    pol = rest.pop(0) if rest else None
    return SimpleNamespace(
        summaries=tree_stack([out[0]._replace(metrics=None)]),
        timelines=tree_stack([out[1]]),
        rollouts=tree_stack([ro]) if ro is not None else None,
        policies=tree_stack([pol]) if pol is not None else None,
        attributions=None,
    )


def _path(port, fn):
    """``fn()`` with the census launches set to 0 just before and read
    just after, its wall and own peak: ``(result, launches, wall s,
    peak GiB)``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    port.census.launches = 0
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = port.census.launches
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    if launches <= 0:
        raise AssertionError("a mesh-served path launched no census")
    return out, launches, wall, peak


def mesh_auto_run(port):
    """``--mesh auto`` as a user sweeps it: ``run_experiment`` of the
    1,024-service tree (open 500 qps, ``MESH_BLOCKS`` blocks of
    ``MESH_BLOCK``) in the world of one, which must resolve to
    ``data=1,svc=1`` and equal the explicit ``1x1`` run: its flat row,
    Fortio document and Prometheus text (but StartTime) and its census
    launches, exactly.  Returns the auto run's launches (path ``mesh
    auto``)."""
    import io
    from contextlib import redirect_stderr

    import yaml

    from isotope_tpu_torch.models.generators import tree_topology
    from isotope_tpu_torch.runner.config import (
        DEFAULT_ENVIRONMENTS,
        ExperimentConfig,
    )
    from isotope_tpu_torch.runner.run import run_experiment

    n = MESH_BLOCKS * MESH_BLOCK
    with tempfile.TemporaryDirectory() as tmp:
        topo = pathlib.Path(tmp) / "mesh-1024svc.yaml"
        topo.write_text(yaml.safe_dump(tree_topology(
            num_branches=4, num_services=MESH_SERVICES)))

        def sweep(spec):
            err = io.StringIO()
            with redirect_stderr(err):
                (res,) = run_experiment(ExperimentConfig(
                    topology_paths=(str(topo),),
                    environments=(DEFAULT_ENVIRONMENTS["NONE"],),
                    qps=(MESH_QPS,), connections=(8,),
                    duration_s=n / MESH_QPS, load_kind="open",
                    num_requests=n, mesh_spec=spec,
                ))
            return res, err.getvalue()

        sweep("1x1")  # unmeasured: the allocator's growth, warm caches
        (auto, text), launches, wall, peak = _path(
            port, lambda: sweep("auto"))
        (plain, _), plain_launches, plain_wall, _ = _path(
            port, lambda: sweep("1x1"))
    line = f"mesh auto: {topo} -> data=1,svc=1 (score 0s/merge)"
    if line not in text:
        raise AssertionError(f"mesh auto: {text!r}")
    if auto.failed or plain.failed or "_mesh_layout" in auto.flat:
        raise AssertionError(f"mesh auto: {auto.error or plain.error}")

    def doc(res):
        return (dict(res.flat, StartTime=None),
                dict(res.fortio_json, StartTime=None), res.prometheus_text)

    if doc(auto) != doc(plain):
        raise AssertionError("mesh auto: not the explicit 1x1 run")
    # the runner's memory-sized block (the tree's: MESH_BLOCK)
    sim = port.Simulator(mesh_compiled(port), device="cuda")
    block = min(sim.default_block_size(), n)
    want = -(-n // block) * len(sim.census_shapes(block))
    if launches != plain_launches or launches != want:
        raise AssertionError(f"mesh auto: {launches} census launches, the "
                             f"1x1 run {plain_launches}, expected {want}")
    log(f"mesh auto (run_experiment, {n} requests of the {MESH_SERVICES}-"
        f"service tree): '{line}', {wall:.3f} s (explicit 1x1 "
        f"{plain_wall:.3f} s), own peak {peak:.3f} GiB, census launches "
        f"{launches} (exact, the 1x1 run's); flat row, Fortio document "
        f"and Prometheus text equal to the 1x1 run's (but StartTime)")
    return launches


def mesh_served_cpu(port, sims):
    """Each mesh-served twin held to its CPU twin at a small size, on
    one draw source, within phase 4's tolerances (``sims[name](device)``
    builds a case's Simulator, ``sims[name + ".load"]`` is its load):
    the 2x2x2 fleet (``MESH_CPU_FLEET``, one member a shard) and bracket
    (``MESH_CPU_BRACKET``: the same lineage), the 4x1x2 protected runs
    (``MESH_CPU_PROT``: ``compare_folded`` with ``cross=True``) on
    policies-smoke's and rollouts-multitier-1000-bad's topologies."""
    from isotope_tpu_torch.parallel import (
        EmulatedMesh,
        MeshSpec,
        ShardedSimulator,
    )
    from isotope_tpu_torch.sim.ensemble import EnsembleSpec
    from isotope_tpu_torch.sim.search import SearchSpec

    fleet_mesh = EmulatedMesh(MeshSpec(*MESH_FLEET_TWIN[:2],
                                       slices=MESH_FLEET_TWIN[2]))
    prot_mesh = EmulatedMesh(MeshSpec(*MESH_PROT_TWIN[:2],
                                      slices=MESH_PROT_TWIN[2]))
    t = time.perf_counter()
    got = {}
    for device in ("cuda", "cpu"):
        ens = sims["ensembleN"](device)
        twin = ShardedSimulator(ens.compiled, fleet_mesh, sim=ens)
        load = port.LoadModel(kind="open", qps=ENS_QPS)
        c = MESH_CPU_FLEET
        fleet = twin.run_ensemble_emulated(
            load, c["n"], port.TorchDraws(41, "cuda"),
            EnsembleSpec.from_jitter(c["members"], **SEARCH_JITTER),
            block_size=c["n"])
        b = MESH_CPU_BRACKET
        bracket = twin.run_search_emulated(
            load, b["n"], port.TorchDraws(42, "cuda"), SearchSpec(
                candidates=EnsembleSpec.from_jitter(b["members"],
                                                    **SEARCH_JITTER),
                eta=b["eta"], rungs=b["rungs"]),
            block_size=b["block"])
        prot = {}
        for name, roll in (("policies", False), ("rollouts", True)):
            psim = sims[name](device)
            ptwin = ShardedSimulator(psim.compiled, prot_mesh, sim=psim)
            fn = (ptwin.run_rollouts_emulated if roll
                  else ptwin.run_policies_emulated)
            p = MESH_CPU_PROT
            prot[name] = _as_fleet(fn(
                sims[name + ".load"], _shards(MESH_PROT_TWIN) * p["block"]
                * p["blocks"], port.TorchDraws(43, "cuda"),
                block_size=p["block"], trim=True, window_s=p["window_s"],
            ), roll)
        got[device] = (fleet, bracket, prot)
    (cf, cb, cp), (hf, hb, hp) = got["cuda"], got["cpu"]
    compare_fleets(cf.summaries, hf.summaries, "mesh twin fleet card/cpu")
    for a, b in zip(cb.rungs, hb.rungs):
        if not (np.array_equal(a.candidates, b.candidates)
                and np.array_equal(a.survivors, b.survivors)):
            raise AssertionError("mesh twin bracket: lineage card != cpu")
        compare_fleets(a.summaries, b.summaries,
                       f"mesh twin bracket rung {a.rung} card/cpu")
    for name in cp:
        compare_folded(cp[name], hp[name], f"mesh twin {name} card/cpu",
                       cross=True)
    log(f"mesh-served twins card against cpu: the {fleet_mesh!r} fleet "
        f"({MESH_CPU_FLEET['members']} x {MESH_CPU_FLEET['n']}) and "
        f"bracket ({MESH_CPU_BRACKET['members']} candidates, winner "
        f"{cb.winner} both), the {prot_mesh!r} policies (policies-smoke) "
        f"and rollouts "
        f"({_shards(MESH_PROT_TWIN)} shards x {MESH_CPU_PROT['blocks']} "
        f"blocks of {MESH_CPU_PROT['block']}) within phase 4's tolerances "
        f"({time.perf_counter() - t:.1f} s)")


def mesh_served_runs(port, mesh, runs, prot, chaos_sim):
    """The mesh-served fleets, bracket, protected runs, protected fleet
    and splitting estimate (module docstring, phase 11); returns each
    path's census launches."""
    from isotope_tpu_torch.parallel import (
        EmulatedMesh,
        MeshSpec,
        ShardedSimulator,
    )
    from isotope_tpu_torch.resilience.faults import ChaosJitterSpec
    from isotope_tpu_torch.runner.run import (
        protected_window_block,
        splitting_pass,
    )
    from isotope_tpu_torch.sim.ensemble import EnsembleSpec
    from isotope_tpu_torch.sim.search import SearchSpec
    from isotope_tpu_torch.sim.splitting import SplitSpec

    t_phase = time.perf_counter()
    one = EmulatedMesh(MeshSpec(1, 1))
    fleet_mesh = EmulatedMesh(MeshSpec(*MESH_FLEET_TWIN[:2],
                                       slices=MESH_FLEET_TWIN[2]))
    prot_mesh = EmulatedMesh(MeshSpec(*MESH_PROT_TWIN[:2],
                                      slices=MESH_PROT_TWIN[2]))
    by_path = {}
    ens = ensemble_sim(runs)
    load = port.LoadModel(kind="open", qps=ENS_QPS)
    asim = port.Simulator(ens.compiled, port.SimParams(
        attribution=True, timeline=True), device="cuda")

    # -- the fleets: ensembleN and ensembleN-observed ------------------------
    for name, sim, members, kw in (
        ("ensembleN", ens, ENS_MEMBERS, {}),
        ("ensembleN-observed", asim, ENS_OBSERVED,
         dict(attribution=True, timeline=True, window_s=0.1)),
    ):
        spec = EnsembleSpec.of(members)
        on_mesh = ShardedSimulator(sim.compiled, mesh, sim=sim)
        twin1 = ShardedSimulator(sim.compiled, one, sim=sim)
        twin8 = ShardedSimulator(sim.compiled, fleet_mesh, sim=sim)

        def fleet(runner, method="run_ensemble", seed=51):
            return getattr(runner, method)(
                load, ENS_N, port.TorchDraws(seed, "cuda"), spec,
                block_size=ENS_N, **kw)

        fleet(on_mesh)  # unmeasured: the allocator's growth, the pilots
        got, by_path[f"mesh {name}"], wall, peak = _path(
            port, lambda: fleet(on_mesh))
        _, solo_wall = _timed(lambda: fleet(sim))
        bit_equal((got.summaries, got.timelines, got.attributions),
                  (lambda t: (t.summaries, t.timelines, t.attributions))(
                      fleet(twin1, "run_ensemble_emulated")),
                  f"mesh {name}")
        tw, by_path[f"mesh {name} emulated"], t_wall, t_peak = _path(
            port, lambda: fleet(twin8, "run_ensemble_emulated"))
        moved = compare_folded(tw, got, f"mesh {name} 2x2x2 twin")
        hops = float(got.summaries.hop_events.sum())
        log(f"mesh {name}: {members} x {ENS_N} over the world of one in "
            f"{wall * 1e3:.2f} ms (solo folded fleet {solo_wall * 1e3:.2f} "
            f"ms, {wall / solo_wall:.4f}x; prediction <= 1.1x), "
            f"{hops / wall:.4e} hop-events/s, chunk {got.chunk}, census "
            f"launches {by_path[f'mesh {name}']}, own peak {peak:.3f} GiB; "
            f"bit-equal to its 1x1 twin; the {fleet_mesh!r} twin (chunk "
            f"{tw.chunk} a shard) {t_wall * 1e3:.2f} ms, census launches "
            f"{by_path[f'mesh {name} emulated']}, own peak {t_peak:.3f} "
            f"GiB, within the folded fleets' tolerances of the world of "
            f"one's ({moved} histogram counts a bucket over)")

    # -- search64 over the 2x2x2 twin ----------------------------------------
    c = SEARCH64
    sspec = SearchSpec(candidates=EnsembleSpec.from_jitter(
        c["members"], **SEARCH_JITTER), eta=c["eta"], rungs=c["rungs"],
        growth=c["growth"])
    twin8 = ShardedSimulator(ens.compiled, fleet_mesh, sim=ens)
    srch, by_path["mesh search64 emulated"], wall, peak = _path(
        port, lambda: twin8.run_search_emulated(
            load, c["n"], port.TorchDraws(31, "cuda"), sspec,
            block_size=c["block"]))
    solo = ens.run_search(load, c["n"], port.TorchDraws(31, "cuda"), sspec,
                          block_size=c["block"])
    same = all(np.array_equal(a.survivors, b.survivors)
               for a, b in zip(srch.rungs, solo.rungs))
    if srch.winner != solo.winner or not same:
        raise AssertionError("mesh search64: the twin's lineage is not the "
                             "solo bracket's")
    for a, b in zip(srch.rungs, solo.rungs):
        compare_fleets(a.summaries, b.summaries,
                       f"mesh search64 rung {a.rung}")
    log(f"mesh search64 over the {fleet_mesh!r} twin: chunks "
        f"{[r.chunk for r in srch.rungs]} a shard (solo "
        f"{[r.chunk for r in solo.rungs]}), wall {wall * 1e3:.2f} ms, "
        f"census launches {by_path['mesh search64 emulated']}, own peak "
        f"{peak:.3f} GiB; the solo bracket's lineage and winner "
        f"({srch.winner})")

    # -- the protected runs ---------------------------------------------------
    sims = {"ensembleN": lambda device: ens if device == "cuda" else
            port.Simulator(ens.compiled, device=device)}
    # the CPU twins: policies-smoke's topology for the policy laws (a
    # block of policies-1000svc-kill's 66,196 hops takes seconds on the
    # CPU), rollouts-multitier-1000-bad's own
    for name, key in (("policies-smoke", "policies"),
                      ("rollouts-multitier-1000-bad", "rollouts")):
        (_, psim, pload, _, _, _, _, make) = [
            r for r in prot if r[0] == name][0]
        sims[key] = lambda device, psim=psim, make=make: (
            psim if device == "cuda" else make(device))
        sims[key + ".load"] = pload
    for name, roll, key in (("policies-1000svc-kill", False, "policies"),
                            ("rollouts-multitier-1000-bad", True,
                             "rollouts")):
        (_, psim, pload, _, block, window, _, make) = [
            r for r in prot if r[0] == name][0]
        n = int(MESH_PROT_WINDOWS * window * pload.qps)
        method = "run_rollouts" if roll else "run_policies"
        on_mesh = ShardedSimulator(psim.compiled, mesh, sim=psim)
        twin1 = ShardedSimulator(psim.compiled, one, sim=psim)
        twin8 = ShardedSimulator(psim.compiled, prot_mesh, sim=psim)
        _, b8 = protected_window_block(
            psim, pload, psim.default_block_size(),
            psim.params.timeline_window_s, PROTECTED_WINDOW_S,
            shards=twin8.n_shards)

        def call(runner, suffix="", b=block, seed=61):
            return getattr(runner, method + suffix)(
                pload, n, port.TorchDraws(seed, "cuda"), block_size=b,
                trim=True, window_s=window)

        call(on_mesh)  # unmeasured
        got, by_path[f"mesh {key}"], wall, peak = _path(
            port, lambda: call(on_mesh))
        calls = len(census_calls(psim, block))
        blocks = -(-n // block)
        if by_path[f"mesh {key}"] != blocks * calls:
            raise AssertionError(f"mesh {key}: {by_path[f'mesh {key}']} "
                                 "census launches")
        _, solo_wall = _timed(lambda: getattr(psim, method)(
            pload, n, port.TorchDraws(61, "cuda"), block_size=block,
            trim=True, window_s=window))
        bit_equal(got[1:], call(twin1, "_emulated")[1:], f"mesh {key}")
        tw, by_path[f"mesh {key} emulated"], t_wall, t_peak = _path(
            port, lambda: call(twin8, "_emulated", b8))
        want = twin8.n_shards * -(-n // twin8.n_shards // b8) * len(
            census_calls(psim, b8))
        if by_path[f"mesh {key} emulated"] != want:
            raise AssertionError(
                f"mesh {key} emulated: {by_path[f'mesh {key} emulated']} "
                f"census launches, expected {want}")
        # one shard's own peak at the twin's shard block: the 1x1 twin
        # over the same requests and windows, blocks of b8
        _, _, _, one_peak = _path(port, lambda: call(twin1, "_emulated", b8))
        if t_peak > MESH_PEAK_RATIO * one_peak:
            raise AssertionError(
                f"mesh {key} emulated: own peak {t_peak:.3f} GiB > "
                f"{MESH_PEAK_RATIO} x one shard's {one_peak:.3f} GiB")
        for out, what in ((got, "world of one"), (tw, "4x1x2 twin")):
            if int(out[0].count) < n or int(out[1].arrivals.sum()) != int(
                    out[0].count):
                raise AssertionError(f"mesh {key} {what}: counts")
        pol = got[-1]
        log(f"mesh {key} ({name}): {MESH_PROT_WINDOWS} windows of "
            f"{window:g} s, {n} requests in {blocks} blocks of {block} over "
            f"the world of one in {wall / blocks * 1e3:.2f} ms a block (solo "
            f"{solo_wall / blocks * 1e3:.2f} ms, "
            f"{wall / solo_wall:.4f}x; prediction <= 1.2x), census "
            f"launches {by_path[f'mesh {key}']} (exact), own peak "
            f"{peak:.3f} GiB, windows done "
            f"{int(pol.windows_done.sum())}; series bit-equal to its 1x1 "
            f"twin; the {prot_mesh!r} twin (blocks of {b8} a shard) "
            f"{t_wall * 1e3:.2f} ms, census launches "
            f"{by_path[f'mesh {key} emulated']} "
            f"(exact), own peak {t_peak:.3f} GiB = "
            f"{t_peak / max(one_peak, 1e-12):.4f} x one shard's at blocks "
            f"of {b8} ({one_peak:.3f} GiB; gate {MESH_PEAK_RATIO}x)")

    # -- the protected fleet and its splitting estimate ------------------------
    cf = CHAOSFLEET
    cload = port.LoadModel(kind="open", qps=cf["qps"])
    jitter = ChaosJitterSpec(**cf["jitter"])
    on_mesh = ShardedSimulator(chaos_sim.compiled, mesh, sim=chaos_sim)

    def pfleet(runner):
        return runner.run_policies_ensemble(
            cload, cf["n"], port.TorchDraws(22, "cuda"),
            EnsembleSpec.of(cf["members"]), block_size=cf["block"],
            window_s=cf["window_s"], member_chaos=jitter)

    got, by_path["mesh svc1000-chaosfleet"], wall, peak = _path(
        port, lambda: pfleet(on_mesh))
    want = pfleet(chaos_sim)
    bit_equal((got.summaries, got.timelines, got.policies),
              (want.summaries, want.timelines, want.policies),
              "mesh svc1000-chaosfleet")
    split = SplitSpec(levels=2, members=cf["members"], keep=0.25,
                      threshold=0.2, severity="err_peak", horizon=0.5)

    def estimate(sharded):
        # 0.5 s windows: the runner's protected block is the fleet's
        # 4,096 (protected_window_block), phase 3's shapes
        return splitting_pass(
            chaos_sim, cload, cf["n"], port.TorchDraws(35, "cuda"),
            cf["block"], split, protected=True,
            timeline_window_s=chaos_sim.params.timeline_window_s,
            timeline=0.5, chaos_jitter=jitter, sharded=sharded)

    doc, by_path["mesh splitting"], s_wall, s_peak = _path(
        port, lambda: estimate(on_mesh))
    if doc != estimate(None):
        raise AssertionError("mesh splitting: not the solo estimate")
    log(f"mesh svc1000-chaosfleet: {cf['members']} protected members over "
        f"the world of one in {wall * 1e3:.2f} ms, census launches "
        f"{by_path['mesh svc1000-chaosfleet']}, own peak {peak:.3f} GiB, "
        f"bit-equal to the solo fleet; its splitting estimate (2 levels) "
        f"p {doc['p']:.6g} in {doc['evaluations']} member runs, "
        f"{s_wall * 1e3:.2f} ms, census launches "
        f"{by_path['mesh splitting']}, own peak {s_peak:.3f} GiB, equal "
        f"to the solo estimate")
    mesh_served_cpu(port, sims)
    log(f"mesh-served runs {time.perf_counter() - t_phase:.1f} s")
    return by_path


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from isotope_tpu_torch.compiler import (
        compile_graph,
        compile_lb,
        compile_policies,
        compile_rollouts,
    )
    from isotope_tpu_torch.models.generators import (
        realistic_topology,
        tree_topology,
        with_call_policy,
    )
    from isotope_tpu_torch.models.graph import ServiceGraph
    from isotope_tpu_torch.native import census as census_mod
    from isotope_tpu_torch.native import satwait as satwait_mod
    from isotope_tpu_torch.runner.config import DEFAULT_ENVIRONMENTS
    from isotope_tpu_torch.runner.run import protected_window_block
    from isotope_tpu_torch.sim import policies as policies_mod
    from isotope_tpu_torch.sim import rollout as rollout_mod
    from isotope_tpu_torch.sim import (
        LoadModel,
        SimParams,
        Simulator,
        TorchDraws,
    )
    from isotope_tpu_torch.sim.config import (
        ChaosEvent,
        MtlsSchedule,
        TrafficSplit,
        bounce_schedule,
    )

    # the port's entry points, as a user calls them
    port = SimpleNamespace(
        compile_graph=compile_graph, compile_lb=compile_lb,
        ServiceGraph=ServiceGraph,
        LoadModel=LoadModel, Simulator=Simulator, TorchDraws=TorchDraws,
        census=census_mod.census, realistic_topology=realistic_topology,
        saturated_wait=satwait_mod.saturated_wait,
        with_call_policy=with_call_policy, SimParams=SimParams,
        ChaosEvent=ChaosEvent, TrafficSplit=TrafficSplit,
        MtlsSchedule=MtlsSchedule, bounce_schedule=bounce_schedule,
        DEFAULT_ENVIRONMENTS=DEFAULT_ENVIRONMENTS,
        compile_policies=compile_policies, compile_rollouts=compile_rollouts,
        policies_mod=policies_mod, rollout_mod=rollout_mod,
        protected_window_block=protected_window_block,
    )

    # full-precision float32 products everywhere (the copula matmul)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    name_power = card()
    log(name_power)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t = time.perf_counter()
    lib = census_mod.LIBRARY.build()
    log(f"build: {lib.name} in {time.perf_counter() - t:.2f} s")
    log(census_mod.LIBRARY.build_log.strip())
    t = time.perf_counter()
    lib = satwait_mod.LIBRARY.build()
    log(f"build: {lib.name} in {time.perf_counter() - t:.2f} s")
    log(satwait_mod.LIBRARY.build_log.strip())
    from isotope_tpu_torch.native import blame as blame_mod

    t = time.perf_counter()
    lib = blame_mod.LIBRARY.build()
    log(f"build: {lib.name} in {time.perf_counter() - t:.2f} s")
    log(blame_mod.LIBRARY.build_log.strip())

    flagship_graph = ServiceGraph.decode(tree_topology(
        num_levels=5, num_branches=3, request_size=1024, response_size=1024,
    ))
    build_s = {}
    runs = main_path_runs(port, flagship_graph, build_s=build_s)
    scenarios = scenario_runs(port, build_s) + lb_runs(port)
    runs += [run[:5] for run in scenarios]
    prot = protected_runs(port)
    chaos_sim = chaosfleet_sim(port)
    planted = planted_sim(port)
    storm = storm_sim(port)
    census_runs = (runs + [run[:5] for run in prot]
                   + fleet_census_runs(runs, chaos_sim)
                   + search_census_runs(runs, planted, storm)
                   + runner_census_runs() + calibration_census_runs()
                   + mesh_census_runs(port))
    census_runs += mesh_served_census_runs(census_runs)
    census_only = census_only_configs(port)
    vet = vet_cases(port, flagship_graph, runs, scenarios, prot)
    grad_sims = vet_grad_sims(port, vet)
    vet_shapes = vet_census_shapes(vet, grad_sims) + sum(
        vet_cli_shapes(port), []) + fleet_pilot_shapes(
            port, runs, chaos_sim, storm) + mesh_extra_shapes(census_runs)
    timing = kernel_phase(census_mod, census_runs, census_only, vet_shapes)
    ragged_phase(census_mod, census_runs, census_only, timing)
    checked = census_check_shapes(census_runs, census_only, vet_shapes)

    def plain(graph):
        compiled = compile_graph(graph)
        return lambda device: Simulator(compiled, device=device)

    def open_case(name, graph, qps, n=16_384, rtol=RESULT_RTOL):
        return (name, plain(graph), LoadModel(kind="open", qps=qps), n,
                None, rtol, RESULT_ATOL)

    scenario_tol = {
        "svc100k-chaos": (RESULT_RTOL, RESULT_ATOL),
        "canonical-2r-storm": (RESULT_RTOL, STORM_ATOL),
        "canonical-2r-qps-max-bounce": (SAT_RTOL, SAT_ATOL),
        "lb-10svc-100r-panic": (RESULT_RTOL, RESULT_ATOL),
    }
    in_situ_phase(port, [
        open_case("flagship", flagship_graph, 1e3),
        open_case("census-test", ServiceGraph.from_yaml(CENSUS_YAML), 500.0),
        open_case("realistic-powerlaw-100", ServiceGraph.from_yaml_file(
            TOPOLOGIES / "realistic-powerlaw-100.yaml"), 6500.0),
        open_case("star-10k-timeouts", star10k_graph(port), STAR10K_QPS,
                  n=3355, rtol=STAR_RTOL),
        ("canonical-qps-max", plain(ServiceGraph.from_yaml_file(
            TOPOLOGIES / "canonical.yaml")),
         LoadModel(kind="closed", qps=None, connections=64), 16_384, None,
         SAT_RTOL, SAT_ATOL),
    ] + [
        # svc100k: its first two blocks; the canonical runs and the panic
        # run: every block
        (name, make, load, min(n, 2 * block), block, *scenario_tol[name])
        for name, _, load, n, block, make in scenarios
        if name in scenario_tol
    ] + [
        (name, make, load, 16_384, None, RESULT_RTOL, RESULT_ATOL)
        for name, _, load, _, _, make in scenarios
        if name == "lb-1000svc-lr"
    ])
    protected_in_situ(port, in_situ_twins(port, prot))
    fleet_in_situ(port)
    planted_in_situ(port, planted)
    attr = dict(attribution=True)
    flagship_c = runs[0][1].compiled
    census_c = compile_graph(ServiceGraph.from_yaml(CENSUS_YAML))
    make_big = [r[5] for r in scenarios if r[0] == "svc100k-chaos"][0]
    big_block = [r[4] for r in scenarios if r[0] == "svc100k-chaos"][0]
    attribution_in_situ(port, [
        ("flagship", lambda dev: Simulator(flagship_c, SimParams(**attr),
                                           device=dev),
         LoadModel(kind="open", qps=1e3), 16_384, 16_384, True),
        ("census-test", lambda dev: Simulator(census_c, SimParams(**attr),
                                              device=dev),
         LoadModel(kind="open", qps=500.0), 16_384, 8_192, False),
    ])
    # the main path's tail block: one block of 262,144 rows of the
    # flagship tree, tail armed, as the tree121.blame-tail cell runs it
    # (its 10,400 qps: at the flagship run's 1e5 qps the first block has
    # no request past the pilot's p99), attributed on the card and by
    # the CPU's sweep on the card's results
    flagship_attr = Simulator(flagship_c, SimParams(**attr), device="cuda")
    tail_load = LoadModel(kind="open", qps=10_400.0)
    tail_block = runs[0][4]
    tail_src = port.TorchDraws(13, "cuda")
    check = AttributedBlocks(
        port, flagship_attr, "attributed flagship tail block",
        flagship_attr.estimate_tail_cut(tail_load, tail_block, tail_src,
                                        block_size=tail_block))
    for res in flagship_attr.run_blocks(tail_load, tail_block, tail_src,
                                        block_size=tail_block):
        check.block(res)
    check.finish()
    if int(check.acc.tail_count) == 0:
        raise AssertionError("attributed flagship tail block: no request "
                             "past the tail cut")
    # svc100k-chaos, the widest: its first two blocks, each attributed
    # on the card and by the CPU's sweep on the card's results
    big = make_big("cuda", attribution=True)
    check = AttributedBlocks(port, big, "attributed svc100k-chaos")
    for res in big.run_blocks(LoadModel(kind="open", qps=SVC100K_QPS),
                              2 * big_block, port.TorchDraws(11, "cuda"),
                              block_size=big_block):
        check.block(res)
    check.finish()

    walls = {}
    by_path = main_path_phase(port, runs, build_s, timing["ms_per_block"],
                              walls)
    panic_share(port, *[run[1:5] for run in runs
                        if run[0] == "lb-10svc-100r-panic"][0])
    sat_timing = satwait_phase(satwait_mod, satwait_calls(port, runs))
    # the protected runs: each its own main path, counts set to 0 just
    # before and read just after
    prot_launches, prot_walls = protected_phase(port, prot,
                                                timing["ms_per_block"])
    by_path.update(prot_launches)
    walls.update(prot_walls)
    # the attributed runs: each its own path, counts set to 0 just before
    smoke = [r for r in prot if r[0] == "policies-smoke"][0]
    svc1000 = [r for r in runs if r[0] == "1000-svc_2000-end"][0]
    by_path.update(attributed_phase(port, [
        ("flagship", "flagship",
         Simulator(flagship_c, SimParams(**attr), device="cuda"),
         runs[0][2], runs[0][3], runs[0][4], "tail", None),
        ("1000-svc_2000-end", "1000-svc_2000-end",
         Simulator(svc1000[1].compiled, SimParams(**attr), device="cuda"),
         *svc1000[2:5], "mean", None),
        ("svc100k-chaos", "svc100k-chaos", big,
         LoadModel(kind="open", qps=SVC100K_QPS),
         SVC100K_BLOCKS * big_block, big_block, "mean", None),
        ("policies-smoke", "policies-smoke",
         Simulator(smoke[1].compiled, attributed_params(smoke[1]),
                   (ChaosEvent(**SMOKE_KILL),),
                   policies=smoke[1]._policies, device="cuda"),
         *smoke[2:5], "tail", smoke[5]),
    ], walls))
    # the fleets: each its own path, counts set to 0 just before
    by_path.update(fleet_phase(port, runs, chaos_sim,
                               timing["ms_per_block"]))
    # the brackets and the splitting estimate: each its own path
    by_path.update(search_phase(port, runs, chaos_sim, storm, timing))
    # the experiment runner's suite: its own path
    by_path["runner-suite"] = runner_phase()
    cli_phase()
    cli_protected_phase()
    cli_attribution_phase()
    cli_fleet_phase()
    cli_search_phase()
    oracle_phase(port)
    # the calibration path: fidelity, the ingest closure and the fitted
    # sweep, each its own path
    by_path.update(calibration_phase(census_mod, checked))
    # vet on the card: the pilots' path and the vetted runs' path
    by_path.update(vet_phase(port, vet, grad_sims, prot, scenarios,
                             checked))
    # the device mesh: the world of one's runs and the emulated twin,
    # each its own path
    by_path.update(mesh_phase(port, runs, prot, chaos_sim))
    launches = sum(by_path.values())
    log(f"census launches on every path: {launches}")

    kernels = [{
        "name": "census",
        "route": "cuda",
        "source": "isotope_tpu_torch/native/csrc/census.cu",
        "replaces": "isotope_tpu/native/census_pallas.py:146",
        "launches": launches,
        "launches_by_path": by_path,
        "max_abs_err": timing["max_abs_err"],
        "ms": timing["ms"],
        "ms_per_block": timing["ms_per_block"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "satwait",
        "route": "cuda",
        "source": "isotope_tpu_torch/native/csrc/satwait.cu",
        "replaces": None,
        # the main path's saturated runs, checked run by run
        "launches": sum(-(-n // block) for _, sim, load, n, block in runs
                        if sim._saturated(load)),
        "max_abs_err": sat_timing["max_abs_err"],
        "ms": sat_timing["ms"],
        "plain_ms": sat_timing["plain_ms"],
        "bound_ms": sat_timing["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }]
    if not all(math.isfinite(k["ms"]) for k in kernels) or launches <= 0:
        raise AssertionError("kernel table incomplete")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(name_power)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
