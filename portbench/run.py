#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the CUDA device it starts on.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout.  Prints the card, the compared numbers
beside their limits on standard error, and as the last line of standard
output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (and with ``--trace 1`` ``breakdown``), then
``checks``.  Exits non-zero without a result when no CUDA device is
there, the program cannot be imported, or JAX was loaded.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench-cache"
# every build and kernel cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(CACHE / "torch_kernels")
for _d in ("torch_extensions", "triton", "torch_kernels"):
    (CACHE / _d).mkdir(parents=True, exist_ok=True)
# one host thread for the CPU's math libraries: the run's host path is
# Python launching kernels, and idle worker pools only add jitter
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"
sys.path.insert(0, str(ROOT))

from portbench.harness import bench  # noqa: E402

if __name__ == "__main__":
    sys.exit(bench.main(sys.argv[1:], T_START))
