"""The benchmark of the PyTorch and CUDA port (``isotope_tpu_torch``).

``python3 portbench/run.py --workload NAME --seed N --seconds S --trace
0|1`` runs one cell once; ``BENCHMARK.json`` at the repository root
names the cells, configurations and metrics, and the files under this
directory hold each of them.
"""
