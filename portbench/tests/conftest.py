"""The closed-loop cell at test size in ``tiny``'s copy of the
benchmark: 64 connections and two blocks of 2,048 requests on the whole
1,000-service graph (the closed loop's block is a multiple of its
connections, so the size names them too)."""
from portbench.tests import tiny

tiny.SIZES.setdefault("multitier1k.qps-max-c10k",
                      {"connections": 64, "requests": 4096, "block": 2048})
