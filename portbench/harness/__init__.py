"""The benchmark's harness: cells, the window, traces and checks."""
