"""Graph compiler: lower the ServiceGraph IR to dense numpy tables.

Host-side copies of ``isotope_tpu.compiler``'s lowering, so the port
imports nothing of the JAX package.
"""
from isotope_tpu_torch.compiler.compile import (
    CycleError,
    HopBudgetExceededError,
    NoEntrypointError,
    compile_graph,
    compile_lb,
)
from isotope_tpu_torch.compiler.program import (
    CompiledGraph,
    HopLevel,
    ServiceTable,
    compiled_from_arrays,
    compiled_to_arrays,
)

__all__ = [
    "CompiledGraph",
    "CycleError",
    "HopBudgetExceededError",
    "HopLevel",
    "NoEntrypointError",
    "ServiceTable",
    "compile_graph",
    "compile_lb",
    "compiled_from_arrays",
    "compiled_to_arrays",
]
