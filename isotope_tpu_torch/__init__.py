"""isotope-tpu on PyTorch and CUDA: the port of ``isotope_tpu``.

The JAX package ``isotope_tpu`` is the reference; this package runs its
main path — topology YAML -> compiled hop program -> block simulation ->
run summary -> Fortio JSON — with torch on an NVIDIA GPU, its one
hand-written kernel (the census join) in CUDA C++ for Hopper.  It
imports nothing of the JAX package.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""
