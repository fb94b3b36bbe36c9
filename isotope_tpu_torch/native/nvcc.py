"""Build one CUDA C++ source with ``nvcc`` and load it with ctypes.

Each kernel source under ``csrc/`` is compiled for ``sm_90a`` into a
shared library with a plain C interface, under ``_build/`` (listed in
``.gitignore``), at first use; the library's name carries a digest of
the source and the flags, so an edited kernel rebuilds.  A failed build
raises with nvcc's own message.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Callable, Optional

BUILD_DIR = pathlib.Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class NvccLibrary:
    """The compiled library of ``source``, built and loaded on first use;
    ``bind`` declares its functions' ``argtypes`` and ``restype``."""

    def __init__(self, source: pathlib.Path,
                 bind: Callable[[ctypes.CDLL], None]):
        self.source = source
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None
        # what ptxas said of each kernel (registers, shared memory,
        # spills) in this process's build; empty if the library existed
        self.build_log = ""

    @staticmethod
    def nvcc() -> str:
        home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
        if home:
            return str(pathlib.Path(home) / "bin" / "nvcc")
        return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"

    def path(self) -> pathlib.Path:
        digest = hashlib.sha256(
            self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.source.stem}-{digest}.so"

    def build(self) -> pathlib.Path:
        """Compile the kernel unless this source's library exists."""
        out = self.path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [self.nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {self.source.name}:\n"
                    f"{proc.stderr}"
                )
            self.build_log = proc.stderr
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return out

    def get(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            self._bind(lib)
            self._lib = lib
        return self._lib
