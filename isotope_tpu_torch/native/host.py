"""Host C++ libraries of the port, built with ``g++`` and loaded by ctypes.

A library ``<name>.cpp`` in this directory is compiled on first use with
``g++ -O2 -std=c++17 -shared -fPIC`` into ``_build/<name>-<hash>.so``,
keyed by a hash of its source, and loaded once per process.  A failed
build raises :class:`NativeBuildError`; there is no Python fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import pathlib
import subprocess
import threading

_DIR = pathlib.Path(__file__).parent
_BUILD_DIR = _DIR / "_build"
_lock = threading.Lock()
_cache: dict = {}


class NativeBuildError(RuntimeError):
    pass


def load_library(name: str) -> ctypes.CDLL:
    """Compile (if needed) and load ``<name>.cpp`` from this directory."""
    with _lock:
        if name in _cache:
            return _cache[name]
        src = _DIR / f"{name}.cpp"
        tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        out = _BUILD_DIR / f"{name}-{tag}.so"
        if not out.exists():
            _BUILD_DIR.mkdir(exist_ok=True)
            tmp = out.with_suffix(".so.tmp")
            proc = subprocess.run(
                ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", str(src),
                 "-o", str(tmp)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise NativeBuildError(
                    f"building {src.name} failed:\n{proc.stderr}"
                )
            tmp.replace(out)  # atomic: parallel builds race safely
        lib = ctypes.CDLL(str(out))
        _cache[name] = lib
        return lib
