"""Build the package's CUDA kernels with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into a shared library under ``microtipi_tpu_torch/_build/`` (git-ignored),
keyed on a hash of the source and the flags, then loaded with ``ctypes``.
``ptxas`` reports each kernel's registers, shared memory and spills
(``-Xptxas -v``); the report is kept beside the library and
:func:`build_report` returns it. Nothing here runs at import time, and
nothing includes PyTorch's headers, so a build takes seconds. ``nvcc`` is
found on ``PATH``, else under ``$CUDA_HOME/bin`` (default
``/usr/local/cuda``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "build_report", "library_path", "load_library", "nvcc_path"]

_PKG = Path(__file__).resolve().parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA kernels "
                       "are built at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` with these flags lies."""
    src = CSRC_DIR / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build_report(name: str) -> str:
    """What ``nvcc`` printed when it built ``csrc/<name>.cu`` (the ``ptxas``
    lines: registers, shared memory, spills); empty if it is not built."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its hashed library is missing, and load it."""
    src = CSRC_DIR / f"{name}.cu"
    lib = library_path(name)
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {src.name}:\n{proc.stderr}")
            lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return ctypes.CDLL(str(lib))
