"""Build the package's native libraries at first use: the CUDA kernels with
``nvcc``, and the TIFF reader (``io/tiffstack.py``) with the host's C++
compiler.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into a shared library under ``microtipi_tpu_torch/_build/`` (git-ignored),
keyed on a hash of the source and the flags, then loaded with ``ctypes``.
``ptxas`` reports each kernel's registers, shared memory and spills
(``-Xptxas -v``); the report is kept beside the library and
:func:`build_report` returns it. Nothing here runs at import time, and
nothing includes PyTorch's headers, so a build takes seconds. ``nvcc`` is
found on ``PATH``, else under ``$CUDA_HOME/bin`` (default
``/usr/local/cuda``). Every library is written under a temporary name and
moved into place with ``os.replace`` (:func:`build_atomically`), so
processes that build the same library at once each load a whole one.
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

__all__ = ["BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "build_atomically", "build_report", "hashed_name", "library_path",
           "load_library", "nvcc_path"]

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


def hashed_name(name: str, src: Path, flags) -> Path:
    """``_build/lib<name>-<key>.so``, keyed on a hash of the source and the flags."""
    key = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` with these flags lies."""
    return hashed_name(name, CSRC_DIR / f"{name}.cu", NVCC_FLAGS)


def build_atomically(lib: Path, argv, what: str) -> str:
    """Run the compiler ``argv + [tmp]`` (its output file last) into a
    temporary name beside ``lib`` and move it into place; returns what the
    compiler printed. A concurrent loader sees the whole library or none."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([*argv, tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{argv[0]} failed to build {what}:\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return proc.stdout + proc.stderr


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
        report = build_atomically(lib, [nvcc_path(), *NVCC_FLAGS, str(src), "-o"], src.name)
        lib.with_suffix(".log").write_text(report)
    return ctypes.CDLL(str(lib))
