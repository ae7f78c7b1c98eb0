"""TIFF stack IO backed by the native loader (``native/stackio.cpp``).

Reads/writes 3D grayscale stacks (one page per z-plane) as float32 volumes in
this framework's (Nz, Ny, Nx) layout. Page decoding is parallelized in C++
(one libtiff handle per thread); :class:`StackPrefetcher` overlaps host
decoding of the next volume with device compute on the current one — the
host-side half of an input pipeline for time-lapse batches. Readers return
NumPy arrays; moving them to the card is the caller's job.

A port of ``microtipi_tpu/io/tiffstack.py`` (that package imports jax on
import), with the same functions over the same C source, read in place. The
shared library is built at first use with the host's C++ compiler (``$CXX``,
default ``g++``) and libtiff (``tiffio.h`` and ``-ltiff``):
``g++ -O3 -fPIC -std=c++17 -shared native/stackio.cpp -ltiff -pthread``, into
the port's git-ignored ``_build/`` under a name hashed from the source and
the command (``_build.hashed_name``), written to a temporary name and moved
into place, so test processes that build it at once each load a whole one.
``tests/test_torch_io.py`` holds the two packages' files byte-equal.
"""

from __future__ import annotations

import ctypes
import functools
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np

from microtipi_tpu_torch._build import build_atomically, hashed_name

__all__ = [
    "read_stack",
    "write_stack",
    "stack_info",
    "read_pixel_size",
    "StackPrefetcher",
]

_SRC_PATH = Path(__file__).resolve().parents[2] / "native" / "stackio.cpp"
_CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
_LINK_FLAGS = ("-ltiff", "-pthread")


@functools.cache
def _lib() -> ctypes.CDLL:
    if not _SRC_PATH.exists():
        raise RuntimeError(f"the native IO library's source is not present (expected {_SRC_PATH}); "
                           "the TIFF functions need a source checkout")
    cxx = os.environ.get("CXX", "g++")
    lib_path = hashed_name("microtipi_io", _SRC_PATH, (cxx, *_CXX_FLAGS, *_LINK_FLAGS))
    if not lib_path.exists():
        build_atomically(lib_path, [cxx, *_CXX_FLAGS, str(_SRC_PATH), *_LINK_FLAGS, "-o"], _SRC_PATH.name)
    lib = ctypes.CDLL(str(lib_path))
    lib.mt_tiff_info.argtypes = [ctypes.c_char_p] + [ctypes.POINTER(ctypes.c_int)] * 3
    lib.mt_tiff_info.restype = ctypes.c_int
    lib.mt_tiff_read.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
    ]
    lib.mt_tiff_read.restype = ctypes.c_int
    lib.mt_tiff_write.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.mt_tiff_write.restype = ctypes.c_int
    lib.mt_tiff_write_opts.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.mt_tiff_write_opts.restype = ctypes.c_int
    lib.mt_tiff_pixel_size.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
    ]
    lib.mt_tiff_pixel_size.restype = ctypes.c_int
    lib.mt_last_error.restype = ctypes.c_char_p
    return lib


def _raise(lib):
    raise IOError(lib.mt_last_error().decode(errors="replace"))


def stack_info(path: str | os.PathLike) -> tuple[int, int, int]:
    """(Nz, Ny, Nx) of a TIFF stack without decoding it."""
    lib = _lib()
    nz, ny, nx = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.mt_tiff_info(str(path).encode(), nz, ny, nx) != 0:
        _raise(lib)
    return nz.value, ny.value, nx.value


def read_stack(path: str | os.PathLike, z0: int = 0, nz: int | None = None) -> np.ndarray:
    """Decode pages [z0, z0+nz) into a float32 (nz, Ny, Nx) array."""
    lib = _lib()
    tz, ny, nx = stack_info(path)
    if nz is None:
        nz = tz - z0
    out = np.empty((nz, ny, nx), np.float32)
    ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    if lib.mt_tiff_read(str(path).encode(), ptr, z0, nz) != 0:
        _raise(lib)
    return out


def write_stack(
    path: str | os.PathLike,
    volume: np.ndarray,
    compression: str = "none",
    tile: int = 0,
    dxy: float | None = None,
    dz: float | None = None,
    description: str | None = None,
    bigtiff: bool = False,
) -> None:
    """Write a (Nz, Ny, Nx) volume as a float32 multi-page TIFF.

    ``compression``: "none" / "lzw" / "deflate". ``tile``: 0 = strip layout,
    else square tile edge (multiple of 16). ``dxy``/``dz`` pixel sizes in
    meters are stamped as resolution tags + an ImageJ-style description so
    :func:`read_pixel_size` (and ImageJ/Fiji) recover the geometry;
    ``description`` overrides the auto description (e.g. OME-XML).
    ``bigtiff`` forces 64-bit offsets (automatic for payloads near the
    classic 4 GiB limit); reads handle both formats transparently.
    """
    vol = np.ascontiguousarray(volume, np.float32)
    if vol.ndim != 3:
        raise ValueError("expected a 3D (Nz, Ny, Nx) volume")
    lib = _lib()
    ptr = vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    rc = lib.mt_tiff_write_opts(
        str(path).encode(), ptr, *map(int, vol.shape),
        compression.encode(), int(tile), float(dxy or 0.0), float(dz or 0.0),
        description.encode() if description else None, int(bool(bigtiff)),
    )
    if rc != 0:
        _raise(lib)


def read_pixel_size(path: str | os.PathLike) -> tuple[float | None, float | None]:
    """(dxy, dz) in meters from TIFF metadata, None where absent.

    Sources, in priority order: OME-XML ``PhysicalSize{X,Z}(Unit)``
    attributes, ImageJ description (``spacing``/``unit`` + XResolution),
    plain XResolution + ResolutionUnit tags.
    """
    lib = _lib()
    dxy, dz = ctypes.c_double(), ctypes.c_double()
    if lib.mt_tiff_pixel_size(str(path).encode(), dxy, dz) != 0:
        _raise(lib)
    return (dxy.value or None), (dz.value or None)


class StackPrefetcher:
    """Iterator over volumes with background decode of the next ``depth``
    files — keeps the device fed during batched time-lapse processing.

    >>> for name, vol in StackPrefetcher(sorted(glob("*.tif"))):
    ...     result = solve(torch.as_tensor(vol, device="cuda"))
    """

    def __init__(self, paths: Iterable[str | os.PathLike], depth: int = 2):
        self._paths = [str(p) for p in paths]
        self._depth = max(1, depth)

    def __iter__(self) -> Iterator[tuple[str, np.ndarray]]:
        # A fresh executor per iteration keeps the prefetcher reusable
        # (re-iterating or breaking out mid-stream must not poison the next pass).
        pool = ThreadPoolExecutor(max_workers=self._depth)
        pending = []
        it = iter(self._paths)
        try:
            for _ in range(self._depth):
                p = next(it, None)
                if p is None:
                    break
                pending.append((p, pool.submit(read_stack, p)))
            while pending:
                path, fut = pending.pop(0)
                nxt = next(it, None)
                if nxt is not None:
                    pending.append((nxt, pool.submit(read_stack, nxt)))
                yield path, fut.result()
        finally:
            pool.shutdown(wait=False, cancel_futures=True)
