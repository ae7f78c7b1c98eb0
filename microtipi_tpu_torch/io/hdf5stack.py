"""HDF5 volume IO (Imaris / BigDataViewer-style containers).

Complements the native TIFF path for the other half of the microscopy
ecosystem. Thin, gated on h5py (present in this environment; the module
degrades with a clear error elsewhere). Datasets are read as float32
volumes in this framework's (Nz, Ny, Nx) layout.

A copy of ``microtipi_tpu/io/hdf5stack.py`` (that package imports jax on
import); ``tests/test_torch_io.py`` holds the two against each other:
the same arrays make byte-equal files, and each reads the other's.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["read_h5", "write_h5", "list_datasets", "read_bdv", "write_bdv", "bdv_info"]

try:
    import h5py

    _H5_ERR = None
except Exception as e:  # pragma: no cover - environment without h5py
    h5py = None
    _H5_ERR = e


def _require():
    if h5py is None:
        raise ImportError(f"h5py is unavailable: {_H5_ERR}")


def list_datasets(path: str | os.PathLike) -> list[str]:
    """All dataset paths in the file (depth-first)."""
    _require()
    out: list[str] = []
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.append(name) if isinstance(obj, h5py.Dataset) else None)
    return out


def read_h5(path: str | os.PathLike, dataset: str | None = None,
            z0: int = 0, nz: int | None = None) -> np.ndarray:
    """Read (a z-range of) a 3D dataset as float32.

    ``dataset=None`` picks the first 3D dataset in the file (the common
    single-volume case)."""
    _require()
    with h5py.File(path, "r") as f:
        if dataset is None:
            candidates = [n for n in list_datasets(path) if f[n].ndim == 3]
            if not candidates:
                raise ValueError(f"no 3D dataset found in {path}")
            dataset = candidates[0]
        d = f[dataset]
        if d.ndim != 3:
            raise ValueError(f"dataset {dataset!r} is {d.ndim}D, expected 3D")
        stop = d.shape[0] if nz is None else z0 + nz
        if z0 < 0 or stop > d.shape[0]:
            raise ValueError(
                f"z-range [{z0}, {stop}) out of bounds for depth {d.shape[0]}"
            )
        return np.asarray(d[z0:stop], dtype=np.float32)


def write_h5(path: str | os.PathLike, volume: np.ndarray,
             dataset: str = "volume", compression: str | None = None) -> None:
    """Write a (Nz, Ny, Nx) float32 volume, chunked by z-plane (so later
    z-range reads touch only the needed chunks)."""
    _require()
    vol = np.ascontiguousarray(volume, np.float32)
    if vol.ndim != 3:
        raise ValueError("expected a 3D (Nz, Ny, Nx) volume")
    with h5py.File(path, "w") as f:
        f.create_dataset(dataset, data=vol, chunks=(1,) + vol.shape[1:],
                         compression=compression)


# ---- BigDataViewer-style multiscale pyramids --------------------------------

def _bdv_cells_path(setup: int, timepoint: int, level: int) -> str:
    return f"t{timepoint:05d}/s{setup:02d}/{level}/cells"


def write_bdv(path: str | os.PathLike, volume: np.ndarray, *,
              setup: int = 0, timepoint: int = 0, levels: int = 3,
              compression: str | None = "gzip") -> None:
    """Write a BigDataViewer-layout HDF5 pyramid.

    Standard BDV group structure: ``s{setup}/resolutions`` +
    ``s{setup}/subdivisions`` (level metadata, xyz order) and
    ``t{timepoint}/s{setup}/{level}/cells`` datasets (zyx order). Levels are
    2x mean-downsampled per axis; stored float32 (BDV tools accept any
    h5 numeric type; the classic exporter used int16). The reverse of
    :func:`read_bdv` on level 0 is exact.
    """
    _require()
    vol = np.ascontiguousarray(volume, np.float32)
    if vol.ndim != 3:
        raise ValueError("expected a 3D (Nz, Ny, Nx) volume")

    pyr = [vol]
    for _ in range(1, levels):
        v = pyr[-1]
        if min(v.shape) < 2:
            break
        ez, ey, ex = (s % 2 for s in v.shape)
        v = v[: v.shape[0] - ez, : v.shape[1] - ey, : v.shape[2] - ex]
        v = v.reshape(v.shape[0] // 2, 2, v.shape[1] // 2, 2, v.shape[2] // 2, 2)
        pyr.append(v.mean(axis=(1, 3, 5)))

    # xyz-order metadata, per the BDV spec.
    res = np.asarray([[2.0 ** l] * 3 for l in range(len(pyr))], np.float64)
    subdiv = np.asarray(
        [[min(64, p.shape[2]), min(64, p.shape[1]), min(8, p.shape[0])] for p in pyr],
        np.int32,
    )
    with h5py.File(path, "a") as f:
        g = f.require_group(f"s{setup:02d}")
        for name, val in (("resolutions", res), ("subdivisions", subdiv)):
            if name in g:
                del g[name]
            g.create_dataset(name, data=val)
        for l, p in enumerate(pyr):
            cells = _bdv_cells_path(setup, timepoint, l)
            if cells in f:
                del f[cells]
            chunks = tuple(min(c, s) for c, s in zip((8, 64, 64), p.shape))
            f.create_dataset(cells, data=p, chunks=chunks, compression=compression)


def read_bdv(path: str | os.PathLike, *, setup: int = 0, timepoint: int = 0,
             level: int = 0, z0: int = 0, nz: int | None = None) -> np.ndarray:
    """Read (a z-range of) one pyramid level from a BigDataViewer HDF5 file."""
    _require()
    with h5py.File(path, "r") as f:
        cells = _bdv_cells_path(setup, timepoint, level)
        if cells not in f:
            raise ValueError(f"no dataset {cells!r} in {path}")
        d = f[cells]
        stop = d.shape[0] if nz is None else z0 + nz
        return np.asarray(d[z0:stop], dtype=np.float32)


def bdv_info(path: str | os.PathLike, setup: int = 0):
    """(resolutions, level shapes) of a BDV pyramid."""
    _require()
    with h5py.File(path, "r") as f:
        res = np.asarray(f[f"s{setup:02d}/resolutions"])
        shapes = []
        for t in sorted(k for k in f.keys() if k.startswith("t")):
            grp = f[t].get(f"s{setup:02d}")
            if grp is None:
                continue
            shapes = [tuple(grp[l]["cells"].shape) for l in sorted(grp.keys(), key=int)]
            break
        return res, shapes
