"""Zarr v2 / OME-NGFF volume IO, implemented from scratch on the stdlib.

The cloud-native half of the microscopy ecosystem (napari, ome-zarr,
webKnossos, MoBIE) exchanges OME-NGFF: a zarr v2 directory hierarchy with
``multiscales`` metadata. The reference ecosystem's host (Icy) reads OME-TIFF
(``io.ome``); NGFF is the same logical model on a chunked store. No ``zarr``
package ships in this environment, and the v2 container format is small
enough to own directly: JSON metadata files + one file per chunk.

Supported surface (clear errors beyond it):

- zarr format v2 directory stores (``.zarray``/``.zgroup``/``.zattrs``);
- compressors: ``null`` (raw), ``zlib``, ``gzip`` (stdlib), plus ``blosc``
  (all cnames/shuffles), ``zstd``, and numcodecs-framed ``lz4`` via the
  system C libraries (``io.codecs``; blosc-lz4/zlib chunks also decode with
  a pure-Python fallback when the libraries are absent);
- C and F chunk order, any numpy dtype with an endianness tag, missing
  chunks -> ``fill_value``;
- OME-NGFF 0.4 ``multiscales`` (axes subsets of t/c/z/y/x, scale
  transforms); reading picks the full-resolution dataset, writing emits a
  single-scale pyramid.

Layout convention matches the rest of the package: volumes are (Nz, Ny, Nx),
hyperstacks (T, C, Nz, Ny, Nx) like ``io.ome.read_ome_hyperstack``.

A copy of ``microtipi_tpu/io/zarrstack.py`` (that package imports jax on
import); ``tests/test_torch_io.py`` holds the two against each other:
the same arrays make byte-equal files, and each reads the other's.
"""

from __future__ import annotations

import json
import os
import zlib

import numpy as np

from . import codecs, zarr3

__all__ = [
    "is_zarr",
    "read_zarr",
    "write_zarr",
    "read_ngff_hyperstack",
    "write_ngff_hyperstack",
    "read_pixel_size",
    "zarr_info",
]

_AXES5 = ("t", "c", "z", "y", "x")


# ---------------------------------------------------------------------------
# zarr v2 array store
# ---------------------------------------------------------------------------


def is_zarr(path) -> bool:
    """A zarr array or group directory (or a path named like one), v2 or v3."""
    p = str(path)
    if os.path.isdir(p):
        return any(
            os.path.exists(os.path.join(p, f))
            for f in (".zarray", ".zgroup", ".zattrs", "zarr.json")
        )
    return p.rstrip("/").lower().endswith(".zarr")


def _load_json(path):
    with open(path, "r") as fh:
        return json.load(fh)


def _decompress(buf: bytes, compressor) -> bytes:
    if compressor is None:
        return buf
    cid = compressor.get("id")
    if cid == "zlib":
        return zlib.decompress(buf)
    if cid == "gzip":
        return zlib.decompress(buf, wbits=31)
    if cid == "blosc":
        return codecs.blosc_decompress(buf)
    if cid == "zstd":
        return codecs.zstd_decompress(buf)
    if cid == "lz4":
        return codecs.lz4_decompress(buf)
    raise ValueError(
        f"unsupported zarr compressor {cid!r}: this reader handles "
        "null/zlib/gzip/blosc/zstd/lz4"
    )


def _compress(buf: bytes, compressor, typesize: int = 1) -> bytes:
    if compressor is None:
        return buf
    cid = compressor["id"]
    level = int(compressor.get("level", compressor.get("clevel", 1)))
    if cid == "zlib":
        return zlib.compress(buf, level)
    if cid == "gzip":
        co = zlib.compressobj(level, zlib.DEFLATED, 31)
        return co.compress(buf) + co.flush()
    if cid == "blosc":
        return codecs.blosc_compress(
            buf,
            typesize=typesize,
            cname=compressor.get("cname", "lz4"),
            clevel=int(compressor.get("clevel", 5)),
            shuffle=int(compressor.get("shuffle", 1)),
            blocksize=int(compressor.get("blocksize", 0)),
        )
    if cid == "zstd":
        return codecs.zstd_compress(buf, level)
    if cid == "lz4":
        return codecs.lz4_compress(buf)
    raise ValueError(f"unsupported compressor {cid!r}")


def _chunk_key(idx, sep):
    return sep.join(str(i) for i in idx)


def _read_array(adir: str) -> np.ndarray:
    """Read one array directory, dispatching on the store format."""
    if zarr3.is_zarr3_array(adir):
        return zarr3.read_array(adir)
    return _read_array_v2(adir)


def _read_array_v2(adir: str) -> np.ndarray:
    meta = _load_json(os.path.join(adir, ".zarray"))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"unsupported zarr_format {meta.get('zarr_format')!r} (v2 only)")
    if meta.get("filters"):
        raise ValueError("zarr filters are not supported by this stdlib reader")
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    dtype = np.dtype(meta["dtype"])
    order = meta.get("order", "C")
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    fill = 0 if fill is None else fill
    out = np.full(shape, fill, dtype=dtype)
    grid = [range((s + c - 1) // c) for s, c in zip(shape, chunks)]
    import itertools

    for idx in itertools.product(*grid):
        cpath = os.path.join(adir, _chunk_key(idx, sep))
        if not os.path.exists(cpath):  # missing chunk -> fill_value
            continue
        with open(cpath, "rb") as fh:
            raw = _decompress(fh.read(), meta.get("compressor"))
        block = np.frombuffer(raw, dtype=dtype).reshape(chunks, order=order)
        sl = tuple(
            slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape)
        )
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    return out


def _write_array(adir: str, arr: np.ndarray, chunks=None, compressor="zlib", level=1):
    os.makedirs(adir, exist_ok=True)
    arr = np.asarray(arr)
    if chunks is None:
        # One z-plane (or trailing-2D slab) per chunk: streams well and maps
        # to how the solvers touch volumes.
        chunks = (1,) * max(0, arr.ndim - 2) + arr.shape[-2:] if arr.ndim >= 2 else arr.shape
    chunks = tuple(min(c, s) for c, s in zip(chunks, arr.shape))
    if compressor in (None, "null"):
        comp = None
    elif isinstance(compressor, dict):
        comp = compressor
    elif compressor == "blosc":
        comp = {"id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1,
                "blocksize": 0}
    elif compressor == "lz4":
        comp = {"id": "lz4", "acceleration": 1}
    else:  # zlib / gzip / zstd
        comp = {"id": compressor, "level": int(level)}
    meta = {
        "zarr_format": 2,
        "shape": list(arr.shape),
        "chunks": list(chunks),
        "dtype": arr.dtype.str,
        "compressor": comp,
        "fill_value": 0,
        "order": "C",
        "filters": None,
    }
    with open(os.path.join(adir, ".zarray"), "w") as fh:
        json.dump(meta, fh)
    import itertools

    grid = [range((s + c - 1) // c) for s, c in zip(arr.shape, chunks)]
    for idx in itertools.product(*grid):
        sl = tuple(
            slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, arr.shape)
        )
        block = arr[sl]
        if block.shape != chunks:  # edge chunks are stored full-size in v2
            pad = np.zeros(chunks, dtype=arr.dtype)
            pad[tuple(slice(0, b) for b in block.shape)] = block
            block = pad
        with open(os.path.join(adir, _chunk_key(idx, ".")), "wb") as fh:
            fh.write(_compress(np.ascontiguousarray(block).tobytes(), comp,
                               typesize=arr.dtype.itemsize))


def _is_array_dir(p: str) -> bool:
    return os.path.exists(os.path.join(p, ".zarray")) or zarr3.is_zarr3_array(p)


def _node_attrs(path: str) -> dict:
    """User attributes of a v2 (.zattrs) or v3 (zarr.json) node."""
    attrs_p = os.path.join(path, ".zattrs")
    if os.path.exists(attrs_p):
        return _load_json(attrs_p)
    if os.path.exists(os.path.join(path, "zarr.json")):
        return zarr3.group_attributes(path)
    return {}


def _multiscales(attrs: dict):
    """NGFF multiscales from 0.4 (top-level) or 0.5 (under ``ome``) attrs."""
    return attrs.get("multiscales") or (attrs.get("ome") or {}).get("multiscales")


def _omero(attrs: dict) -> dict:
    return attrs.get("omero") or (attrs.get("ome") or {}).get("omero") or {}


def _resolve_array_dir(path: str) -> str:
    """Array dir for ``path``: itself, the NGFF full-resolution dataset, or
    the first array child of a plain group."""
    if _is_array_dir(path):
        return path
    ms = _multiscales(_node_attrs(path))
    if ms:
        ds = ms[0]["datasets"][0]["path"]  # full resolution first (NGFF)
        return os.path.join(path, ds)
    for name in sorted(os.listdir(path)):
        sub = os.path.join(path, name)
        if os.path.isdir(sub) and _is_array_dir(sub):
            return sub
    raise ValueError(f"no zarr array found under {path}")


def read_zarr(path) -> np.ndarray:
    """Read a zarr v2/v3 array (or a group's full-resolution/first array)."""
    return _read_array(_resolve_array_dir(str(path)))


def write_zarr(path, arr, chunks=None, compressor="zlib", level=1,
               zarr_format=2, shard=None):
    """Write a bare zarr array directory (``zarr_format`` 2 or 3).

    ``shard`` (v3 only): inner chunk shape for ``sharding_indexed`` storage.
    """
    if zarr_format == 3:
        zarr3.write_array(str(path), np.asarray(arr), chunks=chunks,
                          compressor=compressor, shard=shard)
        return
    if shard is not None:
        raise ValueError("sharding needs zarr_format=3")
    _write_array(str(path), np.asarray(arr), chunks, compressor, level)


# ---------------------------------------------------------------------------
# OME-NGFF 0.4
# ---------------------------------------------------------------------------


def _ngff_axes(path: str):
    """(axes names, scale values, array dir) of the NGFF image at ``path``;
    (None, None, array dir) for a bare array. Handles NGFF 0.4 (zarr v2)
    and 0.5 (zarr v3, attrs under the ``ome`` key)."""
    ms = _multiscales(_node_attrs(path))
    if not ms:
        return None, None, _resolve_array_dir(path)
    m = ms[0]
    axes = [a["name"] if isinstance(a, dict) else a for a in m.get("axes", [])]
    ds = m["datasets"][0]
    scale = None
    for tr in ds.get("coordinateTransformations", []):
        if tr.get("type") == "scale":
            scale = tr["scale"]
    return axes, scale, os.path.join(path, ds["path"])


def read_ngff_hyperstack(path):
    """Read an OME-NGFF image as ``(T, C, Nz, Ny, Nx)`` float32 + metadata.

    Mirrors ``io.ome.read_ome_hyperstack``: missing t/c/z axes are
    singleton-expanded; ``meta`` carries ``dxy``/``dz`` (meters, from the
    scale transform — NGFF scales are conventionally micrometers, converted
    here) and ``channels`` (from ``omero`` metadata when present).
    """
    path = str(path)
    axes, scale, adir = _ngff_axes(path)
    arr = _read_array(adir).astype(np.float32)
    if axes is None:
        if arr.ndim == 3:
            axes = ["z", "y", "x"]
        elif arr.ndim == 5:
            axes = list(_AXES5)
        else:
            raise ValueError(f"bare zarr array is {arr.ndim}D; expected 3D or 5D")
    if len(axes) != arr.ndim:
        raise ValueError(f"NGFF axes {axes} do not match array rank {arr.ndim}")
    unknown = [a for a in axes if a not in _AXES5]
    if unknown:
        raise ValueError(f"unsupported NGFF axes {unknown} (t/c/z/y/x only)")
    # Reorder to TCZYX and expand missing axes.
    order = [axes.index(a) for a in _AXES5 if a in axes]
    arr = np.transpose(arr, order)
    for i, a in enumerate(_AXES5):
        if a not in axes:
            arr = np.expand_dims(arr, i)
    meta = {"dxy": None, "dz": None, "channels": []}
    if scale is not None:
        per_axis = dict(zip([a for a in _AXES5 if a in axes], [scale[i] for i in order]))
        if "x" in per_axis:
            meta["dxy"] = float(per_axis["x"]) * 1e-6
        if "z" in per_axis:
            meta["dz"] = float(per_axis["z"]) * 1e-6
    omero = _omero(_node_attrs(path))
    for ch in omero.get("channels", []):
        meta["channels"].append({
            "name": ch.get("label"),
            "emission_wavelength": (
                float(ch["emissionWavelength"]) * 1e-9
                if ch.get("emissionWavelength") else None
            ),
        })
    return arr, meta


def _halve_spatial(v):
    """One 2x mean-downsample step over the spatial axes of a TCZYX array.

    Each of z/y/x with extent >= 2 is halved (a trailing odd plane is
    trimmed — same convention as the BDV pyramid writer,
    ``io.hdf5stack.write_bdv``); axes already at extent 1 pass through.
    Returns ``(halved, per-axis factors)`` with factors in (z, y, x) order
    (2.0 where halved, 1.0 where passed through) — None when nothing was
    halved (pyramid exhausted).
    """
    facs = []
    for ax in (2, 3, 4):
        n = v.shape[ax]
        if n < 2:
            facs.append(1.0)
            continue
        sl = [slice(None)] * v.ndim
        sl[ax] = slice(0, n - (n % 2))
        v = v[tuple(sl)]
        shape = list(v.shape)
        shape[ax] //= 2
        shape.insert(ax + 1, 2)
        v = v.reshape(shape).mean(axis=ax + 1, dtype=np.float64).astype(v.dtype)
        facs.append(2.0)
    if all(f == 1.0 for f in facs):
        return None, None
    return v, tuple(facs)


def write_ngff_hyperstack(path, arr, dxy=None, dz=None, channels=None,
                          compressor="zlib", level=1, chunks=None,
                          zarr_format=2, shard=None, levels=1):
    """Write ``(T, C, Nz, Ny, Nx)`` (or a plain 3D volume) as OME-NGFF.

    ``zarr_format=2`` emits NGFF 0.4 (``.zattrs`` metadata); ``zarr_format=3``
    emits NGFF 0.5 (attributes under the ``ome`` key of the group's
    ``zarr.json``, optionally sharded chunks). Multiscales carry a TCZYX
    axes block and scale transforms (micrometers, the NGFF convention —
    ``dxy``/``dz`` are meters like the rest of the package). ``levels > 1``
    writes a 2x mean-downsampled spatial pyramid (datasets ``0..L-1``, the
    per-level scale transforms doubling per halved axis) — what NGFF
    viewers (napari, vizarr, neuroglancer) stream large volumes from; thin
    axes stop halving at extent 1, and the pyramid stops early when no
    axis can halve. ``channels`` (list of dicts with
    ``name``/``emission_wavelength``) lands in ``omero`` metadata. Readers
    here always pick dataset 0 (full resolution), so level-0 round-trips
    are exact regardless of ``levels``.
    """
    path = str(path)
    arr = np.asarray(arr)
    if arr.ndim == 3:
        arr = arr[None, None]
    if arr.ndim != 5:
        raise ValueError(f"expected 3D or 5D (TCZYX), got {arr.ndim}D")
    sx = (dxy or 1e-6) * 1e6
    sz = (dz or 1e-6) * 1e6

    pyramid = [arr]
    scales = [(1.0, 1.0, 1.0)]
    for _ in range(1, max(1, int(levels))):
        v, facs = _halve_spatial(pyramid[-1])
        if v is None:
            break
        fz, fy, fx = scales[-1]
        pyramid.append(v)
        scales.append((fz * facs[0], fy * facs[1], fx * facs[2]))

    ms = {
        "version": "0.4" if zarr_format == 2 else "0.5",
        "name": os.path.basename(path.rstrip("/")),
        "axes": [
            {"name": "t", "type": "time"},
            {"name": "c", "type": "channel"},
            {"name": "z", "type": "space", "unit": "micrometer"},
            {"name": "y", "type": "space", "unit": "micrometer"},
            {"name": "x", "type": "space", "unit": "micrometer"},
        ],
        "datasets": [{
            "path": str(l),
            "coordinateTransformations": [
                {"type": "scale",
                 "scale": [1.0, 1.0, sz * fz, sx * fy, sx * fx]}
            ],
        } for l, (fz, fy, fx) in enumerate(scales)],
    }
    omero = None
    if channels:
        omero = {"channels": [
            {
                "label": ch.get("name"),
                **({"emissionWavelength": ch["emission_wavelength"] * 1e9}
                   if ch.get("emission_wavelength") else {}),
            }
            for ch in channels
        ]}
    if zarr_format == 3:
        del ms["version"]  # NGFF 0.5 carries the version on the ome block
        ome = {"version": "0.5", "multiscales": [ms]}
        if omero:
            ome["omero"] = omero
        zarr3.write_group(path, attributes={"ome": ome})
        for l, v in enumerate(pyramid):
            zarr3.write_array(os.path.join(path, str(l)), v,
                              chunks=chunks if l == 0 else None,
                              compressor=compressor, shard=shard,
                              dimension_names=list(_AXES5))
        return
    if shard is not None:
        raise ValueError("sharding needs zarr_format=3")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, ".zgroup"), "w") as fh:
        json.dump({"zarr_format": 2}, fh)
    attrs = {"multiscales": [ms]}
    if omero:
        attrs["omero"] = omero
    with open(os.path.join(path, ".zattrs"), "w") as fh:
        json.dump(attrs, fh, indent=1)
    for l, v in enumerate(pyramid):
        _write_array(os.path.join(path, str(l)), v,
                     chunks if l == 0 else None, compressor, level)


def read_pixel_size(path):
    """(dxy, dz) in meters from the NGFF scale transform (None when absent)."""
    _, meta = read_ngff_metadata_only(path)
    return meta["dxy"], meta["dz"]


def read_ngff_metadata_only(path):
    """(shape-as-TCZYX, meta) without reading chunk data."""
    path = str(path)
    axes, scale, adir = _ngff_axes(path)
    if zarr3.is_zarr3_array(adir):
        shape = zarr3.array_meta(adir)["shape"]
    else:
        shape = tuple(_load_json(os.path.join(adir, ".zarray"))["shape"])
    if axes is None:
        axes = ["z", "y", "x"] if len(shape) == 3 else list(_AXES5[-len(shape):])
    per_axis = {}
    if scale is not None:
        per_axis = dict(zip(axes, scale))
    full = {a: 1 for a in _AXES5}
    for a, s in zip(axes, shape):
        if a in full:
            full[a] = s
    meta = {
        "dxy": float(per_axis["x"]) * 1e-6 if "x" in per_axis else None,
        "dz": float(per_axis["z"]) * 1e-6 if "z" in per_axis else None,
    }
    return tuple(full[a] for a in _AXES5), meta


def zarr_info(path) -> str:
    """Human-readable one/few-line description for the CLI ``info`` command."""
    path = str(path)
    (nt, nc, nz, ny, nx), meta = read_ngff_metadata_only(path)
    lines = [f"{path}: OME-NGFF/zarr T={nt} C={nc} Nz={nz} Ny={ny} Nx={nx}"]
    parts = [f"{name} = {v*1e9:.4g} nm"
             for name, v in (("dxy", meta["dxy"]), ("dz", meta["dz"])) if v]
    if parts:
        lines.append("  " + ", ".join(parts))
    return "\n".join(lines)
