"""OME-NGFF high-content-screening plate collections (multi-position).

A plate is a zarr group hierarchy ``plate/row/column/field`` where each
field is an ordinary NGFF image: plate metadata enumerates rows, columns
and wells; each well's metadata enumerates its fields (NGFF 0.4 ``plate``/
``well`` specs; 0.5 nests the same blocks under the ``ome`` attributes key
on a zarr v3 store). This module reads and writes both layouts on top of
``io.zarrstack``/``io.zarr3``, so every solver entry point (CLI
deconv/blind, serving) can fan out over wells and fields.

The reference has no IO layer (data arrives as TiPi ShapedArrays from the
host GUI, microscopy/PSF_Estimation.java:316-330); multi-position
ingestion is rebuild-owned surface for the screening workflows the
microscopy ecosystem runs at scale.

A copy of ``microtipi_tpu/io/plate.py`` (that package imports jax on
import); ``tests/test_torch_io.py`` holds the two against each other:
the same arrays make byte-equal files, and each reads the other's.
"""

from __future__ import annotations

import json
import os

import numpy as np

from . import zarr3
from .zarrstack import (
    _node_attrs,
    read_ngff_hyperstack,
    write_ngff_hyperstack,
)

__all__ = [
    "is_plate",
    "read_plate_meta",
    "list_plate_images",
    "read_plate_image",
    "write_plate",
    "plate_info",
]


def _plate_attrs(path: str):
    attrs = _node_attrs(str(path))
    return attrs.get("plate") or (attrs.get("ome") or {}).get("plate")


def _well_attrs(path: str):
    attrs = _node_attrs(str(path))
    return attrs.get("well") or (attrs.get("ome") or {}).get("well")


def is_plate(path) -> bool:
    """A zarr group carrying NGFF ``plate`` metadata (0.4 or 0.5)."""
    p = str(path)
    return os.path.isdir(p) and _plate_attrs(p) is not None


def read_plate_meta(path) -> dict:
    """Normalized plate metadata.

    Returns ``rows``/``columns`` (name lists), ``wells`` (list of dicts with
    ``path``/``row_index``/``column_index``), and ``field_count``.
    """
    plate = _plate_attrs(str(path))
    if plate is None:
        raise ValueError(f"{path} has no NGFF plate metadata")
    rows = [r["name"] if isinstance(r, dict) else r
            for r in plate.get("rows", [])]
    cols = [c["name"] if isinstance(c, dict) else c
            for c in plate.get("columns", [])]
    wells = []
    for w in plate.get("wells", []):
        wells.append({
            "path": w["path"],
            "row_index": int(w.get("rowIndex", 0)),
            "column_index": int(w.get("columnIndex", 0)),
        })
    return {
        "rows": rows,
        "columns": cols,
        "wells": wells,
        "field_count": int(plate.get("field_count", 0) or 0),
        "name": plate.get("name"),
    }


def list_plate_images(path):
    """Every (well_path, field_path) pair, in plate order.

    ``field_path`` is relative to the well group (usually "0", "1", ...);
    join all three to get the image group directory.
    """
    path = str(path)
    meta = read_plate_meta(path)
    out = []
    for w in meta["wells"]:
        wdir = os.path.join(path, *w["path"].split("/"))
        well = _well_attrs(wdir)
        if well and well.get("images"):
            fields = [im["path"] for im in well["images"]]
        else:  # tolerate missing well metadata: take numbered children
            fields = sorted(
                d for d in os.listdir(wdir)
                if os.path.isdir(os.path.join(wdir, d)) and d.isdigit()
            )
        out.extend((w["path"], f) for f in fields)
    return out


def read_plate_image(path, well: str, field=0):
    """One field of one well as ``((T, C, Nz, Ny, Nx), meta)``.

    ``well`` is the plate-relative well path ("A/1"); ``field`` is an index
    into the well's image list or a field path string.
    """
    path = str(path)
    wdir = os.path.join(path, *str(well).split("/"))
    if not os.path.isdir(wdir):
        wells = [w["path"] for w in read_plate_meta(path)["wells"]]
        raise ValueError(f"well {well!r} not in plate (wells: {wells})")
    if isinstance(field, str) and not field.isdigit():
        fpath = field
    else:
        wellmeta = _well_attrs(wdir)
        if wellmeta and wellmeta.get("images"):
            images = [im["path"] for im in wellmeta["images"]]
        else:
            images = sorted(
                d for d in os.listdir(wdir)
                if os.path.isdir(os.path.join(wdir, d)) and d.isdigit()
            )
        idx = int(field)
        if not 0 <= idx < len(images):
            raise ValueError(
                f"field {field} out of range for well {well!r} "
                f"({len(images)} fields)")
        fpath = images[idx]
    return read_ngff_hyperstack(os.path.join(wdir, fpath))


def _write_group(path: str, attrs: dict | None, zarr_format: int):
    if zarr_format == 3:
        zarr3.write_group(path, attributes=attrs)
        return
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, ".zgroup"), "w") as fh:
        json.dump({"zarr_format": 2}, fh)
    if attrs:
        with open(os.path.join(path, ".zattrs"), "w") as fh:
            json.dump(attrs, fh, indent=1)


def write_plate(path, wells, dxy=None, dz=None, channels=None,
                compressor="zlib", zarr_format=2, shard=None, name=None,
                levels=1):
    """Write a plate store from ``wells``: dict well-path -> list of fields.

    Each field is a (Nz, Ny, Nx) volume or (T, C, Nz, Ny, Nx) hyperstack.
    Well paths are "row/column" ("A/1"); rows/columns/field_count metadata
    is derived. ``zarr_format=2`` emits NGFF 0.4, ``=3`` NGFF 0.5.
    """
    path = str(path)
    well_paths = list(wells)
    rows, cols = [], []
    for wp in well_paths:
        r, c = wp.split("/")
        if r not in rows:
            rows.append(r)
        if c not in cols:
            cols.append(c)
    rows, cols = sorted(rows), sorted(cols)
    plate = {
        "rows": [{"name": r} for r in rows],
        "columns": [{"name": c} for c in cols],
        "wells": [
            {"path": wp,
             "rowIndex": rows.index(wp.split("/")[0]),
             "columnIndex": cols.index(wp.split("/")[1])}
            for wp in well_paths
        ],
        "field_count": max((len(v) for v in wells.values()), default=0),
    }
    if name:
        plate["name"] = name
    if zarr_format == 3:
        root_attrs = {"ome": {"version": "0.5", "plate": plate}}
    else:
        plate["version"] = "0.4"
        root_attrs = {"plate": plate}
    _write_group(path, root_attrs, zarr_format)
    for r in rows:
        _write_group(os.path.join(path, r), None, zarr_format)
    for wp in well_paths:
        fields = wells[wp]
        well = {"images": [{"path": str(i)} for i in range(len(fields))]}
        if zarr_format == 3:
            wattrs = {"ome": {"version": "0.5", "well": well}}
        else:
            well["version"] = "0.4"
            wattrs = {"well": well}
        wdir = os.path.join(path, *wp.split("/"))
        _write_group(wdir, wattrs, zarr_format)
        for i, vol in enumerate(fields):
            write_ngff_hyperstack(
                os.path.join(wdir, str(i)), np.asarray(vol), dxy=dxy, dz=dz,
                channels=channels, compressor=compressor,
                zarr_format=zarr_format, shard=shard, levels=levels)


def plate_info(path) -> str:
    """Human-readable summary for the CLI ``info`` command."""
    path = str(path)
    meta = read_plate_meta(path)
    images = list_plate_images(path)
    lines = [
        f"{path}: OME-NGFF plate "
        f"{len(meta['rows'])}x{len(meta['columns'])} "
        f"({len(meta['wells'])} wells, "
        f"{meta['field_count'] or (images and len(images)//max(1,len(meta['wells'])))} "
        f"field(s)/well, {len(images)} images)"
    ]
    if images:
        w, f = images[0]
        arr_shape, imeta = None, None
        try:
            from .zarrstack import read_ngff_metadata_only

            arr_shape, imeta = read_ngff_metadata_only(
                os.path.join(path, *w.split("/"), f))
        except Exception:
            pass
        if arr_shape:
            nt, nc, nz, ny, nx = arr_shape
            lines.append(f"  per image: T={nt} C={nc} Nz={nz} Ny={ny} Nx={nx}")
            parts = [f"{nm} = {v*1e9:.4g} nm"
                     for nm, v in (("dxy", imeta["dxy"]), ("dz", imeta["dz"]))
                     if v]
            if parts:
                lines.append("  " + ", ".join(parts))
    return "\n".join(lines)
