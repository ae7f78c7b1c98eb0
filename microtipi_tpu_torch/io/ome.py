"""OME-XML metadata: generate, write, and read OME-TIFF geometry.

The reference ecosystem (Icy, which hosted microTiPi's GUI — provenance
headers at ``src/microTiPi/epifluorescence/WideFieldModel.java`` of the reference)
exchanges volumes as OME-TIFF: a plain TIFF whose first page carries an
OME-XML document in its ImageDescription tag. Round 1 shipped OME *reading*
(pixel sizes, ``native/stackio.cpp::mt_tiff_pixel_size``); this module adds
the writing half so results re-enter OME-aware tools (Fiji/Bio-Formats,
Icy, napari-ome) with correct voxel geometry, plus a Python-side parser for
the richer fields the native fast path does not need.

Only the metadata this framework produces is emitted (single-channel,
single-timepoint float volumes) — a minimal but schema-shaped OME 2016-06
document, not a full Bio-Formats implementation.

A copy of ``microtipi_tpu/io/ome.py`` (that package imports jax on
import); ``tests/test_torch_io.py`` holds the two against each other:
the same arrays make byte-equal files, and each reads the other's.
Its TIFF calls go to the port's ``io/tiffstack.py``.
"""

from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from xml.sax.saxutils import quoteattr

import numpy as np

__all__ = [
    "ome_xml",
    "parse_ome",
    "read_description",
    "read_ome",
    "read_ome_companion",
    "read_ome_hyperstack",
    "write_ome_stack",
    "write_ome_companion",
    "write_ome_hyperstack",
]

_OME_NS = "http://www.openmicroscopy.org/Schemas/OME/2016-06"
_MICRON = "µm"


def ome_xml(
    shape: tuple[int, int, int],
    dxy: float | None = None,
    dz: float | None = None,
    name: str = "microtipi",
    size_c: int = 1,
    size_t: int = 1,
    channel_names=None,
    emission_wavelengths=None,
    tiff_data=None,
) -> str:
    """Minimal OME 2016-06 document for float32 volume(s), (Nz, Ny, Nx) per
    channel/timepoint.

    ``dxy``/``dz`` are in meters (the framework's unit end to end) and are
    emitted as ``PhysicalSize*`` in micrometers, the OME default unit — the
    same attributes ``mt_tiff_pixel_size`` reads back, so write->read
    round-trips the geometry exactly. Multi-channel/timepoint documents
    (``size_c``/``size_t`` > 1) describe pages in ``XYZCT`` order (z fastest,
    then channel, then time); ``emission_wavelengths`` are per-channel, in
    meters, emitted in nm (what the PSF model's ``wavelength`` wants back).

    ``tiff_data``: optional explicit ``<TiffData>`` plane map for multi-file
    sets — dicts with ``ifd``/``plane_count``/``first_z``/``first_c``/
    ``first_t``/``filename`` (the companion-file convention: planes live in
    the referenced sibling TIFFs). Default: one block covering every plane
    of this file.
    """
    nz, ny, nx = (int(s) for s in shape)
    nc, nt = int(size_c), int(size_t)
    phys = ""
    if dxy:
        um = dxy * 1e6
        phys += (
            f' PhysicalSizeX="{um:.9g}" PhysicalSizeXUnit={quoteattr(_MICRON)}'
            f' PhysicalSizeY="{um:.9g}" PhysicalSizeYUnit={quoteattr(_MICRON)}'
        )
    if dz:
        phys += f' PhysicalSizeZ="{dz * 1e6:.9g}" PhysicalSizeZUnit={quoteattr(_MICRON)}'
    channels = ""
    for c in range(nc):
        attrs = f'<Channel ID="Channel:0:{c}" SamplesPerPixel="1"'
        if channel_names is not None and c < len(channel_names) and channel_names[c]:
            attrs += f" Name={quoteattr(str(channel_names[c]))}"
        if (
            emission_wavelengths is not None
            and c < len(emission_wavelengths)
            and emission_wavelengths[c]
        ):
            attrs += (
                f' EmissionWavelength="{emission_wavelengths[c] * 1e9:.9g}"'
                ' EmissionWavelengthUnit="nm"'
            )
        channels += attrs + "/>"
    if tiff_data is None:
        td_xml = f'<TiffData IFD="0" PlaneCount="{nz * nc * nt}"/>'
    else:
        td_xml = ""
        for td in tiff_data:
            td_xml += (
                f'<TiffData IFD="{int(td.get("ifd", 0))}"'
                f' PlaneCount="{int(td["plane_count"])}"'
                f' FirstZ="{int(td.get("first_z", 0))}"'
                f' FirstC="{int(td.get("first_c", 0))}"'
                f' FirstT="{int(td.get("first_t", 0))}">'
            )
            if td.get("filename"):
                td_xml += f"<UUID FileName={quoteattr(str(td['filename']))}/>"
            td_xml += "</TiffData>"
    return (
        '<?xml version="1.0" encoding="UTF-8"?>'
        f'<OME xmlns="{_OME_NS}"'
        ' xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance"'
        f' xsi:schemaLocation="{_OME_NS} {_OME_NS}/ome.xsd">'
        f'<Image ID="Image:0" Name={quoteattr(name)}>'
        '<Pixels ID="Pixels:0" DimensionOrder="XYZCT" Type="float"'
        f' SizeX="{nx}" SizeY="{ny}" SizeZ="{nz}" SizeC="{nc}" SizeT="{nt}"'
        f' BigEndian="false"{phys}>'
        f"{channels}"
        f"{td_xml}"
        "</Pixels></Image></OME>"
    )


def parse_ome(xml: str) -> dict:
    """Parse an OME-XML document into a flat dict.

    Returns ``shape`` (Nz, Ny, Nx), ``dxy``/``dz`` in meters (None where
    absent), ``dtype`` (OME ``Type`` string), ``name``, plus the hyperstack
    fields: ``size_c``/``size_t``, ``dimension_order``, and ``channels`` —
    one dict per channel with ``name`` and ``emission_wavelength`` in meters
    (None where absent). Namespace-agnostic so documents from any OME schema
    year parse.
    """
    root = ET.fromstring(xml)

    def local(tag):
        return tag.rsplit("}", 1)[-1]

    pixels = image = None
    channel_els = []
    for el in root.iter():
        if local(el.tag) == "Pixels" and pixels is None:
            pixels = el
        elif local(el.tag) == "Image" and image is None:
            image = el
        elif local(el.tag) == "Channel":
            channel_els.append(el)
    if pixels is None:
        raise ValueError("no <Pixels> element in OME-XML")

    def size(axis):
        v = pixels.get(f"Size{axis}")
        return int(v) if v else None

    _UNIT = {
        _MICRON: 1e-6, "um": 1e-6, "micron": 1e-6, "nm": 1e-9,
        "mm": 1e-3, "cm": 1e-2, "m": 1.0, "Å": 1e-10, "pm": 1e-12,
    }

    def phys(axis):
        v = pixels.get(f"PhysicalSize{axis}")
        if not v:
            return None
        scale = _UNIT.get(pixels.get(f"PhysicalSize{axis}Unit") or _MICRON)
        return float(v) * scale if scale else None

    def emission(el):
        v = el.get("EmissionWavelength")
        if not v:
            return None
        # OME 2016-06 defaults EmissionWavelength to nm.
        scale = _UNIT.get(el.get("EmissionWavelengthUnit") or "nm")
        return float(v) * scale if scale else None

    tiff_data = []
    for el in pixels:
        if local(el.tag) != "TiffData":
            continue
        fname = None
        for ch in el:
            if local(ch.tag) == "UUID":
                fname = ch.get("FileName")
        pc = el.get("PlaneCount")
        tiff_data.append({
            "ifd": int(el.get("IFD") or 0),
            "plane_count": int(pc) if pc else None,
            "first_z": int(el.get("FirstZ") or 0),
            "first_c": int(el.get("FirstC") or 0),
            "first_t": int(el.get("FirstT") or 0),
            "filename": fname,
        })

    return {
        "shape": (size("Z") or 1, size("Y"), size("X")),
        "dxy": phys("X"),
        "dz": phys("Z"),
        "dtype": pixels.get("Type"),
        "name": image.get("Name") if image is not None else None,
        "size_c": size("C") or 1,
        "size_t": size("T") or 1,
        "dimension_order": pixels.get("DimensionOrder") or "XYZCT",
        "channels": [
            {"name": el.get("Name"), "emission_wavelength": emission(el)}
            for el in channel_els
        ],
        "tiff_data": tiff_data,
    }


def read_description(path: str | os.PathLike) -> str:
    """The first page's ImageDescription tag ('' when absent)."""
    import ctypes

    from microtipi_tpu_torch.io.tiffstack import _lib

    lib = _lib()
    if not hasattr(lib.mt_tiff_description, "_mt_configured"):
        lib.mt_tiff_description.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
        lib.mt_tiff_description.restype = ctypes.c_int
        lib.mt_tiff_description._mt_configured = True
    cap = 1 << 16
    while True:
        buf = ctypes.create_string_buffer(cap)
        n = lib.mt_tiff_description(str(path).encode(), buf, cap)
        if n < 0:
            raise IOError(lib.mt_last_error().decode(errors="replace"))
        if n < cap:
            return buf.value.decode("utf-8", errors="replace")
        cap = n + 1  # description longer than the probe buffer: retry exact


def read_ome(path: str | os.PathLike) -> dict | None:
    """Parsed OME metadata of a TIFF, or None if it carries no OME-XML."""
    desc = read_description(path)
    if "<OME" not in desc:
        return None
    # OME-TIFF allows leading comments/BOM; slice from the root element.
    start = desc.find("<OME")
    m = re.search(r"<\?xml[^>]*\?>", desc[:start])
    xml = (m.group(0) if m else "") + desc[start:]
    return parse_ome(xml)


def _plane_index(meta):
    """(compose, decompose) between linear plane index and (z, c, t) for the
    document's DimensionOrder (letters after XY, fastest-varying first)."""
    order = meta["dimension_order"].upper()
    letters = order[2:5]
    if sorted(letters) != ["C", "T", "Z"]:
        raise ValueError(f"unsupported DimensionOrder {order!r}")
    nz = meta["shape"][0] or 1
    sizes = {"Z": nz, "C": meta["size_c"], "T": meta["size_t"]}

    def compose(z, c, t):
        vals = {"Z": z, "C": c, "T": t}
        lin, stride = 0, 1
        for d in letters:  # fastest first
            lin += vals[d] * stride
            stride *= sizes[d]
        return lin

    def decompose(lin):
        vals = {}
        for d in letters:
            vals[d] = lin % sizes[d]
            lin //= sizes[d]
        return vals["Z"], vals["C"], vals["T"]

    return compose, decompose


def _assemble_multifile(dirname: str, meta: dict, default_file: str | None = None):
    """Assemble a (T, C, Z, Y, X) array from a multi-file TiffData plane map.

    Each ``<TiffData>`` block maps ``PlaneCount`` consecutive IFDs of its
    referenced file (``<UUID FileName>``; ``default_file`` when absent — the
    self-referencing master-file case) onto consecutive plane indices from
    ``(FirstZ, FirstC, FirstT)`` in DimensionOrder. The Bio-Formats
    companion-file convention.
    """
    from microtipi_tpu_torch.io.tiffstack import read_stack

    nz, ny, nx = meta["shape"]
    nz = nz or 1
    nc, nt = meta["size_c"], meta["size_t"]
    compose, decompose = _plane_index(meta)
    arr = np.zeros((nt, nc, nz, ny, nx), np.float32)
    filled = np.zeros(nt * nc * nz, bool)
    cache: dict[str, np.ndarray] = {}
    for td in meta["tiff_data"]:
        fname = td["filename"] or default_file
        if fname is None:
            raise ValueError("TiffData block has no FileName and no default file")
        if fname not in cache:
            cache[fname] = read_stack(os.path.join(dirname, fname))
        pages = cache[fname]
        count = td["plane_count"]
        if count is None:
            count = pages.shape[0] - td["ifd"]
        start = compose(td["first_z"], td["first_c"], td["first_t"])
        for k in range(count):
            z, c, t = decompose(start + k)
            arr[t, c, z] = pages[td["ifd"] + k]
            filled[start + k] = True
    if not filled.all():
        missing = int((~filled).sum())
        raise ValueError(f"multi-file OME set is incomplete: {missing} of "
                         f"{filled.size} planes unmapped")
    return arr, meta


def read_ome_companion(path: str | os.PathLike):
    """Read a ``.companion.ome`` master document (plain OME-XML, no pixels)
    and assemble the referenced sibling TIFFs into ``(T, C, Z, Y, X)``."""
    with open(path, "r", encoding="utf-8") as fh:
        xml = fh.read()
    meta = parse_ome(xml)
    if not meta["tiff_data"]:
        raise ValueError(f"{path} maps no TiffData planes")
    return _assemble_multifile(os.path.dirname(str(path)) or ".", meta)


def read_ome_hyperstack(path: str | os.PathLike):
    """Read a (possibly multi-channel/timepoint) OME-TIFF as a 5D array.

    Returns ``(array, meta)`` with ``array`` shaped ``(T, C, Z, Y, X)``
    (singleton axes kept — a plain single-volume file comes back as
    ``(1, 1, Z, Y, X)``) and ``meta`` the :func:`parse_ome` dict (or a
    minimal dict for non-OME TIFFs, where every page is treated as z).
    Page order follows the document's ``DimensionOrder``; all six valid
    orders are handled. A ``.companion.ome`` path or a document whose
    ``TiffData`` references sibling files dispatches to the multi-file
    assembly (:func:`read_ome_companion`).
    """
    from microtipi_tpu_torch.io.tiffstack import read_stack

    spath = str(path)
    if spath.lower().endswith(".ome") or spath.lower().endswith(".xml"):
        return read_ome_companion(spath)
    meta = read_ome(path)
    if meta is not None:
        base = os.path.basename(spath)
        foreign = [td for td in meta.get("tiff_data", ())
                   if td["filename"] and td["filename"] != base]
        if foreign:
            return _assemble_multifile(os.path.dirname(spath) or ".", meta,
                                       default_file=base)
    pages = read_stack(path)  # (P, Y, X)
    if meta is None:
        meta = {
            "shape": pages.shape, "dxy": None, "dz": None, "dtype": "float",
            "name": None, "size_c": 1, "size_t": 1,
            "dimension_order": "XYZCT", "channels": [],
        }
        return pages[None, None], meta
    nz = meta["shape"][0] or 1
    nc, nt = meta["size_c"], meta["size_t"]
    if nz * nc * nt != pages.shape[0]:
        raise ValueError(
            f"OME sizes Z={nz} C={nc} T={nt} do not match {pages.shape[0]} pages"
        )
    order = meta["dimension_order"].upper()
    letters = order[2:5]  # fastest-varying page dimension first
    if sorted(letters) != ["C", "T", "Z"]:
        raise ValueError(f"unsupported DimensionOrder {order!r}")
    sizes = {"Z": nz, "C": nc, "T": nt}
    # Pages reshape as (slowest, middle, fastest); transpose to (T, C, Z).
    slowest_first = letters[::-1]
    arr = pages.reshape(tuple(sizes[d] for d in slowest_first) + pages.shape[1:])
    perm = tuple(slowest_first.index(d) for d in "TCZ") + (3, 4)
    return arr.transpose(perm), meta


def write_ome_hyperstack(
    path: str | os.PathLike,
    array: np.ndarray,
    dxy: float | None = None,
    dz: float | None = None,
    name: str | None = None,
    channel_names=None,
    emission_wavelengths=None,
    **kwargs,
) -> None:
    """Write a ``(T, C, Z, Y, X)`` (or 4D ``(C, Z, Y, X)`` / 3D) array as a
    multi-channel/timepoint OME-TIFF, pages in ``XYZCT`` order.

    ``emission_wavelengths``: per-channel emission in meters — stamped so a
    later ``blind``/PSF fit can pick the right model wavelength per channel.
    Same ``compression``/``tile``/``bigtiff`` options as
    :func:`~microtipi_tpu_torch.io.tiffstack.write_stack`.
    """
    from microtipi_tpu_torch.io.tiffstack import write_stack

    arr = np.asarray(array)
    while arr.ndim < 5:
        arr = arr[None]
    if arr.ndim != 5:
        raise ValueError("expected a (T, C, Z, Y, X) array (3D/4D allowed)")
    nt, nc, nz, ny, nx = arr.shape
    desc = ome_xml(
        (nz, ny, nx), dxy=dxy, dz=dz,
        name=name or os.path.basename(str(path)),
        size_c=nc, size_t=nt,
        channel_names=channel_names, emission_wavelengths=emission_wavelengths,
    )
    # C-order flatten of [t, c, z] = z fastest, then c, then t == XYZCT.
    write_stack(path, arr.reshape(nt * nc * nz, ny, nx), dxy=dxy, dz=dz,
                description=desc, **kwargs)


def write_ome_companion(
    path: str | os.PathLike,
    array: np.ndarray,
    dxy: float | None = None,
    dz: float | None = None,
    name: str | None = None,
    channel_names=None,
    emission_wavelengths=None,
    **kwargs,
) -> list[str]:
    """Write a ``(T, C, Z, Y, X)`` array as a multi-file OME set.

    ``path`` must end in ``.companion.ome``; one plain TIFF z-stack is
    written per (timepoint, channel) next to it (``<base>_t{T}_c{C}.ome.tif``,
    the index dropped when that axis is singleton) and the companion
    document maps every plane via ``TiffData``/``UUID FileName`` — the
    Bio-Formats convention for acquisitions too large or too parallel for
    one file. Returns the written TIFF filenames.
    """
    from microtipi_tpu_torch.io.tiffstack import write_stack

    spath = str(path)
    if not spath.lower().endswith(".companion.ome"):
        raise ValueError("companion path must end in .companion.ome")
    arr = np.asarray(array)
    while arr.ndim < 5:
        arr = arr[None]
    if arr.ndim != 5:
        raise ValueError("expected a (T, C, Z, Y, X) array (3D/4D allowed)")
    nt, nc, nz, ny, nx = arr.shape
    base = os.path.basename(spath)[: -len(".companion.ome")]
    dirname = os.path.dirname(spath) or "."
    tiff_data, files = [], []
    for t in range(nt):
        for c in range(nc):
            fname = base
            if nt > 1:
                fname += f"_t{t}"
            if nc > 1:
                fname += f"_c{c}"
            fname += ".ome.tif"
            write_stack(os.path.join(dirname, fname), arr[t, c],
                        dxy=dxy, dz=dz, **kwargs)
            tiff_data.append({
                "ifd": 0, "plane_count": nz,
                "first_z": 0, "first_c": c, "first_t": t,
                "filename": fname,
            })
            files.append(fname)
    xml = ome_xml(
        (nz, ny, nx), dxy=dxy, dz=dz, name=name or base,
        size_c=nc, size_t=nt, channel_names=channel_names,
        emission_wavelengths=emission_wavelengths, tiff_data=tiff_data,
    )
    with open(spath, "w", encoding="utf-8") as fh:
        fh.write(xml)
    return files


def write_ome_stack(
    path: str | os.PathLike,
    volume: np.ndarray,
    dxy: float | None = None,
    dz: float | None = None,
    name: str | None = None,
    **kwargs,
) -> None:
    """Write a volume as OME-TIFF: TIFF pages + OME-XML first-page description.

    Thin convenience over :func:`~microtipi_tpu_torch.io.tiffstack.write_stack`
    (same ``compression``/``tile``/``bigtiff`` options) that stamps the
    OME-XML document *and* the baseline resolution tags, so both OME-aware
    and plain-TIFF readers recover the geometry.
    """
    from microtipi_tpu_torch.io.tiffstack import write_stack

    vol = np.asarray(volume)
    if vol.ndim != 3:
        raise ValueError("expected a 3D (Nz, Ny, Nx) volume")
    desc = ome_xml(vol.shape, dxy=dxy, dz=dz, name=name or os.path.basename(str(path)))
    write_stack(path, vol, dxy=dxy, dz=dz, description=desc, **kwargs)
