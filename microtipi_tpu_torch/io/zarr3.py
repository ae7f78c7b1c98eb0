"""Zarr v3 array store: metadata, codec pipelines, and sharding.

Zarr format 3 (the spec the ecosystem is converging on: zarr-python 3,
OME-NGFF 0.5, tensorstore) replaces v2's ``.zarray`` with a ``zarr.json``
node document and a declarative codec pipeline. This module owns the v3
format; ``io.zarrstack`` dispatches between v2 and v3 and keeps the public
reading/writing surface.

Supported surface (clear errors beyond it):

- array + group ``zarr.json`` documents, ``default`` and ``v2`` chunk key
  encodings, fill values incl. the JSON spellings (``"NaN"``, ``"Infinity"``,
  complex ``[re, im]``), ``dimension_names``;
- codecs: ``bytes`` (both endians), ``transpose``, ``gzip``, ``zstd``,
  ``blosc`` (via ``io.codecs`` — system libblosc or the pure-Python
  fallback), ``crc32c`` (verified on read), and ``sharding_indexed`` with
  nested codec chains and start/end index location;
- writing emits ``bytes``+compressor chains, optionally sharded.

The reference has no IO layer (data arrives as TiPi arrays from the host
GUI, microscopy/PSF_Estimation.java:316-330); ingestion is rebuild-owned
surface. Layout convention matches the package: volumes are (Nz, Ny, Nx).

A copy of ``microtipi_tpu/io/zarr3.py`` (that package imports jax on
import); ``tests/test_torch_io.py`` holds the two against each other:
the same arrays make byte-equal files, and each reads the other's.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import struct
import zlib

import numpy as np

from . import codecs

__all__ = [
    "is_zarr3_array",
    "is_zarr3_group",
    "read_array",
    "write_array",
    "array_meta",
    "group_attributes",
    "write_group",
]


# ---------------------------------------------------------------------------
# crc32c (Castagnoli) — needed by the default shard index codec chain
# ---------------------------------------------------------------------------


def _crc32c_table():
    poly = 0x82F63B78
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C_TABLE = _crc32c_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _CRC32C_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# ---------------------------------------------------------------------------
# metadata
# ---------------------------------------------------------------------------

_DTYPES = {
    "bool": "?", "int8": "i1", "int16": "<i2", "int32": "<i4", "int64": "<i8",
    "uint8": "u1", "uint16": "<u2", "uint32": "<u4", "uint64": "<u8",
    "float16": "<f2", "float32": "<f4", "float64": "<f8",
    "complex64": "<c8", "complex128": "<c16",
}


def _np_dtype(name: str) -> np.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported zarr v3 data_type {name!r}")
    return np.dtype(_DTYPES[name])


def _v3_dtype_name(dt: np.dtype) -> str:
    dt = np.dtype(dt)
    for name, code in _DTYPES.items():
        c = np.dtype(code)
        # v3 data types carry no endianness (the bytes codec does)
        if c.kind == dt.kind and c.itemsize == dt.itemsize:
            return name
    raise ValueError(f"dtype {dt} has no zarr v3 name")


def _parse_fill(fv, dtype: np.dtype):
    if fv is None:
        return np.zeros((), dtype)[()]
    if isinstance(fv, str):
        spec = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if fv in spec:
            return np.array(spec[fv], dtype)[()]
        if fv.startswith("0x"):  # raw bit pattern spelling
            return np.frombuffer(
                int(fv, 16).to_bytes(dtype.itemsize, "little"), dtype
            )[0]
        raise ValueError(f"unsupported fill_value {fv!r}")
    if isinstance(fv, (list, tuple)) and dtype.kind == "c":
        re_, im_ = (_parse_fill(v, np.dtype(dtype.char.lower())) for v in fv)
        return np.array(complex(re_, im_), dtype)[()]
    return np.array(fv, dtype)[()]


def _json_fill(value, dtype: np.dtype):
    if dtype.kind == "b":
        return bool(value)
    if dtype.kind in "iu":
        return int(value)
    if dtype.kind == "c":
        return [_json_fill(value.real, np.dtype("f8")),
                _json_fill(value.imag, np.dtype("f8"))]
    v = float(value)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "Infinity" if v > 0 else "-Infinity"
    return v


def is_zarr3_array(path: str) -> bool:
    meta = _node_meta(path)
    return meta is not None and meta.get("node_type") == "array"


def is_zarr3_group(path: str) -> bool:
    meta = _node_meta(path)
    return meta is not None and meta.get("node_type") == "group"


def _node_meta(path: str):
    p = os.path.join(str(path), "zarr.json")
    if not os.path.exists(p):
        return None
    with open(p, "r") as fh:
        return json.load(fh)


def group_attributes(path: str) -> dict:
    meta = _node_meta(path) or {}
    return meta.get("attributes", {}) or {}


def array_meta(adir: str) -> dict:
    """Normalized metadata: shape, dtype, chunks (outer grid), fill."""
    meta = _node_meta(adir)
    if meta is None or meta.get("node_type") != "array":
        raise ValueError(f"{adir} is not a zarr v3 array")
    if int(meta.get("zarr_format", 0)) != 3:
        raise ValueError(f"unsupported zarr_format {meta.get('zarr_format')!r}")
    grid = meta["chunk_grid"]
    if grid.get("name") != "regular":
        raise ValueError(f"unsupported chunk_grid {grid.get('name')!r}")
    dtype = _np_dtype(meta["data_type"])
    return {
        "shape": tuple(meta["shape"]),
        "dtype": dtype,
        "chunks": tuple(grid["configuration"]["chunk_shape"]),
        "fill": _parse_fill(meta.get("fill_value"), dtype),
        "codecs": meta.get("codecs", []),
        "key_encoding": meta.get("chunk_key_encoding",
                                 {"name": "default"}),
        "dimension_names": meta.get("dimension_names"),
        "attributes": meta.get("attributes", {}) or {},
    }


def _chunk_key(idx, enc) -> str:
    name = enc.get("name", "default")
    sep = (enc.get("configuration") or {}).get("separator")
    if name == "default":
        sep = sep or "/"
        return sep.join(["c", *[str(i) for i in idx]]) if idx else "c"
    if name == "v2":
        sep = sep or "."
        return sep.join(str(i) for i in idx) if idx else "0"
    raise ValueError(f"unsupported chunk_key_encoding {name!r}")


# ---------------------------------------------------------------------------
# codec pipeline
# ---------------------------------------------------------------------------


def _split_chain(codec_list):
    """(array->array list, array->bytes codec, bytes->bytes list)."""
    aa, ab, bb = [], None, []
    for c in codec_list:
        name = c.get("name")
        if name == "transpose":
            aa.append(c)
        elif name in ("bytes", "endian", "sharding_indexed"):
            if ab is not None:
                raise ValueError("multiple array->bytes codecs in chain")
            ab = c
        elif name in ("gzip", "zstd", "blosc", "crc32c", "zlib"):
            bb.append(c)
        else:
            raise ValueError(f"unsupported zarr v3 codec {name!r}")
    if ab is None:
        ab = {"name": "bytes", "configuration": {"endian": "little"}}
    return aa, ab, bb


def _bb_encode(buf: bytes, c) -> bytes:
    name, cfg = c["name"], c.get("configuration") or {}
    if name == "gzip":
        co = zlib.compressobj(int(cfg.get("level", 5)), zlib.DEFLATED, 31)
        return co.compress(buf) + co.flush()
    if name == "zlib":
        return zlib.compress(buf, int(cfg.get("level", 5)))
    if name == "zstd":
        return codecs.zstd_compress(buf, int(cfg.get("level", 0)))
    if name == "blosc":
        shuffle = {"noshuffle": 0, "shuffle": 1, "bitshuffle": 2}[
            cfg.get("shuffle", "shuffle")]
        return codecs.blosc_compress(
            buf, typesize=int(cfg.get("typesize", 1)),
            cname=cfg.get("cname", "zstd"), clevel=int(cfg.get("clevel", 5)),
            shuffle=shuffle, blocksize=int(cfg.get("blocksize", 0)))
    if name == "crc32c":
        return buf + struct.pack("<I", crc32c(buf))
    raise ValueError(f"unsupported bytes codec {name!r}")


def _bb_decode(buf: bytes, c) -> bytes:
    name, cfg = c["name"], c.get("configuration") or {}
    if name == "gzip":
        return zlib.decompress(buf, wbits=31)
    if name == "zlib":
        return zlib.decompress(buf)
    if name == "zstd":
        return codecs.zstd_decompress(buf)
    if name == "blosc":
        return codecs.blosc_decompress(buf)
    if name == "crc32c":
        body, (stored,) = buf[:-4], struct.unpack("<I", buf[-4:])
        if crc32c(body) != stored:
            raise ValueError("crc32c checksum mismatch in zarr v3 chunk")
        return body
    raise ValueError(f"unsupported bytes codec {name!r}")


def _encode_chunk(block: np.ndarray, codec_list, dtype) -> bytes:
    aa, ab, bb = _split_chain(codec_list)
    for c in aa:
        order = (c.get("configuration") or {}).get("order")
        block = np.transpose(block, order)
    if ab["name"] == "sharding_indexed":
        buf = _encode_shard(block, ab.get("configuration") or {}, dtype)
    else:
        endian = (ab.get("configuration") or {}).get("endian", "little")
        dt = dtype.newbyteorder("<" if endian == "little" else ">")
        buf = np.ascontiguousarray(block).astype(dt, copy=False).tobytes()
    for c in bb:
        buf = _bb_encode(buf, c)
    return buf


def _decode_chunk(buf: bytes, codec_list, chunk_shape, dtype,
                  fill) -> np.ndarray:
    aa, ab, bb = _split_chain(codec_list)
    stored_shape = tuple(chunk_shape)
    for c in aa:
        order = (c.get("configuration") or {}).get("order")
        stored_shape = tuple(stored_shape[i] for i in order)
    for c in reversed(bb):
        buf = _bb_decode(buf, c)
    if ab["name"] == "sharding_indexed":
        block = _decode_shard(buf, ab.get("configuration") or {},
                              stored_shape, dtype, fill)
    else:
        endian = (ab.get("configuration") or {}).get("endian", "little")
        dt = dtype.newbyteorder("<" if endian == "little" else ">")
        block = np.frombuffer(buf, dtype=dt).reshape(stored_shape)
        block = block.astype(dtype, copy=False)
    for c in reversed(aa):
        order = (c.get("configuration") or {}).get("order")
        block = np.transpose(block, np.argsort(order))
    return block


# ---------------------------------------------------------------------------
# sharding_indexed
# ---------------------------------------------------------------------------

_MISSING = (1 << 64) - 1
_DEFAULT_INDEX_CODECS = [
    {"name": "bytes", "configuration": {"endian": "little"}},
    {"name": "crc32c"},
]


def _shard_grid(shard_shape, inner_shape):
    cps = []
    for s, i in zip(shard_shape, inner_shape):
        if s % i:
            raise ValueError(
                f"shard shape {tuple(shard_shape)} not divisible by inner "
                f"chunk shape {tuple(inner_shape)}")
        cps.append(s // i)
    return tuple(cps)


def _decode_shard(buf: bytes, cfg, shard_shape, dtype, fill) -> np.ndarray:
    inner = tuple(cfg["chunk_shape"])
    cps = _shard_grid(shard_shape, inner)
    n = int(np.prod(cps))
    index_codecs = cfg.get("index_codecs", _DEFAULT_INDEX_CODECS)
    for c in index_codecs:
        if c.get("name") not in ("bytes", "endian", "crc32c"):
            raise ValueError(
                f"compressed shard index codec {c.get('name')!r} is not "
                "supported (bytes/crc32c only)")
    # Encoded index size: decoded is n*16 bytes; run the codec chain on a
    # dummy to learn the encoded length (bytes/crc32c chains are
    # size-deterministic).
    probe = _encode_chunk(
        np.zeros(cps + (2,), dtype="<u8"), index_codecs, np.dtype("<u8"))
    isize = len(probe)
    loc = cfg.get("index_location", "end")
    raw_index = buf[-isize:] if loc == "end" else buf[:isize]
    index = _decode_chunk(raw_index, index_codecs, cps + (2,),
                          np.dtype("<u8"), 0)
    out = np.full(shard_shape, fill, dtype=dtype)
    inner_codecs = cfg.get("codecs",
                           [{"name": "bytes",
                             "configuration": {"endian": "little"}}])
    for idx in itertools.product(*[range(c) for c in cps]):
        off, nb = int(index[idx][0]), int(index[idx][1])
        if off == _MISSING and nb == _MISSING:
            continue
        block = _decode_chunk(buf[off:off + nb], inner_codecs, inner,
                              dtype, fill)
        sl = tuple(slice(i * c, (i + 1) * c) for i, c in zip(idx, inner))
        out[sl] = block
    return out


def _encode_shard(block: np.ndarray, cfg, dtype) -> bytes:
    inner = tuple(cfg["chunk_shape"])
    cps = _shard_grid(block.shape, inner)
    index_codecs = cfg.get("index_codecs", _DEFAULT_INDEX_CODECS)
    inner_codecs = cfg.get("codecs",
                           [{"name": "bytes",
                             "configuration": {"endian": "little"}}])
    loc = cfg.get("index_location", "end")
    index = np.full(cps + (2,), _MISSING, dtype="<u8")
    payload = bytearray()
    if loc == "start":
        probe = _encode_chunk(index, index_codecs, np.dtype("<u8"))
        base = len(probe)
    else:
        base = 0
    for idx in itertools.product(*[range(c) for c in cps]):
        sl = tuple(slice(i * c, (i + 1) * c) for i, c in zip(idx, inner))
        enc = _encode_chunk(np.ascontiguousarray(block[sl]), inner_codecs,
                            dtype)
        index[idx] = (base + len(payload), len(enc))
        payload += enc
    raw_index = _encode_chunk(index, index_codecs, np.dtype("<u8"))
    if loc == "start":
        return raw_index + bytes(payload)
    return bytes(payload) + raw_index


# ---------------------------------------------------------------------------
# whole-array read/write
# ---------------------------------------------------------------------------


def read_array(adir: str) -> np.ndarray:
    meta = array_meta(adir)
    shape, chunks, dtype = meta["shape"], meta["chunks"], meta["dtype"]
    out = np.full(shape, meta["fill"], dtype=dtype)
    grid = [range((s + c - 1) // c) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = _chunk_key(idx, meta["key_encoding"])
        cpath = os.path.join(adir, *key.split("/"))
        if not os.path.exists(cpath):
            continue
        with open(cpath, "rb") as fh:
            block = _decode_chunk(fh.read(), meta["codecs"], chunks, dtype,
                                  meta["fill"])
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    return out


def _default_codecs(compressor, dtype, shard_inner=None):
    chain = [{"name": "bytes", "configuration": {"endian": "little"}}]
    if compressor == "gzip":
        chain.append({"name": "gzip", "configuration": {"level": 5}})
    elif compressor == "zstd":
        chain.append({"name": "zstd",
                      "configuration": {"level": 3, "checksum": False}})
    elif compressor in ("blosc", "zlib"):
        chain.append({"name": "blosc", "configuration": {
            "cname": "lz4" if compressor == "blosc" else "zlib",
            "clevel": 5, "shuffle": "shuffle",
            "typesize": np.dtype(dtype).itemsize, "blocksize": 0}})
    elif compressor in (None, "null"):
        pass
    else:
        raise ValueError(f"unsupported v3 compressor {compressor!r}")
    if shard_inner is not None:
        return [{"name": "sharding_indexed", "configuration": {
            "chunk_shape": list(shard_inner), "codecs": chain,
            "index_codecs": _DEFAULT_INDEX_CODECS, "index_location": "end"}}]
    return chain


def write_array(adir: str, arr: np.ndarray, chunks=None, compressor="zstd",
                shard=None, dimension_names=None, attributes=None):
    """Write a zarr v3 array directory.

    ``shard``: inner chunk shape — when given, ``chunks`` becomes the shard
    (outer chunk) shape and each stored object is a ``sharding_indexed``
    container of inner chunks.
    """
    arr = np.asarray(arr)
    os.makedirs(adir, exist_ok=True)
    if chunks is None:
        chunks = ((1,) * max(0, arr.ndim - 2) + arr.shape[-2:]
                  if arr.ndim >= 2 else arr.shape)
    chunks = tuple(min(c, s) for c, s in zip(chunks, arr.shape))
    if shard is not None:
        shard_inner = tuple(min(i, c) for i, c in zip(shard, chunks))
        # outer chunk must tile exactly by the inner chunk
        chunks = tuple(c - c % i if c % i else c
                       for c, i in zip(chunks, shard_inner))
    else:
        shard_inner = None
    codec_list = _default_codecs(compressor, arr.dtype, shard_inner)
    meta = {
        "zarr_format": 3,
        "node_type": "array",
        "shape": list(arr.shape),
        "data_type": _v3_dtype_name(arr.dtype),
        "chunk_grid": {"name": "regular",
                       "configuration": {"chunk_shape": list(chunks)}},
        "chunk_key_encoding": {"name": "default",
                               "configuration": {"separator": "/"}},
        "fill_value": _json_fill(np.zeros((), arr.dtype)[()], arr.dtype),
        "codecs": codec_list,
        "attributes": attributes or {},
    }
    if dimension_names is not None:
        meta["dimension_names"] = list(dimension_names)
    with open(os.path.join(adir, "zarr.json"), "w") as fh:
        json.dump(meta, fh, indent=1)
    grid = [range((s + c - 1) // c) for s, c in zip(arr.shape, chunks)]
    enc = meta["chunk_key_encoding"]
    for idx in itertools.product(*grid):
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, arr.shape))
        block = arr[sl]
        if block.shape != chunks:  # edge chunks stored full-size
            pad = np.zeros(chunks, dtype=arr.dtype)
            pad[tuple(slice(0, b) for b in block.shape)] = block
            block = pad
        key = _chunk_key(idx, enc)
        cpath = os.path.join(adir, *key.split("/"))
        os.makedirs(os.path.dirname(cpath), exist_ok=True)
        with open(cpath, "wb") as fh:
            fh.write(_encode_chunk(np.ascontiguousarray(block), codec_list,
                                   arr.dtype))


def write_group(path: str, attributes=None):
    os.makedirs(path, exist_ok=True)
    meta = {"zarr_format": 3, "node_type": "group",
            "attributes": attributes or {}}
    with open(os.path.join(path, "zarr.json"), "w") as fh:
        json.dump(meta, fh, indent=1)
