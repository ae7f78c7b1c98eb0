"""The port's IO (``microtipi_tpu_torch/io``) against the JAX package's
(``microtipi_tpu/io``): both packages write the same arrays with the same
options, the files must be byte-equal, and each package reads the other's
files to equal arrays and metadata. TIFF (float32, deflate, LZW, tiled,
BigTIFF, ImageJ and OME pixel sizes, partial reads, a big-endian uint16
fixture), OME hyperstacks and companions, NGFF v2 (zlib) and v3 (zstd,
sharding), the codecs' bytes, plates, HDF5 and BigDataViewer pyramids (their
object headers carry write times, so those are compared by content), and
``StackPrefetcher``. The port's TIFF library is built from
``native/stackio.cpp`` into ``microtipi_tpu_torch/_build``."""

import os

import numpy as np
import pytest

from fixtures import builders
from microtipi_tpu.io import codecs as jax_codecs
from microtipi_tpu.io import ome as jax_ome
from microtipi_tpu.io import plate as jax_plate
from microtipi_tpu.io import tiffstack as jax_tiff
from microtipi_tpu.io import zarrstack as jax_zarr
from microtipi_tpu_torch import _build
from microtipi_tpu_torch import io as port_io
from microtipi_tpu_torch.io import codecs, ome, plate, tiffstack, zarrstack

TIFF_OPTIONS = {
    "strips": {}, "deflate": dict(compression="deflate"), "lzw": dict(compression="lzw"), "tiled": dict(tile=16),
    "tiled_deflate": dict(tile=16, compression="deflate"), "bigtiff": dict(bigtiff=True, compression="lzw"),
    "imagej_pixel_size": dict(dxy=80e-9, dz=2e-7),
}
NGFF_OPTIONS = {
    "v2_zlib": dict(zarr_format=2, compressor="zlib"),
    "v2_zlib_pyramid": dict(zarr_format=2, compressor="zlib", levels=2),
    "v3_zstd_sharded": dict(zarr_format=3, compressor="zstd", chunks=(1, 1, 2, 8, 8), shard=(1, 1, 1, 4, 4)),
}
CHANNELS = [{"name": "gfp", "emission_wavelength": 510e-9}, {"name": "mcherry", "emission_wavelength": 610e-9}]


def _vol(shape=(5, 24, 40), seed=0):
    return (np.random.default_rng(seed).random(shape) * 100).astype(np.float32)


def _files(root) -> dict:
    """Every file under ``root`` (or ``root`` itself) by relative name, as bytes."""
    root = str(root)
    if os.path.isfile(root):
        return {"": open(root, "rb").read()}
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _written(tmp_path, name, write_jax, write_port):
    """Write with each package into its own directory under the same file
    name (OME and NGFF stamp it); assert byte-equal; return both paths."""
    pj, pp = tmp_path / "jax" / name, tmp_path / "port" / name
    pj.parent.mkdir()
    pp.parent.mkdir()
    write_jax(pj)
    write_port(pp)
    fj, fp = _files(pj), _files(pp)
    assert sorted(fj) == sorted(fp)
    for k in fj:
        assert fj[k] == fp[k], f"{name}/{k} differs"
    return pj, pp


def test_same_public_names_as_jax():
    import microtipi_tpu.io as jax_io

    assert port_io.__all__ == jax_io.__all__
    assert tiffstack.__all__ == jax_tiff.__all__


@pytest.mark.parametrize("opts", list(TIFF_OPTIONS.values()), ids=list(TIFF_OPTIONS))
def test_tiff_is_byte_equal_and_reads_across(tmp_path, opts):
    vol = _vol()
    pj, pp = _written(tmp_path, "s.tif", lambda p: jax_tiff.write_stack(p, vol, **opts),
                      lambda p: tiffstack.write_stack(p, vol, **opts))
    for reader in (tiffstack, jax_tiff):
        for p in (pj, pp):
            assert reader.stack_info(p) == vol.shape
            np.testing.assert_array_equal(reader.read_stack(p), vol)
    assert tiffstack.read_pixel_size(pj) == jax_tiff.read_pixel_size(pp) == jax_tiff.read_pixel_size(pj)
    if "dxy" in opts:
        assert tiffstack.read_pixel_size(pj) == pytest.approx((80e-9, 2e-7), rel=1e-9)


def test_partial_read_matches_jax(tmp_path):
    vol = _vol((10, 16, 16), 1)
    p = tmp_path / "s.tif"
    tiffstack.write_stack(p, vol)
    got = tiffstack.read_stack(p, z0=3, nz=4)
    np.testing.assert_array_equal(got, jax_tiff.read_stack(p, z0=3, nz=4))
    np.testing.assert_array_equal(got, vol[3:7])


def test_big_endian_uint16_reads_like_jax(tmp_path):
    """A camera stack from a big-endian writer, hand-assembled from the spec."""
    pages = np.random.default_rng(1).integers(0, 60000, (3, 4, 6)).astype(np.uint16)
    expected = builders.build_tiff_classic(tmp_path / "be.tif", pages, endian=">")
    got = tiffstack.read_stack(tmp_path / "be.tif")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, expected)
    np.testing.assert_array_equal(got, jax_tiff.read_stack(tmp_path / "be.tif"))


def test_ome_stack_is_byte_equal_and_metadata_reads_across(tmp_path):
    vol = _vol()
    pj, pp = _written(tmp_path, "s.ome.tif", lambda p: jax_ome.write_ome_stack(p, vol, dxy=80e-9, dz=2e-7),
                      lambda p: ome.write_ome_stack(p, vol, dxy=80e-9, dz=2e-7))
    meta = ome.read_ome(pj)
    assert meta == jax_ome.read_ome(pp) == jax_ome.read_ome(pj)
    assert (meta["dxy"], meta["dz"]) == pytest.approx((80e-9, 2e-7), rel=1e-12)
    assert tiffstack.read_pixel_size(pj) == jax_tiff.read_pixel_size(pp)
    np.testing.assert_array_equal(tiffstack.read_stack(pj), vol)


@pytest.mark.parametrize("kind", ["hyperstack", "companion"])
def test_ome_hyperstack_and_companion_are_byte_equal_and_read_across(tmp_path, kind):
    arr = _vol((2, 2, 3, 8, 8), 2)
    name = "h.ome.tif" if kind == "hyperstack" else "set.companion.ome"
    kw = dict(dxy=65e-9, dz=2e-7, channel_names=["a", "b"], emission_wavelengths=[510e-9, 610e-9])
    writer = f"write_ome_{kind}"
    writers = (lambda p: getattr(jax_ome, writer)(p, arr, **kw), lambda p: getattr(ome, writer)(p, arr, **kw))
    # a companion set is several files in one directory: compare the directories
    pj, pp = tmp_path / "jax" / name, tmp_path / "port" / name
    for p, write in zip((pj, pp), writers):
        p.parent.mkdir()
        write(p)
    fj, fp = _files(pj.parent), _files(pp.parent)
    assert sorted(fj) == sorted(fp) and all(fj[k] == fp[k] for k in fj)
    out_p, meta_p = ome.read_ome_hyperstack(pj)
    out_j, meta_j = jax_ome.read_ome_hyperstack(pp)
    np.testing.assert_array_equal(out_p, arr)
    np.testing.assert_array_equal(out_j, arr)
    assert meta_p == meta_j


@pytest.mark.parametrize("opts", list(NGFF_OPTIONS.values()), ids=list(NGFF_OPTIONS))
def test_ngff_is_byte_equal_and_reads_across(tmp_path, opts):
    arr = _vol((1, 2, 4, 16, 16), 3)
    kw = dict(dxy=80e-9, dz=2e-7, channels=CHANNELS, **opts)
    pj, pp = _written(tmp_path, "s.zarr", lambda p: jax_zarr.write_ngff_hyperstack(str(p), arr, **kw),
                      lambda p: zarrstack.write_ngff_hyperstack(str(p), arr, **kw))
    out_p, meta_p = zarrstack.read_ngff_hyperstack(str(pj))
    out_j, meta_j = jax_zarr.read_ngff_hyperstack(str(pp))
    np.testing.assert_array_equal(out_p, arr)
    np.testing.assert_array_equal(out_j, arr)
    assert meta_p == meta_j
    assert (meta_p["dxy"], meta_p["dz"]) == pytest.approx((80e-9, 2e-7), rel=1e-12)
    assert [c["emission_wavelength"] for c in meta_p["channels"]] == pytest.approx([510e-9, 610e-9])


@pytest.mark.parametrize("codec", ["blosc", "zstd", "lz4"])
def test_codec_bytes_match_jax(codec):
    if not getattr(codecs, f"have_{codec}_lib")():
        pytest.skip(f"lib{codec} not present")
    raw = (np.arange(50_000, dtype=np.uint8) // 7).tobytes() + np.random.default_rng(4).bytes(5_000)
    kw = dict(typesize=4, cname="zstd") if codec == "blosc" else {}
    comp = getattr(codecs, f"{codec}_compress")(raw, **kw)
    assert comp == getattr(jax_codecs, f"{codec}_compress")(raw, **kw)
    assert getattr(codecs, f"{codec}_decompress")(comp) == raw
    assert getattr(jax_codecs, f"{codec}_decompress")(comp) == raw


def test_python_blosc_decoder_matches_libblosc():
    """The pure-Python blosc decoder (the JAX module's documented path
    without libblosc) decodes libblosc's containers bit for bit."""
    if not codecs.have_blosc_lib():
        pytest.skip("libblosc not present")
    rng = np.random.default_rng(5)
    for cname in ("lz4", "zlib"):
        for shuffle in (0, 1):
            raw = (np.arange(20_000, dtype=np.uint8) // 5 + rng.integers(0, 3, 20_000, dtype=np.uint8)).tobytes()
            comp = codecs.blosc_compress(raw, typesize=4, cname=cname, clevel=5, shuffle=shuffle)
            assert codecs._blosc_decompress_py(comp) == raw == jax_codecs._blosc_decompress_py(comp)


@pytest.mark.parametrize("fmt", [2, 3])
def test_plate_is_byte_equal_and_reads_across(tmp_path, fmt):
    rng = np.random.default_rng(6)
    wells = {wp: [rng.normal(size=(2, 8, 9)).astype(np.float32) for _ in range(2)] for wp in ("A/1", "A/2", "B/1")}
    kw = dict(dxy=65e-9, dz=2e-7, zarr_format=fmt, compressor="zlib" if fmt == 2 else "zstd")
    pj, pp = _written(tmp_path, "p.zarr", lambda p: jax_plate.write_plate(p, wells, **kw),
                      lambda p: plate.write_plate(p, wells, **kw))
    assert plate.read_plate_meta(pj) == jax_plate.read_plate_meta(pp)
    assert plate.list_plate_images(pj) == jax_plate.list_plate_images(pp)
    arr_p, meta_p = plate.read_plate_image(pj, "B/1", 1)
    arr_j, meta_j = jax_plate.read_plate_image(pp, "B/1", 1)
    np.testing.assert_array_equal(arr_p, arr_j)
    np.testing.assert_array_equal(arr_p[0, 0], wells["B/1"][1])
    assert meta_p == meta_j
    assert plate.plate_info(pp) == jax_plate.plate_info(pp)


def _h5_content(path):
    """Every dataset (values, dtype, chunks, compression) and attribute."""
    import h5py

    out = {}

    def visit(name, obj):
        attrs = {k: np.asarray(v).tolist() for k, v in obj.attrs.items()}
        if isinstance(obj, h5py.Dataset):
            out[name] = (obj[()].tobytes(), str(obj.dtype), obj.chunks, obj.compression, attrs)
        else:
            out[name] = attrs

    with h5py.File(path, "r") as f:
        f.visititems(visit)
    return out


def test_hdf5_and_bdv_match_jax(tmp_path):
    pytest.importorskip("h5py")
    from microtipi_tpu.io import hdf5stack as jax_h5
    from microtipi_tpu_torch.io import hdf5stack

    vol = _vol((9, 33, 40), 7)
    for name, jax_write, write in (
            ("v.h5", lambda p: jax_h5.write_h5(p, vol, compression="gzip"),
             lambda p: hdf5stack.write_h5(p, vol, compression="gzip")),
            ("bdv.h5", lambda p: jax_h5.write_bdv(p, vol, levels=3), lambda p: hdf5stack.write_bdv(p, vol, levels=3))):
        pj, pp = tmp_path / f"jax_{name}", tmp_path / f"port_{name}"
        jax_write(pj)
        write(pp)
        assert _h5_content(pj) == _h5_content(pp)
    assert hdf5stack.list_datasets(tmp_path / "jax_v.h5") == jax_h5.list_datasets(tmp_path / "port_v.h5")
    np.testing.assert_array_equal(hdf5stack.read_h5(tmp_path / "jax_v.h5", z0=2, nz=3), vol[2:5])
    np.testing.assert_array_equal(jax_h5.read_h5(tmp_path / "port_v.h5"), vol)
    for level in (0, 1, 2):
        np.testing.assert_array_equal(hdf5stack.read_bdv(tmp_path / "jax_bdv.h5", level=level),
                                      jax_h5.read_bdv(tmp_path / "port_bdv.h5", level=level))
    res_p, shapes_p = hdf5stack.bdv_info(tmp_path / "jax_bdv.h5")
    res_j, shapes_j = jax_h5.bdv_info(tmp_path / "port_bdv.h5")
    np.testing.assert_array_equal(res_p, res_j)
    assert [tuple(s) for s in shapes_p] == [tuple(s) for s in shapes_j]


def test_prefetcher_order_and_content(tmp_path):
    vols = [_vol((4, 8, 8), seed=s) for s in range(5)]
    paths = []
    for i, v in enumerate(vols):
        paths.append(tmp_path / f"t{i}.tif")
        jax_tiff.write_stack(paths[-1], v)
    prefetcher = tiffstack.StackPrefetcher(paths, depth=3)
    for _ in range(2):  # reusable
        out = list(prefetcher)
        assert [p for p, _ in out] == [str(p) for p in paths]
        for (_, got), want in zip(out, vols):
            np.testing.assert_array_equal(got, want)


def test_native_library_lies_in_the_port_build_directory(tmp_path):
    """Built at first use into the port's ``_build`` under a name hashed from
    the source and the command; the JAX package's ``io/_native`` is not
    where the port loads from, and no temporary file is left behind."""
    tiffstack.write_stack(tmp_path / "s.tif", _vol((1, 4, 4)))
    lib = tiffstack._lib()
    path = os.path.realpath(lib._name)
    assert os.path.dirname(path) == str(_build.BUILD_DIR)
    name = os.path.basename(path)
    assert name.startswith("libmicrotipi_io-") and len(name) == len("libmicrotipi_io-") + 16 + len(".so")
    src = tiffstack._SRC_PATH
    assert src == _build.BUILD_DIR.parents[1] / "native" / "stackio.cpp"
    assert _build.hashed_name("microtipi_io", src, ("g++", "-O3")) != _build.hashed_name("microtipi_io", src, ("g++",))
    assert not [n for n in os.listdir(_build.BUILD_DIR) if n.startswith("tmp")]
