"""File parity of the port's auxiliary commands with the JAX CLI's:
``simulate``, ``register``, ``deskew`` and ``fsc``.

As in ``tests/test_torch_cli.py``: the JAX ``main(argv)`` runs in process
once per argv in a module fixture (``MICROTIPI_CACHE_DIR`` unset), the port's
``main(argv, device="cpu")`` on the same seeded 16x32x32 input files, both in
float32. Tolerances:

- ``simulate``: the ground truth bit for bit (the same NumPy phantom), the
  blurring PSF to float32 round-off (1e-6 of its peak). The acquisition
  draws its Poisson and readout noise from the same seeded NumPy generator
  on clean volumes that agree to round-off, so a voxel whose expected count
  differs by round-off may draw one photon more or less: every voxel agrees
  to 1e-6 of the largest value or by one photon (1/gain ADU) exactly, and
  at most 1 voxel in 1000 differs;
- ``deskew``: float32 round-off, 1e-6 of the largest value, and equal
  output geometry;
- ``register``: the printed shift to 1e-4 voxel and the aligned volume to
  1e-5 of its largest value;
- ``fsc``: the curve to 1e-5 and the resolution to 1e-5 relative.
"""

import contextlib
import io
import json
import re

import numpy as np
import pytest
import torch

from microtipi_tpu_torch import cli as tcli
from microtipi_tpu_torch.io.tiffstack import read_stack, write_stack
from microtipi_tpu_torch.io.zarrstack import read_ngff_hyperstack

SHAPE = (16, 32, 32)
OPTICS = ["--na", "1.4", "--wavelength", "561e-9", "--ni", "1.518", "--n-phase", "3"]


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want)) / np.max(np.abs(want)))


def _scene(d):
    """A seeded smooth scene, a copy shifted by a subvoxel translation plus
    noise, both as TIFF with their pixel sizes."""
    from microtipi_tpu_torch.ops.register import fourier_shift

    rng = np.random.default_rng(0)
    obj = rng.random(SHAPE) * (rng.random(SHAPE) < 0.1) * 100
    kern = np.exp(-0.5 * (np.fft.fftfreq(16)[:, None, None] ** 2 / 0.02 + np.fft.fftfreq(32)[None, :, None] ** 2 / 0.01
                          + np.fft.fftfreq(32)[None, None, :] ** 2 / 0.01))
    vol = np.fft.ifftn(np.fft.fftn(obj) * kern).real + 5
    moved = fourier_shift(torch.tensor(vol), (0.6, -1.3, 2.2)).numpy()
    files = {"a": str(d / "a.tif"), "b": str(d / "b.tif")}
    write_stack(files["a"], (vol + 0.1 * rng.standard_normal(SHAPE)).astype(np.float32), dxy=80e-9, dz=200e-9)
    write_stack(files["b"], (moved + 0.1 * rng.standard_normal(SHAPE)).astype(np.float32), dxy=80e-9, dz=200e-9)
    return files


def _argvs(files, out):
    return {
        "simulate": ["simulate", f"{out}/sim.tif", "--shape", *map(str, SHAPE), "--phantom", "shells", "--n", "3",
                     "--seed", "4", "--phase", "0.2", "-0.1", "0.05", *OPTICS, "--truth", f"{out}/truth.tif",
                     "--psf-out", f"{out}/simpsf.tif"],
        "simulate-zarr": ["simulate", f"{out}/sim.zarr", "--shape", *map(str, SHAPE), "--phantom", "filaments",
                          "--n", "2", "--seed", "1", *OPTICS],
        "deskew": ["deskew", files["a"], "--out", f"{out}/deskew.tif", "--angle", "31.8"],
        "register": ["register", files["a"], files["b"], "--out", f"{out}/reg.tif"],
        "fsc": ["fsc", files["a"], files["b"], "--report", f"{out}/fsc.json"],
        "fsc-split": ["fsc", files["a"], "--split", "--report", f"{out}/fsc_split.json"],
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The input files, and the JAX CLI's outputs and printed lines of
    every argv."""
    from microtipi_tpu.cli import main as jax_main

    d = tmp_path_factory.mktemp("cli_tools")
    files = _scene(d)
    (d / "jax").mkdir()
    printed = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("MICROTIPI_CACHE_DIR", raising=False)
        for name, argv in _argvs(files, d / "jax").items():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                jax_main(argv)
            printed[name] = buf.getvalue().splitlines()
    return files, d, printed


def _port(runs, name, tmp_path):
    files, _, _ = runs
    tcli.main(_argvs(files, tmp_path)[name], device="cpu")
    return tmp_path


def _same_draws(got, want, gain=2.0):
    """Equal to float32 round-off but for rare one-photon Poisson flips."""
    diff = np.abs(got.astype(np.float64) - want)
    flips = diff > 1e-6 * np.max(np.abs(want))
    assert np.all(np.abs(diff[flips] - 1.0 / gain) <= 1e-3), diff[flips]
    assert flips.sum() <= 1e-3 * got.size, int(flips.sum())


def test_simulate_matches_jax(runs, tmp_path):
    out = _port(runs, "simulate", tmp_path)
    jax = runs[1] / "jax"
    np.testing.assert_array_equal(read_stack(out / "truth.tif"), read_stack(jax / "truth.tif"))
    assert _rel(read_stack(out / "simpsf.tif"), read_stack(jax / "simpsf.tif")) <= 1e-6
    got, want = read_stack(out / "sim.tif"), read_stack(jax / "sim.tif")
    assert got.shape == SHAPE
    _same_draws(got, want)


def test_simulate_to_ngff_matches_jax(runs, tmp_path):
    out = _port(runs, "simulate-zarr", tmp_path)
    (got, meta), (want, wmeta) = (read_ngff_hyperstack(str(p / "sim.zarr")) for p in (out, runs[1] / "jax"))
    assert got.shape == want.shape == (1, 1, *SHAPE)
    _same_draws(got, want)
    assert (meta["dxy"], meta["dz"]) == (wmeta["dxy"], wmeta["dz"])


def test_deskew_matches_jax(runs, tmp_path):
    out = _port(runs, "deskew", tmp_path)
    got, want = read_stack(out / "deskew.tif"), read_stack(runs[1] / "jax" / "deskew.tif")
    assert got.shape == want.shape and got.shape != SHAPE
    assert _rel(got, want) <= 1e-6


def _shift(lines):
    line = next(l for l in lines if l.startswith("shift:"))
    return np.array([float(v) for v in re.findall(r"-?\d+\.?\d*(?:e-?\d+)?", line.split(":", 1)[1])])


def test_register_matches_jax(runs, tmp_path, capsys):
    out = _port(runs, "register", tmp_path)
    got_shift = _shift(capsys.readouterr().out.splitlines())
    want_shift = _shift(runs[2]["register"])
    assert np.max(np.abs(got_shift - want_shift)) <= 1e-4 and np.max(np.abs(got_shift + (0.6, -1.3, 2.2))) < 0.25
    got, want = read_stack(out / "reg.tif"), read_stack(runs[1] / "jax" / "reg.tif")
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("name", ["fsc", "fsc-split"])
def test_fsc_matches_jax(runs, tmp_path, name):
    out = _port(runs, name, tmp_path)
    report = name.replace("-", "_") + ".json"
    with open(out / report) as fh:
        got = json.load(fh)
    with open(runs[1] / "jax" / report) as fh:
        want = json.load(fh)
    assert got["sampling_limited"] == want["sampling_limited"] and got["threshold"] == want["threshold"]
    np.testing.assert_allclose(got["freqs_per_m"], want["freqs_per_m"], rtol=1e-12)
    np.testing.assert_allclose(got["fsc"], want["fsc"], atol=1e-5)
    assert abs(got["resolution_m"] - want["resolution_m"]) <= 1e-5 * want["resolution_m"]
