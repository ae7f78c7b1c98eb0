"""Shared by ``tests/test_torch_cli_deconv_modes.py`` and
``tests/test_torch_cli_other_modes.py``: the tiny seeded inputs (8x32x32
volumes) and the runner that puts one argv through the JAX CLI and the
port's and compares every output file.

Tolerances, in max norm relative to the JAX output's largest value:

- ``FAST`` = 1e-4 for outputs of no line search (ADMM, FISTA, RL, synthesis,
  ISM, SIM, fusion, registration, the calibrations' PSFs) and for VMLMB
  solves of 3 iterations whose float32 trajectories stay together on these
  inputs;
- ``VMLMB_PARTS`` = 1e-3 for the VMLMB solves whose float32 line searches
  part from JAX's within their 3 iterations (measured 1.5e-4 to 6.2e-4: the
  objective's float32 quadratic form carries ~1e-4 relative round-off in
  either package, so the two take different steps).

Plate outputs are compared well by well.
"""

import contextlib
import io
import pathlib

import numpy as np
import torch

from microtipi_tpu_torch import cli as tcli
from microtipi_tpu_torch.io.ome import write_ome_hyperstack
from microtipi_tpu_torch.io.plate import list_plate_images, read_plate_image, write_plate
from microtipi_tpu_torch.io.tiffstack import read_stack, write_stack
from microtipi_tpu_torch.io.zarrstack import read_ngff_hyperstack

S = (8, 32, 32)
O = ["--na", "1.4", "--wavelength", "561e-9", "--ni", "1.518", "--n-phase", "3"]
Q = ["--iters", "3", "--grtol", "0"]
FAST, VMLMB_PARTS = 1e-4, 1e-3


def make_inputs(d) -> dict:
    """The input files, by name, written into ``d``."""
    from microtipi_tpu_torch.models.widefield import WideFieldConfig, WideFieldModel
    from microtipi_tpu_torch.ops.convolution import convolve, convolve_spectrum

    m = WideFieldModel(WideFieldConfig(shape=S, na=1.4, wavelength=561e-9, ni=1.518, dxy=80e-9, dz=200e-9,
                                       n_phase=3, dtype=torch.float64), "cpu")
    with torch.no_grad():
        psf = m.compute_psf(m.init_params()._replace(phase=torch.tensor([0.3, -0.2, 0.1], dtype=torch.float64)))
    rng = np.random.default_rng(0)

    def scene():
        o = rng.random(S) * (rng.random(S) < 0.05) * 300
        with torch.no_grad():
            b = convolve(torch.tensor(o), convolve_spectrum(psf), S).numpy()
        return (b + 0.01 * b.max() * rng.standard_normal(S) + 5).astype(np.float32)

    f = {}

    def tif(name, arr):
        f[name] = str(d / name)
        write_stack(f[name], arr, dxy=80e-9, dz=200e-9)

    tif("d.tif", scene())
    tif("v2.tif", scene())
    tif("psf.tif", psf.numpy().astype(np.float32))
    bead = np.roll(np.fft.fftshift(psf.numpy()), (0, 2, -1), (0, 1, 2))
    tif("bead.tif", (1e4 * bead + 10 + rng.standard_normal(S)).astype(np.float32))
    two = np.full((8, 64, 64), 10, np.float32)
    two[:, :32, :32] += 1e4 * bead
    two[:, 32:, 32:] += 1e4 * np.roll(bead, (0, 1, 1), (0, 1, 2))
    tif("beads2.tif", two)
    tif("sim.tif", (rng.random((9, 32, 32)) * 10 + 100).astype(np.float32))
    tif("sim3.tif", (rng.random((60, 32, 32)) * 10 + 100).astype(np.float32))
    tif("ism.tif", (rng.random((28, 32, 32)) * 10 + 10).astype(np.float32))
    for name, arr, em in (("ts.ome.tif", [[scene()] for _ in range(3)], None),
                          ("ch.ome.tif", [[scene(), scene()]], [520e-9, 600e-9]),
                          ("tc.ome.tif", [[scene(), scene()] for _ in range(2)], [520e-9, 600e-9])):
        f[name] = str(d / name)
        write_ome_hyperstack(f[name], np.stack(arr), dxy=80e-9, dz=200e-9, emission_wavelengths=em)
    f["plate.zarr"] = str(d / "plate.zarr")
    write_plate(f["plate.zarr"], {"A/1": [scene()], "B/2": [scene()]}, dxy=80e-9, dz=200e-9)
    (d / "win").mkdir()
    write_stack(d / "win" / "a.tif", scene())
    f["win"] = str(d / "win")
    return f


def _outputs(o: pathlib.Path) -> dict:
    """Every volume a run wrote, by relative path (plates well by well)."""
    out = {}
    for p in sorted(o.rglob("*.tif")):
        out[str(p.relative_to(o))] = read_stack(str(p))
    for p in sorted(o.rglob("*.zarr")):
        try:
            for well, field in list_plate_images(str(p)):
                out[f"{p.relative_to(o)}:{well}/{field}"] = read_plate_image(str(p), well, field)[0]
        except Exception:
            out[str(p.relative_to(o))] = read_ngff_hyperstack(str(p))[0]
    return out


def _fill(arg: str, paths: dict) -> str:
    for key, value in paths.items():
        arg = arg.replace("{" + key + "}", value)
    return arg


def run_case(argv, tol, inputs, tmp_path, monkeypatch):
    """Run ``argv`` through both CLIs into ``tmp_path``; assert every output
    of the JAX run is the port's, within ``tol`` of its largest value."""
    from microtipi_tpu.cli import main as jax_main

    monkeypatch.delenv("MICROTIPI_CACHE_DIR", raising=False)
    runs = {}
    for pkg, run in (("jax", jax_main), ("port", lambda a: tcli.main(a, device="cpu"))):
        o = tmp_path / pkg
        o.mkdir()
        with contextlib.redirect_stdout(io.StringIO()):
            run([_fill(a, {"o": str(o), **inputs}) for a in argv])
        runs[pkg] = _outputs(o)
    assert runs["port"].keys() == runs["jax"].keys() and runs["jax"]
    for name, want in runs["jax"].items():
        got = runs["port"][name]
        assert got.shape == want.shape, name
        assert np.isfinite(got).all(), name
        scale = np.max(np.abs(want))
        assert np.max(np.abs(got.astype(np.float64) - want)) <= tol * scale, name
