"""File parity of the port's command line with the JAX one: ``psf``,
``info``, ``deconv`` (vmlmb, rl, admm), ``blind`` (with ``--checkpoint`` /
``--resume``) and ``fitpsf``.

The JAX CLI's ``main(argv)`` runs in process once per argv, in a module
fixture (``MICROTIPI_CACHE_DIR`` unset, so no compilation cache on the CPU);
the port's ``main(argv, device="cpu")`` runs on the same input files: a
seeded 16x32x32 scene written as TIFF and as OME-NGFF. Both packages compute
in float32 (the CLIs' dtype). Tolerances:

- the PSF: float32 round-off, 1e-6 of the largest value;
- short solves (<= 10 iterations): 1e-4 relative in max norm, with equal
  iteration counts, and the reports' costs to 1e-5;
- where a float32 trajectory parts beyond that, the test says where and holds
  the port CLI's output bit for bit against the port's job called with the
  config that ``tests/test_torch_cli_surface.py`` pins.
"""

import json

import numpy as np
import pytest
import torch

from microtipi_tpu_torch import cli as tcli
from microtipi_tpu_torch.cli.parser import build_parser
from microtipi_tpu_torch.io.tiffstack import read_stack, write_stack
from microtipi_tpu_torch.io.zarrstack import read_ngff_hyperstack, write_ngff_hyperstack

SHAPE = (16, 32, 32)
OPTICS = ["--na", "1.4", "--wavelength", "561e-9", "--ni", "1.518", "--n-phase", "3"]
TRUE_PHASE = [0.3, -0.2, 0.1]


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want)) / np.max(np.abs(want)))


def _scene(d):
    """A seeded bead scene blurred by an aberrated widefield PSF plus noise,
    as TIFF and NGFF, its true PSF, and a bead stack."""
    from microtipi_tpu_torch.models.widefield import WideFieldConfig, WideFieldModel
    from microtipi_tpu_torch.ops.convolution import convolve, convolve_spectrum

    model = WideFieldModel(WideFieldConfig(shape=SHAPE, na=1.4, wavelength=561e-9, ni=1.518, dxy=80e-9,
                                           dz=200e-9, n_phase=3, dtype=torch.float64), "cpu")
    rng = np.random.default_rng(0)
    obj = rng.random(SHAPE) * (rng.random(SHAPE) < 0.05) * 300
    with torch.no_grad():
        psf = model.compute_psf(model.init_params()._replace(phase=torch.tensor(TRUE_PHASE, dtype=torch.float64)))
        blur = convolve(torch.tensor(obj), convolve_spectrum(psf), SHAPE).numpy()
    data = (blur + 0.01 * blur.max() * rng.standard_normal(SHAPE)).astype(np.float32)
    off_centre = np.roll(np.fft.fftshift(psf.numpy()), (1, 3, -2), axis=(0, 1, 2))
    bead = (1e4 * off_centre + 10 + rng.standard_normal(SHAPE)).astype(np.float32)
    files = {"tif": str(d / "scene.tif"), "zarr": str(d / "scene.zarr"), "psf": str(d / "psf.tif"),
             "bead": str(d / "bead.tif")}
    write_stack(files["tif"], data, dxy=80e-9, dz=200e-9)
    write_ngff_hyperstack(files["zarr"], data, dxy=80e-9, dz=200e-9)
    write_stack(files["psf"], psf.numpy().astype(np.float32), dxy=80e-9, dz=200e-9)
    write_stack(files["bead"], bead, dxy=80e-9, dz=200e-9)
    return files


def _argvs(files, out):
    """{name: argv} of every command compared; ``out`` is the output directory."""
    solve = ["--mu", "0.01", "--epsilon", "1", "--iters", "8", "--grtol", "0", "--gatol", "0"]
    return {
        "psf": ["psf", f"{out}/psf.tif", "--shape", *map(str, SHAPE), *OPTICS, "--phase", *map(str, TRUE_PHASE)],
        "deconv-vmlmb": ["deconv", files["tif"], "--psf", files["psf"], "--out", f"{out}/vmlmb.tif", *solve,
                         "--report", f"{out}/vmlmb.json"],
        "deconv-rl": ["deconv", files["zarr"], "--psf", files["psf"], "--out", f"{out}/rl.zarr", "--method", "rl",
                      "--iters", "10"],
        "deconv-admm": ["deconv", files["tif"], "--psf", files["psf"], "--out", f"{out}/admm.tif",
                        "--method", "admm", *solve, "--report", f"{out}/admm.json"],
        "blind-admm": ["blind", files["zarr"], "--out", f"{out}/blind.zarr", *OPTICS, "--loops", "2",
                       "--psf-iters", "3", "--joint-fit", "--mu", "0.01", "--iters", "5", "--deconv-engine", "admm",
                       "--report", f"{out}/blind.json", "--params-out", f"{out}/blind_params.json"],
        "fitpsf": ["fitpsf", files["bead"], *OPTICS, "--iters", "6", "--families", "phase",
                   "--params-out", f"{out}/fit.json", "--out", f"{out}/fit.tif"],
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The scene, and the JAX CLI's outputs of every argv."""
    from microtipi_tpu.cli import main as jax_main

    d = tmp_path_factory.mktemp("cli")
    files = _scene(d)
    (d / "jax").mkdir()
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("MICROTIPI_CACHE_DIR", raising=False)
        for argv in _argvs(files, d / "jax").values():
            jax_main(argv)
    return files, d


def _port(runs, name, tmp_path):
    files, _ = runs
    argv = _argvs(files, tmp_path)[name]
    tcli.main(argv, device="cpu")
    return tmp_path


def _vol(path):
    return read_ngff_hyperstack(str(path))[0][0, 0] if str(path).endswith(".zarr") else read_stack(str(path))


def test_psf_matches_jax(runs, tmp_path):
    out = _port(runs, "psf", tmp_path)
    got, want = read_stack(out / "psf.tif"), read_stack(runs[1] / "jax" / "psf.tif")
    assert got.shape == SHAPE and _rel(got, want) <= 1e-6


def test_info_prints_what_jax_prints(runs, capsys):
    from microtipi_tpu.cli import main as jax_main

    files, _ = runs
    for path in (files["tif"], files["zarr"]):
        jax_main(["info", path])
        want = capsys.readouterr().out
        tcli.main(["info", path], device="cpu")
        assert capsys.readouterr().out == want


def _report(path):
    with open(path) as fh:
        return json.load(fh)


def _parsed(argv):
    args = build_parser().parse_args(argv)
    args.device = torch.device("cpu")
    return args


def test_deconv_vmlmb_matches_jax_then_its_job(runs, tmp_path):
    """8 VMLMB iterations (``--grtol 0``): equal counts, and the cost history
    to 1e-4 relative through iteration 2. Float32 parts the two trajectories
    from iteration 3 on this sparse scene (measured: 1.9e-4 at iteration 3,
    1.4e-3 at 4, 5.6% at 8; the line searches then take different steps), so
    the port CLI's object is held bit for bit against the port's
    ``deconvolve`` with the config its parser builds
    (``tests/test_torch_cli_surface.py`` pins that config to JAX's)."""
    from microtipi_tpu_torch.cli.shared import _deconv_config
    from microtipi_tpu_torch.jobs.deconv import deconvolve

    files, d = runs
    out = _port(runs, "deconv-vmlmb", tmp_path)
    rg, rw = _report(out / "vmlmb.json"), _report(d / "jax" / "vmlmb.json")
    assert rg["iterations"] == rw["iterations"] == 8
    np.testing.assert_allclose(rg["f_history"][:3], rw["f_history"][:3], rtol=1e-4)
    args = _parsed(_argvs(files, tmp_path)["deconv-vmlmb"])
    data, psf = (torch.as_tensor(read_stack(files[k])) for k in ("tif", "psf"))
    job = deconvolve(data, psf, config=_deconv_config(args, SHAPE))
    np.testing.assert_array_equal(read_stack(out / "vmlmb.tif"), job.x.numpy())
    assert rg["cost"] == float(job.f) and rg["iterations"] == job.iterations


def test_deconv_admm_matches_jax(runs, tmp_path):
    """8 ADMM iterations (no line search to amplify round-off): equal
    counts, the cost to 1e-5, the object to 1e-4 relative in max norm."""
    out = _port(runs, "deconv-admm", tmp_path)
    rg, rw = _report(out / "admm.json"), _report(runs[1] / "jax" / "admm.json")
    assert rg["iterations"] == rw["iterations"] == 8
    assert abs(rg["cost"] - rw["cost"]) <= 1e-5 * abs(rw["cost"])
    assert _rel(_vol(out / "admm.tif"), _vol(runs[1] / "jax" / "admm.tif")) <= 1e-4


def test_deconv_rl_on_ngff_matches_jax(runs, tmp_path):
    """10 Richardson-Lucy iterations, NGFF in and out: 1e-4 relative."""
    out = _port(runs, "deconv-rl", tmp_path)
    got, want = _vol(out / "rl.zarr"), _vol(runs[1] / "jax" / "rl.zarr")
    assert got.shape == SHAPE and _rel(got, want) <= 1e-4


def test_blind_admm_matches_jax(runs, tmp_path):
    """2 rounds of 5 ADMM object iterations and joint fits of 3, NGFF in and
    out: the object iterations equal, the round and fit costs to 1e-5. The
    fits' float32 VMLMB ends in a flat valley of the phase (costs equal to
    5e-7 where the phase parts by 4e-3 of its largest coefficient), so the
    parameters are held to 1e-2 of the largest and the object to 1e-2."""
    out = _port(runs, "blind-admm", tmp_path)
    rg, rw = _report(out / "blind.json"), _report(runs[1] / "jax" / "blind.json")
    assert rg["deconv_iters"] == rw["deconv_iters"] == [5, 5]
    np.testing.assert_allclose(rg["deconv_f"], rw["deconv_f"], rtol=1e-5)
    np.testing.assert_allclose(rg["fit_f"], rw["fit_f"], rtol=1e-5)
    assert np.isnan(rg["fit_f"][-1]).all()
    pg, pw = _report(out / "blind_params.json"), _report(runs[1] / "jax" / "blind_params.json")
    for name in ("phase", "defocus"):
        assert _rel(pg[name], pw[name]) <= 1e-2, name
    assert _rel(_vol(out / "blind.zarr"), _vol(runs[1] / "jax" / "blind.zarr")) <= 1e-2


def test_blind_vmlmb_equals_its_job(runs, tmp_path):
    """The blind loop on the VMLMB engine (the CLI's default): float32 parts
    the JAX and port object steps inside round 1 on this scene (5e-4 in the
    round's cost after 2 iterations), so the port CLI's output is held bit
    for bit against the port's ``blind_deconvolve`` with the config its
    parser builds (pinned to JAX's by ``tests/test_torch_cli_surface.py``)."""
    from microtipi_tpu_torch.cli.blind import _blind_config
    from microtipi_tpu_torch.cli.shared import _model
    from microtipi_tpu_torch.jobs.blind import blind_deconvolve

    files, _ = runs
    argv = ["blind", files["zarr"], "--out", str(tmp_path / "b.zarr"), *OPTICS, "--loops", "2", "--psf-iters", "3",
            "--joint-fit", "--mu", "0.01", "--iters", "4", "--grtol", "0", "--psf-out", str(tmp_path / "h.tif")]
    tcli.main(argv, device="cpu")
    args = _parsed(argv)
    args.dxy, args.dz = 80e-9, 200e-9
    res = blind_deconvolve(torch.as_tensor(_vol(files["zarr"])), _model(args, SHAPE),
                           config=_blind_config(args, SHAPE))
    np.testing.assert_array_equal(_vol(tmp_path / "b.zarr"), res.obj.numpy())
    np.testing.assert_array_equal(read_stack(tmp_path / "h.tif"), res.psf.numpy())


def test_blind_checkpoint_resume_equals_the_uninterrupted_run(runs, tmp_path, monkeypatch):
    """``--checkpoint`` for 3 rounds, stopped after round 1 (the save after it
    raises), then ``--resume``: the object and the parameters equal the
    uninterrupted checkpointed run's bit for bit."""
    from microtipi_tpu_torch.utils import checkpoint

    files, _ = runs
    base = ["blind", files["tif"], *OPTICS, "--loops", "3", "--psf-iters", "2", "--joint-fit", "--iters", "4",
            "--grtol", "0"]
    whole = [*base, "--out", str(tmp_path / "whole.tif"), "--checkpoint", str(tmp_path / "whole.npz"),
             "--params-out", str(tmp_path / "whole.json")]
    tcli.main(whole, device="cpu")

    class Preempted(Exception):
        pass

    save = checkpoint.save_state

    def save_then_stop(path, obj, params, round_index, **extra):
        save(path, obj, params, round_index, **extra)
        raise Preempted

    cut = [*base, "--out", str(tmp_path / "cut.tif"), "--checkpoint", str(tmp_path / "cut.npz"),
           "--params-out", str(tmp_path / "cut.json")]
    monkeypatch.setattr(checkpoint, "save_state", save_then_stop)
    with pytest.raises(Preempted):
        tcli.main(cut, device="cpu")
    monkeypatch.setattr(checkpoint, "save_state", save)
    assert checkpoint.load_state(str(tmp_path / "cut.npz"), device="cpu")[2] == 1
    tcli.main([*cut, "--resume"], device="cpu")
    np.testing.assert_array_equal(read_stack(tmp_path / "cut.tif"), read_stack(tmp_path / "whole.tif"))
    assert _report(tmp_path / "cut.json") == _report(tmp_path / "whole.json")
    with pytest.raises(SystemExit, match="already at the final round"):
        tcli.main([*cut, "--resume"], device="cpu")


def test_fitpsf_matches_jax(runs, tmp_path):
    """A phase fit of 6 iterations on an off-centre bead: the cost and the
    bead amplitude to 1e-5. Float32 ends the fit in a flat valley (costs
    equal to 2.4e-7 where the phase parts by 4.7e-3 of its largest
    coefficient), so the phase is held to 1e-2 of the largest and the fitted
    PSF to 1e-2 of its peak."""
    out = _port(runs, "fitpsf", tmp_path)
    pg, pw = _report(out / "fit.json"), _report(runs[1] / "jax" / "fit.json")
    assert abs(pg["cost"] - pw["cost"]) <= 1e-5 * abs(pw["cost"])
    assert abs(pg["amplitude"] - pw["amplitude"]) <= 1e-5 * abs(pw["amplitude"])
    assert pg["defocus"] == pw["defocus"] and np.max(np.abs(pw["phase"])) > 0.1
    assert _rel(pg["phase"], pw["phase"]) <= 1e-2
    assert _rel(read_stack(out / "fit.tif"), read_stack(runs[1] / "jax" / "fit.tif")) <= 1e-2
