"""The port's watch-folder service against the JAX one, then its behaviours.

Parity: ``watch`` with ``devices=[torch.device("cpu")]`` on two 16x32x32
TIFF files (a seeded bead scene blurred by an aberrated widefield PSF, with
noise) against the JAX ``watch`` on the same files, run once each in a
module fixture, both in float32:

- ``vmlmb`` with the true PSF, 2 iterations: 1e-4 relative in max norm
  (measured 4.2e-5). The float32 objective's quadratic form carries ~1e-4
  relative round-off in either package (after one iteration the objects
  agree to 8e-8 and the costs differ by 4e-4), so from iteration 3 the line
  searches part the trajectories (2.4e-4 in x at 3, 15% at 5); each served
  file is also held bit for bit against the port's ``deconvolve``;
- ``blind-once`` (a 2-round blind loop on the ADMM engine with joint fits of
  3, then the fast fixed-PSF path of 2 VMLMB iterations): the calibrating
  file's object to 1e-4; the calibrated phase to 2e-2 of its largest
  coefficient (measured 1.06e-2: the fits' float32 VMLMB ends in a flat
  valley of the cost, as in ``tests/test_torch_cli.py``), and the second
  file, solved through that phase, to 1e-3.

Then the behaviours of ``tests/test_serve.py`` at 4x16x16: a bad input
survives and its retries are bounded at one size, a file that grows is
reclaimed, the metrics snapshot and the HTTP endpoint, ``.zarr`` stores in
and out, a plate fanning out its wells, the priority order, fan-out over two
entries of the CPU device (blind-once calibrating before it), and the card
by default.
"""

import json
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from microtipi_tpu_torch.io.tiffstack import read_stack, write_stack
from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig
from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
from microtipi_tpu_torch.models.microscope import DEFOCUS, PHASE
from microtipi_tpu_torch.models.widefield import WideFieldConfig, WideFieldModel
from microtipi_tpu_torch.ops.convolution import convolve, convolve_spectrum
from microtipi_tpu_torch.serve import _DirWaiter, _serve_metrics, watch

CPU = [torch.device("cpu")]
SHAPE = (16, 32, 32)
OPTICS = dict(na=1.4, wavelength=561e-9, ni=1.518, dxy=80e-9, dz=200e-9, n_phase=3)
TRUE_PHASE = [0.3, -0.2, 0.1]
SERVE = dict(mu=0.01, epsilon=1.0, max_iter=2, grtol=0.0)
BLIND = dict(loops=2, families=(DEFOCUS, PHASE), psf_max_iter=(3, 3), joint_fit=True, deconv_engine="admm")


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want)) / np.max(np.abs(want)))


def _bench_files(d, n=2):
    """n seeded bead scenes through the aberrated PSF, and that PSF."""
    model = WideFieldModel(WideFieldConfig(shape=SHAPE, dtype=torch.float64, **OPTICS), "cpu")
    with torch.no_grad():
        psf = model.compute_psf(model.init_params()._replace(phase=torch.tensor(TRUE_PHASE, dtype=torch.float64)))
    rng = np.random.default_rng(0)
    (d / "in").mkdir()
    for i in range(n):
        obj = torch.tensor(rng.random(SHAPE) * (rng.random(SHAPE) < 0.05) * 300)
        with torch.no_grad():
            blur = convolve(obj, convolve_spectrum(psf), SHAPE).numpy()
        write_stack(d / "in" / f"s{i}.tif", (blur + 0.01 * blur.max() * rng.standard_normal(SHAPE)).astype(np.float32))
    write_stack(d / "psf.tif", psf.numpy().astype(np.float32))
    return d / "in", d / "psf.tif"


def _calibrated_phase(logs):
    line = next(m for m in logs if "calibrated pupil" in m)
    return np.array([float(v) for v in re.search(r"'phase': \[([^\]]*)\]", line).group(1).split(",")])


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX service's outputs on the bench files: vmlmb, and blind-once
    with its calibration log."""
    import jax.numpy as jnp

    from microtipi_tpu import serve as jax_serve
    from microtipi_tpu.jobs.blind import BlindDeconvConfig as JaxBlind
    from microtipi_tpu.jobs.deconv import DeconvolutionConfig as JaxDeconv
    from microtipi_tpu.models.widefield import WideFieldConfig as JaxWideField

    d = tmp_path_factory.mktemp("serve")
    indir, psf = _bench_files(d)
    jax_serve.watch(indir, d / "jax_vmlmb", psf, config=JaxDeconv(**SERVE), poll_seconds=0.02, max_files=2,
                    log=lambda m: None)
    logs = []
    jax_serve.watch(indir, d / "jax_blind", None, method="blind-once", config=JaxDeconv(**SERVE),
                    model_factory=lambda s: JaxWideField(shape=s, dtype=jnp.float32, **OPTICS),
                    blind_config=JaxBlind(**BLIND, deconv=JaxDeconv(**SERVE)), poll_seconds=0.02, max_files=2,
                    log=logs.append)
    return d, indir, psf, _calibrated_phase(logs)


def test_vmlmb_matches_jax(jax_runs, tmp_path):
    from microtipi_tpu_torch.jobs.deconv import deconvolve

    d, indir, psf, _ = jax_runs
    out = watch(indir, tmp_path, psf, config=DeconvolutionConfig(**SERVE), poll_seconds=0.02, max_files=2,
                log=lambda m: None, devices=CPU)
    assert sorted(p.name for p in out) == ["s0.tif", "s1.tif"]
    for p in out:
        got = read_stack(p)
        assert _rel(got, read_stack(d / "jax_vmlmb" / p.name)) <= 1e-4
        job = deconvolve(torch.as_tensor(read_stack(indir / p.name)), torch.as_tensor(read_stack(psf)),
                         config=DeconvolutionConfig(**SERVE))
        np.testing.assert_array_equal(got, job.x.numpy())


def test_blind_once_matches_jax(jax_runs, tmp_path):
    d, indir, _, jax_phase = jax_runs
    logs = []
    out = watch(indir, tmp_path, None, method="blind-once", config=DeconvolutionConfig(**SERVE),
                model_factory=lambda s: WideFieldConfig(shape=s, **OPTICS),
                blind_config=BlindDeconvConfig(**BLIND, deconv=DeconvolutionConfig(**SERVE)), poll_seconds=0.02,
                max_files=2, log=logs.append, devices=CPU)
    assert [p.name for p in out] == ["s0.tif", "s1.tif"]
    assert len([m for m in logs if "calibrated pupil from first file" in m]) == 1
    assert _rel(_calibrated_phase(logs), jax_phase) <= 2e-2
    for p, bound in zip(out, (1e-4, 1e-3)):
        got = read_stack(p)
        assert np.isfinite(got).all() and _rel(got, read_stack(d / "jax_blind" / p.name)) <= bound, p.name


def _mini_scene(tmp_path, shape=(4, 16, 16), seed=1):
    psf = np.zeros(shape, np.float32)
    psf[0, 0, 0] = 0.6
    psf[0, 0, 1] = 0.4
    write_stack(tmp_path / "psf.tif", psf)
    o = np.abs(np.random.default_rng(seed).standard_normal(shape)) * 10
    with torch.no_grad():
        d = convolve(torch.tensor(o), convolve_spectrum(torch.tensor(psf, dtype=torch.float64)), shape)
    return tmp_path / "psf.tif", d.numpy().astype(np.float32)


MINI = DeconvolutionConfig(mu=0.001, epsilon=1.0, max_iter=4)


def test_bad_input_survives_and_its_retries_are_bounded(tmp_path):
    """A corrupt file is attempted max_retries times at one size, logged as
    failed, never fatal; the good files are served."""
    indir = tmp_path / "in"
    indir.mkdir()
    psf, d = _mini_scene(tmp_path)
    (indir / "0broken.tif").write_bytes(b"not a tiff at all")
    fails, state = [], {"released": False}

    def log(msg):
        if "FAILED" in msg:
            fails.append(msg)
        if len(fails) >= 2 and not state["released"]:  # the budget is spent: give the loop files
            state["released"] = True
            write_stack(indir / "a.tif", d)
            write_stack(indir / "b.tif", d * 2)

    out = watch(indir, tmp_path / "out", psf, config=MINI, poll_seconds=0.02, max_files=2, max_retries=2, log=log,
                devices=CPU)
    assert [p.name for p in out] == ["a.tif", "b.tif"]
    assert len([m for m in fails if "0broken.tif" in m]) == 2
    assert all(np.isfinite(read_stack(p)).all() for p in out)


def test_a_file_that_grows_after_a_failure_is_reclaimed(tmp_path):
    indir = tmp_path / "in"
    indir.mkdir()
    psf, d = _mini_scene(tmp_path)
    (indir / "a.tif").write_bytes(b"garbage that is not a tiff")
    state = {"replaced": False}

    def log(msg):
        if "FAILED" in msg and not state["replaced"]:
            state["replaced"] = True  # the writer finishes: a valid, larger stack
            write_stack(indir / "a.tif", d)

    out = watch(indir, tmp_path / "out", psf, config=MINI, poll_seconds=0.02, max_files=1, max_retries=1,
                log=log, devices=CPU)
    assert [p.name for p in out] == ["a.tif"] and state["replaced"]
    assert read_stack(out[0]).shape == d.shape


def test_metrics_snapshot_and_http_endpoint(tmp_path):
    srv = _serve_metrics(0, lambda: {"processed": 7})
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        assert json.loads(urllib.request.urlopen(f"{url}/metrics", timeout=5).read()) == {"processed": 7}
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{url}/nope", timeout=5)
        assert e.value.code == 404
    finally:
        srv.shutdown()
    indir = tmp_path / "in"
    indir.mkdir()
    psf, d = _mini_scene(tmp_path)
    write_stack(indir / "a.tif", d)
    write_stack(indir / "b.tif", d * 1.5)
    (indir / "0bad.tif").write_bytes(b"nope")
    logs = []
    out = watch(indir, tmp_path / "out", psf, config=MINI, poll_seconds=0.02, max_files=2, log=logs.append,
                metrics_path=tmp_path / "m.json", metrics_port=0, devices=CPU)
    assert len(out) == 2 and any("metrics at http" in m for m in logs)
    snap = json.loads((tmp_path / "m.json").read_text())
    assert snap["processed"] == 2 and snap["failed_attempts"] >= 1
    assert snap["voxels"] == 2 * d.size and snap["mvox_per_second"] > 0 and snap["uptime_seconds"] > 0
    assert snap["per_device"] == {"cpu": 2}


def test_dir_waiter_wakes_on_change(tmp_path):
    w = _DirWaiter(tmp_path)
    try:
        t0 = time.time()
        w.wait(0.2)
        assert time.time() - t0 >= 0.15
        if w._fd is None:
            return  # no inotify here: the sleep above is the whole waiter

        def touch():
            time.sleep(0.05)
            (tmp_path / "new.tif").write_bytes(b"x")

        threading.Thread(target=touch).start()
        t0 = time.time()
        w.wait(5.0)
        assert time.time() - t0 < 2.0
    finally:
        w.close()


def test_zarr_stores_in_and_out_and_a_plate_fans_out(tmp_path):
    from microtipi_tpu_torch.io.plate import is_plate, read_plate_image, write_plate
    from microtipi_tpu_torch.io.zarrstack import read_ngff_hyperstack, write_ngff_hyperstack

    indir = tmp_path / "in"
    indir.mkdir()
    psf, d = _mini_scene(tmp_path)
    write_ngff_hyperstack(indir / "v.zarr", d, dxy=100e-9, dz=250e-9)
    wells = {"A/1": [d], "B/2": [d * 0.5]}
    write_plate(indir / "p.zarr", wells, dxy=100e-9, dz=250e-9, zarr_format=3, compressor="zstd")
    logs = []
    out = watch(indir, tmp_path / "out", psf, config=MINI, poll_seconds=0.02, max_files=2, log=logs.append,
                zarr_levels=2, devices=CPU)
    assert sorted(p.name for p in out) == ["p.zarr", "v.zarr"]
    rec, _ = read_ngff_hyperstack(tmp_path / "out" / "v.zarr")
    assert rec.shape == (1, 1, *d.shape) and np.isfinite(rec).all()
    attrs = json.loads((tmp_path / "out" / "v.zarr" / ".zattrs").read_text())
    assert [ds["path"] for ds in attrs["multiscales"][0]["datasets"]] == ["0", "1"]
    assert not (tmp_path / "out" / "v.zarr.tmp").exists()
    assert is_plate(tmp_path / "out" / "p.zarr") and (tmp_path / "out" / "p.zarr" / "zarr.json").exists()
    for well in wells:
        rec, _ = read_plate_image(tmp_path / "out" / "p.zarr", well, 0)
        assert rec.shape == (1, 1, *d.shape) and np.isfinite(rec).all()
    assert any("plate (2 images)" in m for m in logs)


def test_priority_order_within_a_scan(tmp_path):
    indir = tmp_path / "in"
    indir.mkdir()
    psf, d = _mini_scene(tmp_path)
    for name in ("b_bulk.tif", "a_bulk.tif", "live_2.tif", "urgent_1.tif", "live_1.tif"):
        write_stack(indir / name, d)
    out = watch(indir, tmp_path / "out", psf, config=DeconvolutionConfig(mu=0.001, epsilon=1.0, max_iter=2),
                poll_seconds=0.02, max_files=5, priority_patterns=["urgent_*", "live_*"], log=lambda m: None,
                devices=CPU)
    assert [p.name for p in out] == ["urgent_1.tif", "live_1.tif", "live_2.tif", "a_bulk.tif", "b_bulk.tif"]


def test_fan_out_over_two_cpu_entries_after_blind_once_calibrates(tmp_path):
    """Two entries of the CPU device: the first file calibrates alone, then
    the other three go round-robin, one worker thread an entry; every output
    lands and equals the single-device service's bit for bit."""
    shape = (4, 16, 16)
    cfg = dict(na=1.2, wavelength=500e-9, ni=1.33, dxy=100e-9, dz=250e-9, n_phase=2, radial=True)
    m = WideFieldModel(WideFieldConfig(shape=shape, **cfg), "cpu")
    with torch.no_grad():
        psf = m.compute_psf(m.init_params()._replace(phase=torch.tensor([0.25, -0.1])))
    indir = tmp_path / "in"
    indir.mkdir()
    rng = np.random.default_rng(3)
    for i in range(4):
        o = torch.tensor(np.abs(rng.standard_normal(shape)).astype(np.float32) * 10)
        with torch.no_grad():
            write_stack(indir / f"s{i}.tif", convolve(o, convolve_spectrum(psf), shape).numpy())
    bcfg = BlindDeconvConfig(loops=2, families=(PHASE,), psf_max_iter=(3,), joint_fit=True,
                             deconv=DeconvolutionConfig(mu=1e-3, epsilon=1.0, max_iter=3, grtol=0.0))
    outs = {}
    for name, devices in (("two", CPU * 2), ("one", CPU)):
        logs = []
        outs[name] = watch(indir, tmp_path / name, None, method="blind-once",
                           config=DeconvolutionConfig(mu=1e-3, epsilon=1.0, max_iter=3),
                           model_factory=lambda s: WideFieldConfig(shape=s, **cfg), blind_config=bcfg,
                           poll_seconds=0.02, max_files=4, log=logs.append, devices=devices,
                           metrics_path=tmp_path / f"{name}.json")
        assert len([m_ for m_ in logs if "calibrated pupil" in m_]) == 1
    assert sorted(p.name for p in outs["two"]) == [f"s{i}.tif" for i in range(4)]
    for p in outs["two"]:
        np.testing.assert_array_equal(read_stack(p), read_stack(tmp_path / "one" / p.name))
    assert json.loads((tmp_path / "two.json").read_text())["per_device"] == {"cpu": 4}


def test_the_card_by_default(tmp_path, monkeypatch):
    psf, _ = _mini_scene(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        watch(tmp_path, tmp_path / "out", psf, max_files=1)
    with pytest.raises(ValueError, match="auto_mu"):
        watch(tmp_path, tmp_path / "out", psf, method="rl", auto_mu=True, devices=CPU)
