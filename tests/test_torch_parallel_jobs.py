"""The port's sharded jobs on meshes of CPU entries (float64), against the
port's dense jobs and, for ``sharded_deconvolve`` and ``sharded_fit_psf``,
against the JAX package's sharded functions on the same mesh shape (the
conftest's virtual devices; the references computed once in a module
fixture). The scene is ``tests/test_parallel_jobs.py``'s 16x32x32, with
12x14x14 for the padded modes.

Tolerances are those ``tests/test_parallel_jobs.py`` holds JAX's sharded
jobs to against its dense ones: f to 1e-8 relative, the object to 1e-6
absolute (intensities up to ~90), the phase to 1e-7: the same float64
algebra with the FFT and the sums taken in another order. The sharded RL to
1e-8 relative. The CLI's ``--mesh`` bit for bit against the job it calls.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.jobs.deconv import DeconvolutionConfig as JaxDeconvConfig
from microtipi_tpu.jobs.psf_fit import PsfFitConfig as JaxFitConfig
from microtipi_tpu.models.widefield import WideFieldConfig as JaxConfig
from microtipi_tpu.parallel.deconv import sharded_deconvolve as jax_sharded_deconvolve
from microtipi_tpu.parallel.mesh import make_mesh as jax_make_mesh
from microtipi_tpu.parallel.psf_fit import sharded_fit_psf as jax_sharded_fit_psf
from microtipi_tpu_torch.cli import main
from microtipi_tpu_torch.cli import shared as tshared
from microtipi_tpu_torch.cli.parser import build_parser
from microtipi_tpu_torch.convert import family_config_from_fields
from microtipi_tpu_torch.io.tiffstack import read_stack, write_stack
from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig, blind_deconvolve
from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, deconvolve
from microtipi_tpu_torch.jobs.multichannel import deconvolve_multichannel
from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig, fit_psf, fit_psf_joint
from microtipi_tpu_torch.jobs.richardson_lucy import multiview_richardson_lucy, richardson_lucy
from microtipi_tpu_torch.jobs.timeseries import deconvolve_timeseries
from microtipi_tpu_torch.models import model_for
from microtipi_tpu_torch.models.microscope import DEFOCUS, PHASE
from microtipi_tpu_torch.ops.convolution import convolve, convolve_spectrum
from microtipi_tpu_torch.parallel import (
    make_mesh,
    sharded_blind_deconvolve,
    sharded_deconvolve,
    sharded_fit_psf,
)
from microtipi_tpu_torch.parallel.mesh import gather
from microtipi_tpu_torch.parallel.psf_fit import sharded_fit_psf_joint
from microtipi_tpu_torch.parallel.richardson_lucy import sharded_multiview_richardson_lucy, sharded_richardson_lucy

SHAPE = (16, 32, 32)
ODD = (12, 14, 14)
KW = dict(na=1.2, wavelength=500e-9, ni=1.33, dxy=100e-9, dz=250e-9)
MESHES = [(1, 2), (1, 4), (2, 2)]
F_REL, X_ABS, P_ABS = 1e-8, 1e-6, 1e-7
CFG = dict(mu=0.002, epsilon=1.0, grtol=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tensors this small run fastest on one intra-op thread, and the suite
    runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(b, z):
    return make_mesh(b, z, devices=[torch.device("cpu")] * (b * z))


def _jax_model(shape=SHAPE):
    return JaxConfig(shape=shape, n_phase=3, radial=True, dtype=jnp.float64, **KW)


@pytest.fixture(scope="module")
def scene():
    """``test_parallel_jobs.py``'s scene, made by the port from numpy."""
    model = model_for(family_config_from_fields(_jax_model()), device="cpu")
    true = model.init_params()._replace(phase=torch.tensor([0.4, -0.2, 0.1], dtype=torch.float64))
    obj = np.zeros(SHAPE)
    obj[4:10, 8:20, 8:20] = 60.0
    obj[10:14, 20:28, 4:12] = 90.0
    obj = torch.as_tensor(obj)
    with torch.no_grad():
        psf = model.compute_psf(true)
        data = convolve(obj, convolve_spectrum(psf), SHAPE)
    data = data + 0.01 * torch.as_tensor(np.random.default_rng(0).standard_normal(SHAPE))
    return model, true, obj, psf, data


@pytest.fixture(scope="module")
def jax_refs(scene):
    """JAX's sharded deconvolution and PHASE fit on a (1, 4) mesh of virtual devices."""
    model, _, obj, psf, data = scene
    mesh = jax_make_mesh(1, 4, devices=jax.devices()[:4])
    d, p, o = (jnp.asarray(t.numpy()) for t in (data, psf, obj))
    cfg = JaxDeconvConfig(max_iter=15, **CFG)
    dec = jax.jit(lambda d, p: jax_sharded_deconvolve(d, p, mesh, config=cfg))(d, p)
    jm = _jax_model()
    fit = jax.jit(lambda d, o: jax_sharded_fit_psf(jm, jm.init_params(), PHASE, d, o, mesh,
                                                   config=JaxFitConfig(max_iter=15, grtol=0.0)))(d, o)
    return {"deconv": (float(dec.f), np.asarray(dec.x)), "fit": np.asarray(fit.params.phase)}


def _same(got, ref, x_abs=X_ABS):
    assert abs(float(got.f) - float(ref.f)) <= F_REL * abs(float(ref.f))
    assert float((gather(got.x) - ref.x).abs().max()) <= x_abs


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_deconvolve_matches_dense(mesh_shape, scene):
    _, _, _, psf, data = scene
    cfg = DeconvolutionConfig(max_iter=15, **CFG)
    got = sharded_deconvolve(data, psf, _mesh(*mesh_shape), config=cfg)
    _same(got, deconvolve(data, psf, config=cfg))
    assert got.iterations == 15


def test_sharded_deconvolve_matches_jax_sharded(scene, jax_refs):
    _, _, _, psf, data = scene
    got = sharded_deconvolve(data, psf, _mesh(1, 4), config=DeconvolutionConfig(max_iter=15, **CFG))
    f, x = jax_refs["deconv"]
    assert abs(float(got.f) - f) <= F_REL * abs(f)
    assert float(np.abs(gather(got.x).numpy() - x).max()) <= X_ABS


@pytest.mark.parametrize("var_shape", [(16, 16, 14), (16, 16, 16)])
def test_sharded_deconvolve_padded_matches_dense_crop(var_shape, scene):
    """Mesh-odd stacks on the padded variable: zero weight outside the
    data window, the dense crop operator's data term."""
    _, true, _, _, data = scene
    model = model_for(family_config_from_fields(_jax_model(ODD)), device="cpu")
    psf = model.compute_psf(true).detach()
    d = data[:ODD[0], :ODD[1], :ODD[2]].contiguous()
    cfg = DeconvolutionConfig(max_iter=10, var_shape=var_shape, **CFG)
    got = sharded_deconvolve(d, psf, _mesh(1, 4), config=cfg)
    assert got.x.shape == var_shape
    _same(got, deconvolve(d, psf, config=cfg))


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
def test_sharded_priors_weights_and_poisson_match_dense(mesh_shape, scene):
    """The sparsity and Hessian priors (the Hessian reads two planes of the
    next slabs), per-voxel weights with a NaN at a zero weight (from a clean
    start: the default start is the data), and the Poisson deviance."""
    _, _, _, psf, data = scene
    mesh = _mesh(*mesh_shape)
    cfg = DeconvolutionConfig(max_iter=12, sparsity=0.01, sparsity_epsilon=0.05, hessian=0.05, **CFG)
    _same(sharded_deconvolve(data, psf, mesh, config=cfg), deconvolve(data, psf, config=cfg))
    w = torch.as_tensor(0.5 + np.random.default_rng(1).random(SHAPE))
    w[0, 0, 0] = 0.0
    bad = data.clone()
    bad[0, 0, 0] = float("nan")
    cfg = DeconvolutionConfig(max_iter=10, **CFG)
    x0 = torch.clamp_min(data, 0.0)
    got = sharded_deconvolve(bad, psf, mesh, weights=w, x0=x0, config=cfg)
    assert bool(torch.isfinite(gather(got.x)).all())
    _same(got, deconvolve(bad, psf, weights=w, x0=x0, config=cfg))
    cfg = DeconvolutionConfig(max_iter=10, data_term="poisson", background=0.5, **CFG)
    dp = torch.clamp_min(data, 0.0) + 1.0
    _same(sharded_deconvolve(dp, psf, mesh, config=cfg), deconvolve(dp, psf, config=cfg))


def test_sharded_coupled_frames_match_the_joint_solvers(scene):
    """The batch rows coupled: ``mu_t`` with bleaching gains (the t halo
    across rows) against ``deconvolve_timeseries``; ``joint_channels`` with
    per-frame kernels and ``mixing`` against ``deconvolve_multichannel``."""
    _, _, _, psf, data = scene
    mesh = _mesh(2, 2)
    cfg = DeconvolutionConfig(max_iter=10, **CFG)
    d2 = torch.stack([data, 1.1 * data])
    gains = torch.tensor([1.0, 0.9], dtype=torch.float64)
    _same(sharded_deconvolve(d2, psf, mesh, config=cfg, mu_t=0.01, bleach=gains),
          deconvolve_timeseries(d2, psf, config=cfg, mu_t=0.01, bleach=gains))
    psfs = torch.stack([psf, psf.roll(1, 1)])
    _same(sharded_deconvolve(d2, psfs, mesh, config=cfg, joint_channels=True),
          deconvolve_multichannel(d2, psfs, config=cfg))
    mix = torch.tensor([[0.85, 0.25], [0.15, 0.75]], dtype=torch.float64)
    _same(sharded_deconvolve(d2, psfs, mesh, config=cfg, mixing=mix),
          deconvolve_multichannel(d2, psfs, config=cfg, coupling="separate", mixing=mix))


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
def test_sharded_fit_psf_matches_dense_and_jax(mesh_shape, scene, jax_refs):
    model, _, obj, _, data = scene
    cfg = PsfFitConfig(max_iter=15, grtol=0.0)
    got = sharded_fit_psf(model, model.init_params(), PHASE, data, obj, _mesh(*mesh_shape), config=cfg)
    ref = fit_psf(model, model.init_params(), PHASE, data, obj, config=cfg)
    assert float((got.params.phase - ref.params.phase).abs().max()) <= P_ABS
    assert float(np.abs(got.params.phase.numpy() - jax_refs["fit"]).max()) <= P_ABS


def test_sharded_fit_psf_joint_matches_dense(scene):
    model, _, obj, _, data = scene
    cfg = PsfFitConfig(max_iter=8, grtol=0.0)
    args = (model, model.init_params(), (DEFOCUS, PHASE), data, obj)
    got = sharded_fit_psf_joint(*args[:5], _mesh(1, 4), config=cfg, phase_freeze_head=1)
    ref = fit_psf_joint(*args, config=cfg, phase_freeze_head=1)
    assert float((got.params.phase - ref.params.phase).abs().max()) <= P_ABS
    # The dense float64 fit takes the quadratic form, the sharded one the
    # residual: the defocus scale (1e6 /m) carries their rounding to 1e-7.
    assert float(((got.params.defocus - ref.params.defocus) / ref.params.defocus).abs().max()) <= 1e-6


BLIND = dict(loops=2, families=(DEFOCUS, PHASE), psf_max_iter=(4, 4), joint_fit=True, phase_freeze_head=1,
             init="wiener")


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("engine", ["vmlmb", "admm"])
def test_sharded_blind_matches_dense(mesh_shape, engine, scene):
    """The quality recipe (joint fit, pin-Z4, the Wiener start) by either
    object engine; explicit unit weights as in ``test_parallel_jobs.py``."""
    model, _, _, _, data = scene
    cfg = BlindDeconvConfig(deconv=DeconvolutionConfig(max_iter=5, **CFG), deconv_engine=engine, **BLIND)
    w = torch.ones_like(data) if engine == "vmlmb" else None
    got = sharded_blind_deconvolve(data, model, _mesh(*mesh_shape), weights=w, config=cfg)
    ref = blind_deconvolve(data, model, weights=w, config=cfg)
    np.testing.assert_allclose(got.deconv_f, ref.deconv_f, rtol=F_REL)
    assert float((got.params.phase - ref.params.phase).abs().max()) <= P_ABS
    assert float((gather(got.obj) - ref.obj).abs().max()) <= X_ABS
    assert float(got.params.phase[0]) == 0.0  # pin-Z4


def test_sharded_blind_batched_and_padded(scene):
    model, _, _, _, data = scene
    cfg = BlindDeconvConfig(loops=2, families=(PHASE,), psf_max_iter=(3,),
                            deconv=DeconvolutionConfig(max_iter=4, **CFG))
    res = sharded_blind_deconvolve(torch.stack([data, 1.1 * data]), model, _mesh(2, 2), config=cfg)
    assert res.obj.shape == (2, *SHAPE) and res.deconv_f[1] <= res.deconv_f[0]
    assert np.isnan(res.fit_f[-1]).all()
    odd = model_for(family_config_from_fields(_jax_model(ODD)), device="cpu")
    res = sharded_blind_deconvolve(data[:ODD[0], :ODD[1], :ODD[2]], odd, _mesh(1, 4),
                                   config=dataclasses.replace(cfg, joint_fit=True, init="wiener"))
    assert res.obj.shape == (12, 16, 14) and np.isfinite(res.deconv_f).all() and res.deconv_f[1] <= res.deconv_f[0]


def test_sharded_blind_guards(scene):
    model, _, _, _, data = scene
    cfg = BlindDeconvConfig(loops=2, families=(PHASE,), psf_max_iter=(2,), deconv_engine="admm",
                            deconv=DeconvolutionConfig(max_iter=4, **CFG))
    with pytest.raises(ValueError, match="mesh-divisible"):
        sharded_blind_deconvolve(torch.stack([data, data]), model, _mesh(2, 2), config=cfg)
    odd = model_for(family_config_from_fields(_jax_model((15, 32, 32))), device="cpu")
    with pytest.raises(ValueError, match="mesh-divisible"):
        sharded_blind_deconvolve(data[:-1], odd, _mesh(1, 4), config=cfg)
    with pytest.raises(ValueError, match="fit_window"):
        sharded_blind_deconvolve(data, model, _mesh(1, 4), config=dataclasses.replace(
            cfg, deconv_engine="vmlmb", fit=PsfFitConfig(fit_window=(8, 16, 16))))


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
def test_sharded_richardson_lucy_matches_dense(mesh_shape, scene):
    """RL-TV (the TV's gradient from the slab mode) and multi-view fusion."""
    _, _, _, psf, data = scene
    mesh = _mesh(*mesh_shape)
    got = gather(sharded_richardson_lucy(data, psf, mesh, iterations=10, mu=0.01, epsilon=0.5))
    ref = richardson_lucy(data, psf, iterations=10, mu=0.01, epsilon=0.5)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-8, atol=1e-10)
    views, psfs = torch.stack([data, 1.1 * data]), torch.stack([psf, psf.roll(1, 0)])
    got = gather(sharded_multiview_richardson_lucy(views, psfs, _mesh(2, 2), iterations=5))
    np.testing.assert_allclose(got.numpy(), multiview_richardson_lucy(views, psfs, iterations=5).numpy(),
                               rtol=1e-8, atol=1e-10)


def test_cli_mesh_runs_the_sharded_job(scene, tmp_path):
    """``deconv --mesh 1 2`` in process on CPU entries writes what
    ``sharded_deconvolve`` computes from the same files and config."""
    _, _, _, psf, data = scene
    d, p, out = str(tmp_path / "d.tif"), str(tmp_path / "p.tif"), str(tmp_path / "o.tif")
    write_stack(d, data.numpy().astype(np.float32), dxy=100e-9, dz=250e-9)
    write_stack(p, psf.numpy().astype(np.float32), dxy=100e-9, dz=250e-9)
    argv = ["deconv", d, "--psf", p, "--out", out, "--mesh", "1", "2", "--iters", "5", "--mu", "0.002"]
    main(argv, device="cpu")
    args = build_parser().parse_args(argv)
    args.device = torch.device("cpu")
    cfg = tshared._deconv_config(args, SHAPE)
    data32 = torch.as_tensor(read_stack(d))
    psf32 = torch.as_tensor(read_stack(p))
    want = gather(sharded_deconvolve(data32, psf32, _mesh(1, 2), config=cfg).x)
    np.testing.assert_array_equal(read_stack(out), want.numpy())
