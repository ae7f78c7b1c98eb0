"""The port's sharded ADMM engine (``parallel/admm.py``: the rhs and split
update through the ADMM kernels' slab modes, here their plain versions) on
meshes of CPU entries (float64), against the port's dense
``admm_deconvolve`` and against the JAX package's
``sharded_admm_deconvolve`` on the same mesh shape (the conftest's virtual
devices, computed once in a module fixture).

Tolerances are ``tests/test_parallel_jobs.py``'s: f to 1e-8 relative, x to
1e-6 absolute, f_history to 1e-7 relative (the same float64 iteration with
the FFT and the sums in another order; an ADMM iteration has no line search
to amplify it). The Boyd-stopped solves stop at the same iteration.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.jobs.deconv import DeconvolutionConfig as JaxDeconvConfig
from microtipi_tpu.parallel.admm import sharded_admm_deconvolve as jax_sharded_admm
from microtipi_tpu.parallel.mesh import make_mesh as jax_make_mesh
from microtipi_tpu_torch.jobs.admm import admm_deconvolve
from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
from microtipi_tpu_torch.models.widefield import WideFieldConfig, WideFieldModel
from microtipi_tpu_torch.ops.convolution import convolve, convolve_spectrum
from microtipi_tpu_torch.ops.kernels import admm_split as ak
from microtipi_tpu_torch.parallel import make_mesh, sharded_admm_deconvolve
from microtipi_tpu_torch.parallel.mesh import ShardedVolume, gather

SHAPE = (16, 32, 32)
F_REL, X_ABS, H_REL = 1e-8, 1e-6, 1e-7
CFG = dict(mu=0.002, epsilon=1.0, grtol=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(b, z):
    return make_mesh(b, z, devices=[torch.device("cpu")] * (b * z))


@pytest.fixture(scope="module")
def scene():
    model = WideFieldModel(WideFieldConfig(shape=SHAPE, na=1.2, wavelength=500e-9, ni=1.33, dxy=100e-9, dz=250e-9,
                                           n_phase=3, radial=True, dtype=torch.float64), device="cpu")
    p = model.init_params()._replace(phase=torch.tensor([0.4, -0.2, 0.1], dtype=torch.float64))
    rng = np.random.default_rng(0)
    obj = torch.as_tensor((rng.random(SHAPE) > 0.97) * rng.random(SHAPE) * 80.0)
    with torch.no_grad():
        psf = model.compute_psf(p)
        data = convolve(obj, convolve_spectrum(psf), SHAPE) + 0.01 * torch.as_tensor(rng.standard_normal(SHAPE))
    weights = torch.as_tensor(0.5 + rng.random(SHAPE))
    return psf, data, weights


@pytest.fixture(scope="module")
def jax_ref(scene):
    psf, data, weights = scene
    mesh = jax_make_mesh(1, 4, devices=jax.devices()[:4])
    cfg = JaxDeconvConfig(max_iter=15, **CFG)
    out = {}
    for name, w in (("uniform", None), ("weighted", weights)):
        res = jax.jit(lambda d, p, w: jax_sharded_admm(d, p, mesh, weights=w, config=cfg))(
            jnp.asarray(data.numpy()), jnp.asarray(psf.numpy()), None if w is None else jnp.asarray(w.numpy()))
        out[name] = (float(res.f), np.asarray(res.x), np.asarray(res.f_history))
    return out


def _same(got, ref):
    assert abs(float(got.f) - float(ref.f)) <= F_REL * abs(float(ref.f))
    assert float((gather(got.x) - ref.x).abs().max()) <= X_ABS


@pytest.mark.parametrize("mesh_shape", [(1, 2), (1, 4), (2, 2)])
@pytest.mark.parametrize("over_relax", [1.8, 1.0])
def test_sharded_admm_uniform_matches_dense(mesh_shape, over_relax, scene):
    psf, data, _ = scene
    cfg = DeconvolutionConfig(max_iter=15, **CFG)
    got = sharded_admm_deconvolve(data, psf, _mesh(*mesh_shape), config=cfg, over_relax=over_relax)
    ref = admm_deconvolve(data, psf, config=cfg, over_relax=over_relax)
    assert isinstance(got.x, ShardedVolume) and got.iterations == 15
    _same(got, ref)
    np.testing.assert_allclose(got.f_history, ref.f_history, rtol=H_REL)


@pytest.mark.parametrize("name", ["uniform", "weighted"])
def test_sharded_admm_matches_jax_sharded(name, scene, jax_ref):
    psf, data, weights = scene
    got = sharded_admm_deconvolve(data, psf, _mesh(1, 4), weights=None if name == "uniform" else weights,
                                  config=DeconvolutionConfig(max_iter=15, **CFG))
    f, x, hist = jax_ref[name]
    assert abs(float(got.f) - f) <= F_REL * abs(f)
    assert float(np.abs(gather(got.x).numpy() - x).max()) <= X_ABS
    np.testing.assert_allclose(got.f_history, hist, rtol=H_REL)


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
def test_sharded_admm_weighted_excludes_nan_at_zero_weight(mesh_shape, scene):
    psf, data, weights = scene
    w = weights.clone()
    w[0, 0, 0] = 0.0
    bad = data.clone()
    bad[0, 0, 0] = float("nan")
    cfg = DeconvolutionConfig(max_iter=15, **CFG)
    got = sharded_admm_deconvolve(bad, psf, _mesh(*mesh_shape), weights=w, config=cfg)
    assert bool(torch.isfinite(gather(got.x)).all()) and np.isfinite(got.f)
    _same(got, admm_deconvolve(bad, psf, weights=w, config=cfg))


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
def test_sharded_admm_poisson_matches_dense(mesh_shape, scene):
    psf, data, _ = scene
    dp = torch.clamp_min(data, 0.0) + 1.0
    cfg = DeconvolutionConfig(max_iter=10, data_term="poisson", background=0.5, **CFG)
    _same(sharded_admm_deconvolve(dp, psf, _mesh(*mesh_shape), config=cfg), admm_deconvolve(dp, psf, config=cfg))


@pytest.mark.parametrize("weighted", [False, True])
def test_sharded_admm_boyd_stop_matches_dense(weighted, scene):
    """The Boyd residual path: the same stopping iteration and status."""
    psf, data, weights = scene
    w = weights if weighted else None
    cfg = DeconvolutionConfig(max_iter=300, admm_reltol=1e-2, admm_check_every=5, **CFG)
    got = sharded_admm_deconvolve(data, psf, _mesh(1, 4), weights=w, config=cfg, track_objective=False)
    ref = admm_deconvolve(data, psf, weights=w, config=cfg, over_relax=1.8, track_objective=False)
    assert (got.iterations, got.status) == (ref.iterations, ref.status)
    _same(got, ref)


def test_sharded_admm_runs_the_slab_entries_only(scene, monkeypatch):
    """Every iteration goes through the slab wrappers, once a slab, and never
    through the whole-volume ones."""
    psf, data, _ = scene
    calls = {"split": 0, "rhs": 0}
    import microtipi_tpu_torch.parallel.admm as padmm

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(padmm, "admm_split_update_slab", count("split", ak.admm_split_update_slab))
    monkeypatch.setattr(padmm, "admm_rhs_slab", count("rhs", ak.admm_rhs_slab))
    monkeypatch.setattr(ak, "admm_split_update", None)
    monkeypatch.setattr(ak, "admm_rhs", None)
    sharded_admm_deconvolve(data, psf, _mesh(1, 4), config=DeconvolutionConfig(max_iter=6, **CFG))
    assert calls == {"split": 24, "rhs": 24}


def test_sharded_admm_refuses_what_it_does_not_take(scene):
    psf, data, _ = scene
    mesh = _mesh(1, 4)
    with pytest.raises(ValueError, match="one \\(Nz, Ny, Nx\\) volume"):
        sharded_admm_deconvolve(torch.stack([data, data]), psf, mesh)
    with pytest.raises(ValueError, match="psf shape == volume shape"):
        sharded_admm_deconvolve(data, psf[:8], mesh)
    with pytest.raises(ValueError, match="padded-variable"):
        sharded_admm_deconvolve(data, psf, mesh, config=DeconvolutionConfig(var_shape=(16, 32, 40)))
