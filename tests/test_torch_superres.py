"""The port's finer-grid solve (``jobs/superres.py``) against the JAX package
on the CPU (float64). Inputs come from numpy with a seed and feed both
packages: camera data of (4, 8, 8) binned at factor (1, 2, 2) from three
point sources on the (4, 16, 16) fine grid blurred by a Gaussian PSF, plus
noise.

Tolerances: ``bin_volume``, ``upsample_volume``, ``upsample_psf`` and the
objective with its gradient to 1e-10 relative (measured 4e-16); solver
outputs, f and x, to 1e-5 relative after a fixed iteration count (measured
5e-15 at most), with equal iteration counts, Boyd-stopped runs included. The
JAX references are computed once per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.jobs import superres as jsr
from microtipi_tpu.jobs.deconv import DeconvolutionConfig as JaxDeconvConfig
from microtipi_tpu_torch.jobs import superres as tsr
from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
from microtipi_tpu_torch.ops.kernels import admm_split as ak
from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

COARSE, F, FINE = (4, 8, 8), (1, 2, 2), (4, 16, 16)
DET_RTOL, SOLVE_RTOL = 1e-10, 1e-5
BASE = dict(mu=0.02, epsilon=0.1, grtol=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tensors this small run fastest on one intra-op thread, and the suite
    runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _psf(shape=FINE, w=3.0):
    axes = [np.minimum(np.arange(n), n - np.arange(n)) for n in shape]
    psf = np.exp(-axes[0][:, None, None] ** 2 / w - axes[1][None, :, None] ** 2 / (1.5 * w)
                 - axes[2][None, None, :] ** 2 / (1.5 * w))
    return psf / psf.sum()


def _scene():
    """(data, counts, psf_fine, weights, x): binned points plus noise, Poisson
    counts of the same model, camera-grid weights with a zero-weight NaN
    pixel, and a positive fine-grid evaluation point."""
    rng = np.random.default_rng(0)
    psf = _psf()
    obj = np.zeros(FINE)
    for (z, y, x), a in zip(((1, 5, 7), (2, 11, 4), (3, 8, 13)), (100.0, 80.0, 60.0)):
        obj[z, y, x] = a
    fine = np.fft.irfftn(np.fft.rfftn(obj) * np.fft.rfftn(psf), s=FINE, axes=(0, 1, 2))
    model = fine.reshape(4, 1, 8, 2, 8, 2).sum(axis=(1, 3, 5))
    data = model + 0.5 * rng.standard_normal(COARSE)
    counts = rng.poisson(np.maximum(model, 0.0) + 1.0).astype(np.float64)
    weights = rng.uniform(0.5, 2.0, COARSE)
    weights[0, 0, 0] = 0.0
    return data, counts, psf, weights, rng.random(FINE) + 0.1


DATA, COUNTS, PSF, WEIGHTS, X = _scene()
NAN_DATA = DATA.copy()
NAN_DATA[0, 0, 0] = np.nan  # under weight 0: excluded
POISSON = dict(data_term="poisson", background=1.0)
# The data split's residuals pass a relative test late (the JAX engine's
# too): an absolute tolerance stops this run at 50 iterations.
BOYD = dict(max_iter=300, admm_reltol=5e-2, admm_abstol=1e-2, admm_check_every=10)


def _jx(a):
    return None if a is None else jnp.asarray(a)


def _tt(a):
    return None if a is None else torch.tensor(a)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _inputs(spec):
    data = {"counts": COUNTS, "nan": NAN_DATA}.get(spec.get("data"), DATA)
    return data, WEIGHTS if spec.get("weighted") else None, {**BASE, **spec.get("config", {})}, spec.get("kw", {})


OBJECTIVES = {
    "gaussian": dict(),
    "weighted_nan": dict(data="nan", weighted=True),
    "poisson_priors": dict(data="counts", config=dict(POISSON, sparsity=0.01, hessian=0.01)),
    "scales_no_tv": dict(config=dict(mu=0.0, sparsity=0.01, scales=(2.0, 0.5, 0.5))),
}
VMLMB = {
    "gaussian": dict(),
    "weighted": dict(weighted=True),
    "poisson": dict(data="counts", config=POISSON),
}
ADMM = {
    "gaussian": dict(),
    "over_relax_1_rhos": dict(kw=dict(over_relax=1.0, rho0=0.7, rho1=0.5, rho2=0.3)),
    "weighted_nan": dict(data="nan", weighted=True),
    "poisson_untracked": dict(data="counts", config=POISSON, kw=dict(track_objective=False)),
    "boyd_converges": dict(config=BOYD),
}


@pytest.fixture(scope="module")
def jax_refs():
    """Every case's JAX result, computed once."""
    out = {}
    for name, spec in OBJECTIVES.items():
        data, w, cfg, _ = _inputs(spec)
        obj = jsr.make_superres_objective(_jx(PSF), _jx(data), _jx(w), JaxDeconvConfig(**cfg), F)
        out["objective", name] = tuple(np.asarray(v) for v in jax.value_and_grad(obj)(jnp.asarray(X)))
    for name, spec in VMLMB.items():
        data, w, cfg, _ = _inputs(spec)
        out["vmlmb", name] = jsr.deconvolve_superres(_jx(data), _jx(PSF), F, _jx(w),
                                                     config=JaxDeconvConfig(max_iter=10, **cfg))
    for name, spec in ADMM.items():
        data, w, cfg, kw = _inputs(spec)
        out["admm", name] = jsr.admm_deconvolve_superres(_jx(data), _jx(PSF), F, _jx(w),
                                                         config=JaxDeconvConfig(**{"max_iter": 25, **cfg}), **kw)
    return out


def _assert_same_result(rt, rj):
    assert (rt.iterations, rt.evaluations, rt.status) == (int(rj.iterations), int(rj.evaluations), int(rj.status))
    assert _rel(rt.f, float(rj.f)) < SOLVE_RTOL
    assert _rel(rt.x.numpy(), rj.x) < SOLVE_RTOL
    fj = np.asarray(rj.f_history)
    np.testing.assert_array_equal(np.isnan(rt.f_history), np.isnan(fj))
    np.testing.assert_allclose(rt.f_history, fj, rtol=SOLVE_RTOL)


def test_bin_and_upsample_match_jax_and_are_adjoint():
    rng = np.random.default_rng(1)
    x, d = rng.random(FINE), rng.random(COARSE)
    xt, dt = torch.tensor(x), torch.tensor(d)
    assert _rel(tsr.bin_volume(xt, F).numpy(), jsr.bin_volume(jnp.asarray(x), F)) < DET_RTOL
    assert _rel(tsr.upsample_volume(dt, F).numpy(), jsr.upsample_volume(jnp.asarray(d), F)) < DET_RTOL
    np.testing.assert_allclose(tsr.bin_volume(tsr.upsample_volume(dt, F), F).numpy(), d, rtol=1e-12)
    lhs = float((tsr.bin_volume(xt, F) * dt).sum())
    rhs = float((xt * tsr.upsample_volume(dt, F) * np.prod(F)).sum())
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


@pytest.mark.parametrize("shape, factor", [((4, 8, 8), (1, 2, 2)), ((5, 7, 6), (2, 3, 2)), ((6, 6, 5), (2, 1, 3))])
def test_upsample_psf_matches_jax(shape, factor):
    """Even sizes take the halved-and-duplicated Nyquist bins, odd ones not;
    float32 goes through complex64, float64 through complex128."""
    p = np.random.default_rng(2).random(shape)
    up = tsr.upsample_psf(torch.tensor(p), factor)
    assert up.dtype == torch.float64 and up.shape == tuple(n * f for n, f in zip(shape, factor))
    assert _rel(up.numpy(), jsr.upsample_psf(jnp.asarray(p), factor)) < DET_RTOL
    up32 = tsr.upsample_psf(torch.tensor(p, dtype=torch.float32), factor)
    assert up32.dtype == torch.float32 and _rel(up32.numpy(), up.numpy()) < 1e-6


@pytest.mark.parametrize("case", OBJECTIVES)
def test_superres_objective_matches_jax(case, jax_refs):
    data, w, cfg, _ = _inputs(OBJECTIVES[case])
    obj = tsr.make_superres_objective(_tt(PSF), _tt(data), _tt(w), DeconvolutionConfig(**cfg), F)
    xt = torch.tensor(X, requires_grad=True)
    f = obj(xt)
    (g,) = torch.autograd.grad(f, xt)
    fj, gj = jax_refs["objective", case]
    assert _rel(f.item(), fj) < DET_RTOL
    assert _rel(g.numpy(), gj) < DET_RTOL


@pytest.mark.parametrize("case", VMLMB)
def test_deconvolve_superres_matches_jax(case, jax_refs):
    data, w, cfg, _ = _inputs(VMLMB[case])
    hv.launches = 0
    rt = tsr.deconvolve_superres(_tt(data), _tt(PSF), F, _tt(w), config=DeconvolutionConfig(max_iter=10, **cfg))
    assert hv.launches == 0  # CPU tensors: the plain version
    assert rt.x.shape == FINE and float(rt.x.min()) >= 0.0
    _assert_same_result(rt, jax_refs["vmlmb", case])


@pytest.mark.parametrize("case", ADMM)
def test_admm_superres_matches_jax(case, jax_refs):
    data, w, cfg, kw = _inputs(ADMM[case])
    ak.split_launches = ak.rhs_launches = 0
    rt = tsr.admm_deconvolve_superres(_tt(data), _tt(PSF), F, _tt(w),
                                      config=DeconvolutionConfig(**{"max_iter": 25, **cfg}), **kw)
    assert (ak.split_launches, ak.rhs_launches) == (0, 0)  # CPU tensors: the plain versions
    _assert_same_result(rt, jax_refs["admm", case])
    if case.endswith("converges"):
        assert rt.status == 0 and rt.iterations < cfg["max_iter"]


def test_superres_guards():
    data, psf = torch.tensor(DATA), torch.tensor(PSF)
    with pytest.raises(ValueError, match=r"\(1, 1, 1\)"):
        tsr.deconvolve_superres(data, psf, factor=(1, 1, 1))
    with pytest.raises(ValueError, match=">= 1"):
        tsr.deconvolve_superres(data, psf, factor=(0, 2, 2))
    with pytest.raises(ValueError, match="psf_fine shape"):
        tsr.deconvolve_superres(data, psf[:, :8, :8], factor=F)
    with pytest.raises(ValueError, match="var_shape"):
        tsr.admm_deconvolve_superres(data, psf, F, config=DeconvolutionConfig(var_shape=(4, 10, 10)))
    with pytest.raises(ValueError, match=r"\(Nz, Ny, Nx\)"):
        tsr.deconvolve_superres(data[None], psf, F)
    with pytest.raises(ValueError, match="does not compose"):
        tsr.deconvolve_superres(data, psf, F, torch.ones_like(data), config=DeconvolutionConfig(**POISSON))
    with pytest.raises(ValueError, match="mu\\*TV"):
        tsr.admm_deconvolve_superres(data, psf, F, config=DeconvolutionConfig(sparsity=0.1))
