"""The port's joint time-series solvers (``jobs/timeseries.py`` and
``jobs/admm.admm_deconvolve_timeseries``) against the JAX package on the CPU
(float64). Inputs come from numpy with a seed and feed both packages: 3
frames of (6, 12, 12), sparse rectified noise blurred by a Gaussian PSF, plus
noise, with per-frame gains and weights where a case asks.

Tolerances: the objective and its gradient to 1e-10 relative (measured
1e-13: the quadratic form's cancellation); solver outputs, f and x, to 1e-5
relative after a fixed iteration count (measured 1e-13 and below), and the
same iteration and evaluation counts, Boyd-stopped runs included. The JAX
references are computed once per module."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.jobs.admm import admm_deconvolve_timeseries as jax_admm_ts
from microtipi_tpu.jobs.deconv import DeconvolutionConfig as JaxDeconvConfig
from microtipi_tpu.jobs.timeseries import deconvolve_timeseries as jax_deconvolve_ts
from microtipi_tpu.jobs.timeseries import make_timeseries_objective as jax_ts_objective
from microtipi_tpu_torch.jobs.admm import admm_deconvolve, admm_deconvolve_timeseries
from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, make_batched_objective
from microtipi_tpu_torch.jobs.timeseries import deconvolve_timeseries, make_timeseries_objective
from microtipi_tpu_torch.ops.kernels import admm_split as ak
from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

T, VOL = 3, (6, 12, 12)
OBJ_RTOL, SOLVE_RTOL = 1e-10, 1e-5
BASE = dict(mu=0.02, epsilon=0.1, grtol=0.0)
BOYD = dict(max_iter=200, admm_reltol=1e-2, admm_abstol=1e-6, admm_check_every=10)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tensors this small run fastest on one intra-op thread, and the suite
    runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _psf(shape=VOL, w=2.0):
    axes = [np.minimum(np.arange(n), n - np.arange(n)) for n in shape]
    psf = np.exp(-axes[0][:, None, None] ** 2 / w - axes[1][None, :, None] ** 2 / (1.5 * w)
                 - axes[2][None, None, :] ** 2 / (1.5 * w))
    return psf / psf.sum()


def _series():
    """(data, psf, weights, bleach, x): the series, its PSF, weights with one
    zero-weight NaN voxel, fading gains, and a positive evaluation point."""
    rng = np.random.default_rng(0)
    psf = _psf()
    truth = np.maximum(rng.standard_normal((T, *VOL)), 0.0) * 5.0
    blur = np.fft.irfftn(np.fft.rfftn(truth, axes=(1, 2, 3)) * np.fft.rfftn(psf), s=VOL, axes=(1, 2, 3))
    data = blur + 0.1 * rng.standard_normal(blur.shape)
    weights = rng.uniform(0.5, 2.0, data.shape)
    weights[0, 0, 0, 0] = 0.0
    x = np.abs(data) + rng.uniform(0.0, 1.0, data.shape)
    return data, psf, weights, np.array([1.0, 0.8, 0.6]), x


DATA, PSF, WEIGHTS, BLEACH, X = _series()
COUNTS = np.random.default_rng(1).poisson(np.maximum(DATA, 0.0) * 3.0).astype(np.float64)
NAN_DATA = DATA.copy()
NAN_DATA[0, 0, 0, 0] = np.nan  # under weight 0: excluded


def _inputs(spec):
    """(data, weights, bleach, config fields, keywords) of a case as numpy."""
    data = {"counts": COUNTS, "nan": NAN_DATA}.get(spec.get("data"), DATA)
    weights = WEIGHTS if spec.get("weighted") else None
    bleach = BLEACH if spec.get("bleach") else None
    return data, weights, bleach, {**BASE, **spec.get("config", {})}, spec.get("kw", {})


def _jx(a):
    return None if a is None else jnp.asarray(a)


def _tt(a):
    return None if a is None else torch.tensor(a)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


POISSON = dict(data_term="poisson", background=1.0)
OBJECTIVES = {
    "quadratic": dict(kw=dict(mu_t=0.05)),
    "quadratic_bleach_priors": dict(bleach=True, config=dict(sparsity=0.01, hessian=0.01), kw=dict(mu_t=0.05)),
    "accurate": dict(kw=dict(mu_t=0.05, epsilon_t=0.3, accurate=True)),
    "weighted_bleach_nan": dict(data="nan", weighted=True, bleach=True, kw=dict(mu_t=0.05)),
    "poisson_bleach": dict(data="counts", bleach=True, config=POISSON, kw=dict(mu_t=0.05)),
    "scales_no_temporal": dict(config=dict(scales=(2.0, 1.0, 1.5))),
}
VMLMB = {
    "temporal": dict(kw=dict(mu_t=0.05)),
    "weighted_bleach": dict(weighted=True, bleach=True, kw=dict(mu_t=0.05, epsilon_t=0.3)),
    "poisson_bleach": dict(data="counts", bleach=True, config=POISSON, kw=dict(mu_t=0.05)),
}
ADMM = {
    "temporal": dict(kw=dict(mu_t=0.05)),
    "over_relax_1_rho1t": dict(kw=dict(mu_t=0.05, over_relax=1.0, rho1t=0.3)),
    "weighted_bleach_nan": dict(data="nan", weighted=True, bleach=True, kw=dict(mu_t=0.05)),
    "poisson": dict(data="counts", config=POISSON, kw=dict(mu_t=0.05)),
    "untracked_scales": dict(config=dict(scales=(2.0, 1.0, 1.5)), kw=dict(mu_t=0.05, track_objective=False)),
    "boyd_converges": dict(config=BOYD, kw=dict(mu_t=0.05)),
}


@pytest.fixture(scope="module")
def jax_refs():
    """Every case's JAX result, computed once: objectives (f, g) at X,
    VMLMB and ADMM results."""
    out = {}
    for name, spec in OBJECTIVES.items():
        data, w, bleach, cfg, kw = _inputs(spec)
        fg = jax_ts_objective(_jx(PSF), _jx(data), _jx(w), JaxDeconvConfig(**cfg), bleach=_jx(bleach), **kw)
        out["objective", name] = tuple(np.asarray(v) for v in fg(jnp.asarray(X)))
    for name, spec in VMLMB.items():
        data, w, bleach, cfg, kw = _inputs(spec)
        out["vmlmb", name] = jax_deconvolve_ts(_jx(data), _jx(PSF), _jx(w), config=JaxDeconvConfig(max_iter=10, **cfg),
                                               bleach=_jx(bleach), **kw)
    for name, spec in ADMM.items():
        data, w, bleach, cfg, kw = _inputs(spec)
        out["admm", name] = jax_admm_ts(_jx(data), _jx(PSF), _jx(w), config=JaxDeconvConfig(**{"max_iter": 25, **cfg}),
                                        bleach=_jx(bleach), **kw)
    return out


def _assert_same_result(rt, rj):
    """Counts and status equal; f, x and f_history to SOLVE_RTOL."""
    assert (rt.iterations, rt.evaluations, rt.status) == (int(rj.iterations), int(rj.evaluations), int(rj.status))
    assert _rel(rt.f, float(rj.f)) < SOLVE_RTOL
    assert _rel(rt.x.numpy(), rj.x) < SOLVE_RTOL
    fj = np.asarray(rj.f_history)
    np.testing.assert_array_equal(np.isnan(rt.f_history), np.isnan(fj))
    np.testing.assert_allclose(rt.f_history, fj, rtol=SOLVE_RTOL)


@pytest.mark.parametrize("case", OBJECTIVES)
def test_timeseries_objective_matches_jax(case, jax_refs):
    data, w, bleach, cfg, kw = _inputs(OBJECTIVES[case])
    fg = make_timeseries_objective(_tt(PSF), _tt(data), _tt(w), DeconvolutionConfig(**cfg), bleach=_tt(bleach), **kw)
    f, g = fg(torch.tensor(X))
    fj, gj = jax_refs["objective", case]
    assert _rel(f.item(), fj) < OBJ_RTOL
    assert _rel(g.numpy(), gj) < OBJ_RTOL


@pytest.mark.parametrize("case", VMLMB)
def test_deconvolve_timeseries_matches_jax(case, jax_refs):
    data, w, bleach, cfg, kw = _inputs(VMLMB[case])
    hv.batched_launches = 0
    rt = deconvolve_timeseries(_tt(data), _tt(PSF), _tt(w), config=DeconvolutionConfig(max_iter=10, **cfg),
                               bleach=_tt(bleach), **kw)
    assert hv.batched_launches == 0  # CPU tensors: the plain version
    assert rt.x.shape == (T, *VOL) and float(rt.x.min()) >= 0.0
    _assert_same_result(rt, jax_refs["vmlmb", case])


@pytest.mark.parametrize("case", ADMM)
def test_admm_timeseries_matches_jax(case, jax_refs):
    data, w, bleach, cfg, kw = _inputs(ADMM[case])
    ak.split_launches = ak.rhs_launches = 0
    rt = admm_deconvolve_timeseries(_tt(data), _tt(PSF), _tt(w), config=DeconvolutionConfig(**{"max_iter": 25, **cfg}),
                                    bleach=_tt(bleach), **kw)
    assert (ak.split_launches, ak.rhs_launches) == (0, 0)  # CPU tensors: the plain versions
    rj = jax_refs["admm", case]
    _assert_same_result(rt, rj)
    if case == "boyd_converges":
        assert rt.status == 0 and rt.iterations < BOYD["max_iter"]


def test_admm_timeseries_mu_t_zero_equals_per_frame():
    """mu_t = 0 decouples the frames: the 4D engine's trajectory equals the
    per-frame ``admm_deconvolve`` over T lanes (tests/test_admm.py:305)."""
    cfg = DeconvolutionConfig(max_iter=25, **BASE)
    joint = admm_deconvolve_timeseries(torch.tensor(DATA), torch.tensor(PSF), config=cfg)
    per = admm_deconvolve(torch.tensor(DATA), torch.tensor(PSF), config=cfg)
    np.testing.assert_allclose(joint.x.numpy(), per.x.numpy(), atol=1e-10)
    np.testing.assert_allclose(float(joint.f), per.f.sum(), rtol=1e-10)
    np.testing.assert_allclose(joint.f_history, per.f_history.sum(0), rtol=1e-10)


@pytest.mark.parametrize("weighted", [False, True])
def test_timeseries_objective_without_temporal_prior_sums_the_batch(weighted):
    """At mu_t = 0 the joint objective is the sum of the batched object
    step's per-frame objectives, and its gradient theirs."""
    cfg = DeconvolutionConfig(sparsity=0.01, **BASE)
    w = torch.tensor(WEIGHTS) if weighted else None
    f, g = make_timeseries_objective(torch.tensor(PSF), torch.tensor(DATA), w, cfg)(torch.tensor(X))
    fb, gb = make_batched_objective(torch.tensor(PSF), torch.tensor(DATA), w, cfg)(torch.tensor(X), range(T))
    np.testing.assert_allclose(f.item(), fb.sum().item(), rtol=OBJ_RTOL)
    assert _rel(g.numpy(), gb.numpy()) < OBJ_RTOL


def test_timeseries_guards():
    data, psf = torch.tensor(DATA), torch.tensor(PSF)
    with pytest.raises(ValueError, match=r"\(T, Nz, Ny, Nx\)"):
        deconvolve_timeseries(data[0], psf)
    with pytest.raises(ValueError, match=r"\(T, Nz, Ny, Nx\)"):
        admm_deconvolve_timeseries(data[0], psf)
    with pytest.raises(ValueError, match="per-frame gains"):
        deconvolve_timeseries(data, psf, bleach=torch.ones(T + 1))
    with pytest.raises(ValueError, match="var_shape"):
        make_timeseries_objective(psf, data, None, DeconvolutionConfig(var_shape=(8, 14, 14)))
    with pytest.raises(ValueError, match="does not compose"):
        deconvolve_timeseries(data, psf, torch.ones_like(data), config=DeconvolutionConfig(data_term="poisson"))
    with pytest.raises(ValueError, match=r"poisson\+bleach"):
        admm_deconvolve_timeseries(data, psf, config=DeconvolutionConfig(data_term="poisson"), bleach=torch.ones(T))
    with pytest.raises(ValueError, match="mu\\*TV"):
        admm_deconvolve_timeseries(data, psf, config=DeconvolutionConfig(sparsity=0.1))
    with pytest.raises(ValueError, match="unknown data_term"):
        make_timeseries_objective(psf, data, None, DeconvolutionConfig(data_term="laplace"))
