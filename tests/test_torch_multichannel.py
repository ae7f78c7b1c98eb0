"""The port's joint multichannel and 5D solvers (``jobs/multichannel.py``,
``ops/regularization.joint_hyperbolic_tv``, and the ADMM engines
``admm_deconvolve_multichannel`` and ``admm_deconvolve_timeseries_multichannel``)
against the JAX package on the CPU (float64). Inputs come from numpy with a
seed and feed both packages: 2 timepoints x 2 channels of (6, 12, 12), each
channel blurred by its own Gaussian PSF, plus a 2x2 bleed-through mix
(README's ``0.85,0.25;0.15,0.75``) of the same scene.

Tolerances: the joint TV, its gradient and its Hessian-vector product,
``mixing_from_controls`` and every objective with its gradient to 1e-10
relative (measured 1e-13 at most); solver outputs, f and x, to 1e-5 relative
after a fixed iteration count (measured 1e-13 at most), with equal iteration
and evaluation counts, Boyd-stopped runs included. The reductions to the
time series and to the unmixed solve are port against port, to 1e-10. The
JAX references are computed once per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.jobs import admm as jadmm
from microtipi_tpu.jobs import multichannel as jmc
from microtipi_tpu.jobs.deconv import DeconvolutionConfig as JaxDeconvConfig
from microtipi_tpu.ops.regularization import joint_hyperbolic_tv as jax_joint_tv
from microtipi_tpu_torch.jobs import admm as tadmm
from microtipi_tpu_torch.jobs import multichannel as tmc
from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
from microtipi_tpu_torch.jobs.timeseries import deconvolve_timeseries
from microtipi_tpu_torch.ops.kernels import admm_split as ak
from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv
from microtipi_tpu_torch.ops.regularization import hyperbolic_tv, joint_hyperbolic_tv

T, C, VOL = 2, 2, (6, 12, 12)
OBJ_RTOL, SOLVE_RTOL = 1e-10, 1e-5
BASE = dict(mu=0.02, epsilon=0.1, grtol=0.0)
MIX = np.array([[0.85, 0.25], [0.15, 0.75]])
BOYD = dict(max_iter=200, admm_reltol=1e-2, admm_abstol=1e-6, admm_check_every=10)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tensors this small run fastest on one intra-op thread, and the suite
    runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _psf(w, shape=VOL):
    axes = [np.minimum(np.arange(n), n - np.arange(n)) for n in shape]
    psf = np.exp(-axes[0][:, None, None] ** 2 / w - axes[1][None, :, None] ** 2 / (1.5 * w)
                 - axes[2][None, None, :] ** 2 / (1.5 * w))
    return psf / psf.sum()


def _block():
    """(data, mixed, psfs, weights, bleach, x): the (T, C) block, its mixed
    version, one PSF a channel, weights with a zero-weight NaN voxel,
    per-frame-per-channel gains and a positive evaluation point."""
    rng = np.random.default_rng(0)
    psfs = np.stack([_psf(2.0), _psf(3.0)])
    truth = np.maximum(rng.standard_normal((T, C, *VOL)), 0.0) * 5.0
    blur = np.fft.irfftn(np.fft.rfftn(truth, axes=(2, 3, 4)) * np.fft.rfftn(psfs, axes=(1, 2, 3)), s=VOL,
                         axes=(2, 3, 4))
    data = blur + 0.1 * rng.standard_normal(blur.shape)
    mixed = np.einsum("ck,tkzyx->tczyx", MIX, blur) + 0.1 * rng.standard_normal(blur.shape)
    weights = rng.uniform(0.5, 2.0, data.shape)
    weights[0, 1, 0, 0, 0] = 0.0
    x = np.abs(data) + rng.uniform(0.0, 1.0, data.shape)
    return data, mixed, psfs, weights, np.array([[1.0, 0.9], [0.8, 0.7]]), x


DATA, MIXED, PSFS, WEIGHTS, BLEACH, X = _block()
COUNTS = np.random.default_rng(1).poisson(np.maximum(DATA, 0.0) * 3.0).astype(np.float64)
NAN_DATA = DATA.copy()
NAN_DATA[0, 1, 0, 0, 0] = np.nan  # under weight 0: excluded
POISSON = dict(data_term="poisson", background=1.0)


def _jx(a):
    return a if a is None or isinstance(a, (str, float, int)) else jnp.asarray(a)


def _tt(a):
    return a if a is None or isinstance(a, (str, float, int)) else torch.tensor(a)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _inputs(spec, five_d=True):
    """(data, weights, config fields, keywords) of a case as numpy; the
    multichannel cases take timepoint 0 of the block."""
    data = {"counts": COUNTS, "nan": NAN_DATA, "mixed": MIXED}.get(spec.get("data"), DATA)
    weights = WEIGHTS if spec.get("weighted") else None
    kw = dict(spec.get("kw", {}))
    if spec.get("mix"):
        kw["mixing"] = MIX
    if spec.get("bleach"):
        kw["bleach"] = BLEACH
    if not five_d:
        data, weights = data[0], None if weights is None else weights[0]
    return data, weights, {**BASE, **spec.get("config", {})}, kw


JOINT_TV = {
    "channels_first": dict(shape=(3, 5, 6, 7), kw=dict()),
    "couple_axis_1_scales": dict(shape=(2, 3, 5, 6, 7), kw=dict(couple_axis=1, axes=(-3, -2, -1),
                                                                 scales=(2.0, 1.0, 0.5))),
    "couple_last": dict(shape=(5, 6, 3), kw=dict(couple_axis=-1)),
}
OBJECTIVES = {
    "joint_quadratic_temporal": dict(kw=dict(coupling="joint", mu_t=0.05)),
    "separate_quadratic_bleach_sparsity": dict(bleach=True, config=dict(sparsity=0.01),
                                               kw=dict(coupling="separate", mu_t=0.05)),
    "joint_accurate_hessian": dict(config=dict(hessian=0.01), kw=dict(coupling="joint", accurate=True)),
    "mixed_quadratic": dict(data="mixed", mix=True, kw=dict(coupling="joint")),
    "mixed_accurate": dict(data="mixed", mix=True, kw=dict(coupling="joint", accurate=True)),
    "mixed_bleach_residual": dict(data="mixed", mix=True, bleach=True, kw=dict(coupling="separate")),
    "weighted_nan": dict(data="nan", weighted=True, kw=dict(coupling="joint", mu_t=0.05, epsilon_t=0.3)),
    "poisson_bleach": dict(data="counts", bleach=True, config=POISSON, kw=dict(coupling="separate", mu_t=0.05)),
}
VMLMB = {  # (5D?, spec)
    "mc_joint": (False, dict(kw=dict(coupling="joint"))),
    "mc_separate_mixing": (False, dict(data="mixed", mix=True, kw=dict(coupling="separate"))),
    "mc_weighted_single_psf": (False, dict(weighted=True, single_psf=True, kw=dict(coupling="joint"))),
    "5d_joint_temporal_bleach": (True, dict(bleach=True, kw=dict(coupling="joint", mu_t=0.05))),
    "5d_poisson_separate": (True, dict(data="counts", config=POISSON, kw=dict(coupling="separate", mu_t=0.05))),
}
ADMM = {
    "mc_joint": (False, dict(kw=dict(coupling="joint"))),
    "mc_separate_weighted": (False, dict(weighted=True, kw=dict(coupling="separate"))),
    "mc_mixing": (False, dict(data="mixed", mix=True, kw=dict(coupling="joint"))),
    "mc_untracked_scales": (False, dict(config=dict(scales=(2.0, 1.0, 1.5)),
                                        kw=dict(coupling="joint", track_objective=False))),
    "5d_separate_temporal_bleach": (True, dict(bleach=True, kw=dict(coupling="separate", mu_t=0.05))),
    "5d_joint_mixing_bleach": (True, dict(data="mixed", mix=True, bleach=True,
                                          kw=dict(coupling="joint", mu_t=0.05, over_relax=1.0))),
    "5d_poisson_joint": (True, dict(data="counts", config=POISSON, kw=dict(coupling="joint", mu_t=0.05))),
    "5d_joint_boyd_converges": (True, dict(config=BOYD, kw=dict(coupling="joint", mu_t=0.05))),  # at 140
    # The data split's residuals stay above the test (the JAX engine's too):
    # the budget runs out.
    "5d_weighted_nan_boyd_budget": (True, dict(data="nan", weighted=True, config=dict(BOYD, max_iter=40),
                                               kw=dict(coupling="separate", mu_t=0.05))),
}
_JAX_VMLMB = {False: jmc.deconvolve_multichannel, True: jmc.deconvolve_timeseries_multichannel}
_JAX_ADMM = {False: jadmm.admm_deconvolve_multichannel, True: jadmm.admm_deconvolve_timeseries_multichannel}
_VMLMB = {False: tmc.deconvolve_multichannel, True: tmc.deconvolve_timeseries_multichannel}
_ADMM = {False: tadmm.admm_deconvolve_multichannel, True: tadmm.admm_deconvolve_timeseries_multichannel}


def _psfs(spec):
    return PSFS[0] if spec.get("single_psf") else PSFS


@pytest.fixture(scope="module")
def jax_refs():
    """Every case's JAX result, computed once."""
    out = {}
    for name, spec in OBJECTIVES.items():
        data, w, cfg, kw = _inputs(spec)
        obj, _ = jmc.make_tsmc_objective(_jx(PSFS), _jx(data), _jx(w), JaxDeconvConfig(**cfg),
                                         **{k: _jx(v) for k, v in kw.items()})
        out["objective", name] = tuple(np.asarray(v) for v in jax.value_and_grad(obj)(jnp.asarray(X)))
    for table, fns, iters in (("vmlmb", _JAX_VMLMB, 10), ("admm", _JAX_ADMM, 25)):
        for name, (five_d, spec) in (VMLMB if table == "vmlmb" else ADMM).items():
            data, w, cfg, kw = _inputs(spec, five_d)
            out[table, name] = fns[five_d](_jx(data), _jx(_psfs(spec)), _jx(w),
                                           config=JaxDeconvConfig(**{"max_iter": iters, **cfg}),
                                           **{k: _jx(v) for k, v in kw.items()})
    return out


def _assert_same_result(rt, rj):
    """Counts and status equal; f, x and f_history to SOLVE_RTOL."""
    assert (rt.iterations, rt.evaluations, rt.status) == (int(rj.iterations), int(rj.evaluations), int(rj.status))
    assert _rel(rt.f, float(rj.f)) < SOLVE_RTOL
    assert _rel(rt.x.numpy(), rj.x) < SOLVE_RTOL
    fj = np.asarray(rj.f_history)
    np.testing.assert_array_equal(np.isnan(rt.f_history), np.isnan(fj))
    np.testing.assert_allclose(rt.f_history, fj, rtol=SOLVE_RTOL)


@pytest.mark.parametrize("case", JOINT_TV)
def test_joint_tv_matches_jax(case):
    """Value, gradient and a Hessian-vector product (the prior is plain
    PyTorch, differentiable twice)."""
    spec = JOINT_TV[case]
    rng = np.random.default_rng(2)
    x, v = rng.random(spec["shape"]), rng.standard_normal(spec["shape"])

    def jf(z):
        return jax_joint_tv(z, 0.3, **spec["kw"])

    fj, gj = jax.value_and_grad(jf)(jnp.asarray(x))
    hvj = jax.jvp(jax.grad(jf), (jnp.asarray(x),), (jnp.asarray(v),))[1]
    xt = torch.tensor(x, requires_grad=True)
    f = joint_hyperbolic_tv(xt, 0.3, **spec["kw"])
    (g,) = torch.autograd.grad(f, xt, create_graph=True)
    (hv_t,) = torch.autograd.grad(g, xt, torch.tensor(v))
    assert _rel(f.item(), float(fj)) < OBJ_RTOL
    assert _rel(g.detach().numpy(), gj) < OBJ_RTOL
    assert _rel(hv_t.numpy(), hvj) < OBJ_RTOL


def test_joint_tv_of_one_channel_is_the_tv():
    x = torch.tensor(np.random.default_rng(3).random((5, 6, 7)))
    np.testing.assert_allclose(joint_hyperbolic_tv(x[None], 0.3).item(), hyperbolic_tv(x, 0.3).item(), rtol=1e-12)
    with pytest.raises(ValueError, match="couple_axis"):
        joint_hyperbolic_tv(x[None], 0.3, axes=(0, 1), couple_axis=0)


def test_mixing_from_controls_matches_jax():
    rng = np.random.default_rng(4)
    controls = [rng.random((3, *VOL)) * s[:, None, None, None] for s in (np.array([1.0, 0.3, 0.05]),
                                                                          np.array([0.1, 1.0, 0.4]))]
    controls[0][0, 0, 0, 0] = -5.0  # below the floor: clipped
    m = tmc.mixing_from_controls([torch.tensor(c) for c in controls], device="cpu")
    assert m.dtype == torch.float64 and m.shape == (3, 2)
    assert _rel(m.numpy(), jmc.mixing_from_controls(controls)) < OBJ_RTOL
    with pytest.raises(ValueError, match="no positive flux"):
        tmc.mixing_from_controls([-np.ones((2, 3, 3))], device="cpu")
    with pytest.raises(ValueError, match=r"\(C,\) \+ volume"):
        tmc.mixing_from_controls([np.ones(3)], device="cpu")


@pytest.mark.parametrize("case", OBJECTIVES)
def test_tsmc_objective_matches_jax(case, jax_refs):
    data, w, cfg, kw = _inputs(OBJECTIVES[case])
    obj, aux = tmc.make_tsmc_objective(_tt(PSFS), _tt(data), _tt(w), DeconvolutionConfig(**cfg),
                                       **{k: _tt(v) for k, v in kw.items()})
    xt = torch.tensor(X, requires_grad=True)
    f = obj(xt)
    (g,) = torch.autograd.grad(f, xt)
    fj, gj = jax_refs["objective", case]
    assert _rel(f.item(), fj) < OBJ_RTOL
    assert _rel(g.numpy(), gj) < OBJ_RTOL
    assert aux["nk"] == C and bool(torch.isfinite(aux["data"]).all())


@pytest.mark.parametrize("case", VMLMB)
def test_multichannel_vmlmb_matches_jax(case, jax_refs):
    five_d, spec = VMLMB[case]
    data, w, cfg, kw = _inputs(spec, five_d)
    hv.batched_launches = 0
    rt = _VMLMB[five_d](_tt(data), _tt(_psfs(spec)), _tt(w), config=DeconvolutionConfig(max_iter=10, **cfg),
                        **{k: _tt(v) for k, v in kw.items()})
    assert hv.batched_launches == 0  # CPU tensors: the plain version
    assert rt.x.shape == data.shape and float(rt.x.min()) >= 0.0
    _assert_same_result(rt, jax_refs["vmlmb", case])


@pytest.mark.parametrize("case", ADMM)
def test_multichannel_admm_matches_jax(case, jax_refs):
    five_d, spec = ADMM[case]
    data, w, cfg, kw = _inputs(spec, five_d)
    ak.split_launches = ak.rhs_launches = 0
    rt = _ADMM[five_d](_tt(data), _tt(PSFS), _tt(w), config=DeconvolutionConfig(**{"max_iter": 25, **cfg}),
                       **{k: _tt(v) for k, v in kw.items()})
    assert (ak.split_launches, ak.rhs_launches) == (0, 0)  # CPU tensors: the plain versions
    _assert_same_result(rt, jax_refs["admm", case])
    if case.endswith("converges"):
        assert rt.status == 0 and rt.iterations < cfg["max_iter"]


@pytest.mark.parametrize("engine", ["vmlmb", "admm"])
def test_5d_single_channel_reduces_to_timeseries(engine):
    """C = 1 is the time series: the same objective and trajectory
    (tests/test_multichannel.py:237)."""
    data, w = torch.tensor(DATA[:, :1]), torch.tensor(WEIGHTS[:, 0])
    cfg, kw = DeconvolutionConfig(max_iter=10, **BASE), dict(mu_t=0.05, bleach=torch.tensor(BLEACH[:, :1]))
    ts_kw = dict(mu_t=0.05, bleach=torch.tensor(BLEACH[:, 0]))
    if engine == "vmlmb":
        five = tmc.deconvolve_timeseries_multichannel(data, torch.tensor(PSFS[0]), w[:, None], config=cfg,
                                                      coupling="separate", **kw)
        four = deconvolve_timeseries(data[:, 0], torch.tensor(PSFS[0]), w, config=cfg, **ts_kw)
    else:
        five = tadmm.admm_deconvolve_timeseries_multichannel(data, torch.tensor(PSFS[0]), w[:, None], config=cfg,
                                                             coupling="separate", **kw)
        four = tadmm.admm_deconvolve_timeseries(data[:, 0], torch.tensor(PSFS[0]), w, config=cfg, **ts_kw)
    assert (five.iterations, five.evaluations) == (four.iterations, four.evaluations)
    np.testing.assert_allclose(float(five.f), float(four.f), rtol=1e-10)
    np.testing.assert_allclose(five.x[:, 0].numpy(), four.x.numpy(), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("engine", ["vmlmb", "admm"])
def test_mixing_identity_reproduces_unmixed(engine):
    """``mixing = I`` is the unmixed solve (tests/test_multichannel.py:386).
    ADMM splits the data term under mixing, so its unmixed counterpart is
    the data-split path of unit weights (the same prox, rho0 = 1)."""
    cfg = DeconvolutionConfig(max_iter=10, **BASE)
    data, psfs = torch.tensor(DATA), torch.tensor(PSFS)
    if engine == "vmlmb":
        solve, weights = tmc.deconvolve_timeseries_multichannel, None
    else:
        solve, weights = tadmm.admm_deconvolve_timeseries_multichannel, torch.ones_like(data)
    plain = solve(data, psfs, weights, config=cfg, mu_t=0.05)
    mixed = solve(data, psfs, config=cfg, mu_t=0.05, mixing=torch.eye(C, dtype=torch.float64))
    np.testing.assert_allclose(float(mixed.f), float(plain.f), rtol=1e-8)
    assert _rel(mixed.x.numpy(), plain.x.numpy()) < 1e-6


def test_multichannel_guards():
    data, psfs = torch.tensor(DATA), torch.tensor(PSFS)
    with pytest.raises(ValueError, match=r"\(C, Nz, Ny, Nx\)"):
        tmc.deconvolve_multichannel(data, psfs)
    with pytest.raises(ValueError, match=r"\(C, Nz, Ny, Nx\)"):
        tadmm.admm_deconvolve_multichannel(data, psfs)
    with pytest.raises(ValueError, match=r"\(T, C, Nz, Ny, Nx\)"):
        tmc.deconvolve_timeseries_multichannel(data[0], psfs)
    with pytest.raises(ValueError, match="unknown coupling"):
        tmc.deconvolve_multichannel(data[0], psfs, coupling="color")
    with pytest.raises(ValueError, match="psfs must be"):
        tmc.deconvolve_multichannel(data[0], torch.stack([psfs[0]] * 3))
    with pytest.raises(ValueError, match="mixing must be"):
        tmc.deconvolve_multichannel(data[0], psfs, mixing=torch.ones(3, 2))
    with pytest.raises(ValueError, match="per-frame-per-channel"):
        tmc.deconvolve_timeseries_multichannel(data, psfs, bleach=torch.ones(T))
    with pytest.raises(ValueError, match="var_shape"):
        tmc.make_tsmc_objective(psfs, data, None, DeconvolutionConfig(var_shape=(8, 14, 14)))
    with pytest.raises(ValueError, match="does not compose"):
        tadmm.admm_deconvolve_multichannel(data[0], psfs, torch.ones_like(data[0]),
                                           config=DeconvolutionConfig(data_term="poisson"))
    with pytest.raises(ValueError, match="uniform Gaussian"):
        tadmm.admm_deconvolve_multichannel(data[0], psfs, torch.ones_like(data[0]), mixing=torch.eye(C))
    with pytest.raises(ValueError, match="uniform Gaussian"):
        tadmm.admm_deconvolve_timeseries_multichannel(data, psfs, config=DeconvolutionConfig(data_term="poisson"),
                                                      mixing=torch.eye(C))
    with pytest.raises(ValueError, match=r"poisson\+bleach"):
        tadmm.admm_deconvolve_timeseries_multichannel(data, psfs, config=DeconvolutionConfig(data_term="poisson"),
                                                      bleach=torch.ones(T, C))
    with pytest.raises(ValueError, match="mu\\*TV"):
        tadmm.admm_deconvolve_multichannel(data[0], psfs, config=DeconvolutionConfig(hessian=0.1))
    assert tmc.deconvolve_multichannel(data[0], psfs[0], config=DeconvolutionConfig(max_iter=2, **{
        k: v for k, v in BASE.items() if k != "grtol"})).x.shape == data[0].shape  # one PSF for every channel
