"""The port's ADMM and FISTA object engines (``jobs/admm.py``), its Poisson
object step and its weight models against the JAX package on the CPU
(float64). Inputs come from numpy with a seed and feed both packages: the
band-limited periodic problem of tests/test_admm.py:19-39 at (6, 12, 12) and
(8, 16, 16). Bounds: an ADMM or FISTA trajectory (``f_history``, ``x``) to
1e-8 relative after 25 iterations (measured: 1e-15, the same float64
arithmetic up to the FFT libraries' summation order, and an ADMM iteration is
a contraction, so nothing amplifies it); the same ``iterations`` and
``status`` under Boyd stopping; the weight models to 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.jobs.admm import admm_deconvolve as jax_admm
from microtipi_tpu.jobs.admm import fista_deconvolve as jax_fista
from microtipi_tpu.jobs.batch import batched_deconvolve as jax_batched
from microtipi_tpu.jobs.blind import BlindDeconvConfig as JaxBlindConfig
from microtipi_tpu.jobs.blind import blind_deconvolve as jax_blind
from microtipi_tpu.jobs.deconv import DeconvolutionConfig as JaxDeconvConfig
from microtipi_tpu.jobs.deconv import deconvolve as jax_deconvolve
from microtipi_tpu.jobs.psf_fit import PsfFitConfig as JaxFitConfig
from microtipi_tpu.models.widefield import WideFieldConfig as JaxConfig
from microtipi_tpu.weights import updaters as jweights
from microtipi_tpu_torch import convert
from microtipi_tpu_torch.jobs import admm as tadmm
from microtipi_tpu_torch.jobs.admm import admm_deconvolve, fista_deconvolve
from microtipi_tpu_torch.jobs.batch import batched_deconvolve
from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig, blind_deconvolve
from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, deconvolve, make_objective
from microtipi_tpu_torch.models.microscope import DEFOCUS, PHASE
from microtipi_tpu_torch.models.widefield import WideFieldModel
from microtipi_tpu_torch.ops.kernels import admm_split as ak
from microtipi_tpu_torch.weights import updaters as tweights

RTOL = 1e-8
KW = dict(mu=0.02, epsilon=0.1, max_iter=25, grtol=0.0)
BOYD = dict(admm_reltol=1e-2, admm_abstol=1e-6)


def _periodic_problem(seed, shape=(6, 12, 12), noise=0.01):
    """tests/test_admm.py:19-39 from a numpy seed: a band-limited periodic
    truth blurred by a Gaussian PSF, plus noise."""
    rng = np.random.default_rng(seed)
    k = np.meshgrid(np.fft.fftfreq(shape[0]), np.fft.fftfreq(shape[1]), np.fft.rfftfreq(shape[2]), indexing="ij")
    spec = np.fft.rfftn(rng.standard_normal(shape)) * np.exp(-30 * sum(ki ** 2 for ki in k))
    truth = np.fft.irfftn(spec, s=shape, axes=(0, 1, 2))
    truth = np.maximum(truth - truth.mean(), 0.0) * 10.0
    zz, yy, xx = np.meshgrid(*(np.arange(n) - n // 2 for n in shape), indexing="ij")
    g = np.exp(-(zz ** 2 + yy ** 2 + xx ** 2) / 3.0)
    psf = np.fft.ifftshift(g / g.sum())
    data = np.fft.irfftn(np.fft.rfftn(truth) * np.fft.rfftn(psf), s=shape, axes=(0, 1, 2))
    return data + noise * data.max() * rng.standard_normal(shape), psf, truth


def _jx(a):
    return None if a is None else jnp.asarray(a)


def _tt(a):
    return None if a is None else torch.tensor(a)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _assert_same_run(rt, rj, lane=None):
    """Iterations, status, the NaN layout of f_history, and f_history, f, x
    to RTOL; ``lane`` picks one lane of batched results on both sides."""
    pick = (lambda v: v) if lane is None else (lambda v: v[lane])
    assert (int(pick(rt.iterations)), int(pick(rt.evaluations)), int(pick(rt.status))) == (
        int(pick(rj.iterations)), int(pick(rj.evaluations)), int(pick(rj.status)))
    ft, fj = pick(rt.f_history), np.asarray(pick(rj.f_history))
    np.testing.assert_array_equal(np.isnan(ft), np.isnan(fj))
    np.testing.assert_allclose(ft, fj, rtol=RTOL)
    assert np.isnan(pick(rt.pg_history)).all()
    np.testing.assert_allclose(float(pick(rt.f)), float(pick(rj.f)), rtol=RTOL)
    assert _rel(pick(rt.x).numpy(), pick(rj.x)) < RTOL


CASES = {
    "uniform": dict(),
    "over_relax_1": dict(engine=dict(over_relax=1.0)),
    "positivity_off": dict(config=dict(positivity=False)),
    "scales": dict(config=dict(scales=(2.0, 1.0, 1.5))),
    "weighted": dict(weighted=True),
    "weighted_over_relax_1": dict(weighted=True, engine=dict(over_relax=1.0)),
    "poisson": dict(config=dict(data_term="poisson", background=2.0), poisson=True),
    "adaptive_rho": dict(engine=dict(adaptive_rho=True, rho1=200.0, rho2=200.0)),
    "adaptive_rho_weighted": dict(weighted=True, engine=dict(adaptive_rho=True, rho1=200.0, rho2=200.0)),
    "explicit_rhos": dict(weighted=True, engine=dict(rho0=0.7, rho1=0.5, rho2=0.1)),
    "warm_start": dict(x0=True),
    "track_off": dict(engine=dict(track_objective=False)),
    "boyd_converges": dict(config=dict(max_iter=120, admm_check_every=10, **BOYD)),  # stops at 100 (measured)
    "boyd_budget_weighted": dict(weighted=True, config=dict(max_iter=40, admm_check_every=7, **BOYD)),
    "boyd_adaptive_poisson": dict(poisson=True, engine=dict(adaptive_rho=True), config=dict(
        data_term="poisson", background=2.0, max_iter=60, admm_check_every=20, **BOYD)),
}


@pytest.mark.parametrize("case", CASES)
def test_admm_matches_jax(case):
    spec = CASES[case]
    data, psf, truth = _periodic_problem(1)
    rng = np.random.default_rng(2)
    if spec.get("poisson"):
        lam = np.fft.irfftn(np.fft.rfftn(truth * 3.0) * np.fft.rfftn(psf), s=data.shape, axes=(0, 1, 2))
        data = rng.poisson(np.maximum(lam, 0.0) + 2.0).astype(np.float64)
    w = rng.uniform(0.5, 3.0, data.shape) if spec.get("weighted") else None
    x0 = np.abs(data) + rng.uniform(0.0, 1.0, data.shape) if spec.get("x0") else None
    kw, ekw = {**KW, **spec.get("config", {})}, spec.get("engine", {})
    rj = jax_admm(_jx(data), _jx(psf), weights=_jx(w), x0=_jx(x0), config=JaxDeconvConfig(**kw), **ekw)
    ak.split_launches = ak.rhs_launches = 0
    rt = admm_deconvolve(_tt(data), _tt(psf), weights=_tt(w), x0=_tt(x0), config=DeconvolutionConfig(**kw), **ekw)
    assert (ak.split_launches, ak.rhs_launches) == (0, 0)  # CPU tensors: the plain versions
    _assert_same_run(rt, rj)
    n = kw["max_iter"]
    assert rt.f_history.shape == (n + 1,) and rt.x.shape == data.shape and isinstance(rt.iterations, int)
    if case == "track_off":
        assert np.isfinite(rt.f_history[0]) and np.isnan(rt.f_history[1:]).all()
    if case == "boyd_converges":
        assert rt.status == 0 and rt.iterations < n and rt.iterations % 10 == 0
        assert np.isfinite(rt.f_history[: rt.iterations + 1]).all() and np.isnan(rt.f_history[rt.iterations + 1:]).all()
    if case.startswith("boyd_budget"):
        assert (rt.status, rt.iterations) == (1, n)
    if kw.get("positivity", True):
        assert float(rt.x.min()) >= 0.0


def test_admm_reports_the_solver_objective_and_descends():
    """tests/test_admm.py:170 and :74: the reported f is make_objective's
    value at the returned x (the last tracked value, since the output is z2),
    and the history falls."""
    data, psf, _ = _periodic_problem(6)
    cfg = DeconvolutionConfig(**{**KW, "max_iter": 40})
    w = torch.tensor(np.random.default_rng(3).uniform(0.5, 3.0, data.shape))
    for weights in (None, w):
        res = admm_deconvolve(_tt(data), _tt(psf), weights=weights, config=cfg)
        f_check, _ = make_objective(_tt(psf), _tt(data), weights, cfg)(res.x)
        np.testing.assert_allclose(float(res.f), float(f_check), rtol=1e-10)
        np.testing.assert_allclose(float(res.f), res.f_history[-1], rtol=1e-12)
        assert np.isfinite(res.f_history).all() and res.f_history[-1] < res.f_history[0]
        assert res.f_history[-1] <= res.f_history[10]


def test_batched_lanes_are_their_own_solves_and_jax_vmapped_lanes():
    """Three lanes under Boyd stopping, which stop at iterations 100, 90 and
    at the budget of 120 (measured): each lane is frozen when it stops, equals its unbatched solve (iterations equal, x to 1e-10:
    tests/test_admm.py:713-721; measured bitwise) and JAX's vmapped lane."""
    probs = [_periodic_problem(s, noise=n) for s, n in ((1, 0.01), (3, 0.002), (4, 0.01))]
    data, psf = np.stack([p[0] for p in probs]), probs[0][1]
    kw = dict(mu=0.02, epsilon=0.1, max_iter=120, grtol=0.0, admm_check_every=10, **BOYD)
    rj = jax_batched(_jx(data), _jx(psf), config=JaxDeconvConfig(**kw), engine="admm")
    rt = batched_deconvolve(_tt(data), _tt(psf), config=DeconvolutionConfig(**kw), engine="admm")
    assert rt.x.shape == data.shape and rt.f.shape == rt.iterations.shape == rt.status.shape == (3,)
    assert len(set(rt.iterations.tolist())) == 3 and rt.status.tolist() == [0, 0, 1]
    assert np.isnan(rt.f_history[:, 1:]).all()  # batched_deconvolve does not track the objective
    for b in range(3):
        _assert_same_run(rt, rj, lane=b)
        rs = admm_deconvolve(_tt(data[b]), _tt(psf), config=DeconvolutionConfig(**kw), track_objective=False)
        assert (rs.iterations, rs.status) == (rt.iterations[b], rt.status[b])
        np.testing.assert_allclose(rt.x[b].numpy(), rs.x.numpy(), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(rt.f[b], rs.f, rtol=1e-12)


def test_batched_weights_x0_per_lane_psf_and_tracking():
    """A batch with weights, a warm start and one PSF per lane, tracked:
    each lane against the unbatched engine on that lane's inputs."""
    probs = [_periodic_problem(s, shape=(8, 16, 16)) for s in (4, 5)]
    data = np.stack([p[0] for p in probs])
    psfs = np.stack([probs[0][1], np.roll(probs[0][1], 1, axis=2)])
    rng = np.random.default_rng(7)
    w, x0 = rng.uniform(0.5, 3.0, data.shape), np.abs(data) + rng.uniform(0.0, 1.0, data.shape)
    cfg = DeconvolutionConfig(**{**KW, "max_iter": 12})
    rt = admm_deconvolve(_tt(data), _tt(psfs), weights=_tt(w), x0=_tt(x0), config=cfg, adaptive_rho=True)
    assert rt.f_history.shape == (2, 13) and np.isfinite(rt.f_history).all()
    for b in range(2):
        rs = admm_deconvolve(_tt(data[b]), _tt(psfs[b]), weights=_tt(w[b]), x0=_tt(x0[b]), config=cfg,
                             adaptive_rho=True)
        np.testing.assert_allclose(rt.f_history[b], rs.f_history, rtol=1e-10)
        np.testing.assert_allclose(rt.x[b].numpy(), rs.x.numpy(), rtol=1e-10, atol=1e-12)


def test_zero_weight_nan_exclusion():
    """tests/test_admm.py:520: a NaN under weight 0 poisons nothing (the data
    is masked before the default x0 is derived)."""
    data, psf, _ = _periodic_problem(50)
    w = np.ones_like(data)
    w[0, 0, 0] = 0.0
    bad = data.copy()
    bad[0, 0, 0] = np.nan
    cfg = DeconvolutionConfig(**{**KW, "max_iter": 10})
    res = admm_deconvolve(_tt(bad), _tt(psf), weights=_tt(w), config=cfg)
    assert bool(torch.isfinite(res.x).all()) and np.isfinite(res.f) and np.isfinite(res.f_history).all()
    rj = jax_admm(_jx(bad), _jx(psf), weights=_jx(w), config=JaxDeconvConfig(**{**KW, "max_iter": 10}))
    _assert_same_run(res, rj)


def test_engine_guards():
    data, psf = torch.zeros((4, 8, 8)), torch.zeros((4, 8, 8))
    psf[0, 0, 0] = 1.0
    with pytest.raises(ValueError, match="Gaussian"):
        fista_deconvolve(data, psf, config=DeconvolutionConfig(data_term="poisson"))
    with pytest.raises(ValueError, match="mu\\*TV"):
        admm_deconvolve(data, psf, config=DeconvolutionConfig(sparsity=0.1))
    with pytest.raises(ValueError, match="mu\\*TV"):
        admm_deconvolve(data, psf, config=DeconvolutionConfig(hessian=0.1))
    with pytest.raises(ValueError, match="padded-variable"):
        fista_deconvolve(data, psf, config=DeconvolutionConfig(var_shape=(8, 8, 8)))
    with pytest.raises(ValueError, match="padded-variable"):
        admm_deconvolve(data, psf, config=DeconvolutionConfig(var_shape=(8, 8, 8)))
    with pytest.raises(ValueError, match="must be >= 0"):
        admm_deconvolve(data, psf, config=DeconvolutionConfig(admm_reltol=-1.0))
    with pytest.raises(ValueError, match="do not compose"):
        admm_deconvolve(data, psf, weights=torch.ones_like(data), config=DeconvolutionConfig(data_term="poisson"))
    with pytest.raises(ValueError, match="3D volume or a 4D batch"):
        admm_deconvolve(data[0], psf[0])
    with pytest.raises(ValueError, match="one 3D volume"):
        fista_deconvolve(data[None], psf)
    assert tadmm._admm_tolerances(DeconvolutionConfig(admm_check_every=0, admm_abstol=1e-6)) == (1e-6, 0.0, 1, True)
    assert tadmm._admm_tolerances(DeconvolutionConfig())[2:] == (20, False)
    for fn in (tadmm.admm_deconvolve_timeseries, tadmm.admm_deconvolve_multichannel,
               tadmm.admm_deconvolve_timeseries_multichannel):
        with pytest.raises(ValueError, match="expected a"):
            fn(data, psf)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("track", [True, False])
def test_fista_matches_jax(weighted, track):
    data, psf, _ = _periodic_problem(3)
    w = np.random.default_rng(4).uniform(0.5, 2.0, data.shape) if weighted else None
    rj = jax_fista(_jx(data), _jx(psf), weights=_jx(w), config=JaxDeconvConfig(**KW), track_objective=track)
    rt = fista_deconvolve(_tt(data), _tt(psf), weights=_tt(w), config=DeconvolutionConfig(**KW),
                          track_objective=track)
    _assert_same_run(rt, rj)
    assert (rt.iterations, rt.evaluations) == (25, 50) and float(rt.x.min()) >= 0.0
    if track:  # the monotone safeguard: the history never increases
        assert (np.diff(rt.f_history) <= 1e-9 * np.abs(rt.f_history[:-1]) + 1e-12).all()


def test_poisson_deconvolve_matches_jax():
    """``deconvolve`` with the Poisson data term (VMLMB through autograd of
    the generalized KL deviance): the bound of
    tests/test_torch_slice.py::test_deconvolve_matches_jax."""
    _, psf, truth = _periodic_problem(10)
    lam = np.fft.irfftn(np.fft.rfftn(truth * 3.0) * np.fft.rfftn(psf), s=truth.shape, axes=(0, 1, 2))
    data = np.random.default_rng(10).poisson(np.maximum(lam, 0.0) + 2.0).astype(np.float64)
    kw = dict(mu=0.02, epsilon=0.1, data_term="poisson", background=2.0, max_iter=10, grtol=0.0, gatol=0.0)
    rj = jax_deconvolve(_jx(data), _jx(psf), config=JaxDeconvConfig(**kw))
    rt = deconvolve(_tt(data), _tt(psf), config=DeconvolutionConfig(**kw))
    assert (int(rj.iterations), int(rj.evaluations), int(rj.status)) == (rt.iterations, rt.evaluations, rt.status)
    np.testing.assert_allclose(rt.f_history[:6], np.asarray(rj.f_history)[:6], rtol=1e-8)
    np.testing.assert_allclose(rt.f_history, np.asarray(rj.f_history), rtol=5e-7)
    assert _rel(rt.x.numpy(), rj.x) < 1e-6
    with pytest.raises(ValueError, match="unknown data_term"):
        deconvolve(_tt(data), _tt(psf), config=DeconvolutionConfig(data_term="huber"))
    # The priors and the padded grid compose with the Poisson term
    # (tests/test_torch_priors.py holds them against JAX).
    for extra in (dict(sparsity=0.1), dict(hessian=0.1), dict(var_shape=(12, 20, 20))):
        res = deconvolve(_tt(data), _tt(psf), config=DeconvolutionConfig(**{**kw, "max_iter": 2}, **extra))
        assert np.isfinite(res.f) and tuple(res.x.shape) == extra.get("var_shape", data.shape)


def _blind_scene():
    """tests/test_admm.py:207-219 from a numpy seed."""
    shape = (6, 24, 24)
    cfg = JaxConfig(shape=shape, na=1.2, wavelength=500e-9, ni=1.33, dxy=100e-9, dz=200e-9, n_phase=3,
                    n_modulus=1, radial=True, dtype=jnp.float64)
    rng = np.random.default_rng(3)
    truth = rng.random(shape) * (rng.random(shape) > 0.97) * 50.0
    psf = np.asarray(cfg.compute_psf(cfg.init_params()._replace(phase=jnp.asarray([0.3, -0.2, 0.1]))))
    data = np.fft.irfftn(np.fft.rfftn(truth) * np.fft.rfftn(psf), s=shape, axes=(0, 1, 2))
    return cfg, data + 0.01 * data.max() * rng.standard_normal(shape)


@pytest.mark.parametrize("recipe", ["constant_mu", "recommended_weight_updater"])
def test_blind_admm_matches_jax(recipe):
    """Two rounds of the blind loop with the ADMM object step, at the bound
    of tests/test_torch_slice.py::test_blind_matches_jax (1e-6 relative); the
    recommended recipe (wiener start, annealed mu) with the inverse-variance
    weight updater feeding the fits. The JAX config crosses over through
    convert.blind_config_from_fields."""
    cfg, data = _blind_scene()
    kw = dict(loops=2, families=(DEFOCUS, PHASE), psf_max_iter=(4, 4), deconv_engine="admm",
              deconv=JaxDeconvConfig(mu=0.01, epsilon=1.0, max_iter=15, grtol=0.0, gatol=0.0),
              fit=JaxFitConfig(grtol=0.0))
    if recipe == "constant_mu":
        jcfg, ju, tu = JaxBlindConfig(joint_fit=True, **kw), None, None
    else:
        jcfg = JaxBlindConfig.recommended(**kw)
        jmodel = jweights.InverseVarianceWeights(gain=2.0, readout_variance=0.5)
        ju, tu = jmodel.update, convert.weights_from_fields(jmodel).update
    tcfg = convert.blind_config_from_fields(jcfg)
    assert tcfg.deconv_engine == "admm" and tcfg.mu_schedule == jcfg.mu_schedule and tcfg.init == jcfg.init
    assert tcfg == (BlindDeconvConfig.recommended if recipe != "constant_mu" else BlindDeconvConfig)(
        **{**kw, "deconv": convert.deconv_config_from_fields(kw["deconv"]), "fit": tcfg.fit},
        **({"joint_fit": True} if recipe == "constant_mu" else {}))
    rj = jax_blind(_jx(data), cfg, weight_updater=ju, config=jcfg)
    model = WideFieldModel(convert.config_from_fields(cfg), device="cpu")
    rt = blind_deconvolve(_tt(data), model, weight_updater=tu, config=tcfg)
    np.testing.assert_allclose(rt.deconv_f, np.asarray(rj.deconv_f), rtol=1e-6)
    assert np.isnan(rt.fit_f[-1]).all() and np.isfinite(rt.fit_f[:-1]).all()
    np.testing.assert_allclose(rt.fit_f, np.asarray(rj.fit_f), rtol=1e-6)
    np.testing.assert_array_equal(rt.deconv_iters, [15, 15])
    for name in ("defocus", "phase"):
        got, want = getattr(rt.params, name).numpy(), np.asarray(getattr(rj.params, name))
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-6, name
    assert _rel(rt.obj.numpy(), rj.obj) < 1e-6 and float(rt.obj.min()) >= 0.0


def test_blind_engine_guards():
    with pytest.raises(ValueError, match="unknown deconv_engine"):
        BlindDeconvConfig(deconv_engine="lbfgs")
    for bad in (dict(sparsity=0.1), dict(hessian=0.1), dict(var_shape=(8, 8, 8))):
        with pytest.raises(ValueError, match="plain TV objective"):
            BlindDeconvConfig(deconv_engine="admm", deconv=DeconvolutionConfig(**bad))
    assert BlindDeconvConfig.recommended(deconv_engine="admm", loops=3).mu_schedule == (0.64, 0.16, 0.04)


@pytest.mark.parametrize("gain,saturation", [(2.0, None), (0.0, None), (1.5, 40.0)])
def test_inverse_variance_weights_match_jax(gain, saturation):
    rng = np.random.default_rng(8)
    data = rng.uniform(-5.0, 60.0, (4, 9, 10))
    data[0, 0, :3] = [np.nan, np.inf, -np.inf]
    model = rng.uniform(-1.0, 50.0, data.shape)
    jm = jweights.InverseVarianceWeights(gain=gain, readout_variance=0.7, saturation=saturation)
    tm = convert.weights_from_fields(jm)
    assert (tm.gain, tm.readout_variance, tm.saturation) == (gain, 0.7, saturation)
    for got, want in ((tm.from_data(_tt(data)), jm.from_data(_jx(data))),
                      (tm.update(_tt(model), _tt(data)), jm.update(_jx(model), _jx(data))),
                      (tweights.validity_mask(_tt(data), saturation), jweights.validity_mask(_jx(data), saturation))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=0)
    assert float(tm.update(_tt(model), _tt(data))[0, 0, :3].abs().max()) == 0.0  # excluded voxels


@pytest.mark.parametrize("shape", [(4, 16, 16), (3, 40, 48), (40, 48)])
def test_noise_estimators_match_jax(shape):
    """``laplacian_residuals`` to 1e-10; ``estimate_gain_readout`` to 1e-8 (a
    sort-based quantile in place of ``jnp.quantile``, the same linear
    interpolation), on Poisson-Gaussian data with dynamic range."""
    rng = np.random.default_rng(9)
    mean = 20.0 + 200.0 * rng.random(shape)
    data = rng.poisson(mean * 2.0) / 2.0 + 1.5 * rng.standard_normal(shape)
    for got, want in zip(tweights.laplacian_residuals(_tt(data)), jweights.laplacian_residuals(_jx(data))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)
    got, want = tweights.estimate_gain_readout(_tt(data)), jweights.estimate_gain_readout(_jx(data))
    np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want], rtol=1e-8)
    with pytest.raises(ValueError, match="2D image or 3D stack"):
        tweights.laplacian_residuals(torch.zeros(2, 3, 4, 5))


def test_deconv_config_crosses_over_by_field():
    jcfg = JaxDeconvConfig(mu=0.3, data_term="poisson", background=1.5, admm_abstol=1e-5, admm_reltol=1e-4,
                           admm_check_every=7, scales=(2.0, 1.0, 1.0), fused_tv=False, exact_fft=True)
    tcfg = convert.deconv_config_from_fields(jcfg)
    assert tcfg == DeconvolutionConfig(mu=0.3, data_term="poisson", background=1.5, admm_abstol=1e-5,
                                       admm_reltol=1e-4, admm_check_every=7, scales=(2.0, 1.0, 1.0))
    assert (DeconvolutionConfig().admm_abstol, DeconvolutionConfig().admm_reltol,
            DeconvolutionConfig().admm_check_every, DeconvolutionConfig().background) == (0.0, 0.0, 20, 0.0)
