"""The sparse-deconvolution priors, the padded variable grid and the plain
regularization cost of the port against the JAX package on the CPU
(float64). Inputs come from numpy with a seed and feed both packages.

Tolerances: the priors and ``regularization_cost`` (values and gradients)
to 1e-10 relative; ``deconvolve`` and the batched lanes at the bounds of
tests/test_torch_slice.py::test_deconvolve_matches_jax (same iterations,
evaluations and status; f_history to 1e-8 over the first six values and
5e-7 over all; x to 1e-6 relative L2); the blind loop on a padded grid at
the bound of tests/test_torch_slice.py::test_blind_matches_jax (1e-6
relative)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.jobs.blind import BlindDeconvConfig as JaxBlindConfig
from microtipi_tpu.jobs.blind import blind_deconvolve as jax_blind
from microtipi_tpu.jobs.deconv import DeconvolutionConfig as JaxDeconvConfig
from microtipi_tpu.jobs.deconv import deconvolve as jax_deconvolve
from microtipi_tpu.jobs.deconv import regularization_cost as jax_regularization_cost
from microtipi_tpu.jobs.psf_fit import PsfFitConfig as JaxFitConfig
from microtipi_tpu.models.widefield import WideFieldConfig as JaxConfig
from microtipi_tpu.ops import regularization as jreg
from microtipi_tpu.weights import updaters as jweights
from microtipi_tpu_torch import convert
from microtipi_tpu_torch.jobs.batch import batched_deconvolve
from microtipi_tpu_torch.jobs.blind import blind_deconvolve
from microtipi_tpu_torch.jobs.deconv import (
    DeconvolutionConfig,
    deconvolve,
    has_regularizer,
    make_regularizer,
    regularization_cost,
)
from microtipi_tpu_torch.models.microscope import DEFOCUS, PHASE
from microtipi_tpu_torch.models.widefield import WideFieldModel
from microtipi_tpu_torch.ops import regularization as treg

RTOL = 1e-10
SHAPE = (8, 16, 16)



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tensors this small run fastest on one intra-op thread, and the suite
    runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b))


def _volume(shape=SHAPE, seed=0):
    return np.random.default_rng(seed).standard_normal(shape) * 3.0


def _scene(shape=SHAPE, seed=0, lanes=None):
    """Sparse blocks blurred by a separable Gaussian PSF plus noise; a
    (lanes,) + shape stack of such scenes when ``lanes`` is given."""
    rng = np.random.default_rng(seed)
    axes = [np.minimum(np.arange(n), n - np.arange(n)) for n in shape]
    psf = np.exp(-axes[0][:, None, None] ** 2 / 2.0 - axes[1][None, :, None] ** 2 / 3.0
                 - axes[2][None, None, :] ** 2 / 3.0)
    psf /= psf.sum()

    def one():
        obj = rng.random(shape) * (rng.random(shape) > 0.9) * 50.0
        data = np.fft.irfftn(np.fft.rfftn(obj) * np.fft.rfftn(psf), s=shape, axes=(0, 1, 2))
        return data + 0.3 * rng.standard_normal(shape)

    return psf, (one() if lanes is None else np.stack([one() for _ in range(lanes)]))


PRIOR_CASES = [("smoothed_l1", {}), ("smoothed_l1", dict(stack=True))] + [
    (fn, kw) for fn in ("hyperbolic_hessian", "hyperbolic_tv_and_gradient")
    for kw in (dict(), dict(scales=(2.0, 1.0, 0.5)), dict(axes=(-3, -2, -1), stack=True))]


@pytest.mark.parametrize("fn,kw", PRIOR_CASES, ids=[f"{fn}-{'-'.join(kw) or 'plain'}" for fn, kw in PRIOR_CASES])
def test_priors_match_jax(fn, kw):
    """Values and gradients to 1e-10; ``axes=(-3, -2, -1)`` on a 4D stack
    leaves the batch axis undifferenced."""
    kw = dict(kw)
    x = _volume((3,) + SHAPE if kw.pop("stack", False) else SHAPE)
    jfn, tfn = getattr(jreg, fn), getattr(treg, fn)
    if fn == "hyperbolic_tv_and_gradient":
        fj, gj = jfn(jnp.asarray(x), 0.3, **kw)
        ft, gt = tfn(torch.tensor(x), 0.3, **kw)
    else:
        fj, gj = jax.value_and_grad(lambda v: jfn(v, 0.3, **kw))(jnp.asarray(x))
        xt = torch.tensor(x, requires_grad=True)
        ft = tfn(xt, 0.3, **kw)
        (gt,) = torch.autograd.grad(ft, xt)
    np.testing.assert_allclose(float(ft.detach()), float(fj), rtol=RTOL)
    assert _rel(gt.numpy(), gj) < RTOL


def test_hessian_prior_is_zero_on_a_ramp_interior():
    """The Hessian penalty vanishes on affine ramps away from the replicate
    boundary face (``regularization.py:149-150``)."""
    z, y, x = np.meshgrid(*(np.arange(n, dtype=np.float64) for n in SHAPE), indexing="ij")
    ramp = torch.tensor(2.0 * z - 0.5 * y + 3.0 * x)
    terms = treg.hessian_terms(ramp, 0.1)
    assert float(terms[:-2, :-2, :-2].abs().max()) < 1e-12 and float(treg.hyperbolic_hessian(ramp, 0.1)) > 0


PRIOR_CONFIGS = [
    dict(mu=0.02, epsilon=0.5, sparsity=0.1),
    dict(mu=0.0, epsilon=0.5, hessian=0.05, scales=(2.0, 1.0, 1.0)),
    dict(mu=0.01, epsilon=0.5, sparsity=0.2, sparsity_epsilon=0.05, hessian=0.03),
]


@pytest.mark.parametrize("kw", PRIOR_CONFIGS)
def test_regularization_cost_matches_jax(kw):
    """``regularization_cost`` (plain, no kernel) value and gradient to
    1e-10, on a volume and with ``axes`` on a stack; ``make_regularizer``
    per lane of a stack against the JAX value of each volume."""
    x = np.abs(_volume((3,) + SHAPE))
    jc, tc = JaxDeconvConfig(**kw), DeconvolutionConfig(**kw)
    for v, axes in ((x[0], None), (x, (-3, -2, -1))):
        fj, gj = jax.value_and_grad(lambda u: jax_regularization_cost(u, jc, axes=axes))(jnp.asarray(v))
        vt = torch.tensor(v, requires_grad=True)
        ft = regularization_cost(vt, tc, axes=axes)
        (gt,) = torch.autograd.grad(ft, vt)
        np.testing.assert_allclose(float(ft.detach()), float(fj), rtol=RTOL)
        assert _rel(gt.numpy(), gj) < RTOL
    lanes = make_regularizer(tc)(torch.tensor(x)).numpy()
    want = [float(jax_regularization_cost(jnp.asarray(v), jc)) for v in x]
    np.testing.assert_allclose(lanes, want, rtol=RTOL)
    assert has_regularizer(tc) and not has_regularizer(DeconvolutionConfig(mu=0.0))


DECONV_CASES = {
    "priors": dict(mu=0.01, epsilon=1.0, sparsity=0.05, hessian=0.02),
    "var_shape": dict(mu=0.01, epsilon=1.0, var_shape=(10, 20, 20)),
    "priors_var_shape_sparsity_epsilon": dict(mu=0.0, epsilon=1.0, sparsity=0.1, sparsity_epsilon=0.1,
                                              hessian=0.05, var_shape=(12, 20, 18)),
}


@pytest.fixture(scope="module")
def jax_solves():
    """Each case's JAX ``deconvolve`` of lanes 0 and 1 of one stack, once."""
    psf, data = _scene(lanes=2)
    out = {}
    for name, kw in DECONV_CASES.items():
        cfg = JaxDeconvConfig(**kw, max_iter=10, grtol=0.0, gatol=0.0)
        out[name] = [jax_deconvolve(jnp.asarray(d), jnp.asarray(psf), config=cfg) for d in data]
    return psf, data, out


def _check_solve(got, want):
    assert (got.iterations, got.evaluations, got.status) == (int(want.iterations), int(want.evaluations),
                                                             int(want.status))
    np.testing.assert_allclose(got.f_history[:6], np.asarray(want.f_history)[:6], rtol=1e-8)
    np.testing.assert_allclose(got.f_history, np.asarray(want.f_history), rtol=5e-7)
    assert _rel(got.x.numpy(), want.x) < 1e-6


@pytest.mark.parametrize("name", list(DECONV_CASES))
def test_deconvolve_with_priors_and_var_shape_matches_jax(name, jax_solves):
    psf, data, want = jax_solves
    cfg = DeconvolutionConfig(**DECONV_CASES[name], max_iter=10, grtol=0.0, gatol=0.0)
    got = deconvolve(torch.tensor(data[0]), torch.tensor(psf), config=cfg)
    if cfg.var_shape is not None:
        assert tuple(got.x.shape) == cfg.var_shape
    _check_solve(got, want[name][0])


@pytest.mark.parametrize("name", list(DECONV_CASES))
def test_batched_lanes_carry_priors_and_var_shape(name, jax_solves):
    """``batched_deconvolve`` (the JAX package vmaps ``deconvolve``): each
    lane against the JAX solve of its volume."""
    psf, data, want = jax_solves
    cfg = DeconvolutionConfig(**DECONV_CASES[name], max_iter=10, grtol=0.0, gatol=0.0)
    res = batched_deconvolve(torch.tensor(data), torch.tensor(psf), config=cfg)
    for b in range(2):
        lane = res._replace(x=res.x[b], f=res.f[b], iterations=int(res.iterations[b]),
                            evaluations=int(res.evaluations[b]), status=int(res.status[b]),
                            f_history=res.f_history[b], pg_history=res.pg_history[b])
        _check_solve(lane, want[name][b])


def test_float32_stall_gate_needs_the_unpadded_grid():
    """The float32 continuation runs only where the quadratic form ran: not
    on a padded grid (``deconv.py:415-419``)."""
    from microtipi_tpu_torch.jobs.deconv import stall_gate

    data = torch.zeros(SHAPE, dtype=torch.float32)
    assert stall_gate(DeconvolutionConfig(), data, None)
    assert not stall_gate(DeconvolutionConfig(var_shape=(10, 16, 16)), data, None)
    assert not stall_gate(DeconvolutionConfig(), data.double(), None)


def test_deconv_config_from_fields_carries_the_priors_and_grid():
    jcfg = JaxDeconvConfig(mu=0.02, sparsity=0.3, hessian=0.04, sparsity_epsilon=0.005, var_shape=(10, 20, 20),
                           fused_tv=True, exact_fft=False)
    tcfg = convert.deconv_config_from_fields(jcfg)
    assert (tcfg.sparsity, tcfg.hessian, tcfg.sparsity_epsilon, tcfg.var_shape) == (0.3, 0.04, 0.005, (10, 20, 20))
    names = {f.name for f in dataclasses.fields(tcfg)}
    assert {f.name for f in dataclasses.fields(jcfg)} - names == {"fused_tv", "mem_dtype", "exact_fft"}


@pytest.mark.parametrize("weighted", [False, True])
def test_blind_on_var_shape_matches_jax(weighted):
    """Two rounds of the blind loop with the object on a padded grid and the
    PSF fits on the data window (``jobs/blind.py:294-345``); ``weighted``
    re-estimates inverse-variance weights for the fits from the model on the
    padded grid. The JAX config crosses over through
    ``convert.blind_config_from_fields``."""
    shape, var_shape = (6, 24, 24), (8, 28, 28)
    cfg = JaxConfig(shape=shape, na=1.2, wavelength=500e-9, ni=1.33, dxy=100e-9, dz=200e-9, n_phase=3,
                    dtype=jnp.float64)
    rng = np.random.default_rng(4)
    truth = rng.random(shape) * (rng.random(shape) > 0.97) * 50.0
    psf = np.asarray(cfg.compute_psf(cfg.init_params()._replace(phase=jnp.asarray([0.3, -0.2, 0.1]))))
    data = np.fft.irfftn(np.fft.rfftn(truth) * np.fft.rfftn(psf), s=shape, axes=(0, 1, 2))
    data += 0.01 * data.max() * rng.standard_normal(shape)
    jcfg = JaxBlindConfig(loops=2, families=(DEFOCUS, PHASE), psf_max_iter=(4, 4), fit=JaxFitConfig(grtol=0.0),
                          deconv=JaxDeconvConfig(mu=0.01, epsilon=1.0, max_iter=8, grtol=0.0, gatol=0.0,
                                                 var_shape=var_shape))
    jmodel = jweights.InverseVarianceWeights(gain=2.0, readout_variance=0.5) if weighted else None
    rj = jax_blind(jnp.asarray(data), cfg, weight_updater=jmodel and jmodel.update, config=jcfg)
    tu = convert.weights_from_fields(jmodel).update if weighted else None
    model = WideFieldModel(convert.config_from_fields(cfg), device="cpu")
    rt = blind_deconvolve(torch.tensor(data), model, weight_updater=tu, config=convert.blind_config_from_fields(jcfg))
    assert tuple(rt.obj.shape) == var_shape == tuple(rj.obj.shape)
    np.testing.assert_allclose(rt.deconv_f, np.asarray(rj.deconv_f), rtol=1e-6)
    assert np.isnan(rt.fit_f[-1]).all() and np.isfinite(rt.fit_f[:-1]).all()
    np.testing.assert_allclose(rt.fit_f, np.asarray(rj.fit_f), rtol=1e-6)
    np.testing.assert_array_equal(rt.deconv_iters, np.asarray(rj.deconv_iters))
    for name in ("defocus", "phase"):
        got, want = getattr(rt.params, name).numpy(), np.asarray(getattr(rj.params, name))
        assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 1e-6, name
    assert _rel(rt.obj.numpy(), rj.obj) < 1e-6
