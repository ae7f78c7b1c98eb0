"""Discrepancy-principle auto-mu in the port against the JAX package on the
CPU (float64): ``estimate_noise_sigma`` (its median over an even and an odd
count), ``deconvolve_auto_mu`` with the Gaussian, weighted and Poisson
targets, and ``batched_deconvolve_auto_mu`` lane by lane. Inputs come from
numpy with a seed and feed both packages.

Tolerances: sigma to 1e-10 relative. The bisection is a chain of decisions
``d > target``, so each case first asserts that every probe's discrepancy is
more than 1e-6 relative from its target (float64 VMLMB trajectories of the
two packages part by up to 5.9e-8), then the same ``mu_history`` exactly,
the discrepancy history and the target to 1e-8 relative, and the final solve
at the bounds of tests/test_torch_slice.py (same iterations; f_history to
5e-7; x to 1e-6 relative L2). Batched lanes: the same ``mu_history`` as the
single solve of each lane, f to 1e-8 and x to 1e-6 relative L2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.jobs.autotune import deconvolve_auto_mu as jax_auto_mu
from microtipi_tpu.jobs.autotune import estimate_noise_sigma as jax_sigma
from microtipi_tpu.jobs.deconv import DeconvolutionConfig as JaxDeconvConfig
from microtipi_tpu_torch.jobs.autotune import deconvolve_auto_mu, estimate_noise_sigma
from microtipi_tpu_torch.jobs.batch import batched_deconvolve_auto_mu
from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig

SHAPE = (6, 12, 12)
MARGIN = 1e-6



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


def _scene(seed=0, lanes=None, noise=0.05):
    """Piecewise-constant blocks blurred by a compact PSF, plus Gaussian
    noise; a stack of ``lanes`` such scenes of growing noise when given."""
    rng = np.random.default_rng(seed)
    psf = np.zeros(SHAPE)
    psf[0, 0, 0], psf[0, 0, 1], psf[0, 1, 0], psf[1, 0, 0], psf[0, -1, 0] = 0.5, 0.15, 0.15, 0.1, 0.1

    def one(level):
        obj = np.zeros(SHAPE)
        obj[1:4, 2:8, 3:9] = 1.0
        obj[2:5, 6:11, 1:5] += 0.6
        blurred = np.fft.irfftn(np.fft.rfftn(obj) * np.fft.rfftn(psf), s=SHAPE, axes=(0, 1, 2))
        return blurred + level * rng.standard_normal(SHAPE)

    data = one(noise) if lanes is None else np.stack([one(noise * (1 + 0.5 * b)) for b in range(lanes)])
    return psf, data


@pytest.mark.parametrize("shape", [(4, 10, 12), (3, 9, 9)], ids=["even_count", "odd_count"])
def test_estimate_noise_sigma_matches_jax(shape):
    """4x8x10 = 320 residuals (jnp.median averages the two middle ones) and
    3x7x7 = 147."""
    data = np.random.default_rng(5).standard_normal(shape) * 2.0 + np.linspace(0, 5, shape[-1])
    got = float(estimate_noise_sigma(torch.tensor(data)))
    np.testing.assert_allclose(got, float(jax_sigma(jnp.asarray(data))), rtol=1e-10)


CASES = {
    "gaussian_blind_sigma_sparsity": (dict(epsilon=0.1, sparsity=0.02, max_iter=15, grtol=0.0), {}),
    "weighted_var_shape": (dict(epsilon=0.1, max_iter=15, grtol=0.0, var_shape=(8, 14, 12)), {"weighted": True}),
    "poisson": (dict(epsilon=0.1, max_iter=15, grtol=0.0, data_term="poisson", background=1.0), {"poisson": True}),
}


def _inputs(opts):
    psf, data = _scene()
    weights = None
    if opts.get("poisson"):
        data = np.random.default_rng(7).poisson(np.maximum(data, 0.0) * 20.0 + 1.0).astype(np.float64)
    if opts.get("weighted"):
        weights = np.random.default_rng(8).uniform(50.0, 400.0, SHAPE)
        weights[0, :2] = 0.0
    return psf, data, weights


@pytest.fixture(scope="module")
def jax_auto():
    """Each case's JAX ``deconvolve_auto_mu`` (6 probes of 10 iterations),
    once."""
    out = {}
    for name, (kw, opts) in CASES.items():
        psf, data, weights = _inputs(opts)
        out[name] = jax_auto_mu(jnp.asarray(data), jnp.asarray(psf),
                                weights=None if weights is None else jnp.asarray(weights),
                                config=JaxDeconvConfig(**kw), steps=6, search_max_iter=10)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_deconvolve_auto_mu_matches_jax(name, jax_auto):
    kw, opts = CASES[name]
    psf, data, weights = _inputs(opts)
    got = deconvolve_auto_mu(torch.tensor(data), torch.tensor(psf),
                             weights=None if weights is None else torch.tensor(weights),
                             config=DeconvolutionConfig(**kw), steps=6, search_max_iter=10)
    want = jax_auto[name]
    gaps = np.abs(got.discrepancy_history - got.target) / got.target
    assert gaps.min() > MARGIN, gaps
    np.testing.assert_array_equal(got.mu_history, np.asarray(want.mu_history))
    assert float(got.mu) == float(want.mu)
    np.testing.assert_allclose(got.target, float(want.target), rtol=1e-8)
    np.testing.assert_allclose(got.discrepancy_history, np.asarray(want.discrepancy_history), rtol=1e-8)
    np.testing.assert_allclose(got.discrepancy, float(want.discrepancy), rtol=1e-8)
    if np.isnan(float(want.sigma)):
        assert np.isnan(got.sigma)
    else:
        np.testing.assert_allclose(got.sigma, float(want.sigma), rtol=1e-10)
    r, w = got.result, want.result
    assert r.iterations == int(w.iterations)
    np.testing.assert_allclose(r.f_history, np.asarray(w.f_history), rtol=5e-7)
    assert _rel(r.x.numpy(), w.x) < 1e-6
    if kw.get("var_shape"):
        assert tuple(r.x.shape) == kw["var_shape"]


@pytest.mark.parametrize("sigma", [None, 0.06], ids=["blind_sigma", "shared_sigma"])
def test_batched_auto_mu_lanes_match_single(sigma):
    """Three lanes of growing noise: each lane's bisection is the single
    solve's, with a noise estimate of its own (or one shared sigma)."""
    psf, data = _scene(seed=1, lanes=3)
    cfg = DeconvolutionConfig(epsilon=0.1, sparsity=0.02, max_iter=10, grtol=0.0)
    got = batched_deconvolve_auto_mu(torch.tensor(data), torch.tensor(psf), config=cfg, steps=4, sigma=sigma)
    assert got.mu_history.shape == (3, 4) and got.result.x.shape == (3, *SHAPE)
    if sigma is None:
        assert len(set(got.sigma.tolist())) == 3 and len(set(got.mu.tolist())) > 1
    for b in range(3):
        one = deconvolve_auto_mu(torch.tensor(data[b]), torch.tensor(psf), config=cfg, steps=4, sigma=sigma)
        assert (np.abs(one.discrepancy_history - one.target) / one.target).min() > MARGIN
        np.testing.assert_array_equal(got.mu_history[b], one.mu_history)
        np.testing.assert_allclose([got.sigma[b], got.target[b]], [one.sigma, one.target], rtol=1e-12)
        np.testing.assert_allclose(got.result.f[b], one.result.f, rtol=1e-8)
        assert _rel(got.result.x[b].numpy(), one.result.x.numpy()) < 1e-6


def test_auto_mu_validates_like_jax():
    psf, data = _scene()
    d, p = torch.tensor(data), torch.tensor(psf)
    with pytest.raises(ValueError, match="steps"):
        deconvolve_auto_mu(d, p, steps=0)
    with pytest.raises(ValueError, match="bracket"):
        deconvolve_auto_mu(d, p, bracket=(1.0, 0.5))
    with pytest.raises(ValueError, match="unknown init"):
        deconvolve_auto_mu(d, p, init="zeros", steps=1)
    with pytest.raises(ValueError, match="4D"):
        batched_deconvolve_auto_mu(d, p)
