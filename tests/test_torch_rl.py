"""Richardson-Lucy in the port against the JAX package on the CPU (float64):
the Wiener-Butterworth backprojector, RL trajectories (matched, RL-TV,
Wiener-Butterworth, Biggs-Andrews accelerated, both discrepancy stops),
multi-view fusion, the batched lanes against single RL, and tiled RL.
Inputs come from numpy with a seed and feed both packages.

Tolerances: ``wb_backprojector`` to 1e-10 relative; every RL output to 1e-8
relative L2 after 20-30 iterations, with the same iteration count ``k``.
The discrepancy stops and the backprojector's support mask are decisions,
so each such case first asserts a margin far above the packages' 1e-14 gap:
``k`` unchanged when the target moves by 1e-6 relative either way, and no
|OTF|^2 within 1e-9 relative of the support threshold."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.jobs.richardson_lucy import multiview_richardson_lucy as jax_multiview
from microtipi_tpu.jobs.richardson_lucy import richardson_lucy as jax_rl
from microtipi_tpu.jobs.richardson_lucy import wb_backprojector as jax_wb
from microtipi_tpu.jobs.tiled import tiled_deconvolve as jax_tiled
from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
from microtipi_tpu_torch.jobs.richardson_lucy import multiview_richardson_lucy, richardson_lucy, wb_backprojector
from microtipi_tpu_torch.jobs.tiled import tiled_deconvolve

SHAPE = (8, 16, 16)
RTOL = 1e-8



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


def _psf(shape=SHAPE, wz=2.0, wxy=3.0):
    axes = [np.minimum(np.arange(n), n - np.arange(n)) for n in shape]
    psf = np.exp(-axes[0][:, None, None] ** 2 / wz - axes[1][None, :, None] ** 2 / wxy
                 - axes[2][None, None, :] ** 2 / wxy)
    return psf / psf.sum()


def _scenes(n=3, shape=SHAPE):
    """n smooth scenes (two Gaussian blobs) blurred by one PSF, with Gaussian
    noise of different levels, so the discrepancy stops end apart; and
    Poisson counts of the first one."""
    rng = np.random.default_rng(1)
    psf = _psf(shape)
    zz, yy, xx = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
    obj = 200 * np.exp(-((zz - 4) / 2.0) ** 2 - ((yy - 8) / 4.0) ** 2 - ((xx - 8) / 4.0) ** 2)
    obj = obj + 120 * np.exp(-((zz - 3) / 1.5) ** 2 - ((yy - 4) / 2.0) ** 2 - ((xx - 12) / 2.0) ** 2)
    blurred = np.fft.irfftn(np.fft.rfftn(obj) * np.fft.rfftn(psf), s=shape, axes=(0, 1, 2))
    noisy = np.stack([blurred + lvl * blurred.max() * rng.standard_normal(shape) for lvl in (0.08, 0.05, 0.12)[:n]])
    counts = rng.poisson(np.maximum(blurred, 0.0)).astype(np.float64)
    return psf, noisy, counts


CASES = {
    "matched": dict(iterations=30),
    "tv": dict(iterations=25, mu=0.01, epsilon=1.0),
    "wiener_butterworth": dict(iterations=20, backprojector="wiener-butterworth"),
    "accelerated": dict(iterations=25, accelerate=True),
    "wb_accelerated_tv": dict(iterations=20, backprojector="wiener-butterworth", accelerate=True, mu=0.02,
                              epsilon=1.0),
    "gaussian_blind_sigma": dict(iterations=30, stop="gaussian"),
    "gaussian_sigma_accelerated": dict(iterations=30, stop="gaussian", stop_sigma=11.0, accelerate=True),
    "poisson": dict(iterations=30, stop="poisson"),
}


def _data_of(name, noisy, counts):
    return counts if name == "poisson" else noisy[0]


@pytest.fixture(scope="module")
def jax_runs():
    """Each case's JAX (x, k), once."""
    psf, noisy, counts = _scenes()
    out = {}
    for name, kw in CASES.items():
        x, k = jax_rl(jnp.asarray(_data_of(name, noisy, counts)), jnp.asarray(psf), return_iterations=True, **kw)
        out[name] = (np.asarray(x), int(k))
    return psf, noisy, counts, out


def _port(data, psf, **kw):
    return richardson_lucy(torch.tensor(data), torch.tensor(psf), return_iterations=True, **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_richardson_lucy_matches_jax(name, jax_runs):
    psf, noisy, counts, want = jax_runs
    kw, data = CASES[name], _data_of(name, noisy, counts)
    x, k = _port(data, psf, **kw)
    want_x, want_k = want[name]
    assert k == want_k and _rel(x.numpy(), want_x) < RTOL and float(x.min()) >= 0.0
    if "stop" in kw:
        assert 0 < k < kw["iterations"]  # the stop decided, and the margin around it is wide
        for tau in (1.0 - 1e-6, 1.0 + 1e-6):
            assert _port(data, psf, **kw, stop_tau=tau)[1] == k


def test_wb_backprojector_matches_jax():
    psf = _psf()
    k_hat = np.fft.rfftn(psf)
    mag2 = np.abs(k_hat) ** 2
    threshold = (1e-2 * np.sqrt(mag2.flat[0])) ** 2
    assert np.min(np.abs(mag2 - threshold)) / threshold > 1e-9  # the support mask is not a coin toss
    want = np.asarray(jax_wb(jnp.asarray(k_hat), SHAPE))
    got = wb_backprojector(torch.tensor(k_hat), SHAPE).numpy()
    assert _rel(got, want) < 1e-10 and abs(got.flat[0] - 1.0) < 1e-12


@pytest.mark.parametrize("backprojector", ["matched", "wiener-butterworth"])
def test_multiview_matches_jax(backprojector):
    """Two views through complementary anisotropic PSFs, 20 iterations."""
    rng = np.random.default_rng(2)
    psfs = np.stack([_psf(wz=6.0, wxy=1.0), _psf(wz=1.0, wxy=6.0)])
    obj = rng.random(SHAPE) * (rng.random(SHAPE) > 0.85) * 100.0
    views = np.stack([np.fft.irfftn(np.fft.rfftn(obj) * np.fft.rfftn(p), s=SHAPE, axes=(0, 1, 2)) for p in psfs])
    views = views + 0.5 * rng.standard_normal(views.shape)
    kw = dict(iterations=20, backprojector=backprojector, background=0.5)
    want = np.asarray(jax_multiview(jnp.asarray(views), jnp.asarray(psfs), **kw))
    got = multiview_richardson_lucy(torch.tensor(views), torch.tensor(psfs), **kw).numpy()
    assert _rel(got, want) < RTOL


LANE_CASES = ["tv", "wb_accelerated_tv", "gaussian_blind_sigma", "gaussian_sigma_accelerated"]


@pytest.mark.parametrize("name", LANE_CASES)
def test_batched_lanes_match_single_rl(name):
    """Three lanes of different noise in one batched run, each against
    ``richardson_lucy`` of its volume: the same ``k`` (the stops end at
    different iterations, so finished lanes stay frozen) and x to 1e-8."""
    psf, noisy, _ = _scenes()
    kw = CASES[name]
    xs, ks = _port(noisy, psf, **kw)
    singles = [_port(v, psf, **kw) for v in noisy]
    assert ks.tolist() == [k for _, k in singles]
    if "stop" in kw:
        assert len(set(ks.tolist())) > 1
    for b, (x, _) in enumerate(singles):
        assert _rel(xs[b].numpy(), x.numpy()) < RTOL


def test_batched_lanes_take_one_psf_each():
    """A (B,) + volume stack of PSFs: lane b is RL through PSF b."""
    psf, noisy, _ = _scenes(n=2)
    psfs = np.stack([psf, _psf(wz=1.0, wxy=2.0)])
    xs = richardson_lucy(torch.tensor(noisy), torch.tensor(psfs), iterations=15, mu=0.01, epsilon=1.0)
    for b in range(2):
        one = richardson_lucy(torch.tensor(noisy[b]), torch.tensor(psfs[b]), iterations=15, mu=0.01, epsilon=1.0)
        assert _rel(xs[b].numpy(), one.numpy()) < RTOL


def test_tiled_rl_matches_jax():
    """``tiled_deconvolve(method="rl")`` with RL-TV (``config.mu`` > 0):
    16x48x48 in 4 tiles of 16x32x32 in batches of 3 (a ragged tail), against
    the JAX tiled RL."""
    rng = np.random.default_rng(3)
    shape = (16, 48, 48)
    psf = np.zeros(shape)
    psf[:2, :2, :2] = rng.random((2, 2, 2))
    psf /= psf.sum()
    obj = rng.random(shape) * (rng.random(shape) > 0.9) * 80.0
    data = np.fft.irfftn(np.fft.rfftn(obj) * np.fft.rfftn(psf), s=shape, axes=(0, 1, 2)) + 0.2
    kw = dict(tile=(16, 32, 32), overlap=4, method="rl", rl_iterations=12, max_batch=3)
    from microtipi_tpu.jobs.deconv import DeconvolutionConfig as JaxDeconvConfig

    want = jax_tiled(data, psf, config=JaxDeconvConfig(mu=0.01, epsilon=1.0), **kw)
    got = tiled_deconvolve(data, psf, config=DeconvolutionConfig(mu=0.01, epsilon=1.0), device="cpu", **kw)
    assert got.shape == shape and _rel(got, want) < RTOL


def test_rejects_what_jax_rejects():
    psf, noisy, _ = _scenes(n=1)
    d, p = torch.tensor(noisy[0]), torch.tensor(psf)
    with pytest.raises(ValueError, match="unknown stop"):
        richardson_lucy(d, p, stop="never")
    with pytest.raises(ValueError, match="unknown backprojector"):
        richardson_lucy(d, p, backprojector="adjoint")
    with pytest.raises(ValueError, match="psf shape"):
        richardson_lucy(d, p[:4])
    with pytest.raises(ValueError, match="share"):
        multiview_richardson_lucy(d[None], p[None, :4])
