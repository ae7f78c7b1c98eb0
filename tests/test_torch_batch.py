"""The port's batched object step against the JAX package's vmapped one on
the CPU (float64), lane by lane, and against its own per-volume
``deconvolve``; the lockstep VMLMB driver. Inputs come from numpy with a
seed and feed both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.jobs.batch import batched_deconvolve as jax_batched
from microtipi_tpu.jobs.deconv import DeconvolutionConfig as JaxDeconvConfig
from microtipi_tpu.models.widefield import WideFieldConfig as JaxConfig
from microtipi_tpu.ops.convolution import convolve, convolve_spectrum
from microtipi_tpu_torch.jobs import batch as tbatch
from microtipi_tpu_torch.jobs.batch import batched_deconvolve
from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, deconvolve
from microtipi_tpu_torch.ops import convolution as conv
from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv
from microtipi_tpu_torch.optim.treeutil import value_and_grad
from microtipi_tpu_torch.optim.vmlmb import minimize_vmlmb, minimize_vmlmb_batched

SHAPE = (8, 32, 32)
KW = dict(na=1.2, wavelength=500e-9, ni=1.33, dxy=100e-9, dz=250e-9)


def _scene(b=3):
    """The scene of tests/test_batch.py:18-31: B boxes of rising brightness
    blurred by one widefield PSF, plus noise."""
    model = JaxConfig(shape=SHAPE, n_phase=3, radial=True, dtype=jnp.float64, **KW)
    psf = model.compute_psf(model.init_params())
    rng = np.random.default_rng(0)
    datas = []
    for i in range(b):
        o = np.zeros(SHAPE)
        o[2 + i : 6 + i, 8:24, 8:24] = 50.0 + 10 * i
        d = convolve(jnp.asarray(o), convolve_spectrum(psf), SHAPE)
        datas.append(np.asarray(d + 0.01 * jnp.asarray(rng.standard_normal(SHAPE))))
    return np.asarray(psf), np.stack(datas)


def _assert_lane_matches_jax(rt, rj, b):
    """The bound of tests/test_torch_slice.py::test_deconvolve_matches_jax:
    same iterations, evaluations and status; f_history to 1e-8 over the
    first five iterations and 5e-7 over all; x to 1e-6 relative L2 (float64
    FFT summation order, amplified late by the quadratic form's c/f)."""
    assert (rt.iterations[b], rt.evaluations[b], rt.status[b]) == (
        int(rj.iterations[b]), int(rj.evaluations[b]), int(rj.status[b]))
    fj = np.asarray(rj.f_history[b])
    np.testing.assert_allclose(rt.f_history[b][:6], fj[:6], rtol=1e-8)
    np.testing.assert_allclose(rt.f_history[b], fj, rtol=5e-7)
    x = rt.x[b].numpy()
    assert np.linalg.norm(x - np.asarray(rj.x[b])) / np.linalg.norm(x) < 1e-6


def _assert_lane_matches_single(rt, rs, b):
    """A lane against deconvolve of its volume: on the CPU each lane's FFTs
    are the single volume's, and at these sizes (below the parallel grain of
    a CPU reduction) the batched sums and dot products reduce each lane in
    the single volume's order, so the trajectory is the same, bit for bit."""
    assert (rt.iterations[b], rt.evaluations[b], rt.status[b]) == (rs.iterations, rs.evaluations, rs.status)
    np.testing.assert_array_equal(rt.f_history[b], rs.f_history)
    np.testing.assert_array_equal(rt.x[b].numpy(), rs.x.numpy())


def test_batched_deconvolve_matches_jax_per_lane():
    psf, datas = _scene()
    kw = dict(mu=0.002, epsilon=1.0, max_iter=10, grtol=0.0)
    rj = jax_batched(jnp.asarray(datas), jnp.asarray(psf), config=JaxDeconvConfig(**kw))
    hv.batched_launches = 0
    rt = batched_deconvolve(torch.tensor(datas), torch.tensor(psf), config=DeconvolutionConfig(**kw))
    assert rt.x.shape == datas.shape and rt.f.shape == rt.iterations.shape == (3,)
    assert rt.f_history.shape == (3, 11) and hv.batched_launches == 0  # CPU: the plain version
    for b in range(3):
        _assert_lane_matches_jax(rt, rj, b)


def test_lanes_stopping_at_different_iterations():
    """grtol > 0: the lanes converge at iterations 17, 29 and 17 (measured),
    so the lockstep driver runs on with fewer live lanes; each lane equals
    JAX's vmapped lane and the port's own deconvolve of that volume."""
    psf, datas = _scene()
    kw = dict(mu=0.002, epsilon=1.0, max_iter=30, grtol=3e-2)
    rj = jax_batched(jnp.asarray(datas), jnp.asarray(psf), config=JaxDeconvConfig(**kw))
    rt = batched_deconvolve(torch.tensor(datas), torch.tensor(psf), config=DeconvolutionConfig(**kw))
    assert len(set(rt.iterations.tolist())) > 1 and (rt.status == 0).all()
    for b in range(3):
        _assert_lane_matches_jax(rt, rj, b)
        rs = deconvolve(torch.tensor(datas[b]), torch.tensor(psf), config=DeconvolutionConfig(**kw))
        _assert_lane_matches_single(rt, rs, b)


def test_float32_lanes_part_from_deconvolve_by_the_fft_alone(monkeypatch):
    """Float32, where VMLMB trajectories are most sensitive to round-off.
    One batched inverse FFT rounds a lane otherwise than the transform of
    that volume alone (pocketfft here, cuFFT on the card), and the lanes
    part from deconvolve after a few iterations at the same cost. With each
    lane transformed on its own, every lane is deconvolve of its volume, bit
    for bit, the residual-form continuation included: the lockstep driver,
    the lane reductions and the TV add no rounding of their own."""
    psf, datas = _scene()
    cfg = DeconvolutionConfig(mu=0.002, epsilon=1.0, max_iter=15, grtol=0.0)
    data, kernel = torch.tensor(datas, dtype=torch.float32), torch.tensor(psf, dtype=torch.float32)
    singles = [deconvolve(data[b], kernel, config=cfg) for b in range(3)]
    rt = batched_deconvolve(data, kernel, config=cfg)
    for b, rs in enumerate(singles):
        np.testing.assert_allclose(rt.f_history[b, :4], rs.f_history[:4], rtol=1e-4)
    assert not all(torch.equal(rt.x[b], rs.x) for b, rs in enumerate(singles))

    rfftn, irfftn = conv._rfftn, conv._irfftn
    monkeypatch.setattr(conv, "_rfftn", lambda x: torch.stack([rfftn(v) for v in x]) if x.ndim == 4 else rfftn(x))
    monkeypatch.setattr(conv, "_irfftn", lambda z, s: torch.stack([irfftn(v, s) for v in z]) if z.ndim == 4
                        else irfftn(z, s))
    rt = batched_deconvolve(data, kernel, config=cfg)
    for b, rs in enumerate(singles):
        _assert_lane_matches_single(rt, rs, b)


def test_batched_weights_and_x0():
    """Batched weights (the weighted cost) and a batched warm start, per lane
    against JAX; unbounded, so the More-Thuente search runs."""
    psf, datas = _scene()
    rng = np.random.default_rng(1)
    w = rng.uniform(0.5, 1.5, datas.shape)
    w[:, :, :4] = 0.0
    x0 = np.abs(datas) + rng.uniform(0.0, 1.0, datas.shape)
    kw = dict(mu=0.002, epsilon=1.0, max_iter=8, grtol=0.0, positivity=False)
    rj = jax_batched(jnp.asarray(datas), jnp.asarray(psf), weights=jnp.asarray(w), x0=jnp.asarray(x0),
                     config=JaxDeconvConfig(**kw))
    rt = batched_deconvolve(torch.tensor(datas), torch.tensor(psf), weights=torch.tensor(w),
                            x0=torch.tensor(x0), config=DeconvolutionConfig(**kw))
    for b in range(3):
        _assert_lane_matches_jax(rt, rj, b)


@pytest.mark.parametrize("weighted", [False, True])
def test_batched_admm_engine_matches_jax_per_lane(weighted):
    """engine="admm" on the box scene: a fixed budget per lane, no tracking
    (f_history NaN past slot 0), each lane to 1e-8 of JAX's vmapped lane (an
    ADMM trajectory carries no line search to amplify the FFT libraries'
    summation order), with batched weights and a batched warm start."""
    psf, datas = _scene()
    rng = np.random.default_rng(3)
    w = rng.uniform(0.5, 1.5, datas.shape) if weighted else None
    x0 = np.abs(datas) + rng.uniform(0.0, 1.0, datas.shape) if weighted else None
    kw = dict(mu=0.002, epsilon=1.0, max_iter=10, grtol=0.0)
    as_jax = lambda a: None if a is None else jnp.asarray(a)
    as_torch = lambda a: None if a is None else torch.tensor(a)
    rj = jax_batched(jnp.asarray(datas), jnp.asarray(psf), weights=as_jax(w), x0=as_jax(x0),
                     config=JaxDeconvConfig(**kw), engine="admm")
    rt = batched_deconvolve(torch.tensor(datas), torch.tensor(psf), weights=as_torch(w), x0=as_torch(x0),
                            config=DeconvolutionConfig(**kw), engine="admm")
    assert rt.iterations.tolist() == [10, 10, 10] and rt.status.tolist() == [0, 0, 0]
    assert rt.f_history.shape == (3, 11) and np.isnan(rt.f_history[:, 1:]).all()
    np.testing.assert_allclose(rt.f_history[:, 0], np.asarray(rj.f_history)[:, 0], rtol=1e-8)
    np.testing.assert_allclose(rt.f, np.asarray(rj.f), rtol=1e-8)
    for b in range(3):
        x = rt.x[b].numpy()
        assert np.linalg.norm(x - np.asarray(rj.x[b])) / np.linalg.norm(x) < 1e-8


def test_batched_driver_at_one_lane_is_the_single_driver():
    """minimize_vmlmb_batched with B = 1 takes the same steps as
    minimize_vmlmb: identical trajectory, bitwise."""
    rng = np.random.default_rng(2)
    d = torch.tensor(rng.uniform(0.5, 4.0, 12))
    b = torch.tensor(rng.standard_normal(12))
    x0 = torch.tensor(rng.standard_normal(12))
    kw = dict(lower=0.0, maxiter=15, grtol=1e-8)

    def objective(v):  # per lane: sums over the last axis only
        return (0.5 * d * v * v - b * v + 0.1 * v ** 4).sum(-1)

    one = minimize_vmlmb(value_and_grad(objective), x0, **kw)
    (lane,) = minimize_vmlmb_batched(lambda x, lanes: value_and_grad(objective)(x), x0[None], **kw)
    assert (lane.iterations, lane.evaluations, lane.status) == (one.iterations, one.evaluations, one.status)
    np.testing.assert_array_equal(lane.f_history, one.f_history)
    assert torch.equal(lane.x, one.x)


def test_unported_and_unknown_entry_points():
    psf, datas = _scene(b=2)
    data, kernel = torch.tensor(datas), torch.tensor(psf)
    with pytest.raises(ValueError, match="a batch of volumes is 4D"):
        batched_deconvolve(data[0], kernel, engine="admm")
    with pytest.raises(ValueError, match="unknown engine"):
        batched_deconvolve(data, kernel, engine="sgd")
    # the batched blind loop is ported (tests/test_torch_batched_blind.py): it
    # takes a 4D batch
    with pytest.raises(ValueError, match="a batch of volumes is 4D"):
        tbatch.batched_blind_deconvolve(data[0], None)
    # the depth-varying batch is ported (tests/test_torch_depthvar.py): it
    # takes a (K,)+volume anchor stack and a 4D batch
    with pytest.raises(ValueError, match=r"\(K,\)\+volume stack"):
        tbatch.batched_deconvolve_depthvar(data, kernel)
    with pytest.raises(ValueError, match="a batch of volumes is 4D"):
        tbatch.batched_deconvolve_depthvar(data[0], kernel[None])
