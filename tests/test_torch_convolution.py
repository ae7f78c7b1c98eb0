"""Port FFT data terms against the JAX package (CPU, float64): cost and
gradient of the weighted, quadratic and uniform forms, with the object as
variable and with the PSF as variable (object as kernel) through
compute_psf; zero-weight NaN voxels; odd last axes; the Poisson deviance and
its cost. Tolerance 1e-10
relative: the same float64 arithmetic up to the FFT libraries' summation
order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.models.widefield import WideFieldConfig as JaxConfig
from microtipi_tpu.ops import convolution as jconv
from microtipi_tpu_torch.convert import config_from_fields, params_to_torch
from microtipi_tpu_torch.models.widefield import WideFieldModel
from microtipi_tpu_torch.ops import convolution as tconv
from microtipi_tpu_torch.optim.treeutil import value_and_grad

RTOL = 1e-10
KINDS = ["weighted", "quadratic", "uniform"]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _build(kind, pkg, kernel, data, weights):
    if kind == "weighted":
        return pkg.WeightedConvolutionCost.build(kernel, data, weights)
    cls = pkg.QuadraticConvCost if kind == "quadratic" else pkg.UniformConvCost
    return cls.build(kernel, data)


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    kernel = rng.random(shape) ** 4
    data = rng.random(shape) * 10
    weights = rng.random(shape)
    weights[rng.random(shape) < 0.2] = 0.0
    data[weights == 0] = np.nan  # zero weight must exclude a NaN voxel
    x = rng.random(shape) * 5
    return kernel, data, weights, x


@pytest.mark.parametrize("kind", KINDS)
def test_cost_and_gradient_object_variable(kind):
    kernel, data, weights, x = _inputs((6, 10, 9))
    if kind != "weighted":
        data = np.nan_to_num(data)
    jc = _build(kind, jconv, jnp.asarray(kernel), jnp.asarray(data), jnp.asarray(weights))
    tc = _build(kind, tconv, torch.tensor(kernel), torch.tensor(data), torch.tensor(weights))
    fj, gj = jax.value_and_grad(jc.cost)(jnp.asarray(x))
    ft, gt = value_and_grad(tc.cost)(torch.tensor(x))
    assert np.isfinite(float(ft))
    assert abs(float(ft) - float(fj)) / abs(float(fj)) < RTOL
    assert _rel(gt, gj) < RTOL


@pytest.mark.parametrize("kind", KINDS)
def test_gradient_psf_variable_through_compute_psf(kind):
    """The PSF fit's composition: the PSF is the variable, the object the
    kernel, and autograd carries the data term's gradient on to the pupil
    parameters."""
    shape = (8, 32, 32)
    jcfg = JaxConfig(shape=shape, na=1.4, wavelength=561e-9, ni=1.518, dxy=80e-9, dz=200e-9,
                     n_phase=6, n_modulus=3, dtype=jnp.float64)
    model = WideFieldModel(config_from_fields(jcfg), device="cpu")
    rng = np.random.default_rng(3)
    obj = rng.random(shape) * (rng.random(shape) > 0.9) * 100
    true = jcfg.init_params()._replace(phase=jnp.asarray(0.1 * rng.standard_normal(6)))
    data = np.asarray(jconv.convolve(jnp.asarray(obj), jconv.convolve_spectrum(jcfg.compute_psf(true)), shape))
    data = data + 0.05 * data.max() * rng.standard_normal(shape)  # keeps f >> eps * c
    weights = rng.random(shape) + 0.5
    jc = _build(kind, jconv, jnp.asarray(obj), jnp.asarray(data), jnp.asarray(weights))
    tc = _build(kind, tconv, torch.tensor(obj), torch.tensor(data), torch.tensor(weights))
    p0 = jcfg.init_params()
    fj, gj = jax.value_and_grad(lambda p: jc.cost(jcfg.compute_psf(p)))(p0)
    ft, gt = value_and_grad(lambda v: tc.cost(model.compute_psf(model.init_params()._replace(**v))))(
        dict(params_to_torch(p0)._asdict()))
    assert abs(float(ft) - float(fj)) / abs(float(fj)) < RTOL
    for name in ("defocus", "phase", "modulus"):
        assert _rel(gt[name], getattr(gj, name)) < RTOL, name


@pytest.mark.parametrize("shape", [(5, 6, 7), (4, 8, 9)])
def test_convolve_odd_last_axis(shape):
    kernel, _, _, x = _inputs(shape, seed=1)
    want = jconv.convolve(jnp.asarray(x), jconv.convolve_spectrum(jnp.asarray(kernel)), shape)
    got = tconv.convolve(torch.tensor(x), tconv.convolve_spectrum(torch.tensor(kernel)), shape)
    assert tuple(got.shape) == shape
    assert _rel(got, want) < RTOL
    model = tconv.WeightedConvolutionCost.build(torch.tensor(kernel), torch.tensor(x)).model(torch.tensor(x))
    assert _rel(model, want) < RTOL


@pytest.mark.parametrize("masked", [False, True])
def test_generalized_kl_matches_jax(masked):
    """d == 0 voxels contribute exactly m, m <= 0 is guarded at the dtype's
    smallest normal, a mask excludes voxels; a batch comes back per lane."""
    rng = np.random.default_rng(4)
    m = rng.uniform(0.1, 20.0, (3, 4, 5, 6))
    d = rng.poisson(m).astype(np.float64)
    m[0, 0, 0, :2] = [0.0, -1.0]
    mask = (rng.random(m.shape) > 0.3).astype(np.float64) if masked else None
    assert (d == 0).any()
    got = tconv.generalized_kl(torch.tensor(m), torch.tensor(d), None if mask is None else torch.tensor(mask))
    assert tuple(got.shape) == (3,)
    for b in range(3):
        want = jconv.generalized_kl(jnp.asarray(m[b]), jnp.asarray(d[b]), None if mask is None else jnp.asarray(mask[b]))
        assert abs(float(got[b]) - float(want)) / abs(float(want)) < RTOL
    one = tconv.generalized_kl(torch.tensor(m[1]), torch.tensor(d[1]))
    assert one.ndim == 0 and abs(float(one) - float(got[1])) / abs(float(one)) < (1.0 if masked else RTOL)
    same = tconv.generalized_kl(torch.tensor(d[1] + 1.0), torch.tensor(d[1] + 1.0))
    assert float(same) == 0.0  # equality at m == d


@pytest.mark.parametrize("background", [0.0, 2.5])
def test_poisson_cost_and_gradient_match_jax(background):
    kernel, _, _, x = _inputs((6, 10, 9), seed=2)
    kernel /= kernel.sum()
    rng = np.random.default_rng(5)
    data = rng.poisson(5.0 + 10 * rng.random(kernel.shape)).astype(np.float64)
    jc = jconv.PoissonConvCost.build(jnp.asarray(kernel), jnp.asarray(data), background)
    tc = tconv.PoissonConvCost.build(torch.tensor(kernel), torch.tensor(data), background)
    fj, gj = jax.value_and_grad(jc.cost)(jnp.asarray(x))
    ft, gt = value_and_grad(tc.cost)(torch.tensor(x))
    assert abs(float(ft) - float(fj)) / abs(float(fj)) < RTOL and _rel(gt, gj) < RTOL
    assert _rel(tc.model(torch.tensor(x)), jc.model(jnp.asarray(x))) < RTOL
    # a batch: per-lane costs, each lane's own gradient, and its lanes selected
    xb = torch.tensor(np.stack([x, 2.0 * x]))
    tb = tconv.PoissonConvCost.build(torch.tensor(kernel), torch.tensor(np.stack([data, data[::-1].copy()])), background)
    fb, gb = value_and_grad(tb.cost)(xb)
    assert tuple(fb.shape) == (2,) and abs(float(fb[0]) - float(fj)) / abs(float(fj)) < RTOL and _rel(gb[0], gj) < RTOL
    lane = tconv.select_lanes(tb, torch.tensor([1]))
    assert abs(float(lane.cost(xb[1:])[0]) - float(fb[1])) / abs(float(fb[1])) < RTOL
    with pytest.raises(ValueError, match="background must be >= 0"):
        tconv.PoissonConvCost.build(torch.tensor(kernel), torch.tensor(data), -1.0)
    with pytest.raises(ValueError, match="pad_fft_kernel"):
        tconv.PoissonConvCost.build(torch.tensor(kernel[:, :, :4]), torch.tensor(data))


def test_uniform_value_is_the_cost_without_its_gradient():
    """UniformConvCost.value: the residual-form cost from 2 FFTs, bitwise the
    3-FFT cost's value, on one volume and per lane."""
    kernel, data, _, x = _inputs((6, 10, 9), seed=3)
    data = np.nan_to_num(data)
    tc = tconv.UniformConvCost.build(torch.tensor(kernel), torch.tensor(data))
    assert torch.equal(tc.value(torch.tensor(x)), tc.cost(torch.tensor(x)))
    tb = tconv.UniformConvCost.build(torch.tensor(kernel), torch.tensor(np.stack([data, 2 * data])))
    xb = torch.tensor(np.stack([x, x]))
    assert torch.equal(tb.value(xb), tb.cost(xb)) and tuple(tb.value(xb).shape) == (2,)
