"""The batched forms of the port's array helpers and FFT data terms: a 4D
tensor is a stack of 3D volumes (lanes). Each lane against the JAX package's
single-volume function (CPU, float64), with one kernel shared by the batch
and with one kernel per lane; the 3D forms stay as they were."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.ops import convolution as jconv
from microtipi_tpu.utils import arrays as ja
from microtipi_tpu_torch.ops import convolution as tconv
from microtipi_tpu_torch.optim.treeutil import value_and_grad
from microtipi_tpu_torch.utils import arrays as ta

# The same float64 arithmetic up to the FFT libraries' summation order, the
# bound of tests/test_torch_convolution.py.
RTOL = 1e-10
KINDS = ["weighted", "quadratic", "uniform"]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("shape", [(3, 5, 7, 9), (2, 4, 6, 8)])
def test_array_helpers_on_trailing_axes(shape):
    """roll/unroll over the last three axes, and pad/crop/pad_fft_kernel
    with a 3D shape, act on each lane as the JAX helper acts on one volume;
    bit-identical."""
    x = np.random.default_rng(0).standard_normal(shape)
    t = torch.tensor(x)
    vol = shape[1:]
    big = tuple(s + 3 for s in vol)
    rolled = ta.roll(t, axes=(-3, -2, -1))
    padded = ta.pad_to_shape(t, big, value=1.5)
    grown = ta.pad_fft_kernel(t, big)
    assert padded.shape == (shape[0],) + big
    for b in range(shape[0]):
        np.testing.assert_array_equal(rolled[b].numpy(), np.asarray(ja.roll(x[b])))
        np.testing.assert_array_equal(padded[b].numpy(), np.asarray(ja.pad_to_shape(x[b], big, value=1.5)))
        np.testing.assert_array_equal(grown[b].numpy(), np.asarray(ja.pad_fft_kernel(x[b], big)))
    np.testing.assert_array_equal(ta.unroll(rolled, axes=(-3, -2, -1)).numpy(), x)
    np.testing.assert_array_equal(ta.crop_to_shape(padded, vol).numpy(), x)
    with pytest.raises(ValueError):
        ta.pad_to_shape(t[0, 0, 0], vol)  # more axes in the shape than in the tensor


def _inputs(nb, shape, seed):
    rng = np.random.default_rng(seed)
    kernels = rng.random((nb,) + shape) ** 4
    data = rng.random((nb,) + shape) * 10
    weights = rng.random((nb,) + shape)
    weights[rng.random(weights.shape) < 0.2] = 0.0
    x = rng.random((nb,) + shape) * 5
    return kernels, data, weights, x


def _build(kind, pkg, kernel, data, weights):
    if kind == "weighted":
        return pkg.WeightedConvolutionCost.build(kernel, data, weights)
    cls = pkg.QuadraticConvCost if kind == "quadratic" else pkg.UniformConvCost
    return cls.build(kernel, data)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("per_lane_kernel", [False, True])
def test_batched_cost_per_lane_matches_jax(kind, per_lane_kernel):
    """Costs (B,) and gradients of a batch: lane b is the JAX cost of volume
    b with its kernel; the FFTs transform the last three axes only."""
    nb, shape = 3, (6, 10, 9)
    kernels, data, weights, x = _inputs(nb, shape, seed=1)
    if not per_lane_kernel:
        kernels = np.broadcast_to(kernels[0], kernels.shape)
    tk = torch.tensor(np.ascontiguousarray(kernels)) if per_lane_kernel else torch.tensor(kernels[0])
    tc = _build(kind, tconv, tk, torch.tensor(data), torch.tensor(weights))
    ft, gt = value_and_grad(tc.cost)(torch.tensor(x))
    assert ft.shape == (nb,) and gt.shape == x.shape
    for b in range(nb):
        jc = _build(kind, jconv, jnp.asarray(kernels[b]), jnp.asarray(data[b]), jnp.asarray(weights[b]))
        fj, gj = jax.value_and_grad(jc.cost)(jnp.asarray(x[b]))
        assert abs(float(ft[b]) - float(fj)) / abs(float(fj)) < RTOL
        assert _rel(gt[b], gj) < RTOL


@pytest.mark.parametrize("kind", KINDS)
def test_select_lanes_keeps_each_lane_cost(kind):
    """A cost restricted to some lanes gives those lanes' costs and
    gradients, bitwise: nothing is recomputed."""
    kernels, data, weights, x = _inputs(4, (4, 8, 8), seed=2)
    tc = _build(kind, tconv, torch.tensor(kernels), torch.tensor(data), torch.tensor(weights))
    f, g = value_and_grad(tc.cost)(torch.tensor(x))
    idx = torch.tensor([1, 3])
    fs, gs = value_and_grad(tconv.select_lanes(tc, idx).cost)(torch.tensor(x)[idx])
    assert torch.equal(fs, f[idx]) and torch.equal(gs, g[idx])


def test_batched_kernel_shape_is_checked():
    kernels, data, _, _ = _inputs(2, (4, 8, 8), seed=3)
    with pytest.raises(ValueError, match="kernel shape"):
        tconv.QuadraticConvCost.build(torch.tensor(kernels[:, :2]), torch.tensor(data))
