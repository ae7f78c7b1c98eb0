"""The port's batched fused hyperbolic TV (the counterpart of the Pallas
``_tv_kernel_flat``): its plain version against the JAX flat kernel in
interpret mode, lane by lane against the single-volume plain version, the
autograd Function, and the wrapper's device rules. The CUDA kernel itself is
compared with the plain version on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.ops.pallas.hyperbolic_tv import hyperbolic_tv_value as jax_value
from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

# The vmapped case of tests/test_pallas_tv.py:60-78 (float32 flat kernel in
# interpret mode against the float64 definition): cost rtol 2e-6, grad rtol
# 2e-4 / atol 1e-6. Lanes against the single-volume version in float64: the
# same arithmetic per volume, 1e-12.
COST_RTOL, GRAD_RTOL, GRAD_ATOL, LANE_TOL = 2e-6, 2e-4, 1e-6, 1e-12


@pytest.fixture
def no_launches():
    hv.launches = hv.batched_launches = 0
    yield
    assert hv.launches == 0 and hv.batched_launches == 0, "a CPU tensor must not launch a kernel"


def _rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("shape", [(3, 6, 8, 8), (2, 5, 12, 16)])
@pytest.mark.parametrize("scales", [None, (2.0, 1.0, 1.0)])
def test_batched_plain_matches_pallas_flat_kernel(shape, scales, no_launches):
    """jax.vmap of value_and_grad routes to _tv_pallas_batched (the flat
    kernel) through the custom_vmap rule; the port's plain batched version
    in float64 against it, per lane."""
    x = _rand(shape, 0)
    eps = 0.1
    vals, grads = jax.vmap(jax.value_and_grad(lambda xi: jax_value(xi, eps, scales, True)))(jnp.asarray(x))
    f, g = hv.hyperbolic_tv_batched_fused(torch.tensor(x.astype(np.float64)), eps, scales)
    assert f.shape == (shape[0],) and g.shape == shape
    np.testing.assert_allclose(f.numpy(), np.asarray(vals), rtol=COST_RTOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(grads), rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("eps,scales", [(0.1, None), (1.0, (2.0, 1.0, 1.0))])
def test_batched_plain_lanes_match_single_volume(eps, scales, no_launches):
    """No difference crosses a volume boundary: each lane is the single
    volume's cost and gradient."""
    x = torch.tensor(_rand((3, 7, 10, 12), 1, np.float64))
    f, g = hv.hyperbolic_tv_batched_plain(x, eps, scales)
    for b in range(3):
        fb, gb = hv.hyperbolic_tv_plain(x[b], eps, scales)
        np.testing.assert_allclose(f[b].item(), fb.item(), rtol=LANE_TOL)
        np.testing.assert_allclose(g[b].numpy(), gb.numpy(), rtol=LANE_TOL, atol=LANE_TOL)


def test_batched_autograd_function(no_launches):
    """Backward of the per-lane costs: g[b] * grad[b], as autograd of the
    plain definition gives it, for a non-uniform cotangent."""
    x = _rand((3, 6, 8, 8), 2, np.float64)
    w = torch.tensor([0.5, 2.0, -1.0], dtype=torch.float64)
    xt = torch.tensor(x, requires_grad=True)
    costs = hv.hyperbolic_tv_batched_value(xt, 0.05)
    (costs * w).sum().backward()
    ref = torch.tensor(x, requires_grad=True)
    ref_costs = torch.stack([hv.hyperbolic_tv_plain(v, 0.05)[0] for v in ref.detach()])
    np.testing.assert_allclose(costs.detach().numpy(), ref_costs.numpy(), rtol=LANE_TOL)
    want = [w[b].item() * hv.hyperbolic_tv_plain(ref.detach()[b], 0.05)[1].numpy() for b in range(3)]
    np.testing.assert_allclose(xt.grad.numpy(), np.stack(want), rtol=LANE_TOL, atol=LANE_TOL)


def test_batched_zero_on_constant_batch(no_launches):
    f, g = hv.hyperbolic_tv_batched_fused(torch.full((2, 4, 16, 16), 2.5), 0.1)
    np.testing.assert_allclose(f.numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), 0.0, atol=1e-6)


def test_batched_wrapper_device_rules():
    """A CPU tensor takes the plain version and builds nothing; a 3D tensor
    is refused; a tensor on another device raises instead of falling back."""
    hv.launches = hv.batched_launches = 0
    hv.hyperbolic_tv_batched_fused(torch.zeros(2, 3, 4, 5), 0.1)
    assert hv.batched_launches == 0 and hv._library.cache_info().currsize == 0
    with pytest.raises(ValueError):
        hv.hyperbolic_tv_batched_fused(torch.zeros(3, 4, 5), 0.1)
    with pytest.raises(ValueError):
        hv.hyperbolic_tv_batched_fused(torch.zeros(2, 3, 4, 5, device="meta"), 0.1)
