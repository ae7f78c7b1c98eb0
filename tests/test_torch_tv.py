"""Port fused hyperbolic TV: the plain version (the CPU path of
``hyperbolic_tv_fused``) against the Pallas kernel in interpret mode and the
float64 jnp definition — the cases of tests/test_pallas_tv.py — plus the
wrapper's device rules. The CUDA kernel itself is compared with the plain
version on the card by tests/test_torch_kernels_cuda.py and by
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.ops.pallas.hyperbolic_tv import hyperbolic_tv_fused as jax_fused
from microtipi_tpu.ops.pallas.hyperbolic_tv import hyperbolic_tv_value as jax_value
from microtipi_tpu.ops.regularization import hyperbolic_tv as jax_tv
from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv
from microtipi_tpu_torch.ops.regularization import hyperbolic_tv

# float32 against float32 in another summation order: the tolerances of
# tests/test_pallas_tv.py:25-26; float64 against float64: 1e-12.
COST_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-5


def _rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.fixture
def no_launches():
    hv.launches = 0
    yield
    assert hv.launches == 0, "a CPU tensor must not launch the kernel"


@pytest.mark.parametrize("shape", [(8, 16, 128), (5, 24, 128)])
@pytest.mark.parametrize("scales", [None, (2.0, 1.0, 1.0)])
def test_plain_matches_pallas_interpret(shape, scales, no_launches):
    x = _rand(shape, 0)
    f, g = hv.hyperbolic_tv_fused(torch.tensor(x), 0.1, scales)
    fj, gj = jax_fused(jnp.asarray(x), 0.1, scales=scales, interpret=True)
    np.testing.assert_allclose(float(f), float(fj), rtol=COST_RTOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    x64 = x.astype(np.float64)
    f64, g64 = hv.hyperbolic_tv_fused(torch.tensor(x64), 0.1, scales)
    fr, gr = jax.value_and_grad(lambda v: jax_tv(v, 0.1, scales))(jnp.asarray(x64))
    np.testing.assert_allclose(float(f64), float(fr), rtol=1e-12)
    np.testing.assert_allclose(g64.numpy(), np.asarray(gr), rtol=1e-12, atol=1e-12)


def test_autograd_function_gradient(no_launches):
    x = _rand((6, 16, 128), 1)

    def obj(v):
        return hv.hyperbolic_tv_value(v, 0.05) + 0.5 * torch.sum(v * v)

    xt = torch.tensor(x, requires_grad=True)
    f = obj(xt)
    f.backward()
    fj, gj = jax.value_and_grad(lambda v: jax_value(v, 0.05, None, True) + 0.5 * jnp.sum(v * v))(jnp.asarray(x))
    np.testing.assert_allclose(f.item(), float(fj), rtol=COST_RTOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gj), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    x64 = torch.tensor(x.astype(np.float64), requires_grad=True)
    hyperbolic_tv(x64, 0.05).backward()
    want = x64.grad.clone()
    x64.grad = None
    hv.hyperbolic_tv_value(x64, 0.05).backward()
    np.testing.assert_allclose(x64.grad.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)


def test_zero_on_constant_volume(no_launches):
    f, g = hv.hyperbolic_tv_fused(torch.full((4, 16, 128), 2.5), 0.1)
    assert abs(float(f)) < 1e-5
    np.testing.assert_allclose(g.numpy(), 0.0, atol=1e-6)


def test_deep_stack_accumulation_accuracy(no_launches):
    """256 planes: the float32 cost stays at float32 round-off of float64."""
    x = _rand((256, 8, 128), 7)
    f64 = float(jax_tv(jnp.asarray(x, jnp.float64), 0.1))
    f, _ = hv.hyperbolic_tv_fused(torch.tensor(x), 0.1)
    assert abs(float(f) - f64) / abs(f64) < 5e-7


def test_wrapper_device_rules():
    """Importing the module built nothing; a CPU tensor takes the plain
    version; a tensor on another device raises instead of falling back."""
    assert hv._library.cache_info().currsize == 0
    hv.launches = 0
    hv.hyperbolic_tv_fused(torch.zeros(3, 4, 5), 0.1)
    assert hv.launches == 0 and hv._library.cache_info().currsize == 0
    with pytest.raises(ValueError):
        hv.hyperbolic_tv_fused(torch.zeros(3, 4, 5, device="meta"), 0.1)
