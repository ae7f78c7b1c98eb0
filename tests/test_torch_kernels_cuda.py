"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda`` and skipped without a card (the kernels have no CPU or
interpret mode). This file imports neither jax nor the JAX package, so it
also runs on a machine with only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

# float32 against float32 in another summation order (tests/test_pallas_tv.py:25-26).
COST_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 64, 96), (256, 8, 128)])
def test_tv_kernel_matches_plain(shape, cuda_device):
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(shape, dtype=np.float32), device=cuda_device)
    hv.launches = 0
    f, g = hv.hyperbolic_tv_fused(x, 0.1, (2.0, 1.0, 1.0))
    fp, gp = hv.hyperbolic_tv_plain(x, 0.1, (2.0, 1.0, 1.0))
    torch.cuda.synchronize()
    assert hv.launches == 1
    np.testing.assert_allclose(f.item(), fp.item(), rtol=COST_RTOL)
    torch.testing.assert_close(g, gp, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.cuda
def test_tv_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((4, 8, 8), device=cuda_device)
    with pytest.raises(TypeError):
        hv.hyperbolic_tv_fused(x.double(), 0.1)
    with pytest.raises(ValueError):
        hv.hyperbolic_tv_fused(x[None], 0.1)
    with pytest.raises(ValueError):
        hv.hyperbolic_tv_fused(x.transpose(1, 2), 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 37, 64, 96), (2, 256, 8, 128)])
def test_batched_tv_kernel_matches_plain_and_single(shape, cuda_device):
    """One batched launch: costs and gradient against the plain version,
    and each lane's gradient bitwise equal to the single-volume kernel's."""
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(shape, dtype=np.float32), device=cuda_device)
    hv.launches = hv.batched_launches = 0
    f, g = hv.hyperbolic_tv_batched_fused(x, 0.1, (2.0, 1.0, 1.0))
    fp, gp = hv.hyperbolic_tv_batched_plain(x, 0.1, (2.0, 1.0, 1.0))
    torch.cuda.synchronize()
    assert (hv.launches, hv.batched_launches) == (0, 1)
    np.testing.assert_allclose(f.cpu().numpy(), fp.cpu().numpy(), rtol=COST_RTOL)
    torch.testing.assert_close(g, gp, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    for b in range(shape[0]):
        _, gb = hv.hyperbolic_tv_fused(x[b], 0.1, (2.0, 1.0, 1.0))
        assert torch.equal(g[b], gb)
    with pytest.raises(ValueError):
        hv.hyperbolic_tv_batched_fused(x[0], 0.1)
