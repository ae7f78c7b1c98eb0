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


@pytest.mark.cuda
def test_tv_kernel_unaligned_shapes_and_views(cuda_device):
    """nx % 4 != 0, and nx % 4 == 0 at a base 4 bytes off 16-byte alignment,
    take the 4-byte-copy instantiation: against the plain version, and the
    latter bitwise equal to the TMA instantiation on an aligned copy."""
    rng = np.random.default_rng(5)
    odd = torch.as_tensor(rng.standard_normal((33, 45, 67), dtype=np.float32), device=cuda_device)
    flat = torch.as_tensor(rng.standard_normal(33 * 44 * 68 + 1, dtype=np.float32), device=cuda_device)
    shifted = flat[1:].view(33, 44, 68)
    assert shifted.data_ptr() % 16 != 0
    for x in (odd, shifted):
        hv.launches = hv.unaligned_launches = 0
        f, g = hv.hyperbolic_tv_fused(x, 0.1, (2.0, 1.0, 1.0))
        fp, gp = hv.hyperbolic_tv_plain(x, 0.1, (2.0, 1.0, 1.0))
        torch.cuda.synchronize()
        assert (hv.launches, hv.unaligned_launches) == (1, 1)
        np.testing.assert_allclose(f.item(), fp.item(), rtol=COST_RTOL)
        torch.testing.assert_close(g, gp, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    hv.unaligned_launches = 0
    fa, ga = hv.hyperbolic_tv_fused(shifted.clone(), 0.1)
    assert hv.unaligned_launches == 0
    fo, go = hv.hyperbolic_tv_fused(shifted, 0.1)
    assert hv.unaligned_launches == 1
    assert torch.equal(fa, fo) and torch.equal(ga, go)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 33, 45, 67), (2, 40, 24, 72)])
def test_batched_lanes_bitwise_the_single_volume_launch(shape, cuda_device):
    """Each lane's cost and gradient are the single-volume launch's bit for
    bit (the kernel sums each volume's partials in the same order), for
    aligned lanes and for the lane views of an odd-shaped batch."""
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(shape, dtype=np.float32), device=cuda_device)
    hv.unaligned_launches = 0
    f, g = hv.hyperbolic_tv_batched_fused(x, 0.1, (2.0, 1.0, 1.0))
    for b in range(shape[0]):
        fb, gb = hv.hyperbolic_tv_fused(x[b], 0.1, (2.0, 1.0, 1.0))
        assert torch.equal(f[b], fb) and torch.equal(g[b], gb)
    unaligned = shape[-1] % 4 != 0
    assert hv.unaligned_launches == (1 + shape[0] if unaligned else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 128, 128), (2, 33, 45, 67)])
def test_two_launches_bitwise_equal(shape, cuda_device):
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(shape, dtype=np.float32), device=cuda_device)
    fused = hv.hyperbolic_tv_batched_fused if len(shape) == 4 else hv.hyperbolic_tv_fused
    f1, g1 = fused(x, 1.0)
    f2, g2 = fused(x, 1.0)
    assert torch.equal(f1, f2) and torch.equal(g1, g2)
