"""Edge-preserving regularizers for the object step, the plain definitions.

Port of ``microtipi_tpu/ops/regularization.py``. The hyperbolic total
variation (``:35-68``)

    R(x) = sum_v ( sqrt( ||D_v x||^2 + eps^2 ) - eps )

with ``D_v`` the forward finite differences along each axis (zero at the
trailing face), optionally divided by the per-axis voxel size, is the CPU
path and the plain version the fused CUDA kernel
(``ops/kernels/hyperbolic_tv.py``) is held against. The sparse-deconvolution
priors :func:`smoothed_l1` and :func:`hyperbolic_hessian` (``:120-164``) are
plain PyTorch on every device, as is the channel-coupled
:func:`joint_hyperbolic_tv` (``:71-110``), which no kernel computes.
"""

from __future__ import annotations

import torch

__all__ = ["hessian_terms", "hyperbolic_hessian", "hyperbolic_tv", "hyperbolic_tv_and_gradient",
           "joint_hyperbolic_tv", "smoothed_l1", "smoothed_l1_terms"]


def _forward_diffs(x: torch.Tensor, scales, axes) -> list[torch.Tensor]:
    """Forward differences along ``axes``, zero at the trailing face
    (replicate boundary, so a constant volume has zero cost)."""
    diffs = []
    for i, axis in enumerate(axes):
        d = torch.diff(x, dim=axis)
        pad_shape = list(x.shape)
        pad_shape[axis] = 1
        d = torch.cat([d, d.new_zeros(pad_shape)], dim=axis)
        if scales is not None:
            d = d * (1.0 / scales[i])
        diffs.append(d)
    return diffs


def hyperbolic_tv(x: torch.Tensor, epsilon: float, scales=None, axes=None) -> torch.Tensor:
    """Hyperbolic (pseudo-Huber) total variation cost; ``scales`` gives the
    per-axis voxel size, ``axes`` the differenced axes (default: all)."""
    if axes is None:
        axes = tuple(range(x.ndim))
    axes = tuple(a % x.ndim for a in axes)
    diffs = _forward_diffs(x, scales, axes)
    g2 = sum(d * d for d in diffs)
    eps = float(epsilon)
    return torch.sum(torch.sqrt(g2 + eps * eps) - eps)


def joint_hyperbolic_tv(x: torch.Tensor, epsilon: float, scales=None, axes=None,
                        couple_axis: int = 0) -> torch.Tensor:
    """Channel-coupled (color) hyperbolic TV of Bresson and Chan
    (``regularization.py:71-110``): per voxel ONE hyperbolic norm over the
    differences of every channel,

        R(x) = sum_v ( sqrt( sum_c ||D_v x_c||^2 + eps^2 ) - eps ),

    so an edge is cheap where the channels place it at the same voxel.
    ``couple_axis`` names the channel axis; ``axes`` the differenced axes
    (default: every axis but ``couple_axis``); ``scales`` and ``epsilon`` as
    in :func:`hyperbolic_tv`, which it equals for one channel. Plain PyTorch,
    differentiable twice."""
    couple_axis = couple_axis % x.ndim
    if axes is None:
        axes = tuple(a for a in range(x.ndim) if a != couple_axis)
    axes = tuple(a % x.ndim for a in axes)
    if couple_axis in axes:
        raise ValueError("couple_axis cannot also be a differenced axis")
    g2 = sum(d * d for d in _forward_diffs(x, scales, axes)).sum(dim=couple_axis)
    eps = float(epsilon)
    return torch.sum(torch.sqrt(g2 + eps * eps) - eps)


def hyperbolic_tv_and_gradient(x: torch.Tensor, epsilon: float, scales=None, axes=None):
    """(cost, gradient) by autograd of :func:`hyperbolic_tv`, both detached
    (``regularization.py:113-117``)."""
    with torch.enable_grad():
        xv = x.detach().requires_grad_(True)
        cost = hyperbolic_tv(xv, epsilon, scales, axes)
        (grad,) = torch.autograd.grad(cost, xv)
    return cost.detach(), grad


def smoothed_l1_terms(x: torch.Tensor, epsilon: float) -> torch.Tensor:
    """The per-voxel terms of :func:`smoothed_l1`, for sums per lane."""
    eps = float(epsilon)
    return torch.sqrt(x * x + eps * eps) - eps


def smoothed_l1(x: torch.Tensor, epsilon: float) -> torch.Tensor:
    """Smoothed L1 on intensity, ``sum sqrt(x^2 + eps^2) - eps``
    (``regularization.py:120-133``): the sparsity prior of Zhao et al., Nat.
    Biotech. 2021."""
    return torch.sum(smoothed_l1_terms(x, epsilon))


def hessian_terms(x: torch.Tensor, epsilon: float, scales=None, axes=None) -> torch.Tensor:
    """The per-voxel terms of :func:`hyperbolic_hessian`, for sums per lane."""
    if axes is None:
        axes = tuple(range(x.ndim))
    axes = tuple(a % x.ndim for a in axes)
    firsts = _forward_diffs(x, scales, axes)
    h2 = None
    for i in range(len(axes)):
        seconds = _forward_diffs(firsts[i], scales, axes)
        for j in range(i, len(axes)):
            m = 1.0 if j == i else 2.0
            term = m * seconds[j] * seconds[j]
            h2 = term if h2 is None else h2 + term
    eps = float(epsilon)
    return torch.sqrt(h2 + eps * eps) - eps


def hyperbolic_hessian(x: torch.Tensor, epsilon: float, scales=None, axes=None) -> torch.Tensor:
    """Hyperbolic penalty on the second-difference Hessian
    (``regularization.py:136-164``): per voxel the squared Frobenius norm of
    the Hessian from the padded forward differences applied twice, cross
    terms counted twice, scaled by ``1/(s_i s_j)``,

        R(x) = sum_v ( sqrt( sum_{i<=j} m_ij (D_i D_j x)_v^2 + eps^2 ) - eps ).
    """
    return torch.sum(hessian_terms(x, epsilon, scales, axes))
