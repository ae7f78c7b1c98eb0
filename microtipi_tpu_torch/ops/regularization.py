"""Hyperbolic total variation, the plain definition.

Port of ``hyperbolic_tv`` in ``microtipi_tpu/ops/regularization.py:35-68``:

    R(x) = sum_v ( sqrt( ||D_v x||^2 + eps^2 ) - eps )

with ``D_v`` the forward finite differences along each axis (zero at the
trailing face), optionally divided by the per-axis voxel size. It is the CPU
path and the plain version the fused CUDA kernel
(``ops/kernels/hyperbolic_tv.py``) is held against. The other priors
(``smoothed_l1``, ``hyperbolic_hessian``, ``joint_hyperbolic_tv``) wait for
ROADMAP.md queue 1 items 12 and 14.
"""

from __future__ import annotations

import torch

__all__ = ["hyperbolic_tv"]


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
