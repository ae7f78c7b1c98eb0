"""Pupil-plane quantities: support mask, defocus function, modulus/phase synthesis.

Port of ``microtipi_tpu/ops/pupil.py`` (reference:
``epifluorescence/WideFieldModel.java`` ``computeMaskPupil`` :1374-1406,
``computeDefocus`` :1452-1499, ``setModulus`` :1588-1610, ``setPhase``
:1625-1649). The evanescent mask carries no gradient (``.detach()``), and
``||beta||`` stays inside the differentiated graph.
"""

from __future__ import annotations

import numpy as np
import torch

from microtipi_tpu_torch.utils.grids import fft_index

__all__ = [
    "geometric_mask",
    "defocus_psi",
    "synthesize_modulus",
    "synthesize_phase",
]


def geometric_mask(ny: int, nx: int, radius: float, dxy: float) -> np.ndarray:
    """Static pupil support: frequencies strictly inside NA/lambda
    (``WideFieldModel.java:1378-1391``), as a float64 0/1 array."""
    kx = fft_index(nx) / (nx * dxy)
    ky = fft_index(ny) / (ny * dxy)
    r2 = kx[None, :] ** 2 + ky[:, None] ** 2
    return (r2 < radius * radius).astype(np.float64)


def defocus_psi(
    defocus: torch.Tensor,
    ny: int,
    nx: int,
    dxy: float,
    geom_mask: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(psi, mask)`` from ``defocus = (ni/lambda, delta_x, delta_y)``
    (``WideFieldModel.java:1452-1499``): ``psi`` is zero at evanescent pixels
    and ``mask = geom_mask & (radicand > 0)`` carries no gradient. A stack of
    defocus vectors (K, 3) gives (K, Ny, Nx) maps."""
    dtype, device = defocus.dtype, defocus.device
    lambda_ni, delta_x, delta_y = (defocus[..., i, None, None] for i in range(3))
    kx = torch.as_tensor(fft_index(nx) / (nx * dxy), dtype=dtype, device=device)
    ky = torch.as_tensor(fft_index(ny) / (ny * dxy), dtype=dtype, device=device)
    rx2 = (kx[None, :] - delta_x) ** 2
    ry2 = (ky[:, None] - delta_y) ** 2
    q = lambda_ni * lambda_ni - rx2 - ry2
    valid = (q > 0).detach().to(dtype)
    mask = geom_mask.to(dtype) * valid
    # Safe sqrt: clamp the radicand away from 0 so the gradient is finite,
    # then zero the evanescent region. The clamp is float32's tiny in every
    # dtype, as in the JAX package (ops/pupil.py:91).
    tiny = float(np.finfo(np.float32).tiny)
    psi = torch.sqrt(torch.clamp_min(q, tiny)) * valid
    return psi, mask


def synthesize_modulus(beta: torch.Tensor, zernike: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Pupil modulus ``rho = (sum_k beta_k Z_k) / ||beta||`` on the support
    (``WideFieldModel.java:1595-1608``); the normalisation is differentiated."""
    k = beta.shape[0]
    beta_n = beta / torch.linalg.vector_norm(beta)
    rho = torch.tensordot(beta_n, zernike[:k], dims=1)
    return rho * mask


def synthesize_phase(
    alpha: torch.Tensor, zernike: torch.Tensor, mask: torch.Tensor, radial: bool
) -> torch.Tensor:
    """Pupil phase ``phi = sum_k alpha_k Z_(k+off)``, offset 1 (radial) or 3
    (full basis) (``WideFieldModel.java:1640-1644``); zero for empty alpha."""
    offset = 1 if radial else 3
    k = alpha.shape[0]
    if k == 0:
        return torch.zeros(mask.shape, dtype=alpha.dtype, device=alpha.device)
    phi = torch.tensordot(alpha, zernike[offset : offset + k], dims=1)
    return phi * mask
