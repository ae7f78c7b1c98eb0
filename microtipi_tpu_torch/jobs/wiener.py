"""Wiener (regularized inverse) filtering.

Port of ``microtipi_tpu/jobs/wiener.py:26-42``: the closed-form Tikhonov
solve ``x = irfftn(conj(K_hat) d_hat / (|K_hat|^2 + lam))``, used as the
``init="wiener"`` warm start of the object step.
"""

from __future__ import annotations

import torch

__all__ = ["wiener"]


def wiener(data: torch.Tensor, psf: torch.Tensor, reg: float = 1e-3) -> torch.Tensor:
    """Regularized-inverse estimate at the data grid; the absolute weight is
    ``reg * max|K_hat|^2``. The PSF is corner-origin at the data shape."""
    if psf.shape != data.shape:
        raise ValueError("wiener requires psf shape == data shape (pad_fft_kernel first)")
    k_hat = torch.fft.rfftn(psf)
    k2 = k_hat.real ** 2 + k_hat.imag ** 2
    lam = reg * torch.max(k2)
    x_hat = torch.conj(k_hat) * torch.fft.rfftn(data) / (k2 + lam)
    return torch.fft.irfftn(x_hat, s=tuple(data.shape))
