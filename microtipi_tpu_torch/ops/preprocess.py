"""Acquisition preprocessing: destriping, bleaching, flat field, hot pixels, background.

Port of ``microtipi_tpu/ops/preprocess.py``: the camera and illumination
corrections a raw acquisition needs before ``d = H x + noise`` holds. The
medians are ``jnp.median``'s (the mean of the two middle values of an even
count, ``utils.arrays.median``). The rolling-ball opening's
``lax.reduce_window`` min and max become max-pooling of the negated input and
of the input (its -inf padding is never a window's only value, so it stands
in for the JAX package's +-finfo.max init), and the window mean a box average
over the in-bounds voxels.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from microtipi_tpu_torch.utils.arrays import median

__all__ = [
    "destripe",
    "estimate_bleach",
    "flat_field_correct",
    "remove_hot_pixels",
    "rolling_ball_background",
    "subtract_background",
]

_F32_TINY = float(np.finfo(np.float32).tiny)


def destripe(data: torch.Tensor, axis: int = -1, sigma: float = 2.0, protect: float = 4.0,
             strength: float = 1.0) -> torch.Tensor:
    """Suppress illumination stripes along one lateral axis, per z plane of
    ``(..., Ny, Nx)`` (``preprocess.py:32-86``): the Fourier-notch gain

        G = 1 - strength * exp(-k_axis^2 / (2 sigma^2)) * (1 - exp(-k_trans^2 / (2 protect^2)))

    (Muench et al. 2009) in bins, ``axis`` -1 (stripes along x) or -2 (along
    y). Integer frames are computed and returned in float32."""
    if axis not in (-1, -2):
        raise ValueError("axis must be -1 (stripes along x) or -2 (along y)")
    if not torch.is_floating_point(data):
        data = data.to(torch.float32)
    if data.ndim < 2:
        raise ValueError(f"expected (..., Ny, Nx), got shape {tuple(data.shape)}")
    ny, nx = data.shape[-2], data.shape[-1]
    ky = np.fft.fftfreq(ny) * ny
    kx = np.fft.rfftfreq(nx) * nx
    if axis == -1:  # notch kx ~ 0, protect low |ky|
        notch = np.exp(-(kx * kx)[None, :] / (2.0 * sigma * sigma))
        keep = 1.0 - np.exp(-(ky * ky)[:, None] / (2.0 * protect * protect))
    else:  # notch ky ~ 0, protect low |kx|
        notch = np.exp(-(ky * ky)[:, None] / (2.0 * sigma * sigma))
        keep = 1.0 - np.exp(-(kx * kx)[None, :] / (2.0 * protect * protect))
    gain = torch.as_tensor(1.0 - strength * notch * keep, dtype=data.dtype, device=data.device)
    spec = torch.fft.rfft2(data, dim=(-2, -1))
    return torch.fft.irfft2(spec * gain, s=(ny, nx), dim=(-2, -1)).to(data.dtype)


def estimate_bleach(series: torch.Tensor, threshold: float = 3.0) -> torch.Tensor:
    """Per-frame photobleaching gains ``(T,)`` of a ``(T,) + volume`` series,
    ``g[0] = 1`` (``preprocess.py:89-149``): each frame's median is its
    background, the flux is summed over one fixed support (the union over
    frames of the voxels more than ``threshold`` robust sigmas, MAD * 1.4826,
    above their frame's background), and ``g_t = flux_t / flux_0``, clamped
    positive. Register a drifting series first; feed the gains to the
    forward model (``deconvolve_timeseries(bleach=g)``), not to the data."""
    if series.ndim < 2 or series.shape[0] < 2:
        raise ValueError(f"need a (T>=2,) + volume series, got {tuple(series.shape)}")
    flat = series.reshape(series.shape[0], -1)
    dev = flat - median(flat, dim=1, keepdim=True)
    sigma = 1.4826 * median(torch.abs(dev), dim=1, keepdim=True)
    support = torch.any(dev > threshold * sigma, dim=0)
    flux = torch.sum(torch.where(support[None], dev, torch.zeros_like(dev)), dim=1)
    return torch.clamp_min(flux, _F32_TINY) / torch.clamp_min(flux[0], _F32_TINY)


def flat_field_correct(data: torch.Tensor, bright, dark=None, eps_rel: float = 1e-3) -> torch.Tensor:
    """``(d - dark) / (bright - dark)`` rescaled by the mean gain
    (``preprocess.py:152-174``); a 2D ``bright`` broadcasts over z, and the
    division is guarded at ``eps_rel * mean(gain)``."""
    bright = torch.as_tensor(bright, dtype=data.dtype, device=data.device)
    if dark is not None:
        dark = torch.as_tensor(dark, dtype=data.dtype, device=data.device)
        data = data - dark
        bright = bright - dark
    if bright.ndim == data.ndim - 1:
        bright = bright[None]
    mean_gain = torch.mean(bright)
    return data * (mean_gain / torch.maximum(bright, eps_rel * mean_gain))


def remove_hot_pixels(data: torch.Tensor, threshold: float = 5.0) -> torch.Tensor:
    """Replace impulsive outliers by the in-plane 3x3 median
    (``preprocess.py:177-204``): a voxel more than ``threshold`` robust
    sigmas (MAD * 1.4826 of the deviation map, global) from its plane's
    edge-replicated 3x3 median is hot. Integer frames are computed and
    returned in float32, as JAX's median promotes them."""
    if not torch.is_floating_point(data):
        data = data.to(torch.float32)
    vol = data if data.ndim == 3 else data[None]
    ny, nx = vol.shape[1], vol.shape[2]
    padded = F.pad(vol, (1, 1, 1, 1), mode="replicate")
    stack = torch.stack([padded[:, 1 + dy:1 + dy + ny, 1 + dx:1 + dx + nx]
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    med = median(stack, dim=0)
    dev = vol - med
    sigma = 1.4826 * median(torch.abs(dev - median(dev))) + _F32_TINY
    out = torch.where(torch.abs(dev) > threshold * sigma, med, vol)
    return out if data.ndim == 3 else out[0]


def rolling_ball_background(data: torch.Tensor, radius: int = 25) -> torch.Tensor:
    """Smooth background: the grayscale opening with a flat (2r+1)-square
    in-plane element (Sternberg 1983), then a (r//2)-radius window mean over
    the in-bounds voxels, kept under the data (``preprocess.py:207-229``)."""
    vol = data if data.ndim == 3 else data[None]
    r = int(radius)
    w = 2 * r + 1
    eroded = -F.max_pool2d(-vol, w, stride=1, padding=r)
    opened = F.max_pool2d(eroded, w, stride=1, padding=r)
    s = max(1, r // 2)
    bg = F.avg_pool2d(opened, 2 * s + 1, stride=1, padding=s, count_include_pad=False)
    bg = torch.minimum(bg, vol)  # the opening is a lower envelope
    return bg if data.ndim == 3 else bg[0]


def subtract_background(data: torch.Tensor, radius: int = 25) -> torch.Tensor:
    """``data - rolling_ball_background(data, radius)``, clamped at 0."""
    return torch.clamp_min(data - rolling_ball_background(data, radius), 0.0)
