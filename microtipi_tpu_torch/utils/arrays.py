"""Array layout helpers: pad / roll / crop.

Port of ``microtipi_tpu/utils/arrays.py`` (TiPi ``ArrayUtils``:
``ArrayUtils.roll`` at ``microUtils/BlindDeconvJob.java:100`` and
``ArrayUtils.pad`` at ``microscopy/PSF_Estimation.java:323``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["roll", "unroll", "pad_to_shape", "crop_to_shape", "pad_fft_kernel"]


def roll(x: torch.Tensor) -> torch.Tensor:
    """Corner-origin (FFT layout) -> centered layout: ``fftshift`` over every
    axis (TiPi ``ArrayUtils.roll``). Use :func:`unroll` to go back."""
    return torch.fft.fftshift(x)


def unroll(x: torch.Tensor) -> torch.Tensor:
    """Centered layout -> corner-origin (FFT layout); inverse of :func:`roll`."""
    return torch.fft.ifftshift(x)


def _offsets(small: tuple[int, ...], big: tuple[int, ...]) -> tuple[int, ...]:
    if len(small) != len(big) or any(s > b for s, b in zip(small, big)):
        raise ValueError(f"cannot fit shape {small} inside {big}")
    # Centered placement, matching TiPi ArrayUtils.pad's default centering.
    return tuple((b - s) // 2 for s, b in zip(small, big))


def pad_to_shape(x: torch.Tensor, shape: tuple[int, ...], value: float = 0.0) -> torch.Tensor:
    """Center-pad ``x`` to ``shape`` with ``value`` (TiPi ``ArrayUtils.pad``)."""
    shape = tuple(shape)
    if tuple(x.shape) == shape:
        return x
    offs = _offsets(tuple(x.shape), shape)
    pads = []
    for o, s, b in reversed(list(zip(offs, x.shape, shape))):  # last axis first
        pads += [o, b - s - o]
    return F.pad(x, pads, value=value)


def crop_to_shape(x: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """Extract the centered region of ``shape`` from ``x`` (inverse of pad)."""
    offs = _offsets(tuple(shape), tuple(x.shape))
    return x[tuple(slice(o, o + s) for o, s in zip(offs, shape))]


def pad_fft_kernel(kernel: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """Grow a corner-origin kernel to ``shape`` while keeping it corner-origin
    (center, zero-pad, shift back)."""
    if tuple(kernel.shape) == tuple(shape):
        return kernel
    return unroll(pad_to_shape(roll(kernel), shape))
