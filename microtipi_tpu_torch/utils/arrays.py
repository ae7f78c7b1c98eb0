"""Array layout helpers: pad / roll / crop.

Port of ``microtipi_tpu/utils/arrays.py`` (TiPi ``ArrayUtils``:
``ArrayUtils.roll`` at ``microUtils/BlindDeconvJob.java:100`` and
``ArrayUtils.pad`` at ``microscopy/PSF_Estimation.java:323``).

Each helper also takes a batch: ``roll``/``unroll`` shift only ``axes`` when
given, and a ``shape`` shorter than the tensor's rank applies to its trailing
axes, leaving the leading (batch) axes alone. Without those arguments they
work on every axis, as the JAX helpers do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["roll", "unroll", "pad_to_shape", "crop_to_shape", "pad_fft_kernel", "median"]


def roll(x: torch.Tensor, axes=None) -> torch.Tensor:
    """Corner-origin (FFT layout) -> centered layout: ``fftshift`` over
    ``axes`` (default every axis; TiPi ``ArrayUtils.roll``). Use
    :func:`unroll` to go back."""
    return torch.fft.fftshift(x, dim=axes)


def unroll(x: torch.Tensor, axes=None) -> torch.Tensor:
    """Centered layout -> corner-origin (FFT layout); inverse of :func:`roll`."""
    return torch.fft.ifftshift(x, dim=axes)


def _trailing(x: torch.Tensor, shape) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(leading batch shape, trailing shape that ``shape`` applies to)."""
    n = len(shape)
    if n > x.ndim:
        raise ValueError(f"shape {tuple(shape)} has more axes than the tensor's {tuple(x.shape)}")
    return tuple(x.shape[: x.ndim - n]), tuple(x.shape[x.ndim - n:])


def _offsets(small: tuple[int, ...], big: tuple[int, ...]) -> tuple[int, ...]:
    if len(small) != len(big) or any(s > b for s, b in zip(small, big)):
        raise ValueError(f"cannot fit shape {small} inside {big}")
    # Centered placement, matching TiPi ArrayUtils.pad's default centering.
    return tuple((b - s) // 2 for s, b in zip(small, big))


def pad_to_shape(x: torch.Tensor, shape: tuple[int, ...], value: float = 0.0) -> torch.Tensor:
    """Center-pad the trailing ``len(shape)`` axes of ``x`` to ``shape`` with
    ``value`` (TiPi ``ArrayUtils.pad``)."""
    shape = tuple(shape)
    _, inner = _trailing(x, shape)
    if inner == shape:
        return x
    offs = _offsets(inner, shape)
    pads = []
    for o, s, b in reversed(list(zip(offs, inner, shape))):  # last axis first
        pads += [o, b - s - o]
    return F.pad(x, pads, value=value)


def crop_to_shape(x: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """Extract the centered region of ``shape`` from the trailing axes of
    ``x`` (inverse of pad)."""
    lead, inner = _trailing(x, tuple(shape))
    offs = _offsets(tuple(shape), inner)
    return x[(slice(None),) * len(lead) + tuple(slice(o, o + s) for o, s in zip(offs, shape))]


def pad_fft_kernel(kernel: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """Grow a corner-origin kernel to ``shape`` while keeping it corner-origin
    (center, zero-pad, shift back); a batch of kernels grows on its trailing
    axes."""
    shape = tuple(shape)
    lead, inner = _trailing(kernel, shape)
    if inner == shape:
        return kernel
    axes = tuple(range(len(lead), kernel.ndim))
    return unroll(pad_to_shape(roll(kernel, axes), shape), axes)


def median(t: torch.Tensor, dim: int | None = None, keepdim: bool = False) -> torch.Tensor:
    """``jnp.median``: the mean of the two middle order statistics of an
    even count (``torch.median`` takes the lower one, and ``torch.quantile``
    refuses more than 2^24 elements), over all elements (``dim`` None, a
    0-dim tensor) or along ``dim``, on ``t``'s device. A slice that holds
    a NaN has the median NaN, as ``jnp.median`` (``torch.sort`` puts NaN
    last, so the middle of the sort alone would skip it)."""
    if dim is None:
        t, dim = t.reshape(-1), 0
    v = torch.sort(t, dim=dim).values
    n = v.shape[dim]
    h = n // 2
    mid = v.narrow(dim, h, 1) if n % 2 else (v.narrow(dim, h - 1, 1) + v.narrow(dim, h, 1)) * 0.5
    if mid.is_floating_point():
        # Sorted NaNs come last: the slice holds one exactly where its last value is NaN.
        mid = torch.where(torch.isnan(v.narrow(dim, n - 1, 1)), torch.nan, mid)
    return mid if keepdim else mid.squeeze(dim)
