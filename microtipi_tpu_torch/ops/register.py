"""Volume registration: subvoxel phase correlation and Fourier shifting.

Port of ``microtipi_tpu/ops/register.py``. The rigid translation between two
volumes comes from the peak of their correlation (Kuglin and Hines 1975):
normalized phase correlation with the Foroosh two-point subvoxel estimator
(Foroosh, Zerubia and Berthod 2002), or the plain matched-filter
cross-correlation with a parabolic vertex; the volume is then resampled by a
Fourier shift. A time series registers its consecutive pairs as one batch of
FFTs (the JAX package's ``vmap``s, ``register.py:142-146``). The JAX
``auto_exact_fft``/``fft_pair`` switch (the TPU's matmul DFT) is not ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["register_translation", "register_timeseries", "fourier_shift"]


def _vol_dims(nd: int) -> tuple[int, ...]:
    return tuple(range(1, nd + 1))


def _register_lanes(a: torch.Tensor, b: torch.Tensor, subvoxel: bool, method: str) -> torch.Tensor:
    """:func:`register_translation` over the leading axis of ``a`` and ``b``:
    one batched rFFT pair, (B, nd) shifts."""
    shape = tuple(a.shape[1:])
    dims = _vol_dims(len(shape))
    f = torch.fft.rfftn(a, dim=dims) * torch.conj(torch.fft.rfftn(b, dim=dims))
    if method == "phase":
        r = torch.fft.irfftn(f / torch.clamp_min(torch.abs(f), float(np.finfo(np.float32).tiny)), s=shape, dim=dims)
    elif method == "xcorr":
        r = torch.fft.irfftn(f, s=shape, dim=dims)
    else:
        raise ValueError(f"unknown method {method!r}")
    nb = r.shape[0]
    flat = torch.argmax(r.reshape(nb, -1), dim=1)
    idx = []
    for n in reversed(shape):  # unravel, C order
        idx.insert(0, flat % n)
        flat = torch.div(flat, n, rounding_mode="floor")
    lane = torch.arange(nb, device=r.device)
    f0 = r[(lane, *idx)]
    shifts = []
    for ax, n in enumerate(shape):
        p = idx[ax].to(r.dtype)
        if subvoxel:
            def at(j, ax=ax):
                sel = list(idx)
                sel[ax] = j % n
                return r[(lane, *sel)]

            fm, fp = at(idx[ax] - 1), at(idx[ax] + 1)
            if method == "phase":
                # Foroosh's ratio toward the larger neighbour (exact for the
                # phase-correlation delta peak).
                d_pos = fp / torch.clamp_min(fp + f0, 1e-30)
                d_neg = -fm / torch.clamp_min(fm + f0, 1e-30)
                frac = torch.where(fp >= fm, d_pos, d_neg)
            else:  # the xcorr peak is smooth: the parabola's vertex
                den = fm - 2.0 * f0 + fp
                frac = torch.where(torch.abs(den) > 1e-30, 0.5 * (fm - fp) / den, torch.zeros_like(den))
            p = p + torch.clamp(frac, -0.999, 0.999)
        shifts.append(torch.where(p > n / 2, p - n, p))  # signed, in (-n/2, n/2]
    return torch.stack(shifts, dim=1)


def register_translation(a: torch.Tensor, b: torch.Tensor, subvoxel: bool = True,
                         method: str = "phase") -> torch.Tensor:
    """Translation ``t`` (voxels, signed, per axis) such that
    ``fourier_shift(b, t)`` aligns ``b`` with ``a`` (``register.py:29-101``).

    ``method="phase"``: normalized phase correlation, exact for broadband
    content but noisy on band-limited (blurred) volumes, whose empty
    out-of-OTF bins vote with unit weight; ``"xcorr"``: the matched-filter
    cross-correlation, the estimator for pairs that share one transfer
    function (:func:`register_timeseries`). Volumes blurred by different
    PSFs should be blur-matched first."""
    if a.shape != b.shape:
        raise ValueError("register_translation requires equal shapes")
    return _register_lanes(a[None], b[None], subvoxel, method)[0]


def _fourier_shift_lanes(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """Each lane of ``x`` (B, ...) shifted by its row of ``shifts`` (B, nd)."""
    shape = tuple(x.shape[1:])
    nd = len(shape)
    kw = dict(dtype=x.dtype, device=x.device)
    shifts = torch.as_tensor(shifts, **kw)
    phase = torch.zeros((), **kw)
    for ax, n in enumerate(shape):
        fr = torch.as_tensor(np.fft.rfftfreq(n) if ax == nd - 1 else np.fft.fftfreq(n), **kw)
        view = [1] * nd
        view[ax] = -1
        phase = phase + fr.reshape(view)[None] * shifts[:, ax].reshape((-1,) + (1,) * nd)
    ramp = torch.exp((-2j * math.pi) * phase.to(torch.complex128 if x.dtype == torch.float64 else torch.complex64))
    dims = _vol_dims(nd)
    return torch.fft.irfftn(torch.fft.rfftn(x, dim=dims) * ramp, s=shape, dim=dims).to(x.dtype)


def fourier_shift(x: torch.Tensor, shift) -> torch.Tensor:
    """``x`` circularly shifted by (fractional) ``shift`` voxels per axis by
    the Fourier shift theorem (``register.py:104-122``); the inverse of the
    displacement :func:`register_translation` reports."""
    return _fourier_shift_lanes(x[None], torch.as_tensor(shift, dtype=x.dtype, device=x.device)[None])[0]


def register_timeseries(data: torch.Tensor, subvoxel: bool = True):
    """Drift-correct a ``(T,) + volume`` series by translation
    (``register.py:125-147``): consecutive frames are registered by
    cross-correlation (one batch of FFTs for the T-1 pairs), the shifts
    summed cumulatively, and each frame corrected by one subvoxel Fourier
    shift (one batch). Returns ``(registered, shifts)``, ``shifts[t]`` the
    correction applied to frame t (frame 0 is the reference)."""
    if data.ndim < 2 or data.shape[0] < 2:
        raise ValueError(f"need a (T>=2,) + volume series, got {tuple(data.shape)}")
    pair = _register_lanes(data[:-1], data[1:], subvoxel, "xcorr")
    shifts = torch.cat([torch.zeros((1, data.ndim - 1), dtype=pair.dtype, device=pair.device),
                        torch.cumsum(pair, dim=0)])
    return _fourier_shift_lanes(data, shifts), shifts
