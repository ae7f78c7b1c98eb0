"""The object step's objective and the layout of its kernel.

    f(x) = 0.5 * sum w (K (*) x - d)^2 + mu * sum_v ( sqrt(||D_v x||^2 + eps^2) - eps )

with per-voxel weights w (uniform: 1), circular convolution by a corner-origin
kernel through real FFTs, and
``D_v`` the forward differences along z, y and x, zero at each trailing
face (the replicate boundary of the port's ``ops/regularization.py``). A PSF
smaller than the volume is embedded as TiPi's ``ArrayUtils`` does it:
centred, zero-padded, shifted back to the corner.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.precision import Precision

__all__ = ["crop", "data_term", "objective", "pad_kernel", "residual", "spectrum", "tv", "value_and_grad"]


def _pads(small, big):
    pads = []
    for s, b in reversed(list(zip(small, big))):
        o = (b - s) // 2
        pads += [o, b - s - o]
    return pads


def pad_kernel(kernel: torch.Tensor, shape) -> torch.Tensor:
    """A corner-origin kernel grown to ``shape``, still corner-origin."""
    shape = tuple(shape)
    if tuple(kernel.shape) == shape:
        return kernel
    centred = torch.fft.fftshift(kernel)
    return torch.fft.ifftshift(F.pad(centred, _pads(tuple(kernel.shape), shape)))


def crop(x: torch.Tensor, shape) -> torch.Tensor:
    """The centred region ``shape`` of the last axes of ``x``."""
    offs = [(b - s) // 2 for s, b in zip(shape, x.shape[-len(shape):])]
    return x[(...,) + tuple(slice(o, o + s) for o, s in zip(offs, shape))]


def spectrum(kernel: torch.Tensor, p: Precision) -> torch.Tensor:
    return p(torch.fft.rfftn(kernel.to(p.dtype)))


def residual(x, d, k_hat, p: Precision) -> torch.Tensor:
    """``K (*) x - d``."""
    hx = p(torch.fft.irfftn(p(p(torch.fft.rfftn(x)) * k_hat), s=tuple(x.shape)))
    return p(hx - d)


def data_term(x, d, k_hat, p: Precision, w=None) -> torch.Tensor:
    """``0.5 * sum w (K (*) x - d)^2``, ``w`` None for uniform weights."""
    r = residual(x, d, k_hat, p)
    return 0.5 * torch.sum(p(r * r) if w is None else p(w * p(r * r)))


def tv(x: torch.Tensor, eps: float, p: Precision) -> torch.Tensor:
    g2 = 0.0
    for axis in range(3):
        d = torch.diff(x, dim=axis)
        pad = list(x.shape)
        pad[axis] = 1
        d = p(torch.cat([d, d.new_zeros(pad)], dim=axis))
        g2 = p(g2 + d * d)
    return torch.sum(p(torch.sqrt(g2 + eps * eps) - eps))


def objective(x, d, k_hat, mu: float, eps: float, p: Precision, w=None) -> torch.Tensor:
    f = data_term(x, d, k_hat, p, w)
    return f + mu * tv(x, eps, p) if mu > 0 else f


def value_and_grad(fun, x: torch.Tensor):
    """``(f, grad f)`` of a scalar function of one tensor, by autograd."""
    with torch.enable_grad():
        xv = x.detach().requires_grad_(True)
        f = fun(xv)
        (g,) = torch.autograd.grad(f, xv)
    return f.detach(), g
