"""ADMM for the uniform-weight object step (Boyd et al. 2011), as the port's
``jobs/admm.py`` states it after the JAX package's ``admm.py:185-479``:

    min_x 0.5 ||Hx - d||^2 + mu * phi(M z1) + i_{>=0}(z2),  z1 = Dx, z2 = x

with D the circular forward differences, M the replicate-boundary mask (no
difference on each trailing face) and phi the hyperbolic TV. rho1 = rho2 =
max(mu / eps, 1e-6). Each iteration solves the circulant x-update by one FFT
pair, then the split update: over-relaxation ``alpha`` on both splits, the
prox of ``lam * (sqrt(s^2 + eps^2) - eps)`` on the masked magnitude of
``Dx + u1`` (8 Newton steps from ``max(v - lam, 0)``), the positivity clamp
and the scaled dual updates. The answer is z2, started at x0 = max(d, 0),
z1 = D x0, z2 = x0, u = 0.

Per-voxel weights w add a data split z0 = Hx (rho0 = mean(w)) whose prox is
pointwise, ``(w d + rho0 v) / (w + rho0)``, and the x-update then reads
``rho0 H^T (z0 - u0)`` in place of ``H^T d``; z0 starts at H x0, relaxed
like the other splits. A voxel of weight 0 has its datum zeroed.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.objective import objective, spectrum
from benchmark.reference.precision import Precision

__all__ = ["admm"]


def _diffs(x, p):
    return [p(torch.roll(x, -1, dims=a) - x) for a in range(3)]


def _diffs_adjoint(g, p):
    out = 0.0
    for a in range(3):
        out = p(out + (torch.roll(g[a], 1, dims=a) - g[a]))
    return out


def _faces(t, a):
    """Component ``a``'s trailing face along axis ``a``."""
    return t.select(a, -1)


def admm(d: torch.Tensor, kernel: torch.Tensor, mu: float, eps: float, iters: int, alpha: float,
         p: Precision, x0: torch.Tensor | None = None, newton: int = 8, w: torch.Tensor | None = None):
    """``(x, f)``: ``iters`` ADMM iterations from ``x0`` (default ``max(d, 0)``),
    ``f`` the objective at the answer. ``kernel`` corner-origin at ``d``'s
    shape; ``w`` the per-voxel weights, None for uniform."""
    d = p(d.to(p.dtype))
    if w is not None:
        w = p(w.to(p.dtype))
        d = torch.where(w > 0, d, torch.zeros_like(d))
    shape, dev = tuple(d.shape), d.device
    r1 = max(mu / max(eps, 1e-30), 1e-6)
    r2 = r1
    lam = mu / r1
    h_hat = spectrum(kernel, p)
    freqs = [torch.fft.fftfreq(n, dtype=p.dtype, device=dev) for n in shape[:2]]
    freqs.append(torch.fft.rfftfreq(shape[2], dtype=p.dtype, device=dev))
    s2 = (4.0 * torch.sin(math.pi * freqs[0])[:, None, None] ** 2 + 4.0 * torch.sin(math.pi * freqs[1])[None, :, None] ** 2
          + 4.0 * torch.sin(math.pi * freqs[2])[None, None, :] ** 2)
    r0 = 1.0 if w is None else float(w.mean())
    inv_den = p(1.0 / (r1 * s2 + r2 + r0 * (h_hat.real ** 2 + h_hat.imag ** 2)))
    x = p(torch.clamp_min(d, 0.0) if x0 is None else x0.to(p.dtype))
    if w is None:
        htd_hat = p(torch.conj(h_hat) * p(torch.fft.rfftn(d)))
    else:
        z0, u0, wd = p(torch.fft.irfftn(p(h_hat * p(torch.fft.rfftn(x))), s=shape)), torch.zeros_like(x), p(w * d)
    z1, z2 = _diffs(x, p), x.clone()
    u1, u2 = [torch.zeros_like(x) for _ in range(3)], torch.zeros_like(x)
    tiny = torch.finfo(p.dtype).tiny
    le2 = lam * eps * eps
    for _ in range(iters):
        rhs = p(r1 * _diffs_adjoint([p(z - u) for z, u in zip(z1, u1)], p) + r2 * p(z2 - u2))
        if w is not None:
            htd_hat = p(r0 * p(torch.conj(h_hat) * p(torch.fft.rfftn(p(z0 - u0)))))
        x_hat = p(p(p(torch.fft.rfftn(rhs)) + htd_hat) * inv_den)
        x = p(torch.fft.irfftn(x_hat, s=shape))
        if w is not None:
            hx = p(torch.fft.irfftn(p(h_hat * x_hat), s=shape))
            hxr = hx if alpha == 1.0 else p(alpha * hx + (1.0 - alpha) * z0)
            z0_new = p(p(wd + r0 * p(hxr + u0)) / p(w + r0))
            u0 = p(u0 + hxr - z0_new)
            z0 = z0_new
        dx = _diffs(x, p)
        dxr = dx if alpha == 1.0 else [p(alpha * a + (1.0 - alpha) * z) for a, z in zip(dx, z1)]
        v = [p(a + u) for a, u in zip(dxr, u1)]
        sq = [p(c * c) for c in v]
        for a in range(3):
            _faces(sq[a], a).zero_()
        vmag = p(torch.sqrt(sq[0] + sq[1] + sq[2] + tiny))
        s = torch.clamp_min(vmag - lam, 0.0)
        for _ in range(newton):
            q = p(torch.reciprocal(torch.sqrt(s * s + eps * eps)))
            g = p(s + lam * s * q - vmag)
            gp = p(1.0 + le2 * q * q * q)
            s = p(torch.clamp_min(s - g / gp, 0.0))
        scale = p(s / vmag)
        z1_new = [p(scale * c) for c in v]
        for a in range(3):
            _faces(z1_new[a], a).copy_(_faces(v[a], a))
        xr = x if alpha == 1.0 else p(alpha * x + (1.0 - alpha) * z2)
        z2_new = p(torch.clamp_min(xr + u2, 0.0))
        u1 = [p(u + a - z) for u, a, z in zip(u1, dxr, z1_new)]
        u2 = p(u2 + xr - z2_new)
        z1, z2 = z1_new, z2_new
    with torch.no_grad():
        f = objective(z2, d, h_hat, mu, eps, p, w)
    return z2, float(f)
