"""The scalar wide-field PSF (``WideFieldModel.java:60-78,202-255``).

    A(z) = rho * exp(i (phi + 2 pi z dz psi)),  PSF(z) = |FFT2(A(z))|^2 / (Nx Ny Nz)

on the wrapped pupil grid, corner-origin in every axis. ``rho`` is the
normalised Zernike modulus, ``phi`` the Zernike phase from mode 4 on (Noll),
``psi`` the defocus function of ``(ni/lambda, delta_x, delta_y)``; the
support is the geometric pupil where the defocus radicand is positive.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.geometry import fft_index, geometric_mask, orthonormalize, zernike_basis
from benchmark.reference.precision import Precision

__all__ = ["WideField"]


class WideField:
    """The PSF of one optical system on the grid ``shape = (Nz, Ny, Nx)``,
    ``Nx == Ny``, with ``n_phase`` phase and ``n_modulus`` modulus modes.
    Lengths in metres."""

    def __init__(self, shape, na, wavelength, ni, dxy, dz, n_phase, n_modulus, device, precision: Precision):
        nz, ny, nx = (int(s) for s in shape)
        if nx != ny:
            raise ValueError("the pupil model needs Nx == Ny")
        self.shape, self.p, self.device = (nz, ny, nx), precision, device
        self.ni, self.wavelength, self.dxy, self.dz = ni, wavelength, dxy, dz
        self.n_phase, self.n_modulus = int(n_phase), max(int(n_modulus), 1)
        radius = na / wavelength
        n_zern = max(self.n_phase + 3, self.n_modulus) if self.n_phase > 0 else self.n_modulus
        zern = orthonormalize(zernike_basis(n_zern, ny, nx, radius * dxy * nx))
        kw = dict(dtype=precision.dtype, device=device)
        self.zernike = torch.as_tensor(zern, **kw)
        self.geom = torch.as_tensor(geometric_mask(ny, nx, radius, dxy), **kw)
        self.kx = torch.as_tensor(fft_index(nx) / (nx * dxy), **kw)
        self.ky = torch.as_tensor(fft_index(ny) / (ny * dxy), **kw)
        self.zw = torch.as_tensor(fft_index(nz), **kw)

    def init_params(self) -> dict:
        """The in-focus unaberrated pupil (``WideFieldModel.java:1562-1564,1908,1957``)."""
        kw = dict(dtype=self.p.dtype, device=self.device)
        modulus = torch.zeros(self.n_modulus, **kw)
        modulus[0] = 1.0
        return {"defocus": torch.tensor([self.ni / self.wavelength, 0.0, 0.0], **kw),
                "phase": torch.zeros(self.n_phase, **kw), "modulus": modulus}

    def psf(self, params: dict) -> torch.Tensor:
        """The PSF of ``params`` (tensors ``defocus`` (3,), ``phase``, ``modulus``),
        differentiable in them."""
        p = self.p
        nz, ny, nx = self.shape
        defocus = params["defocus"].to(p.dtype)
        q = defocus[0] ** 2 - (self.kx[None, :] - defocus[1]) ** 2 - (self.ky[:, None] - defocus[2]) ** 2
        valid = (q > 0).detach().to(p.dtype)
        mask = self.geom * valid
        psi = p(torch.sqrt(torch.clamp_min(q, float(np.finfo(np.float32).tiny))) * valid)
        beta = params["modulus"].to(p.dtype)
        rho = p(torch.tensordot(beta / torch.linalg.vector_norm(beta), self.zernike[: beta.shape[0]], dims=1) * mask)
        alpha = params["phase"].to(p.dtype)
        phi = (p(torch.tensordot(alpha, self.zernike[3: 3 + alpha.shape[0]], dims=1) * mask) if alpha.shape[0]
               else torch.zeros_like(rho))
        arg = p(phi[None] + ((2.0 * math.pi * self.dz) * self.zw)[:, None, None] * psi[None])
        field = p(rho[None] * torch.exp(1j * arg.to(p.cdtype)))
        a_hat = p(torch.fft.fft2(field))
        return p((a_hat.real ** 2 + a_hat.imag ** 2) * (1.0 / (nx * ny * nz)))
