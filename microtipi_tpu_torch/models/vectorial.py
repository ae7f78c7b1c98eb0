"""Vectorial (Richards-Wolf) high-NA wide-field PSF model.

Port of ``microtipi_tpu/models/vectorial.py``: the emission PSF of randomly
oriented dipoles,

    h(z) = sum_{p in {x,y}} sum_{d in {x,y,z}} | FFT2( g_pd(k) a(k) A(k,z) ) |^2,

with ``A`` the aberrated scalar pupil of the wide-field model (its three
families act unchanged), ``a = 1/sqrt(cos theta)`` the aplanatic
apodization and ``g_pd`` the six Green's-tensor pupil factors. The factors
are a float64 NumPy static registered as a (6, Ny, Nx) buffer; the six
fields go through one batched 2D FFT over (6, Nz, Ny, Nx). Unit sum; each
plane comes from the scalar pupil's plane inputs alone.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from microtipi_tpu_torch.models.widefield import PlaneInputs, UnitSumModel, WideFieldConfig
from microtipi_tpu_torch.utils.grids import fft_index

__all__ = ["VectorialConfig", "VectorialModel"]


@dataclasses.dataclass(frozen=True)
class VectorialConfig(WideFieldConfig):
    """Wide-field geometry with vectorial image formation; the same
    parameter families as the scalar model."""

    def vector_factors(self) -> np.ndarray:
        """(6, Ny, Nx) Green's-tensor pupil factors times the aplanatic
        apodization, float64, at the nominal ni/lambda
        (``vectorial.py:54-86``)."""
        _, ny, nx = self.shape
        kx = fft_index(nx) / (nx * self.dxy)
        ky = fft_index(ny) / (ny * self.dxy)
        kxx, kyy = kx[None, :], ky[:, None]
        kr = np.sqrt(kxx ** 2 + kyy ** 2)
        sin_t = np.minimum(kr / (self.ni / self.wavelength), 1.0)
        cos_t = np.sqrt(np.maximum(1.0 - sin_t ** 2, 0.0))
        # azimuth; the on-axis pixel is angle-degenerate but sin/cos stay finite
        cos_f = np.where(kr > 0, kxx / np.maximum(kr, 1e-300), 1.0)
        sin_f = np.where(kr > 0, kyy / np.maximum(kr, 1e-300), 0.0)
        g = np.stack([
            cos_t * cos_f ** 2 + sin_f ** 2,  # g_xx
            (cos_t - 1.0) * sin_f * cos_f,  # g_xy = g_yx
            sin_t * cos_f,  # g_xz
            (cos_t - 1.0) * sin_f * cos_f,  # g_yx
            cos_t * sin_f ** 2 + cos_f ** 2,  # g_yy
            sin_t * sin_f,  # g_yz
        ])
        # 1/sqrt(cos t), clamped so the factor is finite on the evanescent rim
        return g * (1.0 / np.sqrt(np.maximum(cos_t, 1e-3)))[None]


class VectorialModel(UnitSumModel):
    """The vectorial PSF on a device, its factors the buffer ``vector_factors``."""

    def __init__(self, config: VectorialConfig, device: torch.device | str = "cuda"):
        super().__init__(config, device)
        self.register_buffer("vector_factors",
                             torch.as_tensor(config.vector_factors(), dtype=self.dtype, device=self.device))

    def psf_planes(self, inputs: PlaneInputs, planes=slice(None)) -> torch.Tensor:
        """The vectorial PSF's planes ``planes`` before the unit-sum division
        (``vectorial.py:88-95``): the six fields' intensities summed."""
        a = self.planes_field(inputs, planes)
        fields = torch.fft.fft2(self.vector_factors.to(a.device)[:, None] * a[None])  # (6, P, Ny, Nx)
        return torch.sum(fields.real ** 2 + fields.imag ** 2, dim=0)
