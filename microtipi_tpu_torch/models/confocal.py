"""Confocal and two-photon PSF models (scalar, shared-pupil formalism).

Port of ``microtipi_tpu/models/confocal.py``: both are compositions of the
wide-field pupil synthesis (``models/widefield.py``), so the PSF fit and the
blind loop drive them unchanged through autograd.

- **Confocal**: ``h = h_exc * (h_det (*)_xy pinhole)``, the excitation PSF
  times the detection PSF integrated laterally over the pinhole (a disk of
  radius ``pinhole`` in object space; 0 = a point pinhole).
- **Two-photon**: ``h = h_exc^2``, non-descanned detection.

One parameter set drives both pupils: the emission-referred coefficients
(``ni/lambda`` and the phase) are scaled by ``lambda_em / lambda_exc`` for
the excitation pupil, which the model holds as a second ``WideFieldModel``
(``exc``). The composite PSF has unit sum.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from microtipi_tpu_torch.models.widefield import WideFieldConfig, WideFieldModel, WideFieldParams
from microtipi_tpu_torch.utils.grids import fft_index

__all__ = ["ConfocalConfig", "ConfocalModel", "TwoPhotonConfig", "TwoPhotonModel"]


def _scaled_params(params, ratio: float) -> WideFieldParams:
    """Emission-referred parameters re-expressed for a pupil at another
    wavelength (``confocal.py:47-56``): ``ni/lambda`` and the phase
    coefficients scale by ``lambda_em / lambda_other``, the modulus does
    not."""
    scale = torch.tensor([ratio, 1.0, 1.0], dtype=params.defocus.dtype, device=params.defocus.device)
    return WideFieldParams(params.defocus * scale, params.phase * ratio, params.modulus)


def _wide_field_at(config: WideFieldConfig, wavelength: float) -> WideFieldConfig:
    """The wide-field geometry of ``config`` at another wavelength."""
    return WideFieldConfig(
        shape=config.shape, na=config.na, wavelength=wavelength, ni=config.ni, dxy=config.dxy, dz=config.dz,
        n_phase=config.n_phase, n_modulus=config.n_modulus, radial=config.radial, dtype=config.dtype,
    )


@dataclasses.dataclass(frozen=True)
class ConfocalConfig(WideFieldConfig):
    """Confocal laser-scanning PSF (``confocal.py:59-81``): ``wavelength``
    is the emission wavelength; ``wavelength_exc`` the excitation one (0 =
    the emission one); ``pinhole`` the object-space pinhole radius in m (0 =
    a point pinhole)."""

    wavelength_exc: float = 0.0
    pinhole: float = 0.0

    @property
    def lambda_exc(self) -> float:
        return self.wavelength_exc or self.wavelength

    def exc_config(self) -> WideFieldConfig:
        """The excitation-side wide-field synthesis (``confocal.py:87-99``)."""
        return _wide_field_at(self, self.lambda_exc)

    def pinhole_otf(self) -> np.ndarray | None:
        """rfft2 of the normalised corner-origin pinhole disk, float64
        (``confocal.py:101-117``); None for a point pinhole."""
        if self.pinhole <= 0.0:
            return None
        _, ny, nx = self.shape
        x = fft_index(nx) * self.dxy
        y = fft_index(ny) * self.dxy
        disk = ((x[None, :] ** 2 + y[:, None] ** 2) <= self.pinhole ** 2).astype(np.float64)
        disk /= disk.sum()
        return np.fft.rfft2(disk)


class ConfocalModel(WideFieldModel):
    """The confocal PSF on a device; the excitation pupil is the submodule
    ``exc`` and the pinhole's OTF the complex buffer ``pinhole_otf`` (None
    for a point pinhole)."""

    def __init__(self, config: ConfocalConfig, device: torch.device | str = "cuda"):
        super().__init__(config, device)
        self.exc = WideFieldModel(config.exc_config(), self.device)
        otf = config.pinhole_otf()
        self.register_buffer("pinhole_otf", None if otf is None else
                             torch.as_tensor(otf, dtype=self.cdtype, device=self.device))

    def _pinhole_blur(self, h: torch.Tensor) -> torch.Tensor:
        """``h (*)_xy pinhole``, plane by plane; ``h`` itself for a point pinhole."""
        if self.pinhole_otf is None:
            return h
        _, ny, nx = self.shape
        return torch.fft.irfft2(torch.fft.rfft2(h) * self.pinhole_otf, s=(ny, nx))

    def excitation_psf(self, params) -> torch.Tensor:
        """The excitation PSF from the emission-referred ``params``."""
        return self.exc.compute_psf(_scaled_params(params, self.config.wavelength / self.config.lambda_exc))

    def compute_psf(self, params) -> torch.Tensor:
        """``h = h_exc * (h_det (*)_xy pinhole)``, unit sum, corner-origin
        (``confocal.py:119-131``)."""
        h = self.excitation_psf(params) * self._pinhole_blur(WideFieldModel.compute_psf(self, params))
        return h / torch.sum(h)


@dataclasses.dataclass(frozen=True)
class TwoPhotonConfig(WideFieldConfig):
    """Two-photon excitation PSF (``confocal.py:134-141``); ``wavelength``
    is the excitation wavelength and the parameters are in its own pupil's
    convention."""


class TwoPhotonModel(WideFieldModel):
    """``h = h_exc^2``, unit sum (``confocal.py:143-146``)."""

    def compute_psf(self, params) -> torch.Tensor:
        h = super().compute_psf(params)
        h = h * h
        return h / torch.sum(h)
