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
(``exc``). The composite PSF has unit sum. Both are products of per-plane
quantities (the pinhole blur is a 2D convolution of each plane), so each
plane comes from the two pupils' plane inputs (:class:`ConfocalPlaneInputs`)
alone, and ``compute_psf`` divides the planes by their sum.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from microtipi_tpu_torch.models.widefield import (
    PlaneInputs,
    UnitSumModel,
    WideFieldConfig,
    WideFieldModel,
    WideFieldParams,
)
from microtipi_tpu_torch.utils.grids import fft_index

__all__ = ["ConfocalConfig", "ConfocalModel", "ConfocalPlaneInputs", "TwoPhotonConfig", "TwoPhotonModel"]


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


class ConfocalPlaneInputs(NamedTuple):
    """The detection pupil's plane inputs (``rho``, ``phi``, ``defocus``)
    and the excitation pupil's (``exc_*``, from the parameters scaled to its
    wavelength)."""

    rho: torch.Tensor
    phi: torch.Tensor
    defocus: torch.Tensor
    exc_rho: torch.Tensor
    exc_phi: torch.Tensor
    exc_defocus: torch.Tensor


def detection(inputs) -> PlaneInputs:
    """The detection pupil's wide-field plane inputs of a family's ``inputs``."""
    return PlaneInputs(inputs.rho, inputs.phi, inputs.defocus)


def excitation(inputs) -> PlaneInputs:
    """The excitation pupil's wide-field plane inputs of a family's ``inputs``."""
    return PlaneInputs(inputs.exc_rho, inputs.exc_phi, inputs.exc_defocus)


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


class ConfocalModel(UnitSumModel):
    """The confocal PSF on a device; the excitation pupil is the submodule
    ``exc`` and the pinhole's OTF the complex buffer ``pinhole_otf`` (None
    for a point pinhole)."""

    def __init__(self, config: ConfocalConfig, device: torch.device | str = "cuda"):
        super().__init__(config, device)
        self.exc = WideFieldModel(config.exc_config(), self.device)
        otf = config.pinhole_otf()
        self.register_buffer("pinhole_otf", None if otf is None else
                             torch.as_tensor(otf, dtype=self.cdtype, device=self.device))

    def plane_inputs(self, params) -> ConfocalPlaneInputs:
        """Both pupils' plane inputs, from the emission-referred ``params``."""
        wf = WideFieldParams(params.defocus, params.phase, params.modulus)
        exc = self.exc.plane_inputs(_scaled_params(wf, self.config.wavelength / self.config.lambda_exc))
        return ConfocalPlaneInputs(*WideFieldModel.plane_inputs(self, wf), *exc)

    def _pinhole_blur(self, h: torch.Tensor) -> torch.Tensor:
        """``h (*)_xy pinhole``, plane by plane; ``h`` itself for a point pinhole."""
        if self.pinhole_otf is None:
            return h
        _, ny, nx = self.shape
        return torch.fft.irfft2(torch.fft.rfft2(h) * self.pinhole_otf.to(h.device), s=(ny, nx))

    def psf_planes(self, inputs, planes=slice(None)) -> torch.Tensor:
        """``h_exc * (h_det (*)_xy pinhole)`` of the planes ``planes``, before
        the unit-sum division (``confocal.py:119-131``)."""
        h_det = WideFieldModel.psf_planes(self, detection(inputs), planes)
        return self.exc.psf_planes(excitation(inputs), planes) * self._pinhole_blur(h_det)


@dataclasses.dataclass(frozen=True)
class TwoPhotonConfig(WideFieldConfig):
    """Two-photon excitation PSF (``confocal.py:134-141``); ``wavelength``
    is the excitation wavelength and the parameters are in its own pupil's
    convention."""


class TwoPhotonModel(UnitSumModel):
    """``h = h_exc^2``, unit sum (``confocal.py:143-146``)."""

    def psf_planes(self, inputs: PlaneInputs, planes=slice(None)) -> torch.Tensor:
        h = WideFieldModel.psf_planes(self, inputs, planes)
        return h * h
