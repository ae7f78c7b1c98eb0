"""4Pi interferometric PSF model (two opposed objectives, coherent arms).

Port of ``microtipi_tpu/models/fourpi.py``: the upper objective gives the
defocused field ``E+(z) = FFT2(A(+z))``, the lower one the same pupil with
the opposite defocus, ``E-(z) = FFT2(A(-z))``, and they interfere,

    I(z) = | E+(z) + exp(i phi_c) E-(z) |^2,

with ``phi_c`` the cavity phase, the fittable CAVITY family. Type "A":
coherent excitation times confocal single-lens detection,
``h = I_exc * (h_det (*) pinhole)``; type "C": interference on both arms,
``h = I_exc * (I_det (*) pinhole)``. Unit sum. Both fields of an arm go
through one batched 2D FFT.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from microtipi_tpu_torch.models.confocal import ConfocalConfig, ConfocalModel, _scaled_params
from microtipi_tpu_torch.models.widefield import WideFieldModel, WideFieldParams

__all__ = ["FourPiConfig", "FourPiModel", "FourPiParams"]


class FourPiParams(NamedTuple):
    """Wide-field families plus ``cavity = (phi_c,)`` in radians."""

    defocus: torch.Tensor
    phase: torch.Tensor
    modulus: torch.Tensor
    cavity: torch.Tensor


@dataclasses.dataclass(frozen=True)
class FourPiConfig(ConfocalConfig):
    """4Pi PSF (``fourpi.py:82-96``): ``fourpi_type`` "A" or "C",
    ``cavity_phase`` the initial phi_c in radians."""

    fourpi_type: str = "A"
    cavity_phase: float = 0.0

    def __post_init__(self):
        super().__post_init__()
        if self.fourpi_type not in ("A", "C"):
            raise ValueError(f"fourpi_type must be 'A' or 'C', got {self.fourpi_type!r}")


def _interference_intensity(arm: WideFieldModel, params: WideFieldParams, phi_c: torch.Tensor) -> torch.Tensor:
    """``|E+ + e^{i phi_c} E-|^2 / (Nx Ny Nz)`` on the arm's geometry
    (``fourpi.py:98-110``)."""
    rho, phi, psi, _ = arm.compute_pupil(params)
    e_plus, e_minus = torch.fft.fft2(arm._field_from_pupil(rho, phi, torch.stack([psi, -psi])))
    return arm._intensity(e_plus + torch.exp(1j * phi_c.to(arm.cdtype)) * e_minus)


class FourPiModel(ConfocalModel):
    """The 4Pi PSF on a device (``fourpi.py:112-130``)."""

    def init_params(self) -> FourPiParams:
        base = WideFieldModel.init_params(self)
        return FourPiParams(*base, torch.tensor([self.config.cavity_phase], dtype=self.dtype, device=self.device))

    def compute_psf(self, params: FourPiParams) -> torch.Tensor:
        det = WideFieldParams(params.defocus, params.phase, params.modulus)
        phi_c = params.cavity[0]
        ratio = self.config.wavelength / self.config.lambda_exc
        i_exc = _interference_intensity(self.exc, _scaled_params(det, ratio), phi_c)
        if self.config.fourpi_type == "C":
            h_det = _interference_intensity(self, det, phi_c)
        else:
            h_det = WideFieldModel.compute_psf(self, det)
        h = i_exc * self._pinhole_blur(h_det)
        return h / torch.sum(h)
