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

from microtipi_tpu_torch.models.confocal import ConfocalConfig, ConfocalModel, detection, excitation
from microtipi_tpu_torch.models.widefield import PlaneInputs, WideFieldModel

__all__ = ["FourPiConfig", "FourPiModel", "FourPiParams", "FourPiPlaneInputs"]


class FourPiParams(NamedTuple):
    """Wide-field families plus ``cavity = (phi_c,)`` in radians."""

    defocus: torch.Tensor
    phase: torch.Tensor
    modulus: torch.Tensor
    cavity: torch.Tensor


class FourPiPlaneInputs(NamedTuple):
    """The confocal plane inputs of both pupils and the cavity phase."""

    rho: torch.Tensor
    phi: torch.Tensor
    defocus: torch.Tensor
    exc_rho: torch.Tensor
    exc_phi: torch.Tensor
    exc_defocus: torch.Tensor
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


def _interference_planes(arm: WideFieldModel, inputs: PlaneInputs, phi_c: torch.Tensor, planes) -> torch.Tensor:
    """``|E+ + e^{i phi_c} E-|^2 / (Nx Ny Nz)`` of the planes ``planes`` on
    the arm's geometry (``fourpi.py:98-110``)."""
    psi, _ = arm._psi(inputs.defocus)
    z = arm._z(planes, psi.device)
    e_plus, e_minus = torch.fft.fft2(arm._field_from_pupil(inputs.rho, inputs.phi, torch.stack([psi, -psi]), z))
    return arm._intensity(e_plus + torch.exp(1j * phi_c.to(arm.cdtype)) * e_minus)


class FourPiModel(ConfocalModel):
    """The 4Pi PSF on a device (``fourpi.py:112-130``)."""

    def init_params(self) -> FourPiParams:
        base = WideFieldModel.init_params(self)
        return FourPiParams(*base, torch.tensor([self.config.cavity_phase], dtype=self.dtype, device=self.device))

    def plane_inputs(self, params: FourPiParams) -> FourPiPlaneInputs:
        return FourPiPlaneInputs(*super().plane_inputs(params), params.cavity)

    def psf_planes(self, inputs: FourPiPlaneInputs, planes=slice(None)) -> torch.Tensor:
        """``I_exc * (h_det (*) pinhole)``, ``h_det`` the detection arm's
        interference for type "C", of the planes ``planes``, before the
        unit-sum division."""
        phi_c = inputs.cavity[0]
        i_exc = _interference_planes(self.exc, excitation(inputs), phi_c, planes)
        if self.config.fourpi_type == "C":
            h_det = _interference_planes(self, detection(inputs), phi_c, planes)
        else:
            h_det = WideFieldModel.psf_planes(self, detection(inputs), planes)
        return i_exc * self._pinhole_blur(h_det)
