"""STED (stimulated-emission-depletion) PSF model.

Port of ``microtipi_tpu/models/sted.py`` (pulsed-STED approximation, Harke
et al. 2008):

    h_sted(r) = h_conf(r) * exp(-ln2 * zeta * d(r)),

with ``h_conf`` the confocal PSF, ``d`` the depletion beam's intensity
(unit peak) and ``zeta = I_peak / I_sat`` the fittable STED family. The
depletion focus comes from the same aberrated pupil at the depletion
wavelength (the submodule ``dep``) plus a static phase mask, the buffer
``dep_mask_phase``: a 2pi vortex ("donut", lateral) or a pi disk over the
inner, equal-area pupil ("bottle", axial). Each plane comes from the three
pupils' plane inputs (:class:`STEDPlaneInputs`) and two numbers of the whole
volume, the confocal PSF's sum and the depletion's peak
(:meth:`STEDModel.plane_steps` yields them).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from microtipi_tpu_torch.models.confocal import ConfocalConfig, ConfocalModel, _scaled_params, _wide_field_at
from microtipi_tpu_torch.models.widefield import (
    PlaneInputs,
    WideFieldConfig,
    WideFieldModel,
    WideFieldParams,
    whole_steps,
)
from microtipi_tpu_torch.utils.grids import fft_index

__all__ = ["STEDConfig", "STEDModel", "STEDParams", "STEDPlaneInputs"]


class STEDParams(NamedTuple):
    """Wide-field families plus ``sted = (zeta,)``, the saturation factor
    (>= 0; 0 = plain confocal)."""

    defocus: torch.Tensor
    phase: torch.Tensor
    modulus: torch.Tensor
    sted: torch.Tensor


class STEDPlaneInputs(NamedTuple):
    """The confocal plane inputs of the detection and excitation pupils, the
    depletion pupil's (``dep_*``: its modulus and phase with the static mask,
    each masked by the pupil support) and ``sted = (zeta,)``."""

    rho: torch.Tensor
    phi: torch.Tensor
    defocus: torch.Tensor
    exc_rho: torch.Tensor
    exc_phi: torch.Tensor
    exc_defocus: torch.Tensor
    dep_rho: torch.Tensor
    dep_phi: torch.Tensor
    dep_defocus: torch.Tensor
    sted: torch.Tensor


@dataclasses.dataclass(frozen=True)
class STEDConfig(ConfocalConfig):
    """STED PSF (``sted.py:64-94``): ``wavelength_dep`` the depletion
    wavelength (0 = the emission one), ``depletion`` "donut" or "bottle",
    ``saturation`` the initial zeta."""

    wavelength_dep: float = 0.0
    depletion: str = "donut"
    saturation: float = 0.0

    def __post_init__(self):
        super().__post_init__()
        if self.depletion not in ("donut", "bottle"):
            raise ValueError(f"unknown depletion {self.depletion!r}")

    @property
    def lambda_dep(self) -> float:
        return self.wavelength_dep or self.wavelength

    def dep_config(self) -> WideFieldConfig:
        return _wide_field_at(self, self.lambda_dep)

    def dep_mask_phase(self) -> np.ndarray:
        """The static depletion phase mask on the pupil grid, float64
        (``sted.py:111-125``)."""
        _, ny, nx = self.shape
        ky = fft_index(ny)[:, None]
        kx = fft_index(nx)[None, :]
        if self.depletion == "donut":
            return np.arctan2(ky, kx)  # 2pi vortex (singular at DC)
        dep = self.dep_config()
        r_px = dep.radius * dep.dxy * nx  # aperture radius in pixels
        return np.pi * ((ky ** 2 + kx ** 2) <= (r_px / np.sqrt(2.0)) ** 2).astype(np.float64)


class STEDModel(ConfocalModel):
    """The STED PSF on a device (``sted.py:127-156``)."""

    def __init__(self, config: STEDConfig, device: torch.device | str = "cuda"):
        super().__init__(config, device)
        self.dep = WideFieldModel(config.dep_config(), self.device)
        kw = dict(dtype=self.dtype, device=self.device)
        self.register_buffer("dep_mask_phase", torch.as_tensor(config.dep_mask_phase(), **kw))
        # The vortex is singular at the pupil centre: that pixel's modulus is
        # zeroed, out of place, so the on-axis null survives.
        centre = torch.ones(self.shape[1:], **kw)
        if config.depletion == "donut":
            centre[0, 0] = 0.0
        self.register_buffer("dep_centre", centre)

    def init_params(self) -> STEDParams:
        base = WideFieldModel.init_params(self)
        return STEDParams(*base, torch.tensor([self.config.saturation], dtype=self.dtype, device=self.device))

    def plane_inputs(self, params: STEDParams) -> STEDPlaneInputs:
        conf = super().plane_inputs(params)
        wf = _scaled_params(WideFieldParams(params.defocus, params.phase, params.modulus),
                            self.config.wavelength / self.config.lambda_dep)
        rho, phi, _, mask = self.dep.compute_pupil(wf)
        dep = ((rho * self.dep_centre) * mask, (phi + self.dep_mask_phase) * mask, wf.defocus)
        return STEDPlaneInputs(*conf, *dep, params.sted)

    def depletion_intensity(self, params: STEDParams) -> torch.Tensor:
        """Depletion-beam intensity, unit peak, corner-origin (Nz, Ny, Nx)."""
        i = self.plane_inputs(params)
        h = self.dep.psf_planes(PlaneInputs(i.dep_rho, i.dep_phi, i.dep_defocus))
        return h / torch.amax(h)

    def plane_steps(self, inputs: STEDPlaneInputs, planes=slice(None)):
        """``h_conf * exp(-ln2 * zeta * d)`` of the planes ``planes``, before
        the unit-sum division; they wait on the confocal PSF's sum and the
        depletion intensity's peak."""
        conf = ConfocalModel.psf_planes(self, inputs, planes)
        dep = self.dep.psf_planes(PlaneInputs(inputs.dep_rho, inputs.dep_phi, inputs.dep_defocus), planes)
        total, peak = yield ("sum", conf), ("max", dep)
        # physical: no "anti-depletion"; torch.maximum splits the gradient at
        # the tie zeta = 0 as jnp.maximum does (torch.clamp would not)
        kw = dict(dtype=self.dtype, device=conf.device)
        zeta = torch.maximum(inputs.sted[0], torch.zeros((), **kw))
        return (conf / total) * torch.exp(-torch.tensor(math.log(2.0), **kw) * zeta * (dep / peak))

    def psf_planes(self, inputs: STEDPlaneInputs, planes=slice(None)) -> torch.Tensor:
        """:meth:`plane_steps` of every plane; of fewer, their sum and peak
        over those planes alone."""
        return whole_steps(self.plane_steps(inputs, planes))
