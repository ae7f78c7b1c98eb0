"""Light-sheet (SPIM) PSF models: wide-field detection times the excitation sheet.

Port of ``microtipi_tpu/models/lightsheet.py``. The PSF is the detection
arm's wide-field PSF times the sheet's intensity profile, unit sum.

- :class:`LightSheetModel`: a cylindrically focused Gaussian beam along x,

      L(z, x) = sqrt(w0 / w(x)) * exp(-2 (z - z0)^2 / w(x)^2),
      w(x)    = w0 * sqrt(1 + (x / xR)^2),  xR = pi * w0^2 * ni / lambda_exc,

  with ``divergence=False`` dropping the x dependence. ``sheet = (z0, w0)``
  is the fittable SHEET family.
- :class:`StructuredSheetModel`: a dithered Bessel or lattice sheet from a
  static (ky, kz) illumination mask,
  ``S(z) = sum_ky | sum_kz A(ky, kz) exp(i kz z) |^2``, unit peak; the
  SHEET family reads ``(z0, scale)`` there.

The sheet's profile is a function of z (and x), so each plane is its
detection plane times its rows of the profile; the structured sheet's unit
peak runs over z, so each set of planes takes its rows of the whole (Nz,)
profile, M * Nz values.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from microtipi_tpu_torch.models.widefield import PlaneInputs, UnitSumModel, WideFieldConfig, WideFieldModel
from microtipi_tpu_torch.utils.grids import fft_index, wrapped_z

__all__ = ["LightSheetConfig", "LightSheetModel", "LightSheetParams", "LightSheetPlaneInputs",
           "StructuredSheetConfig", "StructuredSheetModel"]


class LightSheetParams(NamedTuple):
    """Wide-field families plus ``sheet = (z0, w0)`` in m."""

    defocus: torch.Tensor
    phase: torch.Tensor
    modulus: torch.Tensor
    sheet: torch.Tensor


class LightSheetPlaneInputs(NamedTuple):
    """The detection pupil's plane inputs and ``sheet``."""

    rho: torch.Tensor
    phi: torch.Tensor
    defocus: torch.Tensor
    sheet: torch.Tensor


@dataclasses.dataclass(frozen=True)
class LightSheetConfig(WideFieldConfig):
    """Light-sheet PSF (``lightsheet.py:60-93``): ``wavelength`` is the
    emission wavelength; ``sheet_na`` the illumination NA, which sets the
    default waist ``lambda_exc / (pi * sheet_na)``; ``wavelength_exc`` the
    excitation wavelength (0 = the emission one); ``divergence`` the waist's
    growth along x."""

    sheet_na: float = 0.1
    wavelength_exc: float = 0.0
    divergence: bool = True

    @property
    def lambda_exc(self) -> float:
        return self.wavelength_exc or self.wavelength

    @property
    def waist(self) -> float:
        """Default sheet waist w0 = lambda_exc / (pi * NA_sheet) in m."""
        return self.lambda_exc / (np.pi * self.sheet_na)


class LightSheetModel(UnitSumModel):
    """The Gaussian light-sheet PSF on a device (``lightsheet.py:104-135``)."""

    def init_params(self) -> LightSheetParams:
        base = WideFieldModel.init_params(self)
        sheet = torch.tensor([0.0, self.config.waist], dtype=self.dtype, device=self.device)
        return LightSheetParams(*base, sheet)

    def plane_inputs(self, params: LightSheetParams) -> LightSheetPlaneInputs:
        return LightSheetPlaneInputs(*WideFieldModel.plane_inputs(self, params), params.sheet)

    def _z_centered(self, device) -> torch.Tensor:
        """The planes' centred z in m, on ``device``."""
        return torch.as_tensor(wrapped_z(self.shape[0]) * self.config.dz, dtype=self.dtype, device=device)

    def sheet_profile(self, sheet: torch.Tensor, planes=slice(None)) -> torch.Tensor:
        """Excitation intensity of the planes ``planes``, corner-origin,
        (P, 1, Nx) with divergence, (P, 1, 1) without, on ``sheet``'s device."""
        c = self.config
        z0, w0 = sheet[0], sheet[1]
        dz2 = (self._z_centered(sheet.device)[planes] - z0) ** 2
        if not c.divergence:
            return torch.exp(-2.0 * dz2 / (w0 * w0))[:, None, None]
        xc = torch.as_tensor(fft_index(self.shape[2]) * c.dxy, dtype=self.dtype, device=sheet.device)
        x_r = (np.pi * c.ni / c.lambda_exc) * w0 * w0  # Rayleigh range
        w2 = w0 * w0 * (1.0 + (xc / x_r) ** 2)  # w(x)^2, (Nx,)
        # a 2D (cylindrical) Gaussian sheet: amplitude ~ sqrt(w0/w)
        prof = torch.sqrt(w0 * w0 / w2)[None, :] * torch.exp(-2.0 * dz2[:, None] / w2[None, :])
        return prof[:, None, :]

    def psf_planes(self, inputs: LightSheetPlaneInputs, planes=slice(None)) -> torch.Tensor:
        """``h_det * L`` of the planes ``planes``, before the unit-sum division."""
        h_det = WideFieldModel.psf_planes(self, PlaneInputs(inputs.rho, inputs.phi, inputs.defocus), planes)
        return h_det * self.sheet_profile(inputs.sheet, planes)


@dataclasses.dataclass(frozen=True)
class StructuredSheetConfig(LightSheetConfig):
    """Bessel or lattice light-sheet excitation, dithered along y
    (``lightsheet.py:138-193``): ``sheet_mode`` "bessel" (the annulus
    ``[sheet_na_min, sheet_na_max]``) or "lattice" (Gaussian spots of 1/e^2
    radius ``lattice_sigma`` in NA units on the ``sheet_na_max`` ring at the
    ky fractions ``lattice_ky``), sampled on ``sheet_samples``^2 points.
    ``divergence`` is ignored."""

    sheet_na_min: float = 0.4
    sheet_na_max: float = 0.55
    sheet_mode: str = "bessel"
    lattice_ky: tuple = (0.0,)
    lattice_sigma: float = 0.0
    sheet_samples: int = 96

    def __post_init__(self):
        super().__post_init__()
        if self.sheet_mode not in ("bessel", "lattice"):
            raise ValueError(f"unknown sheet_mode {self.sheet_mode!r}")
        if not 0.0 < self.sheet_na_min < self.sheet_na_max:
            raise ValueError("need 0 < sheet_na_min < sheet_na_max")

    def illumination_mask(self) -> tuple[np.ndarray, np.ndarray]:
        """The (ky, kz) pupil mask and the kz samples in 1/m, float64
        (``lightsheet.py:200-244``)."""
        m = int(self.sheet_samples)
        k_max = 2.0 * np.pi * self.sheet_na_max / self.lambda_exc
        k_min = 2.0 * np.pi * self.sheet_na_min / self.lambda_exc
        lim = 1.1 * k_max
        ky = np.linspace(-lim, lim, m)
        kz = np.linspace(-lim, lim, m)
        kyy, kzz = np.meshgrid(ky, kz, indexing="ij")
        if self.sheet_mode == "bessel":
            r = np.hypot(kyy, kzz)
            mask = ((r >= k_min) & (r <= k_max)).astype(np.float64)
        else:
            sig = self.lattice_sigma or (self.sheet_na_max - self.sheet_na_min) / 2
            sig_k = 2.0 * np.pi * sig / self.lambda_exc
            mask = np.zeros((m, m))
            if not self.lattice_ky:
                raise ValueError("lattice mode needs at least one lattice_ky beam position")
            for u in self.lattice_ky:
                u = float(u)
                if not -1.0 <= u <= 1.0:
                    raise ValueError(f"lattice_ky fraction {u} outside [-1, 1]")
                cy = u * k_max
                cz = np.sqrt(max(1.0 - u * u, 0.0)) * k_max
                # u = 0 collapses the ky pair of spots, u = +-1 the kz pair
                for sy in ({1.0} if cy == 0.0 else {1.0, -1.0}):
                    for sz in ({1.0} if cz == 0.0 else {1.0, -1.0}):
                        mask += np.exp(-(((kyy - sy * cy) ** 2 + (kzz - sz * cz) ** 2) / (2.0 * sig_k ** 2)))
        if not np.any(mask > 0):
            raise ValueError("illumination mask is empty (check the annulus NAs / lattice positions)")
        return mask, kz


class StructuredSheetModel(LightSheetModel):
    """The structured-sheet PSF on a device; the illumination mask and its kz
    samples are the buffers ``illumination`` and ``kz``."""

    def __init__(self, config: StructuredSheetConfig, device: torch.device | str = "cuda"):
        super().__init__(config, device)
        mask, kz = config.illumination_mask()
        self.register_buffer("illumination", torch.as_tensor(mask, dtype=self.dtype, device=self.device))
        self.register_buffer("kz", torch.as_tensor(kz, dtype=self.dtype, device=self.device))

    def init_params(self) -> LightSheetParams:
        base = WideFieldModel.init_params(self)
        return LightSheetParams(*base, torch.tensor([0.0, 1.0], dtype=self.dtype, device=self.device))

    def sheet_profile(self, sheet: torch.Tensor, planes=slice(None)) -> torch.Tensor:
        """Dithered sheet intensity S(z) of the planes ``planes``, (P, 1, 1),
        unit peak over every plane (``lightsheet.py:246-263``), on
        ``sheet``'s device."""
        z0, scale = sheet[0], sheet[1]
        dev = sheet.device
        phase = (scale * self.kz.to(dev))[:, None] * (self._z_centered(dev) - z0)[None, :]  # (M, Nz)
        illumination = self.illumination.to(dev)
        e_re = illumination @ torch.cos(phase)
        e_im = illumination @ torch.sin(phase)
        s = torch.sum(e_re * e_re + e_im * e_im, dim=0)
        s = s / torch.amax(s)
        return s[planes, None, None]
