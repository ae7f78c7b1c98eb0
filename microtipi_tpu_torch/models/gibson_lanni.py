"""Gibson-Lanni depth-aberrated wide-field PSF model.

Port of ``microtipi_tpu/models/gibson_lanni.py``: imaging at depth ``d``
inside a sample of index ``ns`` under immersion index ``ni`` adds a
depth-proportional spherical aberration to the pupil phase (Gibson & Lanni
1991),

    OPD(k; z) = z * psi_i(k) + d * (psi_s(k) - psi_i(k)),
    psi_m(k)  = sqrt((n_m / lambda)^2 - |k|^2),

so ``A(z) = rho * exp(i (phi + 2*pi*OPD))``; at ``d = 0`` it is the
wide-field model. ``depth = (ns/lambda, d)`` is the fittable DEPTH family.

The optical path is linear in ``d``, so the PSFs at K depths
(:meth:`GibsonLanniModel.compute_depth_psfs`) come from one (K, Nz, Ny, Nx)
field with depth on a broadcast axis and one batched 2D FFT: the port's
counterpart of the JAX package's ``vmap`` over depth. As in the wide-field
model, each of these is :meth:`~WideFieldModel.psf_planes` over every plane,
here of :class:`GibsonLanniPlaneInputs`, which add the DEPTH family.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from microtipi_tpu_torch.models.widefield import WideFieldConfig, WideFieldModel
from microtipi_tpu_torch.utils.grids import fft_index

__all__ = ["GibsonLanniConfig", "GibsonLanniModel", "GibsonLanniParams", "GibsonLanniPlaneInputs"]


class GibsonLanniParams(NamedTuple):
    defocus: torch.Tensor  # (ni/lambda, delta_x, delta_y)
    phase: torch.Tensor
    modulus: torch.Tensor
    depth: torch.Tensor  # (ns/lambda, d): sample index over wavelength, depth in m


class GibsonLanniPlaneInputs(NamedTuple):
    """The wide-field plane inputs and ``depth = (ns/lambda, d)``, from which
    each plane range recomputes the sample's defocus function."""

    rho: torch.Tensor
    phi: torch.Tensor
    defocus: torch.Tensor
    depth: torch.Tensor


@dataclasses.dataclass(frozen=True)
class GibsonLanniConfig(WideFieldConfig):
    """Wide-field config plus the sample index ``ns`` and the nominal
    imaging depth ``depth`` in m (0 is the wide-field model)."""

    ns: float = 1.38
    depth: float = 0.0


class GibsonLanniModel(WideFieldModel):
    """The Gibson-Lanni PSF on a device (``gibson_lanni.py:44-73``)."""

    def init_params(self) -> GibsonLanniParams:
        base = super().init_params()
        c = self.config
        depth = torch.tensor([c.ns / c.wavelength, c.depth], dtype=self.dtype, device=self.device)
        return GibsonLanniParams(base.defocus, base.phase, base.modulus, depth)

    def plane_inputs(self, params: GibsonLanniParams) -> GibsonLanniPlaneInputs:
        rho, phi, _, _ = self.compute_pupil(params)
        return GibsonLanniPlaneInputs(rho, phi, params.defocus, params.depth)

    def _psi_sample(self, lambda_ns: torch.Tensor) -> torch.Tensor:
        """Defocus function in the sample medium (``gibson_lanni.py:54-63``)
        on ``lambda_ns``'s device; the clamp is float32's tiny in every
        dtype, as in the JAX package."""
        _, ny, nx = self.shape
        kw = dict(dtype=self.dtype, device=lambda_ns.device)
        kx = torch.as_tensor(fft_index(nx) / (nx * self.config.dxy), **kw)
        ky = torch.as_tensor(fft_index(ny) / (ny * self.config.dxy), **kw)
        q = lambda_ns * lambda_ns - kx[None, :] ** 2 - ky[:, None] ** 2
        valid = (q > 0).to(self.dtype)
        return torch.sqrt(torch.clamp_min(q, float(np.finfo(np.float32).tiny))) * valid

    def planes_field(self, inputs: GibsonLanniPlaneInputs, planes=slice(None),
                     depths: torch.Tensor | None = None) -> torch.Tensor:
        """The field of the planes ``planes`` (:meth:`WideFieldModel.planes_field`)
        at the depth ``inputs.depth[1]``, (P, Ny, Nx), or one a depth of
        ``depths`` (K,), (K, P, Ny, Nx) (``gibson_lanni.py:65-73``)."""
        psi_i, mask = self._psi(inputs.defocus)
        psi_s = self._psi_sample(inputs.depth[0]) * mask
        defoc = (2.0 * math.pi * self.config.dz) * self._z(planes, psi_i.device)
        d = inputs.depth[1] if depths is None else depths[:, None, None, None]
        opd = defoc[:, None, None] * psi_i[None] + (2.0 * math.pi) * d * (psi_s - psi_i)[None]
        phase = inputs.phi[None] + opd
        return inputs.rho[None] * torch.exp(1j * phase.to(self.cdtype))

    def compute_pupil_field(self, params: GibsonLanniParams, depths: torch.Tensor | None = None) -> torch.Tensor:
        """The field (Nz, Ny, Nx) at the depth ``params.depth[1]``, or one a
        depth of ``depths`` (K,), (K, Nz, Ny, Nx)."""
        return self.planes_field(self.plane_inputs(params), depths=depths)

    def compute_depth_psfs(self, params: GibsonLanniParams, depths: torch.Tensor) -> torch.Tensor:
        """The PSFs at the K depths ``depths`` (in m; they replace
        ``params.depth[1]``), (K, Nz, Ny, Nx), from one batched 2D FFT."""
        return self.psf_planes(self.plane_inputs(params), depths=depths)
