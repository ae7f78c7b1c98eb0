"""Wide-field fluorescence microscope PSF model (scalar, monochromatic).

Port of ``microtipi_tpu/models/widefield.py`` (reference:
``epifluorescence/WideFieldModel.java``): the pupil function
``A(z) = rho * exp(i (phi + 2*pi*z*dz * psi))`` is built for all z planes at
once and pushed through one batched 2D FFT (cuFFT on the card); the PSF is
``|FFT2(A(z))|^2 / (Nx*Ny*Nz)`` (``WideFieldModel.java:60-78,202-203,241-255``).
Gradients with respect to defocus, phase and modulus come from autograd
through this synthesis, complex tensors included.

Each plane's field and 2D FFT are independent of the others' (the reference
synthesizes them on a thread pool, ``WideFieldModel.java:216-261``), so the
synthesis is one function of a plane range: :meth:`WideFieldModel.plane_inputs`
computes what every plane needs once (:class:`PlaneInputs`) and
:meth:`WideFieldModel.psf_planes` synthesizes any planes of the FFT-layout z
axis from it, on the device the inputs are on. ``compute_psf`` is that
function over every plane; a mesh-sharded fit (``parallel/psf_fit.py``) calls
it on each cell for the cell's own planes.

Every other family is built on this class the same way: its planes before
one division (:class:`UnitSumModel`, a PSF of unit sum), and where they wait
on a reduction over the whole volume (ISM's joint normalisation, STED's
confocal sum and depletion peak) :meth:`WideFieldModel.plane_steps` yields
it, so that a mesh takes it over every cell's planes (:func:`run_steps`).

``WideFieldConfig`` holds the static geometry; ``WideFieldModel`` is the
``nn.Module`` whose Zernike stack, pupil mask and wrapped-z grid are
registered buffers, so ``.to(device)`` moves them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from microtipi_tpu_torch.ops.pupil import (
    defocus_psi,
    geometric_mask,
    synthesize_modulus,
    synthesize_phase,
)
from microtipi_tpu_torch.ops.zernike import orthonormalize, zernike_basis
from microtipi_tpu_torch.utils.grids import wrapped_z

__all__ = ["REDUCTIONS", "PlaneInputs", "UnitSumModel", "WideFieldParams", "WideFieldConfig", "WideFieldModel",
           "run_steps", "whole_steps"]

#: A whole-volume reduction that a family's planes wait on, taken over one tensor.
REDUCTIONS = {"sum": torch.sum, "max": torch.amax}


class WideFieldParams(NamedTuple):
    """Optimizable PSF parameters, one field per family
    (``WideFieldModel.java:1516-1531``): ``defocus = (ni/lambda, delta_x,
    delta_y)``, ``phase`` the Zernike phase coefficients, ``modulus`` the
    Zernike modulus coefficients."""

    defocus: torch.Tensor
    phase: torch.Tensor
    modulus: torch.Tensor


class PlaneInputs(NamedTuple):
    """What every z plane of the wide-field PSF needs: the Zernike syntheses
    ``rho`` and ``phi`` (Ny, Nx), which read the model's Zernike stack, and
    the ``defocus`` vector, from which each plane range recomputes ``psi``
    (an elementwise map of three numbers)."""

    rho: torch.Tensor
    phi: torch.Tensor
    defocus: torch.Tensor


def run_steps(steps: dict, total) -> dict:
    """The planes of each of ``steps`` (a dict of :meth:`WideFieldModel.plane_steps`
    generators, one a set of planes), run side by side: each time they stop,
    all on the same reductions ``((op, tensor), ...)``, ``total(op, parts)``
    takes each over every generator's tensor (``parts``, keyed as ``steps``)
    and gives each its value (a dict keyed so), which it receives to go on."""
    values, out = dict.fromkeys(steps), {}
    while steps:
        asks = {}
        for k, s in steps.items():
            try:
                asks[k] = s.send(values[k])
            except StopIteration as done:
                out[k] = done.value
        if asks and len(asks) != len(steps):
            raise RuntimeError("plane syntheses of one PSF stopped on different reductions")
        steps = {k: steps[k] for k in asks}
        if asks:
            ops = [op for op, _ in next(iter(asks.values()))]
            each = [total(op, {k: a[i][1] for k, a in asks.items()}) for i, op in enumerate(ops)]
            values = {k: tuple(v[k] for v in each) for k in asks}
    return out


def whole_steps(steps):
    """The planes of one :meth:`WideFieldModel.plane_steps` generator, each
    reduction taken over its own tensor (its planes are every plane)."""
    return run_steps({0: steps}, lambda op, parts: {k: REDUCTIONS[op](t) for k, t in parts.items()})[0]


@dataclasses.dataclass(frozen=True)
class WideFieldConfig:
    """Static geometry/physics of the wide-field PSF model, with the fields
    of ``microtipi_tpu.models.widefield.WideFieldConfig``
    (``WideFieldModel.java:154-188``): ``shape = (Nz, Ny, Nx)`` with
    ``Nx == Ny``, ``radius = NA/lambda``, ``max(n_phase + offset, n_modulus)``
    Zernike modes, L2-normalised then Gram-Schmidt orthonormalised."""

    shape: tuple[int, int, int]  # (Nz, Ny, Nx)
    na: float
    wavelength: float  # emission wavelength in m
    ni: float  # refractive index of the immersion medium
    dxy: float  # lateral pixel size in m
    dz: float  # axial step in m
    n_phase: int = 0
    n_modulus: int = 1
    radial: bool = False
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        nz, ny, nx = self.shape
        if nx != ny:
            raise ValueError("Nx should equal Ny")  # WideFieldModel.java:158-160
        if self.n_modulus < 1:
            object.__setattr__(self, "n_modulus", 1)  # WideFieldModel.java:177-179

    @property
    def radius(self) -> float:
        """Pupil radius NA/lambda in 1/m (``WideFieldModel.java:165``)."""
        return self.na / self.wavelength

    @property
    def phase_offset(self) -> int:
        return 1 if self.radial else 3

    @property
    def n_zern(self) -> int:
        """``max(nPhase + offset, nModulus)`` (``WideFieldModel.java:1902-1906``)."""
        n = self.n_modulus
        if self.n_phase > 0:
            n = max(self.n_phase + self.phase_offset, self.n_modulus)
        return n

    def static_numpy(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(Zernike stack, geometric mask, wrapped z) in NumPy float64
        (``microtipi_tpu/models/widefield.py:116-135``)."""
        nz, ny, nx = self.shape
        radius_px = self.radius * self.dxy * nx  # WideFieldModel.java:195
        z = zernike_basis(self.n_zern, ny, nx, radius_px, normalize=True, radial=self.radial)
        return orthonormalize(z), geometric_mask(ny, nx, self.radius, self.dxy), wrapped_z(nz)


class WideFieldModel(nn.Module):
    """The wide-field PSF model on a device: ``compute_psf(params)``.

    The static Zernike stack, pupil mask and wrapped-z grid are computed in
    float64 and registered as buffers cast to ``config.dtype`` — the JAX
    package's per-dtype static cache (``widefield.py:116-135``). They live
    on the card unless the caller names another ``device`` (``"cpu"``).
    """

    def __init__(self, config: WideFieldConfig, device: torch.device | str = "cuda"):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("WideFieldModel runs on the CUDA card by default and none is available; "
                               "pass device='cpu' to run it on the CPU")
        self.config = config
        zern, mask, zw = config.static_numpy()
        for name, arr in (("zernike", zern), ("geom_mask", mask), ("z_wrapped", zw)):
            self.register_buffer(name, torch.as_tensor(arr, dtype=config.dtype, device=device))

    @property
    def shape(self) -> tuple[int, int, int]:
        return tuple(self.config.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.zernike.dtype

    @property
    def device(self) -> torch.device:
        return self.zernike.device

    @property
    def cdtype(self) -> torch.dtype:
        return torch.complex128 if self.dtype == torch.float64 else torch.complex64

    def init_params(self) -> WideFieldParams:
        """In-focus unaberrated pupil: defocus = (ni/lambda, 0, 0)
        (``WideFieldModel.java:1562-1564``), phase = 0 (``:1908``), modulus =
        [1, 0, ..., 0] (``:1957-1958``)."""
        c, kw = self.config, dict(dtype=self.dtype, device=self.device)
        defocus = torch.tensor([c.ni / c.wavelength, 0.0, 0.0], **kw)
        phase = torch.zeros((c.n_phase,), **kw)
        modulus = torch.zeros((c.n_modulus,), **kw)
        modulus[0] = 1.0
        return WideFieldParams(defocus, phase, modulus)

    def compute_pupil(self, params: WideFieldParams):
        """(rho, phi, psi, mask) on the wrapped pupil grid."""
        nz, ny, nx = self.shape
        psi, mask = defocus_psi(params.defocus, ny, nx, self.config.dxy, self.geom_mask)
        rho = synthesize_modulus(params.modulus, self.zernike, mask)
        phi = synthesize_phase(params.phase, self.zernike, mask, self.config.radial)
        return rho, phi, psi, mask

    def plane_inputs(self, params: WideFieldParams) -> PlaneInputs:
        """The inputs of :meth:`psf_planes`, computed once on the model's device."""
        rho, phi, _, _ = self.compute_pupil(params)
        return PlaneInputs(rho, phi, params.defocus)

    def _psi(self, defocus: torch.Tensor):
        """``(psi, mask)`` of ``defocus`` on its device."""
        _, ny, nx = self.shape
        return defocus_psi(defocus, ny, nx, self.config.dxy, self.geom_mask.to(defocus.device))

    def _z(self, planes, device) -> torch.Tensor:
        """The wrapped z of ``planes`` on ``device``."""
        return self.z_wrapped[planes].to(device)

    def planes_field(self, inputs: PlaneInputs, planes=slice(None)) -> torch.Tensor:
        """The complex pupil field ``A(z) = rho * exp(i (phi + 2*pi*z_w*dz*psi))``
        with the negative-frequency z fold (``WideFieldModel.java:232-246``)
        of the planes ``planes`` (a slice or an index tensor of the FFT-layout
        z axis), (P, Ny, Nx), on the inputs' device."""
        psi, _ = self._psi(inputs.defocus)
        return self._field_from_pupil(inputs.rho, inputs.phi, psi, self._z(planes, inputs.rho.device))

    def psf_planes(self, inputs: PlaneInputs, planes=slice(None), **field) -> torch.Tensor:
        """The PSF planes ``planes`` of :meth:`compute_psf`, (P, Ny, Nx), from
        :meth:`plane_inputs` on the inputs' device: each plane's field and its
        2D FFT, normalised by the whole volume's Nx*Ny*Nz. ``field``: the
        keywords of :meth:`planes_field`."""
        return self._intensity(torch.fft.fft2(self.planes_field(inputs, planes, **field)))

    def plane_steps(self, inputs, planes=slice(None), **field):
        """:meth:`psf_planes` as a generator of :func:`run_steps`: a family
        whose planes wait on reductions over the whole volume yields each
        round of them, ``((op, tensor), ...)`` with ``op`` a key of
        :data:`REDUCTIONS`, and goes on with their values; it returns the
        planes. These planes wait on none."""
        yield from ()
        return self.psf_planes(inputs, planes, **field)

    def compute_pupil_field(self, params: WideFieldParams) -> torch.Tensor:
        """The pupil field of every plane, (Nz, Ny, Nx) (:meth:`planes_field`)."""
        return self.planes_field(self.plane_inputs(params))

    def _field_from_pupil(self, rho, phi, psi, z=None) -> torch.Tensor:
        """The field of (Ny, Nx) pupil maps over the planes of wrapped z ``z``
        (default every plane), (P, Ny, Nx); maps with leading axes (K, Ny, Nx)
        give (K, P, Ny, Nx) (``widefield.py:178-182``)."""
        defoc_scale = (2.0 * math.pi * self.config.dz) * (self.z_wrapped if z is None else z)
        phase = phi.unsqueeze(-3) + defoc_scale[:, None, None] * psi.unsqueeze(-3)
        return rho.unsqueeze(-3) * torch.exp(1j * phase.to(self.cdtype))

    def _intensity(self, a_hat: torch.Tensor) -> torch.Tensor:
        """``|FFT2(A)|^2 / (Nx*Ny*Nz)`` (``WideFieldModel.java:251-255``)."""
        nz, ny, nx = self.shape
        return (a_hat.real ** 2 + a_hat.imag ** 2) * (1.0 / (nx * ny * nz))

    def compute_psf_from_pupil(self, phi, rho=None, defocus=None) -> torch.Tensor:
        """PSF from explicit pupil-plane maps instead of the Zernike
        parameters (``widefield.py:184-210``): ``phi``/``rho`` are (Ny, Nx)
        maps, masked by the full pupil support; ``rho`` None is the nominal
        flat modulus, ``defocus`` None the nominal ``(ni/lambda, 0, 0)``.
        Maps (K, Ny, Nx) with a defocus (3,) or (K, 3) give K PSFs
        (K, Nz, Ny, Nx) from one batched 2D FFT."""
        nz, ny, nx = self.shape
        kw = dict(dtype=self.dtype, device=self.device)
        d = torch.as_tensor(defocus, **kw) if defocus is not None else self.init_params().defocus
        psi, mask = defocus_psi(d, ny, nx, self.config.dxy, self.geom_mask)
        if rho is None:
            rho = synthesize_modulus(self.init_params().modulus, self.zernike, mask)
        else:
            rho = torch.as_tensor(rho, **kw) * mask
        phi = torch.as_tensor(phi, **kw) * mask
        return self._intensity(torch.fft.fft2(self._field_from_pupil(rho, phi, psi)))

    def compute_psf_and_field(self, params: WideFieldParams):
        """(psf, FFT2(A)) — the unnormalised batched 2D FFT over the last two
        axes, then the 1/(Nx*Ny*Nz) norm (``WideFieldModel.java:251-255``)."""
        a_hat = torch.fft.fft2(self.compute_pupil_field(params))
        return self._intensity(a_hat), a_hat

    def compute_psf(self, params: WideFieldParams) -> torch.Tensor:
        """3D PSF, corner-origin (FFT layout), shape (Nz, Ny, Nx)
        (``WideFieldModel.java:202-203,213,251-255``): :meth:`psf_planes`
        over every plane."""
        return self.psf_planes(self.plane_inputs(params))

    def compute_mtf(self, params: WideFieldParams) -> torch.Tensor:
        """3D FFT of the PSF (``widefield.py:221-233``; the reference's
        ``getMtf`` never increments its loop, ``WideFieldModel.java:1814,1822``)."""
        return torch.fft.fftn(self.compute_psf(params).to(self.cdtype))


class UnitSumModel(WideFieldModel):
    """A family whose PSF has unit sum: :meth:`psf_planes` gives its planes
    before the division, and :meth:`compute_psf` divides them, over every
    plane, by their sum. A mesh divides each cell's planes by the sum of
    every cell's (``parallel.psf_fit.psf_slabs``); the wide-field planes
    carry their analytic 1/(Nx*Ny*Nz) instead."""

    def compute_psf(self, params) -> torch.Tensor:
        """The unit-sum PSF, corner-origin (FFT layout), (Nz, Ny, Nx)."""
        h = self.psf_planes(self.plane_inputs(params))
        return h / torch.sum(h)
