"""Image-scanning microscopy (ISM / Airyscan) PSF model.

Port of ``microtipi_tpu/models/ism.py``: a confocal microscope whose pinhole
is a small detector array. Element k at the object-space offset ``d_k`` sees

    h_k(r) = h_exc(r) * (h_det (*)_xy element)(r - d_k)

(Sheppard 1988; Mueller & Enderlein 2010). :meth:`ISMModel.compute_psfs`
gives the K element PSFs through one batched FFT chain, jointly normalised
to unit sum; :meth:`ISMModel.compute_psf` is the pixel-reassigned sum (each
element shifted back by ``-reassign_factor * d_k``), unit sum, so the fits
and the blind loop run on reassembled ISM images unchanged. The shifts are
rfft2 phase ramps, complex buffers computed in float64. Each plane of the
element PSFs and of their reassigned sum comes from that plane's fields
alone, but the reassigned planes wait on the elements' joint sum
(:meth:`ISMModel.plane_steps` yields it).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from microtipi_tpu_torch.models.confocal import ConfocalConfig, ConfocalModel, detection, excitation
from microtipi_tpu_torch.models.widefield import WideFieldModel, whole_steps

__all__ = ["ISMConfig", "ISMModel", "hex_offsets"]


def hex_offsets(rings: int, pitch: float) -> np.ndarray:
    """Hexagonally packed detector-element offsets ``(K, 2)`` in m
    ``(dy, dx)``, a centre element plus ``rings`` hex rings, ``K = 1 +
    3*rings*(rings+1)``, centre-out (``ism.py:50-75``, copied)."""
    a1 = np.array([0.0, 1.0])  # (dy, dx) basis
    a2 = np.array([np.sqrt(3.0) / 2.0, 0.5])
    out = [(0.0, 0.0)]
    for i in range(-rings, rings + 1):
        for j in range(-rings, rings + 1):
            if i == 0 and j == 0:
                continue
            if max(abs(i), abs(j), abs(i + j)) > rings:  # axial-coordinate hex distance
                continue
            v = (i * a1 + j * a2) * pitch
            out.append((float(v[0]), float(v[1])))
    out = np.asarray(out, np.float64)
    # centre-out ordering (stable: radius then angle)
    r = np.hypot(out[:, 0], out[:, 1])
    ang = np.arctan2(out[:, 0], out[:, 1])
    return out[np.lexsort((ang, np.round(r / max(pitch, 1e-300), 6)))]


@dataclasses.dataclass(frozen=True)
class ISMConfig(ConfocalConfig):
    """ISM PSF (``ism.py:78-110``): the confocal pupils, ``pinhole`` the
    element aperture radius (0 = point elements), ``element_pitch`` the
    object-space element spacing in m, ``rings`` the hex rings around the
    centre element, ``reassign_factor`` the pixel-reassignment scale."""

    element_pitch: float = 0.0
    rings: int = 2
    reassign_factor: float = 0.5

    def __post_init__(self):
        super().__post_init__()
        if self.element_pitch <= 0.0:
            raise ValueError("ISMConfig needs element_pitch > 0 (object-projected element spacing in meters)")

    def offsets(self) -> np.ndarray:
        """(K, 2) object-space element offsets (dy, dx), centre-out."""
        return hex_offsets(self.rings, self.element_pitch)

    @property
    def n_elements(self) -> int:
        return 1 + 3 * self.rings * (self.rings + 1)

    def shift_ramps(self, scale: float) -> np.ndarray:
        """(K, Ny, Nx//2+1) rfft2 phase ramps that shift an image by
        ``+scale*d_k`` (``ism.py:123-134``), complex128."""
        _, ny, nx = self.shape
        d = self.offsets()
        fy = np.fft.fftfreq(ny)[None, :, None]
        fx = np.fft.rfftfreq(nx)[None, None, :]
        py = d[:, 0, None, None] / self.dxy
        px = d[:, 1, None, None] / self.dxy
        return np.exp(-2j * np.pi * scale * (fy * py + fx * px))


class ISMModel(ConfocalModel):
    """The ISM PSFs on a device; the element ramps (times the element
    aperture's OTF) and the reassignment ramps are the buffers
    ``element_ramps`` and ``reassign_ramps``, (K, 1, Ny, Nx//2+1)."""

    def __init__(self, config: ISMConfig, device: torch.device | str = "cuda"):
        super().__init__(config, device)
        ramps = torch.as_tensor(config.shift_ramps(1.0), dtype=self.cdtype, device=self.device)[:, None]
        if self.pinhole_otf is not None:  # element aperture integration
            ramps = ramps * self.pinhole_otf[None, None]
        self.register_buffer("element_ramps", ramps)
        self.register_buffer("reassign_ramps", torch.as_tensor(
            config.shift_ramps(-config.reassign_factor), dtype=self.cdtype, device=self.device)[:, None])

    def _element_planes(self, inputs, planes) -> torch.Tensor:
        """The K element PSFs' planes ``planes``, (K, P, Ny, Nx), before their
        joint normalisation."""
        _, ny, nx = self.shape
        spec = torch.fft.rfft2(WideFieldModel.psf_planes(self, detection(inputs), planes))[None]
        h_det_k = torch.fft.irfft2(spec * self.element_ramps.to(spec.device), s=(ny, nx))
        return self.exc.psf_planes(excitation(inputs), planes)[None] * h_det_k

    def compute_psfs(self, params) -> torch.Tensor:
        """The K element PSFs ``(K, Nz, Ny, Nx)``, corner-origin, their sum
        of unit integral (``ism.py:136-155``)."""
        h = self._element_planes(self.plane_inputs(params), slice(None))
        return h / torch.sum(h)

    def plane_steps(self, inputs, planes=slice(None)):
        """The reassigned sum's planes ``planes`` before the unit-sum division
        (``ism.py:157-180``); they wait on the element PSFs' joint sum. The
        subvoxel shifts ring slightly negative, as the reassembled data do."""
        _, ny, nx = self.shape
        h = self._element_planes(inputs, planes)
        (total,) = yield (("sum", h),)
        ramps = self.reassign_ramps.to(h.device)
        return torch.sum(torch.fft.irfft2(torch.fft.rfft2(h / total) * ramps, s=(ny, nx)), dim=0)

    def psf_planes(self, inputs, planes=slice(None)) -> torch.Tensor:
        """:meth:`plane_steps` of every plane; of fewer, the element sum over
        those planes alone."""
        return whole_steps(self.plane_steps(inputs, planes))
