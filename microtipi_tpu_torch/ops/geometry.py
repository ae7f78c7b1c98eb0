"""Acquisition geometry: stage-scan light-sheet deskewing.

Port of ``microtipi_tpu/ops/geometry.py``. Stage-scanned light-sheet
instruments (lattice light-sheet, diSPIM, OPM) record planes while the sample
moves along the coverslip, so plane k of the raw stack is displaced laterally
by ``k * dz * cos(theta) / dxy`` pixels; deskewing shears it back, and the
deskewed axial spacing is ``dz * sin(theta)``. The shear is one batched rFFT
along x with a phase ramp linear in z: an exact subvoxel translation.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["deskew", "deskew_geometry"]


def deskew_geometry(shape, angle_deg: float, dz: float, dxy: float):
    """(x shift a plane [px], padded Nx, deskewed dz) for :func:`deskew`
    (``geometry.py:29-35``)."""
    theta = math.radians(angle_deg)
    shift = dz * math.cos(theta) / dxy
    nz, _, nx = shape
    return shift, nx + int(math.ceil(abs(shift) * (nz - 1))), dz * math.sin(theta)


def deskew(vol: torch.Tensor, angle_deg: float, dz: float, dxy: float, invert: bool = False):
    """Deskew a stage-scanned (Nz, Ny, Nx) stack; returns ``(deskewed,
    dz_new)`` (``geometry.py:38-70``). ``angle_deg`` is the detection-axis to
    scan angle (31.8 for a lattice light-sheet, 45 for diSPIM), ``dz`` the
    stage step; ``invert`` flips the shear. The x axis grows by the total
    shear, zero-filled, so the circular shift wraps into the padding."""
    if vol.ndim != 3:
        raise ValueError("deskew expects a (Nz, Ny, Nx) stack")
    nz, _, nx = vol.shape
    shift, nx_out, dz_new = deskew_geometry(tuple(vol.shape), angle_deg, dz, dxy)
    if invert:
        shift = -shift
    pad = nx_out - nx
    before = pad if shift < 0 else 0  # negative shifts move content toward -x
    v = torch.nn.functional.pad(vol, (before, pad - before))
    kw = dict(dtype=v.dtype, device=v.device)
    fx = torch.as_tensor(np.fft.rfftfreq(nx_out), **kw)
    z_idx = torch.arange(nz, **kw)
    cdtype = torch.complex128 if v.dtype == torch.float64 else torch.complex64
    ramp = torch.exp((-2j * math.pi) * (shift * z_idx[:, None] * fx[None, :]).to(cdtype))
    return torch.fft.irfft(torch.fft.rfft(v, dim=-1) * ramp[:, None, :], n=nx_out, dim=-1), dz_new
