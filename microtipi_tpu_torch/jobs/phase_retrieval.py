"""Nonparametric pupil retrieval from a bead stack (pixelwise phase map).

Port of ``microtipi_tpu/jobs/phase_retrieval.py``. The pupil phase, and
optionally its modulus, are free per-pixel maps on the pupil support,
recovered from a measured through-focus bead stack (Hanser et al. 2004) as
one regularized gradient solve: VMLMB over the maps with the profiled
amplitude-and-background bead objective of ``psf_fit.bead_anchor_term`` and
a hyperbolic-TV smoothness prior on each map, autograd through the pupil
synthesis. A Gerchberg-Saxton start (batched 2D FFTs over z, a Python loop
of rounds) precedes the polish.

Gauges: piston, tip/tilt and the defocus function psi are projected out of
the returned phase (:func:`remove_position_gauges`); they are the bead's
unknown position, not aberration. ``torch.angle`` and ``jnp.angle`` may pick
different branches at a phase of +-pi, so a map can part from the JAX one
by exactly 2 pi at a pixel; compare ``exp(i phi)`` there.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig, center_bead_stack
from microtipi_tpu_torch.ops.regularization import hyperbolic_tv
from microtipi_tpu_torch.optim.treeutil import value_and_grad
from microtipi_tpu_torch.optim.vmlmb import minimize_vmlmb
from microtipi_tpu_torch.utils.arrays import median
from microtipi_tpu_torch.utils.grids import fft_index, wrapped_z

__all__ = [
    "PupilRetrievalResult",
    "project_phase",
    "remove_position_gauges",
    "resample_pupil_map",
    "retrieve_pupil",
]

_F32_TINY = float(np.finfo(np.float32).tiny)


def resample_pupil_map(
    m: torch.Tensor,
    src_dxy: float,
    dst_shape: tuple[int, int],
    dst_dxy: float,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """A wrapped pupil-plane map on another frequency grid
    (``phase_retrieval.py:54-121``): bilinear interpolation in physical
    frequency (``k = fft_index(n) / (n * dxy)``), so a map retrieved on a bead
    crop lands on the sample model's grid (``compute_psf_from_pupil``,
    ``jobs.depthvar.depth_anchor_psfs_from_maps``). Frequencies beyond the
    source Nyquist are zero. ``mask`` (the source support) makes the
    interpolation mask-normalized: the ratio of the interpolated ``m * mask``
    and ``mask``, kept where the support weight exceeds 0.5."""
    ny_s, nx_s = m.shape
    ny_d, nx_d = int(dst_shape[0]), int(dst_shape[1])
    kw = dict(dtype=m.dtype, device=m.device)
    fy = fft_index(ny_d) / (ny_d * dst_dxy) * (ny_s * src_dxy)
    fx = fft_index(nx_d) / (nx_d * dst_dxy) * (nx_s * src_dxy)
    valid = torch.as_tensor((np.abs(fy)[:, None] <= ny_s / 2.0) & (np.abs(fx)[None, :] <= nx_s / 2.0), **kw)
    y0, x0 = np.floor(fy).astype(np.int64), np.floor(fx).astype(np.int64)
    ty = torch.as_tensor(fy - y0, **kw)[:, None]
    tx = torch.as_tensor(fx - x0, **kw)[None, :]

    def idx(i, n, axis):
        t = torch.as_tensor(i % n, device=m.device)
        return t[:, None] if axis == 0 else t[None, :]

    iy0, iy1 = idx(y0, ny_s, 0), idx(y0 + 1, ny_s, 0)
    ix0, ix1 = idx(x0, nx_s, 1), idx(x0 + 1, nx_s, 1)

    def bilerp(a):
        return ((1 - ty) * ((1 - tx) * a[iy0, ix0] + tx * a[iy0, ix1])
                + ty * ((1 - tx) * a[iy1, ix0] + tx * a[iy1, ix1]))

    if mask is None:
        return bilerp(m) * valid
    mask = torch.as_tensor(mask, **kw)
    num, den = bilerp(m * mask), bilerp(mask)
    keep = (den > 0.5).to(m.dtype) * valid
    return torch.where(keep > 0, num / torch.clamp_min(den, _F32_TINY), torch.zeros_like(num))


def remove_position_gauges(phi: torch.Tensor, mask: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    """Project piston, the tip/tilt ramps and ``psi`` out of a pupil phase
    map over the support (``phase_retrieval.py:124-142``). Apply it to both
    maps before comparing two retrievals, or a retrieval and a truth."""
    ny, nx = phi.shape
    kw = dict(dtype=phi.dtype, device=phi.device)
    ky = torch.as_tensor(fft_index(ny), **kw)
    kx = torch.as_tensor(fft_index(nx), **kw)
    gauges = torch.stack([torch.ones_like(phi), ky[:, None].expand(ny, nx), kx[None, :].expand(ny, nx),
                          psi.to(phi.dtype)])
    gm = (gauges * mask[None]).reshape(gauges.shape[0], -1)
    gm = gm / torch.linalg.vector_norm(gm, dim=1, keepdim=True)
    coefs = torch.linalg.solve(gm @ gm.T, gm @ phi.reshape(-1))
    return (phi - (coefs @ gm).reshape(phi.shape)) * mask


class PupilRetrievalResult(NamedTuple):
    """Outcome of :func:`retrieve_pupil` (``phase_retrieval.py:145-155``)."""

    phi: torch.Tensor  # retrieved pupil phase map (Ny, Nx), gauges removed, masked
    rho: torch.Tensor | None  # retrieved modulus map (None unless fit_modulus)
    mask: torch.Tensor  # the pupil support the maps live on
    psf: torch.Tensor  # PSF at the retrieved pupil (corner-origin)
    f: np.floating  # final objective value
    iterations: int
    evaluations: int
    status: int


def project_phase(model, phi: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Least-squares Zernike coefficients of a retrieved phase map over the
    model's ``n_phase`` phase modes (``phase_retrieval.py:158-174``): the way
    back to a parametric ``params0``."""
    off, n = model.config.phase_offset, model.config.n_phase
    basis = model.zernike[off:off + n].to(phi.dtype)
    m = torch.as_tensor(mask, dtype=phi.dtype, device=phi.device)
    a = (basis * m[None]).reshape(basis.shape[0], -1).T  # (pix, k)
    return torch.linalg.lstsq(a, (phi * m).reshape(-1, 1)).solution[:, 0]


def retrieve_pupil(
    model,
    bead_data,
    *,
    params0=None,
    fit_modulus: bool = False,
    smooth: float = 1e-2,
    smooth_epsilon: float = 0.05,
    config: PsfFitConfig = PsfFitConfig(max_iter=100, grtol=1e-9),
    subvoxel: bool = True,
    init: str = "gs",
    gs_iterations: int = 30,
) -> PupilRetrievalResult:
    """Pixelwise pupil maps from a bead stack (``phase_retrieval.py:177-332``).

    ``model``: a ``WideFieldModel`` at the bead stack's shape
    (``psf_fit.model_at(sample_model, bead.shape)``); the stack goes to its
    device and dtype. ``params0``: the start and anchor; the phase map starts
    at its Zernike phase and the defocus stays fixed at its value.
    ``fit_modulus`` frees the modulus map too (bounded below by 0); off, the
    ``params0`` modulus stays fixed in the objective and the returned PSF.
    ``smooth`` is the TV prior's weight relative to the data misfit at the
    start (``smooth * f0 * TV(map)``), ``smooth_epsilon`` its knee. ``init``
    "gs" runs ``gs_iterations`` Gerchberg-Saxton rounds first (measured
    magnitudes imposed on FFT(A_z), back-projection, defocus stripped, the
    pupil averaged coherently over z), "params" starts from ``params0``.
    """
    if tuple(bead_data.shape) != tuple(model.shape):
        raise ValueError(f"model shape {tuple(model.shape)} != bead stack shape {tuple(bead_data.shape)}; "
                         "build it with psf_fit.model_at(sample_model, bead.shape)")
    if init not in ("gs", "params"):
        raise ValueError(f"unknown init {init!r}")
    if params0 is None:
        params0 = model.init_params()
    dtype, cdtype, dev = model.dtype, model.cdtype, model.device
    with torch.no_grad():
        rho0, phi0, psi0, mask = model.compute_pupil(params0)
    defocus = params0.defocus.detach()

    data = torch.as_tensor(bead_data, dtype=dtype, device=dev)
    peak = torch.clamp_min(torch.max(torch.abs(data)), torch.finfo(dtype).tiny)
    d0 = center_bead_stack(data / peak, subvoxel=subvoxel)
    s1d = torch.sum(d0)
    n = float(d0.numel())

    if init == "gs":
        cz = torch.as_tensor((2.0 * math.pi * model.config.dz) * wrapped_z(model.shape[0]), dtype=dtype,
                             device=dev)[:, None, None]
        sqrt_d = torch.sqrt(torch.clamp_min(d0 - median(d0), 0.0))
        rho_c = rho0.to(cdtype)
        back = torch.exp(-1j * (cz * psi0[None]).to(cdtype))
        phi0 = phi0 * mask
        for _ in range(int(gs_iterations)):
            a = rho_c * torch.exp(1j * (phi0[None] + cz * psi0[None]).to(cdtype))
            f_hat = torch.fft.fft2(a)
            f_hat = sqrt_d * f_hat / torch.clamp_min(torch.abs(f_hat), _F32_TINY)
            pupil = torch.mean(torch.fft.ifft2(f_hat) * back, dim=0)
            phi0 = torch.angle(pupil).to(dtype) * mask

    def bead_cost(h):
        # The profiled (amplitude, background), residual form (bead_anchor_term).
        shh, sh1, shd = torch.sum(h * h), torch.sum(h), torch.sum(h * d0)
        det = torch.clamp_min(shh * n - sh1 * sh1, torch.finfo(h.dtype).tiny)
        amp = (n * shd - sh1 * s1d) / det
        c = (shh * s1d - sh1 * shd) / det
        r = amp * h + c - d0
        return 0.5 * torch.sum(r * r)

    # The prior's weight is relative to the data misfit of the start: an
    # absolute weight made the prior 50x the data term at the true pupil.
    with torch.no_grad():
        w_smooth = smooth * bead_cost(model.compute_psf_from_pupil(phi0, rho=rho0, defocus=defocus))

    def objective(v):
        rho = v["rho"] if fit_modulus else rho0  # else params0's fitted modulus stays
        f = bead_cost(model.compute_psf_from_pupil(v["phi"], rho=rho, defocus=defocus))
        if smooth > 0:
            f = f + w_smooth * hyperbolic_tv(v["phi"] * mask, smooth_epsilon)
            if fit_modulus:
                f = f + w_smooth * hyperbolic_tv(v["rho"] * mask, smooth_epsilon)
        return f

    v0, lower = {"phi": phi0}, None
    if fit_modulus:
        v0["rho"] = rho0
        lower = {"phi": -math.inf, "rho": 0.0}
    res = minimize_vmlmb(value_and_grad(objective), v0, lower=lower, mem=config.mem, maxiter=config.max_iter,
                         maxeval=config.max_eval, gatol=config.gatol, grtol=config.grtol)
    phi = remove_position_gauges(res.x["phi"] * mask, mask, psi0)
    rho = res.x["rho"] * mask if fit_modulus else None
    with torch.no_grad():
        psf = model.compute_psf_from_pupil(phi, rho=rho if fit_modulus else rho0, defocus=defocus)
    return PupilRetrievalResult(phi, rho, mask, psf, res.f, res.iterations, res.evaluations, res.status)
