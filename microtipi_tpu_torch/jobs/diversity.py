"""Phase-diversity aberration estimation (Gonsalves 1982; Paxman-Schulz-Fienup 1992).

Port of ``microtipi_tpu/jobs/diversity.py``. D >= 2 images of one unknown
object, each through the same pupil plus a known diversity phase
``theta_d`` (a camera defocus step, a deformable-mirror pattern), make the
pupil identifiable without the object: the object is eliminated in closed
form per Fourier mode,

    Xhat_k = sum_d w_d conj(H_dk) Y_dk / (sum_d w_d |H_dk|^2 + gamma),

and the profiled objective is evaluated in residual form,

    E = (0.5/N) sum_k m_k [ sum_d w_d |Y_dk - H_dk Xhat_k|^2 + gamma |Xhat_k|^2 ],

with ``m_k`` the rfft multiplicity (conjugate-pair bins count twice). The D
diversity pupils go through one batched 2D FFT (the model's own synthesis,
``models/widefield.py``), and the fit is ``psf_fit.fit_families_with_cost``.
For volumetric models the common-mode Z4 is the object-z-shift gauge, so
:func:`fit_psf_diversity` pins it by default (``phase_freeze_head=None``).
The error bars' OTF Jacobian comes from forward mode (``torch.func.jacfwd``,
over the OTF's real and imaginary parts) through the synthesis. The JAX
package's ``auto_exact_fft``/``fft_pair`` switch (the TPU's matmul DFT) is
not ported: cuFFT serves every FFT here.
"""

from __future__ import annotations

import numpy as np
import torch

from microtipi_tpu_torch.jobs.psf_fit import FitUncertainty, PsfFitConfig, PsfFitResult, fit_families_with_cost
from microtipi_tpu_torch.models.microscope import PHASE, family_name
from microtipi_tpu_torch.ops.zernike import orthonormalize, zernike_basis
from microtipi_tpu_torch.utils.grids import fft_freq2

__all__ = [
    "defocus_diversity",
    "zernike_diversity",
    "diversity_psfs",
    "diversity_cost",
    "diversity_fit_uncertainty",
    "diversity_object_estimate",
    "fit_psf_diversity",
]

_VOL = (1, 2, 3)


def _rfftn(t: torch.Tensor) -> torch.Tensor:
    return torch.fft.rfftn(t, dim=_VOL)


def defocus_diversity(model, deltas, lambda_ni: float | None = None) -> np.ndarray:
    """Known diversity phases of axial camera offsets ``deltas`` (m),
    ``(D, Ny, Nx)`` float64 NumPy (``diversity.py:95-119``): ``theta_d =
    2 pi delta_d psi`` with ``psi = sqrt((ni/lambda)^2 - k^2)`` the nominal
    defocus function, 0 where evanescent; ``lambda_ni`` overrides ni/lambda."""
    c = model.config
    deltas = np.atleast_1d(np.asarray(deltas, np.float64))
    ny, nx = c.shape[1:]
    if lambda_ni is None:
        lambda_ni = c.ni / c.wavelength
    ky, kx = fft_freq2(ny, nx, c.dxy)
    psi = np.sqrt(np.maximum(lambda_ni * lambda_ni - kx * kx - ky * ky, 0.0))
    return (2.0 * np.pi) * deltas[:, None, None] * psi[None]


def zernike_diversity(model, coeffs) -> np.ndarray:
    """Known diversity phases from Zernike coefficients, ``(D, Ny, Nx)``
    float64 NumPy (``diversity.py:122-144``): ``coeffs[d, j]`` multiplies the
    orthonormalized mode that the model's ``phase[j]`` does."""
    c = model.config
    coeffs = np.atleast_2d(np.asarray(coeffs, np.float64))
    ny, nx = c.shape[1:]
    off = c.phase_offset
    n = off + coeffs.shape[1]
    z = orthonormalize(zernike_basis(max(n, c.n_zern), ny, nx, c.radius * c.dxy * nx, normalize=True,
                                     radial=c.radial))
    return np.tensordot(coeffs, z[off:n], axes=1)


def diversity_psfs(model, params, phases) -> torch.Tensor:
    """The D diversity-channel PSFs ``(D,) + model.shape``
    (``diversity.py:147-172``): channel d's pupil field is the model's with
    ``theta_d`` added to the phase; every D*Nz plane in one ``fft2``."""
    rho, phi, psi, _ = model.compute_pupil(params)
    nz, ny, nx = model.shape
    theta = torch.as_tensor(phases, dtype=model.dtype, device=model.device)
    if theta.ndim != 3 or tuple(theta.shape[1:]) != (ny, nx):
        raise ValueError(f"phases must be (D, {ny}, {nx}), got {tuple(theta.shape)}")
    defoc = (2.0 * np.pi * model.config.dz) * model.z_wrapped
    full = phi[None, None] + theta[:, None] + defoc[None, :, None, None] * psi[None, None]
    a_hat = torch.fft.fft2(rho[None, None] * torch.exp(1j * full.to(model.cdtype)))
    return (a_hat.real ** 2 + a_hat.imag ** 2) * (1.0 / (nx * ny * nz))


def _rfft_multiplicity(shape, dtype) -> np.ndarray:
    """Conjugate-pair multiplicity of the halved last axis
    (``diversity.py:175-185``): 2, except the self-conjugate columns 0 and
    (even Nx) Nx/2; half-spectrum sums then equal full-spectrum ones."""
    nx = shape[-1]
    m = np.full(nx // 2 + 1, 2.0)
    m[0] = 1.0
    if nx % 2 == 0:
        m[-1] = 1.0
    return m.astype(dtype)


def _inputs(model, data, phases, image_weights):
    kw = dict(dtype=model.dtype, device=model.device)
    d = torch.as_tensor(data, **kw)
    w = None if image_weights is None else torch.as_tensor(image_weights, **kw)[:, None, None, None]
    return d, torch.as_tensor(phases, **kw), w


def _power(h_hat, wh):
    return torch.sum(h_hat.real * wh.real + h_hat.imag * wh.imag, dim=0)


def diversity_cost(model, data, phases, *, gamma: float = 1e-3, image_weights=None):
    """The object-profiled phase-diversity objective ``cost(params)``
    (``diversity.py:188-249``), for ``psf_fit.fit_families_with_cost``.
    ``data``: ``(D,) + model.shape``; ``phases``: ``(D, Ny, Nx)``; ``gamma``:
    the Tikhonov damping relative to the peak of the channel-summed OTF
    power; ``image_weights``: per-image inverse-variance weights ``(D,)``."""
    d, phases, w = _inputs(model, data, phases, image_weights)
    if d.ndim != 4 or tuple(d.shape[1:]) != tuple(model.shape):
        raise ValueError(f"data must be (D,) + {tuple(model.shape)}, got {tuple(d.shape)}; build the model with "
                         "psf_fit.model_at(model, img.shape)")
    if phases.shape[0] != d.shape[0]:
        raise ValueError(f"{d.shape[0]} images but {phases.shape[0]} diversity phases")
    y_hat = _rfftn(d)
    mult = torch.as_tensor(_rfft_multiplicity(model.shape, np.float32), dtype=model.dtype, device=model.device)
    n_vox = float(np.prod(model.shape))

    def cost(params):
        h_hat = _rfftn(diversity_psfs(model, params, phases))
        wh = h_hat if w is None else w * h_hat
        s = _power(h_hat, wh)
        g = gamma * torch.max(s).detach()
        x_hat = torch.sum(torch.conj(wh) * y_hat, dim=0) / (s + g)
        r = y_hat - h_hat * x_hat[None]
        r2 = r.real ** 2 + r.imag ** 2
        wr2 = torch.sum(r2 if w is None else w * r2, dim=0)
        e = wr2 + g * (x_hat.real ** 2 + x_hat.imag ** 2)
        return (0.5 / n_vox) * torch.sum(mult * e)

    return cost


def diversity_object_estimate(model, params, data, phases, *, gamma: float = 1e-3,
                              image_weights=None) -> torch.Tensor:
    """The profiled object at ``params``, the multi-frame Wiener restoration
    (``diversity.py:252-273``)."""
    d, phases, w = _inputs(model, data, phases, image_weights)
    y_hat = _rfftn(d)
    with torch.no_grad():
        h_hat = _rfftn(diversity_psfs(model, params, phases))
    wh = h_hat if w is None else w * h_hat
    s = _power(h_hat, wh)
    x_hat = torch.sum(torch.conj(wh) * y_hat, dim=0) / (s + gamma * torch.max(s))
    return torch.fft.irfftn(x_hat, s=tuple(model.shape)).to(model.dtype)


def _freeze_head(model, phase_freeze_head):
    """``None`` pins Z4 for volumetric models with >= 2 phase modes."""
    if phase_freeze_head is None:
        return 1 if (model.shape[0] > 1 and model.config.n_phase >= 2) else 0
    return phase_freeze_head


def diversity_fit_uncertainty(
    model,
    params,
    families: tuple[int, ...],
    data,
    phases,
    *,
    gamma: float = 1e-3,
    image_weights=None,
    sigma: float | None = None,
    phase_freeze_head: int | None = None,
) -> FitUncertainty:
    """1-sigma error bars of a :func:`fit_psf_diversity` solution
    (``diversity.py:276-410``): the Fisher information of the
    object-profiled problem, the Schur complement of the joint Gaussian
    Fisher, separable per Fourier mode,

        M_ij = (1/N) sum_k m_k |Xhat_k|^2 [ sum_d Re(conj(A_dki) A_dkj)
                                            - Re(conj(u_ki) u_kj) / (S_k + gamma_abs) ],

    ``u_ki = sum_d conj(H_dk) A_dki``, ``A`` the OTF Jacobian by forward
    mode; ``cov = sigma^2 M^-1``. ``sigma`` defaults to the profiled
    residual's estimate with ``(D - 1) N - k`` degrees of freedom.
    ``phase_freeze_head`` must match the fit's (None: the same rule); frozen
    entries of ``std`` are NaN. ``std`` is a ``{family: tensor}`` dict."""
    d, phases, w = _inputs(model, data, phases, image_weights)
    n_img = d.shape[0]
    y_hat = _rfftn(d)
    mult = torch.as_tensor(_rfft_multiplicity(model.shape, np.float64), dtype=model.dtype, device=model.device)
    n_vox = float(np.prod(model.shape))
    phase_freeze_head = _freeze_head(model, phase_freeze_head)
    names = tuple(family_name(f) for f in families)
    freeze = {nm: (phase_freeze_head if nm == "phase" else 0) for nm in names}
    for nm in names:
        if not 0 <= freeze[nm] < getattr(params, nm).shape[0]:
            raise ValueError(f"phase_freeze_head={freeze[nm]} out of range for {nm!r}")
    sizes = [int(getattr(params, nm).shape[0]) - freeze[nm] for nm in names]
    x0 = torch.cat([getattr(params, nm).detach()[freeze[nm]:] for nm in names])

    def otf(v):
        sub, off = {}, 0
        for nm, sz in zip(names, sizes):
            full = getattr(params, nm).detach()
            sub[nm] = torch.cat([full[:freeze[nm]], v[off:off + sz]])
            off += sz
        return _rfftn(diversity_psfs(model, params._replace(**sub), phases))

    with torch.no_grad():
        h_hat = otf(x0)  # (D, ...) complex
    # jacfwd takes real outputs only: the OTF as (..., 2) real pairs, back to
    # complex with the coefficient axis last, (D, ..., k).
    jac = torch.func.jacfwd(lambda v: torch.view_as_real(otf(v)))(x0)
    a = torch.view_as_complex(jac.movedim(-1, -2).contiguous())
    wh = h_hat if w is None else w * h_hat
    s = _power(h_hat, wh)
    g = gamma * torch.max(s)
    x_hat = torch.sum(torch.conj(wh) * y_hat, dim=0) / (s + g)
    x2 = x_hat.real ** 2 + x_hat.imag ** 2
    wa = a if w is None else w[..., None] * a
    aa = torch.einsum("d...i,d...j->...ij", torch.conj(a), wa).real
    u = torch.einsum("d...,d...i->...i", torch.conj(h_hat), wa)
    uu = torch.einsum("...i,...j->...ij", torch.conj(u), u).real / (s + g)[..., None, None]
    m = torch.einsum("zyx,zyxij->ij", (mult * x2).reshape(s.shape), aa - uu) / n_vox
    m = 0.5 * (m + m.T)
    k_model = x0.shape[0]
    if sigma is None:
        r = y_hat - h_hat * x_hat[None]
        if w is not None:
            r = r * torch.sqrt(w)
        rss = torch.sum(mult * torch.sum(r.real ** 2 + r.imag ** 2, dim=0)) / n_vox
        sigma2 = rss / max((n_img - 1) * n_vox - k_model, 1.0)
        sigma_out = torch.sqrt(sigma2)
    else:
        sigma_out = torch.as_tensor(sigma, dtype=model.dtype, device=model.device)
        sigma2 = sigma_out * sigma_out
    # solve_ex: a singular Fisher matrix (an unidentifiable family) gives
    # non-finite error bars, as jnp.linalg.solve does, instead of raising.
    cov = sigma2 * torch.linalg.solve_ex(m, torch.eye(k_model, dtype=m.dtype, device=m.device))[0]
    std_all = torch.sqrt(torch.diagonal(cov))
    std, off = {}, 0
    for nm, sz in zip(names, sizes):
        part = std_all[off:off + sz]
        if freeze[nm]:
            part = torch.cat([torch.full((freeze[nm],), float("nan"), dtype=part.dtype, device=part.device), part])
        std[nm] = part
        off += sz
    return FitUncertainty(std, cov, sigma_out)


def fit_psf_diversity(
    model,
    data,
    phases,
    families: tuple[int, ...] = (PHASE,),
    params0=None,
    config: PsfFitConfig | None = None,
    *,
    gamma: float = 1e-3,
    image_weights=None,
    phase_active: int | None = None,
    phase_freeze_head: int | None = None,
    phase_anchor: torch.Tensor | None = None,
    phase_prior_weight: float = 0.0,
    aux_terms: tuple = (),
) -> PsfFitResult:
    """Pupil parameters from D diversity images of one unknown object
    (``diversity.py:413-458``), the object profiled out exactly
    (:func:`diversity_cost`). ``phase_freeze_head=None`` pins Z4 for
    volumetric models (the object-z-shift gauge) and frees it for planar
    ones. The family-fit semantics are ``fit_psf``'s: graduated
    ``phase_active``, the calibration prior, auxiliary bead terms.
    Reconstruct with :func:`diversity_object_estimate` or a regularized
    solve."""
    if params0 is None:
        params0 = model.init_params()
    if config is None:
        config = PsfFitConfig()
    cost = diversity_cost(model, data, phases, gamma=gamma, image_weights=image_weights)
    return fit_families_with_cost(cost, params0, tuple(family_name(f) for f in families), config,
                                  phase_active=phase_active, phase_freeze_head=_freeze_head(model, phase_freeze_head),
                                  phase_anchor=phase_anchor, phase_prior_weight=phase_prior_weight,
                                  aux_terms=aux_terms)
