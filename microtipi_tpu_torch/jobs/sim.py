"""Structured-illumination microscopy (SIM) reconstruction, lateral 2x.

Port of ``microtipi_tpu/jobs/sim.py``. Linear SIM (Gustafsson 2000;
Heintzmann and Cremer 1999) illuminates the sample with a sinusoid at A
angles x P phases; each raw image downmixes object frequencies ``k -+ p``
into the OTF passband, and the reconstruction recovers lateral support up to
``|k| + |p|``. Per angle a and phase j (2D protocol):

    D_aj(k) = H(k) [ S(k) + (m/2) e^{+i phi_aj} S(k - p_a) + (m/2) e^{-i phi_aj} S(k + p_a) ]

:func:`separate_bands` inverts the P x 3 phase matrix per angle;
:func:`reconstruct_sim` shifts each sideband to its frequency on a 2x grid
(real-space modulation, an exact subpixel shift) and combines the bands with
matched-filter weights and Wiener damping, apodized by a triangle;
:func:`estimate_sim_pattern` refines the pattern frequency and phase offset
per angle from the data by maximizing the phase coherence of the
sideband-carrier product over zoomed 5x5 grids of subpixel candidates.

The 3D protocol (3-beam, >= 5 phases, Gustafsson et al. 2008) adds +-1
orders that carry an axial frequency q inside their effective OTFs
(:func:`sim3d_order_otfs`, :func:`simulate_sim3d`,
:func:`separate_bands_3d`, :func:`reconstruct_sim3d`).

Everything runs on the device of the data. The JAX package ran the pattern
estimation in host NumPy because its TPU runtime dispatches eagerly and has
no float64 (``sim.py:156-172,204-211``), and switched its 3D FFTs to a
matmul DFT there (``auto_exact_fft``); neither is ported: here each zoom
level's 25 candidates are one batched float64 FFT on the card, and every
FFT is cuFFT.
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "SIMReconstruction",
    "estimate_sim_pattern",
    "reconstruct_sim",
    "reconstruct_sim3d",
    "separate_bands",
    "separate_bands_3d",
    "sim3d_order_otfs",
    "simulate_sim",
    "simulate_sim3d",
]

#: 3D-SIM illumination orders in band-index order (m = lateral order; the
#: +-1 orders carry the axial +-q sidebands inside their effective OTFs).
ORDERS_3D = (0, 1, -1, 2, -2)


def _cdtype(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype in (torch.float64, torch.complex128) else torch.complex64


def _rdtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype in (torch.float64, torch.complex128) else torch.float32


def _fft2c(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.fft2(x.to(_cdtype(x.dtype)))


def _fftnc(x: torch.Tensor) -> torch.Tensor:
    """The 3D FFT over the trailing (Nz, Ny, Nx) axes; leading axes are batch."""
    return torch.fft.fftn(x.to(_cdtype(x.dtype)), dim=(-3, -2, -1))


def _ifftn3(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.ifftn(x, dim=(-3, -2, -1))


def _phase_ramp(shape, p, dtype: torch.dtype, device) -> torch.Tensor:
    """``e^{i 2 pi p . r}`` on the (Ny, Nx) grid: the real-space modulation
    that shifts a spectrum by +p (p in cycles/pixel, (py, px)); the phase is
    float64 on the host, as in ``sim.py:83-92``."""
    ny, nx = shape
    ph = 2.0 * np.pi * (p[0] * np.arange(ny)[:, None] + p[1] * np.arange(nx)[None, :])
    return torch.exp(1j * torch.as_tensor(ph, device=device).to(_cdtype(dtype)))


def _device_of(x):
    if isinstance(x, torch.Tensor):
        return x.device
    if not torch.cuda.is_available():
        raise RuntimeError("the SIM functions run on the CUDA card by default and none is available; "
                           "pass CPU tensors to run them on the CPU")
    return torch.device("cuda")


def simulate_sim(x, otf, pattern_k, phases, modulation: float = 1.0) -> torch.Tensor:
    """Raw SIM images ``(A, P, Ny, Nx)`` of a 2D object (``sim.py:95-119``):
    ``otf`` the fft2 of the corner-origin 2D PSF at the camera grid,
    ``pattern_k`` ``(A, 2)`` cycles/pixel ``(ky, kx)``, ``phases`` ``(A, P)``
    radians. The pattern convention is :func:`separate_bands`'s."""
    dev = _device_of(x)
    x = torch.as_tensor(x, device=dev)
    otf = torch.as_tensor(otf, device=dev)
    a_k = np.asarray(pattern_k, np.float64)
    phases = np.asarray(phases, np.float64)
    out = []
    for a in range(a_k.shape[0]):
        ramp = _phase_ramp(x.shape, a_k[a], x.dtype, dev)
        shifts = torch.as_tensor(np.exp(1j * phases[a]), device=dev).to(ramp.dtype)[:, None, None]
        illum = 1.0 + modulation * torch.real(ramp[None] * shifts)
        out.append(torch.real(torch.fft.ifft2(_fft2c(x[None] * illum) * otf)).to(x.dtype))
    return torch.stack(out)


def _phase_pinv(phases_a: np.ndarray, orders, scale: float) -> np.ndarray:
    """The (bands, P) pseudo-inverse of the phase matrix of one angle."""
    m = np.stack([np.ones(phases_a.shape[0], np.complex128) if o == 0 else scale * np.exp(1j * o * phases_a)
                  for o in orders], axis=1)
    return np.linalg.pinv(m)


def separate_bands(data, phases, modulation: float = 1.0) -> torch.Tensor:
    """Carrier and sidebands per angle, ``(A, 3, Ny, Nx)`` complex
    (``sim.py:122-153``): ``[b0, b+, b-]`` with ``b0 = H S(k)`` and ``b+- =
    H S(k -+ p)``, the ``m/2`` divided out; the phase matrix is inverted by
    least squares (exactly at P = 3)."""
    d = torch.as_tensor(data, device=_device_of(data))
    if d.ndim != 4:
        raise ValueError(f"data must be (A, P, Ny, Nx), got {tuple(d.shape)}")
    a_n, p_n = d.shape[:2]
    phases = np.asarray(phases, np.float64)
    if phases.shape != (a_n, p_n):
        raise ValueError(f"phases must be ({a_n}, {p_n}), got {phases.shape}")
    if p_n < 3:
        raise ValueError("band separation needs >= 3 pattern phases")
    spec = _fft2c(d)
    return torch.stack([
        torch.einsum("bp,pyx->byx",
                     torch.as_tensor(_phase_pinv(phases[a], (0, 1, -1), 0.5 * modulation), device=d.device)
                     .to(spec.dtype), spec[a])
        for a in range(a_n)])


def estimate_sim_pattern(data, otf, pattern_k0, phases0, modulation: float = 1.0, refine_radius: int = 2,
                         iterations: int = 2, support: float = 0.05):
    """Refine the pattern frequencies and the per-angle phase offsets from
    the data (``sim.py:175-262``), in float64 on the data's device.

    Bands separated with phases off by a common ``delta`` are exactly
    ``e^{+-i delta}`` times the true ones, so at the true frequency the
    per-bin product ``q(k) = b+(k + p) conj(b0(k))`` has constant phase
    ``delta`` over the band overlap (bins where both OTFs exceed ``support``
    of the peak). The estimator maximizes the coherence ``|sum q| / sum |q|``
    over a (2r+1)^2 grid of whole-bin shifts, then 5x5 grids of 0.5, 0.1,
    0.02 and 0.004 bins (each grid one batched FFT; the winner is the first
    maximum in row-major (dy, dx) order), and reads ``delta = angle(sum q)``
    at the optimum; ``iterations`` rounds, because frequency and phase couple
    through the separation. The relative phase steps of ``phases0`` are
    trusted. Returns ``(pattern_k, phases)`` as NumPy arrays.
    """
    dev = _device_of(data)
    d = torch.as_tensor(data, device=dev).to(torch.float64)
    a_k = np.asarray(pattern_k0, np.float64).copy()
    ph = np.asarray(phases0, np.float64).copy()
    ny, nx = d.shape[2:]
    yg = torch.arange(ny, dtype=torch.float64, device=dev)[None, :, None]
    xg = torch.arange(nx, dtype=torch.float64, device=dev)[None, None, :]
    h = torch.as_tensor(otf, device=dev).to(torch.complex128)
    habs = torch.abs(h)
    thresh = support * habs.max()
    h_img = torch.fft.ifft2(h)

    for _ in range(int(iterations)):
        bands = separate_bands(d, ph, modulation)
        for a in range(a_k.shape[0]):
            base = a_k[a].copy()
            ip = torch.fft.ifft2(bands[a, 1])
            # The overlap mask at the nominal shift: candidates move < 1 bin,
            # and one static mask keeps them comparable.
            ramp0 = torch.exp(2j * math.pi * (base[0] * yg + base[1] * xg))[0]
            h_shift = torch.fft.fft2(h_img * torch.conj(ramp0))
            mask = (habs > thresh) & (torch.abs(h_shift) > thresh)
            b0m = torch.where(mask, torch.conj(bands[a, 0]), torch.zeros_like(bands[a, 0]))

            def best(dys, dxs):
                """The first maximum of the coherence over the candidates
                (dys x dxs, row-major) and its sum q."""
                cy, cx = np.meshgrid(np.asarray(dys, np.float64), np.asarray(dxs, np.float64), indexing="ij")
                py = torch.as_tensor(base[0] + cy.reshape(-1) / ny, device=dev)[:, None, None]
                px = torch.as_tensor(base[1] + cx.reshape(-1) / nx, device=dev)[:, None, None]
                q = torch.fft.fft2(ip * torch.exp(-2j * math.pi * (py * yg + px * xg))) * b0m
                sq = q.sum(dim=(1, 2))
                coh = torch.abs(sq) / torch.clamp_min(torch.abs(q).sum(dim=(1, 2)), 1e-300)
                i = int(torch.argmax(coh))
                return float(cy.reshape(-1)[i]), float(cx.reshape(-1)[i]), sq[i]

            r = int(refine_radius)
            fy, fx, sq = best(np.arange(-r, r + 1), np.arange(-r, r + 1))
            for step in (0.5, 0.1, 0.02, 0.004):
                fy, fx, sq = best(np.linspace(fy - 2 * step, fy + 2 * step, 5),
                                  np.linspace(fx - 2 * step, fx + 2 * step, 5))
            a_k[a] += np.array([fy / ny, fx / nx])
            ph[a] += float(torch.angle(sq))
    return a_k, ph


class SIMReconstruction(NamedTuple):
    """Outcome of :func:`reconstruct_sim` and :func:`reconstruct_sim3d`."""

    x: torch.Tensor  # reconstructed object on the 2x-upsampled grid
    spectrum_weight: torch.Tensor  # sum_b |H_b|^2 on the extended grid (support diagnostic)


def _zeropad_spectrum(spec: torch.Tensor, out_shape) -> torch.Tensor:
    """A corner-origin spectrum zero-padded onto a finer grid of the same
    field of view (``sim.py:460-482``): each axis's low half keeps its place,
    the high half moves to the end, the new mid-band is zero; an axis of
    equal size passes through."""
    big = torch.zeros(tuple(out_shape), dtype=spec.dtype, device=spec.device)
    per_axis = []
    for n, n2 in zip(spec.shape, out_shape):
        h = n // 2
        if n2 == n:
            per_axis.append([(slice(0, n), slice(0, n))])
        else:
            per_axis.append([(slice(0, h), slice(0, h)), (slice(h, n), slice(n2 - (n - h), n2))])
    for combo in itertools.product(*per_axis):
        big[tuple(c[1] for c in combo)] = spec[tuple(c[0] for c in combo)]
    return big


def reconstruct_sim(data, otf, pattern_k, phases, modulation: float = 1.0, wiener: float = 1e-2,
                    apodize: bool = True) -> SIMReconstruction:
    """Generalized-Wiener SIM reconstruction on a 2x grid
    (``sim.py:272-362``): ``data`` ``(A, P, Ny, Nx)``, ``otf`` the fft2 of the
    corner-origin 2D PSF at the camera grid, ``pattern_k`` ``(A, 2)``
    cycles/pixel, ``phases`` ``(A, P)``; ``wiener`` is relative to the
    carrier OTF's peak. The division is apodized by a triangle to the
    extended support unless ``apodize`` is off."""
    dev = _device_of(data)
    d = torch.as_tensor(data, device=dev)
    otf = torch.as_tensor(otf, device=dev)
    bands = separate_bands(d, phases, modulation)
    a_n = d.shape[0]
    ny, nx = d.shape[2:]
    fine = (2 * ny, 2 * nx)
    rdtype = _rdtype(d.dtype)
    otf_big = _zeropad_spectrum(otf, fine)
    otf_big_img = torch.fft.ifft2(otf_big)  # shared by every sideband
    num = torch.zeros(fine, dtype=_cdtype(rdtype), device=dev)
    a_k = np.asarray(pattern_k, np.float64)
    # The carrier: a numerator an angle, one shared denominator term x A.
    for a in range(a_n):
        num = num + torch.conj(otf_big) * _zeropad_spectrum(bands[a, 0], fine)
    den = torch.zeros(fine, dtype=rdtype, device=dev) + a_n * (otf_big.real ** 2 + otf_big.imag ** 2)
    for a in range(a_n):
        # b+ = H S(k - p) moves to its frequency by -p, b- by +p (band and
        # OTF weight alike); on the fine grid p is halved.
        for b, sign in ((1, -1.0), (2, +1.0)):
            ramp = _phase_ramp(fine, sign * a_k[a] / 2.0, rdtype, dev)
            big_b = torch.fft.fft2(torch.fft.ifft2(_zeropad_spectrum(bands[a, b], fine)) * ramp)
            big_h = torch.fft.fft2(otf_big_img * ramp)
            num = num + torch.conj(big_h) * big_b
            den = den + big_h.real ** 2 + big_h.imag ** 2
    otf_peak = torch.max(torch.sqrt(otf.real ** 2 + otf.imag ** 2))
    s_hat = num / (den + (wiener * otf_peak) ** 2)
    if apodize:
        kmax = 0.5 + float(np.max(np.hypot(a_k[:, 0], a_k[:, 1])))
        fy = np.fft.fftfreq(fine[0]) * 2.0  # original cycles/pixel
        fx = np.fft.fftfreq(fine[1]) * 2.0
        rr = np.hypot(fy[:, None], fx[None, :])
        s_hat = s_hat * torch.as_tensor(np.clip(1.0 - rr / kmax, 0.0, 1.0), device=dev).to(rdtype)
    return SIMReconstruction(torch.real(torch.fft.ifft2(s_hat)).to(rdtype), den)


# 3D-SIM (3-beam). The three-beam interference
#   I(rho, z) = 1 + m1 cos(2 pi p.rho + phi_j) cos(2 pi q z + psi) + m2 cos(2 (2 pi p.rho + phi_j))
# is fixed to the objective while the sample is z-scanned, so the axial
# profile multiplies the detection PSF and the lateral modulation the object:
#   D_j = sum_{m=-2..2} e^{i m phi_j} [ (x e^{i m 2 pi p.rho}) (*) h c_m ],
# c_0 = 1, c_{+-1}(z) = (m1/2) cos(2 pi q z + psi), c_{+-2} = m2/2 (sim.py:365-386).


def _wrapped_coord(n: int) -> np.ndarray:
    i = np.arange(n)
    return np.where(i > n // 2, i - n, i).astype(np.float64)


def sim3d_order_otfs(psf, q: float, psi: float = 0.0, m1: float = 1.0, m2: float = 1.0) -> torch.Tensor:
    """Effective OTFs of the five 3D-SIM orders ``(5, Nz, Ny, Nx)`` complex
    (``sim.py:422-442``), in :data:`ORDERS_3D` order: ``O_m = FFT3[h c_m(z)]``
    on the signed wrapped plane index. ``q`` is the axial pattern frequency
    in cycles per plane, ``psi`` its phase at the focal plane."""
    h = torch.as_tensor(psf, device=_device_of(psf))
    c1 = 0.5 * m1 * np.cos(2.0 * np.pi * q * _wrapped_coord(h.shape[0]) + psi)
    c1 = torch.as_tensor(c1, device=h.device).to(h.dtype)[:, None, None]
    o0 = _fftnc(h)
    o1 = _fftnc(h * c1)
    o2 = (0.5 * m2) * o0
    return torch.stack([o0, o1, o1, o2, o2])


def simulate_sim3d(x, psf, pattern_k, phases, q: float, psi: float = 0.0, m1: float = 1.0,
                   m2: float = 1.0) -> torch.Tensor:
    """Raw 3D-SIM stacks ``(A, P, Nz, Ny, Nx)`` (``sim.py:445-482``): ``x`` the
    3D object, ``psf`` the corner-origin detection PSF, ``pattern_k`` ``(A, 2)``
    lateral frequencies in cycles/pixel (the +-2 orders at twice that),
    ``phases`` ``(A, P)`` with P >= 5 for separability."""
    dev = _device_of(x)
    x = torch.as_tensor(x, device=dev)
    otfs = sim3d_order_otfs(torch.as_tensor(psf, device=dev), q, psi, m1, m2)
    a_k = np.asarray(pattern_k, np.float64)
    phases = np.asarray(phases, np.float64)
    cdtype = otfs.dtype
    out = []
    for a in range(a_k.shape[0]):
        ramp = _phase_ramp(x.shape[1:], a_k[a], x.dtype, dev)[None]
        # The blurred component of every order, mixed by each phase.
        comps = []
        for i, m in enumerate(ORDERS_3D):
            xm = x.to(cdtype) if m == 0 else (x * (ramp ** m if m > 0 else torch.conj(ramp) ** (-m))).to(cdtype)
            comps.append(_ifftn3(_fftnc(xm) * otfs[i]))
        row = []
        for j in range(phases.shape[1]):
            d = comps[0]
            for i, m in enumerate(ORDERS_3D):
                if m:
                    d = d + complex(np.exp(1j * m * phases[a, j])) * comps[i]
            row.append(torch.real(d).to(x.dtype))
        out.append(torch.stack(row))
    return torch.stack(out)


def separate_bands_3d(data, phases) -> torch.Tensor:
    """The five 3D-SIM orders per angle, ``(A, 5, Nz, Ny, Nx)`` complex
    (``sim.py:485-513``): ``B_m(k) = O_m(k) S(k - m p)`` in :data:`ORDERS_3D`
    order, by least squares (exactly at P = 5); the modulation depths stay
    in the effective OTFs."""
    d = torch.as_tensor(data, device=_device_of(data))
    if d.ndim != 5:
        raise ValueError(f"data must be (A, P, Nz, Ny, Nx), got {tuple(d.shape)}")
    a_n, p_n = d.shape[:2]
    phases = np.asarray(phases, np.float64)
    if phases.shape != (a_n, p_n):
        raise ValueError(f"phases must be ({a_n}, {p_n}), got {phases.shape}")
    if p_n < 5:
        raise ValueError("3D band separation needs >= 5 pattern phases")
    spec = _fftnc(d)
    return torch.stack([
        torch.einsum("bp,pzyx->bzyx",
                     torch.as_tensor(_phase_pinv(phases[a], ORDERS_3D, 1.0), device=d.device).to(spec.dtype),
                     spec[a])
        for a in range(a_n)])


def reconstruct_sim3d(data, psf, pattern_k, phases, q: float, psi: float = 0.0, m1: float = 1.0, m2: float = 1.0,
                      wiener: float = 1e-2, apodize: bool = True, upsample_z: bool = True) -> SIMReconstruction:
    """Generalized-Wiener 3D-SIM reconstruction on a 2x lateral (and by
    default 2x axial) grid (``sim.py:516-603``): each band shifted to its
    lateral frequency together with its effective OTF, all five orders x A
    angles combined with matched-filter weights and Wiener damping, a
    separable triangle apodization. ``upsample_z=False`` keeps the axial
    grid when ``kz_max + q`` still fits under its Nyquist."""
    dev = _device_of(data)
    d = torch.as_tensor(data, device=dev)
    bands = separate_bands_3d(d, phases)
    a_n = d.shape[0]
    nz, ny, nx = d.shape[2:]
    fine = (2 * nz if upsample_z else nz, 2 * ny, 2 * nx)
    rdtype = _rdtype(d.dtype)
    cdtype = _cdtype(rdtype)
    otfs = sim3d_order_otfs(torch.as_tensor(psf, device=dev), q, psi, m1, m2)
    a_k = np.asarray(pattern_k, np.float64)
    o0_big = _zeropad_spectrum(otfs[0].to(cdtype), fine)
    num = torch.zeros(fine, dtype=cdtype, device=dev)
    for a in range(a_n):
        num = num + torch.conj(o0_big) * _zeropad_spectrum(bands[a, 0].to(cdtype), fine)
    den = torch.zeros(fine, dtype=rdtype, device=dev) + a_n * (o0_big.real ** 2 + o0_big.imag ** 2)
    for i, m in enumerate(ORDERS_3D):
        if m == 0:
            continue
        o_big_img = _ifftn3(_zeropad_spectrum(otfs[i].to(cdtype), fine))
        for a in range(a_n):
            # Band m carries S(k - m p): shift band and OTF by -m p (p halves
            # on the fine lateral grid).
            ramp = _phase_ramp(fine[1:], -m * a_k[a] / 2.0, rdtype, dev)[None]
            big_b = torch.fft.fftn(_ifftn3(_zeropad_spectrum(bands[a, i].to(cdtype), fine)) * ramp,
                                   dim=(-3, -2, -1))
            big_h = torch.fft.fftn(o_big_img * ramp, dim=(-3, -2, -1))
            num = num + torch.conj(big_h) * big_b
            den = den + big_h.real ** 2 + big_h.imag ** 2
    otf_peak = torch.max(torch.abs(otfs[0].real))  # H(0), real and positive
    s_hat = num / (den + (wiener * otf_peak) ** 2)
    if apodize:
        kmax_lat = 0.5 + float(np.max(np.hypot(a_k[:, 0], a_k[:, 1]))) * 2.0
        fy = np.fft.fftfreq(fine[1]) * 2.0  # original lateral cycles/pixel
        fx = np.fft.fftfreq(fine[2]) * 2.0
        apo_lat = np.clip(1.0 - np.hypot(fy[:, None], fx[None, :]) / kmax_lat, 0.0, 1.0)
        fz = np.fft.fftfreq(fine[0]) * (2.0 if upsample_z else 1.0)
        apo_ax = np.clip(1.0 - np.abs(fz) / (0.5 + float(q)), 0.0, 1.0)
        s_hat = s_hat * torch.as_tensor(apo_ax[:, None, None] * apo_lat[None], device=dev).to(rdtype)
    return SIMReconstruction(torch.real(_ifftn3(s_hat)).to(rdtype), den)
