"""Noll-indexed Zernike polynomial basis on the FFT frequency grid.

Capability parity with the reference's ``microUtils/Zernike.java`` plus the
orthonormalization step the reference applies on top
(``epifluorescence/WideFieldModel.java:194-197``):

- Noll index -> (n, m)                      (``Zernike.java:37-52``)
- radial coefficients via cumulative-log    (``Zernike.java:70-90``)
- sampling on the wrapped FFT grid          (``Zernike.java:125-126``)
- optional radial-only (m = 0) basis        (``Zernike.java:132-134,165-198``)
- per-mode L2 normalization                 (``Zernike.java:154-161`` et al.)
- Gram-Schmidt orthonormalization           (``WideFieldModel.java:196``)

The basis depends only on static geometry (shape, pupil radius), so it is
computed once in NumPy float64 and registered as a buffer of the PSF model.

Downstream, synthesis of the pupil modulus/phase from coefficients is a single
``(K, Npix) x (K,)`` contraction; the basis is stored as a dense
``(K, Ny, Nx)`` stack for that reason. A verbatim copy of
``microtipi_tpu/ops/zernike.py`` apart from this note and the grids import;
``tests/test_torch_geometry.py`` pins bit-equality with it.
"""

from __future__ import annotations

import numpy as np

from microtipi_tpu_torch.utils.grids import fft_angle, fft_dist

__all__ = [
    "noll_to_nm",
    "radial_coefficients",
    "zernike_basis",
    "orthonormalize",
]


def noll_to_nm(j: int) -> tuple[int, int]:
    """Map 1-based Noll index ``j`` to (radial degree n, azimuthal |m|).

    Same arithmetic as the reference (``Zernike.java:37-52``).
    """
    n1 = (np.sqrt(1 + 8 * j) - 1) / 2
    n = int(np.floor(n1))
    if n1 == n:
        n -= 1
    k = (n + 1) * (n + 2) // 2
    m = int(n - 2 * np.floor((k - j) / 2))
    return n, m


def radial_coefficients(n: int, m: int) -> np.ndarray:
    """Coefficients of R^m_n, computed in log space for stability.

    ``R^m_n(r) = sum_s coeff[s] * r^(n-2s)``, s = 0..(n-m)/2, with
    ``coeff[s] = (-1)^s (n-s)! / (s! ((n+m)/2-s)! ((n-m)/2-s)!)``
    (``Zernike.java:70-90``).
    """
    p = (n - m) // 2
    q = (n + m) // 2
    lfact = np.concatenate([[0.0], np.cumsum(np.log(np.arange(1, n + 1)))]) if n > 0 else np.zeros(1)
    coeffs = np.zeros(p + 1)
    for s in range(p + 1):
        c = np.exp(lfact[n - s] - lfact[s] - lfact[p - s] - lfact[q - s])
        coeffs[s] = -c if s % 2 else c
    return coeffs


def _radial_poly(n: int, m: int, r_norm: np.ndarray, inside: np.ndarray) -> np.ndarray:
    """Evaluate R^m_n on the normalized radius, zero outside the pupil."""
    coeffs = radial_coefficients(n, m)
    out = np.zeros_like(r_norm)
    for s, c in enumerate(coeffs):
        out += c * np.where(inside, r_norm ** (n - 2 * s), 0.0)
    return np.where(inside, out, 0.0)


def zernike_basis(
    n_modes: int,
    ny: int,
    nx: int,
    radius_px: float,
    normalize: bool = True,
    radial: bool = False,
) -> np.ndarray:
    """Stack of ``n_modes`` Zernike modes, shape ``(n_modes, ny, nx)``.

    Sampled on the wrapped FFT grid with pupil support ``r < radius_px``
    (strict, matching ``Zernike.java:146``). Mode 0 is the piston. With
    ``radial=True`` only m = 0 modes are produced, mode ``k`` having radial
    degree ``k`` (``Zernike.java:165-198``); otherwise modes follow Noll order
    with the cos/sin split on Noll parity (``Zernike.java:240-284``).

    Noll normalization factors sqrt(n+1) / sqrt(2(n+1)) are applied, then each
    mode is optionally L2-normalized over the full grid.
    """
    r = fft_dist(ny, nx)
    theta = fft_angle(ny, nx)
    inside = r < radius_px
    r_norm = np.where(inside, r / radius_px, 0.0)

    modes = np.zeros((n_modes, ny, nx))
    modes[0] = np.where(inside, 1.0, 0.0)  # piston

    for k in range(1, n_modes):
        if radial:
            n, m = k, 0
            z = np.sqrt(n + 1) * _radial_poly(n, m, r_norm, inside)
        else:
            j = k + 1  # 1-based Noll index
            n, m = noll_to_nm(j)
            rad = _radial_poly(n, m, r_norm, inside)
            if m == 0:
                z = np.sqrt(n + 1) * rad
            elif j % 2 == 0:  # even Noll index -> cosine
                z = np.sqrt(2 * (n + 1)) * rad * np.cos(m * theta)
            else:  # odd Noll index -> sine
                z = np.sqrt(2 * (n + 1)) * rad * np.sin(m * theta)
        modes[k] = z

    if normalize:
        norms = np.sqrt((modes ** 2).sum(axis=(1, 2)))
        norms = np.where(norms > 0, norms, 1.0)
        modes /= norms[:, None, None]
    return modes


def orthonormalize(modes: np.ndarray) -> np.ndarray:
    """Modified Gram-Schmidt orthonormalization of a mode stack.

    Equivalent of ``MathUtils.gram_schmidt_orthonormalization`` applied by the
    reference after building the basis (``WideFieldModel.java:196``): modes are
    orthonormalized in order against all previous ones under the plain L2
    inner product over the grid.
    """
    k, ny, nx = modes.shape
    q = modes.reshape(k, -1).astype(np.float64).copy()
    for i in range(k):
        for j in range(i):
            q[i] -= (q[j] @ q[i]) * q[j]
        nrm = np.linalg.norm(q[i])
        if nrm > 1e-30:
            q[i] /= nrm
    return q.reshape(k, ny, nx)
