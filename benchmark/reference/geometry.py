"""Pupil-plane geometry in NumPy float64: wrapped FFT grids, the Noll
Zernike basis with its Gram-Schmidt orthonormalisation, and the pupil's
geometric support.

Frozen copies of the port's ``utils/grids.py``, ``ops/zernike.py`` and
``ops/pupil.geometric_mask``, after TiPi's ``MathUtils.fftDist1D`` and
``fftAngle1D``, ``Zernike.java:37-284`` and ``WideFieldModel.java:194-197,
1374-1406``. Nothing here is differentiated.
"""

from __future__ import annotations

import numpy as np

__all__ = ["fft_index", "geometric_mask", "orthonormalize", "zernike_basis"]


def fft_index(n: int) -> np.ndarray:
    """Signed wrapped index ``[0, 1, ..., n//2, n//2+1-n, ..., -1]`` (``n//2``
    stays positive, as in ``WideFieldModel.java:1460-1466``)."""
    i = np.arange(n)
    return np.where(i > n // 2, i - n, i).astype(np.float64)


def _noll_to_nm(j: int) -> tuple[int, int]:
    n1 = (np.sqrt(1 + 8 * j) - 1) / 2
    n = int(np.floor(n1))
    if n1 == n:
        n -= 1
    k = (n + 1) * (n + 2) // 2
    return n, int(n - 2 * np.floor((k - j) / 2))


def _radial(n: int, m: int, r: np.ndarray, inside: np.ndarray) -> np.ndarray:
    p, q = (n - m) // 2, (n + m) // 2
    lf = np.concatenate([[0.0], np.cumsum(np.log(np.arange(1, n + 1)))]) if n > 0 else np.zeros(1)
    out = np.zeros_like(r)
    for s in range(p + 1):
        c = np.exp(lf[n - s] - lf[s] - lf[p - s] - lf[q - s])
        out += (-c if s % 2 else c) * np.where(inside, r ** (n - 2 * s), 0.0)
    return np.where(inside, out, 0.0)


def zernike_basis(n_modes: int, ny: int, nx: int, radius_px: float) -> np.ndarray:
    """``n_modes`` Noll-ordered modes on the wrapped grid, support
    ``r < radius_px``, each L2-normalised over the grid, (n_modes, ny, nx)."""
    ix = np.minimum(np.arange(nx), nx - np.arange(nx)).astype(np.float64)
    iy = np.minimum(np.arange(ny), ny - np.arange(ny)).astype(np.float64)
    r = np.sqrt(ix[None, :] ** 2 + iy[:, None] ** 2)
    theta = np.arctan2(fft_index(ny)[:, None], fft_index(nx)[None, :])
    inside = r < radius_px
    rn = np.where(inside, r / radius_px, 0.0)
    modes = np.zeros((n_modes, ny, nx))
    modes[0] = np.where(inside, 1.0, 0.0)
    for k in range(1, n_modes):
        j = k + 1
        n, m = _noll_to_nm(j)
        rad = _radial(n, m, rn, inside)
        if m == 0:
            modes[k] = np.sqrt(n + 1) * rad
        elif j % 2 == 0:
            modes[k] = np.sqrt(2 * (n + 1)) * rad * np.cos(m * theta)
        else:
            modes[k] = np.sqrt(2 * (n + 1)) * rad * np.sin(m * theta)
    norms = np.sqrt((modes ** 2).sum(axis=(1, 2)))
    return modes / np.where(norms > 0, norms, 1.0)[:, None, None]


def orthonormalize(modes: np.ndarray) -> np.ndarray:
    """Modified Gram-Schmidt over the modes in order (``WideFieldModel.java:196``)."""
    k = modes.shape[0]
    q = modes.reshape(k, -1).astype(np.float64).copy()
    for i in range(k):
        for j in range(i):
            q[i] -= (q[j] @ q[i]) * q[j]
        nrm = np.linalg.norm(q[i])
        if nrm > 1e-30:
            q[i] /= nrm
    return q.reshape(modes.shape)


def geometric_mask(ny: int, nx: int, radius: float, dxy: float) -> np.ndarray:
    """Frequencies strictly inside NA/lambda, 0/1 (``WideFieldModel.java:1378-1391``)."""
    kx = fft_index(nx) / (nx * dxy)
    ky = fft_index(ny) / (ny * dxy)
    return ((kx[None, :] ** 2 + ky[:, None] ** 2) < radius * radius).astype(np.float64)
