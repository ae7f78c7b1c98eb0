"""FFT-layout coordinate grids.

The reference samples every pupil-plane quantity on the *FFT frequency grid*
(wrapped / corner-origin layout): radius via ``MathUtils.fftDist1D`` and angle
via ``MathUtils.fftAngle1D`` (used at ``microUtils/Zernike.java:125-126``), and
the pupil mask / defocus use the same wrapped indexing
(``epifluorescence/WideFieldModel.java:1383-1391,1458-1481``).

These grids are static (shape-only) so they are built with NumPy in float64 at
setup time and handed to PyTorch as buffers; nothing here is differentiated.
A verbatim copy of ``microtipi_tpu/utils/grids.py`` (that package imports jax
on import); ``tests/test_torch_geometry.py`` pins bit-equality with it.

Array layout convention for the whole framework: volumes are ``(Nz, Ny, Nx)``
with x fastest — the reference uses flat index ``in = ix + Nx*iy`` and slices
over z (``WideFieldModel.java:241-255``), which is the same memory order.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "fft_dist",
    "fft_angle",
    "fft_index",
    "fft_freq2",
    "wrapped_z",
]


def fft_index(n: int) -> np.ndarray:
    """Signed wrapped index: ``[0, 1, ..., n//2, n//2+1-n, ..., -1]``.

    Matches the reference's wrap convention where index ``i > n/2`` maps to
    ``i - n`` (``WideFieldModel.java:1460-1466,1474-1480`` and the z fold at
    ``:232-239``). Note ``i == n//2`` stays *positive* (unlike numpy.fftfreq
    which makes it negative), which matters for even sizes.
    """
    i = np.arange(n)
    return np.where(i > n // 2, i - n, i).astype(np.float64)


def fft_dist(ny: int, nx: int) -> np.ndarray:
    """Wrapped radial distance in pixels on an ``(ny, nx)`` grid.

    Equivalent of TiPi ``MathUtils.fftDist1D`` as used by
    ``Zernike.zernikeArray`` (``microUtils/Zernike.java:125``): distance from
    the corner origin with wrap-around, i.e. ``sqrt(min(ix, nx-ix)^2 +
    min(iy, ny-iy)^2)``.
    """
    ix = np.minimum(np.arange(nx), nx - np.arange(nx)).astype(np.float64)
    iy = np.minimum(np.arange(ny), ny - np.arange(ny)).astype(np.float64)
    return np.sqrt(ix[None, :] ** 2 + iy[:, None] ** 2)


def fft_angle(ny: int, nx: int) -> np.ndarray:
    """Wrapped azimuthal angle ``atan2(ky, kx)`` on an ``(ny, nx)`` grid.

    Equivalent of TiPi ``MathUtils.fftAngle1D`` (``microUtils/Zernike.java:126``),
    with signed wrapped coordinates.
    """
    kx = fft_index(nx)
    ky = fft_index(ny)
    return np.arctan2(ky[:, None], kx[None, :])


def fft_freq2(ny: int, nx: int, dxy: float) -> tuple[np.ndarray, np.ndarray]:
    """Physical frequency coordinates ``(ky, kx)`` in 1/m, wrapped layout.

    ``kx = wrapped_ix / (Nx * dxy)`` as in ``WideFieldModel.java:1455-1456``.
    Returns broadcastable ``ky (ny,1)`` and ``kx (1,nx)`` arrays.
    """
    kx = fft_index(nx) / (nx * dxy)
    ky = fft_index(ny) / (ny * dxy)
    return ky[:, None], kx[None, :]


def wrapped_z(nz: int) -> np.ndarray:
    """Signed wrapped z-plane index used for the defocus scale.

    ``z = iz`` for ``iz <= Nz/2`` else ``iz - Nz``
    (``WideFieldModel.java:232-239``).
    """
    return fft_index(nz)
