"""Synthetic test-object phantoms and a camera noise model.

Beyond-parity tooling: the reference has no data generator (its authors
validated inside Icy on private data); a complete framework ships one so
users can benchmark solvers, rehearse pipelines, and file reproducible
reports. Host-side NumPy on purpose — generation is offline, and the
solver paths under test should not share code with the data generator.

Phantoms come back as float32 ``(Nz, Ny, Nx)`` volumes; compose with any
PSF model via ``convolve(phantom, convolve_spectrum(model.compute_psf(p)))``
and :func:`apply_camera` for noise (the JAX package's CLI ``simulate``
command wires the whole chain).

A copy of ``microtipi_tpu/utils/phantoms.py``: the same seed gives bit-equal
phantoms (``tests/test_torch_utils.py``). The port's ``convolve`` takes
tensors: ``torch.as_tensor(phantom, device=...)`` first.
"""

from __future__ import annotations

import numpy as np

__all__ = ["apply_camera", "beads_phantom", "filaments_phantom",
           "shells_phantom"]


def beads_phantom(shape, n: int = 40, intensity=(50.0, 200.0), margin: int = 3,
                  seed: int = 0) -> np.ndarray:
    """Sub-resolution point sources at random positions (delta objects)."""
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    lo = [margin] * 3
    hi = [max(m + 1, s - margin) for m, s in zip(lo, shape)]
    for _ in range(n):
        z, y, x = (rng.integers(l, h) for l, h in zip(lo, hi))
        vol[z, y, x] += rng.uniform(*intensity)
    return vol


def filaments_phantom(shape, n: int = 8, steps: int = 400, stiffness: float = 0.9,
                      intensity=(80.0, 160.0), sigma: float = 0.8,
                      seed: int = 0) -> np.ndarray:
    """Smooth random-walk curves with a Gaussian cross-section —
    microtubule/actin-like structure (persistent direction ``stiffness``)."""
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float64)
    dims = np.asarray(shape, np.float64)
    for _ in range(n):
        pos = rng.uniform(0.2, 0.8, 3) * dims
        d = rng.standard_normal(3)
        d /= np.linalg.norm(d)
        amp = rng.uniform(*intensity)
        for _ in range(steps):
            step = stiffness * d + (1 - stiffness) * rng.standard_normal(3)
            d = step / max(np.linalg.norm(step), 1e-9)
            pos = pos + 0.7 * d
            # reflect at the walls
            for ax in range(3):
                if pos[ax] < 1 or pos[ax] > dims[ax] - 2:
                    d[ax] = -d[ax]
                    pos[ax] = np.clip(pos[ax], 1, dims[ax] - 2)
            z, y, x = (int(round(p)) for p in pos)
            vol[z, y, x] += amp / steps
    # Gaussian cross-section via FFT blur (corner-origin kernel)
    grids = [np.minimum(np.arange(s), s - np.arange(s)).astype(np.float64)
             for s in shape]
    r2 = (grids[0][:, None, None] ** 2 + grids[1][None, :, None] ** 2
          + grids[2][None, None, :] ** 2)
    k = np.exp(-r2 / (2 * sigma ** 2))
    out = np.fft.irfftn(np.fft.rfftn(vol) * np.fft.rfftn(k / k.sum()),
                        s=shape, axes=(0, 1, 2))
    return np.maximum(out, 0.0).astype(np.float32) * steps


def shells_phantom(shape, n: int = 5, radius=(4.0, 10.0), thickness: float = 1.2,
                   intensity=(60.0, 120.0), seed: int = 0) -> np.ndarray:
    """Hollow spheres (membrane/nuclear-envelope-like structure)."""
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.float32)
    zz, yy, xx = np.meshgrid(*[np.arange(s, dtype=np.float64) for s in shape],
                             indexing="ij")
    for _ in range(n):
        r = rng.uniform(*radius)
        c = [rng.uniform(r, s - r) if s > 2 * r else s / 2 for s in shape]
        dist = np.sqrt((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2)
        vol += np.where(np.abs(dist - r) < thickness,
                        rng.uniform(*intensity), 0.0).astype(np.float32)
    return vol


def apply_camera(clean, photons_at_max: float = 1e4, gain: float = 2.0,
                 readout_sigma: float = 1.5, offset: float = 100.0,
                 seed: int = 0) -> np.ndarray:
    """Mixed Poisson-Gaussian camera model (the noise the
    ``weights.InverseVarianceWeights`` model inverts).

    The clean volume is scaled so its max expects ``photons_at_max``
    photons, shot noise is Poisson, and the ADU output is
    ``photons / gain + offset + N(0, readout_sigma)`` — gain in e-/ADU,
    readout in ADU. Returns float32 ADU.
    """
    clean = np.asarray(clean, np.float64)
    rng = np.random.default_rng(seed)
    peak = clean.max()
    if peak <= 0:
        raise ValueError("phantom is empty")
    lam = clean * (photons_at_max / peak)
    electrons = rng.poisson(lam).astype(np.float64)
    adu = electrons / gain + offset + readout_sigma * rng.standard_normal(clean.shape)
    return adu.astype(np.float32)
