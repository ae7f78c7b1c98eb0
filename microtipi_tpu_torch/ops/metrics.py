"""Reconstruction and optics quality metrics: FSC resolution and Strehl ratio.

Port of ``microtipi_tpu/ops/metrics.py``. The Fourier shell correlation
(Harauz and van Heel 1986) of two independent volumes of one scene gives the
resolution where it drops through a threshold (0.143 for independent noise,
van Heel and Schatz 2005); the Strehl ratio grades the optics from any PSF
model at fitted parameters. The shell sums are ``index_add_`` over a shell
index grid computed on the host (``jax.ops.segment_sum`` in the JAX
package); on the card that sum is made of float atomics whose order is not
fixed, so two runs may differ in the last bits. The JAX ``auto_exact_fft``
switch (the TPU's matmul DFT) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "checkerboard_split",
    "fourier_shell_correlation",
    "fsc_resolution",
    "strehl_ratio",
    "strehl_ratio_from_pupil",
]


def checkerboard_split(vol: torch.Tensor):
    """Two quasi-independent half-volumes of one acquisition by diagonal
    lateral decimation (Koho et al. 2019; ``metrics.py:36-57``):
    ``vol[..., 0::2, 0::2]`` and ``vol[..., 1::2, 1::2]``, odd trailing rows
    and columns trimmed. They sample at twice the lateral pitch: pass
    ``spacing=(dz, 2*dxy, 2*dxy)`` to :func:`fourier_shell_correlation`."""
    ny, nx = vol.shape[-2] & ~1, vol.shape[-1] & ~1
    v = vol[..., :ny, :nx]
    return v[..., 0::2, 0::2], v[..., 1::2, 1::2]


def _shell_indices(shape, spacing, n_shells):
    """The shell index of every frequency (host NumPy) and the shells'
    centre frequencies (``metrics.py:60-77``): physical when ``spacing`` is
    given, shells over [0, the smallest per-axis Nyquist], the corners beyond
    clipped into the last shell."""
    freqs = [np.fft.fftfreq(n, d) for n, d in zip(shape, spacing)]
    k = np.sqrt(sum(f.reshape([-1 if i == ax else 1 for i in range(len(shape))]) ** 2
                    for ax, f in enumerate(freqs)))
    k_ny = min(np.abs(f).max() for f in freqs)
    edges = np.linspace(0.0, k_ny, n_shells + 1)
    idx = np.clip(np.digitize(k, edges) - 1, 0, n_shells - 1)
    return idx.ravel(), 0.5 * (edges[:-1] + edges[1:])


def fourier_shell_correlation(a: torch.Tensor, b: torch.Tensor, spacing=None, n_shells=None):
    """FSC of two registered volumes; returns ``(freqs, fsc)`` over
    ``n_shells`` shells (``metrics.py:80-116``). ``spacing`` (dz, dy, dx) in
    m gives frequencies in cycles/m; without it they are in index units."""
    if a.shape != b.shape:
        raise ValueError("FSC needs equal shapes")
    if spacing is None:
        spacing = (1.0,) * a.ndim
    if n_shells is None:
        n_shells = max(8, min(a.shape) // 2)
    idx, centers = _shell_indices(tuple(a.shape), spacing, n_shells)
    idx = torch.as_tensor(idx, device=a.device)
    fa = torch.fft.fftn(a).reshape(-1)
    fb = torch.fft.fftn(b).reshape(-1)

    def shells(v):
        return torch.zeros(n_shells, dtype=v.dtype, device=v.device).index_add_(0, idx, v)

    cross = shells(torch.real(fa * torch.conj(fb)))
    pa = shells(torch.abs(fa) ** 2)
    pb = shells(torch.abs(fb) ** 2)
    fsc = cross / torch.clamp_min(torch.sqrt(pa * pb), float(np.finfo(np.float32).tiny))
    return torch.as_tensor(centers, dtype=fsc.dtype, device=fsc.device), fsc


def fsc_resolution(freqs, fsc, threshold: float = 0.143) -> float:
    """Resolution, 1 / (the first crossing of ``threshold``), interpolated
    linearly inside the crossing shell; the last shell's frequency when the
    curve never drops below (``metrics.py:119-140``). Host NumPy."""
    f = np.asarray(freqs.cpu() if isinstance(freqs, torch.Tensor) else freqs, np.float64)
    c = np.asarray(fsc.cpu() if isinstance(fsc, torch.Tensor) else fsc, np.float64)
    below = np.nonzero(c < threshold)[0]
    below = below[below > 0]  # shell 0 (DC) is degenerate
    if below.size == 0:
        return 1.0 / f[-1]
    i = int(below[0])
    t = (c[i - 1] - threshold) / max(c[i - 1] - c[i], 1e-30)
    return 1.0 / (f[i - 1] + t * (f[i] - f[i - 1]))


def _peak_share(h: torch.Tensor) -> torch.Tensor:
    return torch.max(h) / torch.sum(h)


def strehl_ratio(model, params) -> torch.Tensor:
    """The aberrated PSF's peak over the unaberrated one, each over its total
    energy (``metrics.py:143-160``), for every PSF family; the peak is the
    volume's maximum, so a focal shift does not read as loss."""
    with torch.no_grad():
        return _peak_share(model.compute_psf(params)) / _peak_share(model.compute_psf(model.init_params()))


def strehl_ratio_from_pupil(model, phi, rho=None, defocus=None) -> torch.Tensor:
    """:func:`strehl_ratio` of explicit pupil maps (``jobs.phase_retrieval``'s
    output, ``metrics.py:163-169``), synthesized by
    ``compute_psf_from_pupil``."""
    with torch.no_grad():
        return (_peak_share(model.compute_psf_from_pupil(phi, rho=rho, defocus=defocus))
                / _peak_share(model.compute_psf(model.init_params())))
