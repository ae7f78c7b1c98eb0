"""Mesh-sharded Richardson-Lucy (and RL-TV) deconvolution.

Port of ``microtipi_tpu/parallel/richardson_lucy.py``: two distributed FFT
pairs an iteration over the (batch, z) mesh (``parallel/fft.py``), and for
RL-TV the TV's gradient from the TV kernel's slab mode, one launch a z-slab
(``parallel/deconv.sharded_tv_gradient``). Semantics match
``jobs.richardson_lucy.richardson_lucy`` without acceleration or stops, as
in the JAX module.
"""

from __future__ import annotations

import math

import torch

from microtipi_tpu_torch.parallel.deconv import sharded_tv_gradient
from microtipi_tpu_torch.parallel.fft import sharded_irfftn, sharded_rfftn, sharded_spectrum
from microtipi_tpu_torch.parallel.mesh import Mesh, ShardedVolume, gather, shard

__all__ = ["sharded_multiview_richardson_lucy", "sharded_richardson_lucy"]


def _support_floor(d: ShardedVolume, n: int, background: float) -> torch.Tensor:
    """``max(1e-6 * (mean(d) + bg), tiny)`` (see ``jobs.richardson_lucy``)."""
    return torch.clamp_min(1e-6 * (d.sum() / n + background), torch.finfo(d.dtype).tiny)


def _ratio(model: ShardedVolume, d: ShardedVolume, eps: torch.Tensor) -> ShardedVolume:
    return model.map(lambda m, dd, e: torch.where(m > e, dd / torch.maximum(m, e), torch.zeros_like(m)), d, eps)


def _clamp(x: ShardedVolume, floor: float) -> ShardedVolume:
    return x.map(lambda t: torch.clamp_min(t, floor))


def sharded_richardson_lucy(data, psf, mesh: Mesh, iterations: int = 50, background: float = 0.0, mu: float = 0.0,
                            epsilon: float = 1e-2, x0=None) -> ShardedVolume:
    """RL (RL-TV with ``mu`` > 0) on the mesh (``richardson_lucy.py:25-64``):
    ``psf`` corner-origin at the volume grid, ``data`` (Nz, Ny, Nx) or
    batched (B, Nz, Ny, Nx), a tensor or a sharded volume. Returns the
    sharded estimate."""
    vol_shape = tuple(data.shape[-3:])
    if tuple(psf.shape) != vol_shape:
        raise ValueError("richardson_lucy requires psf shape == volume shape")
    data = shard(data, mesh, data.ndim == 4)
    k_hat = sharded_spectrum(psf, mesh)
    k_conj = k_hat.map(torch.conj)
    flux = gather(psf).sum().to(mesh.first)
    d = _clamp(data, 0.0)
    x = _clamp(data if x0 is None else shard(x0, mesh, data.batched), 1e-12)
    eps = _support_floor(d, math.prod(data.shape), background)
    with torch.no_grad():
        for _ in range(iterations):
            model = sharded_irfftn(sharded_rfftn(x, mesh) * k_hat, vol_shape, mesh) + background
            back = sharded_irfftn(k_conj * sharded_rfftn(_ratio(model, d, eps), mesh), vol_shape, mesh)
            denom = flux
            if mu > 0:
                denom = (mu * sharded_tv_gradient(x, epsilon) + flux).map(torch.maximum, 0.1 * flux)
            x = _clamp(x * back / denom, 0.0)
    return x


def sharded_multiview_richardson_lucy(views, psfs, mesh: Mesh, iterations: int = 50, background: float = 0.0,
                                      x0=None) -> ShardedVolume:
    """Joint-MLE multi-view RL fusion on the mesh (``richardson_lucy.py:67-107``):
    the views (K,) + volume ride the mesh's batch axis, each z-sharded; the
    sum over views adds the rows' back-projections on row 0, where the
    estimate lives (one unbatched volume; over processes on every row, each
    row's replica)."""
    if tuple(views.shape) != tuple(psfs.shape) or len(views.shape) != 4:
        raise ValueError("views and psfs must share a (K,)+volume shape")
    vol = tuple(views.shape[1:])
    views = shard(views, mesh, True)
    k_hat = sharded_spectrum(gather(psfs), mesh)
    k_conj = k_hat.map(torch.conj)
    flux = gather(psfs).sum().to(mesh.first)
    d = _clamp(views, 0.0)
    n = math.prod(views.shape)
    if x0 is None:
        # Floored mean-of-views start, matching jobs.richardson_lucy.
        mean_view = d.sum_frames() / views.shape[0]
        x = mean_view.map(torch.maximum, 1e-3 * d.sum() / n + 1e-12)
    else:
        x = _clamp(shard(x0, mesh, False), 1e-12)
    eps = _support_floor(d, n, background)
    with torch.no_grad():
        for _ in range(iterations):
            model = sharded_irfftn(k_hat * sharded_rfftn(x, mesh), vol, mesh) + background
            back = sharded_irfftn(k_conj * sharded_rfftn(_ratio(model, d, eps), mesh), vol, mesh).sum_frames()
            x = _clamp(x * back / flux, 0.0)
    return x
