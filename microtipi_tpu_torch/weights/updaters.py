"""Statistical data-weight models (inverse noise variance).

Port of ``microtipi_tpu/weights/updaters.py`` (the TiPi ``WeightUpdater``
surface the reference plumbs through ``BlindDeconvJob``,
``microUtils/BlindDeconvJob.java:58,109-111``): after each object update the
weights are re-estimated from the current model (the convolved object) and
fed to the next PSF fit. The pre-deconv update is disabled in the reference
(``:105-107``) and is not performed here either.

Noise model: mixed Poisson-Gaussian detection,

    var_i = max(model_i, 0) / gain  +  readout_variance

so ``w_i = 1 / var_i``, with ``w_i = 0`` for saturated or non-finite data
(zero weight = excluded voxel, the TiPi convention). Per-voxel weights are
also what switches the ADMM engine (``jobs/admm.py``) to its data split.
Everything runs on the device of its tensors.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["InverseVarianceWeights", "estimate_gain_readout", "laplacian_residuals", "validity_mask"]


def laplacian_residuals(data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Structure-free noise residuals and local means of an image or stack
    (``updaters.py:29-59``): per z plane, ``r = (L * d)/6`` with the
    Immerkaer 3x3 Laplacian difference L = [[1,-2,1],[-2,4,-2],[1,-2,1]]
    (unit noise gain after /6), and the 3x3 box mean, both flattened over the
    valid interior. A 2D input is one plane."""
    d = data[None] if data.ndim == 2 else data
    if d.ndim != 3:
        raise ValueError(f"expected a 2D image or 3D stack, got shape {tuple(data.shape)}")
    c = d[:, 1:-1, 1:-1]
    edges = d[:, :-2, 1:-1] + d[:, 2:, 1:-1] + d[:, 1:-1, :-2] + d[:, 1:-1, 2:]
    lap = 4.0 * c - 2.0 * edges + d[:, :-2, :-2] + d[:, :-2, 2:] + d[:, 2:, :-2] + d[:, 2:, 2:]
    box = c + edges + d[:, :-2, :-2] + d[:, :-2, 2:] + d[:, 2:, :-2] + d[:, 2:, 2:]
    return (lap / 6.0).reshape(-1), (box / 9.0).reshape(-1)


def validity_mask(data: torch.Tensor, saturation: float | None = None) -> torch.Tensor:
    """1.0 where a voxel is usable, 0.0 where dead, saturated or non-finite."""
    ok = torch.isfinite(data)
    if saturation is not None:
        ok = ok & (data < saturation)
    return ok.to(data.dtype)


@dataclasses.dataclass(frozen=True)
class InverseVarianceWeights:
    """Callable weight model (``updaters.py:70-95``); ``gain`` in
    photo-electrons per count, ``readout_variance`` in counts^2.
    ``gain <= 0`` disables the shot-noise term (pure Gaussian noise)."""

    gain: float = 1.0
    readout_variance: float = 1.0
    saturation: float | None = None

    def from_data(self, data: torch.Tensor) -> torch.Tensor:
        """Initial weights, with the data itself as the variance predictor."""
        return self._weights(data, data)

    def update(self, model: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
        """Re-estimated weights from the current model prediction H*x: what
        ``wghtUpdt.update(deconvolver)`` computes from
        ``deconvolver.getModel()`` (``BlindDeconvJob.java:109-111``)."""
        return self._weights(model, data)

    def _weights(self, predictor: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
        var = torch.full_like(data, self.readout_variance)
        if self.gain > 0:
            var = var + torch.clamp_min(predictor, 0.0) / self.gain
        w = 1.0 / torch.clamp_min(var, torch.finfo(data.dtype).tiny)
        return w * validity_mask(data, self.saturation)


def _quantiles(sorted_values: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """Linearly interpolated quantiles of an ascending 1D tensor, of any
    length (``torch.quantile`` stops at 16M elements)."""
    pos = qs * (sorted_values.numel() - 1)
    lo = pos.floor().long()
    hi = torch.clamp_max(lo + 1, sorted_values.numel() - 1)
    frac = pos - lo
    return sorted_values[lo] * (1.0 - frac) + sorted_values[hi] * frac


def estimate_gain_readout(data: torch.Tensor, *, bins: int = 16,
                          min_bin_count: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """Estimate ``(gain, readout_variance)`` from one image or stack
    (``updaters.py:98-177``): single-shot photon transfer in the spirit of
    Foi et al. 2008. Under mixed Poisson-Gaussian detection the local noise
    variance is affine in the local mean, ``var(d) = mean(d)/gain +
    readout_variance``. Voxels are binned by local-mean quantiles, each bin's
    variance is the mean of ``r^2`` (:func:`laplacian_residuals`) after
    rejecting ``|r|`` beyond 10x the global MAD scale, and a count-weighted
    least-squares line through (mean_b, var_b) gives slope ``1/gain`` and
    intercept ``readout_variance``. Bins with fewer than ``min_bin_count``
    accepted voxels are dropped; the slope is clipped at 0 before the
    intercept is taken. Returns 0-dim tensors on the data's device."""
    r, box = laplacian_residuals(data)
    dtype, tiny = data.dtype, torch.finfo(data.dtype).tiny
    min_bin_count = min(min_bin_count, max(1, r.numel() // (2 * bins)))

    half = torch.tensor([0.5], dtype=dtype, device=data.device)
    scale = _quantiles(torch.sort(r.abs()).values, half)[0] / 0.6745
    keep = r.abs() <= 10.0 * scale

    qs = torch.linspace(0.0, 1.0, bins + 1, dtype=dtype, device=data.device)
    edges = _quantiles(torch.sort(box).values, qs)
    idx = torch.clamp(torch.searchsorted(edges[1:-1].contiguous(), box), 0, bins - 1)
    w = keep.to(dtype)
    zeros = torch.zeros(bins, dtype=dtype, device=data.device)
    cnt = zeros.index_add(0, idx, w)
    sum_m = zeros.index_add(0, idx, w * box)
    sum_r2 = zeros.index_add(0, idx, w * r * r)
    safe = torch.clamp_min(cnt, 1.0)
    mean_b, var_b = sum_m / safe, sum_r2 / safe

    # No bin qualifying (pathological data) falls back to slope 0 with the
    # robust global variance instead of 0/0.
    wb = torch.where(cnt >= min_bin_count, cnt, torch.zeros_like(cnt))
    sw = torch.clamp_min(wb.sum(), tiny)
    mx = (wb * mean_b).sum() / sw
    my = torch.where(wb.sum() > 0, (wb * var_b).sum() / sw, scale * scale)
    sxx = (wb * (mean_b - mx) ** 2).sum()
    sxy = (wb * (mean_b - mx) * (var_b - my)).sum()
    a = torch.clamp_min(sxy / torch.clamp_min(sxx, tiny), 0.0)
    b = my - a * mx
    return 1.0 / torch.clamp_min(a, tiny), torch.clamp_min(b, 0.0)
