"""Depth-varying (spatially variant along z) FFT convolution data term.

Port of ``microtipi_tpu/ops/depthconv.py``. The PSF changes with imaging
depth (the Gibson-Lanni aberration grows linearly with ``d``,
``models/gibson_lanni.py``); the operator blends K anchor PSFs along z
(Preza & Conchello 2004):

    H x = sum_k  h_k (*) (w_k ⊙ x),

with ``w_k(z)`` hat-function weights over K anchor depths (a partition of
unity) and each ``h_k`` the PSF at that depth. This is the scatter form;
its adjoint comes from autograd. The K weighted volumes go through one
batched ``rfftn``, the spectra are summed over k, and one ``irfftn``
returns the model: K + 1 transforms forward, K + 1 back for the gradient.
There is no quadratic form: the blend breaks the circulant structure.

Batches: a 4D ``data`` (B, Nz, Ny, Nx) is B lanes with per-lane costs, the
anchor kernels shared (K, Nz, Ny, Nx) or one stack a lane (B, K, Nz, Ny,
Nx), the data weights None or per lane; the z weights are shared.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from microtipi_tpu_torch.ops.convolution import _irfftn, _lane_sum
from microtipi_tpu_torch.utils.arrays import crop_to_shape

__all__ = ["DepthVaryingConvCost", "depth_varying_convolve", "depth_weights"]

_VOLUME = (-3, -2, -1)


def depth_weights(nz: int, anchors) -> np.ndarray:
    """Hat-function interpolation weights, shape ``(K, nz)``
    (``depthconv.py:38-64``, copied).

    ``anchors`` are strictly increasing z indices (floats allowed) in
    ``[0, nz-1]``. Each plane's blur is a convex blend of its two
    surrounding anchor PSFs; planes outside the anchor span clamp to the
    nearest anchor. Columns sum to 1 over k (partition of unity), so a
    constant PSF stack reproduces plain convolution exactly.
    """
    anchors = np.asarray(anchors, np.float64)
    if anchors.ndim != 1 or anchors.size < 1:
        raise ValueError("anchors must be a non-empty 1D sequence")
    if anchors.size > 1 and not np.all(np.diff(anchors) > 0):
        raise ValueError("anchors must be strictly increasing")
    z = np.arange(nz, dtype=np.float64)
    k = anchors.size
    w = np.zeros((k, nz))
    if k == 1:
        w[0] = 1.0
        return w
    zc = np.clip(z, anchors[0], anchors[-1])
    seg = np.clip(np.searchsorted(anchors, zc, side="right") - 1, 0, k - 2)
    t = (zc - anchors[seg]) / (anchors[seg + 1] - anchors[seg])
    w[seg, np.arange(nz)] = 1.0 - t
    w[seg + 1, np.arange(nz)] += t
    return w


def depth_varying_convolve(x: torch.Tensor, kernels_hat: torch.Tensor, zweights: torch.Tensor,
                           shape: tuple[int, ...]) -> torch.Tensor:
    """``sum_k h_k (*) (w_k ⊙ x)`` with precomputed anchor spectra
    (``depthconv.py:67-80``): ``x`` one volume or a batch (B, ...),
    ``kernels_hat`` the rfftn spectra (K, ...) or (B, K, ...), ``zweights``
    (K, Nz)."""
    xk = zweights[:, :, None, None] * x.unsqueeze(-4)
    xk_hat = torch.fft.rfftn(xk, dim=_VOLUME)
    return _irfftn(torch.sum(kernels_hat * xk_hat, dim=-4), shape)


class DepthVaryingConvCost(NamedTuple):
    """Weighted data term under the depth-varying blur
    (``depthconv.py:83-164``): the build / model / cost contract of
    ``WeightedConvolutionCost`` with K anchor kernels instead of one.
    ``anchors`` are z indices of the data grid; on a padded variable grid
    they are offset onto its centred data window."""

    kernels_hat: torch.Tensor  # (K,) or (B, K) + the rfftn spectrum's shape at var_shape
    zweights: torch.Tensor  # (K, var_nz)
    data: torch.Tensor
    weights: torch.Tensor | None
    var_shape: tuple[int, ...]

    @classmethod
    def build(cls, kernels, data, weights=None, var_shape=None, anchors=None) -> "DepthVaryingConvCost":
        """``kernels``: the corner-origin anchor PSFs at ``var_shape``,
        (K, Nz, Ny, Nx), or (B, K, Nz, Ny, Nx) for a batch ``data`` with one
        stack a lane (embed them with ``utils.arrays.pad_fft_kernel``).
        ``anchors`` default to K evenly spaced z indices over the data."""
        shape = tuple(data.shape[-3:])
        var_shape = shape if var_shape is None else tuple(var_shape)
        lanes = data.ndim == 4
        if kernels.ndim not in ((4, 5) if lanes else (4,)):
            raise ValueError("kernels must be a (K,)+volume stack (or (B, K)+volume for a batch)")
        if tuple(kernels.shape[-3:]) != var_shape:
            raise ValueError(f"kernel shape {tuple(kernels.shape[-3:])} != variable shape {var_shape}; "
                             "use utils.arrays.pad_fft_kernel per anchor to embed them")
        if kernels.ndim == 5 and kernels.shape[0] != data.shape[0]:
            raise ValueError(f"{kernels.shape[0]} kernel stacks for {data.shape[0]} lanes")
        if weights is not None and weights.shape != data.shape:
            raise ValueError("weights must match the data shape")
        if weights is not None:
            # Zero weight excludes the voxel whatever its value (0*NaN = NaN).
            data = torch.where(weights > 0, data, torch.zeros_like(data))
        k = kernels.shape[-4]
        if anchors is None:
            anchors = np.linspace(0.0, shape[0] - 1.0, k)
        anchors = np.asarray(anchors, np.float64)
        if anchors.shape != (k,):
            raise ValueError(f"need one anchor per kernel, got {anchors.shape} for K={k}")
        # The weights live on the variable z grid; the data window is centred
        # (utils.arrays._offsets), so data plane 0 is variable plane off_z.
        off_z = (var_shape[0] - shape[0]) // 2
        zw = depth_weights(var_shape[0], anchors + off_z)
        return cls(torch.fft.rfftn(kernels, dim=_VOLUME), torch.as_tensor(zw, dtype=data.dtype, device=data.device),
                   data, weights, var_shape)

    def select_lanes(self, idx: torch.Tensor) -> "DepthVaryingConvCost":
        """The cost over the lanes ``idx`` of a batch: the data, the data
        weights and per-lane kernel stacks are indexed, shared ones kept."""
        return self._replace(
            kernels_hat=self.kernels_hat[idx] if self.kernels_hat.ndim == 5 else self.kernels_hat,
            data=self.data[idx], weights=None if self.weights is None else self.weights[idx])

    def model(self, x: torch.Tensor) -> torch.Tensor:
        """Forward model H x = crop(sum_k h_k (*) (w_k ⊙ x)) at the data window."""
        hx = depth_varying_convolve(x, self.kernels_hat, self.zweights, self.var_shape)
        if hx.shape != self.data.shape:
            hx = crop_to_shape(hx, tuple(self.data.shape[-3:]))
        return hx

    def cost(self, x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
        """0.5 * alpha * sum w * (H x - d)^2 in the residual form, per lane
        for a batch."""
        r = self.model(x) - self.data
        wr2 = r * r if self.weights is None else self.weights * r * r
        return 0.5 * alpha * _lane_sum(wr2)

    value = cost  # the cost alone, under torch.no_grad(): nothing to skip here
