"""Joint multichannel and 5D deconvolution with chromatic PSFs (color-TV solve).

Port of ``microtipi_tpu/jobs/multichannel.py``. Fluorescence channels image
the same specimen through their own PSFs (the pupil scales with the emission
wavelength), so one solve over the (C, Nz, Ny, Nx) block couples what is
shared, the edge locations, and leaves each channel's intensity free:

    f(x) = sum_c [ 0.5 ||H_c x_c - d_c||^2_{w_c} ]  +  mu * JTV_eps(x)
           (+ sparsity/hessian per channel),            x >= 0

with JTV the channel-coupled hyperbolic TV
(``ops.regularization.joint_hyperbolic_tv``). ``coupling="separate"`` keeps
one TV per channel: the batched TV kernel over the channel lanes
(``jobs.deconv.make_regularizer``), one launch an evaluation.
:func:`deconvolve_timeseries_multichannel` is the full (T, C) acquisition:
color TV within each timepoint, temporal TV along t, per-frame-per-channel
bleaching gains, and optional spectral unmixing through a (C, K) mixing
matrix. Its objective, :func:`make_tsmc_objective`, is the single definition
behind every joint solver of the port: the time series
(``jobs/timeseries.py``) is its C = 1 case and the multichannel solve its
T = 1 case, as in the JAX package, and the ADMM engines (``jobs/admm.py``)
track its values.

The data term runs through batched 3D FFTs over the leading axes with
per-channel kernel spectra; its uniform-weight fast paths are
``torch.autograd.Function``s whose forward keeps the gradient.
"""

from __future__ import annotations

import numpy as np
import torch

from microtipi_tpu_torch.jobs.deconv import (
    DeconvolutionConfig,
    DeconvolutionResult,
    _extra_priors,
    _vmlmb_options,
    has_regularizer,
    make_regularizer,
)
from microtipi_tpu_torch.ops.convolution import _abs2, _irfftn, _rfftn, generalized_kl
from microtipi_tpu_torch.ops.regularization import hyperbolic_tv, joint_hyperbolic_tv
from microtipi_tpu_torch.optim.treeutil import value_and_grad
from microtipi_tpu_torch.optim.vmlmb import minimize_vmlmb
from microtipi_tpu_torch.utils.arrays import pad_fft_kernel

__all__ = [
    "deconvolve_multichannel",
    "deconvolve_timeseries_multichannel",
    "make_tsmc_objective",
    "mixing_from_controls",
]


class _BatchedQuadraticCost(torch.autograd.Function):
    """Sum over the leading (time, channel) axes of the circulant quadratic
    data term ``0.5 <x, g2 A x> - <x, b> + c``, one FFT pair for the cost and
    the gradient ``g2 A x - b`` (``timeseries.py:48-75`` and
    ``multichannel.py:59-85``). ``kernel_sq`` (|K_hat|^2, one spectrum a
    channel or one shared) broadcasts against the rfftn of ``x`` over its last
    three axes; ``g2`` is the squared bleaching gain per frame and channel,
    applied outside the spectrum product."""

    @staticmethod
    def forward(ctx, x, kernel_sq, g2, b, c, vol):
        ax = g2 * _irfftn(kernel_sq * _rfftn(x), vol)
        ctx.save_for_backward(ax - b)
        return 0.5 * torch.sum(x * ax) - torch.sum(x * b) + c

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return g * grad, None, None, None, None, None


class _MixedQuadraticCost(torch.autograd.Function):
    """The quadratic data term of the spectrally mixed model ``y_tc = sum_k
    M_ck (H_k x_tk)`` (``multichannel.py:88-121``): mixing is pointwise in
    Fourier space, so the normal operator is one (K, K) einsum over spectra,
    ``N_kj = conj(H_k) (M^T M)_kj H_j``, between one FFT pair."""

    @staticmethod
    def forward(ctx, x, normal_spec, b, c, vol):
        ax = _irfftn(torch.einsum("kjzyx,tjzyx->tkzyx", normal_spec, _rfftn(x)), vol)
        ctx.save_for_backward(ax - b)
        return 0.5 * torch.sum(x * ax) - torch.sum(x * b) + c

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return g * grad, None, None, None, None


def mixing_from_controls(controls, device: torch.device | str = "cuda") -> torch.Tensor:
    """Detection-spectrum mixing matrix from single-stain controls
    (``multichannel.py:123-146``): ``controls`` holds one ``(C,) + vol``
    stack a dye, each imaged in every detection channel; column k of the
    returned (C, K) matrix is control k's per-channel positive flux,
    normalized to unit sum. Computed with NumPy on the host, in float64; the
    matrix goes to ``device``, the card unless the caller names another."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("mixing_from_controls puts its matrix on the CUDA card by default and none is "
                           "available; pass device='cpu' to keep it on the CPU")
    cols = []
    for arr in controls:
        a = np.asarray(arr.detach().cpu() if isinstance(arr, torch.Tensor) else arr, np.float64)
        if a.ndim < 2:
            raise ValueError("each control must be a (C,) + volume stack")
        flux = np.maximum(a, 0.0).reshape(a.shape[0], -1).sum(axis=1)
        total = flux.sum()
        if not total > 0:
            raise ValueError("a control stack has no positive flux")
        cols.append(flux / total)
    return torch.as_tensor(np.stack(cols, axis=1), device=device)


def make_tsmc_objective(
    psfs: torch.Tensor,
    data: torch.Tensor,
    weights: torch.Tensor | None,
    config: DeconvolutionConfig,
    *,
    mu_t: float = 0.0,
    epsilon_t: float | None = None,
    bleach=None,
    coupling: str = "joint",
    mixing=None,
    accurate: bool = False,
):
    """The joint (T, C)-block objective (``multichannel.py:286-443``):
    returns ``(objective, aux)``, ``objective(x) -> f`` a 0-dim tensor that
    autograd differentiates, and ``aux`` the prepared pieces the ADMM engines
    reuse: ``k_hat`` (per-channel spectra), ``m`` (mixing), ``g5`` (bleach
    gains), ``nk``, ``nt``, ``nc``, ``vol`` and the zero-weight-masked
    ``data`` and broadcast ``weights``.

    ``psfs`` is one corner-origin PSF a channel (a dye with ``mixing``) or one
    volume for all; ``weights`` (T, C)+vol, (C,)+vol or one volume; ``bleach``
    (T, C or K) gains in the model. The Gaussian term without weights takes
    the 2-FFT quadratic form (mixed: the (K, K) Fourier coupling), or with
    ``accurate`` (and with mixing and bleach together) the residual form;
    zero weights exclude their voxels whatever the data holds there.
    """
    if data.ndim != 5:
        raise ValueError(f"expected a (T, C, Nz, Ny, Nx) block, got {tuple(data.shape)}")
    if coupling not in ("joint", "separate"):
        raise ValueError(f"unknown coupling {coupling!r}")
    if config.var_shape is not None:
        raise ValueError("var_shape is not supported for the joint 5D solve; pad the input data instead")
    nt, nc = data.shape[:2]
    vol = tuple(data.shape[2:])
    dtype, dev = data.dtype, data.device
    m, nk = None, nc
    if mixing is not None:
        m = torch.as_tensor(mixing, dtype=dtype, device=dev)
        if m.ndim != 2 or m.shape[0] != nc:
            raise ValueError(f"mixing must be a ({nc}, K) detection-spectra matrix (rows = the data's detected "
                             f"channels), got {tuple(m.shape)}")
        nk = m.shape[1]
    if psfs.ndim == 3:  # one corner-origin PSF (any size <= vol), broadcast
        psfs = psfs[None]
    if psfs.ndim != 4 or psfs.shape[0] not in (1, nk):
        raise ValueError(f"psfs must be ({'K' if m is not None else 'C'}={nk},) + a corner-origin kernel shape "
                         f"<= {vol} (or one volume broadcast), got {tuple(psfs.shape)}")
    k_hat = _rfftn(pad_fft_kernel(psfs, vol))  # (C or K or 1,) + spectrum
    if m is not None and k_hat.shape[0] == 1 and nk > 1:  # the (K, K) coupling needs one spectrum a dye
        k_hat = k_hat.expand(nk, *k_hat.shape[1:])
    if weights is not None and weights.ndim in (3, 4):
        weights = weights.reshape((1,) * (5 - weights.ndim) + tuple(weights.shape))
    g5 = None
    if bleach is not None:
        bleach = torch.as_tensor(bleach, dtype=dtype, device=dev)
        if tuple(bleach.shape) != (nt, nk):
            raise ValueError(f"bleach must be per-frame-per-{'dye' if m is not None else 'channel'} gains of "
                             f"shape ({nt}, {nk}), got {tuple(bleach.shape)}")
        g5 = bleach.reshape(nt, nk, 1, 1, 1)

    def model(x):
        hx = _irfftn(k_hat * _rfftn(x), vol)
        if g5 is not None:
            hx = g5 * hx
        if m is not None:
            hx = torch.einsum("ck,tkzyx->tczyx", m, hx)
        return hx

    def residual_term(x):
        r = model(x) - data
        return 0.5 * torch.sum(r * r if weights is None else weights * r * r)

    if config.data_term == "poisson":
        if weights is not None:
            raise ValueError("data_term='poisson' does not compose with weights")
        bg, counts = float(config.background), torch.clamp_min(data, 0.0)

        def data_term(x):
            return generalized_kl(model(x) + bg, counts).sum()
    elif config.data_term != "gaussian":
        raise ValueError(f"unknown data_term {config.data_term!r}")
    elif weights is not None:
        # Zero weight excludes the voxel whatever its value: 0 * NaN would
        # defeat the validity mask (WeightedConvolutionCost.build).
        data = torch.where(weights > 0, data, torch.zeros_like(data))
        data_term = residual_term
    elif accurate or (m is not None and g5 is not None):
        data_term = residual_term
    elif m is None:
        # f = sum_tc 0.5||g H_c x - d||^2 = 0.5<x, g^2 K^2 x> - <x, g H^T d> + c.
        kernel_sq = _abs2(k_hat)
        g2 = torch.ones((), dtype=dtype, device=dev) if g5 is None else g5 * g5
        b = _irfftn(torch.conj(k_hat) * _rfftn(data), vol)
        if g5 is not None:
            b = g5 * b
        c = 0.5 * torch.sum(data * data)

        def data_term(x):
            return _BatchedQuadraticCost.apply(x, kernel_sq, g2, b, c, vol)
    else:
        mc = m.to(k_hat.dtype)
        normal_spec = torch.einsum("kzyx,kj,jzyx->kjzyx", torch.conj(k_hat), mc.T @ mc, k_hat)
        b = _irfftn(torch.conj(k_hat) * torch.einsum("ck,tczyx->tkzyx", mc, _rfftn(data)), vol)
        c = 0.5 * torch.sum(data * data)

        def data_term(x):
            return _MixedQuadraticCost.apply(x, normal_spec, b, c, vol)

    eps_t = config.epsilon if epsilon_t is None else epsilon_t
    reg = make_regularizer(config)

    def objective(x):
        f = data_term(x)
        if coupling == "joint":
            if config.mu > 0:
                f = f + config.mu * joint_hyperbolic_tv(x, config.epsilon, config.scales, axes=(-3, -2, -1),
                                                        couple_axis=1)
            f = f + _extra_priors(x, config, axes=(-3, -2, -1))
        elif has_regularizer(config):  # the batched TV kernel over the (T * C) channel lanes
            f = f + reg(x.reshape(-1, *vol)).sum()
        if mu_t > 0:
            f = f + mu_t * hyperbolic_tv(x, eps_t, axes=(0,))
        return f

    aux = {"k_hat": k_hat, "m": m, "g5": g5, "nk": nk, "nt": nt, "nc": nc, "vol": vol, "data": data,
           "weights": weights}
    return objective, aux


def _vmlmb_result(objective, x0, config: DeconvolutionConfig) -> DeconvolutionResult:
    """One VMLMB run of ``objective`` from ``x0`` (clamped under positivity)."""
    if config.positivity:
        x0 = torch.clamp_min(x0, 0.0)
    res = minimize_vmlmb(value_and_grad(objective), x0, **_vmlmb_options(config), maxeval=config.max_eval)
    return DeconvolutionResult(res.x, res.f, res.iterations, res.evaluations, res.status, res.f_history,
                               res.pg_history)


def deconvolve_timeseries_multichannel(
    data: torch.Tensor,
    psfs: torch.Tensor,
    weights: torch.Tensor | None = None,
    x0: torch.Tensor | None = None,
    config: DeconvolutionConfig = DeconvolutionConfig(),
    *,
    mu_t: float = 0.0,
    epsilon_t: float | None = None,
    bleach=None,
    coupling: str = "joint",
    mixing=None,
) -> DeconvolutionResult:
    """Jointly deconvolve a (T, C) + volume block, the whole acquisition, in
    one VMLMB run (``multichannel.py:206-283``): per-channel PSF spectra,
    color TV within each timepoint (``coupling="joint"``, ``config.mu``;
    tune it 3-10x larger than a per-channel TV's), temporal TV along t
    (``mu_t``, ``epsilon_t``), per-frame-per-channel bleaching gains
    ``bleach`` (T, C) in the model, and optional unmixing: ``mixing`` (C, K)
    makes the model ``y_tc = sum_k M_ck g_tk (H_k x_tk)``, and ``psfs``,
    ``bleach`` and the returned ``x`` are per dye. Without ``x0`` the solve
    starts from the data, or from the clipped pseudo-inverse unmix ``M^+ d``.
    Returns one joint cost; runs on the device of its tensors."""
    objective, aux = make_tsmc_objective(psfs, data, weights, config, mu_t=mu_t, epsilon_t=epsilon_t, bleach=bleach,
                                         coupling=coupling, mixing=mixing)
    if x0 is None:
        x0 = aux["data"] if aux["m"] is None else torch.einsum("kc,tczyx->tkzyx", torch.linalg.pinv(aux["m"]),
                                                               aux["data"])
    return _vmlmb_result(objective, x0, config)


def deconvolve_multichannel(
    data: torch.Tensor,
    psfs: torch.Tensor,
    weights: torch.Tensor | None = None,
    x0: torch.Tensor | None = None,
    config: DeconvolutionConfig = DeconvolutionConfig(),
    *,
    coupling: str = "joint",
    mixing=None,
) -> DeconvolutionResult:
    """Jointly deconvolve a (C,) + volume stack with per-channel PSFs
    (``multichannel.py:149-203``): the T = 1 case of
    :func:`deconvolve_timeseries_multichannel`, whose objective is the same
    up to the leading length-1 axis. ``coupling="separate"`` makes it C
    independent solves sharing one VMLMB run; ``mixing`` recovers K dye
    volumes. Returns ``x`` of shape (C or K,) + vol."""
    if data.ndim != 4:
        raise ValueError(f"expected a (C, Nz, Ny, Nx) stack, got {tuple(data.shape)}")
    if weights is not None and weights.ndim == 4:
        weights = weights[None]
    res = deconvolve_timeseries_multichannel(data[None], psfs, weights, None if x0 is None else x0[None], config,
                                             coupling=coupling, mixing=mixing)
    return res._replace(x=res.x[0])
