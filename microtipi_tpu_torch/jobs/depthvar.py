"""Depth-variant deconvolution: the object step under a z-varying PSF.

Port of ``microtipi_tpu/jobs/depthvar.py``: the solver of ``jobs/deconv.py``
(VMLMB, hyperbolic TV, positivity; the TV through the same
``make_regularizer``, so each evaluation is one fused TV launch on the card)
with the depth-varying data term of ``ops/depthconv.py`` — K anchor PSFs
blended along z — in place of one shift-invariant kernel, and Richardson-Lucy
under the same operator through the shared RL engine (RL-TV: one TV launch
an iteration). The anchor PSFs come from a Gibson-Lanni model at K depths in
one batched synthesis (:func:`depth_anchor_psfs`), or from K retrieved pupil
maps (:func:`depth_anchor_psfs_from_maps`).

The data term is always the residual form (the blend has no quadratic
form), so the float32 continuation of ``deconvolve``, which guards the
quadratic form's value resolution, has nothing to guard here, as in the JAX
package; the L-BFGS memory is kept in the iterate's dtype.

The depth-varying PSF fits, the blind loop and the bead-ladder calibration
stand on parts of ``jobs/psf_fit.py`` not ported yet and raise
``NotImplementedError`` naming ROADMAP.md queue 1, item 15.
"""

from __future__ import annotations

import numpy as np
import torch

from microtipi_tpu_torch.jobs.deconv import (
    DeconvolutionConfig,
    DeconvolutionResult,
    _vmlmb_options,
    has_regularizer,
    make_regularizer,
    var_shape_of,
)
from microtipi_tpu_torch.jobs.richardson_lucy import _rl_engine
from microtipi_tpu_torch.ops.convolution import _irfftn, generalized_kl
from microtipi_tpu_torch.ops.depthconv import DepthVaryingConvCost, depth_varying_convolve, depth_weights
from microtipi_tpu_torch.optim.treeutil import value_and_grad
from microtipi_tpu_torch.optim.vmlmb import minimize_vmlmb
from microtipi_tpu_torch.utils.arrays import pad_fft_kernel, pad_to_shape

__all__ = [
    "blind_deconvolve_depthvar",
    "calibrate_depth",
    "deconvolve_depthvar",
    "depth_anchor_psfs",
    "depth_anchor_psfs_from_maps",
    "depthvar_cost",
    "depthvar_objective",
    "depthvar_start",
    "fit_psf_depthvar",
    "ladder_fit_uncertainty",
    "richardson_lucy_depthvar",
]


def depth_anchor_psfs(model, params, anchors, depth0=None) -> torch.Tensor:
    """The K anchor PSFs of a depth-varying solve, (K, Nz, Ny, Nx)
    (``depthvar.py:40-62``): the PSF of anchor ``a`` (a z index of the data
    grid) at the physical depth ``depth0 + a * dz``, ``depth0`` the nominal
    depth of plane 0 (default ``model.config.depth``). ``model`` is a
    ``GibsonLanniModel``; the K PSFs come from one batched synthesis."""
    if not hasattr(model, "compute_depth_psfs"):
        raise ValueError("depth_anchor_psfs needs a model with a DEPTH family (models/gibson_lanni.py)")
    if depth0 is None:
        depth0 = getattr(model.config, "depth", 0.0)
    steps = np.asarray(anchors, np.float64) * model.config.dz
    kw = dict(dtype=model.dtype, device=model.device)
    if isinstance(depth0, torch.Tensor):
        depths = depth0 + torch.as_tensor(steps, **kw)
    else:
        depths = torch.as_tensor(depth0 + steps, **kw)
    return model.compute_depth_psfs(params, depths)


def depth_anchor_psfs_from_maps(model, phis, rhos=None, defocus=None) -> torch.Tensor:
    """Anchor PSFs from K retrieved pupil maps, (K, Nz, Ny, Nx)
    (``depthvar.py:65-108``): ``model`` a ``WideFieldModel`` at the sample
    geometry, ``phis`` (K, Ny, Nx) phase maps, ``rhos`` (K, Ny, Nx) modulus
    maps or None (the nominal flat modulus), ``defocus`` None (nominal), one
    (3,) vector or (K, 3). One batched 2D FFT over the K fields."""
    kw = dict(dtype=model.dtype, device=model.device)
    phis = torch.as_tensor(phis, **kw)
    if phis.ndim != 3:
        raise ValueError(f"phis must be (K, Ny, Nx), got {tuple(phis.shape)}")
    defocus = model.init_params().defocus if defocus is None else torch.as_tensor(defocus, **kw)
    if defocus.ndim == 1:
        defocus = defocus.expand(phis.shape[0], defocus.shape[0])
    return model.compute_psf_from_pupil(phis, rho=rhos, defocus=defocus)


def depthvar_cost(data, psfs, anchors, weights, config: DeconvolutionConfig) -> DepthVaryingConvCost:
    """The depth-varying data term of the object step on ``config``'s
    variable grid (``depthvar.py:135-141``): ``psfs`` (K, ...), or one stack
    a lane (B, K, ...) for a batch ``data``, embedded at ``var_shape``."""
    var_shape = var_shape_of(config, data)
    if config.data_term == "poisson" and weights is not None:
        raise ValueError("data_term='poisson' does not compose with weights")
    if config.data_term not in ("gaussian", "poisson"):
        raise ValueError(f"unknown data_term {config.data_term!r}")
    return DepthVaryingConvCost.build(pad_fft_kernel(psfs, var_shape), data, weights, var_shape, anchors)


def depthvar_objective(cost: DepthVaryingConvCost, config: DeconvolutionConfig):
    """``x -> (f, grad f)`` of the object step (``depthvar.py:143-154``): the
    Gaussian term, or the Poisson deviance of ``H x + background``, plus the
    regularizer; per lane (B,) for a batch, whose TV is one batched launch."""
    reg = make_regularizer(config)

    def objective(x):
        if config.data_term == "poisson":
            f = generalized_kl(cost.model(x) + config.background, cost.data)
        else:
            f = cost.cost(x)
        if has_regularizer(config):
            f = f + reg(x)
        return f

    return value_and_grad(objective)


def depthvar_start(data, config: DeconvolutionConfig):
    """The default start: the data (one volume or a batch) on the variable
    grid, clamped at 0 under positivity."""
    x0 = pad_to_shape(data, var_shape_of(config, data))
    return torch.clamp_min(x0, 0.0) if config.positivity else x0


def deconvolve_depthvar(
    data: torch.Tensor,
    psfs: torch.Tensor,
    anchors=None,
    weights: torch.Tensor | None = None,
    x0: torch.Tensor | None = None,
    config: DeconvolutionConfig = DeconvolutionConfig(),
) -> DeconvolutionResult:
    """Solve the object step under the depth-varying blur
    (``depthvar.py:111-172``): ``psfs`` the (K, Nz, Ny, Nx) corner-origin
    anchor stack (e.g. :func:`depth_anchor_psfs`), ``anchors`` its z indices
    on the data grid (default K evenly spaced); ``config.var_shape`` pads the
    object grid, ``config.data_term`` picks the Gaussian or Poisson term."""
    fun = depthvar_objective(depthvar_cost(data, psfs, anchors, weights, config), config)
    res = minimize_vmlmb(fun, depthvar_start(data, config) if x0 is None else x0, **_vmlmb_options(config),
                         maxeval=config.max_eval)
    return DeconvolutionResult(res.x, res.f, res.iterations, res.evaluations, res.status, res.f_history,
                               res.pg_history)


def richardson_lucy_depthvar(
    data: torch.Tensor,
    psfs: torch.Tensor,
    anchors=None,
    iterations: int = 50,
    background: float = 0.0,
    mu: float = 0.0,
    epsilon: float = 1e-2,
    x0: torch.Tensor | None = None,
    accelerate: bool = False,
    stop: str = "fixed",
    stop_sigma=None,
    stop_tau: float = 1.0,
    return_iterations: bool = False,
):
    """Richardson-Lucy under the depth-varying blur (``depthvar.py:175-235``).

    The update divides by the per-voxel sensitivity ``H^T 1``, here the z
    profile ``sum_k w_k(z) * sum(h_k)``; the forward model is the anchor
    blend, the backprojection its exact adjoint ``sum_k w_k ⊙ (h_k^T (*) r)``,
    K batched FFTs each. RL-TV (``mu > 0``, one TV launch an iteration),
    Biggs-Andrews acceleration and the discrepancy stops are those of
    ``richardson_lucy``; the matched backprojector only. A constant stack is
    plain RL (partition of unity)."""
    shape = tuple(data.shape)
    psfs = pad_fft_kernel(psfs, shape)
    k = psfs.shape[0]
    if anchors is None:
        anchors = np.linspace(0.0, shape[0] - 1.0, k)
    zw = torch.as_tensor(depth_weights(shape[0], anchors), dtype=data.dtype, device=data.device)
    h_hat = torch.fft.rfftn(psfs, dim=(-3, -2, -1))

    def forward(y):
        return depth_varying_convolve(y, h_hat, zw, shape)

    def backward(r):
        backs = _irfftn(torch.conj(h_hat) * torch.fft.rfftn(r)[None], shape)
        return torch.sum(zw[:, :, None, None] * backs, dim=0)

    flux = torch.sum(zw * torch.sum(psfs, dim=(1, 2, 3))[:, None], dim=0)[:, None, None]
    return _rl_engine(data, forward, backward, flux, iterations, background, mu, epsilon, x0, accelerate, stop,
                      stop_sigma, stop_tau, return_iterations)


def _item_15(name: str):
    def unported(*args, **kw):
        raise NotImplementedError(f"{name} is not ported yet (ROADMAP.md queue 1, item 15: the rest of "
                                  "jobs/psf_fit.py, which it stands on)")

    unported.__name__ = unported.__qualname__ = name
    unported.__doc__ = f"``depthvar.{name}``: not ported yet (ROADMAP.md queue 1, item 15)."
    return unported


fit_psf_depthvar = _item_15("fit_psf_depthvar")  # fit_families_with_cost, depthvar.py:272-330
blind_deconvolve_depthvar = _item_15("blind_deconvolve_depthvar")  # its fits and bead_anchor_term, :333-475
calibrate_depth = _item_15("calibrate_depth")  # center_bead_stack, :491-640
ladder_fit_uncertainty = _item_15("ladder_fit_uncertainty")  # center_bead_stack and _gn_covariance, :643-
