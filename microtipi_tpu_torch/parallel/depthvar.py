"""Mesh-sharded depth-varying deconvolution.

Port of ``microtipi_tpu/parallel/depthvar.py``: the depth-variant operator
``H x = sum_k h_k (*) (w_k x)`` on the (batch, z) mesh, one distributed-FFT
convolution an anchor (K is small). The blend rows ``w_k`` are taken by
global z offset: each z-slab multiplies by its own rows, with no exchange.
The anchor spectra live in the y-sharded layout (``parallel/fft.py``),
shared by the batch. Padded-variable mode follows
``parallel/deconv.make_sharded_objective``: the object lives on the padded
grid and the padding carries zero weight, the route to mesh-divisible grids.
The TV goes through the TV kernel's slab mode (``parallel/deconv.sharded_tv``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig, BlindDeconvResult, _bead_terms, run_blind_loop
from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, DeconvolutionResult, has_regularizer
from microtipi_tpu_torch.jobs.depthvar import depth_anchor_psfs
from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig, fit_families_with_cost
from microtipi_tpu_torch.models.microscope import PHASE, family_name
from microtipi_tpu_torch.ops.depthconv import depth_weights
from microtipi_tpu_torch.optim.vmlmb import minimize_vmlmb
from microtipi_tpu_torch.parallel.blind import _Grid
from microtipi_tpu_torch.parallel.deconv import _sharded_fun, pad_trailing, sharded_regularization, sharded_start
from microtipi_tpu_torch.parallel.fft import sharded_convolve, sharded_spectrum
from microtipi_tpu_torch.parallel.mesh import Mesh, ShardedVolume, gather, shard
from microtipi_tpu_torch.parallel.psf_fit import psf_slabs, synthesizes_planes
from microtipi_tpu_torch.utils.arrays import pad_fft_kernel

__all__ = [
    "sharded_blind_deconvolve_depthvar",
    "sharded_deconvolve_depthvar",
    "sharded_fit_psf_depthvar",
]


def _blend_rows(nz: int, anchors, mesh: Mesh, dtype) -> list[ShardedVolume]:
    """The K blend rows of ``ops.depthconv.depth_weights`` as (Nz, 1, 1)
    columns, each slab holding its own planes' weights."""
    zw = torch.as_tensor(depth_weights(nz, anchors), dtype=dtype)
    return [shard(row[:, None, None], mesh, False) for row in zw]


def _on_grid(psfs, var_shape) -> list:
    """The K anchor PSFs on the variable's grid: K sharded volumes there as
    they are, or a (K,) + volume stack zero-padded in FFT layout to it."""
    if not isinstance(psfs, ShardedVolume) and all(isinstance(h, ShardedVolume) for h in psfs):
        if any(tuple(h.shape) != var_shape for h in psfs):
            raise ValueError(f"sharded anchor PSFs must lie on the variable's grid {var_shape}, got "
                             f"{[tuple(h.shape) for h in psfs]}")
        return list(psfs)
    psfs = gather(psfs)
    return list(pad_fft_kernel(psfs, var_shape) if tuple(psfs.shape[1:]) != var_shape else psfs)


def _anchor_depths(model, anchors):
    """``field_of`` of ``parallel.psf_fit.psf_slabs`` for the K anchor PSFs
    of ``jobs.depthvar.depth_anchor_psfs`` (``depth0`` the parameters' depth)
    from a cell's copy of the plane inputs."""
    steps = np.asarray(anchors, np.float64) * model.config.dz

    def depths(inputs):
        return {"depths": inputs.depth[1] + torch.as_tensor(steps, dtype=inputs.depth.dtype,
                                                             device=inputs.depth.device)}

    return depths


def _depthvar_model(k_hats, rows, shape, mesh: Mesh):
    def model(x):
        hx = None
        for k_hat, w in zip(k_hats, rows):
            term = sharded_convolve(x * w, k_hat, shape, mesh)
            hx = term if hx is None else hx + term
        return hx

    return model


def sharded_deconvolve_depthvar(
    data,
    psfs,
    mesh: Mesh,
    anchors=None,
    weights=None,
    x0=None,
    config: DeconvolutionConfig = DeconvolutionConfig(),
) -> DeconvolutionResult:
    """The depth-varying object step on the mesh (``depthvar.py:44-130``):
    ``data`` (Nz, Ny, Nx) or batched (B, Nz, Ny, Nx); ``psfs`` the (K,) +
    volume corner-origin anchor stack shared by the batch, or K z-sharded
    volumes on the variable's grid (``parallel.psf_fit.psf_slabs``), whose
    spectra are taken from their tiles in place; ``anchors`` their z indices
    on the data grid (default K evenly spaced). The Gaussian data term (the
    JAX module's only one). The result's ``x`` is a sharded volume."""
    if config.data_term != "gaussian":
        raise ValueError("the sharded depth-varying step has the Gaussian data term only")
    vol_shape = tuple(data.shape[-3:])
    var_shape = tuple(config.var_shape) if config.var_shape is not None else vol_shape
    batched = data.ndim == 4
    k_hats = [sharded_spectrum(h, mesh) for h in _on_grid(psfs, var_shape)]
    k = len(k_hats)
    anchors = np.linspace(0.0, vol_shape[0] - 1.0, k) if anchors is None else np.asarray(anchors, np.float64)
    if anchors.shape != (k,):
        raise ValueError(f"need one anchor per kernel, got {anchors.shape} for K={k}")
    off_z = (var_shape[0] - vol_shape[0]) // 2
    rows = _blend_rows(var_shape[0], anchors + off_z, mesh, data.dtype)
    if weights is not None:
        # Zero weight excludes the voxel whatever its value (0 * NaN = NaN).
        # Data and weights carry no gradient, so these gathers run over processes too.
        weights = gather(weights)
        data = torch.where(weights > 0, gather(data), torch.zeros((), dtype=data.dtype, device=weights.device))
    if var_shape != vol_shape:
        dense = gather(data)
        d = shard(pad_trailing(dense, var_shape), mesh, batched)
        w = torch.ones(vol_shape, dtype=dense.dtype, device=dense.device) if weights is None else weights
        w = shard(pad_trailing(w, var_shape), mesh, w.ndim == 4)
    else:
        d = shard(data, mesh, batched)
        w = None if weights is None else shard(weights, mesh, weights.ndim == 4)
    model = _depthvar_model(k_hats, rows, var_shape, mesh)

    def objective(x):
        r = model(x) - d
        f = 0.5 * (r * r if w is None else w * r * r).sum()
        return f + sharded_regularization(x, config) if has_regularizer(config) else f

    x0 = sharded_start(data, var_shape, mesh, config.positivity) if x0 is None else shard(x0, mesh, batched)
    res = minimize_vmlmb(_sharded_fun(objective, x0), x0.variable(), lower=0.0 if config.positivity else None,
                         mem=config.mem, maxiter=config.max_iter, maxeval=config.max_eval, gatol=config.gatol,
                         grtol=config.grtol)
    return DeconvolutionResult(x0.with_tiles(res.x), res.f, res.iterations, res.evaluations, res.status,
                               res.f_history, res.pg_history)


def sharded_depthvar_fit_cost(model, data, obj, weights, mesh: Mesh, anchors, off_z: int = 0):
    """The depth-varying PSF fit's data term on the mesh (``depthvar.py:133-180``):
    the K blended objects' spectra are taken once; each evaluation
    synthesizes the K anchor PSFs from the parameters at the data grid's
    anchor depths and runs K distributed convolutions. On the model's grid
    each cell synthesizes its own planes of the K PSFs
    (``parallel.psf_fit.psf_slabs``, the gradient that crosses cells the
    pupil's); on a padded grid (``off_z`` shifts the blend rows there) the K
    PSFs are synthesized whole in one batch, zero-padded and cut."""
    vol = tuple(data.shape[-3:])
    batched = data.ndim == 4
    data = shard(data, mesh, batched)
    if weights is not None:
        weights = shard(weights, mesh, weights.ndim == 4)
        data = data.map(lambda dd, ww: torch.where(ww > 0, dd, torch.zeros_like(dd)), weights)
    anchors = np.asarray(anchors, np.float64)
    obj = shard(obj, mesh, obj.ndim == 4)
    obj_hats = [sharded_spectrum(obj * w, mesh) for w in _blend_rows(vol[0], anchors + off_z, mesh, data.dtype)]
    planes, depths = synthesizes_planes(model, vol), _anchor_depths(model, anchors)

    def cost(p):
        if planes:
            psfs = psf_slabs(model, p, mesh, depths)
        else:
            whole = pad_fft_kernel(depth_anchor_psfs(model, p, anchors, depth0=p.depth[1]), vol)
            psfs = [shard(h, mesh, False) for h in whole]
        pred = None
        for psf, obj_hat in zip(psfs, obj_hats):
            term = sharded_convolve(psf, obj_hat, vol, mesh)
            pred = term if pred is None else pred + term
        r = pred - data
        return 0.5 * (r * r if weights is None else weights * r * r).sum()

    return cost


def sharded_fit_psf_depthvar(
    model,
    params,
    flags: tuple[int, ...],
    data,
    obj,
    mesh: Mesh,
    anchors,
    weights=None,
    config: PsfFitConfig | None = None,
    phase_active: int | None = None,
    phase_freeze_head: int = 0,
    phase_anchor: torch.Tensor | None = None,
    phase_prior_weight: float = 0.0,
    aux_terms: tuple = (),
    off_z: int = 0,
):
    """The sharded ``jobs.depthvar.fit_psf_depthvar`` (``depthvar.py:183-232``):
    one flag fits that family, several fit jointly, under the depth-varying
    operator; the DEPTH family is fittable and preconditioned; a batch gives
    one parameter vector."""
    if not hasattr(params, "depth"):
        raise ValueError("sharded_fit_psf_depthvar needs a model with a DEPTH family (models/gibson_lanni.py) — "
                         "the anchors vary that family")
    cost = sharded_depthvar_fit_cost(model, data, obj, weights, mesh, anchors, off_z=off_z)
    return fit_families_with_cost(cost, params, tuple(family_name(f) for f in flags),
                                  PsfFitConfig() if config is None else config, phase_active=phase_active,
                                  phase_freeze_head=phase_freeze_head, phase_anchor=phase_anchor,
                                  phase_prior_weight=phase_prior_weight, aux_terms=aux_terms)


def sharded_blind_deconvolve_depthvar(
    data,
    model,
    mesh: Mesh,
    anchors,
    params0=None,
    weights=None,
    weight_updater=None,
    config: BlindDeconvConfig | None = None,
    bead_data: torch.Tensor | None = None,
) -> BlindDeconvResult:
    """Blind depth-varying deconvolution on the mesh (``depthvar.py:235-384``):
    ``jobs.depthvar.blind_deconvolve_depthvar`` with the features of
    ``parallel.blind.sharded_blind_deconvolve`` (batched frames sharing the
    optics, mesh-odd Nz/Ny padded with zero weight, every
    ``BlindDeconvConfig`` knob but the ADMM engine and the fit window, which
    the dense depth-varying loop refuses too). ``anchors``: K z indices of the
    data grid, or an int K. The object step's K anchor PSFs are synthesized
    z-sharded, each cell its own planes, as the fits' are (see
    ``parallel.blind``). The result's PSF is the (K, ...) anchor stack,
    synthesized whole once on every rank."""
    config = BlindDeconvConfig() if config is None else config
    if config.deconv_engine != "vmlmb":
        raise ValueError("deconv_engine='admm' needs a circulant forward model; the depth-varying anchor blend is "
                         "not circulant — use vmlmb")
    if config.fit.fit_window is not None:
        raise ValueError("fit_window is not supported by the depth-varying loop (its fits see every anchor)")
    params0 = model.init_params() if params0 is None else params0
    if not hasattr(params0, "depth"):
        raise ValueError("sharded_blind_deconvolve_depthvar needs a model with a DEPTH family "
                         "(models/gibson_lanni.py)")
    vol = tuple(data.shape[-3:])
    if isinstance(anchors, int):
        anchors = np.linspace(0.0, vol[0] - 1.0, anchors)
    anchors = np.asarray(anchors, np.float64)
    base_var = tuple(config.deconv.var_shape) if config.deconv.var_shape is not None else vol
    grid = _Grid(data, weights, base_var, mesh)
    off_z = (grid.var_shape[0] - vol[0]) // 2
    dcfg = dataclasses.replace(config.deconv, var_shape=grid.var_shape if grid.padded else None)
    fit_cfg = dataclasses.replace(config.fit, grtol=0.0)  # BlindDeconvJob.java:124

    def synth(p):
        """The object step's K anchor PSFs: each cell's planes on the loop's
        grid (the fits' depths)."""
        with torch.no_grad():
            return psf_slabs(model, p, mesh, _anchor_depths(model, anchors), grid=grid.var_shape)

    with torch.no_grad():
        # Middle-anchor regularized inverse: the best shift-invariant stand-in.
        x0 = grid.start(lambda: synth(params0)[anchors.shape[0] // 2], config.init)

    def object_step(x, params, mu):
        psfs = synth(params)
        cfg_i = dcfg if mu is None else dataclasses.replace(dcfg, mu=mu)
        res = sharded_deconvolve_depthvar(grid.data, psfs, mesh, anchors, weights=weights, x0=x, config=cfg_i)
        return res.x, res.f, res.iterations, psfs

    def fit_weights(x, psfs):
        if weight_updater is None:
            return grid.w_fit
        with torch.no_grad():
            rows = _blend_rows(grid.var_shape[0], anchors + off_z, mesh, x.dtype)
            k_hats = [sharded_spectrum(h, mesh) for h in _on_grid(psfs, grid.var_shape)]
            return grid.refit_weights(weight_updater, _depthvar_model(k_hats, rows, grid.var_shape, mesh)(x))

    phase_anchor = params0.phase.detach() if config.phase_prior_weight > 0 else None
    aux_terms = _bead_terms(model, bead_data, config)

    def fit(params, x, w_fit, flags, max_iter, phase_active):
        return sharded_fit_psf_depthvar(
            model, params, flags, grid.d_fit, grid.mask(x.detach()), mesh, anchors, weights=w_fit,
            config=dataclasses.replace(fit_cfg, max_iter=max_iter), phase_active=phase_active,
            phase_freeze_head=config.phase_freeze_head if PHASE in flags else 0,
            phase_anchor=phase_anchor if PHASE in flags else None,
            phase_prior_weight=config.phase_prior_weight if PHASE in flags else 0.0, aux_terms=aux_terms,
            off_z=off_z)

    def fit_one(params, x, w_fit, j, phase_active):
        res = fit(params, x, w_fit, (config.families[j],), config.psf_max_iter[j], phase_active)
        return res.params, res.f

    def fit_joint(params, x, w_fit, jfams):
        res = fit(params, x, w_fit, jfams, max(config.psf_max_iter), None)
        return res.params, res.f

    f_dtype = np.float64 if data.dtype == torch.float64 else np.float32
    x, params, deconv_f, fit_f, deconv_iters = run_blind_loop(config, f_dtype, x0, params0, object_step,
                                                              fit_weights, fit_one, fit_joint)
    with torch.no_grad():
        psfs = depth_anchor_psfs(model, params, anchors, depth0=params.depth[1])
    return BlindDeconvResult(x, params, psfs, deconv_f, fit_f, deconv_iters)
