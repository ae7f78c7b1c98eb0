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

The PSF fits under the same operator (:func:`fit_psf_depthvar`, the anchors
re-synthesized from the parameters at every evaluation), the blind loop
(:func:`blind_deconvolve_depthvar`, with the calibration prior and bead
anchors of ``jobs/blind.py``) and the depth-ladder bead calibration
(:func:`calibrate_depth`: beads at known depths pin the sample index, the K
rungs synthesized in one batched synthesis) with its error bars
(:func:`ladder_fit_uncertainty`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig, BlindDeconvResult, _bead_terms, run_blind_loop
from microtipi_tpu_torch.jobs.deconv import (
    DeconvolutionConfig,
    DeconvolutionResult,
    _vmlmb_options,
    has_regularizer,
    make_regularizer,
    var_shape_of,
)
from microtipi_tpu_torch.jobs.psf_fit import (
    FitUncertainty,
    PsfFitConfig,
    PsfFitResult,
    _gn_covariance,
    _jacobian,
    _profiled,
    _profiled_residual,
    _run_vmlmb,
    _split_std,
    center_bead_stack,
    fit_families_with_cost,
    joint_variable,
    model_at,
)
from microtipi_tpu_torch.jobs.richardson_lucy import _rl_engine
from microtipi_tpu_torch.jobs.wiener import wiener
from microtipi_tpu_torch.models.microscope import PHASE, family_name
from microtipi_tpu_torch.ops.convolution import _irfftn, generalized_kl
from microtipi_tpu_torch.ops.depthconv import DepthVaryingConvCost, depth_varying_convolve, depth_weights
from microtipi_tpu_torch.optim.treeutil import value_and_grad
from microtipi_tpu_torch.optim.vmlmb import minimize_vmlmb
from microtipi_tpu_torch.utils.arrays import crop_to_shape, pad_fft_kernel, pad_to_shape

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


def _depthvar_fit_cost(obj, data, weights, anchors):
    """``psfs -> cost`` of a depth-varying PSF fit (``depthvar.py:238-271``):
    the object is fixed, so the spectra of the K masked objects ``w_k x``
    are taken once and an evaluation is one batched rfftn of the anchor
    stack and one irfftn; the residual form (no quadratic shortcut)."""
    shape = tuple(data.shape)
    if weights is not None:
        data = torch.where(weights > 0, data, torch.zeros_like(data))  # zero weight excludes the voxel
    zw = torch.as_tensor(depth_weights(shape[0], anchors), dtype=data.dtype, device=data.device)
    xk_hat = torch.fft.rfftn(zw[:, :, None, None] * obj[None], dim=(-3, -2, -1))

    def cost(psfs):
        pred = _irfftn(torch.sum(torch.fft.rfftn(psfs, dim=(-3, -2, -1)) * xk_hat, dim=0), shape)
        r = pred - data
        return 0.5 * torch.sum(r * r) if weights is None else 0.5 * torch.sum(weights * r * r)

    return cost


def _needs_depth(params, what: str) -> None:
    if not hasattr(params, "depth"):
        raise ValueError(f"{what} needs a model with a DEPTH family (models/gibson_lanni.py)")


def fit_psf_depthvar(
    model,
    params,
    flags: tuple[int, ...],
    data: torch.Tensor,
    obj: torch.Tensor,
    anchors,
    weights: torch.Tensor | None = None,
    config: PsfFitConfig | None = None,
    phase_active: int | None = None,
    phase_freeze_head: int = 0,
    phase_anchor: torch.Tensor | None = None,
    phase_prior_weight: float = 0.0,
    aux_terms: tuple = (),
):
    """Fit PSF families under the depth-varying operator
    (``depthvar.py:274-330``): one flag fits that family (``phase_active``,
    ``phase_freeze_head``), several fit jointly, through
    ``psf_fit.fit_families_with_cost``. The anchor stack is re-synthesized
    from the current parameters at every evaluation, at the depths
    ``params.depth[1] + anchors * dz``, so the DEPTH family itself (the
    sample index and the depth of plane 0) is fittable."""
    _needs_depth(params, "fit_psf_depthvar")
    names = tuple(family_name(f) for f in flags)
    if weights is not None and weights.shape != data.shape:
        weights = pad_to_shape(weights, tuple(data.shape))
    data_cost = _depthvar_fit_cost(obj, data, weights, anchors)

    def cost(p):
        return data_cost(depth_anchor_psfs(model, p, anchors, depth0=p.depth[1]))

    return fit_families_with_cost(cost, params, names, PsfFitConfig() if config is None else config,
                                  phase_active=phase_active, phase_freeze_head=phase_freeze_head,
                                  phase_anchor=phase_anchor, phase_prior_weight=phase_prior_weight,
                                  aux_terms=aux_terms)


def blind_deconvolve_depthvar(
    data: torch.Tensor,
    model,
    anchors,
    params0=None,
    x0: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
    weight_updater=None,
    config: BlindDeconvConfig | None = None,
    bead_data: torch.Tensor | None = None,
    phase_anchor: torch.Tensor | None = None,
) -> BlindDeconvResult:
    """The blind loop under a depth-varying PSF (``depthvar.py:334-475``):
    the object step is :func:`deconvolve_depthvar` (one TV launch an
    evaluation), every fit :func:`fit_psf_depthvar`, and the anchor stack is
    re-synthesized from the parameters each round. ``anchors``: K z indices
    of the data grid, or an int K for K evenly spaced. Every
    ``BlindDeconvConfig`` option applies but the ADMM engine (the anchor
    blend is not circulant) and the fit window (the JAX loop ignores it;
    this one refuses it); the result's PSF is the (K, Nz, Ny, Nx) anchor
    stack. ``phase_anchor``: the calibration prior's anchor (default
    ``params0``'s phase where ``config.phase_prior_weight > 0``)."""
    if config is None:
        config = BlindDeconvConfig()
    if config.deconv_engine != "vmlmb":
        raise ValueError("deconv_engine='admm' needs a circulant forward model; the depth-varying anchor blend is "
                         "not circulant — use vmlmb")
    if config.fit.fit_window is not None:
        raise ValueError("fit_window is not supported by the depth-varying loop (its fits see every anchor)")
    if params0 is None:
        params0 = model.init_params()
    _needs_depth(params0, "blind_deconvolve_depthvar")
    if isinstance(anchors, int):
        anchors = np.linspace(0.0, data.shape[0] - 1.0, anchors)
    anchors = np.asarray(anchors, np.float64)
    shape = tuple(data.shape)
    var_shape = tuple(config.deconv.var_shape) if config.deconv.var_shape is not None else shape

    def synth(p):
        with torch.no_grad():
            return depth_anchor_psfs(model, p, anchors, depth0=p.depth[1])

    if x0 is None:
        # The middle anchor is the best shift-invariant stand-in for the blur.
        x0 = wiener(data, synth(params0)[anchors.shape[0] // 2]) if config.init == "wiener" else data
        x0 = torch.clamp_min(pad_to_shape(x0, var_shape), 0.0)
    fit_cfg = dataclasses.replace(config.fit, grtol=0.0)  # BlindDeconvJob.java:124

    def object_step(x, params, mu):
        psfs = synth(params)
        dcfg = config.deconv if mu is None else dataclasses.replace(config.deconv, mu=mu)
        dres = deconvolve_depthvar(data, psfs, anchors, weights=weights, x0=x, config=dcfg)
        return dres.x, dres.f, dres.iterations, psfs

    def fit_weights(x, psfs):
        if weight_updater is None:
            return weights
        cost = DepthVaryingConvCost.build(pad_fft_kernel(psfs, var_shape), data, None, var_shape, anchors)
        return weight_updater(cost.model(x), data)

    def at_data(x):
        return crop_to_shape(x, shape) if tuple(x.shape) != shape else x

    if phase_anchor is None:
        phase_anchor = params0.phase.detach() if config.phase_prior_weight > 0 else None
    else:
        phase_anchor = torch.as_tensor(phase_anchor, dtype=params0.phase.dtype, device=params0.phase.device)
    aux_terms = _bead_terms(model, bead_data, config)

    def fit(params, x, w_fit, flags, max_iter, phase_active):
        return fit_psf_depthvar(
            model, params, flags, data, at_data(x), anchors, weights=w_fit,
            config=dataclasses.replace(fit_cfg, max_iter=max_iter), phase_active=phase_active,
            phase_freeze_head=config.phase_freeze_head if PHASE in flags else 0,
            phase_anchor=phase_anchor if PHASE in flags else None,
            phase_prior_weight=config.phase_prior_weight if PHASE in flags else 0.0, aux_terms=aux_terms)

    def fit_one(params, x, w_fit, j, phase_active):
        res = fit(params, x, w_fit, (config.families[j],), config.psf_max_iter[j], phase_active)
        return res.params, res.f

    def fit_joint(params, x, w_fit, jfams):
        res = fit(params, x, w_fit, jfams, max(config.psf_max_iter), None)
        return res.params, res.f

    f_dtype = np.float64 if data.dtype == torch.float64 else np.float32
    x, params, deconv_f, fit_f, deconv_iters = run_blind_loop(config, f_dtype, x0, params0, object_step,
                                                              fit_weights, fit_one, fit_joint)
    return BlindDeconvResult(x, params, synth(params), deconv_f, fit_f, deconv_iters)


def _cyclic_shift_z(h: torch.Tensor, s, cdtype) -> torch.Tensor:
    """Cyclic z shift by +s voxels through a Fourier phase ramp
    (``depthvar.py:478-488``): ``shifted[0] = h[-s]``. ``h`` one volume and
    a scalar ``s``, or a stack (K, ...) and ``s`` (K,); differentiable."""
    nz = h.shape[-3]
    fz = torch.as_tensor(np.fft.rfftfreq(nz), dtype=h.dtype, device=h.device)
    s = torch.as_tensor(s, dtype=h.dtype, device=h.device)
    ramp = torch.exp((-2j * math.pi) * (fz * s[..., None]).to(cdtype))
    return torch.fft.irfft(torch.fft.rfft(h, dim=-3) * ramp[..., None, None], n=nz, dim=-3).to(h.dtype)


class _Ladder:
    """The rungs of a depth ladder (``depthvar.py:553-581,675-683``): each
    bead normalized to unit peak and centred (raw camera scales stall the
    float32 line search), the bead model at the stack's grid, the rungs'
    depth offsets ``z_j * dz``; ``psfs(p, zshifts)`` synthesizes all K
    rungs at ``p.depth[1] + offsets`` in one batched synthesis and shifts
    each by its own z shift."""

    def __init__(self, model, beads, anchors_z, subvoxel: bool):
        beads = torch.as_tensor(beads, dtype=model.dtype, device=model.device)
        if beads.ndim != 4:
            raise ValueError(f"beads must be (K, nz, ny, nx), got {tuple(beads.shape)}")
        anchors_z = np.asarray(anchors_z, np.float64)
        if anchors_z.shape != (beads.shape[0],):
            raise ValueError(f"anchors_z needs one z position per bead, got {anchors_z.shape} for {beads.shape[0]} "
                             "beads")
        self.model = model_at(model, beads.shape[1:])
        self.offsets = torch.as_tensor(anchors_z * model.config.dz, dtype=model.dtype, device=model.device)
        tiny = torch.finfo(beads.dtype).tiny
        self.data = torch.stack([center_bead_stack(b / torch.clamp_min(torch.max(torch.abs(b)), tiny),
                                                   subvoxel=subvoxel) for b in beads])
        self.s1d = torch.sum(self.data, dim=(-3, -2, -1))
        self.n = float(self.data[0].numel())

    def psfs(self, p, zshifts):
        h = self.model.compute_depth_psfs(p, p.depth[1] + self.offsets)
        return _cyclic_shift_z(h, zshifts, self.model.cdtype)

    def cost(self, p, zshifts):
        return torch.sum(_profiled_residual(self.psfs(p, zshifts), self.data, self.s1d, self.n))


def calibrate_depth(
    model,
    beads,
    anchors_z,
    families: tuple[int, ...] = (3,),  # (DEPTH,)
    params0=None,
    config: PsfFitConfig | None = None,
    phase_freeze_head: int = 0,
    subvoxel: bool = True,
):
    """Depth-ladder calibration (``depthvar.py:491-640``): fit the
    Gibson-Lanni DEPTH family (``ns/lambda`` and the depth ``d0`` of plane 0)
    from bead stacks at K known z positions ``anchors_z`` (data-grid voxels),
    bead j at depth ``d0 + anchors_z[j] * dz``; one bead cannot separate ns
    from d0, two or more pin the slope of the aberration with depth. Each
    rung contributes the profiled amplitude-and-background objective of
    ``psf_fit.bead_anchor_term`` and a free axial origin ``zshift`` (voxels,
    a cyclic Fourier shift of the model), started at the model's own focal
    shift under ``params0`` (a zero start strands deep stacks in a local
    minimum of the shift). One joint VMLMB run over the gradient-balanced
    families and the K shifts. ``beads``: (K, nz, ny, nx); ``families``
    must include DEPTH. Returns ``(PsfFitResult, zshifts)``."""
    config = PsfFitConfig() if config is None else config
    if params0 is None:
        params0 = model.init_params()
    _needs_depth(params0, "calibrate_depth")
    names = tuple(family_name(f) for f in families)
    if "depth" not in names:
        raise ValueError("calibrate_depth fits the DEPTH family; include it in families")
    for n in names:
        if getattr(params0, n).shape[0] == 0:
            raise ValueError(f"family {n!r} has no coefficients to fit")
    ladder = _Ladder(model, beads, anchors_z, subvoxel)
    nz = ladder.data.shape[1]
    # Start each shift at the start model's focal shift: the data peak sits
    # at plane 0 after centring, the model's at its wrapped argmax plane.
    with torch.no_grad():
        h = ladder.model.compute_depth_psfs(params0, params0.depth[1] + ladder.offsets)
        i = torch.argmax(torch.amax(h.reshape(h.shape[0], nz, -1), dim=2), dim=1)
        zs0 = -torch.where(i > nz // 2, i - nz, i).to(model.dtype)
    _, g0 = value_and_grad(lambda sub: ladder.cost(params0._replace(**sub), zs0))(
        {n: getattr(params0, n) for n in names})
    x0, rebuild = joint_variable(params0, names, phase_freeze_head, grads=g0)
    res = _run_vmlmb(lambda v: ladder.cost(rebuild({n: v[n] for n in names}), v["zshift"]), dict(x0, zshift=zs0),
                     config)
    fit = PsfFitResult(rebuild({n: res.x[n] for n in names}), res.f, res.iterations, res.evaluations, res.status,
                       res.f_history)
    return fit, res.x["zshift"]


def ladder_fit_uncertainty(
    model,
    params,
    families: tuple[int, ...],
    beads,
    anchors_z,
    zshifts,
    subvoxel: bool = True,
    sigma: float | None = None,
) -> FitUncertainty:
    """Error bars of a :func:`calibrate_depth` solution
    (``depthvar.py:643-744``): the Gauss-Newton recipe of
    ``psf_fit.bead_fit_uncertainty`` on every rung's prediction ``amp_j *
    shift_z(h(theta, d0 + z_j dz), s_j) + c_j`` over the shared families,
    the per-rung shifts, amplitudes and backgrounds as columns,
    marginalized. ``std`` gains ``"zshift"``, ``"amp"`` and ``"background"``
    (K,) entries; ``std["depth"][0] * wavelength`` is the error bar of ns.
    Pass the ``calibrate_depth`` call's model, beads, ``anchors_z`` and
    ``subvoxel`` and its fitted params and shifts."""
    names = tuple(family_name(f) for f in families)
    ladder = _Ladder(model, beads, anchors_z, subvoxel)
    k = ladder.data.shape[0]
    zshifts = torch.as_tensor(zshifts, dtype=model.dtype, device=model.device)
    with torch.no_grad():
        amps, cs = _profiled(ladder.psfs(params, zshifts), ladder.data, ladder.s1d, ladder.n)
    sizes = [int(getattr(params, nm).shape[0]) for nm in names]
    x0 = torch.cat([getattr(params, nm).detach() for nm in names] + [zshifts, amps, cs])

    def predict(v):
        sub, off = {}, 0
        for nm, sz in zip(names, sizes):
            sub[nm] = v[off:off + sz]
            off += sz
        s_all, a_all, c_all = v[off:off + k], v[off + k:off + 2 * k], v[off + 2 * k:off + 3 * k]
        return a_all[:, None, None, None] * ladder.psfs(params._replace(**sub), s_all) + c_all[:, None, None, None]

    jac = _jacobian(predict, x0)
    with torch.no_grad():
        resid = (predict(x0) - ladder.data).reshape(-1)
    cov, sigma_out = _gn_covariance(jac, None, x0.shape[0], sigma, resid, ladder.data.dtype)
    std = _split_std(torch.sqrt(torch.diagonal(cov)), names, sizes, (("zshift", k), ("amp", k), ("background", k)))
    return FitUncertainty(std, cov, sigma_out)
