"""Batched object steps: many volumes solved together on one card.

Port of ``microtipi_tpu/jobs/batch.py``. The JAX package batches by
``jax.vmap`` over ``deconvolve``; here a batch is a leading axis written out.
:func:`batched_deconvolve` runs one VMLMB solve per lane in lockstep
(``optim/vmlmb.minimize_vmlmb_batched``): every step makes one call of the
batched objective (``jobs/deconv.make_batched_objective``) over the lanes
still running, which is one batched FFT pair and one launch of the batched
hyperbolic-TV kernel. Each lane keeps its own iterate, line search, memory
and stopping, so lane b gives what ``deconvolve`` gives on volume b.
``engine="admm"`` hands the batch to the ADMM engine
(``jobs/admm.admm_deconvolve``), which is written over lanes: one batched FFT
pair and one launch of each of its kernels an iteration, per-lane ``rho``s and
per-lane Boyd stopping. :func:`batched_deconvolve_auto_mu` bisects a mu
a lane (``jobs/autotune.py``), each probe round one lockstep solve.
:func:`batched_deconvolve_depthvar` solves the depth-varying object step of
``jobs/depthvar.py`` a lane, in lockstep, one batched TV launch a step.


:func:`batched_blind_deconvolve` runs the blind loop over a batch. Per frame
(``joint_psf=False``, the JAX ``vmap`` of ``blind_deconvolve``) every round's
object step is one lockstep ``batched_deconvolve`` (or ADMM over the lanes)
with one PSF a lane, so each evaluation launches the batched TV kernel once;
the PSF fits then run lane by lane, each the single loop's fit of its frame.
With ``joint_psf=True`` one optical system explains every frame: the object
step is one VMLMB over the whole stack (``jobs/multichannel.make_tsmc_objective``
with one channel and no temporal term: one shared PSF, spatial TV a frame on
the batched TV kernel) and the fit minimizes the sum of the frames' data
terms over one parameter vector, the JAX package's mesh path
(``parallel/blind.py``) on one card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from microtipi_tpu_torch.jobs.admm import admm_deconvolve
from microtipi_tpu_torch.jobs.autotune import AutoMuResult, _auto_mu_lanes
from microtipi_tpu_torch.jobs.deconv import (
    DeconvolutionConfig,
    DeconvolutionResult,
    _f32_stall_continue_batched,
    _stacked,
    _vmlmb_options,
    lane_objective,
    make_batched_objective,
    stall_gate,
    var_shape_of,
)
from microtipi_tpu_torch.jobs.blind import (
    BlindDeconvConfig,
    BlindDeconvResult,
    _bead_terms,
    blind_fits,
    blind_start,
    run_blind_loop,
)
from microtipi_tpu_torch.jobs.depthvar import depthvar_cost, depthvar_objective, depthvar_start
from microtipi_tpu_torch.jobs.multichannel import make_tsmc_objective
from microtipi_tpu_torch.jobs.wiener import wiener
from microtipi_tpu_torch.ops.convolution import _irfftn, _rfftn
from microtipi_tpu_torch.optim.treeutil import value_and_grad
from microtipi_tpu_torch.optim.vmlmb import minimize_vmlmb, minimize_vmlmb_batched
from microtipi_tpu_torch.utils.arrays import pad_fft_kernel, pad_to_shape

__all__ = ["batched_deconvolve", "batched_blind_deconvolve", "batched_deconvolve_auto_mu",
           "batched_deconvolve_depthvar", "blind_deconvolve_stack"]


def batched_deconvolve(
    data: torch.Tensor,
    psf: torch.Tensor,
    weights: torch.Tensor | None = None,
    x0: torch.Tensor | None = None,
    config: DeconvolutionConfig = DeconvolutionConfig(),
    engine: str = "vmlmb",
) -> DeconvolutionResult:
    """Object update over a (B, Nz, Ny, Nx) stack (``jobs/batch.py:25-59``).

    ``psf`` is one corner-origin PSF shared by every lane (3D) or one per
    lane (4D, the tiled solver's field-varying path); ``weights``/``x0`` are
    batched or None (``x0`` None: the data, clamped at 0 under positivity).
    Runs on the device of its tensors. Returns a ``DeconvolutionResult`` with
    a leading batch axis on every field. Float32 uniform-weight lanes that
    stall on the quadratic form's value resolution continue on the residual
    form, each on its own budget, as ``deconvolve`` does.

    ``engine="admm"`` runs the ADMM engine instead, ``config.max_iter``
    iterations a lane with no line searches at all, without tracking the
    objective; ``config.admm_abstol``/``admm_reltol`` compose: each lane stops
    at its own Boyd residual test and the batch runs until the slowest stops.
    """
    if engine == "admm":
        if data.ndim != 4:
            raise ValueError(f"a batch of volumes is 4D, got shape {tuple(data.shape)}")
        return admm_deconvolve(data, psf, weights=weights, x0=x0, config=config, track_objective=False)
    if engine != "vmlmb":
        raise ValueError(f"unknown engine {engine!r}")
    if x0 is None:
        x0 = pad_to_shape(data, var_shape_of(config, data))
        if config.positivity:
            x0 = torch.clamp_min(x0, 0.0)
    fun = make_batched_objective(psf, data, weights, config)
    results = minimize_vmlmb_batched(fun, x0, **_vmlmb_options(config), maxeval=config.max_eval)
    if stall_gate(config, data, weights):
        results = _f32_stall_continue_batched(results, psf, data, config)
    return _stacked(results)


def batched_deconvolve_depthvar(
    data: torch.Tensor,
    psfs: torch.Tensor,
    anchors=None,
    weights: torch.Tensor | None = None,
    config: DeconvolutionConfig = DeconvolutionConfig(),
) -> DeconvolutionResult:
    """Depth-varying object update over a (B, Nz, Ny, Nx) stack
    (``jobs/batch.py:62-79``): one ``deconvolve_depthvar`` a lane, in
    lockstep. ``psfs`` is one (K, ...) anchor stack shared by the lanes (a
    time-lapse: the optics and the depth profile belong to the acquisition)
    or one a lane (B, K, ...), the tiled solver's; ``weights`` None or per
    lane. Each lockstep step is one batched FFT chain over the B x K
    weighted volumes and one batched TV launch. Returns a
    ``DeconvolutionResult`` with a leading batch axis on every field."""
    if data.ndim != 4:
        raise ValueError(f"a batch of volumes is 4D, got shape {tuple(data.shape)}")
    full = depthvar_cost(data, psfs, anchors, weights, config)
    fun = lane_objective(full, data.shape[0], lambda cost, lanes: depthvar_objective(cost, config))
    return _stacked(minimize_vmlmb_batched(fun, depthvar_start(data, config), **_vmlmb_options(config),
                                           maxeval=config.max_eval))


def batched_blind_deconvolve(
    data: torch.Tensor,
    model,
    params0=None,
    weights: torch.Tensor | None = None,
    config: BlindDeconvConfig = BlindDeconvConfig(),
    joint_psf: bool = False,
    bead_data: torch.Tensor | None = None,
) -> BlindDeconvResult:
    """Blind deconvolution over a (B, Nz, Ny, Nx) stack (``jobs/batch.py:82-121``).

    ``joint_psf=False``: each frame gets its own PSF estimate, and lane b's
    result is ``blind_deconvolve(data[b], model, params0[b], weights[b])``;
    ``params0`` is batched (a leading B on every field) or one params tuple
    for every frame (None: ``model.init_params()``). Every field of the
    result has a leading batch axis. ``joint_psf=True``: one parameter vector
    fitted to all frames, as :func:`blind_deconvolve_stack`; ``params0`` and
    the result's ``params`` are single. ``bead_data``: one bead stack that
    anchors every frame's fits. Runs on the device of ``data``.
    """
    if data.ndim != 4:
        raise ValueError(f"a batch of volumes is 4D, got shape {tuple(data.shape)}")
    if joint_psf:
        return blind_deconvolve_stack(data, model, params0=params0, weights=weights, config=config,
                                      bead_data=bead_data)
    nb = data.shape[0]
    lanes = _lane_params(model, params0, nb)
    x0 = torch.stack([blind_start(data[b], model, lanes[b], config) for b in range(nb)])
    aux_terms = _bead_terms(model, bead_data, config)
    fitters = [blind_fits(model, data[b], config, lanes[b], aux_terms) for b in range(nb)]

    def object_step(x, params, mu):
        with torch.no_grad():
            psfs = torch.stack([model.compute_psf(p) for p in params])
        dcfg = config.deconv if mu is None else dataclasses.replace(config.deconv, mu=mu)
        if config.deconv_engine == "admm":  # over_relax=1.0 inside the alternation, as blind_deconvolve
            res = admm_deconvolve(data, psfs, weights=weights, x0=x, config=dcfg, over_relax=1.0,
                                  track_objective=False)
        else:
            res = batched_deconvolve(data, psfs, weights=weights, x0=x, config=dcfg)
        return res.x, res.f, res.iterations, psfs

    def per_lane(k):
        """Each lane's ``fit_one`` (k = 0) or ``fit_joint`` (k = 1) on its own
        params, object and weights."""
        def run(params, x, w_fit, *args):
            out = [fitters[b][k](params[b], x[b], None if w_fit is None else w_fit[b], *args) for b in range(nb)]
            return [p for p, _ in out], np.array([f for _, f in out])

        return run

    f_dtype = np.float64 if data.dtype == torch.float64 else np.float32
    x, params, deconv_f, fit_f, deconv_iters = run_blind_loop(
        config, f_dtype, x0, lanes, object_step, lambda x, psf: weights, per_lane(0), per_lane(1), lanes=nb)
    with torch.no_grad():
        psfs = torch.stack([model.compute_psf(p) for p in params])
    stacked = params[0]._replace(**{n: torch.stack([getattr(p, n).detach() for p in params])
                                    for n in params[0]._fields})
    return BlindDeconvResult(x, stacked, psfs, np.moveaxis(deconv_f, 0, 1), np.moveaxis(fit_f, 0, 1),
                             np.moveaxis(deconv_iters, 0, 1))


def _lane_params(model, params0, nb: int) -> list:
    """One params tuple a lane from a batched ``params0`` (a leading axis of
    ``nb`` on every field), one shared tuple, or None (the model's start)."""
    if params0 is None:
        params0 = model.init_params()
    ref = model.init_params()
    batched = getattr(params0, ref._fields[0]).ndim == getattr(ref, ref._fields[0]).ndim + 1
    if not batched:
        return [params0] * nb
    return [params0._replace(**{n: getattr(params0, n)[b] for n in params0._fields}) for b in range(nb)]


def blind_deconvolve_stack(
    data: torch.Tensor,
    model,
    params0=None,
    weights: torch.Tensor | None = None,
    config: BlindDeconvConfig = BlindDeconvConfig(),
    bead_data: torch.Tensor | None = None,
) -> BlindDeconvResult:
    """One optical system constrained by every frame of a (B, Nz, Ny, Nx)
    stack: the blind loop of ``parallel/blind.py:48-196`` on one card.

    The object step is one VMLMB run over the whole stack with the shared
    PSF and a spatial TV a frame (``make_tsmc_objective`` with C = 1 and no
    temporal term: one batched FFT pair and one batched TV launch an
    evaluation); each fit minimizes the sum over frames of the residual data
    terms ``0.5 ||w (obj_b (*) h - d_b)||^2`` over one parameter vector with
    ``grtol = 0`` (``parallel/psf_fit.py:40-66``). ``deconv.var_shape``
    larger than a frame puts the object on the padded grid, the padding at
    zero weight, and the fits see the object masked to the data window.
    ``fit.fit_window`` and the ADMM engine raise, as in the JAX package. The
    returned ``params`` is one tuple, and ``obj`` is (B,) + the object grid.
    """
    if data.ndim != 4:
        raise ValueError(f"a batch of volumes is 4D, got shape {tuple(data.shape)}")
    if params0 is None:
        params0 = model.init_params()
    vol = tuple(data.shape[1:])
    var_shape = tuple(config.deconv.var_shape) if config.deconv.var_shape is not None else vol
    padded = var_shape != vol
    if config.fit.fit_window is not None:
        raise ValueError("PsfFitConfig.fit_window is a single-volume option (parallel/blind.py:80-84); "
                         "drop it for the joint loop")
    if config.deconv_engine == "admm":
        raise ValueError("the joint loop runs the VMLMB object step; deconv_engine='admm' takes one volume "
                         "(parallel/blind.py:85-90)")
    dcfg = dataclasses.replace(config.deconv, var_shape=None)
    if padded:  # the data window at weight 1 (or the user's), the padding at 0
        d_fit = pad_to_shape(data, var_shape)
        w_fit = pad_to_shape(torch.ones_like(data) if weights is None else weights, var_shape)
        window = pad_to_shape(torch.ones(vol, dtype=data.dtype, device=data.device), var_shape)
    else:
        d_fit, w_fit, window = data, weights, None

    if config.init == "wiener":
        k = pad_fft_kernel(model.compute_psf(params0), var_shape)
        x0 = torch.stack([wiener(d, k) for d in d_fit])
    else:
        x0 = pad_to_shape(data, var_shape)
    x0 = torch.clamp_min(x0, 0.0)

    def object_step(x, params, mu):
        with torch.no_grad():
            psf = model.compute_psf(params)
        cfg = dcfg if mu is None else dataclasses.replace(dcfg, mu=mu)
        objective, _ = make_tsmc_objective(psf, d_fit[:, None], None if w_fit is None else w_fit[:, None], cfg,
                                           coupling="separate")
        res = minimize_vmlmb(value_and_grad(objective), x[:, None], lower=0.0 if cfg.positivity else None,
                             mem=cfg.mem, maxiter=cfg.max_iter, maxeval=cfg.max_eval, gatol=cfg.gatol,
                             grtol=cfg.grtol)
        return res.x[:, 0], res.f, res.iterations, psf

    def stack_cost(x, w):
        """The sum over frames of the residual data terms (``parallel/psf_fit.py:40-66``);
        the dense loop crops the object to the data window before the fit, and
        masking is the padded grid's equivalent (``parallel/blind.py:104-107``)."""
        obj_hat = _rfftn(x if window is None else x * window)
        d = d_fit if w is None else torch.where(w > 0, d_fit, torch.zeros_like(d_fit))

        def cost(p):
            r = _irfftn(obj_hat * _rfftn(pad_fft_kernel(model.compute_psf(p), var_shape)), var_shape) - d
            return 0.5 * torch.sum(r * r if w is None else w * r * r)

        return cost

    fit_one, fit_joint = blind_fits(model, data, config, params0, _bead_terms(model, bead_data, config),
                                    cost_of=stack_cost)

    f_dtype = np.float64 if data.dtype == torch.float64 else np.float32
    x, params, deconv_f, fit_f, deconv_iters = run_blind_loop(
        config, f_dtype, x0, params0, object_step, lambda x, psf: w_fit, fit_one, fit_joint)
    with torch.no_grad():
        psf = model.compute_psf(params)
    return BlindDeconvResult(x, params, psf, deconv_f, fit_f, deconv_iters)


def batched_deconvolve_auto_mu(
    data: torch.Tensor,
    psf: torch.Tensor,
    weights: torch.Tensor | None = None,
    config: DeconvolutionConfig = DeconvolutionConfig(),
    **auto_kw,
) -> AutoMuResult:
    """Discrepancy-principle mu over a (B, Nz, Ny, Nx) stack, per frame
    (``jobs/batch.py:124-151``): each lane runs its own bisection with its
    own blind noise estimate, and each probe round is one lockstep solve of
    every lane at its own mu. ``auto_kw`` forwards ``sigma`` (a float shared
    by all lanes, one per lane, or None to estimate per lane), ``tau``,
    ``bracket``, ``steps``, ``search_max_iter`` and ``init``. Returns an
    ``AutoMuResult`` with a leading batch axis on every field, ``result``
    included."""
    if data.ndim != 4:
        raise ValueError(f"a batch of volumes is 4D, got shape {tuple(data.shape)}")
    return _auto_mu_lanes(data, psf, weights, config, **auto_kw)
