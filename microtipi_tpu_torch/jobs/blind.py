"""Blind deconvolution: alternate object updates and PSF-parameter fits.

Port of the slice's part of ``microtipi_tpu/jobs/blind.py`` (reference:
``microUtils/BlindDeconvJob.java``, ``blindDeconv`` :97-138):

  for each of ``loops`` rounds:
    1. synthesize the PSF from the current parameters and run the object
       update (``:100-108``);
    2. optionally re-estimate data weights from the current model for the
       PSF step (``:109-111``);
    3. unless this is the last round (``:116``), fit each configured family
       in order with its own budget and ``grtol = 0`` (``:118-133``),
       skipping zero-budget families (``:126``) — or all of them jointly.

The JAX ``fori_loop`` and unrolled paths become one Python loop. The object
step is VMLMB (``jobs/deconv.deconvolve``) or, with ``deconv_engine="admm"``,
the ADMM engine (``jobs/admm.admm_deconvolve``). A bead calibration anchors
the fits two ways: the calibration prior pulls the phase toward ``params0``
(``phase_prior_weight``), and a bead stack joins every fit as a data term of
its own (``bead_data``, ``psf_fit.bead_anchor_term``). ``fit.fit_window``
moves the fits to a centred crop.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from microtipi_tpu_torch.jobs.admm import admm_deconvolve
from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, deconvolve
from microtipi_tpu_torch.jobs.wiener import wiener
from microtipi_tpu_torch.jobs.psf_fit import (
    PsfFitConfig,
    _fit_data_term,
    _fit_joint,
    _fit_single,
    bead_anchor_term,
    model_at,
)
from microtipi_tpu_torch.models.microscope import DEFOCUS, DEPTH, MODULUS, PHASE, SHEET, family_name
from microtipi_tpu_torch.ops.convolution import WeightedConvolutionCost
from microtipi_tpu_torch.utils.arrays import crop_to_shape, pad_fft_kernel, pad_to_shape

__all__ = ["BlindDeconvConfig", "BlindDeconvResult", "blind_deconvolve", "blind_fits", "blind_start",
           "run_blind_loop"]


@dataclasses.dataclass(frozen=True)
class BlindDeconvConfig:
    """Schedule of the alternating loop, the slice's fields of the JAX
    config (``jobs/blind.py:49-153``): ``families``/``psf_max_iter`` pair up
    like the reference's ``parametersFlags``/``maxIter``
    (``BlindDeconvJob.java:80-88``); ``phase_schedule`` and ``mu_schedule``
    give per-round active phase modes and TV weights; ``joint_fit`` fits the
    families in one VMLMB run; ``phase_freeze_head`` freezes the first phase
    coefficients; ``init`` is the round-1 warm start. ``deconv_engine`` is
    "vmlmb" (reference semantics, ``PSF_Estimation.java:186-199``) or "admm":
    ``deconv.max_iter`` fixed iterations a round (or Boyd stopping, if the
    object config sets it) on the plain TV objective; pair it with an annealed
    ``mu_schedule`` (:meth:`recommended`), since an exactly converged object
    step under a weak constant mu absorbs the aberration.
    ``phase_prior_weight`` adds ``w * f0 * ||phase - phase(params0)||^2`` to
    every fit, anchored at the initial parameters (a bead calibration passed
    as ``params0``); ``bead_weight`` weighs the bead stack's data term in
    natural intensity units (1 is the joint maximum likelihood when bead and
    sample share a noise level), ``bead_subvoxel`` centres the bead laterally
    to a subvoxel (``jobs/blind.py:86-109``). With ``skip_last_fit`` (the
    default) the last round never refits (``BlindDeconvJob.java:116``);
    False makes every round fit, for a caller that composes one-round runs
    on the host (the CLI's checkpointed rounds) and skips the true last
    round's fit itself (``jobs/blind.py:80-86``)."""

    loops: int = 5
    families: tuple[int, ...] = (DEFOCUS, PHASE, MODULUS)
    psf_max_iter: tuple[int, ...] = (20, 20, 20)
    deconv: DeconvolutionConfig = dataclasses.field(default_factory=DeconvolutionConfig)
    fit: PsfFitConfig = dataclasses.field(default_factory=PsfFitConfig)
    phase_schedule: tuple[int, ...] | None = None
    joint_fit: bool = False
    phase_freeze_head: int = 0
    init: str = "data"
    skip_last_fit: bool = True
    phase_prior_weight: float = 0.0
    bead_weight: float = 1.0
    bead_subvoxel: bool = True
    mu_schedule: tuple[float, ...] | None = None
    deconv_engine: str = "vmlmb"

    def __post_init__(self):
        if len(self.families) != len(self.psf_max_iter):
            raise ValueError("families and psf_max_iter must have the same length")
        if self.phase_schedule is not None and len(self.phase_schedule) != self.loops:
            raise ValueError("phase_schedule must have one entry per loop")
        if self.mu_schedule is not None and len(self.mu_schedule) != self.loops:
            raise ValueError("mu_schedule must have one entry per loop")
        if self.joint_fit and self.phase_schedule is not None:
            raise ValueError("phase_schedule is not supported with joint_fit")
        if self.init not in ("data", "wiener"):
            raise ValueError(f"unknown init {self.init!r}")
        if self.deconv_engine not in ("vmlmb", "admm"):
            raise ValueError(f"unknown deconv_engine {self.deconv_engine!r}")
        if self.deconv_engine == "admm" and (
            self.deconv.sparsity > 0 or self.deconv.hessian > 0 or self.deconv.var_shape is not None
        ):
            raise ValueError("deconv_engine='admm' supports the plain TV objective only (no sparsity/hessian "
                             "priors, no padded-variable mode); use the vmlmb engine")

    @classmethod
    def recommended(cls, pin_z4: bool = False, **overrides) -> "BlindDeconvConfig":
        """The quality recipe of ``jobs/blind.py:155-177``: joint fit, the
        wiener warm start, and a TV weight annealed from 64x the base ``mu``
        by 4x per round; ``pin_z4`` freezes the first phase mode."""
        base = dict(joint_fit=True, init="wiener", phase_freeze_head=1 if pin_z4 else 0)
        base.update(overrides)
        cfg = cls(**base)
        if cfg.mu_schedule is None and cfg.deconv.mu > 0:
            sched = tuple(cfg.deconv.mu * max(1.0, 64.0 / 4.0**i) for i in range(cfg.loops))
            cfg = dataclasses.replace(cfg, mu_schedule=sched)
        return cfg


class BlindDeconvResult(NamedTuple):
    obj: torch.Tensor  # restored object
    params: object  # fitted PSF parameters
    psf: torch.Tensor  # final synthesized PSF (corner-origin)
    deconv_f: np.ndarray  # per-round final object-step cost, (loops,)
    fit_f: np.ndarray  # per-round per-family final PSF-step cost, (loops, nfam)
    deconv_iters: np.ndarray  # per-round object-step iterations, (loops,)


def run_blind_loop(config, f_dtype, x0, params0, object_step, fit_weights, fit_one, fit_joint,
                   lanes: int | None = None):
    """Driver of the alternating loop (``jobs/blind.py:189-266``): round
    order, skip-refit on the last round (``BlindDeconvJob.java:116``) unless
    ``config.skip_last_fit`` is False (``jobs/blind.py:242``), the
    zero-budget family skip (``:126``), per-round schedules and the joint
    dispatch. The callables are those of the JAX loop:
    ``object_step(x, params, mu) -> (x, f, iterations, psf)``,
    ``fit_weights(x, psf)``, ``fit_one(params, x, w, j, phase_active)`` and
    ``fit_joint(params, x, w, flags)``, each fit returning ``(params, f)``.
    ``lanes``: the loop runs ``lanes`` independent problems in lockstep, and
    every f and iteration count the callables return is one per lane; the
    histories then have the lanes after the round axis."""
    nfam = len(config.families)
    lead = () if lanes is None else (lanes,)
    deconv_f = np.full((config.loops,) + lead, np.nan, f_dtype)
    fit_f = np.full((config.loops,) + lead + (nfam,), np.nan, f_dtype)
    deconv_iters = np.zeros((config.loops,) + lead, np.int32)
    x, params = x0, params0
    for i in range(config.loops):
        mu = config.mu_schedule[i] if config.mu_schedule else None
        x, deconv_f[i], deconv_iters[i], psf = object_step(x, params, mu)
        w_fit = fit_weights(x, psf)
        if i == config.loops - 1 and config.skip_last_fit:
            continue  # fit_f row stays NaN
        if config.joint_fit:
            # Zero-budget families are left out of the joint variable; the
            # shared cost is reported in every participating slot.
            jfams = tuple(f for f, it in zip(config.families, config.psf_max_iter) if it > 0)
            params, jf = fit_joint(params, x, w_fit, jfams)
            for j, it in enumerate(config.psf_max_iter):
                if it > 0:
                    fit_f[i][..., j] = jf
            continue
        fit_f[i] = 0.0
        for j, flag in enumerate(config.families):
            if config.psf_max_iter[j] <= 0:  # BlindDeconvJob.java:126
                continue
            phase_active = config.phase_schedule[i] if (config.phase_schedule and flag == PHASE) else None
            params, fit_f[i][..., j] = fit_one(params, x, w_fit, j, phase_active)
    return x, params, deconv_f, fit_f, deconv_iters


def blind_start(data, model, params0, config: "BlindDeconvConfig") -> torch.Tensor:
    """The round-1 object of one volume: the data or its Wiener estimate
    under ``params0``, clamped at 0 and centred on ``deconv.var_shape``."""
    var_shape = tuple(config.deconv.var_shape) if config.deconv.var_shape is not None else tuple(data.shape)
    x0 = wiener(data, model.compute_psf(params0)) if config.init == "wiener" else data
    return torch.clamp_min(pad_to_shape(x0, var_shape), 0.0)


def blind_fits(model, data, config: "BlindDeconvConfig", params0, aux_terms=(), cost_of=None, phase_anchor=None):
    """``(fit_one, fit_joint)`` of :func:`run_blind_loop` (``jobs/blind.py:347-434``):
    every family fit with ``grtol = 0`` (``BlindDeconvJob.java:124``), the
    calibration prior anchored at ``phase_anchor`` (by default ``params0``'s
    phase), and the auxiliary bead terms.
    ``cost_of(x, w) -> cost(params)`` is the data term a round's fits
    minimize; by default the object-as-kernel term of one volume ``data``
    (``fit_psf``'s), on ``fit.fit_window``'s crop where one is set."""
    fit_cfg = dataclasses.replace(config.fit, grtol=0.0)
    # The calibration prior's anchor is the original params0, not the
    # drifting estimate of each round (jobs/blind.py:347-354).
    if config.phase_prior_weight <= 0:
        phase_anchor = None
    elif phase_anchor is None:
        phase_anchor = params0.phase.detach()
    else:
        phase_anchor = torch.as_tensor(phase_anchor, dtype=params0.phase.dtype, device=params0.phase.device)
    if cost_of is None:
        fit_view, fit_model = _fit_window_view(model, data, config.fit.fit_window)

        def cost_of(x, w):
            fdata, fobj, fw = fit_view(x, w)
            if fw is not None and fw.shape != fdata.shape:
                fw = pad_to_shape(fw, tuple(fdata.shape))
            data_cost = _fit_data_term(fobj, fdata, fw)
            return lambda p: data_cost.cost(fit_model.compute_psf(p))

    def fit_one(params, x, w_fit, j, phase_active):
        flag = config.families[j]
        fres = _fit_single(
            cost_of(x, w_fit), params, family_name(flag),
            dataclasses.replace(fit_cfg, max_iter=config.psf_max_iter[j]),
            active=phase_active,
            freeze_head=config.phase_freeze_head if flag == PHASE else 0,
            # DEPTH and SHEET mix physical scales; unpreconditioned they stall.
            precondition=flag in (DEPTH, SHEET),
            anchor=phase_anchor if flag == PHASE else None,
            prior_weight=config.phase_prior_weight if flag == PHASE else 0.0,
            aux_terms=aux_terms,
        )
        return fres.params, fres.f

    def fit_joint(params, x, w_fit, jfams):
        fres = _fit_joint(cost_of(x, w_fit), params, tuple(family_name(f) for f in jfams),
                          dataclasses.replace(fit_cfg, max_iter=max(config.psf_max_iter)),
                          config.phase_freeze_head, phase_anchor, config.phase_prior_weight, aux_terms)
        return fres.params, fres.f

    return fit_one, fit_joint


def blind_deconvolve(
    data: torch.Tensor,
    model,
    params0=None,
    x0: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
    weight_updater: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
    config: BlindDeconvConfig = BlindDeconvConfig(),
    bead_data: torch.Tensor | None = None,
    phase_anchor: torch.Tensor | None = None,
) -> BlindDeconvResult:
    """Run the alternating blind-deconvolution loop (``jobs/blind.py:269-434``).

    ``model`` is a PSF model (``WideFieldModel`` or another family);
    ``weight_updater`` maps (model prediction, data) -> weights for the PSF
    step of each round. ``bead_data``: a bead stack measured on the same
    optics (laterally square, e.g. ``psf_fit.average_beads``'s patch), which
    joins every PSF fit as a data term at its own grid, weighted by
    ``config.bead_weight``. ``phase_anchor``: the calibration prior's anchor
    (``jobs/blind.py:346-353``), by default ``params0.phase`` when
    ``config.phase_prior_weight > 0``; a caller that runs one round at a time
    passes the original calibration's phase, since its per-round ``params0``
    is the drifting estimate.
    """
    if params0 is None:
        params0 = model.init_params()
    # The object lives on deconv.var_shape (the padded variable grid), the
    # PSF fits on the data window (jobs/blind.py:294-345).
    var_shape = tuple(config.deconv.var_shape) if config.deconv.var_shape is not None else tuple(data.shape)
    if x0 is None:
        x0 = blind_start(data, model, params0, config)

    def object_step(x, params, mu):
        with torch.no_grad():
            psf = model.compute_psf(params)
        dcfg = config.deconv if mu is None else dataclasses.replace(config.deconv, mu=mu)
        # The object step always sees the user's weights: the reference
        # disables the pre-deconv weight update (BlindDeconvJob.java:105-107).
        if config.deconv_engine == "admm":
            # over_relax=1.0 inside the alternation: the relaxed engine's
            # faster per-round convergence re-feeds the object-absorbs-
            # aberration mode that the annealed mu_schedule suppresses
            # (jobs/blind.py:318-323). Standalone solves keep the 1.8 default.
            dres = admm_deconvolve(data, psf, weights=weights, x0=x, config=dcfg, over_relax=1.0,
                                   track_objective=False)
        else:
            dres = deconvolve(data, psf, weights=weights, x0=x, config=dcfg)
        return dres.x, dres.f, dres.iterations, psf

    def fit_weights(x, psf):
        if weight_updater is None:
            return weights
        # Model prediction H*x from the updated object; the weights feed only
        # this round's PSF step (BlindDeconvJob.java:109-111).
        full_cost = WeightedConvolutionCost.build(pad_fft_kernel(psf, var_shape), data, None, var_shape)
        return weight_updater(full_cost.model(x), data)

    fit_one, fit_joint = blind_fits(model, data, config, params0, _bead_terms(model, bead_data, config),
                                    phase_anchor=phase_anchor)

    f_dtype = np.float64 if data.dtype == torch.float64 else np.float32
    x, params, deconv_f, fit_f, deconv_iters = run_blind_loop(
        config, f_dtype, x0, params0, object_step, fit_weights, fit_one, fit_joint
    )
    with torch.no_grad():
        psf = model.compute_psf(params)
    return BlindDeconvResult(x, params, psf, deconv_f, fit_f, deconv_iters)


def _bead_terms(model, bead_data, config: BlindDeconvConfig) -> tuple:
    """The fits' auxiliary terms: none, or the bead stack's
    ``psf_fit.bead_anchor_term`` on ``model``'s optics at the stack's grid,
    weighted by ``config.bead_weight`` (``jobs/blind.py:356-371``)."""
    if bead_data is None:
        return ()
    if bead_data.shape[-1] != bead_data.shape[-2]:
        raise ValueError(f"bead stack must be laterally square for the pupil model, got {tuple(bead_data.shape)}; "
                         "crop it or run psf_fit.average_beads (its default patch is square)")
    term = bead_anchor_term(model_at(model, bead_data.shape), bead_data, subvoxel=config.bead_subvoxel)
    return ((term, config.bead_weight),)


def _fit_window_view(model, data, fit_window):
    """``(view, fit_model)`` of the windowed fit (``jobs/blind.py:373-424``):
    ``view(x, w) -> (data, object, weights)`` at the fit grid, the object
    cropped to the data window first; with a window all three are centred
    crops and ``fit_model`` is the model at the window's shape."""
    shape = tuple(data.shape)

    def at_data(x):
        return crop_to_shape(x, shape) if tuple(x.shape) != shape else x

    if fit_window is None:
        return (lambda x, w: (data, at_data(x), w)), model
    win = tuple(int(v) for v in fit_window)
    if any(w > s for w, s in zip(win, shape)):
        raise ValueError(f"fit_window {win} exceeds the data shape {shape}")
    if win[1] != win[2]:
        raise ValueError(f"fit_window lateral dims must be square (pupil model), got {win}")

    def view(x, w):
        return (crop_to_shape(data, win), crop_to_shape(at_data(x), win),
                None if w is None else crop_to_shape(w, win))

    return view, model_at(model, win)
