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

The batched blind loop raises ``NotImplementedError`` naming the ROADMAP.md
item that ports it.
"""

from __future__ import annotations

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
from microtipi_tpu_torch.jobs.depthvar import depthvar_cost, depthvar_objective, depthvar_start
from microtipi_tpu_torch.optim.vmlmb import minimize_vmlmb_batched
from microtipi_tpu_torch.utils.arrays import pad_to_shape

__all__ = ["batched_deconvolve", "batched_blind_deconvolve",
           "batched_deconvolve_auto_mu", "batched_deconvolve_depthvar"]


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


def batched_blind_deconvolve(*args, **kw):
    """Blind deconvolution over a batch (``jobs/batch.py:82-121``)."""
    raise NotImplementedError("batched_blind_deconvolve is not ported yet (ROADMAP.md queue 1, "
                              "item 17: the rest of the out-of-core and batched solvers)")


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
