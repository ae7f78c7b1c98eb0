"""Mesh-sharded blind deconvolution: the alternating loop on a mesh.

Port of ``microtipi_tpu/parallel/blind.py``: the sharded object step
(``parallel/deconv.py`` by VMLMB, or ``parallel/admm.py``) alternates with
the sharded PSF fits (``parallel/psf_fit.py``), one optical system for every
frame. The loop itself is ``jobs.blind.run_blind_loop``, shared with the
dense path, so skip-refit on the last round, zero-budget skips, graduated
phase schedules, ``joint_fit``, ``phase_freeze_head``, the mu schedule, the
Wiener start, the calibration prior and the bead anchor behave the same.

Any stack size: where Nz or Ny is not a multiple of the mesh's z axis (the
distributed FFT needs both), the loop runs on the rounded-up grid with zero
weight in the padding, the dense crop operator's semantics; the returned
object lives on that grid (``crop_trailing`` recovers the data window).

The object step's PSF, and the Wiener start's, is z-sharded on the loop's
grid, as the JAX module's GSPMD lays it out: each cell builds its own planes
(``parallel.psf_fit.psf_slabs``, zero-padded in FFT layout on a padded
grid; a unit-sum family's planes over the sum of every cell's), so no rank
holds the whole PSF or its complex field, and no PSF byte moves between
ranks; the solver and the weights' re-estimate take its spectrum in place.
The result's ``psf`` is the whole PSF (``BlindDeconvResult``'s),
synthesized once on every rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig, BlindDeconvResult, _bead_terms, blind_fits, run_blind_loop
from microtipi_tpu_torch.parallel.deconv import crop_trailing, pad_trailing, sharded_deconvolve, sharded_wiener
from microtipi_tpu_torch.parallel.fft import sharded_convolve, sharded_spectrum
from microtipi_tpu_torch.parallel.mesh import Z_AXIS, Mesh, constrain_volume, gather, shard
from microtipi_tpu_torch.parallel.psf_fit import psf_slabs, sharded_fit_cost

__all__ = ["sharded_blind_deconvolve"]


def _round_up(v: int, m: int) -> int:
    return v + (-v) % m


class _Grid:
    """The loop's grids: the object's ``var_shape`` (rounded up to the mesh's
    z axis), the fit data on it, the fits' base weights and the data window
    (``blind.py:76-119``)."""

    def __init__(self, data, weights, var0, mesh: Mesh):
        vol = tuple(data.shape[-3:])
        zp = mesh.shape[Z_AXIS]
        self.vol, self.mesh = vol, mesh
        self.batched = data.ndim == 4
        self.var_shape = (_round_up(var0[0], zp), _round_up(var0[1], zp), var0[2])
        self.padded = self.var_shape != vol
        self.data = constrain_volume(data, mesh, self.batched)
        if self.padded:
            dense = gather(data)
            w = torch.ones(vol, dtype=dense.dtype, device=dense.device) if weights is None else gather(weights)
            self.d_fit = shard(pad_trailing(dense, self.var_shape), mesh, self.batched)
            self.w_fit = shard(pad_trailing(w, self.var_shape), mesh, w.ndim == 4)
            self.window = shard(pad_trailing(torch.ones_like(w if w.ndim == 3 else w[0]), self.var_shape),
                                mesh, False)
        else:
            self.d_fit, self.w_fit, self.window = self.data, weights, None

    def mask(self, x):
        """The object as the fit's kernel: the dense loop crops it to the data
        window, the padded grid masks it."""
        return x * self.window if self.padded else x

    def start(self, psf0, init: str):
        """Round 1's object: the data or its Wiener estimate under ``psf0()``
        (the object step's PSF, sharded on the loop's grid), clamped at 0."""
        if init == "wiener":
            x0 = sharded_wiener(self.d_fit if self.padded else self.data, psf0(), self.mesh)
        else:
            x0 = shard(pad_trailing(gather(self.data), self.var_shape), self.mesh, self.batched)
        return x0.map(lambda t: torch.clamp_min(t, 0.0))

    def refit_weights(self, weight_updater, pred_full):
        """Weights for the PSF step from the model prediction on the var grid."""
        pred = gather(crop_trailing(pred_full, self.vol))
        w = weight_updater(pred, gather(self.data))
        return shard(pad_trailing(w, self.var_shape) if self.padded else w, self.mesh, w.ndim == 4)


def sharded_blind_deconvolve(
    data,
    model,
    mesh: Mesh,
    params0=None,
    weights=None,
    weight_updater=None,
    config: BlindDeconvConfig = BlindDeconvConfig(),
    bead_data: torch.Tensor | None = None,
) -> BlindDeconvResult:
    """The sharded ``jobs.blind.blind_deconvolve`` (``blind.py:46-196``).

    ``data``: (Nz, Ny, Nx) or batched (B, Nz, Ny, Nx), a tensor or a sharded
    volume; Nz and Ny need not divide the mesh's z axis (zero-weight
    padding). ``bead_data``: the bead stack of the calibration anchor, a
    small term evaluated whole on the model's device. The result's ``obj``
    is a sharded volume on the (padded) grid."""
    if params0 is None:
        params0 = model.init_params()
    batched = data.ndim == 4
    base_var = tuple(config.deconv.var_shape) if config.deconv.var_shape is not None else tuple(data.shape[-3:])
    grid = _Grid(data, weights, base_var, mesh)
    dcfg = dataclasses.replace(config.deconv, var_shape=grid.var_shape if grid.padded else None)
    if config.fit.fit_window is not None:
        raise ValueError("PsfFitConfig.fit_window is a single-chip optimization (the crop would gather across "
                         "shards); drop it for the sharded loop")
    if config.deconv_engine == "admm" and (batched or grid.padded):
        raise ValueError("the sharded admm object engine takes one mesh-divisible (Nz, Ny, Nx) volume "
                         "(parallel.admm); batched/auto-padded sharded loops run the VMLMB object step")

    def object_psf(params):
        """The object step's PSF: each cell's planes on the loop's grid."""
        with torch.no_grad():
            return psf_slabs(model, params, mesh, grid=grid.var_shape)[0]

    with torch.no_grad():
        x0 = grid.start(lambda: object_psf(params0), config.init)

    def object_step(x, params, mu):
        psf = object_psf(params)
        cfg_i = dcfg if mu is None else dataclasses.replace(dcfg, mu=mu)
        if config.deconv_engine == "admm":
            from microtipi_tpu_torch.parallel.admm import sharded_admm_deconvolve

            # over_relax=1.0 inside the alternation (jobs/blind.py rationale).
            res = sharded_admm_deconvolve(grid.data, psf, mesh, weights=weights, x0=x, config=cfg_i,
                                          over_relax=1.0, track_objective=False)
        else:
            res = sharded_deconvolve(grid.data, psf, mesh, weights=weights, x0=x, config=cfg_i)
        return res.x, res.f, res.iterations, psf

    def fit_weights(x, psf):
        if weight_updater is None:
            return grid.w_fit
        # Model prediction H x (deconvolver.getModel()); the re-estimated
        # weights feed only the PSF step (BlindDeconvJob.java:109-111).
        with torch.no_grad():
            k_hat = sharded_spectrum(psf, mesh)
            return grid.refit_weights(weight_updater, sharded_convolve(x, k_hat, grid.var_shape, mesh))

    def cost_of(x, w):
        return sharded_fit_cost(model, grid.d_fit, grid.mask(x.detach()), w, mesh)

    fit_one, fit_joint = blind_fits(model, data, config, params0, _bead_terms(model, bead_data, config),
                                    cost_of=cost_of)
    f_dtype = np.float64 if data.dtype == torch.float64 else np.float32
    x, params, deconv_f, fit_f, deconv_iters = run_blind_loop(config, f_dtype, x0, params0, object_step,
                                                              fit_weights, fit_one, fit_joint)
    with torch.no_grad():
        psf = model.compute_psf(params)
    return BlindDeconvResult(x, params, psf, deconv_f, fit_f, deconv_iters)
