"""Mesh-sharded PSF-parameter fits, including multi-frame joint fits.

Port of ``microtipi_tpu/parallel/psf_fit.py``. The data term is the object
step's distributed convolution with the roles swapped: the object's spectrum
is taken once per fit, and each evaluation synthesizes the PSF from the
parameters, splits it into z-slabs and convolves. For batched stacks every
frame shares one optical system, so the fit minimizes the sum of the frames'
costs over one parameter vector: the parameters are tiny and live on the
model's device, only the volumes are sharded.

The PSF is synthesized whole on the model's device and then split into slabs
(autograd runs through the copies). The JAX module synthesizes it z-sharded,
each plane's pupil field and 2D FFT on its own device; that is a later
optimization (``ROADMAP.md``). The fit scaffolding (graduated ``active``
modes, ``freeze_head``, preconditioning, the calibration prior, auxiliary
bead terms, the joint variable) is ``jobs.psf_fit``'s, over this cost.
"""

from __future__ import annotations

import torch

from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig, PsfFitResult, _fit_joint, _fit_single
from microtipi_tpu_torch.models.microscope import family_name
from microtipi_tpu_torch.parallel.fft import sharded_convolve, sharded_spectrum
from microtipi_tpu_torch.parallel.mesh import Mesh, shard
from microtipi_tpu_torch.utils.arrays import pad_fft_kernel

__all__ = ["sharded_fit_psf", "sharded_fit_psf_joint"]


def sharded_fit_cost(model, data, obj, weights, mesh: Mesh):
    """``cost(params) = 0.5 * sum w * (obj (*) psf(params) - data)^2`` on the
    mesh (``psf_fit.py:41-67``). ``data`` and ``obj`` share one (possibly
    padded) grid, tensors or sharded volumes; the PSF is zero-padded in FFT
    layout to the grid when the model's grid is smaller."""
    vol_shape = tuple(data.shape[-3:])
    batched = data.ndim == 4
    data = shard(data, mesh, batched)
    if weights is not None:
        # Zero weight excludes the voxel whatever its value (0 * NaN = NaN).
        weights = shard(weights, mesh, weights.ndim == 4)
        data = data.map(lambda d, w: torch.where(w > 0, d, torch.zeros_like(d)), weights)
    obj_hat = sharded_spectrum(shard(obj, mesh, obj.ndim == 4), mesh)

    def cost(p):
        psf = model.compute_psf(p)
        if tuple(psf.shape) != vol_shape:
            psf = pad_fft_kernel(psf, vol_shape)
        r = sharded_convolve(shard(psf, mesh, batched=False), obj_hat, vol_shape, mesh) - data
        return 0.5 * (r * r if weights is None else weights * r * r).sum()

    return cost


def sharded_fit_psf(
    model,
    params,
    flag: int,
    data,
    obj,
    mesh: Mesh,
    weights=None,
    config: PsfFitConfig = PsfFitConfig(),
    active: int | None = None,
    freeze_head: int = 0,
    precondition: bool = False,
    anchor: torch.Tensor | None = None,
    prior_weight: float = 0.0,
    aux_terms: tuple = (),
) -> PsfFitResult:
    """The sharded ``jobs.psf_fit.fit_psf`` (``psf_fit.py:70-160``):
    ``data``/``obj`` (Nz, Ny, Nx) or batched (B, Nz, Ny, Nx); a batch gives
    one jointly fitted parameter vector. ``active``, ``freeze_head``,
    ``precondition``, the prior and ``aux_terms`` as in the dense fit."""
    cost = sharded_fit_cost(model, data, obj, weights, mesh)
    return _fit_single(cost, params, family_name(flag), config, active, freeze_head, precondition, anchor,
                       prior_weight, aux_terms)


def sharded_fit_psf_joint(
    model,
    params,
    flags: tuple[int, ...],
    data,
    obj,
    mesh: Mesh,
    weights=None,
    config: PsfFitConfig = PsfFitConfig(),
    phase_freeze_head: int = 0,
    phase_anchor: torch.Tensor | None = None,
    phase_prior_weight: float = 0.0,
    aux_terms: tuple = (),
) -> PsfFitResult:
    """The sharded ``jobs.psf_fit.fit_psf_joint`` (``psf_fit.py:163-221``):
    several families in one VMLMB run over the gradient-balanced joint
    variable, with the pin-Z4 freeze and the calibration prior."""
    cost = sharded_fit_cost(model, data, obj, weights, mesh)
    return _fit_joint(cost, params, tuple(family_name(f) for f in flags), config, phase_freeze_head, phase_anchor,
                      phase_prior_weight, aux_terms)
