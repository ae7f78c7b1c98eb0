"""Mesh-sharded PSF-parameter fits, including multi-frame joint fits.

Port of ``microtipi_tpu/parallel/psf_fit.py``. The data term is the object
step's distributed convolution with the roles swapped: the object's spectrum
is taken once per fit, and each evaluation synthesizes the PSF from the
parameters, splits it into z-slabs and convolves. For batched stacks every
frame shares one optical system, so the fit minimizes the sum of the frames'
costs over one parameter vector: the parameters are tiny and live on the
model's device, only the volumes are sharded.

The PSF synthesis is embarrassingly z-parallel: each plane's pupil field and
2D FFT are independent of the others'. Where the model's grid is the data's,
and the model synthesizes its PSF plane by plane (the wide-field and
Gibson-Lanni models: :func:`synthesizes_planes`), each cell of the mesh
synthesizes its own z-slab of the PSF on its own device (:func:`psf_slabs`),
from a copy of the model's plane inputs (the pupil's Zernike syntheses and
the defocus and depth vectors, computed once on the model's device and given
to the cells by ``mesh.replicate``). No PSF slab then moves between cells: the
gradient that crosses them is the pupil's, at most 3 * Ny * Nx values a cell
(kind "pupil" in ``collectives.sent``), where the whole PSF's slabs crossed.

The other routes synthesize the PSF whole on the model's device and cut it
into slabs (``mesh.shard``; over processes its gradient is every cell's slab
gradient, kind "cells"): the families that define their own
``compute_psf`` (a second pupil, a normalisation over the whole volume), and
a grid larger than the model's, the padded grid of a sharded blind loop
whose Nz or Ny does not divide the mesh, where the PSF is zero-padded in FFT
layout first (the JAX module, too, shards the padded kernel there). The fit
scaffolding (graduated ``active`` modes, ``freeze_head``, preconditioning,
the calibration prior, auxiliary bead terms, the joint variable) is
``jobs.psf_fit``'s, over this cost.
"""

from __future__ import annotations

import torch

from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig, PsfFitResult, _fit_joint, _fit_single
from microtipi_tpu_torch.models.microscope import family_name
from microtipi_tpu_torch.models.widefield import WideFieldModel
from microtipi_tpu_torch.parallel.fft import sharded_convolve, sharded_spectrum
from microtipi_tpu_torch.parallel.mesh import Z_AXIS, Mesh, ShardedVolume, replicate, shard
from microtipi_tpu_torch.utils.arrays import pad_fft_kernel

__all__ = ["psf_slabs", "sharded_fit_psf", "sharded_fit_psf_joint", "synthesizes_planes"]


def synthesizes_planes(model, grid) -> bool:
    """Whether a sharded fit on ``grid`` synthesizes ``model``'s PSF cell by
    cell (:func:`psf_slabs`): on the model's own grid, where its
    ``compute_psf`` is ``WideFieldModel``'s, the plane synthesis over every
    plane (the wide-field and Gibson-Lanni models; the class that defines
    ``compute_psf`` decides)."""
    return type(model).compute_psf is WideFieldModel.compute_psf and tuple(model.shape) == tuple(grid)


def psf_slabs(model, params, mesh: Mesh, field_of=None) -> list[ShardedVolume]:
    """The PSF of ``params`` as unbatched z-sharded volumes, each cell's slab
    synthesized on its own device (``model.psf_planes``) from its copy of
    ``model.plane_inputs(params)``: one volume, or K where ``field_of``, a
    function of a cell's copy, gives keywords of ``model.planes_field`` that
    make K PSFs (Gibson-Lanni ``depths``). Differentiable; every rank of a
    mesh over processes must reach the backward."""
    nz, z_size = model.shape[0], mesh.shape[Z_AXIS]
    if nz % z_size:
        raise ValueError(f"the PSF's {nz} planes do not divide over {z_size} mesh entries")
    step, cells = nz // z_size, mesh.volume_cells(False)
    tiles = {}
    for (b, z), inputs in replicate(model.plane_inputs(params), mesh, cells).items():
        kw = {} if field_of is None else field_of(inputs)
        tiles[(b, z)] = model.psf_planes(inputs, slice(z * step, (z + 1) * step), **kw)
    lead = next(iter(tiles.values())).shape[:-3]
    if not lead:
        return [ShardedVolume(mesh, model.shape, tiles, False)]
    return [ShardedVolume(mesh, model.shape, {c: t[k] for c, t in tiles.items()}, False) for k in range(lead[0])]


def sharded_fit_cost(model, data, obj, weights, mesh: Mesh):
    """``cost(params) = 0.5 * sum w * (obj (*) psf(params) - data)^2`` on the
    mesh (``psf_fit.py:41-67``). ``data`` and ``obj`` share one (possibly
    padded) grid, tensors or sharded volumes. Where the model
    :func:`synthesizes_planes` on that grid, each cell synthesizes its slab
    (:func:`psf_slabs`); otherwise the PSF is synthesized whole, zero-padded
    in FFT layout to the grid when the model's grid is smaller, and cut."""
    vol_shape = tuple(data.shape[-3:])
    batched = data.ndim == 4
    data = shard(data, mesh, batched)
    if weights is not None:
        # Zero weight excludes the voxel whatever its value (0 * NaN = NaN).
        weights = shard(weights, mesh, weights.ndim == 4)
        data = data.map(lambda d, w: torch.where(w > 0, d, torch.zeros_like(d)), weights)
    obj_hat = sharded_spectrum(shard(obj, mesh, obj.ndim == 4), mesh)
    planes = synthesizes_planes(model, vol_shape)

    def cost(p):
        if planes:
            psf = psf_slabs(model, p, mesh)[0]
        else:
            psf = shard(pad_fft_kernel(model.compute_psf(p), vol_shape), mesh, batched=False)
        r = sharded_convolve(psf, obj_hat, vol_shape, mesh) - data
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
