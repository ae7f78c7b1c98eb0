"""Mesh-sharded PSF-parameter fits, including multi-frame joint fits.

Port of ``microtipi_tpu/parallel/psf_fit.py``. The data term is the object
step's distributed convolution with the roles swapped: the object's spectrum
is taken once per fit, and each evaluation synthesizes the PSF from the
parameters, splits it into z-slabs and convolves. For batched stacks every
frame shares one optical system, so the fit minimizes the sum of the frames'
costs over one parameter vector: the parameters are tiny and live on the
model's device, only the volumes are sharded.

The PSF synthesis is embarrassingly z-parallel: each plane's pupil fields
and 2D FFTs are independent of the others'. Each cell of the mesh
synthesizes its own z-slab of the PSF on its own device (:func:`psf_slabs`),
from a copy of the model's plane inputs (its pupils' Zernike syntheses and
the small vectors of its families, computed once on the model's device and
given to the cells by ``mesh.replicate``). A family's PSF of unit sum is its
planes over one total: each cell's planes' sum, added over the cells in
their order in float64 (``Mesh.add``), so every cell divides by the same
number; the reductions its planes wait on (ISM's joint normalisation,
STED's confocal sum and depletion peak) are taken over the cells alike. No
PSF slab then moves between cells: the gradient that crosses them is the
pupils', a few (Ny, Nx) maps a cell (kind "pupil" in ``collectives.sent``),
and each reduction's a value a cell (kind "values"). The sharded loops'
object steps take their PSFs the same way, under ``no_grad``
(``parallel/blind.py``, ``parallel/depthvar.py``), so no rank holds a whole
PSF or its whole complex field there.

The padded grid of a sharded loop whose Nz or Ny does not divide the mesh
(the JAX module shards the zero-padded kernel there): each cell's planes of
the PSF zero-padded in FFT layout are either planes of the model's grid,
each zero-padded in (y, x), or zero planes, so a cell can synthesize the
model planes that land in its slab and place them (:func:`psf_slabs` with
``grid``), within a rounding of ``pad_fft_kernel`` of the whole PSF cut; the
zero planes take no part in a reduction. The object steps take that route.
The fits on a padded grid synthesize the PSF whole, zero-pad it and cut it
(``mesh.shard``; over processes its gradient is every cell's slab gradient,
kind "cells"): the pupil gradient added cell by cell rounds otherwise over
processes on a mesh of several rows (each row's cells add their own parts)
than on one process (row 1 reads row 0's slabs), and a float64 blind loop of
a padded noise stack on (2, 2) carried that to 3.4e-11 relative in its
phase, where the whole route stays within 1e-12 of the one-process mesh.
The fit scaffolding (graduated ``active`` modes, ``freeze_head``,
preconditioning, the calibration prior, auxiliary bead terms, the joint
variable) is ``jobs.psf_fit``'s, over this cost.
"""

from __future__ import annotations

import torch

from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig, PsfFitResult, _fit_joint, _fit_single
from microtipi_tpu_torch.models.microscope import family_name
from microtipi_tpu_torch.models.widefield import UnitSumModel, run_steps
from microtipi_tpu_torch.parallel.fft import sharded_convolve, sharded_spectrum
from microtipi_tpu_torch.parallel.mesh import Z_AXIS, Mesh, ShardedVolume, replicate, shard
from microtipi_tpu_torch.utils.arrays import pad_fft_kernel

__all__ = ["psf_slabs", "sharded_fit_psf", "sharded_fit_psf_joint", "synthesizes_planes"]


def synthesizes_planes(model, grid) -> bool:
    """Whether a sharded fit on ``grid`` synthesizes ``model``'s PSF cell by
    cell (:func:`psf_slabs`): on the model's own grid. On a padded grid the
    fits synthesize the PSF whole (the module docstring says why)."""
    return tuple(model.shape) == tuple(grid)


def _fft_planes(n: int, size: int) -> torch.Tensor:
    """For each plane of an FFT-layout axis of ``size``, the plane of one of
    ``n`` that ``pad_fft_kernel`` puts there, or -1 (a zero plane)."""
    return pad_fft_kernel(torch.arange(1, n + 1, dtype=torch.float64), (size,)).long() - 1


def _placed(planes: torch.Tensor, src: torch.Tensor, grid) -> torch.Tensor:
    """The planes of the PSF zero-padded in FFT layout to ``grid`` whose
    model planes are ``src`` (:func:`_fft_planes`; -1 a zero plane), from
    ``planes``, the model planes of ``src`` that are not -1 in order: each
    zero-padded in (y, x) and put in place."""
    held = src >= 0
    planes = pad_fft_kernel(planes, tuple(grid[1:]))
    at = torch.where(held, torch.cumsum(held, 0) - 1, planes.shape[-3]).to(planes.device)
    return torch.cat([planes, torch.zeros_like(planes[..., :1, :, :])], -3).index_select(-3, at)


def _cell_total(mesh: Mesh, op: str, parts: dict, counted, cells) -> dict:
    """The reduction ``op`` ("sum" or "max") of every cell's tensor over
    ``counted``, ``parts`` holding this rank's of ``cells``, as a copy on
    each of this rank's cells (``mesh.replicate``): the same number on every
    cell and rank, differentiable, its gradient every cell's copy's, added
    in the order of ``cells`` (kind "values"). A sum takes each cell's sum
    in float64, adds them in the order of ``counted`` (``Mesh.add``) and
    rounds once to the parts' dtype. A maximum is exact, and its gradient
    goes in equal shares to every element that reaches it, over all the
    cells, as ``torch.amax``'s over one tensor does. A part of a cell not
    counted takes no part and gets a zero gradient."""
    dtype = next(iter(parts.values())).dtype
    if op == "sum":
        total = mesh.add({c: p.sum(dtype=torch.float64) for c, p in parts.items()}, counted, torch.float64).to(dtype)
    else:
        peak = mesh.max({c: p.detach().amax() for c, p in parts.items()}, counted, dtype)
        hits = {c: (p.detach() == peak.to(p.device)).to(dtype) for c, p in parts.items()}
        count = mesh.add({c: h.sum() for c, h in hits.items()}, counted, dtype)
        held = mesh.add({c: (p * hits[c]).sum() for c, p in parts.items()}, counted, dtype)
        total = peak + (held - held.detach()) / count
    return {c: t for c, (t,) in replicate((total,), mesh, cells, "values").items()}


def psf_slabs(model, params, mesh: Mesh, field_of=None, grid=None) -> list[ShardedVolume]:
    """The PSF of ``params`` as unbatched z-sharded volumes, each cell's slab
    synthesized on its own device (``model.plane_steps``) from its copy of
    ``model.plane_inputs(params)``: one volume, or K where ``field_of``, a
    function of a cell's copy, gives keywords of ``model.planes_field`` that
    make K PSFs (Gibson-Lanni ``depths``). A reduction that the planes wait
    on, and a unit-sum model's sum, is taken over row 0's cells
    (:func:`_cell_total`). ``grid``: a grid larger than the model's, on
    which the PSF is zero-padded in FFT layout (default the model's).
    Differentiable; every rank of a mesh over processes must reach the
    backward."""
    grid = tuple(model.shape) if grid is None else tuple(grid)
    nz, z_size = grid[0], mesh.shape[Z_AXIS]
    if nz % z_size:
        raise ValueError(f"the PSF's {nz} planes do not divide over {z_size} mesh entries")
    step, cells = nz // z_size, mesh.volume_cells(False)
    src = None if grid == tuple(model.shape) else _fft_planes(model.shape[0], nz)
    slab = [slice(z * step, (z + 1) * step) for z in range(z_size)]
    # The cells whose planes a reduction counts: row 0's (the other rows hold replicas), with model planes.
    counted = [(0, z) for z in range(z_size) if src is None or bool((src[slab[z]] >= 0).any())]
    steps = {}
    for (b, z), inputs in replicate(model.plane_inputs(params), mesh, cells).items():
        kw = {} if field_of is None else field_of(inputs)
        if src is None:
            planes = slab[z]
        else:  # a slab of zero planes synthesizes plane 0 for its shape only, counted in no reduction
            planes = src[slab[z]][src[slab[z]] >= 0] if (0, z) in counted else src.new_zeros(1)
        steps[(b, z)] = model.plane_steps(inputs, planes, **kw)
    tiles = run_steps(steps, lambda op, parts: _cell_total(mesh, op, parts, counted, cells))
    if isinstance(model, UnitSumModel):
        total = _cell_total(mesh, "sum", tiles, counted, cells)
        tiles = {c: t / total[c] for c, t in tiles.items()}
    if src is not None:
        tiles = {(b, z): _placed(t, src[slab[z]], grid) for (b, z), t in tiles.items()}
    lead = next(iter(tiles.values())).shape[:-3]
    if not lead:
        return [ShardedVolume(mesh, grid, tiles, False)]
    return [ShardedVolume(mesh, grid, {c: t[k] for c, t in tiles.items()}, False) for k in range(lead[0])]


def sharded_fit_cost(model, data, obj, weights, mesh: Mesh):
    """``cost(params) = 0.5 * sum w * (obj (*) psf(params) - data)^2`` on the
    mesh (``psf_fit.py:41-67``). ``data`` and ``obj`` share one (possibly
    padded) grid, tensors or sharded volumes. On the model's grid each cell
    synthesizes its slab (:func:`psf_slabs`); on a larger one the PSF is
    synthesized whole, zero-padded in FFT layout to it, and cut."""
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
