"""Tiled (overlap-discard) deconvolution of volumes larger than one solve.

Port of ``microtipi_tpu/jobs/tiled.py``: overlapping tiles of one static
shape are solved independently and only each tile's core is kept; the halo
absorbs the circular-FFT wraparound and the regularizer's boundary effect.
The volume stays a NumPy array on the host and never goes to the card whole:
tiles stream through :func:`microtipi_tpu_torch.jobs.batch.batched_deconvolve`
in batches of ``max_batch``, each batch one lockstep solve with one batched
TV launch per step. The JAX package padded the last, smaller batch to keep
one compiled program; PyTorch runs eagerly, so the ragged tail is solved as
it is.

``method="vmlmb"``, ``method="admm"`` (the same objective through the ADMM
engine, ``config.max_iter`` fixed iterations a tile) and ``method="rl"``
(Richardson-Lucy, ``rl_iterations`` a tile, RL-TV when ``config.mu > 0``,
through the batched RL engine of ``jobs/richardson_lucy.py``: one batched TV
launch an iteration) are ported, and so is the depth-varying path
(``depthvar_anchors``, with :func:`field_depthvar_psf` for a PSF that varies
laterally and with depth): each batch of tiles one lockstep
``batched_deconvolve_depthvar``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from microtipi_tpu_torch.jobs.batch import batched_deconvolve, batched_deconvolve_depthvar
from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
from microtipi_tpu_torch.jobs.richardson_lucy import richardson_lucy
from microtipi_tpu_torch.utils.arrays import crop_to_shape, pad_fft_kernel, roll, unroll

__all__ = ["field_depthvar_psf", "field_psf", "tile_plan", "tiled_deconvolve"]

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def tile_plan(shape: tuple[int, ...], tile: tuple[int, ...], overlap: tuple[int, ...]):
    """Per-axis tile start positions and core (kept) intervals
    (``jobs/tiled.py:32-60``).

    Tiles are placed at stride ``tile - 2*overlap`` with the last tile
    flush against the edge (same shape everywhere); each tile's core is its
    center minus the halo, extended to the volume edge on boundary tiles.
    Cores cover the volume; where flush-shifting makes neighboring cores
    overlap, the later tile wins (both are interior there).

    Returns ``[(starts, cores)] per axis`` with ``cores`` as (lo, hi) in
    volume coordinates.
    """
    plan = []
    for n, t, o in zip(shape, tile, overlap):
        if t > n:
            raise ValueError(f"tile {t} exceeds volume extent {n}")
        if t <= 2 * o and t != n:
            raise ValueError(f"tile {t} must exceed twice the overlap {o}")
        stride = t - 2 * o
        starts = list(range(0, max(n - t, 0) + 1, stride))
        if starts[-1] + t < n:
            starts.append(n - t)
        cores = []
        for i, s in enumerate(starts):
            lo = 0 if i == 0 else s + o
            hi = n if i == len(starts) - 1 else s + t - o
            cores.append((lo, hi))
        plan.append((starts, cores))
    return plan


def field_psf(model, anchors, power: float = 2.0):
    """Laterally field-varying PSF from scattered calibrations: a
    ``psf_fn(center)`` for :func:`tiled_deconvolve` (``jobs/tiled.py:63-93``).

    ``anchors``: ``[((y, x), params), ...]``, PSF parameters calibrated at
    known field positions (voxels). Parameters are interpolated at each tile
    center by inverse-distance weighting (power ``power``; exact at the
    anchors) and synthesized by ``model.compute_psf`` on ``model.device``.
    ``model`` must carry the TILE shape.
    """
    anchors = list(anchors)
    if not anchors:
        raise ValueError("field_psf needs at least one (position, params) anchor")

    def psf_fn(center):
        with torch.no_grad():
            return model.compute_psf(_idw_params(anchors, center, power, model.dtype, model.device))

    return psf_fn


def _as_numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _idw_params(anchors, center, power, dtype, device):
    """Inverse-distance-weighted parameter mix at a field position, mixed
    on the host in float64 (``jobs/tiled.py:96-115``)."""
    positions = np.asarray([p for p, _ in anchors], np.float64).reshape(len(anchors), 2)
    cy, cx = float(center[-2]), float(center[-1])
    d2 = np.sum((positions - np.asarray([cy, cx])) ** 2, axis=1)
    i_near = int(np.argmin(d2))
    if d2[i_near] < 1e-12:
        w = np.zeros(len(anchors))
        w[i_near] = 1.0
    else:
        w = 1.0 / d2 ** (power / 2.0)
        w = w / w.sum()
    p0 = anchors[0][1]
    return p0._replace(**{
        name: torch.as_tensor(sum(
            wi * _as_numpy(getattr(p, name)).astype(np.float64)
            for wi, (_, p) in zip(w, anchors)), dtype=dtype, device=device)
        for name in p0._fields
    })


def field_depthvar_psf(model, anchors, zs, power: float = 2.0):
    """Lateral x axial space-variant PSF field: a ``psf_fn(center)`` for
    ``tiled_deconvolve(..., depthvar_anchors=zs)`` (``jobs/tiled.py:118-161``).

    Laterally the parameters are inverse-distance weighted at each tile's
    centre, as in :func:`field_psf`; axially each tile gets a (K, tz, ty, tx)
    anchor stack synthesized at the tile's absolute depths, so z-tiled solves
    see the deep planes' aberration. ``model``: a ``GibsonLanniModel`` at the
    TILE shape. ``anchors``: ``[((y, x), params), ...]``, each params with a
    DEPTH family. ``zs``: the K anchor z indices in tile coordinates, the
    same array as ``tiled_deconvolve``'s ``depthvar_anchors``. The anchor
    depth of a tile starting at volume plane ``Z0`` is ``params.depth[1] +
    (Z0 + zs[j]) * dz``; the K PSFs come from one batched synthesis.
    """
    anchors = list(anchors)
    if not anchors:
        raise ValueError("field_depthvar_psf needs at least one (position, params) anchor")
    if not hasattr(anchors[0][1], "depth"):
        raise ValueError("field_depthvar_psf needs params with a DEPTH family (models/gibson_lanni.py)")
    zs = np.asarray(zs, np.float64)
    nz_tile, dz = model.shape[0], model.config.dz

    def psf_fn(center):
        mixed = _idw_params(anchors, center, power, model.dtype, model.device)
        z0 = float(center[0]) - nz_tile / 2.0  # the tile's first plane, volume coordinates
        depths = float(_as_numpy(mixed.depth)[1]) + (z0 + zs) * dz
        with torch.no_grad():
            return model.compute_depth_psfs(mixed, torch.as_tensor(depths, dtype=model.dtype, device=model.device))

    return psf_fn


def _tile_boxes(plan) -> list:
    """Every tile as (start per axis, core per axis), the last axis fastest."""
    boxes = [((), ())]
    for starts, cores in plan:
        boxes = [(s0 + (s,), c0 + (c,)) for s0, c0 in boxes for s, c in zip(starts, cores)]
    return boxes


def tiled_deconvolve(
    data,
    psf,
    weights=None,
    tile: tuple[int, int, int] | None = None,
    overlap: tuple[int, int, int] | int = 16,
    config: DeconvolutionConfig = DeconvolutionConfig(),
    method: str = "vmlmb",
    rl_iterations: int = 50,
    max_batch: int = 8,
    depthvar_anchors=None,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Deconvolve a volume tile by tile; returns the blended NumPy volume
    (``jobs/tiled.py:164-334``).

    ``data`` is a NumPy array (or anything ``np.asarray`` takes); tiles
    stream to ``device`` in batches of ``max_batch`` and back. ``psf`` is
    corner-origin; it is embedded at the tile shape, so its support should
    fit one tile and ``overlap`` should be at least its half-width per axis.
    ``psf`` may instead be a callable ``psf_fn(center) -> corner-origin
    PSF`` receiving each tile's center in volume voxel coordinates (build
    one with :func:`field_psf`): the tiles of a batch then solve with one
    kernel per lane. ``method`` is "vmlmb" (TV + positivity by VMLMB), "admm"
    (the same objective through the ADMM engine, a fixed ``config.max_iter``
    per tile) or "rl" (Richardson-Lucy, ``rl_iterations`` per tile;
    ``config.mu``/``epsilon`` feed its TV variant; ``weights`` are not
    used). ``config.var_shape`` is ignored (padding is what the halo is for).

    ``depthvar_anchors``: K anchor z indices in TILE coordinates; each tile
    then solves under the depth-varying operator of ``jobs/depthvar.py``
    (vmlmb only, through ``batched_deconvolve_depthvar``), and ``psf`` is a
    (K, ...) anchor stack or a callable returning one for each tile (build a
    fully space-variant field with :func:`field_depthvar_psf`).
    """
    if method not in ("vmlmb", "admm", "rl"):
        raise ValueError(f"unknown method {method!r}")
    if depthvar_anchors is not None:
        depthvar_anchors = np.asarray(depthvar_anchors, np.float64)
        if method != "vmlmb":
            raise ValueError(f"depthvar_anchors rides the vmlmb path; method {method!r} does not take it")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("tiled_deconvolve runs on the CUDA card by default and none is available; "
                           "pass device='cpu' to run it on the CPU")
    data = np.asarray(data)
    dtype = _TORCH_DTYPES[data.dtype]
    if tile is None:
        tile = tuple(min(n, 256) for n in data.shape)
    tile = tuple(min(t, n) for t, n in zip(tile, data.shape))
    if isinstance(overlap, int):
        overlap = (overlap,) * data.ndim
    overlap = tuple(0 if t == n else o for o, t, n in zip(overlap, tile, data.shape))
    boxes = _tile_boxes(tile_plan(data.shape, tile, overlap))

    def prep_kernel(k):
        k = torch.as_tensor(k, dtype=dtype, device=device)
        if any(p > t for p, t in zip(k.shape, tile)):
            # A PSF stored at the (larger) volume grid: keep its centered
            # core at the tile size, lossless when the support fits the tile.
            k = unroll(crop_to_shape(roll(k), tuple(min(p, t) for p, t in zip(k.shape, tile))))
        return pad_fft_kernel(k, tile)

    if depthvar_anchors is not None:  # (K, ...) anchor stacks
        prep_one = prep_kernel

        def prep_kernel(k):
            return torch.stack([prep_one(h) for h in k])

    varying = callable(psf)
    if not varying and depthvar_anchors is not None and np.ndim(psf) != 4:
        raise ValueError(f"depthvar_anchors needs a (K, ...) anchor stack, got ndim={np.ndim(psf)}")
    kern = None if varying else prep_kernel(psf)
    cfg = dataclasses.replace(config, var_shape=None)
    if weights is not None and method != "rl":  # RL models no per-voxel weights
        weights = np.asarray(weights)
    else:
        weights = None
    out = np.empty(data.shape, data.dtype)
    for i in range(0, len(boxes), max_batch):
        chunk = boxes[i : i + max_batch]
        sl = [tuple(slice(s, s + t) for s, t in zip(starts, tile)) for starts, _ in chunk]
        batch = torch.as_tensor(np.stack([data[s] for s in sl])).to(device)
        wbatch = None
        if weights is not None:
            wbatch = torch.as_tensor(np.stack([weights[s] for s in sl]), dtype=dtype).to(device)
        if varying:
            kern = torch.stack([
                prep_kernel(psf(tuple(s + t / 2.0 for s, t in zip(starts, tile))))
                for starts, _ in chunk
            ])
        if depthvar_anchors is not None:
            xs = batched_deconvolve_depthvar(batch, kern, depthvar_anchors, weights=wbatch, config=cfg).x
        elif method == "rl":
            xs = richardson_lucy(batch, kern, iterations=rl_iterations, mu=config.mu, epsilon=config.epsilon)
        else:
            xs = batched_deconvolve(batch, kern, weights=wbatch, config=cfg, engine=method).x
        xs = xs.cpu().numpy()
        for (starts, cores), x in zip(chunk, xs):
            dst = tuple(slice(lo, hi) for lo, hi in cores)
            src = tuple(slice(lo - s, hi - s) for (lo, hi), s in zip(cores, starts))
            out[dst] = x[src]
    return out
