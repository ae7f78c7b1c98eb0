"""Mesh-sharded object step: the objective, VMLMB on the mesh, and Wiener.

Port of ``microtipi_tpu/parallel/deconv.py``. The division of labour:

- the FFT convolution goes through the distributed transpose FFT
  (``parallel/fft.py``);
- the hyperbolic TV goes through the TV kernel's grouped slab launch: one
  launch over the z-slabs a device holds (up to the kernel's cap), which
  reads a neighbouring slab's boundary plane in place where that slab lies on
  the same device and takes a copy of it from another device
  (:func:`sharded_tv`, :func:`plan_slab_launches`; on a TPU mesh GSPMD
  inserts these halo exchanges around the Pallas kernel); the
  other priors, the temporal TV across the batch rows and the channel-coupled
  TV are plain PyTorch on each tile with the halo planes or frames they need,
  put together with ``collectives.assemble``, whose backward returns each
  piece's gradient to its tile;
- everything else is elementwise tile by tile, and every sum is each tile's
  sum added on the mesh's first device in a fixed order (``Mesh.add``).

The same code runs on a mesh driven by one process and on a mesh over
processes, where each rank evaluates its own tiles: there a slab's halo plane
from another rank's slab comes in one exchange before the TV launches
(:func:`_remote_halos`), the assembled pieces and the FFT's transposes cross
between the ranks, and every sum gathers the cells' parts and adds them alike
on every rank. An unbatched volume on several mesh rows is computed on each
row's replica, its sums count row 0's tiles, and the replicas of the
variable move with row 0's gradient (``ShardedVolume.as_row0``). Only
unmixing takes another path over processes (each row contracts the mixing
matrix with its own channels instead of row 0 with them all), so its results
there agree with one process's to rounding.

VMLMB (``optim/vmlmb.py``) runs unchanged on the sharded variable, a dict of
tiles keyed (batch, z) (``ShardedVolume.variable``). The same PSF is shared
across the batch unless ``psf`` is a (B,) + volume stack.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, DeconvolutionResult, has_regularizer
from microtipi_tpu_torch.ops.kernels.hyperbolic_tv import GROUP_SLABS, hyperbolic_tv_slab_group
from microtipi_tpu_torch.ops.regularization import _forward_diffs, hessian_terms, smoothed_l1_terms
from microtipi_tpu_torch.optim.treeutil import value_and_grad
from microtipi_tpu_torch.optim.vmlmb import minimize_vmlmb
from microtipi_tpu_torch.parallel.collectives import assemble, exchange
from microtipi_tpu_torch.parallel.fft import sharded_irfftn, sharded_rfftn, sharded_spectrum
from microtipi_tpu_torch.parallel.mesh import (
    BATCH_AXIS,
    Z_AXIS,
    Mesh,
    ShardedVolume,
    constrain_volume,
    gather,
    send,
    shard,
    shard_rows,
)
from microtipi_tpu_torch.utils.arrays import crop_to_shape, pad_fft_kernel, pad_to_shape

__all__ = [
    "crop_trailing",
    "make_sharded_objective",
    "sharded_objective",
    "pad_trailing",
    "plan_slab_launches",
    "sharded_deconvolve",
    "sharded_regularization",
    "sharded_tv",
    "sharded_wiener",
]


def pad_trailing(a, vol_shape, value: float = 0.0):
    """Centre-pad the trailing 3 (volume) axes of ``a`` to ``vol_shape``,
    leading batch axes alone (``deconv.py:56-68``). A sharded volume is
    gathered, padded and sharded again (whole if the new shape does not
    divide the mesh)."""
    if tuple(a.shape[-3:]) == tuple(vol_shape):
        return a
    if isinstance(a, ShardedVolume):
        return constrain_volume(pad_trailing(gather(a), vol_shape, value), a.mesh, a.batched)
    return pad_to_shape(a, tuple(vol_shape), value)


def crop_trailing(a, vol_shape):
    """Inverse of :func:`pad_trailing`: the centred crop of the trailing 3
    axes (``deconv.py:71-80``)."""
    if tuple(a.shape[-3:]) == tuple(vol_shape):
        return a
    if isinstance(a, ShardedVolume):
        return constrain_volume(crop_trailing(gather(a), vol_shape), a.mesh, a.batched)
    return crop_to_shape(a, tuple(vol_shape))


def _after_plan(x: ShardedVolume, k: int) -> list:
    """``collectives.assemble``'s plan that gives every cell up to ``k``
    planes of the slabs after it (none at the volume's end)."""
    nz = x.mesh.shape[Z_AXIS]
    nzs, plan = x.shape[-3] // nz, []
    for b, z in x.cells():
        need = k
        for j in range(z + 1, nz):
            if need == 0:
                break
            take = min(need, nzs)
            plan.append(((b, z), (b, j), 0, take))
            need -= take
    return plan


def _assembled(x: ShardedVolume, plan: list, dim: int) -> dict:
    """This rank's cells' tensors of ``plan`` over ``x``'s tiles."""
    local = x.local_cells()
    return assemble(x.mesh, local, [x.tiles[c] for c in local], plan, dim)


def _with_halo(x: ShardedVolume, plan: list, dim: int) -> dict:
    """Per cell of this rank, its tile with the pieces ``plan`` lists for it
    appended along ``dim``, and a tie to add to the cell's cost. The tile is
    used itself, so that autograd adds the gradients of its uses into it one
    by one; a tile without pieces is used as it is, and its tie (a zero: the
    sum of its empty pieces) keeps it in the exchange's backward, which every
    rank must reach. Any other tie is 0.0."""
    out = {}
    for c, h in _assembled(x, plan, dim).items():
        t = x.tiles[c]
        out[c] = (torch.cat([t, h], dim), 0.0) if h.shape[dim] else (t, h.sum())
    return out


def _column_plan(x: ShardedVolume) -> list:
    """The plan that gives each cell its z column's tiles, row by row, along
    the leading (frame) axis."""
    rows = x.shape[0] // x.mesh.shape[BATCH_AXIS]
    return [((b, z), (r, z), 0, rows) for b, z in x.cells() for r in range(x.mesh.shape[BATCH_AXIS])]


#: Halo planes that TV evaluations copied between devices since the last reset.
halo_sends = 0


class SlabLaunch(NamedTuple):
    """One grouped TV slab launch: its device, its cells (mesh order), and
    per cell its neighbouring cells in z before and after it (None at the
    volume's faces)."""

    device: torch.device
    cells: tuple
    prev: tuple
    next: tuple


def plan_slab_launches(mesh: Mesh, cells) -> list[SlabLaunch]:
    """The TV slab launches of one evaluation over ``cells`` (batch-major):
    the cells grouped by device in order of first appearance, at most
    ``GROUP_SLABS`` a launch, each with its neighbours in z. Where a halo
    plane is read from is decided once, from the tensors: :func:`_halo_plane`
    copies a plane from another device, and the kernel's wrapper reads any
    other plane in place (``hyperbolic_tv_slab_group``)."""
    nz, by_dev = mesh.shape[Z_AXIS], {}
    for c in cells:
        by_dev.setdefault(mesh.device(*c), []).append(c)

    def neighbour(b, z):
        return (b, z) if 0 <= z < nz else None

    launches = []
    for dev, group in by_dev.items():
        for i in range(0, len(group), GROUP_SLABS):
            part = tuple(group[i:i + GROUP_SLABS])
            launches.append(SlabLaunch(dev, part, tuple(neighbour(b, z - 1) for b, z in part),
                                       tuple(neighbour(b, z + 1) for b, z in part)))
    return launches


def _remote_halos(mesh: Mesh, by: dict, cells) -> dict:
    """The halo planes this rank's slabs read from other ranks' slabs, keyed
    (cell, plane): one exchange, its moves listed alike on every rank (each
    cell of ``cells`` with its z neighbours before and after). Empty on a
    mesh driven by one process."""
    like, nz, moves, keys = next(iter(by.values())), mesh.shape[Z_AXIS], [], []
    for b, z in cells:
        for nbr, at in (((b, z - 1), -1), ((b, z + 1), 0)):
            if 0 <= nbr[1] < nz and mesh.owner(*nbr) != mesh.owner(b, z):
                plane = by[nbr][:, at] if nbr in by else None
                moves.append((nbr, (b, z), plane, (like.shape[0], *like.shape[-2:]), like.dtype))
                keys.append((nbr, at))
    return {k: t for k, t in zip(keys, exchange(mesh, moves, "halo")) if t is not None}


def _halo_plane(mesh: Mesh, by: dict, cell, at: int, device: torch.device, remote: dict):
    """Plane ``at`` of the slab of ``cell`` (None: none) for a launch on
    ``device``: the plane received from another rank, a view of its tile
    where the cell lies on ``device``, else a copy of it sent there."""
    global halo_sends
    if cell is None:
        return None
    if (cell, at) in remote:
        return remote[(cell, at)]
    plane = by[cell][:, at]
    if mesh.device(*cell) == device:
        return plane
    halo_sends += 1
    return send(plane, device)


def _launch_inputs(mesh: Mesh, by: dict, launch: SlabLaunch, remote: dict | None = None):
    """(slabs, prevs, nexts) of one planned launch over the tiles ``by``
    (cell: (B, nz_s, Ny, Nx)), as :func:`hyperbolic_tv_slab_group` takes them;
    ``remote``: the planes of :func:`_remote_halos`."""
    remote = {} if remote is None else remote
    return ([by[c] for c in launch.cells],
            [_halo_plane(mesh, by, c, -1, launch.device, remote) for c in launch.prev],
            [_halo_plane(mesh, by, c, 0, launch.device, remote) for c in launch.next])


def _slab_tv(x: ShardedVolume, epsilon: float, scales):
    """(cost, gradients of this rank's tiles) of the hyperbolic TV of each
    volume of ``x``: the grouped slab launches of :func:`plan_slab_launches`
    over this rank's slabs, the slabs' costs added on the mesh's first device
    batch-major, then by z. A slab's gradient is the whole volume's at its
    planes."""
    cells = x.local_cells()
    by = {c: (x.tiles[c] if x.batched else x.tiles[c][None]).detach().contiguous() for c in cells}
    remote = _remote_halos(x.mesh, by, x.cells())
    costs, grads = {}, {}
    for launch in plan_slab_launches(x.mesh, cells):
        c, g = hyperbolic_tv_slab_group(*_launch_inputs(x.mesh, by, launch, remote), epsilon, scales)
        costs.update(zip(launch.cells, c))
        grads.update(zip(launch.cells, g))
    total = x.mesh.add({c: costs[c].sum() for c in cells}, x.sum_cells(), x.dtype)
    return total, [grads[c] if x.batched else grads[c][0] for c in cells]


class _SlabTV(torch.autograd.Function):
    """:func:`_slab_tv` as a differentiable cost: the backward is ``g *
    grad`` per tile, the exact gradient of the slabs' summed cost."""

    @staticmethod
    def forward(ctx, like, epsilon, scales, *tiles):
        total, grads = _slab_tv(like.with_tiles(dict(zip(like.local_cells(), tiles))), epsilon, scales)
        ctx.save_for_backward(*grads)
        return total

    @staticmethod
    def backward(ctx, g):
        return (None, None, None, *[g.to(gr.device) * gr for gr in ctx.saved_tensors])


def sharded_tv(x: ShardedVolume, epsilon: float, scales=None) -> torch.Tensor:
    """The hyperbolic TV of each volume of ``x``, summed, through the TV
    kernel's slab mode (its plain version on CPU tiles); differentiable."""
    return _SlabTV.apply(x, float(epsilon), scales, *(x.tiles[c] for c in x.local_cells()))


def sharded_tv_gradient(x: ShardedVolume, epsilon: float, scales=None) -> ShardedVolume:
    """The TV's gradient (RL-TV's denominator), one slab launch a tile."""
    return x.with_tiles(dict(zip(x.local_cells(), _slab_tv(x, float(epsilon), scales)[1])))


def _own_terms(x: ShardedVolume, halo: int, terms) -> torch.Tensor:
    """``sum`` of ``terms(slab with halo following planes)`` over each slab's
    own planes, added on the mesh's first device."""
    parts = {c: terms(ext).narrow(-3, 0, x.tiles[c].shape[-3]).sum() + tie
             for c, (ext, tie) in _with_halo(x, _after_plan(x, halo), -3).items()}
    return x.mesh.add(parts, x.sum_cells(), x.dtype)


def _extra_priors(x: ShardedVolume, config: DeconvolutionConfig):
    """sparsity * L1 + hessian * Hess of a sharded volume (``jobs.deconv``'s
    ``_extra_priors``); the Hessian's second differences read two planes of
    the next slabs."""
    out = None
    if config.sparsity > 0:
        eps_s = config.epsilon if config.sparsity_epsilon is None else config.sparsity_epsilon
        out = config.sparsity * x.map(lambda t: smoothed_l1_terms(t, eps_s)).sum()
    if config.hessian > 0:
        axes = (-3, -2, -1) if x.batched else None
        h = config.hessian * _own_terms(x, 2, lambda t: hessian_terms(t, config.epsilon, config.scales, axes))
        out = h if out is None else out + h
    return out


def sharded_regularization(x: ShardedVolume, config: DeconvolutionConfig) -> torch.Tensor:
    """mu * TV + the priors of a sharded volume (``jobs.deconv.regularization_cost``
    with the TV through the slab kernel); per volume of a batch, summed."""
    total = config.mu * sharded_tv(x, config.epsilon, config.scales) if config.mu > 0 else None
    extra = _extra_priors(x, config)
    if extra is not None:
        total = extra if total is None else total + extra
    return total


def _temporal_tv(x: ShardedVolume, epsilon: float) -> torch.Tensor:
    """``hyperbolic_tv(x, eps, axes=(0,))`` across the batch rows: each tile
    reads the next row's first frame (the t halo)."""
    eps, nb = float(epsilon), x.mesh.shape[BATCH_AXIS]
    rows, parts = x.shape[0] // nb, {}
    plan = [((b, z), (b + 1, z), 0, 1) for b, z in x.cells() if b < nb - 1]
    for c, (ext, tie) in _with_halo(x, plan, 0).items():
        (d,) = _forward_diffs(ext, None, (0,))
        parts[c] = (torch.sqrt(d * d + eps * eps) - eps)[:rows].sum() + tie
    return x.mesh.add(parts, x.cells(), x.dtype)


def _joint_tv(x: ShardedVolume, epsilon: float, scales) -> torch.Tensor:
    """``joint_hyperbolic_tv(x, couple_axis=0)`` with the channels over the
    batch rows: each slab's squared differences (one z plane of halo) summed
    over its channels, then every cell of a z column adds the column's in row
    order, and row 0's cells count the cost (every cell computes its part, so
    that over processes every rank's backward reaches the column's exchange)."""
    eps, mesh, nzs = float(epsilon), x.mesh, x.shape[-3] // x.mesh.shape[Z_AXIS]
    sq, ties = {}, {}
    for c, (ext, tie) in _with_halo(x, _after_plan(x, 1), -3).items():
        sq[c] = sum(d * d for d in _forward_diffs(ext, scales, (-3, -2, -1))).sum(dim=0)[None, :nzs]
        ties[c] = tie
    sums = ShardedVolume(mesh, (mesh.shape[BATCH_AXIS], *x.shape[-3:]), sq, True)
    parts = {}
    for c, s in _assembled(sums, _column_plan(sums), 0).items():
        frames = s.unbind(0)
        g2 = sum(frames[1:], frames[0])
        parts[c] = (torch.sqrt(g2 + eps * eps) - eps).sum() + ties[c]
    return mesh.add(parts, mesh.cells((0,)), x.dtype)


def _kl_terms(m: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The per-voxel generalized KL terms of ``ops.convolution.generalized_kl``."""
    tiny = torch.finfo(m.dtype).tiny
    m = torch.clamp_min(m, tiny)
    log_ratio = torch.log(m) - torch.log(torch.clamp_min(d, tiny))
    return (m - d) - torch.where(d > 0, d * log_ratio, torch.zeros_like(d))


def _abs2(t):
    return t.real ** 2 + t.imag ** 2


class _QuadraticCost(torch.autograd.Function):
    """0.5<x, g2 A x> - <x, b> + c from one distributed FFT pair
    (``deconv.py:83-110``); the gradient ``g2 A x - b`` is the forward's
    by-product, and only ``x`` carries one."""

    @staticmethod
    def forward(ctx, meta, *tiles):
        like, kernel_sq, g2, b, c = meta
        x = like.with_tiles(dict(zip(like.local_cells(), tiles)))
        ax = sharded_irfftn(sharded_rfftn(x, like.mesh) * kernel_sq, like.shape[-3:], like.mesh)
        gax = ax * g2
        grad = gax - b
        ctx.save_for_backward(*(grad.tiles[k] for k in like.local_cells()))
        return 0.5 * (x * gax).sum() - (x * b).sum() + c

    @staticmethod
    def backward(ctx, g):
        return (None, *[g.to(gr.device) * gr for gr in ctx.saved_tensors])


def _mixer(mixm: torch.Tensor, mesh: Mesh):
    """``y_c = sum_k M_ck hx_k`` across the batch rows: per z column the dye
    tiles meet on row 0's device, and the channels go back to their rows."""

    def mix(hx: ShardedVolume) -> ShardedVolume:
        nb = mesh.shape[BATCH_AXIS]
        cr = mixm.shape[0] // nb
        tiles = {}
        if mesh.distributed:
            for (b, z), full in _assembled(hx, _column_plan(hx), 0).items():
                tiles[(b, z)] = torch.einsum("ck,k...->c...", mixm.to(full.device), full)[b * cr:(b + 1) * cr]
            return ShardedVolume(mesh, (mixm.shape[0], *hx.shape[1:]), tiles, True, "z")
        for z in range(mesh.shape[Z_AXIS]):
            dev = mesh.device(0, z)
            full = torch.cat([hx.tiles[(b, z)].to(dev) for b in range(nb)])
            out = torch.einsum("ck,k...->c...", mixm.to(dev), full)
            for b in range(nb):
                tiles[(b, z)] = out[b * cr:(b + 1) * cr].to(mesh.device(b, z))
        return ShardedVolume(mesh, (mixm.shape[0], *hx.shape[1:]), tiles, True, "z")

    return mix


def _sharded_fun(objective, like: ShardedVolume):
    """``v -> (f, g)`` over the tiles dict VMLMB moves (or a sharded volume,
    whose gradient then comes back sharded); an unbatched variable's replicas
    on the rows of a mesh over processes take row 0's gradient."""
    value_grad = value_and_grad(lambda tiles: objective(like.with_tiles(tiles)))

    def fun(tiles):
        f, g = value_grad(tiles)
        return f, like.as_row0(g)

    def call(v):
        if isinstance(v, ShardedVolume):
            f, g = fun(v.variable())
            return f, v.with_tiles(g)
        return fun(v)

    return call


def make_sharded_objective(psf, data, weights, config: DeconvolutionConfig, mesh: Mesh, mu_t: float = 0.0,
                           epsilon_t: float | None = None, bleach=None, joint_channels: bool = False, mixing=None,
                           accurate: bool = False):
    """Fused sharded cost and gradient of the object step (``deconv.py:113-339``).

    ``data`` is (Nz, Ny, Nx) or batched (B, Nz, Ny, Nx), a tensor or a
    sharded volume; ``psf`` one volume at the data shape or, for batched
    data, a (B,) + volume stack of per-frame kernels; a sharded ``psf`` on
    the variable's grid (``parallel.psf_fit.psf_slabs``) is the kernel
    already zero-padded there, and its spectrum is taken from its tiles in
    place. Uniform weights take
    the 2-FFT quadratic form (``accurate``: the residual form); weights, or
    ``mixing`` (a (C_det, K) bleed-through matrix: the variable is the K dye
    volumes), the explicit residual; ``data_term="poisson"`` the generalized
    KL deviance. ``config.var_shape`` larger than the data is the padded
    variable: zero weight outside the centred data window (the route to
    mesh-divisible grids). ``mu_t`` adds the temporal TV across the batch
    rows, ``bleach`` per-frame gains (B,) folded into the model,
    ``joint_channels`` the channel-coupled TV over the batch rows instead of
    the per-frame TV.

    Returns ``fun(x) -> (f, g)``: ``x`` the dict of tiles VMLMB moves (or a
    sharded volume), ``f`` on the mesh's first device.
    """
    return _sharded_fun(*sharded_objective(psf, data, weights, config, mesh, mu_t, epsilon_t, bleach,
                                           joint_channels, mixing, accurate))


def sharded_objective(psf, data, weights, config: DeconvolutionConfig, mesh: Mesh, mu_t: float = 0.0,
                      epsilon_t: float | None = None, bleach=None, joint_channels: bool = False, mixing=None,
                      accurate: bool = False):
    """``(objective, like)``: the cost of :func:`make_sharded_objective` as a
    function of a sharded volume, differentiable, and an empty sharded volume
    of the variable's layout."""
    vol_shape = tuple(data.shape[-3:])
    batched = data.ndim == 4
    per_channel = psf.ndim == 4
    dtype = data.dtype
    mixm = None
    if mixing is not None:
        if not batched:
            raise ValueError("mixing needs batched (C_det, Nz, Ny, Nx) data")
        mixm = torch.as_tensor(mixing, dtype=dtype).to(mesh.first)
        if mixm.ndim != 2 or mixm.shape[0] != data.shape[0]:
            raise ValueError(f"mixing must be ({data.shape[0]}, K) (rows = the data's detected channels), "
                             f"got {tuple(mixm.shape)}")
    n_kernels = mixm.shape[1] if mixm is not None else (data.shape[0] if batched else None)
    var_shape = tuple(config.var_shape) if config.var_shape is not None else vol_shape
    if per_channel:
        if not batched:
            raise ValueError("per-frame kernels need batched (B, Nz, Ny, Nx) data")
        if psf.shape[0] != n_kernels or tuple(psf.shape[1:]) != vol_shape:
            raise ValueError(f"per-frame kernels must be {(n_kernels,) + vol_shape}, got {tuple(psf.shape)}")
    elif tuple(psf.shape) != vol_shape and not (isinstance(psf, ShardedVolume) and tuple(psf.shape) == var_shape):
        raise ValueError("sharded mode requires psf shape == volume shape (or, sharded, == var_shape)")
    if mu_t > 0 and not batched:
        raise ValueError("mu_t couples the leading batch axis; data must be (T, Nz, Ny, Nx)")
    if joint_channels:
        if not batched:
            raise ValueError("joint_channels couples the leading batch axis; data must be (C, Nz, Ny, Nx)")
        if mu_t > 0:
            raise ValueError("joint_channels and mu_t both couple the leading axis; pick one (channels are "
                             "unordered, timepoints are ordered)")
    if mixm is not None and mu_t > 0:
        raise ValueError("mixing treats the leading axis as channels; mu_t treats it as time — they do not "
                         "compose on the 4D mesh path")
    eps_t = config.epsilon if epsilon_t is None else epsilon_t
    mix = (lambda hx: hx) if mixm is None else _mixer(mixm, mesh)

    def spectrum(p):
        if isinstance(p, ShardedVolume) and tuple(p.shape[-3:]) == var_shape:
            return sharded_spectrum(p, mesh)  # the slabs in place (parallel.psf_fit.psf_slabs)
        kernel = gather(p)
        kernel = pad_fft_kernel(kernel, var_shape) if tuple(kernel.shape[-3:]) != var_shape else kernel
        return sharded_spectrum(shard(kernel, mesh, batched=per_channel), mesh)

    def regularize(f, x):
        if joint_channels:
            if config.mu > 0:
                f = f + config.mu * _joint_tv(x, config.epsilon, config.scales)
            extra = _extra_priors(x, config)
            return f if extra is None else f + extra
        if has_regularizer(config):
            f = f + sharded_regularization(x, config)
        return f

    g4 = None
    if bleach is not None:
        if not batched:
            raise ValueError("bleach gains are per frame of the leading batch axis; data must be (T, Nz, Ny, Nx)")
        bleach = torch.as_tensor(bleach, dtype=dtype)
        if tuple(bleach.shape) != (n_kernels,):
            raise ValueError(f"bleach must be per-{'dye' if mixm is not None else 'frame'} gains of shape "
                             f"({n_kernels},), got {tuple(bleach.shape)}")
        g4 = shard_rows(bleach.reshape(-1, 1, 1, 1), mesh)

    def gained(hx):
        return hx if g4 is None else hx * g4

    like = ShardedVolume(mesh, ((n_kernels,) if batched else ()) + var_shape, {}, batched)

    def wrap(objective):
        if mu_t <= 0:
            return objective, like
        return (lambda x: objective(x) + mu_t * _temporal_tv(x, eps_t)), like

    padded = var_shape != vol_shape

    if config.data_term == "poisson":
        if weights is not None:
            raise ValueError("data_term='poisson' does not compose with weights")
        k_hat = spectrum(psf)
        d = shard(pad_trailing(gather(data), var_shape), mesh, batched) if padded else shard(data, mesh, batched)
        mask = shard(pad_trailing(torch.ones(vol_shape, dtype=dtype), var_shape), mesh, False) if padded else None
        bg = float(config.background)

        def objective(x):
            pred = mix(gained(sharded_irfftn(sharded_rfftn(x, mesh) * k_hat, var_shape, mesh))) + bg
            terms = pred.map(_kl_terms, d)
            return regularize((terms if mask is None else terms * mask).sum(), x)

        return wrap(objective)
    if config.data_term != "gaussian":
        raise ValueError(f"unknown data_term {config.data_term!r}")

    k_hat = spectrum(psf)

    def model(x):
        return mix(gained(sharded_irfftn(sharded_rfftn(x, mesh) * k_hat, var_shape, mesh)))

    if padded:
        d_pad = shard(pad_trailing(gather(data), var_shape), mesh, batched)
        w = torch.ones(vol_shape, dtype=dtype) if weights is None else gather(weights)
        w_pad = shard(pad_trailing(w, var_shape), mesh, w.ndim == 4)

        def objective(x):
            r = model(x) - d_pad
            return regularize(0.5 * (w_pad * r * r).sum(), x)

        return wrap(objective)

    data = shard(data, mesh, batched)
    if weights is None and mixm is None and accurate:
        def data_term(x):
            r = model(x) - data
            return 0.5 * (r * r).sum()
    elif weights is None and mixm is None:
        kernel_sq = k_hat.map(_abs2)
        b = sharded_irfftn(k_hat.map(torch.conj) * sharded_rfftn(data, mesh), vol_shape, mesh)
        g2 = 1.0 if g4 is None else g4 * g4
        if g4 is not None:
            b = b * g4
        c = 0.5 * (data * data).sum()

        def data_term(x):
            return _QuadraticCost.apply((x, kernel_sq, g2, b, c), *(x.tiles[k] for k in x.local_cells()))
    else:
        if weights is None:
            weights = 1.0  # mixing without weights: the explicit residual
        else:
            # Zero weight excludes the voxel whatever its value (0 * NaN = NaN).
            weights = shard(weights, mesh, weights.ndim == 4)
            data = data.map(lambda d, w: torch.where(w > 0, d, torch.zeros_like(d)), weights)

        def data_term(x):
            r = model(x) - data
            return 0.5 * (weights * r * r).sum()

    def objective(x):
        return regularize(data_term(x), x)

    return wrap(objective)


def sharded_start(data, var_shape, mesh: Mesh, positivity: bool = True, mixing=None) -> ShardedVolume:
    """The default start: the data (or, with ``mixing``, its clipped
    pseudo-inverse unmix) centred on ``var_shape``, clamped at 0 under
    positivity, sharded."""
    d = gather(data)
    if mixing is not None:
        mixm = torch.as_tensor(mixing, dtype=d.dtype, device=d.device)
        d = torch.einsum("kc,c...->k...", torch.linalg.pinv(mixm), d)
    x0 = pad_trailing(d, var_shape)
    if positivity:
        x0 = torch.clamp_min(x0, 0.0)
    return shard(x0, mesh, x0.ndim == 4)


def sharded_deconvolve(
    data,
    psf,
    mesh: Mesh,
    weights=None,
    x0=None,
    config: DeconvolutionConfig = DeconvolutionConfig(),
    mu_t: float = 0.0,
    epsilon_t: float | None = None,
    bleach=None,
    joint_channels: bool = False,
    mixing=None,
) -> DeconvolutionResult:
    """The object step on the mesh (``deconv.py:342-397``), the sharded
    counterpart of ``jobs.deconv.deconvolve`` with the options of
    :func:`make_sharded_objective`. ``data`` (and ``weights``, ``x0``) are
    tensors or sharded volumes; the result's ``x`` is a sharded volume on
    ``config.var_shape`` (``mesh.gather(res.x)`` is the tensor)."""
    var_shape = tuple(config.var_shape) if config.var_shape is not None else tuple(data.shape[-3:])
    if x0 is None:
        x0 = sharded_start(data, var_shape, mesh, config.positivity, mixing)
    x0 = shard(x0, mesh, x0.ndim == 4)
    fun = make_sharded_objective(psf, data, weights, config, mesh, mu_t=mu_t, epsilon_t=epsilon_t, bleach=bleach,
                                 joint_channels=joint_channels, mixing=mixing)
    res = minimize_vmlmb(fun, x0.variable(), lower=0.0 if config.positivity else None, mem=config.mem,
                         maxiter=config.max_iter, maxeval=config.max_eval, gatol=config.gatol, grtol=config.grtol)
    return DeconvolutionResult(x0.with_tiles(res.x), res.f, res.iterations, res.evaluations, res.status,
                               res.f_history, res.pg_history)


def sharded_wiener(data, psf, mesh: Mesh, reg: float = 1e-3) -> ShardedVolume:
    """The distributed ``jobs.wiener.wiener`` (``deconv.py:400-416``): 2
    distributed FFTs, ``psf`` corner-origin at the volume grid, one kernel
    spectrum for a batch."""
    vol_shape = tuple(data.shape[-3:])
    if tuple(psf.shape) != vol_shape:
        raise ValueError("sharded wiener requires psf shape == volume shape")
    k_hat = sharded_spectrum(psf, mesh)
    k2 = k_hat.map(_abs2)
    lam = reg * k2.amax()
    d_hat = sharded_rfftn(data, mesh)
    return sharded_irfftn(k_hat.map(torch.conj) * d_hat / (k2 + lam), vol_shape, mesh)
