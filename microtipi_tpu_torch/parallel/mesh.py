"""Device mesh and sharded volumes, driven by one process or spanning several.

Port of ``microtipi_tpu/parallel/mesh.py``. The JAX package builds one
program over global arrays on a ``Mesh`` of devices, and GSPMD inserts the
collectives. Here the mesh is a (batch, z) grid of ``torch.device``s, and a
sharded volume is a grid of per-device tensors:

- ``batch`` (:data:`BATCH_AXIS`): the frames or channels of a stack
  (B, Nz, Ny, Nx), a contiguous run of them on each row of the mesh;
- ``z`` (:data:`Z_AXIS`): each volume's z planes, a contiguous slab on each
  column; the distributed FFT (``parallel/fft.py``) transposes over it.

A move between cells is an explicit copy between devices (:func:`send`,
``collectives.exchange``). A device list may repeat a device:
``[cuda:0] * 4`` runs every slab, halo exchange and transpose on one card, as the JAX suite runs its mesh on virtual host
devices, and a list of CPU entries runs the same code on the host.

:class:`ShardedVolume` is the grid: its tiles, keyed ``(b, z)``, and the
global shape. An unbatched volume (Nz, Ny, Nx) lives on row 0; where it meets
a batched one, row ``b`` reads a copy (:meth:`ShardedVolume.tile`), the
counterpart of JAX's replication over the batch axis. Elementwise arithmetic
runs tile by tile, and :meth:`ShardedVolume.sum` adds the tiles' sums on the
mesh's first device in a fixed order (batch-major, then z), so a run is
reproducible. The optimizer sees the tiles as a dict (:meth:`variable`):
``optim/treeutil.tdot`` sums the per-tile dots the same way.

No tile is a view of another tile: :func:`send` always copies, and what
the collectives move is concatenated or added into new tensors, since the
ADMM split update writes its state in place.

A mesh over processes (``make_mesh(..., group=pg)``, the counterpart of a JAX
mesh under ``jax.distributed``): every rank runs the same program, one OS
process a rank. The global device list is every rank's local devices in rank
order, the cells are numbered batch-major over it, and each cell belongs to
the rank whose device it is (:meth:`Mesh.owner`). A sharded volume holds the
tiles of this rank's cells only (:meth:`ShardedVolume.local_cells`). The
solvers run the same code on both kinds of mesh: the moves between cells go
through ``parallel/collectives.py``, which copies between two cells of one
rank and sends and receives between cells of different ranks. Where the two
kinds differ:

- :func:`shard` of a tensor that every rank holds whole cuts this rank's
  tiles (``make_array_from_callback``); its gradient, where the tensor has
  one, is the sum over every rank's tiles (:class:`_Cut`);
- :func:`replicate` gives each cell a copy of small tensors that every cell
  needs whole (a PSF's pupil, from which each cell synthesizes its own
  planes; the sum that each cell's planes are divided by); their gradient
  is every cell's, gathered and added in the order of the cells on every
  rank (:class:`_Replicate`), on both kinds of mesh;
- :func:`gather` gives every rank the whole (``process_allgather``);
- a sum or maximum gathers the cells' parts and adds them on every rank in
  the order above, so every rank gets the same bits (:meth:`Mesh.add`), and
  the optimizer's variable is a ``treeutil.Shares`` that sums its dots so;
  a replica's part of a sum is passed and takes no part, so that its
  rank's backward reaches the replica (with a zero gradient) and with it
  every collective of the backward that the other ranks run;
- an unbatched volume has a replica on every mesh row, computed there (JAX
  replicates it over the batch axis too), instead of copies of row 0's; its
  sums count row 0's tiles, and an unbatched variable's replicas move with
  row 0's gradient (:meth:`ShardedVolume.as_row0`), so every row holds the
  one-process mesh's row 0 bit for bit.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from microtipi_tpu_torch.optim import treeutil
from microtipi_tpu_torch.parallel.collectives import all_cells, cell_values, exchange

__all__ = ["BATCH_AXIS", "Z_AXIS", "Mesh", "ShardedVolume", "VolumeSharding", "constrain_volume", "gather",
           "make_mesh", "replicate", "send", "shard", "shard_rows", "volume_sharding"]

BATCH_AXIS = "batch"
Z_AXIS = "z"


class Mesh:
    """A (batch, z) grid of devices; ``shape[BATCH_AXIS]``, ``shape[Z_AXIS]``
    as on a JAX mesh. ``owners``: the rank of ``group`` each cell belongs to
    (a mesh over processes); this process is rank ``rank``."""

    def __init__(self, devices, owners=None, group=None, rank: int = 0):
        rows = tuple(tuple(torch.device(d) for d in row) for row in devices)
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.devices = rows
        self.shape = {BATCH_AXIS: len(rows), Z_AXIS: len(rows[0])}
        self.owners = tuple(tuple(0 for _ in r) for r in rows) if owners is None else tuple(map(tuple, owners))
        self.group, self.rank = group, rank
        self.backend = None if group is None else dist.get_backend(group)
        self.size = 1 if group is None else dist.get_world_size(group)
        self._peers = None if group is None else dist.get_process_group_ranks(group)
        self._first = self.device(*self.local(self.cells())[0])

    @property
    def distributed(self) -> bool:
        """Whether the mesh spans the processes of a group."""
        return self.group is not None

    @property
    def first(self) -> torch.device:
        """Where reductions land: the device of this rank's first cell, (0, 0)
        on a mesh driven by one process."""
        return self._first

    def device(self, b: int, z: int) -> torch.device:
        return self.devices[b][z]

    def owner(self, b: int, z: int) -> int:
        return self.owners[b][z]

    def is_local(self, b: int, z: int) -> bool:
        return self.owners[b][z] == self.rank

    def peer(self, b: int, z: int) -> int:
        """The global rank of cell (b, z)'s owner, as point-to-point calls take it."""
        return self._peers[self.owners[b][z]]

    def cells(self, rows=None) -> list[tuple[int, int]]:
        """The cells (b, z), batch-major; ``rows`` restricts to those rows."""
        rows = range(self.shape[BATCH_AXIS]) if rows is None else rows
        return [(b, z) for b in rows for z in range(self.shape[Z_AXIS])]

    def local(self, cells) -> list[tuple[int, int]]:
        """Those of ``cells`` that this rank owns, in their order."""
        return [c for c in cells if self.is_local(*c)]

    def volume_cells(self, batched: bool) -> list[tuple[int, int]]:
        """The cells that hold a volume's tiles: every cell for a batched one;
        row 0's for an unbatched one, or every row's replica on a mesh over
        processes."""
        return self.cells(None if batched or self.distributed else (0,))

    def add(self, parts: dict, cells, dtype: torch.dtype) -> torch.Tensor:
        """The sum of ``parts`` (cell: 0-dim tensor) over ``cells``, added in
        their order on :attr:`first`, differentiable. Over processes ``parts``
        holds this rank's cells, and every rank gets the same bits."""
        vals = self._values(parts, cells, dtype)
        return sum(vals[1:], vals[0])

    def max(self, parts: dict, cells, dtype: torch.dtype) -> torch.Tensor:
        """The largest of ``parts`` over ``cells``, on :attr:`first`."""
        return torch.stack(self._values(parts, cells, dtype)).amax()

    def _values(self, parts: dict, cells, dtype) -> list:
        if self.distributed:
            return list(cell_values(self, parts, cells, dtype).unbind())
        return [parts[c].to(self.first) for c in cells]

    def __repr__(self) -> str:
        devs = [[str(d) for d in r] for r in self.devices]
        if not self.distributed:
            return f"Mesh({self.shape[BATCH_AXIS]}x{self.shape[Z_AXIS]}, {devs})"
        return (f"Mesh({self.shape[BATCH_AXIS]}x{self.shape[Z_AXIS]}, {devs}, owners={[list(r) for r in self.owners]}, "
                f"rank={self.rank} of {self.size}, {self.backend})")


def _visible_cuda() -> list[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh with devices=None takes the visible CUDA devices and there are none; "
                           "pass devices (e.g. [torch.device('cpu')] * n) to run the mesh on the host")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(batch: int = 1, z: int | None = None, devices=None, group=None) -> Mesh:
    """A (batch, z) mesh (``mesh.py:28-40``). ``devices=None`` takes the
    visible CUDA devices; with ``z=None`` all that are left go to the z axis.
    An explicit list may repeat a device.

    With a process group ``group`` (``torch.distributed``; its backend is the
    one the mesh's collectives use) the mesh spans the group's processes, and
    every rank calls this with its own ``devices`` (default: the current CUDA
    device). The global device list is every rank's in rank order; cell
    (b, z) is its entry ``b * z_size + z`` and belongs to that entry's rank."""
    if group is None:
        devices = _visible_cuda() if devices is None else [torch.device(d) for d in devices]
        owners = [0] * len(devices)
    else:
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError("make_mesh over processes with devices=None takes the current CUDA device and "
                                   "there is none; pass this rank's devices (e.g. [torch.device('cpu')])")
            devices = [torch.device("cuda", torch.cuda.current_device())]
        every = [None] * dist.get_world_size(group)
        dist.all_gather_object(every, [str(torch.device(d)) for d in devices], group=group)
        if not all(every):
            raise ValueError(f"every rank of a mesh over processes needs a device; the ranks hold {every}")
        devices = [torch.device(d) for ds in every for d in ds]
        owners = [r for r, ds in enumerate(every) for _ in ds]
    n = len(devices)
    if z is None:
        if n % batch:
            raise ValueError(f"{n} devices not divisible by batch={batch}")
        z = n // batch
    if batch * z != n:
        raise ValueError(f"mesh {batch}x{z} != {n} devices")
    cut = [slice(b * z, (b + 1) * z) for b in range(batch)]
    if group is None:
        return Mesh([devices[s] for s in cut])
    return Mesh([devices[s] for s in cut], [owners[s] for s in cut], group, dist.get_rank(group))


class VolumeSharding(NamedTuple):
    """The canonical layout of a stack (B, Nz, Ny, Nx) or volume (Nz, Ny, Nx):
    batch over ``batch`` (batched only), z over ``z``, (y, x) whole."""

    mesh: Mesh
    batched: bool


def volume_sharding(mesh: Mesh, batched: bool = True) -> VolumeSharding:
    """The layout descriptor of ``mesh.py:43-47``; :func:`shard` takes it."""
    return VolumeSharding(mesh, batched)


def send(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``device``, differentiable; a copy even
    on ``t``'s own device, so no tile ever aliases another."""
    return t.to(device, copy=True, memory_format=torch.contiguous_format)


def _split(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what} of {n} does not divide over {parts} mesh entries")
    return n // parts


class ShardedVolume:
    """A grid of tiles over a mesh: ``tiles[(b, z)]`` on ``mesh.device(b, z)``.

    ``shape`` is the global shape. ``layout`` "z": real space, z-slabs
    (..., Nz/Z, Ny, Nx); "y": a spectrum of ``parallel/fft.py``, z whole and y
    split (..., Nz, Ny/Z, Nx//2+1); "rows": per-frame values (B, 1, 1, 1)
    split over the batch axis only. ``batched``: the leading axis is split
    over the mesh rows; otherwise the tiles are row 0's (over processes
    every row's replica)."""

    def __init__(self, mesh: Mesh, shape, tiles: dict, batched: bool, layout: str = "z"):
        self.mesh, self.shape, self.tiles = mesh, tuple(shape), tiles
        self.batched, self.layout = batched, layout
        self._replicas: dict = {}

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.tiles.values())).dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def cells(self) -> list[tuple[int, int]]:
        """The cells that hold tiles (``Mesh.volume_cells``), every rank's."""
        return self.mesh.volume_cells(self.batched)

    def local_cells(self) -> list[tuple[int, int]]:
        """The cells whose tiles this rank holds (all of them on a mesh
        driven by one process)."""
        return self.mesh.local(self.cells())

    def sum_cells(self) -> list[tuple[int, int]]:
        """The cells whose tiles a sum adds: row 0's of an unbatched volume
        (its other rows' tiles are replicas)."""
        return self.mesh.cells(None if self.batched else (0,))

    def tile(self, b: int, z: int) -> torch.Tensor:
        """Cell (b, z)'s tile; of an unbatched volume, row 0's tile on that
        cell's device (cached for a constant, a differentiable copy else), or
        over processes the row's own replica."""
        if self.batched or b == 0 or self.mesh.distributed:
            return self.tiles[(b, z)]
        t = self.tiles[(0, z)]
        dev = self.mesh.device(b, z)
        if t.requires_grad:
            return t.to(dev)
        if (b, z) not in self._replicas:
            self._replicas[(b, z)] = t.to(dev)
        return self._replicas[(b, z)]

    def map(self, fn: Callable, *others) -> "ShardedVolume":
        """``fn(tile, *others' tiles)`` cell by cell, elementwise with
        broadcasting. ``others``: sharded volumes on the same mesh, numbers,
        or 0-dim tensors (sent to each tile's device). Batched if any operand
        is; the result has the longest shape of the operands of this layout."""
        sharded = [o for o in (self, *others) if isinstance(o, ShardedVolume)]
        batched = any(o.batched for o in sharded)
        shape = max((o.shape for o in sharded if o.layout == self.layout), key=len)
        tiles = {}
        for b, z in self.mesh.local(self.mesh.volume_cells(batched)):
            dev = self.mesh.device(b, z)
            args = [o.tile(b, z) if isinstance(o, ShardedVolume)
                    else o.to(dev) if isinstance(o, torch.Tensor) else o for o in (self, *others)]
            tiles[(b, z)] = fn(*args)
        return ShardedVolume(self.mesh, shape, tiles, batched, self.layout)

    def sum(self) -> torch.Tensor:
        """The sum of every element, a 0-dim tensor on the mesh's first device:
        each tile's sum, added batch-major then by z. A replica's tile (an
        unbatched volume's on a row other than 0, over processes) adds
        nothing and gets a zero gradient."""
        return self.mesh.add({c: self.tiles[c].sum() for c in self.local_cells()}, self.sum_cells(), self.dtype)

    def sum_frames(self) -> "ShardedVolume":
        """The sum over the leading (frame) axis of a batched volume, an
        unbatched one: each z column's frame sums added in row order on the
        cells that hold the result (row 0's; over processes every row's, and
        not differentiable there)."""
        mesh, nb = self.mesh, self.mesh.shape[BATCH_AXIS]
        if mesh.distributed and torch.is_grad_enabled() and any(t.requires_grad for t in self.tiles.values()):
            raise ValueError("sum_frames over processes is not differentiable")
        parts = {c: t.sum(dim=0) for c, t in self.tiles.items()}
        like, cells = next(iter(parts.values())), mesh.volume_cells(False)
        moves = [((b, z), (r, z), parts.get((b, z)), like.shape, like.dtype) for r, z in cells for b in range(nb)]
        got, tiles = exchange(mesh, moves, "cells"), {}
        for k, (r, z) in enumerate(cells):
            if mesh.is_local(r, z):
                frames = got[k * nb:(k + 1) * nb]
                tiles[(r, z)] = sum(frames[1:], frames[0])
        return ShardedVolume(mesh, self.shape[1:], tiles, False, self.layout)

    def amax(self) -> torch.Tensor:
        """The largest element, a 0-dim tensor on the mesh's first device."""
        cells = self.sum_cells()
        return self.mesh.max({c: self.tiles[c].amax() for c in self.mesh.local(cells)}, cells, self.dtype)

    def variable(self) -> dict:
        """The tiles the optimizer moves, as a dict keyed (b, z); over
        processes this rank's, as a ``treeutil.Shares`` whose dots every rank
        sums alike, each cell once (an unbatched volume's row 0: the other
        rows' replicas are copies of it, :meth:`as_row0`)."""
        tiles = {c: self.tiles[c] for c in self.local_cells()}
        if not self.mesh.distributed:
            return tiles
        cells, mesh, dtype = self.sum_cells(), self.mesh, self.dtype
        return treeutil.Shares(tiles, lambda parts: mesh.add(parts, cells, dtype))

    def as_row0(self, tiles: dict) -> dict:
        """``tiles`` (this rank's, of this volume's layout) with every
        replica's tile replaced by row 0's of its z column, in one exchange:
        over processes on several rows each row holds a replica of an
        unbatched volume, and only row 0's tiles take part in its sums, so
        row 0's gradient is the whole one, and the replicas move with it.
        ``tiles`` as they are where there are no replicas."""
        mesh = self.mesh
        if self.batched or not mesh.distributed or mesh.shape[BATCH_AXIS] == 1:
            return tiles
        like = next(iter(tiles.values()))
        moves = [((0, z), (b, z), tiles.get((0, z)), like.shape, like.dtype)
                 for b in range(1, mesh.shape[BATCH_AXIS]) for z in range(mesh.shape[Z_AXIS])]
        out = dict(tiles)
        for (_, dst, *_), t in zip(moves, exchange(mesh, moves, "rows")):
            if t is not None:
                out[dst] = t
        return treeutil.like((tiles,), out)

    def with_tiles(self, tiles: dict) -> "ShardedVolume":
        """This layout with other tiles (a dict of :meth:`variable`'s keys)."""
        return ShardedVolume(self.mesh, self.shape, dict(tiles), self.batched, self.layout)

    def detach(self) -> "ShardedVolume":
        return self.map(torch.Tensor.detach)

    def __add__(self, o):
        return self.map(torch.add, o)

    def __radd__(self, o):
        return self.map(lambda t, v: v + t, o)

    def __sub__(self, o):
        return self.map(torch.sub, o)

    def __mul__(self, o):
        return self.map(torch.mul, o)

    def __rmul__(self, o):
        return self.map(lambda t, v: v * t, o)

    def __truediv__(self, o):
        return self.map(torch.div, o)

    def __rtruediv__(self, o):
        return self.map(lambda t, v: v / t, o)

    def __repr__(self) -> str:
        return (f"ShardedVolume(shape={self.shape}, layout={self.layout!r}, batched={self.batched}, "
                f"dtype={self.dtype}, mesh={self.mesh.shape[BATCH_AXIS]}x{self.mesh.shape[Z_AXIS]})")


def shard(a, mesh: Mesh, batched: bool | None = None, layout: str = "z") -> ShardedVolume:
    """Split a tensor over the mesh: its leading axis over the rows when
    ``batched`` (default: 4D), and axis -3 (layout "z") or -2 (layout "y")
    over the columns. Each tile is a copy on its device. A
    :class:`VolumeSharding` may stand for the mesh."""
    if isinstance(a, ShardedVolume):
        return a
    if isinstance(mesh, VolumeSharding):
        mesh, batched = mesh.mesh, mesh.batched
    if batched is None:
        batched = a.ndim == 4
    nb, nz = mesh.shape[BATCH_AXIS], mesh.shape[Z_AXIS]
    axis = a.ndim - (3 if layout == "z" else 2)
    step = _split(a.shape[axis], nz, f"axis {axis - a.ndim} of shape {tuple(a.shape)}")
    rows = _split(a.shape[0], nb, f"the batch of shape {tuple(a.shape)}") if batched else None
    cut = functools.partial(_part, axis=axis, step=step, rows=rows)
    cells = mesh.volume_cells(batched)
    local = mesh.local(cells)
    if mesh.distributed and a.requires_grad and torch.is_grad_enabled():
        tiles = dict(zip(local, _Cut.apply(mesh, cells, cut, a)))
    else:
        tiles = {(b, z): send(cut(a, b, z), mesh.device(b, z)) for b, z in local}
    return ShardedVolume(mesh, a.shape, tiles, batched, layout)


def _part(a: torch.Tensor, b: int, z: int, axis: int, step: int, rows: int | None) -> torch.Tensor:
    """Cell (b, z)'s part of ``a``, a view (``rows`` None: every row's is the whole batch)."""
    t = a if rows is None else a[b * rows:(b + 1) * rows]
    return t.narrow(axis, z * step, step)


class _Cut(torch.autograd.Function):
    """This rank's tiles of a tensor that every rank holds whole, over
    processes. The whole's gradient is every cell's tile gradient added into
    its place, in the order of the cells, on every rank alike (one
    broadcast a cell): the sum over the ranks, taken once."""

    @staticmethod
    def forward(ctx, mesh, cells, cut, a):
        ctx.args, ctx.like = (mesh, cells, cut), (a.shape, a.dtype, a.device)
        return tuple(send(cut(a, b, z), mesh.device(b, z)) for b, z in mesh.local(cells))

    @staticmethod
    def backward(ctx, *grads):
        mesh, cells, cut = ctx.args
        shape, dtype, device = ctx.like
        every = all_cells(mesh, dict(zip(mesh.local(cells), grads)), cells)
        g = torch.zeros(shape, dtype=dtype, device=device)
        for b, z in cells:
            cut(g, b, z).add_(every[(b, z)].to(device))
        return None, None, None, g


class _Replicate(torch.autograd.Function):
    """A copy of ``tensors`` on each of this rank's ``cells``' devices, one
    output a tensor and a cell (this rank's cells in order). The gradient of
    each tensor is every cell's gradient of its copy, gathered
    (``collectives.all_cells``, its bytes counted under ``kind``: a cell's
    gradients as one vector) and added in the order of ``cells`` on every
    rank alike, on the tensors' device, in float64 and rounded once to the
    tensors' dtype (a
    float32 sum in cell order rounds each addition, and a float32 blind loop
    follows its gradient's last bits): the same bits on a mesh driven by one
    process and over processes. Forward mode takes the tangents' copies."""

    generate_vmap_rule = True

    @staticmethod
    def forward(mesh, cells, kind, *tensors):
        return tuple(send(t, mesh.device(*c)) for c in mesh.local(cells) for t in tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        mesh, cells, kind, *tensors = inputs
        ctx.args, ctx.like = (mesh, cells, kind), [(t.shape, t.device) for t in tensors]

    @staticmethod
    def backward(ctx, *grads):
        mesh, cells, kind = ctx.args
        n, local = len(ctx.like), mesh.local(cells)
        parts = {c: torch.cat([g.reshape(-1) for g in grads[k * n:(k + 1) * n]]) for k, c in enumerate(local)}
        if mesh.distributed:
            parts = all_cells(mesh, parts, cells, kind)
        device, dtype = ctx.like[0][1], parts[cells[0]].dtype
        total = parts[cells[0]].to(device, torch.float64)
        for c in cells[1:]:
            total = total + parts[c].to(device, torch.float64)
        sizes = [shape.numel() for shape, _ in ctx.like]
        return (None, None, None,
                *(g.reshape(shape).to(dev, dtype) for g, (shape, dev) in zip(total.split(sizes), ctx.like)))

    @staticmethod
    def jvp(ctx, _mesh, _cells, _kind, *tangents):
        mesh, cells, _ = ctx.args
        return tuple(None if t is None else send(t, mesh.device(*c)) for c in mesh.local(cells) for t in tangents)


def replicate(tensors, mesh: Mesh, cells, kind: str = "pupil") -> dict:
    """A copy of ``tensors`` (a tuple, or a named tuple, of tensors of one
    dtype that every cell needs whole) on each of this rank's ``cells``'
    devices, keyed by cell, as ``tensors``' type; differentiable (see
    :class:`_Replicate`: every rank must reach its backward; ``kind`` counts
    its bytes in ``collectives.sent``)."""
    n, local = len(tensors), mesh.local(cells)
    flat = _Replicate.apply(mesh, list(cells), kind, *tensors)
    make = getattr(tensors, "_make", tuple)
    return {c: make(flat[k * n:(k + 1) * n]) for k, c in enumerate(local)}


def shard_rows(a: torch.Tensor, mesh: Mesh) -> ShardedVolume:
    """Per-frame values (B, 1, 1, 1) split over the mesh rows only, each row's
    run on every cell of the row (layout "rows")."""
    rows = _split(a.shape[0], mesh.shape[BATCH_AXIS], f"the batch of shape {tuple(a.shape)}")
    tiles = {(b, z): send(a[b * rows:(b + 1) * rows], mesh.device(b, z)) for b, z in mesh.local(mesh.cells())}
    return ShardedVolume(mesh, a.shape, tiles, True, "rows")


def gather(s, device=None) -> torch.Tensor:
    """The global tensor of a sharded volume on ``device`` (default: the
    mesh's first device); a tensor passes through. Differentiable on a mesh
    driven by one process; over processes every rank gets the whole, and
    nothing flows back."""
    if not isinstance(s, ShardedVolume):
        return s
    device = s.mesh.first if device is None else device
    nb, nz = s.mesh.shape[BATCH_AXIS], s.mesh.shape[Z_AXIS]
    axis = s.ndim - (3 if s.layout == "z" else 2)
    tiles = s.tiles
    if s.mesh.distributed:
        if torch.is_grad_enabled() and any(t.requires_grad for t in tiles.values()):
            raise ValueError("gather over processes is not differentiable")
        tiles = all_cells(s.mesh, tiles, [(b, 0) for b in range(nb)] if s.layout == "rows" else s.sum_cells())
    if s.layout == "rows":
        return torch.cat([tiles[(b, 0)].to(device) for b in range(nb)])
    rows = [torch.cat([tiles[(b, z)].to(device) for z in range(nz)], dim=axis)
            for b in range(nb if s.batched else 1)]
    return torch.cat(rows) if s.batched else rows[0]


def constrain_volume(a, mesh: Mesh, batched: bool | None = None):
    """``a`` in the canonical layout when its shape divides the mesh, else
    ``a`` as it is (``mesh.py:50-62``): a sharded volume passes through; a
    tensor whose z (and, batched, leading) axis does not divide stays whole."""
    if isinstance(a, ShardedVolume):
        return a
    if batched is None:
        batched = a.ndim == 4
    if a.shape[-3] % mesh.shape[Z_AXIS] or (batched and a.shape[0] % mesh.shape[BATCH_AXIS]):
        return a
    return shard(a, mesh, batched)
