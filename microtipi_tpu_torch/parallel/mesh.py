"""Device mesh and sharded volumes, driven by one process.

Port of ``microtipi_tpu/parallel/mesh.py``. The JAX package builds one
program over global arrays on a ``Mesh`` of devices, and GSPMD inserts the
collectives. Here the mesh is a (batch, z) grid of ``torch.device``s that one
process drives, and a sharded volume is a grid of per-device tensors:

- ``batch`` (:data:`BATCH_AXIS`): the frames or channels of a stack
  (B, Nz, Ny, Nx), a contiguous run of them on each row of the mesh;
- ``z`` (:data:`Z_AXIS`): each volume's z planes, a contiguous slab on each
  column; the distributed FFT (``parallel/fft.py``) transposes over it.

A collective is an explicit copy between devices (:func:`send`). A device
list may repeat a device: ``[cuda:0] * 4`` runs every slab, halo exchange and
transpose on one card, as the JAX suite runs its mesh on virtual host
devices, and a list of CPU entries runs the same code on the host.

:class:`ShardedVolume` is the grid: its tiles, keyed ``(b, z)``, and the
global shape. An unbatched volume (Nz, Ny, Nx) lives on row 0; where it meets
a batched one, row ``b`` reads a copy (:meth:`ShardedVolume.tile`), the
counterpart of JAX's replication over the batch axis. Elementwise arithmetic
runs tile by tile, and :meth:`ShardedVolume.sum` adds the tiles' sums on the
mesh's first device in a fixed order (batch-major, then z), so a run is
reproducible. The optimizer sees the tiles as a dict (:meth:`variable`):
``optim/treeutil.tdot`` sums the per-tile dots the same way.

No exchange hands a tile a view of another tile: :func:`send` always copies,
since the ADMM split update writes its state in place.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["BATCH_AXIS", "Z_AXIS", "Mesh", "ShardedVolume", "VolumeSharding", "constrain_volume", "gather",
           "make_mesh", "send", "shard", "shard_rows", "volume_sharding"]

BATCH_AXIS = "batch"
Z_AXIS = "z"


class Mesh:
    """A (batch, z) grid of devices; ``shape[BATCH_AXIS]``, ``shape[Z_AXIS]``
    as on a JAX mesh."""

    def __init__(self, devices):
        rows = tuple(tuple(torch.device(d) for d in row) for row in devices)
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.devices = rows
        self.shape = {BATCH_AXIS: len(rows), Z_AXIS: len(rows[0])}

    @property
    def first(self) -> torch.device:
        """Where reductions land: the device of cell (0, 0)."""
        return self.devices[0][0]

    def device(self, b: int, z: int) -> torch.device:
        return self.devices[b][z]

    def cells(self, rows=None) -> list[tuple[int, int]]:
        """The cells (b, z), batch-major; ``rows`` restricts to those rows."""
        rows = range(self.shape[BATCH_AXIS]) if rows is None else rows
        return [(b, z) for b in rows for z in range(self.shape[Z_AXIS])]

    def __repr__(self) -> str:
        return f"Mesh({self.shape[BATCH_AXIS]}x{self.shape[Z_AXIS]}, {[[str(d) for d in r] for r in self.devices]})"


def _visible_cuda() -> list[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh with devices=None takes the visible CUDA devices and there are none; "
                           "pass devices (e.g. [torch.device('cpu')] * n) to run the mesh on the host")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(batch: int = 1, z: int | None = None, devices=None) -> Mesh:
    """A (batch, z) mesh (``mesh.py:28-40``). ``devices=None`` takes the
    visible CUDA devices; with ``z=None`` all that are left go to the z axis.
    An explicit list may repeat a device."""
    devices = _visible_cuda() if devices is None else [torch.device(d) for d in devices]
    n = len(devices)
    if z is None:
        if n % batch:
            raise ValueError(f"{n} devices not divisible by batch={batch}")
        z = n // batch
    if batch * z != n:
        raise ValueError(f"mesh {batch}x{z} != {n} devices")
    return Mesh([devices[b * z:(b + 1) * z] for b in range(batch)])


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
    over the mesh rows; otherwise the tiles are row 0's."""

    def __init__(self, mesh: Mesh, shape, tiles: dict, batched: bool, layout: str = "z"):
        self.mesh, self.shape, self.tiles = mesh, tuple(shape), tiles
        self.batched, self.layout = batched, layout
        self._replicas: dict = {}

    @property
    def dtype(self) -> torch.dtype:
        return self.tiles[(0, 0)].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def cells(self) -> list[tuple[int, int]]:
        return self.mesh.cells(None if self.batched else (0,))

    def tile(self, b: int, z: int) -> torch.Tensor:
        """Cell (b, z)'s tile; of an unbatched volume, row 0's tile on that
        cell's device (cached for a constant, a differentiable copy else)."""
        if self.batched or b == 0:
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
        for b, z in self.mesh.cells(None if batched else (0,)):
            dev = self.mesh.device(b, z)
            args = [o.tile(b, z) if isinstance(o, ShardedVolume)
                    else o.to(dev) if isinstance(o, torch.Tensor) else o for o in (self, *others)]
            tiles[(b, z)] = fn(*args)
        return ShardedVolume(self.mesh, shape, tiles, batched, self.layout)

    def sum(self) -> torch.Tensor:
        """The sum of every element, a 0-dim tensor on the mesh's first device:
        each tile's sum, added batch-major then by z."""
        first = self.mesh.first
        parts = [self.tiles[c].sum().to(first) for c in self.cells()]
        return sum(parts[1:], parts[0])

    def sum_frames(self) -> "ShardedVolume":
        """The sum over the leading (frame) axis of a batched volume, an
        unbatched one: each z column's frames added on row 0's device."""
        tiles = {}
        for z in range(self.mesh.shape[Z_AXIS]):
            dev, acc = self.mesh.device(0, z), None
            for b in range(self.mesh.shape[BATCH_AXIS]):
                part = self.tiles[(b, z)].sum(dim=0).to(dev)
                acc = part if acc is None else acc + part
            tiles[(0, z)] = acc
        return ShardedVolume(self.mesh, self.shape[1:], tiles, False, self.layout)

    def amax(self) -> torch.Tensor:
        """The largest element, a 0-dim tensor on the mesh's first device."""
        return torch.stack([self.tiles[c].amax().to(self.mesh.first) for c in self.cells()]).amax()

    def variable(self) -> dict:
        """The tiles the optimizer moves, as a dict keyed (b, z)."""
        return {c: self.tiles[c] for c in self.cells()}

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
    tiles = {}
    for b, z in mesh.cells(None if batched else (0,)):
        t = a if rows is None else a[b * rows:(b + 1) * rows]
        tiles[(b, z)] = send(t.narrow(axis, z * step, step), mesh.device(b, z))
    return ShardedVolume(mesh, a.shape, tiles, batched, layout)


def shard_rows(a: torch.Tensor, mesh: Mesh) -> ShardedVolume:
    """Per-frame values (B, 1, 1, 1) split over the mesh rows only, each row's
    run on every cell of the row (layout "rows")."""
    rows = _split(a.shape[0], mesh.shape[BATCH_AXIS], f"the batch of shape {tuple(a.shape)}")
    tiles = {(b, z): send(a[b * rows:(b + 1) * rows], mesh.device(b, z)) for b, z in mesh.cells()}
    return ShardedVolume(mesh, a.shape, tiles, True, "rows")


def gather(s, device=None) -> torch.Tensor:
    """The global tensor of a sharded volume on ``device`` (default: the
    mesh's first device); a tensor passes through. Differentiable."""
    if not isinstance(s, ShardedVolume):
        return s
    device = s.mesh.first if device is None else device
    nb, nz = s.mesh.shape[BATCH_AXIS], s.mesh.shape[Z_AXIS]
    axis = s.ndim - (3 if s.layout == "z" else 2)
    if s.layout == "rows":
        return torch.cat([s.tiles[(b, 0)].to(device) for b in range(nb)])
    rows = [torch.cat([s.tiles[(b, z)].to(device) for z in range(nz)], dim=axis)
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
