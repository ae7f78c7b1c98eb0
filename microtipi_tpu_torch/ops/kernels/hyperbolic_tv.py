"""Fused hyperbolic-TV cost and gradient: CUDA kernel wrapper and plain version.

Port of ``microtipi_tpu/ops/pallas/hyperbolic_tv.py`` (``hyperbolic_tv_value``
and ``hyperbolic_tv_fused``, :290-314, and the batched ``_tv_pallas_batched``,
:229-266, that its ``custom_vmap`` rule reaches). The CUDA source is
``csrc/hyperbolic_tv.cu``; its note says which Pallas kernels it replaces and
why it is shaped as it is.

- :func:`hyperbolic_tv_fused` returns ``(cost, grad)`` of one volume. On a
  CUDA tensor it launches the kernel (float32, contiguous, 3D) or raises; on
  a CPU tensor it takes :func:`hyperbolic_tv_plain`, the autograd of
  ``ops.regularization.hyperbolic_tv``.
- :func:`hyperbolic_tv_batched_fused` returns ``(costs (B,), grad)`` of a
  batch (B, Nz, Ny, Nx), no difference crossing a volume boundary: one launch
  of the same kernel with the batch on its grid (float32, contiguous, 4D), or
  :func:`hyperbolic_tv_batched_plain` for a CPU tensor.
- :func:`hyperbolic_tv_slab_group` returns ``(costs, grads)`` of up to
  ``GROUP_SLABS`` z-slabs (B, nz_s, Ny, Nx) of volumes sharded in z
  (``parallel/``), each with the plane before it and the plane after it (B,
  Ny, Nx), None where the slab starts or ends the volume: one grouped launch
  of the kernel's slab entry. A halo plane that is a view into one of the
  group's slabs (a neighbouring slab on the same device) is read in place
  through that slab's tensor map; any other (a copy from another device) is
  a map of its own. The costs are each slab's own planes' and each gradient
  is the whole volume's at the slab's planes, so the slabs' costs add up to
  the volume's and their gradients put together are its gradient; how the
  slabs are grouped changes no bit. :func:`hyperbolic_tv_slab_group_plain` is
  its plain version. :func:`hyperbolic_tv_slab_fused` is the group of one
  slab, :func:`hyperbolic_tv_slab_plain` its plain version.
- :class:`HyperbolicTV` and :class:`HyperbolicTVBatched` are the
  ``torch.autograd.Function``s: the forward runs the sweep once and keeps the
  gradient, the backward is ``g * grad`` (per volume for the batch).
- ``launches`` counts single-volume launches, ``batched_launches`` batched
  ones, ``slab_launches`` grouped slab launches and ``slabs_launched`` the
  slabs they covered (CPU calls leave them alone); a run sets them to 0 and
  reads them to show which kernel its path went through.
  ``unaligned_launches`` counts the launches of any kind that took the
  kernel's 4-byte-copy instantiation (nx % 4 != 0, or data not 16-byte
  aligned) instead of its TMA one.
- :func:`tv_launch` is the one place the launch geometry is decided (tile,
  z range, grid, partials per volume, instantiation): whole volumes walk
  ``Z_RANGE`` planes a block, the slabs of a grouped launch the longest of
  ``SLAB_Z_RANGES`` that gives the launch ``SLAB_BLOCKS`` blocks, their costs
  summed in chunks of ``COST_PLANES`` planes so that no result depends on
  the z range; the C launchers refuse a grid that disagrees with the tile
  and the z range they are given.
  :func:`prepare_launch` and :func:`prepare_slabs` allocate the outputs once
  and return a launcher for timing back-to-back launches.
- The kernel sums each volume's (or slab's) cost itself (its last block),
  so one evaluation is one launch; the tickets are allocated once per device
  and stream.

Importing this module needs no ``nvcc`` and no card: the library is built
and loaded at the first launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from microtipi_tpu_torch.ops.regularization import _forward_diffs, hyperbolic_tv

__all__ = [
    "HyperbolicTV",
    "HyperbolicTVBatched",
    "hyperbolic_tv_batched_fused",
    "hyperbolic_tv_batched_plain",
    "hyperbolic_tv_batched_value",
    "hyperbolic_tv_fused",
    "hyperbolic_tv_plain",
    "hyperbolic_tv_slab_fused",
    "hyperbolic_tv_slab_group",
    "hyperbolic_tv_slab_group_plain",
    "hyperbolic_tv_slab_plain",
    "hyperbolic_tv_value",
]

#: Single-volume kernel launches since the last reset (``launches = 0``).
launches = 0
#: Batched kernel launches since the last reset (``batched_launches = 0``).
batched_launches = 0
#: Grouped slab launches (z-slabs with their halo planes) since the last reset.
slab_launches = 0
#: Slabs those launches covered.
slabs_launched = 0
#: Launches (of either kind) that took the 4-byte-copy instantiation because
#: nx % 4 != 0 or the data is not 16-byte aligned.
unaligned_launches = 0

# The kernel's tile and the planes a block of the whole-volume launch walks
# (TV_TX, TV_TY, TV_ZR in csrc/hyperbolic_tv.cu, whose launcher refuses a
# grid built with any others), and CUDA's limit on grid y and z.
TILE_X, TILE_Y, Z_RANGE, GRID_LIMIT = 64, 16, 32, 65535
#: The z ranges the blocks of a grouped slab launch may walk, longest first
#: (multiples of COST_PLANES, TV_COST_PLANES: the planes of a cost partial),
#: and the blocks a launch should reach: about 4 resident an SM on the H100's
#: 132 (the grouped kernel's register cap, TV_GROUP_BLOCKS_PER_SM).
SLAB_Z_RANGES, SLAB_BLOCKS, COST_PLANES = (32, 16, 8, 4), 512, 4
#: Slabs that one grouped launch's table holds (TV_GROUP_SLABS; its
#: TV_GROUP_MAPS tensor maps take every slab's and two halo buffers a slab).
GROUP_SLABS = 8
_TICKETS: dict = {}


def hyperbolic_tv_plain(x: torch.Tensor, epsilon: float, scales=None):
    """(cost, grad) from autograd of the plain definition — the kernel's
    plain version, on any device and dtype."""
    with torch.enable_grad():
        xv = x.detach().requires_grad_(True)
        cost = hyperbolic_tv(xv, epsilon, scales)
        (grad,) = torch.autograd.grad(cost, xv)
    return cost.detach(), grad


def hyperbolic_tv_batched_plain(x: torch.Tensor, epsilon: float, scales=None):
    """(costs (B,), grad) of a batch (B, Nz, Ny, Nx): autograd of the plain
    definition over the last three axes, one cost per volume — the batched
    kernel's plain version, on any device and dtype."""
    if x.ndim != 4:
        raise ValueError(f"a batch of volumes is 4D, got shape {tuple(x.shape)}")
    with torch.enable_grad():
        xv = x.detach().requires_grad_(True)
        costs = torch.stack([hyperbolic_tv(v, epsilon, scales, axes=(-3, -2, -1)) for v in xv.unbind(0)])
        (grad,) = torch.autograd.grad(costs.sum(), xv)
    return costs.detach(), grad


def hyperbolic_tv_slab_group_plain(slabs, prevs, nexts, epsilon: float, scales=None):
    """(costs, grads) lists of :func:`hyperbolic_tv_slab_plain` over the
    slabs and their halo planes: the grouped launch's plain version."""
    out = [hyperbolic_tv_slab_plain(x, p, n, epsilon, scales) for x, p, n in zip(slabs, prevs, nexts, strict=True)]
    return [c for c, _ in out], [g for _, g in out]


def hyperbolic_tv_slab_plain(x: torch.Tensor, prev, next_, epsilon: float, scales=None):
    """(costs (B,), grad) of z-slabs ``x`` (B, nz, Ny, Nx) with their halo
    planes ``prev`` and ``next_`` (B, Ny, Nx, or None at the volume's faces),
    by autograd of the plain definition — the slab launch's plain version, on
    any device and dtype. The costs sum the slab's own planes; the gradient is
    that of the plane before the slab and the slab's own planes together,
    which is the whole volume's gradient at the slab's planes."""
    if x.ndim != 4:
        raise ValueError(f"slabs are 4D (B, nz, Ny, Nx), got shape {tuple(x.shape)}")
    lo = int(prev is not None)
    with torch.enable_grad():
        xv = x.detach().requires_grad_(True)
        ext = torch.cat([h.detach()[:, None] for h in (prev,) if h is not None] + [xv]
                        + [h.detach()[:, None] for h in (next_,) if h is not None], dim=1)
        g2 = sum(d * d for d in _forward_diffs(ext, scales, (1, 2, 3)))
        eps = float(epsilon)
        terms = torch.sqrt(g2 + eps * eps) - eps
        costs = terms[:, lo:lo + x.shape[1]].sum(dim=(1, 2, 3))
        (grad,) = torch.autograd.grad(terms[:, :lo + x.shape[1]].sum(), xv)
    return costs.detach(), grad


@functools.cache
def _library() -> ctypes.CDLL:
    from microtipi_tpu_torch._build import load_library

    lib = load_library("hyperbolic_tv")
    lib.hyperbolic_tv_f32.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float] * 4
                                      + [ctypes.c_void_p])
    lib.hyperbolic_tv_f32.restype = ctypes.c_int
    lib.hyperbolic_tv_group_f32.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                                            + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    lib.hyperbolic_tv_group_f32.restype = ctypes.c_int
    return lib


class TvLaunch(NamedTuple):
    """One volume's (or slab's) geometry: its grid (x tiles, y tiles, B * z
    ranges), the z ranges and the cost partials (one a block; a slab's one
    a tile and COST_PLANES planes) of each volume, whether the TMA
    instantiation (16-byte staging and stores) takes it, and the planes a
    block walks."""

    grid: tuple[int, int, int]
    ranges: int
    partials: int
    aligned: bool
    z_range: int


def tv_launch(shape, data_ptr: int, group=None) -> TvLaunch:
    """The launch geometry of a volume (nz, ny, nx) or a batch (B, nz, ny,
    nx) whose data starts at ``data_ptr``: ``Z_RANGE`` planes a block, or, as
    one of the z-slabs (B, nz_s, ny, nx) of a grouped launch whose shapes are
    ``group``, the longest of ``SLAB_Z_RANGES`` that gives the launch at
    least ``SLAB_BLOCKS`` blocks, else the shortest. Raises ``ValueError``
    where the grid does not fit (more than 65535 blocks in y or z)."""
    nb, nz, ny, nx = shape if len(shape) == 4 else (1, *shape)
    gx, gy = -(-nx // TILE_X), -(-ny // TILE_Y)
    z_range = Z_RANGE
    if group is not None:
        z_range = next((zr for zr in SLAB_Z_RANGES
                        if sum(g[0] * gx * gy * -(-g[1] // zr) for g in group) >= SLAB_BLOCKS), SLAB_Z_RANGES[-1])
    ranges = -(-nz // z_range)
    grid = (gx, gy, nb * ranges)
    if grid[1] > GRID_LIMIT or grid[2] > GRID_LIMIT:
        raise ValueError(f"shape {tuple(shape)} needs {grid[1]} blocks in grid y and {grid[2]} in grid z "
                         f"(B * ceil(Nz / {z_range})); the limit is {GRID_LIMIT}")
    aligned = nx % 4 == 0 and data_ptr % 16 == 0
    partials = gx * gy * (ranges if group is None else -(-nz // COST_PLANES))
    return TvLaunch(grid, ranges, partials, aligned, z_range)


class TvGroupLaunch(NamedTuple):
    """A grouped slab launch's geometry: the grid (x tiles, y tiles, the
    slabs' grid z summed), each slab's :class:`TvLaunch`, the tensor maps of
    its table, and whether the TMA instantiation takes it."""

    grid: tuple[int, int, int]
    slabs: tuple
    maps: int
    aligned: bool


def _tickets(device: torch.device, stream, nb: int) -> torch.Tensor:
    """The kernel's per-volume tickets on ``stream``: zero, kept zero by
    every launch, allocated once and grown as batches grow."""
    key = (device, stream.cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < nb:
        t = _TICKETS[key] = torch.zeros(max(nb, 64), dtype=torch.int32, device=device)
    return t


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"the CUDA hyperbolic-TV kernel takes float32, got {x.dtype}")
    if x.ndim not in (3, 4):
        raise ValueError(f"the CUDA hyperbolic-TV kernel takes a 3D volume or a 4D batch, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("the CUDA hyperbolic-TV kernel takes a contiguous tensor")


def _check_halo(h, x: torch.Tensor) -> None:
    """A halo plane of slabs ``x``: float32 (B, Ny, Nx) on x's device, each
    plane's rows contiguous and its planes a whole number of planes apart."""
    if h is None:
        return
    want, plane = (x.shape[0], *x.shape[2:]), x.shape[2] * x.shape[3]
    if (h.dtype != torch.float32 or h.device != x.device or tuple(h.shape) != want or h.stride(2) != 1
            or h.stride(1) != x.shape[3] or (want[0] > 1 and h.stride(0) % plane)):
        raise ValueError(f"a halo plane of slabs {tuple(x.shape)} is a float32 {want} of whole planes on {x.device}, "
                         f"got {h.dtype} {tuple(h.shape)}, strides {h.stride()}, on {h.device}")


def _launcher(fn, args, buffers, device):
    """A callable that launches ``fn(*args)`` on ``device``; it keeps
    ``buffers`` alive as long as itself, since it writes through their pointers."""

    def launch(_buffers=buffers) -> None:
        with torch.cuda.device(device):  # the stream's device must be current at the launch
            err = fn(*args)
        if err != 0:
            raise RuntimeError(f"hyperbolic-TV kernel launch failed: cudaError {err}")

    return launch


def _inverse_scales(scales):
    return tuple(1.0 / float(s) for s in (scales or (1.0, 1.0, 1.0)))


def prepare_launch(x: torch.Tensor, epsilon: float, scales=None):
    """``(launch, costs, grad, geometry)`` of whole volumes: the outputs
    allocated once and a callable that launches the kernel into them on
    ``x``'s device's current stream, for timing back-to-back launches. It
    counts nothing; ``costs`` is (B,), or (1,) for a 3D volume."""
    _check(x)
    nb, nz, ny, nx = x.shape if x.ndim == 4 else (1, *x.shape)
    geo = tv_launch(x.shape, x.data_ptr())
    grad = torch.empty_like(x)
    costs = torch.empty(nb, dtype=torch.float32, device=x.device)
    partials = torch.empty(nb * geo.partials, dtype=torch.float64, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream()
        tickets = _tickets(x.device, stream, nb)
    args = (x.data_ptr(), grad.data_ptr(), partials.data_ptr(), costs.data_ptr(), tickets.data_ptr(), nb, nz, ny,
            nx, *geo.grid[:2], geo.ranges, int(geo.aligned), float(epsilon), *_inverse_scales(scales),
            stream.cuda_stream)
    launch = _launcher(_library().hyperbolic_tv_f32, args, (x, grad, costs, partials, tickets), x.device)
    return launch, costs, grad, geo


def _source(h, slabs, maps: list) -> tuple[int, int, int]:
    """(map, z0, zstep) of halo plane ``h`` in a grouped launch's table: a
    view into one of ``slabs`` is read in place through that slab's map;
    any other plane gets a map of its own, appended to ``maps`` as (tensor,
    base pointer, planes). (-1, 0, 0) for None, the volume's face."""
    if h is None:
        return -1, 0, 0
    nb, ny, nx = h.shape
    pbytes = ny * nx * 4
    for j, t in enumerate(slabs):
        nz, off = t.shape[1], h.data_ptr() - t.data_ptr()
        if 0 <= off and off % pbytes == 0 and off // pbytes < nz and (nb == 1 or h.stride(0) == nz * ny * nx):
            return j, off // pbytes, nz
    zstep = h.stride(0) // (ny * nx) if nb > 1 else 1
    maps.append((h, h.data_ptr(), (nb - 1) * zstep + 1))
    return len(maps) - 1, 0, zstep


def prepare_slabs(slabs, prevs, nexts, epsilon: float, scales=None):
    """``(launch, costs, grads, geometry)`` of one grouped slab launch over
    ``slabs`` (1 to ``GROUP_SLABS`` contiguous float32 (B, nz_s, Ny, Nx) on
    one device) with their halo planes ``prevs``/``nexts`` (each (B, Ny, Nx)
    or None): the outputs allocated once (``costs`` a (B,) tensor a slab)
    and a launcher as :func:`prepare_launch`'s. It counts nothing."""
    slabs, prevs, nexts = list(slabs), list(prevs), list(nexts)
    if not 1 <= len(slabs) <= GROUP_SLABS or len(prevs) != len(slabs) or len(nexts) != len(slabs):
        raise ValueError(f"a grouped slab launch takes 1 to {GROUP_SLABS} slabs with a prev and a next halo "
                         f"plane (or None) each, got {len(slabs)}, {len(prevs)} and {len(nexts)}")
    first = slabs[0]
    for t in slabs:
        _check(t)
        if t.ndim != 4 or t.device != first.device or (t.shape[0], *t.shape[2:]) != (first.shape[0],
                                                                                       *first.shape[2:]):
            raise ValueError(f"the slabs of a grouped launch are 4D (B, nz, Ny, Nx) of one B, Ny, Nx on one "
                             f"device, got {tuple(t.shape)} on {t.device} beside {tuple(first.shape)} on "
                             f"{first.device}")
    for h in prevs + nexts:
        _check_halo(h, first)
    nb, _, ny, nx = first.shape
    geos = tuple(tv_launch(t.shape, t.data_ptr(), [tuple(u.shape) for u in slabs]) for t in slabs)
    maps = [(t, t.data_ptr(), nb * t.shape[1]) for t in slabs]
    sources = [v for p, n in zip(prevs, nexts) for h in (p, n) for v in _source(h, slabs, maps)]
    grid = (*geos[0].grid[:2], sum(g.grid[2] for g in geos))
    if grid[2] > GRID_LIMIT:
        raise ValueError(f"slabs {[tuple(t.shape) for t in slabs]} need {grid[2]} blocks in grid z together; "
                         f"the limit is {GRID_LIMIT}")
    aligned = nx % 4 == 0 and all(ptr % 16 == 0 for _, ptr, _ in maps)
    geo = TvGroupLaunch(grid, geos, len(maps), aligned)
    dev = first.device
    grads = [torch.empty_like(t) for t in slabs]
    costs = torch.empty((len(slabs), nb), dtype=torch.float32, device=dev)
    partials = torch.empty(nb * sum(g.partials for g in geos), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream()
        tickets = _tickets(dev, stream, len(slabs) * nb)

    def array(ctype, values):
        return (ctype * len(values))(*values)

    args = (len(slabs), len(maps), array(ctypes.c_void_p, [ptr for _, ptr, _ in maps]),
            array(ctypes.c_longlong, [depth for _, _, depth in maps]),
            array(ctypes.c_void_p, [g.data_ptr() for g in grads]), array(ctypes.c_int, [t.shape[1] for t in slabs]),
            array(ctypes.c_int, sources), partials.data_ptr(), costs.data_ptr(), tickets.data_ptr(), nb, ny, nx,
            geos[0].z_range, *grid, int(aligned), float(epsilon), *_inverse_scales(scales), stream.cuda_stream)
    buffers = ([m for m, _, _ in maps], grads, costs, partials, tickets)
    launch = _launcher(_library().hyperbolic_tv_group_f32, args, buffers, dev)
    return launch, list(costs.unbind(0)), grads, geo


def _launch(x: torch.Tensor, epsilon: float, scales, batched: bool):
    """One launch over a 3D volume, or over a 4D batch when ``batched``."""
    global launches, batched_launches, unaligned_launches
    if x.ndim != (4 if batched else 3):
        what = "a 4D batch of volumes" if batched else "a 3D volume"
        raise ValueError(f"this CUDA hyperbolic-TV wrapper takes {what}, got shape {tuple(x.shape)}")
    launch, costs, grad, geo = prepare_launch(x, epsilon, scales)
    launch()
    unaligned_launches += not geo.aligned
    if batched:
        batched_launches += 1
        return costs, grad
    launches += 1
    return costs.reshape(()), grad


def hyperbolic_tv_fused(x: torch.Tensor, epsilon: float, scales=None):
    """(cost, gradient) of the hyperbolic TV from one sweep: the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cuda":
        return _launch(x, epsilon, scales, batched=False)
    if x.device.type == "cpu":
        return hyperbolic_tv_plain(x, epsilon, scales)
    raise ValueError(f"hyperbolic_tv_fused runs on CUDA or CPU tensors, got {x.device}")


def hyperbolic_tv_slab_group(slabs, prevs, nexts, epsilon: float, scales=None):
    """(costs, gradients) lists of z-slabs (B, nz_s, Ny, Nx) with their halo
    planes (B, Ny, Nx, None at the volume's faces), a (B,) cost a slab: one
    grouped launch for CUDA tensors (1 to ``GROUP_SLABS`` slabs of one
    device), :func:`hyperbolic_tv_slab_group_plain` for CPU ones."""
    global slab_launches, slabs_launched, unaligned_launches
    kinds = {t.device.type for t in slabs}
    if kinds == {"cuda"}:
        launch, costs, grads, geo = prepare_slabs(slabs, prevs, nexts, epsilon, scales)
        launch()
        slab_launches += 1
        slabs_launched += len(grads)
        unaligned_launches += not geo.aligned
        return costs, grads
    if kinds == {"cpu"}:
        return hyperbolic_tv_slab_group_plain(slabs, prevs, nexts, epsilon, scales)
    raise ValueError(f"hyperbolic_tv_slab_group runs on CUDA or CPU tensors of one kind, got {kinds}")


def hyperbolic_tv_slab_fused(x: torch.Tensor, prev, next_, epsilon: float, scales=None):
    """(costs (B,), gradient) of z-slabs ``x`` (B, nz, Ny, Nx) with their
    halo planes (B, Ny, Nx, None at the volume's faces): the grouped launch
    of one slab for a CUDA tensor, :func:`hyperbolic_tv_slab_plain` for a CPU
    one."""
    if x.ndim != 4:
        raise ValueError(f"slabs are 4D (B, nz, Ny, Nx), got shape {tuple(x.shape)}")
    (costs,), (grad,) = hyperbolic_tv_slab_group([x], [prev], [next_], epsilon, scales)
    return costs, grad


def hyperbolic_tv_batched_fused(x: torch.Tensor, epsilon: float, scales=None):
    """(costs (B,), gradient) of a batch (B, Nz, Ny, Nx) from one sweep: the
    batched CUDA launch for a CUDA tensor, the plain version for a CPU one."""
    if x.device.type == "cuda":
        return _launch(x, epsilon, scales, batched=True)
    if x.device.type == "cpu":
        return hyperbolic_tv_batched_plain(x, epsilon, scales)
    raise ValueError(f"hyperbolic_tv_batched_fused runs on CUDA or CPU tensors, got {x.device}")


class HyperbolicTV(torch.autograd.Function):
    """Differentiable fused hyperbolic TV: the sweep runs once in forward and
    the backward reuses its gradient (``hyperbolic_tv.py:290-309``)."""

    @staticmethod
    def forward(ctx, x, epsilon, scales):
        cost, grad = hyperbolic_tv_fused(x, epsilon, scales)
        ctx.save_for_backward(grad)
        return cost

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return g * grad, None, None


class HyperbolicTVBatched(torch.autograd.Function):
    """The batched counterpart: costs (B,) in forward, ``g[b] * grad[b]`` per
    volume in backward."""

    @staticmethod
    def forward(ctx, x, epsilon, scales):
        costs, grad = hyperbolic_tv_batched_fused(x, epsilon, scales)
        ctx.save_for_backward(grad)
        return costs

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return g[:, None, None, None] * grad, None, None


def hyperbolic_tv_value(x: torch.Tensor, epsilon: float, scales=None) -> torch.Tensor:
    """Drop-in for ``ops.regularization.hyperbolic_tv`` on 3D volumes."""
    return HyperbolicTV.apply(x, epsilon, scales)


def hyperbolic_tv_batched_value(x: torch.Tensor, epsilon: float, scales=None) -> torch.Tensor:
    """Per-volume hyperbolic TV (B,) of a batch (B, Nz, Ny, Nx), differentiable."""
    return HyperbolicTVBatched.apply(x, epsilon, scales)
