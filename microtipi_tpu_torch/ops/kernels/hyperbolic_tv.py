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
- :func:`hyperbolic_tv_slab_fused` returns ``(costs (B,), grad)`` of z-slabs
  (B, nz, Ny, Nx) of a volume sharded in z (``parallel/``): the same kernel
  with the plane before the slab and the plane after it (B, Ny, Nx), None
  where the slab starts or ends the volume. The costs are the slab's own
  planes' and the gradient is the whole volume's at the slab's planes, so the
  slabs' costs add up to the volume's and their gradients put together are
  its gradient; :func:`hyperbolic_tv_slab_plain` is its plain version.
- :class:`HyperbolicTV` and :class:`HyperbolicTVBatched` are the
  ``torch.autograd.Function``s: the forward runs the sweep once and keeps the
  gradient, the backward is ``g * grad`` (per volume for the batch).
- ``launches`` counts single-volume launches and ``batched_launches`` batched
  ones and ``slab_launches`` slab ones (CPU calls leave them alone); a run sets them to 0 and reads them to
  show which kernel its path went through. ``unaligned_launches`` counts the
  launches of either kind that took the kernel's 4-byte-copy instantiation
  (nx % 4 != 0, or data not 16-byte aligned) instead of its TMA one.
- :func:`tv_launch` is the one place the launch geometry is decided (tile,
  z range, grid, partials per volume, instantiation); the C launcher refuses
  a grid that disagrees with its tile. :func:`prepare_launch` allocates the
  outputs once and returns a launcher for timing back-to-back launches.
- The kernel sums each volume's cost itself (the last block of the volume),
  so one evaluation is one launch; its per-volume tickets are allocated once
  per device and stream.

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
    "hyperbolic_tv_slab_plain",
    "hyperbolic_tv_value",
]

#: Single-volume kernel launches since the last reset (``launches = 0``).
launches = 0
#: Batched kernel launches since the last reset (``batched_launches = 0``).
batched_launches = 0
#: Slab launches (a z-slab with its halo planes) since the last reset.
slab_launches = 0
#: Launches (of either kind) that took the 4-byte-copy instantiation because
#: nx % 4 != 0 or the data is not 16-byte aligned.
unaligned_launches = 0

# The kernel's tile and the planes a block walks (TV_TX, TV_TY, TV_ZR in
# csrc/hyperbolic_tv.cu, whose launcher refuses a grid built with any
# others), and CUDA's limit on grid y and z.
TILE_X, TILE_Y, Z_RANGE, GRID_LIMIT = 64, 16, 32, 65535
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
    lib.hyperbolic_tv_slab_f32.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_float] * 4 + [ctypes.c_void_p]
    )
    lib.hyperbolic_tv_slab_f32.restype = ctypes.c_int
    return lib


class TvLaunch(NamedTuple):
    """One launch's geometry: the grid (x tiles, y tiles, B * z ranges), the
    z ranges and the cost partials (one per block) of each volume, and
    whether the TMA instantiation (16-byte staging and stores) takes it."""

    grid: tuple[int, int, int]
    ranges: int
    partials: int
    aligned: bool


def tv_launch(shape, data_ptr: int) -> TvLaunch:
    """The launch geometry of a volume (nz, ny, nx) or a batch (B, nz, ny,
    nx) whose data starts at ``data_ptr``. Raises ``ValueError`` where the
    grid does not fit (more than 65535 blocks in y or z)."""
    nb, nz, ny, nx = shape if len(shape) == 4 else (1, *shape)
    ranges = -(-nz // Z_RANGE)
    grid = (-(-nx // TILE_X), -(-ny // TILE_Y), nb * ranges)
    if grid[1] > GRID_LIMIT or grid[2] > GRID_LIMIT:
        raise ValueError(f"shape {tuple(shape)} needs {grid[1]} blocks in grid y and {grid[2]} in grid z "
                         f"(B * ceil(Nz / {Z_RANGE})); the limit is {GRID_LIMIT}")
    aligned = nx % 4 == 0 and data_ptr % 16 == 0
    return TvLaunch(grid, ranges, grid[0] * grid[1] * ranges, aligned)


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
    if h is None:
        return
    want = (x.shape[0], *x.shape[2:])
    if h.dtype != torch.float32 or h.device != x.device or tuple(h.shape) != want or not h.is_contiguous():
        raise ValueError(f"a halo plane of slabs {tuple(x.shape)} is a contiguous float32 {want} on {x.device}, "
                         f"got {h.dtype} {tuple(h.shape)} on {h.device}")


def prepare_launch(x: torch.Tensor, epsilon: float, scales=None, prev=None, next_=None):
    """``(launch, costs, grad, geometry)``: the outputs allocated once and a
    callable that launches the kernel into them on ``x``'s device's current
    stream, for timing back-to-back launches. It counts nothing; ``costs`` is (B,), or
    (1,) for a 3D volume. ``prev``/``next_``: the halo planes of slabs ``x``
    (B, nz, Ny, Nx), each (B, Ny, Nx) or None."""
    _check(x)
    if prev is not None or next_ is not None:
        if x.ndim != 4:
            raise ValueError(f"slabs are 4D (B, nz, Ny, Nx), got shape {tuple(x.shape)}")
        for h in (prev, next_):
            _check_halo(h, x)
    nb, nz, ny, nx = x.shape if x.ndim == 4 else (1, *x.shape)
    geo = tv_launch(x.shape, x.data_ptr())
    geo = geo._replace(aligned=geo.aligned and all(h is None or h.data_ptr() % 16 == 0 for h in (prev, next_)))
    grad = torch.empty_like(x)
    costs = torch.empty(nb, dtype=torch.float32, device=x.device)
    partials = torch.empty(nb * geo.partials, dtype=torch.float64, device=x.device)
    inv_sz, inv_sy, inv_sx = (1.0 / float(s) for s in (scales or (1.0, 1.0, 1.0)))
    fn = _library().hyperbolic_tv_slab_f32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream()
        tickets = _tickets(x.device, stream, nb)
    halos = [None if h is None else h.data_ptr() for h in (prev, next_)]
    args = (x.data_ptr(), *halos, grad.data_ptr(), partials.data_ptr(), costs.data_ptr(), tickets.data_ptr(), nb,
            nz, ny, nx, *geo.grid[:2], geo.ranges, int(geo.aligned), float(epsilon), inv_sz, inv_sy, inv_sx,
            stream.cuda_stream)

    # The default keeps the buffers alive as long as the launcher: it writes through their pointers.
    def launch(_buffers=(x, prev, next_, grad, costs, partials, tickets)) -> None:
        with torch.cuda.device(x.device):  # the stream's device must be current at the launch
            err = fn(*args)
        if err != 0:
            raise RuntimeError(f"hyperbolic-TV kernel launch failed: cudaError {err}")

    return launch, costs, grad, geo


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


def hyperbolic_tv_slab_fused(x: torch.Tensor, prev, next_, epsilon: float, scales=None):
    """(costs (B,), gradient) of z-slabs ``x`` (B, nz, Ny, Nx) with their
    halo planes (B, Ny, Nx, None at the volume's faces): one slab launch for a
    CUDA tensor, :func:`hyperbolic_tv_slab_plain` for a CPU one."""
    global slab_launches, unaligned_launches
    if x.device.type == "cuda":
        if x.ndim != 4:
            raise ValueError(f"slabs are 4D (B, nz, Ny, Nx), got shape {tuple(x.shape)}")
        launch, costs, grad, geo = prepare_launch(x, epsilon, scales, prev, next_)
        launch()
        slab_launches += 1
        unaligned_launches += not geo.aligned
        return costs, grad
    if x.device.type == "cpu":
        return hyperbolic_tv_slab_plain(x, prev, next_, epsilon, scales)
    raise ValueError(f"hyperbolic_tv_slab_fused runs on CUDA or CPU tensors, got {x.device}")


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
