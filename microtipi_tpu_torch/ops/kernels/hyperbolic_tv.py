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
- :class:`HyperbolicTV` and :class:`HyperbolicTVBatched` are the
  ``torch.autograd.Function``s: the forward runs the sweep once and keeps the
  gradient, the backward is ``g * grad`` (per volume for the batch).
- ``launches`` counts single-volume launches and ``batched_launches`` batched
  ones (CPU calls leave both alone); a run sets them to 0 and reads them to
  show which kernel its path went through.

Importing this module needs no ``nvcc`` and no card: the library is built
and loaded at the first launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from microtipi_tpu_torch.ops.regularization import hyperbolic_tv

__all__ = [
    "HyperbolicTV",
    "HyperbolicTVBatched",
    "hyperbolic_tv_batched_fused",
    "hyperbolic_tv_batched_plain",
    "hyperbolic_tv_batched_value",
    "hyperbolic_tv_fused",
    "hyperbolic_tv_plain",
    "hyperbolic_tv_value",
]

#: Single-volume kernel launches since the last reset (``launches = 0``).
launches = 0
#: Batched kernel launches since the last reset (``batched_launches = 0``).
batched_launches = 0


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


@functools.cache
def _library() -> ctypes.CDLL:
    from microtipi_tpu_torch._build import load_library

    lib = load_library("hyperbolic_tv")
    lib.hyperbolic_tv_num_partials.argtypes = [ctypes.c_int] * 4
    lib.hyperbolic_tv_num_partials.restype = ctypes.c_int64
    lib.hyperbolic_tv_f32.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_float] * 4 + [ctypes.c_void_p]
    )
    lib.hyperbolic_tv_f32.restype = ctypes.c_int
    return lib


def _launch(x: torch.Tensor, epsilon: float, scales, batched: bool):
    """One launch over a 3D volume, or over a 4D batch when ``batched``."""
    global launches, batched_launches
    ndim = 4 if batched else 3
    if x.dtype != torch.float32:
        raise TypeError(f"the CUDA hyperbolic-TV kernel takes float32, got {x.dtype}")
    if x.ndim != ndim:
        what = "a 4D batch of volumes" if batched else "a 3D volume"
        raise ValueError(f"this CUDA hyperbolic-TV wrapper takes {what}, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("the CUDA hyperbolic-TV kernel takes a contiguous tensor")
    nb, nz, ny, nx = x.shape if batched else (1, *x.shape)
    lib = _library()
    n_partials = lib.hyperbolic_tv_num_partials(nb, nz, ny, nx)
    if n_partials < 0:
        raise ValueError(f"shape {tuple(x.shape)} needs more than 65535 blocks in grid z "
                         f"(B * ceil(Nz / 16) = {nb * -(-nz // 16)})")
    grad = torch.empty_like(x)
    partials = torch.empty(n_partials, dtype=torch.float64, device=x.device)
    inv_sz, inv_sy, inv_sx = (1.0 / float(s) for s in (scales or (1.0, 1.0, 1.0)))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hyperbolic_tv_f32(x.data_ptr(), grad.data_ptr(), partials.data_ptr(), nb, nz,
                                            ny, nx, float(epsilon), inv_sz, inv_sy, inv_sx, stream)
    if err != 0:
        raise RuntimeError(f"hyperbolic-TV kernel launch failed: cudaError {err}")
    if batched:
        batched_launches += 1
        return partials.view(nb, -1).sum(1).to(torch.float32), grad
    launches += 1
    return torch.sum(partials).to(torch.float32), grad


def hyperbolic_tv_fused(x: torch.Tensor, epsilon: float, scales=None):
    """(cost, gradient) of the hyperbolic TV from one sweep: the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cuda":
        return _launch(x, epsilon, scales, batched=False)
    if x.device.type == "cpu":
        return hyperbolic_tv_plain(x, epsilon, scales)
    raise ValueError(f"hyperbolic_tv_fused runs on CUDA or CPU tensors, got {x.device}")


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
