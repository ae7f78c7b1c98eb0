"""Fused hyperbolic-TV cost and gradient: CUDA kernel wrapper and plain version.

Port of ``microtipi_tpu/ops/pallas/hyperbolic_tv.py`` (``hyperbolic_tv_value``
and ``hyperbolic_tv_fused``, :290-314). The CUDA source is
``csrc/hyperbolic_tv.cu``; its note says which Pallas kernels it replaces and
why it is shaped as it is. The batched variant ``_tv_kernel_flat`` is not
ported yet (ROADMAP.md queue 2).

- :func:`hyperbolic_tv_fused` returns ``(cost, grad)``. On a CUDA tensor it
  launches the kernel (float32, contiguous, 3D) or raises; on a CPU tensor it
  takes :func:`hyperbolic_tv_plain`, the autograd of
  ``ops.regularization.hyperbolic_tv``.
- :class:`HyperbolicTV` is the ``torch.autograd.Function``: its forward runs
  the sweep once and keeps the gradient, its backward is ``g * grad``.
- ``launches`` counts kernel launches (CPU calls leave it alone); a run sets
  it to 0 and reads it to show that its main path went through the kernel.

Importing this module needs no ``nvcc`` and no card: the library is built
and loaded at the first launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from microtipi_tpu_torch.ops.regularization import hyperbolic_tv

__all__ = ["HyperbolicTV", "hyperbolic_tv_fused", "hyperbolic_tv_plain", "hyperbolic_tv_value"]

#: Kernel launches since the last reset (``launches = 0``).
launches = 0


def hyperbolic_tv_plain(x: torch.Tensor, epsilon: float, scales=None):
    """(cost, grad) from autograd of the plain definition — the kernel's
    plain version, on any device and dtype."""
    with torch.enable_grad():
        xv = x.detach().requires_grad_(True)
        cost = hyperbolic_tv(xv, epsilon, scales)
        (grad,) = torch.autograd.grad(cost, xv)
    return cost.detach(), grad


@functools.cache
def _library() -> ctypes.CDLL:
    from microtipi_tpu_torch._build import load_library

    lib = load_library("hyperbolic_tv")
    lib.hyperbolic_tv_num_partials.argtypes = [ctypes.c_int] * 3
    lib.hyperbolic_tv_num_partials.restype = ctypes.c_int64
    lib.hyperbolic_tv_f32.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float] * 4 + [ctypes.c_void_p]
    )
    lib.hyperbolic_tv_f32.restype = ctypes.c_int
    return lib


def _launch(x: torch.Tensor, epsilon: float, scales):
    global launches
    if x.dtype != torch.float32:
        raise TypeError(f"the CUDA hyperbolic-TV kernel takes float32, got {x.dtype}")
    if x.ndim != 3:
        raise ValueError(f"the CUDA hyperbolic-TV kernel takes a 3D volume, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("the CUDA hyperbolic-TV kernel takes a contiguous tensor")
    nz, ny, nx = x.shape
    lib = _library()
    grad = torch.empty_like(x)
    partials = torch.empty(lib.hyperbolic_tv_num_partials(nz, ny, nx),
                           dtype=torch.float64, device=x.device)
    inv_sz, inv_sy, inv_sx = (1.0 / float(s) for s in (scales or (1.0, 1.0, 1.0)))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hyperbolic_tv_f32(x.data_ptr(), grad.data_ptr(), partials.data_ptr(),
                                    nz, ny, nx, float(epsilon), inv_sz, inv_sy, inv_sx, stream)
    if err != 0:
        raise RuntimeError(f"hyperbolic_tv_f32 launch failed: cudaError {err}")
    launches += 1
    return torch.sum(partials).to(torch.float32), grad


def hyperbolic_tv_fused(x: torch.Tensor, epsilon: float, scales=None):
    """(cost, gradient) of the hyperbolic TV from one sweep: the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cuda":
        return _launch(x, epsilon, scales)
    if x.device.type == "cpu":
        return hyperbolic_tv_plain(x, epsilon, scales)
    raise ValueError(f"hyperbolic_tv_fused runs on CUDA or CPU tensors, got {x.device}")


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


def hyperbolic_tv_value(x: torch.Tensor, epsilon: float, scales=None) -> torch.Tensor:
    """Drop-in for ``ops.regularization.hyperbolic_tv`` on 3D volumes."""
    return HyperbolicTV.apply(x, epsilon, scales)
