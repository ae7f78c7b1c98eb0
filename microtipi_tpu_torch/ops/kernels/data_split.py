"""The ADMM engine's data split (weighted Gaussian or Poisson): CUDA kernels and plain versions.

The split ``z0 = H x`` of ``jobs/admm.admm_deconvolve`` is pointwise on both
sides of the FFTs, and each side is one hand-written CUDA kernel here
(``csrc/data_split.cu``, whose note has the math and the design); XLA fuses
the same lines of ``step_core`` in ``microtipi_tpu/jobs/admm.py`` on the TPU:

- :func:`data_split_spectrum`: the x-update's spectrum, in place: ``x_hat =
  (x_hat + conj(h) X r0) * inv_den`` and ``X = h x_hat`` (the spectrum of
  ``H x``), with ``x_hat`` holding the spectrum of the right-hand side and
  ``X`` that of ``t = z0 - u0`` on entry.
- :func:`data_split_prox`: everything after ``hx = irfftn(h x_hat)``, in place
  on ``z0`` and ``u0``, writing ``t``: the over-relaxation, the data term's
  pointwise prox (weighted Gaussian ``(wd + r0 v) / (w + r0)``, or the
  Poisson positive root with the background), the dual update, and ``t = z0
  - u0`` for the next iteration's transform.

Both take a batch: the spectra are complex (B, Nz, Ny, Nx // 2 + 1), ``h``
also (Nz, Ny, Nx // 2 + 1) when the lanes share it, ``inv_den`` real of the
spectra's batch shape, the volumes (B, Nz, Ny, Nx), ``r0`` (B,). One volume is
B = 1.

On a CUDA tensor a wrapper launches its kernel (float32 and complex64,
contiguous) or raises; on a CPU tensor it takes the plain version beside it
(:func:`data_split_spectrum_plain`, :func:`data_split_prox_plain`, any dtype).
The kernels keep the plain versions' operation order, so on the card the two
agree bit for bit. The plain prox is the engine's PyTorch lines as they stood
before the kernels; the plain spectrum step is real arithmetic on
``view_as_real``, which can differ from PyTorch's complex multiplication in
the last bit. ``spectrum_launches`` and ``prox_launches`` count kernel
launches (CPU calls leave them alone), ``unaligned_launches`` those of either
kernel's 4-byte instantiation (:func:`vectorized` is false). Importing this
module needs no ``nvcc`` and no card: the library is built and loaded at the
first launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from microtipi_tpu_torch.ops.kernels.admm_split import _launcher, per_lane

__all__ = [
    "data_split_prox",
    "data_split_prox_plain",
    "data_split_spectrum",
    "data_split_spectrum_plain",
    "prepare_prox",
    "prepare_spectrum",
    "vectorized",
]

#: ``data_split_spectrum`` kernel launches since the last reset (``spectrum_launches = 0``).
spectrum_launches = 0
#: ``data_split_prox`` kernel launches since the last reset (``prox_launches = 0``).
prox_launches = 0
#: of both, those of the 4-byte instantiation (a lane's count not a multiple of 4, or a base off 16-byte alignment).
unaligned_launches = 0


def data_split_spectrum_plain(x_hat, sx, h, r0, inv_den) -> None:
    """The spectrum step with PyTorch operators, in place on ``x_hat`` and
    ``sx``: the kernel's plain version, on any device and dtype."""
    xr, sr, hr = (torch.view_as_real(t) for t in (x_hat, sx, h))
    a, b = hr[..., 0], hr[..., 1]
    c, d = sr[..., 0], sr[..., 1]
    rr0 = per_lane(r0)
    re = (xr[..., 0] + (a * c + b * d) * rr0) * inv_den
    im = (xr[..., 1] + (a * d - b * c) * rr0) * inv_den
    sr[..., 0] = a * re - b * im
    sr[..., 1] = a * im + b * re
    xr[..., 0] = re
    xr[..., 1] = im


def data_split_prox_plain(hx, z0, u0, t, r0, alpha: float = 1.0, *, wd=None, weights=None, data=None,
                          background: float = 0.0) -> None:
    """The prox and dual update with PyTorch operators, in place on ``z0`` and
    ``u0``, writing ``t = z0 - u0``: the kernel's plain version, on any
    device and dtype. Weighted Gaussian with ``wd`` and ``weights``, Poisson
    with ``data`` and ``background``."""
    rr0 = per_lane(r0)
    hxr = hx if alpha == 1.0 else alpha * hx + (1.0 - alpha) * z0
    v = hxr + u0
    if data is not None:  # rho z^2 + z (1 + rho (b - v)) + (b - d - rho v b) = 0, the + root
        b_coef = 1.0 + rr0 * (background - v)
        c_coef = background - data - rr0 * v * background
        disc = torch.clamp_min(b_coef * b_coef - 4.0 * rr0 * c_coef, 0.0)
        z = (-b_coef + torch.sqrt(disc)) / (2.0 * rr0)
    else:
        z = (wd + rr0 * v) / (weights + rr0)
    u = u0 + hxr - z
    z0.copy_(z)
    u0.copy_(u)
    torch.sub(z, u, out=t)


@functools.cache
def _library() -> ctypes.CDLL:
    from microtipi_tpu_torch._build import load_library

    lib = load_library("data_split")
    lib.data_split_spectrum_f32.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                                            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.data_split_spectrum_f32.restype = ctypes.c_int
    lib.data_split_prox_f32.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_float] * 3
                                        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.data_split_prox_f32.restype = ctypes.c_int
    return lib


def _check(name: str, first: torch.Tensor, wanted) -> None:
    """``wanted``: (tensor, dtype, shape) triples the kernel takes, contiguous
    on ``first``'s device."""
    if first.ndim != 4:
        raise ValueError(f"the CUDA {name} kernel takes a batch (B, Nz, Ny, Nx), got shape {tuple(first.shape)}")
    for t, dtype, shape in wanted:
        if t.dtype != dtype:
            raise TypeError(f"the CUDA {name} kernel takes {dtype}, got {t.dtype}")
        if t.device != first.device:
            raise ValueError(f"the CUDA {name} kernel takes tensors on one device, got {t.device} and {first.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"the CUDA {name} kernel expected shape {tuple(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"the CUDA {name} kernel takes contiguous tensors")


def vectorized(*tensors) -> bool:
    """Whether a kernel takes its 16-byte instantiation on these tensors (the
    first a batch): a lane's element count a multiple of 4 and every base
    16-byte aligned."""
    first = tensors[0]
    return first[0].numel() % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def prepare_spectrum(x_hat, sx, h, r0, inv_den):
    """A callable that launches the spectrum kernel on these tensors (in
    place, on the current stream), for timing back-to-back launches. It
    counts nothing."""
    nb, spec = x_hat.shape[0], tuple(x_hat.shape[1:])
    shared = h.ndim == 3
    _check("data_split_spectrum", x_hat, [(x_hat, torch.complex64, x_hat.shape), (sx, torch.complex64, x_hat.shape),
                                          (h, torch.complex64, spec if shared else x_hat.shape),
                                          (inv_den, torch.float32, x_hat.shape), (r0, torch.float32, (nb,))])
    args = (x_hat.data_ptr(), sx.data_ptr(), h.data_ptr(), int(shared), inv_den.data_ptr(), r0.data_ptr(), nb,
            x_hat[0].numel(), int(vectorized(x_hat, sx, h, inv_den)))
    return _launcher("data_split_spectrum", _library().data_split_spectrum_f32, args, x_hat.device,
                     (x_hat, sx, h, inv_den, r0))


def _prox_volumes(hx, z0, u0, t, wd, weights, data):
    """(the volumes the prox kernel reads and writes, poisson): ``hx, z0, u0,
    t`` and ``w d`` and the weights (weighted Gaussian), or the data (Poisson)."""
    if data is not None and wd is None and weights is None:
        return [hx, z0, u0, t, data], True
    if data is None and wd is not None and weights is not None:
        return [hx, z0, u0, t, wd, weights], False
    raise ValueError("data_split_prox takes wd and weights (weighted Gaussian) or data (Poisson)")


def prepare_prox(hx, z0, u0, t, r0, alpha: float = 1.0, *, wd=None, weights=None, data=None,
                 background: float = 0.0):
    """A callable that launches the prox kernel on these tensors (in place, on
    the current stream), for timing back-to-back launches. It counts
    nothing."""
    volumes, poisson = _prox_volumes(hx, z0, u0, t, wd, weights, data)
    _check("data_split_prox", hx, [(v, torch.float32, hx.shape) for v in volumes]
           + [(r0, torch.float32, (hx.shape[0],))])
    alpha = float(alpha)
    w = 0 if poisson else weights.data_ptr()
    args = (*(v.data_ptr() for v in volumes[:5]), w, r0.data_ptr(), hx.shape[0], hx[0].numel(), alpha, 1.0 - alpha,
            float(background), int(alpha != 1.0), int(poisson), int(vectorized(*volumes)))
    return _launcher("data_split_prox", _library().data_split_prox_f32, args, hx.device, (*volumes, r0))


def data_split_spectrum(x_hat, sx, h, r0, inv_den) -> None:
    """The x-update's spectrum on the data-split path, in place: ``x_hat =
    (x_hat + conj(h) sx r0) * inv_den``, then ``sx = h x_hat``. The CUDA
    kernel for CUDA tensors, the plain version for CPU ones. ``h`` is one
    spectrum a lane or one shared by the lanes, ``r0`` (B,) the data split's
    rho per lane."""
    global spectrum_launches, unaligned_launches
    if x_hat.device.type == "cuda":
        prepare_spectrum(x_hat, sx, h, r0, inv_den)()
        spectrum_launches += 1
        unaligned_launches += not vectorized(x_hat, sx, h, inv_den)
    elif x_hat.device.type == "cpu":
        data_split_spectrum_plain(x_hat, sx, h, r0, inv_den)
    else:
        raise ValueError(f"data_split_spectrum runs on CUDA or CPU tensors, got {x_hat.device}")


def data_split_prox(hx, z0, u0, t, r0, alpha: float = 1.0, *, wd=None, weights=None, data=None,
                    background: float = 0.0) -> None:
    """The data split's prox and dual update from ``hx = H x``, in place on
    ``z0`` and ``u0``, writing ``t = z0 - u0``: the CUDA kernel for CUDA
    tensors, the plain version for CPU ones. ``alpha`` is the
    over-relaxation; ``wd`` and ``weights`` give the weighted Gaussian prox,
    ``data`` and ``background`` the Poisson one."""
    global prox_launches, unaligned_launches
    if hx.device.type == "cuda":
        prepare_prox(hx, z0, u0, t, r0, alpha, wd=wd, weights=weights, data=data, background=background)()
        prox_launches += 1
        unaligned_launches += not vectorized(*_prox_volumes(hx, z0, u0, t, wd, weights, data)[0])
    elif hx.device.type == "cpu":
        data_split_prox_plain(hx, z0, u0, t, r0, alpha, wd=wd, weights=weights, data=data, background=background)
    else:
        raise ValueError(f"data_split_prox runs on CUDA or CPU tensors, got {hx.device}")
