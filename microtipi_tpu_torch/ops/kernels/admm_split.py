"""The ADMM engine's split update and right-hand side: CUDA kernels and plain versions.

The two pieces of ``step_core`` in ``microtipi_tpu/jobs/admm.py`` that XLA
fuses under ``jit`` on the TPU, each one hand-written CUDA kernel here
(``csrc/admm_split.cu``, whose note has the math and the design):

- :func:`admm_split_update`: everything after the x-update for the splits
  ``z1 = Dx`` and ``z2 = x`` (``admm.py:353-368``), in place on ``z1, u1, z2,
  u2``: circular differences, over-relaxation, the masked gradient magnitude,
  the Newton hyperbolic prox, the positivity clamp and the dual updates.
- :func:`admm_rhs`: the x-update's right-hand side (``admm.py:330-331``),
  ``rho1 * D^T(z1 - u1) + rho2 * (z2 - u2)``.
- :func:`admm_split_update_slab` and :func:`admm_rhs_slab`: the same two
  kernels on a z-slab of a volume sharded in z (``parallel/admm.py``), with
  the neighbouring slabs' planes: x's plane after the slab, for the split
  update (around the ring after the volume's last plane), whose z mask is the
  volume's last plane (``z_off``, ``nz``: the slab's global offset and the
  volume's depth); ``z1_z``, ``u1_z`` at the plane before the slab, for the
  rhs. The slabs' outputs put together are the whole volume's, bit for bit.

Both take a batch: ``x``, ``z2``, ``u2`` are (B, Nz, Ny, Nx), ``z1`` and ``u1``
(B, 3, Nz, Ny, Nx) with the difference axis second, and ``lam = mu / rho1``,
``rho1``, ``rho2`` are (B,) tensors, one value a lane. One volume is B = 1.

On a CUDA tensor a wrapper launches its kernel (float32, contiguous) or
raises; on a CPU tensor it takes the plain version beside it
(:func:`admm_split_update_plain`, :func:`admm_rhs_plain`: the JAX lines with
``torch.roll``, any dtype and device). The kernels keep the plain versions'
operation order, and both multiply by the scales' reciprocals
(:func:`reciprocals`), so on the card the two agree bit for bit.
``split_launches`` and ``rhs_launches`` count kernel launches, and
``split_slab_launches`` and ``rhs_slab_launches`` slab launches (CPU calls leave
them alone); a run sets them to 0 and reads them to show that its path went
through the kernels. ``split_unaligned_launches`` counts the split update's
4-byte instantiation (:func:`split_vectorized` is false).

:func:`circ_diffs`, :func:`circ_diffs_adjoint`, :func:`hyperbolic_prox`,
:func:`split_magnitude` and :func:`split_apply` are the plain building blocks,
which the engines also use outside the kernels: the joint TV's prox takes one
magnitude over a voxel's channels (``split_magnitude(group=...)``), which is
not the kernel's function.
Importing this module needs no ``nvcc`` and no card: the library is built and
loaded at the first launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = [
    "admm_rhs",
    "admm_rhs_plain",
    "admm_rhs_slab",
    "admm_rhs_slab_plain",
    "admm_split_update",
    "admm_split_update_plain",
    "admm_split_update_slab",
    "admm_split_update_slab_plain",
    "circ_diffs",
    "circ_diffs_adjoint",
    "hyperbolic_prox",
    "per_lane",
    "reciprocals",
    "split_apply",
    "split_magnitude",
]

#: ``admm_split_update`` kernel launches since the last reset (``split_launches = 0``).
split_launches = 0
#: ``admm_rhs`` kernel launches since the last reset (``rhs_launches = 0``).
rhs_launches = 0
#: Slab launches of the split update and the rhs since the last reset.
split_slab_launches = 0
rhs_slab_launches = 0
#: of ``split_launches`` and ``split_slab_launches``, those of the 4-byte instantiation (nx % 4 != 0 or a base
#: off 16-byte alignment).
split_unaligned_launches = 0

NEWTON_ITERS = 8  # ADMM_NEWTON in csrc/admm_split.cu


def reciprocals(scales, dtype: torch.dtype = torch.float32) -> tuple[float, float, float]:
    """``1 / s`` for each scale, in double and rounded to ``dtype``: for
    float32 the number PyTorch's CUDA division of a tensor by a Python scalar
    multiplies by. The plain versions multiply by these and the kernels take
    them, so the two agree bit for bit at every scale."""
    if scales is None:
        return (1.0, 1.0, 1.0)
    return tuple(float(torch.tensor(1.0 / float(s), dtype=dtype)) for s in scales)


def circ_diffs(x: torch.Tensor, scales=None) -> torch.Tensor:
    """Circular forward differences of a batch (B, Nz, Ny, Nx) along each
    volume axis, scaled, stacked on axis 1 (``admm.py:98-103``)."""
    r = reciprocals(scales, x.dtype)
    return torch.stack([(torch.roll(x, -1, dims=a + 1) - x) * r[a] for a in range(3)], dim=1)


def circ_diffs_adjoint(g: torch.Tensor, scales=None) -> torch.Tensor:
    """Adjoint of :func:`circ_diffs` on a stack (B, 3, Nz, Ny, Nx):
    ``D^T g = sum_a (roll(g_a, +1) - g_a) / s_a`` (``admm.py:106-112``)."""
    r = reciprocals(scales, g.dtype)
    out = 0.0
    for a in range(3):
        out = out + (torch.roll(g[:, a], 1, dims=a + 1) - g[:, a]) * r[a]
    return out


def hyperbolic_prox(vmag: torch.Tensor, lam, eps: float, newton_iters: int = NEWTON_ITERS) -> torch.Tensor:
    """prox of ``lam * (sqrt(t^2 + eps^2) - eps)`` on the gradient magnitude
    (``admm.py:170-182``): ``argmin_{s>=0} lam*sqrt(s^2+eps^2) + 0.5*(s-v)^2``
    for v >= 0, the root of ``g(s) = s + lam*s/sqrt(s^2+eps^2) - v`` by Newton
    (g' >= 1: globally convergent from ``max(v - lam, 0) <= s*``), one
    reciprocal ``q = 1/r`` a step. ``lam`` is a number or a tensor that
    broadcasts against ``vmag``."""
    s = torch.clamp_min(vmag - lam, 0.0)
    le2 = lam * eps * eps
    for _ in range(newton_iters):
        q = torch.reciprocal(torch.sqrt(s * s + eps * eps))
        g = s + lam * s * q - vmag
        gp = 1.0 + le2 * q * q * q
        s = torch.clamp_min(s - g / gp, 0.0)
    return s


def _trailing_faces(t: torch.Tensor, z_face=-1):
    """Each component ``a`` of a stack (B, 3, Nz, Ny, Nx) on axis ``a``'s
    trailing face, where the replicate-boundary TV has no difference, as
    views. ``z_face``: the z face's plane, None for a slab that does not hold
    the volume's last plane."""
    for a in range(3):
        if a or z_face is not None:
            yield t[:, a].select(a + 1, -1 if a else z_face)


def slab_diffs(x: torch.Tensor, x_next: torch.Tensor, scales=None) -> torch.Tensor:
    """:func:`circ_diffs` of z-slabs (B, nz, Ny, Nx), the plane after the
    slab's last ``x_next`` (B, Ny, Nx): the same operations on the same
    values, so the slabs' differences put together are the volume's."""
    r = reciprocals(scales, x.dtype)
    ahead = torch.cat([x[:, 1:], x_next[:, None]], dim=1)
    return torch.stack([(ahead - x) * r[0]] + [(torch.roll(x, -1, dims=a + 1) - x) * r[a] for a in (1, 2)], dim=1)


def slab_diffs_adjoint(g: torch.Tensor, g_prev: torch.Tensor, scales=None) -> torch.Tensor:
    """:func:`circ_diffs_adjoint` of a slab stack (B, 3, nz, Ny, Nx), with
    ``g_prev`` (B, Ny, Nx) the z component at the plane before the slab."""
    r = reciprocals(scales, g.dtype)
    out = 0.0 + (torch.cat([g_prev[:, None], g[:, 0, :-1]], dim=1) - g[:, 0]) * r[0]
    for a in (1, 2):
        out = out + (torch.roll(g[:, a], 1, dims=a + 1) - g[:, a]) * r[a]
    return out


def per_lane(t: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, 1, 1): one value a lane against (B, Nz, Ny, Nx)."""
    return t.reshape(-1, 1, 1, 1)


def split_magnitude(x, z1, u1, alpha: float = 1.0, scales=None, group: int = 1, dx=None, z_face=-1):
    """``(dxr, v, vmag)`` of the split update: the relaxed differences, ``v =
    dxr + u1`` and its masked magnitude (B, Nz, Ny, Nx), ``tiny`` under the
    root. The replicate-boundary mask is applied on the trailing faces' views.
    ``group`` > 1 takes one magnitude over each run of ``group`` lanes (the
    channels of the joint TV, ``admm.py:1076-1090``): vmag is then
    (B / group, Nz, Ny, Nx). A slab passes its differences ``dx``
    (:func:`slab_diffs`) and its z face's plane ``z_face`` (None: not in it)."""
    dx = circ_diffs(x, scales) if dx is None else dx
    dxr = dx if alpha == 1.0 else alpha * dx + (1.0 - alpha) * z1
    v = dxr + u1
    sq = v * v
    for face in _trailing_faces(sq, z_face):
        face.zero_()
    mag2 = sq[:, 0] + sq[:, 1] + sq[:, 2] if group == 1 else sq.reshape(-1, 3 * group, *x.shape[1:]).sum(1)
    return dxr, v, torch.sqrt(mag2 + torch.finfo(x.dtype).tiny)


def split_apply(x, z1, u1, z2, u2, dxr, v, scale, alpha: float = 1.0, positivity: bool = True,
                z_face=-1) -> None:
    """The rest of the split update from the prox's shrinkage ``scale`` (B,
    Nz, Ny, Nx), in place on ``z1, u1, z2, u2``: ``z1 = scale * v`` off the
    trailing faces (``z_face`` as in :func:`split_magnitude`), the positivity
    clamp and the dual updates."""
    z1_new = scale[:, None] * v
    for face, v_face in zip(_trailing_faces(z1_new, z_face), _trailing_faces(v, z_face)):
        face.copy_(v_face)  # unpenalized there: the prox is the identity
    xr = x if alpha == 1.0 else alpha * x + (1.0 - alpha) * z2
    z2_new = torch.clamp_min(xr + u2, 0.0) if positivity else xr + u2
    u1.add_(dxr).sub_(z1_new)
    u2.add_(xr).sub_(z2_new)
    z1.copy_(z1_new)
    z2.copy_(z2_new)


def admm_split_update_plain(x, z1, u1, z2, u2, lam, epsilon: float, alpha: float = 1.0,
                            positivity: bool = True, scales=None) -> None:
    """The split update with PyTorch operators, in place on ``z1, u1, z2,
    u2``: the kernel's plain version, on any device and dtype."""
    dxr, v, vmag = split_magnitude(x, z1, u1, alpha, scales)
    scale = hyperbolic_prox(vmag, per_lane(lam), float(epsilon)) / vmag
    split_apply(x, z1, u1, z2, u2, dxr, v, scale, alpha, positivity)


def _z_face(z_off: int, nz: int, nz_glob: int):
    """The slab's plane that is the volume's last, or None."""
    return nz - 1 if z_off + nz == nz_glob else None


def admm_split_update_slab_plain(x, x_next, z1, u1, z2, u2, lam, epsilon: float, z_off: int, nz: int,
                                 alpha: float = 1.0, positivity: bool = True, scales=None) -> None:
    """The split update of z-slabs with PyTorch operators, in place: the
    slab launch's plain version. ``x_next`` (B, Ny, Nx) is x's plane after
    the slab's last, ``z_off`` the slab's first plane in the volume of ``nz``
    planes."""
    z_face = _z_face(z_off, x.shape[1], nz)
    dxr, v, vmag = split_magnitude(x, z1, u1, alpha, scales, dx=slab_diffs(x, x_next, scales), z_face=z_face)
    scale = hyperbolic_prox(vmag, per_lane(lam), float(epsilon)) / vmag
    split_apply(x, z1, u1, z2, u2, dxr, v, scale, alpha, positivity, z_face=z_face)


def admm_rhs_slab_plain(z1, u1, z2, u2, z1_prev, u1_prev, rho1, rho2, scales=None) -> torch.Tensor:
    """The rhs of z-slabs with PyTorch operators: the slab launch's plain
    version; ``z1_prev``, ``u1_prev`` (B, Ny, Nx) are the z components at the
    plane before the slab."""
    return (per_lane(rho1) * slab_diffs_adjoint(z1 - u1, z1_prev - u1_prev, scales)
            + per_lane(rho2) * (z2 - u2))


def admm_rhs_plain(z1, u1, z2, u2, rho1, rho2, scales=None) -> torch.Tensor:
    """``rho1 * D^T(z1 - u1) + rho2 * (z2 - u2)`` with PyTorch operators:
    the kernel's plain version, on any device and dtype."""
    return per_lane(rho1) * circ_diffs_adjoint(z1 - u1, scales) + per_lane(rho2) * (z2 - u2)


@functools.cache
def _library() -> ctypes.CDLL:
    from microtipi_tpu_torch._build import load_library

    lib = load_library("admm_split")
    lib.admm_split_update_f32.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float] * 4 + [ctypes.c_int] * 3
        + [ctypes.c_float] * 3 + [ctypes.c_void_p]
    )
    lib.admm_split_update_f32.restype = ctypes.c_int
    lib.admm_rhs_f32.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3 + [ctypes.c_void_p]
    lib.admm_rhs_f32.restype = ctypes.c_int
    lib.admm_split_update_slab_f32.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float] * 4 + [ctypes.c_int] * 3
        + [ctypes.c_float] * 3 + [ctypes.c_void_p]
    )
    lib.admm_split_update_slab_f32.restype = ctypes.c_int
    lib.admm_rhs_slab_f32.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
                                      + [ctypes.c_void_p])
    lib.admm_rhs_slab_f32.restype = ctypes.c_int
    return lib


def _check(name: str, x: torch.Tensor, stacks=(), volumes=(), lanes=()) -> None:
    """What the kernels take: float32 contiguous tensors on ``x``'s device,
    ``x`` (B, Nz, Ny, Nx), ``volumes`` of its shape, ``stacks`` (B, 3, Nz, Ny,
    Nx), ``lanes`` (B,)."""
    if x.ndim != 4:
        raise ValueError(f"the CUDA {name} kernel takes a batch (B, Nz, Ny, Nx), got shape {tuple(x.shape)}")
    nb = x.shape[0]
    wanted = [(x, tuple(x.shape))] + [(t, tuple(x.shape)) for t in volumes]
    wanted += [(t, (nb, 3, *x.shape[1:])) for t in stacks] + [(t, (nb,)) for t in lanes]
    for t, shape in wanted:
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA {name} kernel takes float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"the CUDA {name} kernel takes tensors on one device, got {t.device} and {x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"the CUDA {name} kernel expected shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"the CUDA {name} kernel takes contiguous tensors")


def _launcher(name: str, fn, args: tuple, device: torch.device, buffers: tuple):
    """A callable that launches ``fn(*args, stream)`` on ``device``'s current
    stream and raises on a refused launch; it keeps ``buffers`` alive, since
    the kernel reads and writes through their pointers."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream

    def launch(_buffers=buffers) -> None:
        with torch.cuda.device(device):  # the stream's device must be current at the launch
            err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")

    return launch


def split_vectorized(x, z1, u1, z2, u2, x_next=None) -> bool:
    """Whether the split update takes its 16-byte instantiation on these
    tensors: nx % 4 == 0 and every base 16-byte aligned."""
    return x.shape[-1] % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (x, z1, u1, z2, u2, x_next)
                                        if t is not None)


def _check_planes(name: str, x: torch.Tensor, planes) -> None:
    """Halo planes of slabs ``x`` (B, nz, Ny, Nx): float32 contiguous (B, Ny, Nx) on its device."""
    want = (x.shape[0], *x.shape[2:])
    for t in planes:
        if t.dtype != torch.float32 or t.device != x.device or tuple(t.shape) != want or not t.is_contiguous():
            raise ValueError(f"the CUDA {name} kernel takes contiguous float32 halo planes {want} on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def prepare_split_update(x, z1, u1, z2, u2, lam, epsilon: float, alpha: float = 1.0, positivity: bool = True,
                         scales=None, x_next=None, z_off: int = 0, nz=None):
    """A callable that launches the split-update kernel on these tensors (in
    place, on the current stream), for timing back-to-back launches. It counts
    nothing. With ``x_next`` it is the slab launch (:func:`admm_split_update_slab`)."""
    _check("admm_split_update", x, stacks=(z1, u1), volumes=(z2, u2), lanes=(lam,))
    eps, alpha = float(epsilon), float(alpha)
    tail = (eps, eps * eps, alpha, 1.0 - alpha, int(alpha != 1.0), int(bool(positivity)),
            int(split_vectorized(x, z1, u1, z2, u2, x_next)), *reciprocals(scales))
    ptrs = (z1.data_ptr(), u1.data_ptr(), z2.data_ptr(), u2.data_ptr(), lam.data_ptr())
    if x_next is None:
        return _launcher("admm_split_update", _library().admm_split_update_f32, (x.data_ptr(), *ptrs, *x.shape,
                         *tail), x.device, (x, z1, u1, z2, u2, lam))
    _check_planes("admm_split_update", x, (x_next,))
    args = (x.data_ptr(), x_next.data_ptr(), *ptrs, *x.shape, int(z_off), int(nz), *tail)
    return _launcher("admm_split_update", _library().admm_split_update_slab_f32, args, x.device,
                     (x, x_next, z1, u1, z2, u2, lam))


def prepare_rhs(z1, u1, z2, u2, rho1, rho2, scales=None, z1_prev=None, u1_prev=None):
    """``(launch, out)``: the output allocated once and a callable that
    launches the rhs kernel into it, for timing back-to-back launches. It
    counts nothing. With ``z1_prev``, ``u1_prev`` it is the slab launch
    (:func:`admm_rhs_slab`)."""
    _check("admm_rhs", z2, stacks=(z1, u1), volumes=(u2,), lanes=(rho1, rho2))
    out = torch.empty_like(z2)
    tail = (rho1.data_ptr(), rho2.data_ptr(), out.data_ptr(), *z2.shape, *reciprocals(scales))
    if z1_prev is None:
        args = (z1.data_ptr(), u1.data_ptr(), z2.data_ptr(), u2.data_ptr(), *tail)
        return _launcher("admm_rhs", _library().admm_rhs_f32, args, z2.device,
                         (z1, u1, z2, u2, rho1, rho2, out)), out
    _check_planes("admm_rhs", z2, (z1_prev, u1_prev))
    args = (z1.data_ptr(), u1.data_ptr(), z2.data_ptr(), u2.data_ptr(), z1_prev.data_ptr(), u1_prev.data_ptr(), *tail)
    return _launcher("admm_rhs", _library().admm_rhs_slab_f32, args, z2.device,
                     (z1, u1, z2, u2, z1_prev, u1_prev, rho1, rho2, out)), out


def admm_split_update(x, z1, u1, z2, u2, lam, epsilon: float, alpha: float = 1.0, positivity: bool = True,
                      scales=None) -> None:
    """One split update in place on ``z1, u1, z2, u2`` from the new iterate
    ``x``: the CUDA kernel for CUDA tensors, the plain version for CPU ones.
    ``lam`` (B,) is ``mu / rho1`` per lane, ``alpha`` the over-relaxation."""
    global split_launches, split_unaligned_launches
    if x.device.type == "cuda":
        prepare_split_update(x, z1, u1, z2, u2, lam, epsilon, alpha, positivity, scales)()
        split_launches += 1
        split_unaligned_launches += not split_vectorized(x, z1, u1, z2, u2)
    elif x.device.type == "cpu":
        admm_split_update_plain(x, z1, u1, z2, u2, lam, epsilon, alpha, positivity, scales)
    else:
        raise ValueError(f"admm_split_update runs on CUDA or CPU tensors, got {x.device}")


def admm_rhs(z1, u1, z2, u2, rho1, rho2, scales=None) -> torch.Tensor:
    """The x-update's right-hand side (B, Nz, Ny, Nx): the CUDA kernel for
    CUDA tensors, the plain version for CPU ones. ``rho1``, ``rho2`` are (B,)."""
    global rhs_launches
    if z2.device.type == "cuda":
        launch, out = prepare_rhs(z1, u1, z2, u2, rho1, rho2, scales)
        launch()
        rhs_launches += 1
        return out
    if z2.device.type == "cpu":
        return admm_rhs_plain(z1, u1, z2, u2, rho1, rho2, scales)
    raise ValueError(f"admm_rhs runs on CUDA or CPU tensors, got {z2.device}")


def admm_split_update_slab(x, x_next, z1, u1, z2, u2, lam, epsilon: float, z_off: int, nz: int, alpha: float = 1.0,
                           positivity: bool = True, scales=None) -> None:
    """The split update of z-slabs (B, nz_slab, Ny, Nx) in place: one slab
    launch for CUDA tensors, :func:`admm_split_update_slab_plain` for CPU
    ones. ``x_next`` (B, Ny, Nx) is x's plane after the slab's last (after the
    volume's last plane, its first), ``z_off`` the slab's first plane in the
    volume of ``nz`` planes."""
    global split_slab_launches, split_unaligned_launches
    if x.device.type == "cuda":
        prepare_split_update(x, z1, u1, z2, u2, lam, epsilon, alpha, positivity, scales, x_next, z_off, nz)()
        split_slab_launches += 1
        split_unaligned_launches += not split_vectorized(x, z1, u1, z2, u2, x_next)
    elif x.device.type == "cpu":
        admm_split_update_slab_plain(x, x_next, z1, u1, z2, u2, lam, epsilon, z_off, nz, alpha, positivity, scales)
    else:
        raise ValueError(f"admm_split_update_slab runs on CUDA or CPU tensors, got {x.device}")


def admm_rhs_slab(z1, u1, z2, u2, z1_prev, u1_prev, rho1, rho2, scales=None) -> torch.Tensor:
    """The rhs of z-slabs: one slab launch for CUDA tensors,
    :func:`admm_rhs_slab_plain` for CPU ones. ``z1_prev``, ``u1_prev`` (B, Ny,
    Nx) are the z components at the plane before the slab's first (before the
    volume's first plane, at its last)."""
    global rhs_slab_launches
    if z2.device.type == "cuda":
        launch, out = prepare_rhs(z1, u1, z2, u2, rho1, rho2, scales, z1_prev, u1_prev)
        launch()
        rhs_slab_launches += 1
        return out
    if z2.device.type == "cpu":
        return admm_rhs_slab_plain(z1, u1, z2, u2, z1_prev, u1_prev, rho1, rho2, scales)
    raise ValueError(f"admm_rhs_slab runs on CUDA or CPU tensors, got {z2.device}")
