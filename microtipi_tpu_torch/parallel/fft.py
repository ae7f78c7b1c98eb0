"""Distributed 3D real FFT and FFT-domain convolution over a device mesh.

Port of ``microtipi_tpu/parallel/fft.py``: the transpose decomposition. A
volume is z-sharded over the mesh's z axis; then

  forward:  ``torch.fft.rfft2`` over (y, x) on each z-slab
            -> transpose: gather z, scatter y (explicit slices and copies)
            -> ``torch.fft.fft`` along the now whole z axis
  inverse:  the mirror image.

The spectrum lives y-sharded (layout "y" of ``parallel/mesh.py``), so a
product with a kernel spectrum in the same layout is local and a convolution
costs two transposes. Everything is differentiable through autograd, as the
JAX transforms are through ``all_to_all``. Nz and Ny must divide the z axis
(the sharded loops pad up to that, ``parallel/blind.py``).

:func:`rfft3_local` and :func:`irfft3_local` are one mesh row's transforms
(the counterparts of the bodies the JAX module runs inside ``shard_map``);
:func:`sharded_rfftn` and the rest run them over every row. There is no
``exact`` switch: the exact matmul DFT stood in for the TPU's FFT, and cuFFT
float32 is float32-exact.
"""

from __future__ import annotations

import torch

from microtipi_tpu_torch.parallel.mesh import BATCH_AXIS, Z_AXIS, Mesh, ShardedVolume, constrain_volume, shard

__all__ = [
    "irfft3_local",
    "rfft3_local",
    "sharded_convolve",
    "sharded_irfftn",
    "sharded_rfftn",
    "sharded_spectrum",
]


def rfft3_local(slabs: list[torch.Tensor], devices: list[torch.device]) -> list[torch.Tensor]:
    """Forward transform of one mesh row: its z-slabs (..., Nz/p, Ny, Nx), on
    ``devices``, in; the spectrum's y-slabs (..., Nz, Ny/p, Nx//2+1) out."""
    p = len(slabs)
    planes = [torch.fft.rfft2(s) for s in slabs]
    nyl = planes[0].shape[-2] // p
    out = []
    for j, dev in enumerate(devices):
        parts = [t[..., j * nyl:(j + 1) * nyl, :].to(dev) for t in planes]
        out.append(torch.fft.fft(torch.cat(parts, dim=-3), dim=-3))
    return out


def irfft3_local(slabs: list[torch.Tensor], ny: int, nx: int, devices: list[torch.device]) -> list[torch.Tensor]:
    """Inverse of :func:`rfft3_local`: y-slabs (..., Nz, Ny/p, Nx//2+1) in,
    z-slabs (..., Nz/p, Ny, Nx) out; ``ny``, ``nx`` the global sizes."""
    p = len(slabs)
    cols = [torch.fft.ifft(s, dim=-3) for s in slabs]
    nzl = cols[0].shape[-3] // p
    out = []
    for j, dev in enumerate(devices):
        parts = [t[..., j * nzl:(j + 1) * nzl, :, :].to(dev) for t in cols]
        out.append(torch.fft.irfft2(torch.cat(parts, dim=-2), s=(ny, nx)))
    return out


def _rows(v: ShardedVolume, fn, shape, layout: str) -> ShardedVolume:
    """``fn`` over each mesh row's tiles, in z order."""
    mesh, nz = v.mesh, v.mesh.shape[Z_AXIS]
    rows = range(mesh.shape[BATCH_AXIS]) if v.batched else (0,)
    tiles = {}
    for b in rows:
        devs = [mesh.device(b, z) for z in range(nz)]
        for z, t in enumerate(fn([v.tiles[(b, z)] for z in range(nz)], devs)):
            tiles[(b, z)] = t
    return ShardedVolume(mesh, shape, tiles, v.batched, layout)


def _check(shape, mesh: Mesh) -> None:
    p = mesh.shape[Z_AXIS]
    if shape[-3] % p or shape[-2] % p:
        raise ValueError(f"the distributed FFT needs Nz and Ny divisible by the mesh's z axis ({p}), got "
                         f"{tuple(shape[-3:])}; pad the grid (parallel.deconv.pad_trailing)")


def sharded_rfftn(x, mesh: Mesh) -> ShardedVolume:
    """Distributed rfftn: a z-sharded volume or stack in (a tensor is
    sharded first), its y-sharded spectrum out."""
    x = constrain_volume(x, mesh)
    if not isinstance(x, ShardedVolume):
        raise ValueError(f"shape {tuple(x.shape)} does not divide the mesh {mesh}")
    _check(x.shape, mesh)
    return _rows(x, rfft3_local, (*x.shape[:-1], x.shape[-1] // 2 + 1), "y")


def sharded_irfftn(y: ShardedVolume, shape, mesh: Mesh) -> ShardedVolume:
    """Distributed irfftn of a y-sharded spectrum; ``shape`` is the global
    (Nz, Ny, Nx)."""
    nz, ny, nx = shape
    return _rows(y, lambda s, d: irfft3_local(s, ny, nx, d), (*y.shape[:-3], nz, ny, nx), "z")


def sharded_spectrum(kernel, mesh: Mesh) -> ShardedVolume:
    """A kernel's spectrum in the distributed layout, computed once; a
    (K,) + volume stack of kernels is batched over the mesh rows."""
    if not isinstance(kernel, ShardedVolume):
        kernel = shard(kernel, mesh, batched=kernel.ndim == 4)
    return sharded_rfftn(kernel, mesh)


def sharded_convolve(x, kernel_hat: ShardedVolume, shape, mesh: Mesh) -> ShardedVolume:
    """Circular convolution of a z-sharded ``x`` with a kernel spectrum from
    :func:`sharded_spectrum` (broadcast over a batch): two transposes, and the
    spectral product local."""
    return sharded_irfftn(sharded_rfftn(x, mesh) * kernel_hat, shape, mesh)
