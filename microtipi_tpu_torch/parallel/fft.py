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
:func:`sharded_rfftn` and the rest run the same code over every row. The
transpose of every row is one ``collectives.transpose`` (the JAX module's
``all_to_all``), whose backward is the inverse exchange: copies between the
devices of one process, and sends and receives between the ranks of a mesh
over processes, in the same slices and order, so the spectra are the same
bits either way. There is no
``exact`` switch: the exact matmul DFT stood in for the TPU's FFT, and cuFFT
float32 is float32-exact.
"""

from __future__ import annotations

import torch

from microtipi_tpu_torch.parallel.collectives import transpose
from microtipi_tpu_torch.parallel.mesh import Z_AXIS, Mesh, ShardedVolume, constrain_volume, shard

__all__ = [
    "irfft3_local",
    "rfft3_local",
    "sharded_convolve",
    "sharded_irfftn",
    "sharded_rfftn",
    "sharded_spectrum",
]


def _forward(slabs: list[torch.Tensor], mesh: Mesh, cells, local) -> list[torch.Tensor]:
    """Forward transform of the rows of ``cells``: ``local``'s z-slabs
    (..., Nz/p, Ny, Nx) in, their spectrum's y-slabs (..., Nz, Ny/p, Nx//2+1)
    out. The transpose gathers z and scatters y (``collectives.transpose``)."""
    planes = transpose(mesh, cells, local, [torch.fft.rfft2(s) for s in slabs], -2, -3)
    return [torch.fft.fft(t, dim=-3) for t in planes]


def _inverse(slabs: list[torch.Tensor], ny: int, nx: int, mesh: Mesh, cells, local) -> list[torch.Tensor]:
    """Inverse of :func:`_forward`; ``ny``, ``nx`` the global sizes."""
    cols = transpose(mesh, cells, local, [torch.fft.ifft(s, dim=-3) for s in slabs], -3, -2)
    return [torch.fft.irfft2(t, s=(ny, nx)) for t in cols]


def rfft3_local(slabs: list[torch.Tensor], devices: list[torch.device]) -> list[torch.Tensor]:
    """Forward transform of one mesh row: its z-slabs (..., Nz/p, Ny, Nx), on
    ``devices``, in; the spectrum's y-slabs (..., Nz, Ny/p, Nx//2+1) out."""
    row = Mesh([devices])
    return _forward(slabs, row, row.cells(), row.cells())


def irfft3_local(slabs: list[torch.Tensor], ny: int, nx: int, devices: list[torch.device]) -> list[torch.Tensor]:
    """Inverse of :func:`rfft3_local`: y-slabs (..., Nz, Ny/p, Nx//2+1) in,
    z-slabs (..., Nz/p, Ny, Nx) out; ``ny``, ``nx`` the global sizes."""
    row = Mesh([devices])
    return _inverse(slabs, ny, nx, row, row.cells(), row.cells())


def _rows(v: ShardedVolume, fn, shape, layout: str) -> ShardedVolume:
    """``fn(tiles, mesh, cells, local)`` over this rank's tiles of ``v``, the
    transforms of every mesh row that holds ``v``."""
    local = v.local_cells()
    out = fn([v.tiles[c] for c in local], v.mesh, v.cells(), local)
    return ShardedVolume(v.mesh, shape, dict(zip(local, out)), v.batched, layout)


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
    return _rows(x, _forward, (*x.shape[:-1], x.shape[-1] // 2 + 1), "y")


def sharded_irfftn(y: ShardedVolume, shape, mesh: Mesh) -> ShardedVolume:
    """Distributed irfftn of a y-sharded spectrum; ``shape`` is the global
    (Nz, Ny, Nx)."""
    nz, ny, nx = shape
    return _rows(y, lambda s, *where: _inverse(s, ny, nx, *where), (*y.shape[:-3], nz, ny, nx), "z")


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
