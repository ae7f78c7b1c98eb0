"""Mesh-sharded execution: distributed FFT, sharded solvers.

Port of ``microtipi_tpu/parallel``. One process drives a (batch, z) grid of
devices (``mesh.make_mesh``); a sharded volume is a grid of per-device
tensors (``mesh.ShardedVolume``), and the collectives are explicit copies.
With a process group (``make_mesh(..., group=pg)``) the mesh spans one
process a rank, and the collectives are ``torch.distributed`` calls
(``parallel/collectives.py``); every sharded solver runs on either kind.
"""
from microtipi_tpu_torch.parallel.admm import sharded_admm_deconvolve
from microtipi_tpu_torch.parallel.blind import sharded_blind_deconvolve
from microtipi_tpu_torch.parallel.collectives import all_cells, cell_values, exchange
from microtipi_tpu_torch.parallel.deconv import make_sharded_objective, sharded_deconvolve
from microtipi_tpu_torch.parallel.fft import (
    sharded_convolve,
    sharded_irfftn,
    sharded_rfftn,
    sharded_spectrum,
)
from microtipi_tpu_torch.parallel.mesh import (
    BATCH_AXIS,
    Z_AXIS,
    Mesh,
    ShardedVolume,
    gather,
    make_mesh,
    shard,
    volume_sharding,
)
from microtipi_tpu_torch.parallel.psf_fit import sharded_fit_psf

__all__ = [
    "make_mesh", "volume_sharding", "BATCH_AXIS", "Z_AXIS",
    "sharded_rfftn", "sharded_irfftn", "sharded_spectrum", "sharded_convolve",
    "make_sharded_objective", "sharded_deconvolve", "sharded_fit_psf",
    "sharded_blind_deconvolve", "sharded_admm_deconvolve",
    "ShardedVolume", "shard", "gather",
    "Mesh", "exchange", "all_cells", "cell_values",
]
