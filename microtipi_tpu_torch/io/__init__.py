"""Volume IO: native TIFF (C++ parallel decode), OME-TIFF metadata, HDF5,
zarr/OME-NGFF (stdlib-only store implementation).

The port of ``microtipi_tpu/io``, with the same ``__all__``: NumPy in and out
on the host, no torch. The TIFF functions build ``native/stackio.cpp`` at
first use and need a C++ compiler and libtiff on the host; the zarr/NGFF
stores need only the standard library (blosc, zstd and lz4 chunks need their
libraries where a store uses them)."""
from microtipi_tpu_torch.io.ome import (
    ome_xml,
    parse_ome,
    read_ome,
    read_ome_companion,
    read_ome_hyperstack,
    write_ome_companion,
    write_ome_hyperstack,
    write_ome_stack,
)
from microtipi_tpu_torch.io.tiffstack import StackPrefetcher, read_stack, stack_info, write_stack
from microtipi_tpu_torch.io.zarrstack import (
    read_ngff_hyperstack,
    read_zarr,
    write_ngff_hyperstack,
    write_zarr,
)

__all__ = [
    "read_stack",
    "write_stack",
    "stack_info",
    "StackPrefetcher",
    "ome_xml",
    "parse_ome",
    "read_ome",
    "read_ome_hyperstack",
    "read_ome_companion",
    "write_ome_companion",
    "write_ome_hyperstack",
    "write_ome_stack",
    "read_zarr",
    "write_zarr",
    "read_ngff_hyperstack",
    "write_ngff_hyperstack",
]
