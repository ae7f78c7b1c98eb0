"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Port of the Pallas kernels in ``microtipi_tpu.ops.pallas``.
"""
