"""Port of ``microtipi_tpu.jobs``."""
from microtipi_tpu_torch.jobs.richardson_lucy import multiview_richardson_lucy, richardson_lucy

__all__ = ["multiview_richardson_lucy", "richardson_lucy"]
