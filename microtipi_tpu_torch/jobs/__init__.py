"""Port of ``microtipi_tpu.jobs``."""
from microtipi_tpu_torch.jobs.multichannel import (
    deconvolve_multichannel,
    deconvolve_timeseries_multichannel,
    mixing_from_controls,
)
from microtipi_tpu_torch.jobs.richardson_lucy import multiview_richardson_lucy, richardson_lucy

__all__ = ["deconvolve_multichannel", "deconvolve_timeseries_multichannel", "mixing_from_controls",
           "multiview_richardson_lucy", "richardson_lucy"]
