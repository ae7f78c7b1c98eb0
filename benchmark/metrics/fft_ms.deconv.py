"""fft_ms.deconv: cuFFT's device time per completed solve (profiler), ms, which
moves deconv_mvox_iter_s: the FFT data term's share of the work."""

from benchmark.readers import fft_ms as read

__all__ = ["read"]
