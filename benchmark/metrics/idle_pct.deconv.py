"""idle_pct.deconv: the device's idle share of the traced wall (profiler), which
moves deconv_mvox_iter_s: host time between launches that the card waits out."""

from benchmark.readers import idle_pct as read

__all__ = ["read"]
