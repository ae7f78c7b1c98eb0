"""admm_setup_ms.deconv: the device time of a solve's set-up, the ``admm.setup``
span's own (its ``admm.objective`` excluded: the cost build, the PSF and data
spectra, the state), per completed unit (profiler), ms, which moves
deconv_mvox_iter_s: the fixed cost of each solve."""

from benchmark import spans

__all__ = ["SPANS", "read"]

SPANS = ("admm.setup",)
spans.install()


def read(ctx):
    return spans.per_unit_ms(ctx, SPANS[0], "device_s")
