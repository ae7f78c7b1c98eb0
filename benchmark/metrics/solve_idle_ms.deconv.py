"""solve_idle_ms.deconv: the device's idle time whose gap ends inside an
``admm.solve`` span (the device waits for a launch that the solve makes), per
completed unit (profiler), ms, which moves deconv_mvox_iter_s."""

from benchmark import spans

__all__ = ["SPANS", "read"]

SPANS = ("admm.solve",)
spans.install()


def read(ctx):
    return spans.per_unit_ms(ctx, SPANS[0], "idle_total_s")
