"""admm_objective_ms.deconv: the device time under the ``admm.objective`` spans
(each objective value: slot 0 of the history, every tracked iteration, the
final ``f``), per completed unit (profiler), ms, which moves
deconv_mvox_iter_s: two FFTs and a TV launch a value."""

from benchmark import spans

__all__ = ["SPANS", "read"]

SPANS = ("admm.objective",)
spans.install()


def read(ctx):
    return spans.per_unit_ms(ctx, SPANS[0], "device_total_s")
