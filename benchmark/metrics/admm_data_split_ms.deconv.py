"""admm_data_split_ms.deconv: the device time under the ``admm.data_split``
spans (an iteration's data split on the weighted or Poisson path, in two
halves: its term of the x-update's spectrum; then ``H x``, the prox, the
``z0``/``u0`` update), per completed unit (profiler), ms, which moves
deconv_mvox_iter_s."""

from benchmark import spans

__all__ = ["SPANS", "read"]

SPANS = ("admm.data_split",)
spans.install()


def read(ctx):
    return spans.per_unit_ms(ctx, SPANS[0], "device_total_s")
