"""fft_per_iter.deconv: the port's FFTs (``ops/convolution.fft_calls``, one a
transform, whatever its batch) over the object iterations of the units the
traced slice completed (a unit's iterations: its lanes' most), which moves
deconv_mvox_iter_s: 2 an iteration uniform, 4 weighted, plus each solve's
fixed transforms."""

import numpy as np

__all__ = ["COUNTERS", "read"]

COUNTERS = {"fft_calls": ("microtipi_tpu_torch.ops.convolution", "fft_calls")}


def read(ctx):
    iterations = sum(int(np.max(a.iterations)) for a in ctx.answers)
    if not ctx.counters.get("fft_calls") or iterations == 0:  # a port without the counter reads 0
        return None
    return ctx.counters["fft_calls"] / iterations
