"""Tracing/profiling affordances (SURVEY.md section 5-a: the reference has
only stdout debug prints; here the profiler is first-class).

Port of ``microtipi_tpu/utils/profiling.py`` on ``torch.profiler``.
:func:`trace` records the CPU and, where there is a card, its kernels, and
writes a Chrome/Perfetto trace into ``logdir``. :func:`span` is the
program's one way to name a range of its work in such a trace; every name
the program gives one is in :data:`SPAN_NAMES`, so that a reader of the
trace can tell the program's spans from the profiler's other events."""

from __future__ import annotations

import contextlib
import os

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["SPAN_NAMES", "span", "trace"]

#: Every span the program opens, as a reader of a trace finds it (``jobs/admm.admm_deconvolve``):
#: ``admm.solve`` a call, the parent of the rest; ``admm.setup`` from entry to the loop; ``admm.objective``
#: each objective value; ``admm.data_split`` each of an iteration's two data-split halves (weighted or
#: Poisson only: the data term of the x-update's spectrum with its denominator, then ``H x``, the prox and the
#: dual update).
SPAN_NAMES = ("admm.solve", "admm.setup", "admm.objective", "admm.data_split")

_OFF = contextlib.nullcontext()


def span(name: str):
    """A named range of the program's work while a ``torch.profiler`` session
    records: a host range named ``name`` (``torch._C._profiler._RecordFunctionFast``,
    a tenth of ``torch.profiler.record_function``'s host time and no device-side
    copy of the range), inside which the operators and the kernels they launch
    group under ``name``. Otherwise one shared no-op context, with no
    ``RecordFunction`` made. ``name`` is one of :data:`SPAN_NAMES`.

    >>> with span("admm.setup"):
    ...     h_hat = torch.fft.rfftn(psf)
    """
    if _autograd_profiler._is_profiler_enabled:
        return torch._C._profiler._RecordFunctionFast(name)
    return _OFF


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a profiler trace viewable in Perfetto / ``chrome://tracing``,
    written to ``logdir/trace.json``:

    >>> with trace("/tmp/torch-trace"):
    ...     run_blind_deconv()
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
