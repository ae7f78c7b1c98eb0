"""Tracing/profiling affordances (SURVEY.md section 5-a: the reference has
only stdout debug prints; here the profiler is first-class).

Port of ``microtipi_tpu/utils/profiling.py`` on ``torch.profiler``: the same
three names. :func:`trace` records the CPU and, where there is a card, its
kernels, and writes a Chrome/Perfetto trace into ``logdir``."""

from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["trace", "annotate", "timed"]


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


def annotate(name: str):
    """Named range so the operators and kernels inside group under ``name``
    in traces (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def timed(label: str, sink=print):
    """Wall-clock a block; waiting for the card on exit
    (``torch.cuda.synchronize()``) is the caller's job, as JAX's
    ``block_until_ready`` is there."""
    t0 = time.perf_counter()
    yield
    sink(f"{label}: {time.perf_counter() - t0:.3f}s")
