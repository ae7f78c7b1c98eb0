"""What a ``torch.profiler`` trace of the window says, for the per-layer
readers: device time by kernel class, device busy time, the traced wall,
the operations that took most device time, and the idle gaps by what the
host was doing.

The class table and the idle arithmetic are copied from ``chip_profile.py``:
a kernel is classed by its name (the TV kernel, the ADMM kernels, cuFFT,
copies, reductions, the other elementwise kernels); idle = 1 - busy / wall,
an upper estimate, since the profiler slows the host. Busy time is the union
of the device operations' intervals.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["CLASSES", "Summary", "kernel_class", "summarize"]

CLASSES = ("tv", "admm", "cufft", "reduction", "copy", "elementwise")


def kernel_class(name: str) -> str:
    low = name.lower()
    if "hyperbolic_tv" in low:
        return "tv"
    if "admm_" in low:
        return "admm"
    if "fft" in low:
        return "cufft"
    if "memcpy" in low or "memset" in low:
        return "copy"
    if "reduce" in low or "dot" in low or "gemv" in low:
        return "reduction"
    return "elementwise"


class Summary(NamedTuple):
    by_class: dict  # seconds of device time by class
    busy_s: float
    window_s: float
    device_ops: list  # [[name, seconds], ...], the 10 longest in sum
    idle_gaps: list  # [[host op, seconds], ...], the 10 longest in sum


def summarize(events, window_s: float, top: int = 10, gaps_considered: int = 4000) -> Summary:
    """Summary of the profiler's ``events()`` over a traced window of ``window_s`` seconds."""
    import torch

    dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    by_class = dict.fromkeys(CLASSES, 0.0)
    by_name: dict = {}
    spans = []
    for e in dev:
        start, end = e.time_range.start, e.time_range.end
        seconds = (end - start) * 1e-6
        by_class[kernel_class(e.name)] += seconds
        by_name[e.name] = by_name.get(e.name, 0.0) + seconds
        spans.append((start, end))
    busy, gaps = 0.0, []
    if spans:
        spans.sort()
        cur_s, cur_e = spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                gaps.append((s - cur_e, cur_e))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
    busy_s = busy * 1e-6
    device_ops = sorted(([n, s] for n, s in by_name.items()), key=lambda v: -v[1])[:top]
    idle = {}
    if gaps and host:
        starts = np.array([e.time_range.start for e in host], dtype=np.float64)
        ends = np.array([e.time_range.end for e in host], dtype=np.float64)
        names = [e.name for e in host]
        for length, at in sorted(gaps, reverse=True)[:gaps_considered]:
            inside = np.nonzero((starts <= at) & (ends >= at))[0]
            name = names[inside[np.argmax(starts[inside])]] if inside.size else "(no host op)"
            idle[name] = idle.get(name, 0.0) + length * 1e-6
    idle_gaps = sorted(([n, s] for n, s in idle.items()), key=lambda v: -v[1])[:top]
    return Summary(by_class, busy_s, window_s, device_ops, idle_gaps)
