"""The program's spans in a ``torch.profiler`` trace of the window, for the
span readers (``metrics/<name>.py`` that name the spans they read in
``SPANS``).

The port names ranges of its work with ``utils/profiling.span`` and declares
every name it gives one in that module's ``SPAN_NAMES``; a port without them
has no span, and the span readers read nothing. Over the profiler's
``events()``, for each declared span:

- device seconds: each device operation goes to the innermost span whose
  host range holds the runtime call that launched it (``cudaLaunchKernel``,
  ``cuLaunchKernel``, ``cudaMemcpyAsync``...), matched by the correlation id
  that the profiler gives both the call and the operation; an operation
  launched outside every span goes to ``outside``, one whose call the trace
  lacks to ``unmatched``;
- idle seconds: each gap between the merged busy intervals goes to the
  innermost span open on the host at the gap's end, when the device starts
  again, or to ``outside``;
- the count of its host ranges, and its own device seconds by kernel class.

Each span has its own share (the spans nested in it excluded) and its total
(them included). The device operations split without remainder into the
spans' own, ``outside`` and ``unmatched``; ``unmatched`` 0 says that every
operation was matched to its launch.

A span's own events, its host ranges and any device-side copies a profiler
makes of them, are neither device operations nor host operations:
:func:`install` puts a filter in front of ``trace.summarize``, so that
``summarize`` reads the events it read before the port had spans, and keeps
the spans of the trace it saw in :data:`last`, which it also writes as one
``spans:`` line on standard error. Each span reader installs it when it is
loaded; ``tests/test_bench_spans.py`` fails for a cell whose traced run
hands ``summarize`` a span's event.
"""

from __future__ import annotations

import bisect
import functools
import importlib
import json
import re
import sys
from typing import NamedTuple

import torch

from benchmark import trace

__all__ = ["OUTSIDE", "UNMATCHED", "Span", "attribute", "declared", "install", "last", "per_unit_ms", "without"]

OUTSIDE, UNMATCHED = "outside", "unmatched"
LAUNCH = re.compile(r"^cu(da)?[A-Z]")  # cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync...; not aten::... nor a span

last = None  # {name: Span} of the trace that the filtered summarize saw last


class Span(NamedTuple):
    count: int  # host ranges
    device_s: float  # device time launched in the span itself, the spans nested in it excluded
    idle_s: float  # idle time whose gap ends in the span itself
    device_total_s: float  # the same with the nested spans
    idle_total_s: float
    by_class: dict  # device_s by kernel class (``trace.kernel_class``)


def declared() -> tuple:
    """The span names the port declares (``utils/profiling.SPAN_NAMES``), or none."""
    return tuple(getattr(importlib.import_module("microtipi_tpu_torch.utils.profiling"), "SPAN_NAMES", ()))


def without(events, names) -> list:
    """``events`` less the spans' own: host ranges and device-side copies named in ``names``."""
    names = set(names)
    return [e for e in events if e.name not in names]


class _Ranges:
    """The spans' host ranges, each with its parent, for the innermost range
    open at a time and the ranges around it."""

    def __init__(self, host):
        order = sorted(host, key=lambda e: (e.time_range.start, -e.time_range.end))
        self.starts = [e.time_range.start for e in order]
        self.ends = [e.time_range.end for e in order]
        self.names = [e.name for e in order]
        self.parent, open_ = [], []
        for i, s in enumerate(self.starts):
            while open_ and self.ends[open_[-1]] <= s:
                open_.pop()
            self.parent.append(open_[-1] if open_ else -1)
            open_.append(i)

    def around(self, t: float) -> list:
        """The ranges open at ``t``, innermost first: the latest to start
        before ``t``, or the first of its ancestors still open."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ends[i] < t:
            i = self.parent[i]
        out = []
        while i >= 0:
            out.append(self.names[i])
            i = self.parent[i]
        return out


def attribute(events, names) -> dict:
    """``{name: Span}`` of every name in ``names``, with :data:`OUTSIDE` and
    :data:`UNMATCHED` (count 0), over the profiler's ``events()``."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    names = tuple(names)
    keys = names + (OUTSIDE, UNMATCHED)
    own = {k: [0.0, 0.0] for k in keys}  # device, idle
    total = {k: [0.0, 0.0] for k in keys}
    by_class = {k: dict.fromkeys(trace.CLASSES, 0.0) for k in keys}
    ranges = _Ranges([e for e in events if e.device_type == cpu and e.name in names])
    launch_at = {}
    for e in events:
        if e.device_type == cpu and LAUNCH.match(e.name):
            launch_at.setdefault(e.id, e.time_range.start)
    dev = [e for e in events if e.device_type == cuda and e.name not in names]

    def add(kind: int, t, seconds: float) -> str:
        inside = [UNMATCHED] if t is None else (ranges.around(t) or [OUTSIDE])
        own[inside[0]][kind] += seconds
        for name in inside:
            total[name][kind] += seconds
        return inside[0]

    intervals = []
    for e in dev:
        start, end = e.time_range.start, e.time_range.end
        seconds = (end - start) * 1e-6
        by_class[add(0, launch_at.get(e.id), seconds)][trace.kernel_class(e.name)] += seconds
        intervals.append((start, end))
    intervals.sort()
    if intervals:
        cur_end = intervals[0][1]
        for s, e in intervals[1:]:
            if s > cur_end:
                add(1, s, (s - cur_end) * 1e-6)
            cur_end = max(cur_end, e)
    counts = {k: ranges.names.count(k) for k in keys}
    return {k: Span(counts[k], own[k][0], own[k][1], total[k][0], total[k][1], by_class[k]) for k in keys}


def per_unit_ms(ctx, name: str, field: str) -> float | None:
    """``field`` of span ``name`` in :data:`last`, per completed unit, ms; None
    when the span never opened or the trace holds no device operation."""
    if last is None or name not in last or last[name].count == 0 or not ctx.answers:
        return None
    if sum(s.device_s for s in last.values()) <= 0:
        return None
    return 1e3 * getattr(last[name], field) / len(ctx.answers)


def install() -> None:
    """Put the span filter in front of ``trace.summarize``, once a process."""
    if hasattr(trace.summarize, "__wrapped__"):
        return
    plain = trace.summarize

    @functools.wraps(plain)
    def summarize(events, window_s, *args, **kwargs):
        global last
        names = declared()
        last = attribute(events, names)
        print(f"spans: {json.dumps({k: s._asdict() for k, s in last.items()})}", file=sys.stderr)
        return plain(without(events, names), window_s, *args, **kwargs)

    trace.summarize = summarize
