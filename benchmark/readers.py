"""The arithmetic the per-layer readers share (``metrics/<name>.py`` each
name one of these and the end-to-end metric it moves).

A reader takes the traced slice's :class:`Context` and returns the metric's
value, or None when the slice holds nothing to read (the layer did not
run): the harness then leaves the metric out. A roofline share is never 0
for want of time: no time read gives None. A reader that reads the port's
counters names them in its ``COUNTERS``, ``{name: (module, attribute)}``:
the harness zeroes them before the traced slice and reads them after it.
"""

from __future__ import annotations

import importlib
from typing import NamedTuple

from benchmark import roofline

__all__ = ["Context", "admm_roofline_pct", "fft_ms", "idle_pct", "read_counters", "reset_counters"]


class Context(NamedTuple):
    trace: object  # trace.Summary of the traced slice
    counters: dict  # the port's launch counters over the slice
    answers: list  # entry.Answer of each unit the slice completed
    voxels: int  # voxels of one volume (one lane)
    lanes: int  # volumes a unit restores together
    traffic: dict


def read_counters(counters: dict) -> dict:
    """``{name: value}`` of ``counters`` (``{name: (module, attribute)}``)."""
    return {k: getattr(importlib.import_module(m), a) for k, (m, a) in counters.items()}


def reset_counters(counters: dict) -> None:
    for m, a in counters.values():
        setattr(importlib.import_module(m), a, 0)


def idle_pct(ctx: Context) -> float | None:
    """The device's idle share of the traced wall, %: 100 (1 - busy / wall)."""
    if ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def admm_roofline_pct(ctx: Context, alpha: float) -> float | None:
    """The ADMM kernels' (split update and right-hand side) bound time over
    their device time, %. Each launch covers every lane of the unit."""
    seconds = ctx.trace.by_class["admm"]
    split, rhs = ctx.counters.get("split_launches", 0), ctx.counters.get("rhs_launches", 0)
    if seconds <= 0 or split + rhs == 0:
        return None
    voxels = ctx.voxels * ctx.lanes
    nbytes = split * roofline.admm_split_bytes(voxels, alpha) + rhs * roofline.admm_rhs_bytes(voxels)
    return 100.0 * roofline.bound_seconds(nbytes) / seconds


def fft_ms(ctx: Context) -> float | None:
    """cuFFT's device time per completed unit (stack or solve), ms."""
    if not ctx.answers or ctx.trace.by_class["cufft"] <= 0:
        return None
    return 1e3 * ctx.trace.by_class["cufft"] / len(ctx.answers)
