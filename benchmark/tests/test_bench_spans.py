"""The span reader's arithmetic (``spans.py``) over a synthetic trace: the
spans' own events change nothing that ``trace.summarize`` reads; a device
operation goes to the innermost span around the runtime call that launched
it, a gap to the span open on the host when the device starts again. And on
the CPU, each cell's traced run hands ``summarize`` no span's event."""

from __future__ import annotations

import json
import time
from typing import NamedTuple

import pytest
import torch

from benchmark import spans, trace
from benchmark.cell import ROOT, run_cell
from conftest import tiny_spec

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
NAMES = ("admm.solve", "admm.setup", "admm.objective", "admm.data_split")


class _Range(NamedTuple):
    start: float
    end: float


class _Event:
    """What the readers take of a profiler event (times in us)."""

    def __init__(self, name, device_type, start, end, id=0, is_user_annotation=False):
        self.name, self.device_type, self.id, self.is_user_annotation = name, device_type, id, is_user_annotation
        self.time_range = _Range(start, end)


def _span(name, start, end):
    return _Event(name, CPU, start, end, is_user_annotation=True)


def _launch(at, id, name="cudaLaunchKernel"):
    return _Event(name, CPU, at, at + 2, id=id)


def _kernel(name, start, end, id):
    return _Event(name, CUDA, start, end, id=id)


def _trace():
    """One solve: set-up with an objective inside it, then the loop; a copy launched outside it."""
    return [
        _span("admm.solve", 0, 1000), _span("admm.setup", 10, 400), _span("admm.objective", 200, 300),
        _span("admm.data_split", 420, 990),
        _launch(20, 1), _kernel("regular_fft", 30, 80, 1),  # in the set-up
        _launch(210, 2), _kernel("hyperbolic_tv_kernel", 220, 260, 2),  # in the objective, in the set-up
        _launch(430, 3), _kernel("admm_rhs_kernel", 500, 600, 3),  # in the loop; the device idles 260-500
        _launch(450, 4, "cuLaunchKernel"), _kernel("admm_split_update_kernel", 600, 700, 4),
        _launch(1100, 5, "cudaMemcpyAsync"), _kernel("Memcpy DtoH (Device -> Pageable)", 1110, 1120, 5),
        _Event("aten::add", CPU, 430, 440, id=4),  # a torch op whose id is also a launch's
        _kernel("vectorized_elementwise_kernel", 700, 710, 99),  # its launch is not in the trace
        # the device-side copies the profiler makes of the spans
        _Event("admm.setup", CUDA, 30, 260, is_user_annotation=True),
        _Event("admm.data_split", CUDA, 500, 700, is_user_annotation=True),
    ]


def _plain():
    return getattr(trace.summarize, "__wrapped__", trace.summarize)


def test_summarize_reads_the_same_without_the_spans_own_events():
    events = _trace()
    bare = [e for e in events if not e.is_user_annotation]
    assert _plain()(spans.without(events, NAMES), 2e-3) == _plain()(bare, 2e-3)
    with_spans = _plain()(events, 2e-3)
    assert with_spans.busy_s > _plain()(bare, 2e-3).busy_s  # the device-side copies would count as busy


def test_the_installed_filter_gives_summarize_what_it_read_before_the_spans(monkeypatch):
    monkeypatch.setattr(trace, "summarize", _plain())
    spans.install()
    assert trace.summarize.__wrapped__ is _plain()
    events = _trace()
    got = trace.summarize(events, 2e-3)
    assert got == _plain()([e for e in events if not e.is_user_annotation], 2e-3)
    assert not {n for n, _ in got.device_ops + got.idle_gaps} & set(NAMES)
    assert spans.last["admm.solve"].count == 1


def test_a_kernel_goes_to_the_innermost_span_around_its_launch():
    got = spans.attribute(_trace(), NAMES)
    assert got["admm.objective"].device_s == pytest.approx(40e-6)
    assert got["admm.setup"].device_s == pytest.approx(50e-6)  # its own: the objective's kernel excluded
    assert got["admm.setup"].device_total_s == pytest.approx(90e-6)
    assert got["admm.data_split"].device_s == pytest.approx(200e-6)
    assert got["admm.setup"].by_class["cufft"] == pytest.approx(50e-6)  # by class, its own only
    assert got["admm.objective"].by_class["tv"] == pytest.approx(40e-6) and got["admm.setup"].by_class["tv"] == 0
    assert got["admm.solve"].device_s == 0.0 and got["admm.solve"].device_total_s == pytest.approx(290e-6)
    assert got[spans.OUTSIDE].device_s == pytest.approx(10e-6)
    assert got[spans.UNMATCHED].device_s == pytest.approx(10e-6)
    assert sum(s.device_s for s in got.values()) == pytest.approx(sum(_plain()(_trace(), 1.0).by_class.values())
                                                                    - 430e-6)  # less the two device-side copies


def test_a_gap_goes_to_the_span_open_when_the_device_starts_again():
    got = spans.attribute(_trace(), NAMES)
    # gaps: 80-220 (ends in the objective), 260-500 (ends in the loop), 710-1110 (ends outside every span)
    assert got["admm.objective"].idle_s == pytest.approx(140e-6)
    assert got["admm.data_split"].idle_s == pytest.approx(240e-6)
    assert got[spans.OUTSIDE].idle_s == pytest.approx(400e-6)
    assert got["admm.solve"].idle_total_s == pytest.approx(380e-6)
    assert [got[n].count for n in NAMES] == [1, 1, 1, 1]


@pytest.mark.parametrize("workload", CELLS)
def test_a_traced_cell_hands_summarize_no_span_event(monkeypatch, workload):
    """The filter is installed by the cell's span readers: a cell whose solve
    opens spans and that lists none of them fails here."""
    seen, summarize = [], _plain()

    def plain(events, window_s, *args, **kwargs):
        seen.append([e.name for e in events])
        return summarize(events, window_s, *args, **kwargs)

    monkeypatch.setattr(trace, "summarize", plain)  # no filter until a span reader of the cell installs one
    monkeypatch.setattr(spans, "last", None)
    run_cell(workload, 2 ** 31 + 17, 1.0, True, t0=time.perf_counter(), device="cpu", spec=tiny_spec(workload))
    (names,) = seen
    assert spans.last is not None and spans.last["admm.solve"].count >= 1
    assert not set(names) & set(spans.declared())
