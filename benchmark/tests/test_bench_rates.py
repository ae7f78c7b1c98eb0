"""The rate over a window counts all the work of the units that ended in it."""

from __future__ import annotations

import pytest

from benchmark.rates import mvox_iter_per_s


def test_whole_units_over_the_time_to_the_last_that_ended_inside():
    units = [(1.0, 2e6), (2.0, 2e6), (3.0, 2e6), (4.5, 2e6)]  # the last ends after the window closes
    assert mvox_iter_per_s(units, 0.0, 4.0) == pytest.approx(6.0 / 3.0)


def test_a_stall_inside_the_window_counts_against_the_rate():
    steady = [(float(i), 1e6) for i in range(1, 11)]
    stalled = [(float(i) + (3.0 if i > 5 else 0.0), 1e6) for i in range(1, 11)]
    assert mvox_iter_per_s(steady, 0.0, 10.0) == pytest.approx(1.0)
    # five units in 5 s, a 3 s stall, then two more by 10 s: 7 units over 10 s
    assert mvox_iter_per_s(stalled, 0.0, 10.0) == pytest.approx(0.7)


def test_a_window_with_no_unit_ended_is_refused():
    with pytest.raises(RuntimeError):
        mvox_iter_per_s([(5.0, 1e6)], 0.0, 4.0)
