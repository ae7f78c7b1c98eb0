"""Rates over a measured window."""

from __future__ import annotations

__all__ = ["mvox_iter_per_s"]


def mvox_iter_per_s(units, t_start: float, seconds: float) -> float:
    """Millions of voxel-iterations a second: ``units`` are ``(t_end, work)``
    pairs in completion order, ``work`` in voxel-iterations. Every unit that
    ended within ``seconds`` of ``t_start`` counts, over the time from
    ``t_start`` to the last such end; a unit that ends after the window
    closes counts for nothing. Raises if none ended inside the window."""
    done = [(t, w) for t, w in units if t - t_start <= seconds]
    if not done:
        raise RuntimeError(f"no unit ended inside the {seconds} s window")
    return sum(w for _, w in done) / (done[-1][0] - t_start) / 1e6
