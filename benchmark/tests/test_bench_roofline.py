"""The roofline's byte counts give the bounds of the port's kernel table at 256^3."""

from __future__ import annotations

import pytest

from benchmark import roofline

V = 256 ** 3


@pytest.mark.parametrize("nbytes,bound_ms", [
    (roofline.tv_bytes(V), 0.0401),              # TV: 8 B a voxel
    (roofline.admm_split_bytes(V, 1.8), 0.3406),  # split update, 17 volumes
    (roofline.admm_split_bytes(V, 1.0), 0.2604),  # split update at alpha 1, 13 volumes
    (roofline.admm_rhs_bytes(V), 0.1803),        # right-hand side, 9 volumes
    (roofline.tv_bytes(4 * V), 0.1603),          # batched TV over 4 x 256^3
])
def test_bounds_at_256_cubed(nbytes, bound_ms):
    assert roofline.bound_seconds(nbytes) * 1e3 == pytest.approx(bound_ms, abs=1e-4)
