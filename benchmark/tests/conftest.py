"""Shared fixtures of the benchmark's CPU tests: a cell's spec at a tiny
grid, so that a whole run fits a test on the CPU."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny_spec(workload: str) -> dict:
    """The cell's spec with its grid cut to 8 x 20 x 16 (PSF 8 x 16 x 16):
    a non-square stack, as the published one is."""
    from benchmark.cell import load_cell

    spec = load_cell(workload)
    spec = dict(spec, config=copy.deepcopy(spec["config"]))
    c = spec["config"]
    c["grid"], c["psf_grid"] = [8, 20, 16], [8, 16, 16]
    c["voxel_m"] = [4e-7, 1.3e-7, 1.3e-7]
    c["scene"].update(nuclei=2, filaments=2, filament_steps=20, nucleus_radius_um=[0.5, 0.8])
    return spec


@pytest.fixture
def card():
    """The CUDA card, decided when the test runs; skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
