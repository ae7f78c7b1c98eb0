"""The port's entries, each a file of its own: ``entries/<name>.py``, named by
a traffic mix's ``"entry"``.

An entry module is all that the harness knows of one port call. It holds:

- ``program(traffic, config, device)``: an engine that drives the port's
  entry (``microtipi_tpu_torch``), the system under test;
- ``reference(traffic, config, device, precision)``: an engine that runs the
  same work with the benchmark's plain reference in ``precision`` (the
  control: ``"bfloat16"``, or ``"float32"``);
- ``checker(traffic, config, device)``: an object whose ``readings(stack,
  answer)`` gives the numbers ``correct`` holds (each a relative gap, the
  worst lane's) against the plain reference in float64, with the numbers
  recorded beside them.

An engine's ``run(stack, warm=False)`` restores one :class:`scene.Stack` and
returns one :class:`Answer`. So a new port entry adds a file, and no file
of the harness changes.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["Answer", "lanes", "load"]

HERE = Path(__file__).resolve().parent


class Answer(NamedTuple):
    """What one unit of work produced: the restored object ``x`` (one volume
    or one a lane), the objective the engine reports for it ``f`` (one a
    lane), and the object iterations and evaluations done (one a lane)."""

    stack: int
    x: torch.Tensor
    f: np.ndarray
    iterations: np.ndarray
    evaluations: np.ndarray


def lanes(stack) -> tuple:
    """``(data, psfs, weights)`` of a stack, one a lane (weights None a lane
    for uniform weights)."""
    data = stack.data if stack.data.ndim == 4 else stack.data[None]
    psfs = stack.psf if stack.psf.ndim == 4 else stack.psf[None]
    if stack.weights is None:
        return data, psfs, [None] * len(data)
    return data, psfs, stack.weights if stack.weights.ndim == 4 else stack.weights[None]


def load(name: str):
    """The entry module ``entries/<name>.py``."""
    path = HERE / "entries" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"unknown entry {name!r}: no {path.relative_to(HERE.parent)}")
    spec = importlib.util.spec_from_file_location(f"benchmark.entries.{name.replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
