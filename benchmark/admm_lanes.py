"""The plain reference's side of the ADMM entries, lane by lane: a stack is
one lane, a multichannel batch one a channel, each with its own PSF and
weights.

:class:`Reference` restores a stack with ``reference/admm.py`` in a stated
precision: in the program's place, the control. :class:`Checker` judges an
answer in float64 (``check.py`` holds its numbers to the cell's limits):

- ``x_gap``: the answer against the reference's own solve of the same lane
  from the same start, same iterations, relative L2: the PSF's embedding,
  the FFT data term, both ADMM kernels, the prox;
- ``f_gap``: the objective the engine reports against the reference's
  objective of the answer: the FFT data term and the TV term;
- ``f_excess``: the reference's objective of the answer against that of its
  own solve: what the answer reached;
- ``restoration_error`` (recorded, held to no limit): the answer against the
  scene's truth, relative L2.

The worst lane gives each number.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.check import gap, rel
from benchmark.entry import Answer, lanes
from benchmark.reference.admm import admm
from benchmark.reference.objective import objective, pad_kernel, spectrum
from benchmark.reference.precision import Precision

__all__ = ["Checker", "Reference"]

F64 = Precision("float64")


def _solve(traffic: dict, d, k, w, p: Precision):
    """``(x, f)``: the traffic's ADMM solve of one lane in ``p``, from ``max(d, 0)``."""
    d = d.to(p.dtype)
    return admm(d, pad_kernel(k.to(p.dtype), d.shape), traffic["mu"], traffic["epsilon"], traffic["iters"],
                traffic["over_relax"], p, w=w)


class Reference:
    """The plain reference in the program's place, in ``precision``."""

    def __init__(self, traffic: dict, config: dict, device, precision: str):
        self.traffic, self.p = traffic, Precision(precision)

    def run(self, stack, warm: bool = False) -> Answer:
        xs, fs = [], []
        for d, k, w in zip(*lanes(stack)):
            x, f = _solve(self.traffic, d, k, w, self.p)
            xs.append(x.float())
            fs.append(f)
        x = torch.stack(xs) if stack.data.ndim == 4 else xs[0]
        its = np.full(len(xs), self.traffic["iters"])
        return Answer(stack.index, x, np.array(fs), its, its)


class Checker:
    """The readings of answers to one cell's stacks, in float64 on ``device``."""

    def __init__(self, traffic: dict, config: dict, device):
        self.traffic = traffic
        self.own: dict = {}  # the reference's own solve of each lane, by stack

    def readings(self, stack, ans: Answer) -> dict:
        t = self.traffic
        data, psfs, weights = lanes(stack)
        xs = ans.x if ans.x.ndim == 4 else ans.x[None]
        truths = stack.truth if stack.truth.ndim == 4 else stack.truth[None]
        if stack.index not in self.own:
            self.own[stack.index] = [(x.float(), f) for x, f in
                                     (_solve(t, d, k, w, F64) for d, k, w in zip(data, psfs, weights))]
        gaps = {"f_gap": [], "x_gap": [], "f_excess": [], "restoration_error": []}
        for lane, (d, k, w, x) in enumerate(zip(data, psfs, weights, xs)):
            d64 = d.to(torch.float64)
            w64 = None if w is None else w.to(torch.float64)
            if w64 is not None:
                d64 = torch.where(w64 > 0, d64, torch.zeros_like(d64))
            with torch.no_grad():
                f = float(objective(x.to(torch.float64), d64, spectrum(pad_kernel(k.to(torch.float64), d.shape), F64),
                                    t["mu"], t["epsilon"], F64, w64))
            x_own, f_own = self.own[stack.index][lane]
            gaps["f_gap"].append(gap(ans.f[lane], f))
            gaps["x_gap"].append(rel(x, x_own))
            gaps["f_excess"].append(gap(f, f_own))
            gaps["restoration_error"].append(rel(x, truths[lane]))
        return {k: max(v) for k, v in gaps.items()}
