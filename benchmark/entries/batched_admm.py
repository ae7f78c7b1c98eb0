"""``jobs.batch.batched_deconvolve`` with ``engine="admm"``: a multichannel
stack restored as one batch, a lane a channel, each with its calibrated
PSF, untracked. The traffic gives ``mu``, ``epsilon``, ``iters`` and
``over_relax``; the batched entry takes the port's default over-relaxation,
which the traffic states (1.8)."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import admm_lanes
from benchmark.entry import Answer

__all__ = ["checker", "program", "reference"]

reference = admm_lanes.Reference
checker = admm_lanes.Checker


class program:
    def __init__(self, traffic: dict, config: dict, device):
        from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig

        self.traffic, self.device = traffic, torch.device(device)
        self.config = DeconvolutionConfig(mu=traffic["mu"], epsilon=traffic["epsilon"], max_iter=traffic["iters"],
                                          grtol=0.0, gatol=0.0)

    def run(self, stack, warm: bool = False) -> Answer:
        from microtipi_tpu_torch.jobs.batch import batched_deconvolve

        res = batched_deconvolve(stack.data, stack.psf, weights=stack.weights, config=self.config, engine="admm")
        return Answer(stack.index, res.x, np.atleast_1d(res.f), np.atleast_1d(res.iterations),
                      np.atleast_1d(res.evaluations))
