"""``jobs.admm.admm_deconvolve``: one stack restored by ADMM with its
calibrated PSF (uniform weights, or the stack's per-voxel weights),
untracked: the CLI's ``--engine admm``. The traffic gives ``mu``,
``epsilon``, ``iters`` and ``over_relax``."""

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
        from microtipi_tpu_torch.jobs.admm import admm_deconvolve

        res = admm_deconvolve(stack.data, stack.psf, weights=stack.weights, config=self.config,
                              over_relax=self.traffic["over_relax"], track_objective=False)
        return Answer(stack.index, res.x, np.atleast_1d(res.f), np.atleast_1d(res.iterations),
                      np.atleast_1d(res.evaluations))
