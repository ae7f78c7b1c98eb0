"""``correct`` comes out false for the control (the reference in bfloat16 in
the program's place) and for each fault a cell can have, planted under a
whole run of the harness at a tiny grid on the CPU; and true for the port."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from benchmark.cell import ROOT, load_cell, run_cell
from conftest import tiny_spec

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
# A unit of a multichannel configuration is a batch, which can have half of it left out.
FAULTS = [(w, f) for w in CELLS for f in ("unchanged", "half_batch", "altered")
          if f != "half_batch" or len(load_cell(w)["config"]["channels"]) > 1]
SEED = 2 ** 31 + 29


def _run(workload, factory):
    result, _ = run_cell(workload, SEED, 2.0, False, t0=time.perf_counter(), device="cpu",
                         spec=tiny_spec(workload), engine_factory=factory)
    return result


class _Faulty:
    """The port's entry with a fault planted where its answer is produced."""

    fault = entry = None

    def __init__(self, traffic, config, device):
        if self.fault == "unchanged":  # every step returns the state it was given
            traffic = dict(traffic, iters=0)
        self.program = self.entry.program(traffic, config, device)

    def run(self, stack, warm=False):
        if self.fault == "half_batch" and stack.data.ndim == 4:  # half the lanes left out
            keep = (stack.data.shape[0] + 1) // 2
            ans = self.program.run(stack._replace(data=stack.data[:keep], psf=stack.psf[:keep]), warm)
            rest = torch.clamp_min(stack.data[keep:], 0.0)
            return ans._replace(x=torch.cat([ans.x, rest]), f=np.concatenate([ans.f, ans.f[-1:].repeat(len(rest))]))
        ans = self.program.run(stack, warm)
        if self.fault == "altered":  # the answer altered where it is produced
            x = ans.x.clone()
            x[..., 0, :, :] = 0.0
            ans = ans._replace(x=x)
        return ans


def _faulty(workload, fault):
    return type(f"Faulty_{fault}", (_Faulty,), {"fault": fault, "entry": load_cell(workload)["entry"]})


@pytest.mark.parametrize("workload", CELLS)
def test_the_port_is_correct(workload):
    assert _run(workload, None)["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    reference = load_cell(workload)["entry"].reference
    result = _run(workload, lambda t, c, d: reference(t, c, d, "bfloat16"))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_planted_fault_is_not_correct(workload, fault):
    result = _run(workload, _faulty(workload, fault))
    assert not result["correct"], result["checks"]
