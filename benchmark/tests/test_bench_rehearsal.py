"""A rehearsal of every cell on the CPU at a tiny grid: the whole run (the
stacks from the seed, the warm-up, the window, a traced window, the check,
the readers) with the port's plain kernels. The command itself refuses to
run without a card."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest

from benchmark.cell import ROOT, run_cell
from conftest import tiny_spec

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_cell_runs_end_to_end_on_the_cpu(workload, trace):
    spec = tiny_spec(workload)
    result, lines = run_cell(workload, 2 ** 31 + 11, 2.0, trace, t0=time.perf_counter(), device="cpu", spec=spec)
    assert list(result)[-1] == "checks" and set(spec["limits"]) <= set(result["checks"])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert result["attempted"] >= 1 and result["failed"] == 0
    names = {m["name"] for m in (spec["per_layer"] if trace else spec["end_to_end"])}
    assert set(result["metrics"]) <= names
    if not trace:
        assert set(result["metrics"]) == names and all(m["value"] > 0 for m in result["metrics"].values())
    else:
        assert "busy_s" in result["device"] and "breakdown" in result
    assert lines[-len(result["checks"]):] == [f"check {k}: {v['value']!r} limit {v['limit']!r}"
                                               for k, v in result["checks"].items()]


def test_the_same_seed_makes_the_same_stacks():
    import torch

    from benchmark import scene

    config = tiny_spec(CELLS[0])["config"]
    a, b = (scene.make_stack(config, 2 ** 31 + 3, 1, torch.device("cpu")) for _ in range(2))
    assert torch.equal(a.data, b.data) and torch.equal(a.psf, b.psf)
    assert not torch.equal(a.data, scene.make_stack(config, 2 ** 31 + 4, 1, torch.device("cpu")).data)


def test_the_command_refuses_without_a_card_and_prints_no_result():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"}, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_a_cell_is_correct_on_the_card(card, workload):
    result, _ = run_cell(workload, 2 ** 31 + 101, 2.0, False, t0=time.perf_counter(), device=card)
    assert result["correct"], result["checks"]
