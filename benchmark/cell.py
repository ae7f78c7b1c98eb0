"""One run of one cell: set-up, the measured window, the check, the metrics.

Everything that belongs to one cell is data found by name:
``BENCHMARK.json`` names the cell's configuration, traffic mix and metrics;
``configs/<config>.json`` holds the optics, grid and scene;
``traffic/<mix>.json`` the port entry the window drives, its solver
settings and the window's ring of stacks; ``entries/<entry>.py`` the port
call, the plain reference in its place and the checker (``entry.py``);
``limits/<cell>.json`` the numbers ``correct`` holds and their limits;
``end_to_end/<metric>.py`` and ``metrics/<metric>.py`` one reader each,
a per-layer reader with the port's counters it reads (``COUNTERS``).

The window is a closed loop with one client: it runs whole units (one stack
restored) back to back over a ring of stacks made from the seed, each unit
ending in a device synchronisation, until ``seconds`` have passed. A traced
run holds the profiler over the first ``trace_units`` units of its window
and reports the per-layer metrics of that slice.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import random
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from benchmark import check, entry as entries, readers, scene, trace as tracing

__all__ = ["ROOT", "Run", "forbidden_modules", "load_cell", "load_pair", "run_cell"]

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "microtipi_tpu")


class Run(NamedTuple):
    """What the end-to-end readers read."""

    setup_s: float
    t_start: float
    seconds: float
    units: list  # (t_end, voxel-iterations) of each completed unit


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_pair(config: str, traffic: str) -> dict:
    """A configuration and a traffic mix by name."""
    pair = {"config": _json(HERE / "configs" / f"{config}.json"), "traffic": _json(HERE / "traffic" / f"{traffic}.json")}
    pair["entry"] = entries.load(pair["traffic"]["entry"])
    return pair


def load_cell(workload: str, root: Path = ROOT) -> dict:
    """The cell's entry in ``BENCHMARK.json``, its configuration, traffic,
    port entry, limits and metric lists."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return {"cell": cell, **load_pair(cell["config"], cell["traffic"]),
            "limits": _json(HERE / "limits" / f"{workload}.json"),
            "end_to_end": mine(bench["end_to_end"]), "per_layer": mine(bench["per_layer"])}


def _reader(kind: str, name: str):
    """The module ``<kind>/<name>.py``: its ``read``, and the port's
    ``COUNTERS`` it reads, if any."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


class _Sample:
    """A uniform sample of ``k`` answers among all the window's, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.kept, self.seen = k, random.Random(seed), [], 0

    def offer(self, ans) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(ans)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.kept[j] = ans


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, t0: float, device="cuda", spec=None,
             engine_factory=None) -> tuple[dict, list[str]]:
    """``(result, check_lines)`` of one run. ``spec`` (default
    :func:`load_cell`) may carry a smaller configuration for a rehearsal on
    the CPU; ``engine_factory(traffic, config, device)`` puts another engine
    in the program's place (the control, or a fault in a test)."""
    spec = spec or load_cell(workload)
    config, traffic, chips, entry = spec["config"], spec["traffic"], spec["cell"]["chips"], spec["entry"]
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA card: torch.cuda.is_available() is False")
        if torch.cuda.device_count() < chips:
            raise SystemExit(f"the cell needs {chips} cards, {torch.cuda.device_count()} are visible")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    marks = [("imports", time.perf_counter())]
    ring = [scene.make_stack(config, seed, i, dev, traffic.get("weights")) for i in range(traffic["ring"])]
    lane_voxels = int(np.prod(config["grid"]))
    _sync(dev)
    marks.append(("stacks", time.perf_counter()))
    engine = (engine_factory or entry.program)(traffic, config, dev)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    marks.append(("engine", time.perf_counter()))
    engine.run(ring[0], warm=True)
    _sync(dev)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    setup_parts = {name: round(t - prev, 4) for (name, t), prev in zip(marks, [t0] + [t for _, t in marks])}

    sample = _Sample(traffic["sample"], seed)
    units, traced, attempted, failed = [], [], 0, 0
    layer_readers = [(m, _reader("metrics", m["name"])) for m in spec["per_layer"]] if trace else []
    counted = {k: v for _, r in layer_readers for k, v in getattr(r, "COUNTERS", {}).items()}
    readers.reset_counters(counted)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.__enter__()
    t_start = time.perf_counter()
    while True:
        now = time.perf_counter()
        if (trace and attempted >= traffic["trace_units"]) or (not trace and now - t_start >= seconds):
            break
        ans = engine.run(ring[attempted % len(ring)])
        _sync(dev)
        t_end = time.perf_counter()
        attempted += 1
        failed += int(not np.all(np.isfinite(ans.f)))
        units.append((t_end, lane_voxels * int(np.sum(ans.iterations))))
        if trace:  # the readers need the counts only: keep no volume of an answer not sampled
            traced.append(ans._replace(x=None))
        sample.offer(ans)
        del ans
    window_end = time.perf_counter()
    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        summary = tracing.summarize(prof.events(), window_end - t_start)
        del prof
    counters = readers.read_counters(counted)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    kept = sample.kept
    del engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    checker = entry.checker(traffic, config, dev)
    readings = [checker.readings(ring[a.stack], a) if check.finite(a) else {"finite": float("inf")} for a in kept]
    correct, checks = check.judge(readings, spec["limits"])

    run = Run(setup_s, t_start, seconds, units)
    metrics = {}
    if not trace:
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": float(_reader("end_to_end", m["name"]).read(run)), "unit": m["unit"]}
    else:
        ctx = readers.Context(summary, counters, traced, lane_voxels, len(config["channels"]), traffic)
        for m, reader in layer_readers:
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct and failed == 0), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    recorded = {k: max(r[k] for r in readings if k in r) for k in sorted({k for r in readings for k in r})
                if k not in spec["limits"]}
    lines = [f"setup: {json.dumps(setup_parts)}",
             f"recorded: {json.dumps(recorded)} (answers judged: {len(readings)}, readings: {json.dumps(readings)})"]
    lines += [f"check {k}: {v['value']!r} limit {v['limit']!r}" for k, v in checks.items()]
    return result, lines
