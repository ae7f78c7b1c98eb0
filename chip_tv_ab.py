#!/usr/bin/env python3
"""A CUDA kernel of this checkout against another checkout's, on one card.

    python3 chip_tv_ab.py OTHER [--kernel tv|admm_split]

``OTHER`` is the root of another checkout of the repo, for example an
earlier commit unpacked into a git-ignored directory:

    mkdir -p .chipwork/parent && git archive <commit> | tar -x -C .chipwork/parent

Each tree runs in a process of its own, in turns other, this, this, other.
A process imports its own tree's ``microtipi_tpu_torch`` (which builds its
kernels from its own sources into its own ``_build/``) and calls wrappers
that every version has.

``--kernel tv`` (the default): ``hyperbolic_tv_fused`` and
``hyperbolic_tv_batched_fused`` at 256^3, 4x64x256x256 and 4x256^3 (eps 1,
unit scales):

- ``kernel_ms``: the device time of the kernels named ``hyperbolic_tv`` per
  evaluation, from torch.profiler over 50 back-to-back wrapper calls;
- ``device_ms``: all device time per evaluation in the same trace (the
  kernel and whatever else the wrapper launches);
- ``call_ms``: CUDA events around one wrapper call into an idle queue,
  median of 20;

and the host time of one wrapper call at 8x16x64 (mean of 2000).

``--kernel admm_split``: ``admm_split_update`` with over-relaxation 1.8 and
1 on the random states of ``chip_smoke.py`` phase 9 at 256^3, 4x64x256x256
and 4x256^3 and on the 256^3 bench solve's iteration-10 states, captured
once by this tree and loaded by both: ``kernel_ms`` is the profiler's device
time of the kernels named ``admm_split_update`` per launch, over 20 launches
each on a fresh copy of the state.

The first process of each tree saves its outputs, and the two trees' are
compared: elements that differ, largest difference in float32 ulp. The
card's name and power limit come first, one JSON object of every number
last. Without a CUDA card it exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs  # this checkout's, beside this file: times and bounds measured alike for both trees

SHAPES = ((256, 256, 256), (4, 64, 256, 256), (4, 256, 256, 256))
HOST_SHAPE = (8, 16, 64)
CALLS = 50
ADMM_SHAPES = ((1, *SHAPES[0]), SHAPES[1], SHAPES[2])
ADMM_LAUNCHES = 20
SOLVE_ITERATION = 10


def import_tree(root: str, module: str):
    """``microtipi_tpu_torch.ops.kernels.<module>`` of the tree at ``root``."""
    import importlib

    sys.path.insert(0, root)
    mod = importlib.import_module(f"microtipi_tpu_torch.ops.kernels.{module}")
    if not os.path.abspath(mod.__file__).startswith(os.path.join(root, "")):
        raise RuntimeError(f"imported {mod.__file__}, not the tree at {root}")
    return mod


def device_us(prof, name: str) -> tuple[float, float]:
    """(device µs of the kernels whose name holds ``name``, all device µs) in a trace."""
    kernel = total = 0.0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            total += ev.device_time_total
            kernel += ev.device_time_total if name in ev.name else 0.0
    if kernel == 0.0:
        raise RuntimeError(f"the trace holds no {name} kernel")
    return kernel, total


def worker(root: str, save: str | None) -> dict:
    """The TV numbers of the tree at ``root``; its costs and gradients go to
    ``save`` (one ``.npy`` each per shape) if given."""
    from torch.profiler import ProfilerActivity, profile

    hv = import_tree(root, "hyperbolic_tv")
    out = {"root": root, "shapes": []}
    for i, shape in enumerate(SHAPES):
        x = torch.as_tensor(np.random.default_rng(0).standard_normal(shape, dtype=np.float32), device="cuda")
        fused = hv.hyperbolic_tv_batched_fused if x.ndim == 4 else hv.hyperbolic_tv_fused
        for _ in range(5):
            costs, grad = fused(x, 1.0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fused(x, 1.0)
            torch.cuda.synchronize()
        tv_us, all_us = device_us(prof, "hyperbolic_tv")
        out["shapes"].append({"shape": list(shape), "kernel_ms": tv_us / CALLS / 1e3,
                              "device_ms": all_us / CALLS / 1e3,
                              "call_ms": cs._median_ms(lambda: fused(x, 1.0))})
        if save:
            os.makedirs(save, exist_ok=True)
            np.save(os.path.join(save, f"{i}_costs.npy"), costs.reshape(-1).cpu().numpy())
            np.save(os.path.join(save, f"{i}_grad.npy"), grad.cpu().numpy())
        del x, costs, grad

    x = torch.as_tensor(np.random.default_rng(1).standard_normal(HOST_SHAPE, dtype=np.float32), device="cuda")
    for _ in range(50):
        hv.hyperbolic_tv_fused(x, 1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        hv.hyperbolic_tv_fused(x, 1.0)
    out["host_us"] = (time.perf_counter() - t0) / 2000 * 1e6
    torch.cuda.synchronize()
    return out


def capture(states: str) -> None:
    """The split update's inputs at iteration SOLVE_ITERATION of the 256^3
    bench solve (phase 10's scene and config), over-relaxed 1.8 and 1, saved
    to ``states`` for both trees' workers."""
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig

    _, data, psf = cs.bench_scene(SHAPES[0], torch.device("cuda"), torch.float32)
    cfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=SOLVE_ITERATION, grtol=0.0, gatol=0.0)
    os.makedirs(states, exist_ok=True)
    for alpha in cs.SOLVE_ALPHAS:
        tensors, args = cs.capture_split_states(data, psf, cfg, alpha)[SOLVE_ITERATION]
        torch.save({"tensors": tensors, "args": args}, os.path.join(states, f"solve_{alpha:g}.pt"))


def admm_cases(states: str):
    """(label, state tensors, update arguments): phase 9's random states at
    ADMM_SHAPES and the saved solve states, each over-relaxed 1.8 and 1."""
    for shape in ADMM_SHAPES:
        st = cs.admm_state(shape, seed=0)
        for alpha in cs.SOLVE_ALPHAS:
            yield f"random {shape}, alpha {alpha:g}", [st[k] for k in ("x", "z1", "u1", "z2", "u2", "lam")], \
                (1.0, alpha, True, None)
        del st
    for alpha in cs.SOLVE_ALPHAS:
        saved = torch.load(os.path.join(states, f"solve_{alpha:g}.pt"), map_location="cuda")
        yield f"solve iteration {SOLVE_ITERATION} {ADMM_SHAPES[0]}, alpha {alpha:g}", saved["tensors"], saved["args"]


def admm_worker(root: str, states: str, save: str | None, against: str | None) -> dict:
    """The split update's numbers of the tree at ``root``: device time per
    launch, each on a fresh copy of the state. At 256^3 its outputs go to
    ``save``, or are compared with those in ``against`` (in ulp)."""
    from torch.profiler import ProfilerActivity, profile

    ak = import_tree(root, "admm_split")
    out = {"root": root, "cases": []}
    for i, (label, tensors, args) in enumerate(admm_cases(states)):
        work = [t.clone() for t in tensors]

        def launch():
            for w, t in zip(work[1:5], tensors[1:5]):
                w.copy_(t)
            ak.admm_split_update(*work, *args)

        for _ in range(3):
            launch()
        torch.cuda.synchronize()
        for attempt in range(3):  # a trace has come back without the kernel's device events
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(ADMM_LAUNCHES):
                    launch()
                torch.cuda.synchronize()
            try:
                kernel_us = device_us(prof, "admm_split_update")[0]
                break
            except RuntimeError:
                if attempt == 2:
                    raise
        row = {"case": label, "shape": list(tensors[0].shape), "kernel_ms": kernel_us / ADMM_LAUNCHES / 1e3}
        if work[0].shape[0] == 1:
            path = os.path.join(save or against or "", f"{i}.pt")
            if save:
                os.makedirs(save, exist_ok=True)
                torch.save(work[1:5], path)
            elif against:
                diffs = [ulp_diff(a, b) for a, b in zip(work[1:5], torch.load(path, map_location="cuda"))]
                row["elements_differing"] = sum(d for d, _ in diffs)
                row["max_ulp"] = max(u for _, u in diffs)
                os.remove(path)
        out["cases"].append(row)
        del work, tensors
    return out


def ulp_diff(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int]:
    """Elements whose bit patterns differ, and the largest difference in
    float32 ulp between them."""
    ia, ib = a.view(torch.int32).long(), b.view(torch.int32).long()
    differ = ia != ib
    return int(differ.sum()), int((ia - ib).abs()[differ].max()) if bool(differ.any()) else 0


def compare(a_dir: str, b_dir: str, i: int) -> dict:
    """Elements of the gradients that differ, the largest difference in
    float32 ulp, and the largest relative cost difference, at shape ``i``."""
    ga, gb = (np.load(os.path.join(d, f"{i}_grad.npy")) for d in (a_dir, b_dir))
    fa, fb = (np.load(os.path.join(d, f"{i}_costs.npy")) for d in (a_dir, b_dir))
    differ = ga != gb  # +0 and -0 are equal
    ulp = np.abs(ga.view(np.int32).astype(np.int64) - gb.view(np.int32).astype(np.int64))[differ]
    return {"grad_elements_differing": int(differ.sum()), "grad_max_ulp": int(ulp.max(initial=0)),
            "cost_max_rel": float(np.max(np.abs(fa.astype(np.float64) - fb) / np.abs(fb)))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root", help="the other checkout's root (with --worker: the tree to measure)")
    ap.add_argument("--kernel", choices=("tv", "admm_split"), default="tv")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--save", help=argparse.SUPPRESS)
    ap.add_argument("--against", help=argparse.SUPPRESS)
    ap.add_argument("--states", help=argparse.SUPPRESS)
    ap.add_argument("--capture", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_tv_ab.py needs a CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    if args.capture:
        capture(args.states)
        return 0
    if args.worker:
        if args.kernel == "tv":
            print(json.dumps(worker(root, args.save)))
        else:
            print(json.dumps(admm_worker(root, args.states, args.save, args.against)))
        return 0
    module = {"tv": "hyperbolic_tv"}.get(args.kernel, args.kernel)
    if not os.path.isfile(os.path.join(root, "microtipi_tpu_torch", "ops", "kernels", f"{module}.py")):
        print(f"{root} is not a checkout of the repo with the {args.kernel} kernel", file=sys.stderr)
        return 2

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    runs = {"other": [], "this": []}

    def run(cmd):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), *cmd, "--kernel", args.kernel],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"{cmd} failed:\n{proc.stderr[-4000:]}")
        return proc.stdout

    with tempfile.TemporaryDirectory() as tmp:
        states = os.path.join(tmp, "states")
        if args.kernel == "admm_split":
            run([here, "--capture", "--states", states])
        for who in ("other", "this", "this", "other"):
            cmd = [root if who == "other" else here, "--worker", "--states", states]
            if not runs[who]:
                if args.kernel == "tv" or who == "other":
                    cmd += ["--save", os.path.join(tmp, who)]
                else:
                    cmd += ["--against", os.path.join(tmp, "other")]
            runs[who].append(json.loads(run(cmd).strip().splitlines()[-1]))
        if args.kernel == "tv":
            diffs = [compare(os.path.join(tmp, "this"), os.path.join(tmp, "other"), i) for i in range(len(SHAPES))]

    if args.kernel == "admm_split":
        result = {"card": card, "other": root, "kernel": args.kernel, "cases": []}
        for i, case in enumerate(runs["this"][0]["cases"]):
            volumes = cs.SPLIT_VOLUMES if case["case"].endswith("alpha 1") else cs.SPLIT_VOLUMES_RELAXED
            row = {**case, "bound_ms": cs.admm_bound(case["shape"], volumes, cs.SPLIT_OPS_RELAXED)[0],
                   "kernel_ms": {who: [r["cases"][i]["kernel_ms"] for r in rs] for who, rs in runs.items()}}
            result["cases"].append(row)
            same = (f"outputs: {row['elements_differing']} elements differ, largest {row['max_ulp']} ulp; "
                    if "max_ulp" in row else "")
            print(f"[ab] [{card}] admm_split_update on {case['case']}: kernel_ms "
                  + ", ".join(f"{who} {row['kernel_ms'][who]}" for who in ("other", "this"))
                  + f" (device time a launch, turns other, this, this, other); {same}bound {row['bound_ms']:.4f} "
                  f"ms, this at {row['bound_ms'] / min(row['kernel_ms']['this']):.1%}, other at "
                  f"{row['bound_ms'] / min(row['kernel_ms']['other']):.1%}", flush=True)
        print(json.dumps(result))
        return 0

    result = {"card": card, "other": root, "kernel": args.kernel, "shapes": [],
              "host_us": {who: [r["host_us"] for r in rs] for who, rs in runs.items()}}
    for i, shape in enumerate(SHAPES):
        row = {"shape": list(shape), **diffs[i], "bound_ms": cs.tv_bound(torch.empty(shape, device="meta"))[0]}
        for key in ("kernel_ms", "device_ms", "call_ms"):
            row[key] = {who: [r["shapes"][i][key] for r in rs] for who, rs in runs.items()}
        result["shapes"].append(row)
        t = {k: ", ".join(f"{who} {row[k][who]}" for who in ("other", "this")) for k in ("kernel_ms", "device_ms",
                                                                                           "call_ms")}
        print(f"[ab] [{card}] {shape}: kernel_ms {t['kernel_ms']}; device_ms {t['device_ms']}; call_ms "
              f"{t['call_ms']} (turns other, this, this, other); gradients: {diffs[i]['grad_elements_differing']} "
              f"elements differ, largest {diffs[i]['grad_max_ulp']} ulp; costs {diffs[i]['cost_max_rel']:.3g} rel; "
              f"bound {row['bound_ms']:.4f} ms, this at {row['bound_ms'] / min(row['kernel_ms']['this']):.1%}",
              flush=True)
    print(f"[host] [{card}] host us per wrapper call at {HOST_SHAPE} (mean of 2000): "
          + "; ".join(f"{who} {v}" for who, v in result["host_us"].items()), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
