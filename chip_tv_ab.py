#!/usr/bin/env python3
"""The hyperbolic-TV CUDA kernel of this checkout against another checkout's, on one card.

    python3 chip_tv_ab.py OTHER

``OTHER`` is the root of another checkout of the repo, for example an
earlier commit unpacked into a git-ignored directory:

    mkdir -p .chipwork/parent && git archive <commit> | tar -x -C .chipwork/parent

Each tree runs in a process of its own, in turns other, this, this, other.
A process imports its own tree's ``microtipi_tpu_torch`` (which builds its
kernel from its own sources into its own ``_build/``) and calls the two
wrappers every version has, ``hyperbolic_tv_fused`` and
``hyperbolic_tv_batched_fused``. At 256^3, 4x64x256x256 and 4x256^3 (eps 1,
unit scales) it reports:

- ``kernel_ms``: the device time of the kernels named ``hyperbolic_tv`` per
  evaluation, from torch.profiler over 50 back-to-back wrapper calls;
- ``device_ms``: all device time per evaluation in the same trace (the
  kernel and whatever else the wrapper launches);
- ``call_ms``: CUDA events around one wrapper call into an idle queue,
  median of 20;

and the host time of one wrapper call at 8x16x64 (mean of 2000). The first
process of each tree saves its costs and gradients, and the two trees'
are compared: elements that differ, largest difference in float32 ulp. The
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


def worker(root: str, save: str | None) -> dict:
    """The numbers of the tree at ``root``; its costs and gradients go to
    ``save`` (one ``.npy`` each per shape) if given."""
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, root)
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

    if not os.path.abspath(hv.__file__).startswith(os.path.join(root, "")):
        raise RuntimeError(f"imported {hv.__file__}, not the tree at {root}")
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
        tv_us = device_us = 0.0
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                device_us += ev.device_time_total
                tv_us += ev.device_time_total if "hyperbolic_tv" in ev.name else 0.0
        if tv_us == 0.0:
            raise RuntimeError(f"the trace at {shape} holds no hyperbolic_tv kernel")
        out["shapes"].append({"shape": list(shape), "kernel_ms": tv_us / CALLS / 1e3,
                              "device_ms": device_us / CALLS / 1e3,
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
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--save", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_tv_ab.py needs a CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    if args.worker:
        print(json.dumps(worker(root, args.save)))
        return 0
    if not os.path.isfile(os.path.join(root, "microtipi_tpu_torch", "ops", "kernels", "hyperbolic_tv.py")):
        print(f"{root} is not a checkout of the repo", file=sys.stderr)
        return 2

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    runs = {"other": [], "this": []}
    with tempfile.TemporaryDirectory() as tmp:
        for who in ("other", "this", "this", "other"):
            cmd = [sys.executable, os.path.abspath(__file__), root if who == "other" else here, "--worker"]
            if not runs[who]:
                cmd += ["--save", os.path.join(tmp, who)]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"the {who} tree's process failed:\n{proc.stderr[-4000:]}")
            runs[who].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        diffs = [compare(os.path.join(tmp, "this"), os.path.join(tmp, "other"), i) for i in range(len(SHAPES))]

    result = {"card": card, "other": root, "shapes": [],
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
