#!/usr/bin/env python3
"""A CUDA kernel of this checkout against another checkout's, on one card.

    python3 chip_tv_ab.py OTHER [--kernel tv|tv_slab|tv_sweep|tv_depth|admm_split]

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

``--kernel tv_slab``: the TV kernel's slab entry through
``hyperbolic_tv_slab_fused`` at a 64-plane slab of 256^3 and a 16-plane
slab of 64x256x256 (both halo planes; ``kernel_ms``, ``device_ms``,
``call_ms`` as above), then one TV evaluation of 256^3 in four z-slabs on a
(1, 4) mesh of the one card through ``parallel.deconv._slab_tv`` (whatever
launches each tree makes: per-slab launches and halo copies, or one grouped
launch), with the device time of its TV kernels, of its copies and of all
its work per evaluation, its kernel launches per evaluation and its
``call_ms``, beside the whole-volume launch at 256^3 in the same process.
Costs and gradients are compared in ulp as above.

``--kernel tv_sweep``: OTHER's TV source only, no turns. Scratch copies of
its ``csrc/hyperbolic_tv.cu`` are built in a temporary directory with the
sweep's ``-D`` defines (the copy's ``#define``s of those it has become
``#ifndef``), all builds started together: the z range ``TV_ZR`` (4, 8, 16,
32), the ring depth ``TV_STAGES`` (4, 6) and, in a source with the grouped
slab launch, its resident blocks ``TV_GROUP_BLOCKS_PER_SM`` (3, 4). Each is loaded in place of the
tree's library, its wrapper's z ranges set to match, and timed by
``kernel_ms`` (CUDA events around 50 raw launches): the slab entry at the two
slabs above, the whole-volume launch at 256^3 and, where the tree has it,
the grouped launch of 256^3 in four slabs; with whether each output is
bitwise the first variant's. The copies also carry a timer of
``cuTensorMapEncodeTiled`` alone on the host (mean of 10000 encodes of the
64-plane slab's map).

``--kernel tv_depth``: OTHER's grouped slab launch alone, no turns (``.``
for this checkout): one slab of 256^2 planes with both halos at depths of
16 to 512 planes, each at z ranges 8 and 32 (the wrapper's z ranges set to
that one), ``kernel_ms`` by the profiler's device time of 50 launches and by
CUDA events; then, per z range, the least-squares line ``a + b * planes``
through the depths whose grid fills the card (``SLAB_BLOCKS`` blocks or
more): ``a`` the device time a launch costs whatever its depth, ``b`` a
plane's, beside the bytes bound of a plane (read once, written once).

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
import concurrent.futures
import ctypes
import json
import os
import re
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
#: (volume, first plane, end plane) of the slabs the tv_slab and tv_sweep modes time: a 64-plane slab of 256^3 (the
#: (1, 4) mesh's) and a 16-plane slab of 64x256x256 (RL-TV's and depthvar's on (1, 4)), both with their halo planes.
SLAB_AB = (((1, 256, 256, 256), 64, 128), ((1, 64, 256, 256), 16, 32))
GROUP_SLABS = 4  # z-slabs of the 256^3 evaluation on a (1, GROUP_SLABS) mesh of the one card
SWEEP_Z_RANGES, SWEEP_STAGES, SWEEP_BLOCKS_PER_SM = (4, 8, 16, 32), (4, 6), (3, 4)
#: The source's defines a sweep sets where the source has them: the z range of the whole-volume launch (and of a slab,
#: then a compile-time constant), the ring depth, the grouped kernel's resident blocks.
SWEEP_DEFINES = ("TV_ZR", "TV_STAGES", "TV_GROUP_BLOCKS_PER_SM")
ENCODE_REPS = 10000
#: Slab depths (planes of 256^2, both halos) and z ranges of the tv_depth mode.
DEPTH_PLANES, DEPTH_Z_RANGES = (16, 32, 64, 128, 256, 384, 512), (8, 32)
#: Appended to each sweep copy: cuTensorMapEncodeTiled alone, through the source's own encode_planes.
ENCODE_TIMER = r"""
#include <time.h>
extern "C" double tv_encode_ns(const void* base, int nx, int ny, long long depth, int reps) {
    CUtensorMap m;
    if (!encode_planes(&m, base, nx, ny, depth)) return -1.0;
    timespec t0, t1;
    clock_gettime(CLOCK_MONOTONIC, &t0);
    for (int i = 0; i < reps; ++i) encode_planes(&m, base, nx, ny, depth);
    clock_gettime(CLOCK_MONOTONIC, &t1);
    return ((t1.tv_sec - t0.tv_sec) * 1e9 + (t1.tv_nsec - t0.tv_nsec)) / reps;
}
"""


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


def device_classes(prof, name: str, calls: int) -> dict:
    """Per call: device ms of the kernels whose name holds ``name``, of
    copies (memcpy and copy kernels), of all device work, and how many
    ``name`` kernels ran."""
    kernel = copies = total = 0.0
    count = 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        total += ev.device_time_total
        if name in ev.name:
            kernel += ev.device_time_total
            count += 1
        elif "memcpy" in ev.name.lower() or "copy" in ev.name.lower():
            copies += ev.device_time_total
    if kernel == 0.0:
        raise RuntimeError(f"the trace holds no {name} kernel")
    return {"kernel_ms": kernel / calls / 1e3, "copy_ms": copies / calls / 1e3, "device_ms": total / calls / 1e3,
            "kernel_launches": count / calls}


def traced(fn, name: str = "hyperbolic_tv") -> dict:
    """:func:`device_classes` of CALLS back-to-back calls of ``fn`` after 5
    warm-up calls; a trace that comes back without the kernel is retaken."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        try:
            return device_classes(prof, name, CALLS)
        except RuntimeError:
            if attempt == 2:
                raise


def _save(save: str | None, i: int, costs: torch.Tensor, grad: torch.Tensor) -> None:
    if save:
        os.makedirs(save, exist_ok=True)
        np.save(os.path.join(save, f"{i}_costs.npy"), costs.reshape(-1).cpu().numpy())
        np.save(os.path.join(save, f"{i}_grad.npy"), grad.cpu().numpy())


def slab_worker(root: str, save: str | None) -> dict:
    """The slab numbers of the tree at ``root`` (``--kernel tv_slab``); the
    outputs go to ``save`` as in :func:`worker`, the two slabs as 0 and 1,
    the four-slab evaluation as 2."""
    hv = import_tree(root, "hyperbolic_tv")
    from microtipi_tpu_torch.parallel import deconv as pd
    from microtipi_tpu_torch.parallel import make_mesh, shard

    dev = torch.device("cuda", 0)
    out = {"root": root, "slabs": []}
    for i, (vol, a, b) in enumerate(SLAB_AB):
        x = torch.as_tensor(np.random.default_rng(i).standard_normal(vol, dtype=np.float32), device=dev)
        slab, prev, nxt = x[:, a:b].contiguous(), x[:, a - 1].contiguous(), x[:, b].contiguous()

        def call():
            return hv.hyperbolic_tv_slab_fused(slab, prev, nxt, 1.0)

        row = {"slab": list(slab.shape), **traced(call), "call_ms": cs._median_ms(call)}
        hv.slab_launches = 0
        costs, grad = call()
        row["slab_launches"], row["slabs_launched"] = hv.slab_launches, getattr(hv, "slabs_launched", None)
        out["slabs"].append(row)
        _save(save, i, costs, grad)
        del x, slab, prev, nxt, costs, grad

    x = torch.as_tensor(np.random.default_rng(2).standard_normal(SLAB_AB[0][0][1:], dtype=np.float32), device=dev)
    xs = shard(x, make_mesh(1, GROUP_SLABS, devices=[dev] * GROUP_SLABS))

    def evaluate():
        return pd._slab_tv(xs, 1.0, None)

    row = {"volume": list(x.shape), "slabs": GROUP_SLABS, **traced(evaluate), "call_ms": cs._median_ms(evaluate)}
    hv.slab_launches = 0
    total, grads = evaluate()
    row["slab_launches"], row["slabs_launched"] = hv.slab_launches, getattr(hv, "slabs_launched", None)
    whole = traced(lambda: hv.hyperbolic_tv_fused(x, 1.0))
    row["whole_kernel_ms"] = whole["kernel_ms"]
    row["whole_call_ms"] = cs._median_ms(lambda: hv.hyperbolic_tv_fused(x, 1.0))
    out["group"] = row
    _save(save, 2, total, torch.cat(grads, 0))
    return out


def _sweep_cases(hv, dev):
    """(label, prepare) of the sweep's launches in the tree whose wrapper
    module is ``hv``: the two slabs of SLAB_AB with both halos, the 256^3
    volume whole, and (where the tree has a grouped slab launch) the 256^3
    volume as GROUP_SLABS slabs of one launch reading each other's planes.
    ``prepare()`` returns (launch, read, grid): ``read()`` gives the costs and
    the gradient from the buffers the launch writes."""
    grouped = hasattr(hv, "prepare_slabs")
    cases = []
    for i, (vol, a, b) in enumerate(SLAB_AB):
        x = torch.as_tensor(np.random.default_rng(i).standard_normal(vol, dtype=np.float32), device=dev)
        t, prev, nxt = x[:, a:b].contiguous(), x[:, a - 1].contiguous(), x[:, b].contiguous()
        if grouped:
            def prepare(t=t, prev=prev, nxt=nxt):
                launch, costs, grads, geo = hv.prepare_slabs([t], [prev], [nxt], 1.0)
                return launch, lambda: (costs[0], grads[0]), geo.grid
        else:
            def prepare(t=t, prev=prev, nxt=nxt):
                launch, costs, grad, geo = hv.prepare_launch(t, 1.0, None, prev, nxt)
                return launch, lambda: (costs, grad), geo.grid
        cases.append((f"slab {list(t.shape)}", prepare))
    whole = torch.as_tensor(np.random.default_rng(2).standard_normal(SLAB_AB[0][0][1:], dtype=np.float32),
                            device=dev)

    def prepare_whole():
        launch, costs, grad, geo = hv.prepare_launch(whole, 1.0)
        return launch, lambda: (costs, grad), geo.grid

    cases.append((f"whole {list(whole.shape)}", prepare_whole))
    if grouped:
        slabs = list(whole[None].chunk(GROUP_SLABS, 1))
        slabs = [t.contiguous() for t in slabs]

        def prepare_group():
            launch, costs, grads, geo = hv.prepare_slabs(slabs, [None] + [t[:, -1] for t in slabs[:-1]],
                                                         [t[:, 0] for t in slabs[1:]] + [None], 1.0)
            return launch, lambda: (torch.cat(costs), torch.cat(grads, 1)), geo.grid

        cases.append((f"group of {GROUP_SLABS} slabs of {list(whole.shape)}", prepare_group))
    return cases


def sweep_worker(root: str) -> dict:
    """``--kernel tv_sweep`` on the tree at ``root``: its TV source built
    with every variant of the sweep's defines (those the source has), each
    timed through the tree's own wrapper."""
    hv = import_tree(root, "hyperbolic_tv")
    import microtipi_tpu_torch._build as build

    text = (build.CSRC_DIR / "hyperbolic_tv.cu").read_text()
    names = [n for n in SWEEP_DEFINES if re.search(rf"^#define {n} ", text, flags=re.M)]
    for name in names:
        text = re.sub(rf"^#define {name} (\S+)", rf"#ifndef {name}\n#define {name} \1\n#endif", text, flags=re.M)
    grouped = "TV_GROUP_BLOCKS_PER_SM" in names
    variants = [{"TV_ZR": zr, "TV_STAGES": st, **({"TV_GROUP_BLOCKS_PER_SM": bps} if grouped else {})}
                for bps in (SWEEP_BLOCKS_PER_SM if grouped else (None,)) for st in SWEEP_STAGES
                for zr in SWEEP_Z_RANGES]
    dev = torch.device("cuda", 0)
    out = {"root": root, "variants": []}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "hyperbolic_tv.cu")
        with open(src, "w") as f:
            f.write(text + ENCODE_TIMER)

        def nvcc(i):
            lib = os.path.join(tmp, f"libtv_{i}.so")
            proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS,
                                   *(f"-D{k}={v}" for k, v in variants[i].items()), src, "-o", lib],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {variants[i]}:\n{proc.stderr[-3000:]}")
            return lib, [ln for ln in proc.stderr.splitlines() if "registers" in ln or "spill" in ln]

        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            libs = list(pool.map(nvcc, range(len(variants))))
        cases = _sweep_cases(hv, dev)
        first = {}
        default_ranges = hv.Z_RANGE, getattr(hv, "SLAB_Z_RANGES", None)
        for variant, (lib, ptxas) in zip(variants, libs):
            build.load_library = lambda name, _lib=lib: ctypes.CDLL(_lib)
            hv._library.cache_clear()
            hv.Z_RANGE = variant["TV_ZR"]
            if grouped:
                hv.SLAB_Z_RANGES = (variant["TV_ZR"],)
            row = {"defines": variant, "ptxas": ptxas, "cases": []}
            for label, prepare in cases:
                launch, read, grid = prepare()
                ms = cs.raw_ms(launch)
                launch()
                torch.cuda.synchronize()
                costs, grad = read()
                same = None
                if label in first:
                    same = bool(torch.equal(grad, first[label][1])) and bool(torch.equal(costs, first[label][0]))
                else:
                    first[label] = (costs.clone(), grad.clone())
                row["cases"].append({"case": label, "kernel_ms": ms, "grid": list(grid), "bitwise_first": same})
                del launch, read, costs, grad
            lib_h = ctypes.CDLL(lib)
            lib_h.tv_encode_ns.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_int]
            lib_h.tv_encode_ns.restype = ctypes.c_double
            slab = torch.empty(SLAB_AB[0][0][0], SLAB_AB[0][2] - SLAB_AB[0][1], *SLAB_AB[0][0][2:], device=dev)
            row["encode_us"] = lib_h.tv_encode_ns(slab.data_ptr(), slab.shape[-1], slab.shape[-2],
                                                  slab.shape[0] * slab.shape[1], ENCODE_REPS) / 1e3
            out["variants"].append(row)
        hv.Z_RANGE, slab_ranges = default_ranges
        if grouped:
            hv.SLAB_Z_RANGES = slab_ranges
    return out


def depth_worker(root: str) -> dict:
    """``--kernel tv_depth`` on the tree at ``root``: its grouped slab launch
    of one slab at DEPTH_PLANES and DEPTH_Z_RANGES."""
    hv = import_tree(root, "hyperbolic_tv")
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((1, max(DEPTH_PLANES) + 2, 256, 256),
                                                                 dtype=np.float32), device="cuda")
    out, default = {"root": root, "rows": []}, hv.SLAB_Z_RANGES
    try:
        for zr in DEPTH_Z_RANGES:
            hv.SLAB_Z_RANGES = (zr,)
            for d in DEPTH_PLANES:
                slab, prev, nxt = x[:, 1:d + 1].contiguous(), x[:, 0].contiguous(), x[:, d + 1].contiguous()
                launch, _, _, geo = hv.prepare_slabs([slab], [prev], [nxt], 1.0)
                out["rows"].append({"z_range": zr, "planes": d, "grid": list(geo.grid),
                                    "kernel_ms": traced(launch)["kernel_ms"], "events_ms": cs.raw_ms(launch)})
                del slab, prev, nxt, launch
    finally:
        hv.SLAB_Z_RANGES = default
    out["slab_blocks"] = hv.SLAB_BLOCKS
    return out


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


def report_sweep(card: str, run: dict) -> int:
    for v in run["variants"]:
        cases = "; ".join(f"{c['case']} grid {c['grid']} {c['kernel_ms']:.4f} ms"
                          + ("" if c["bitwise_first"] is None else f" (bitwise: {c['bitwise_first']})")
                          for c in v["cases"])
        print(f"[sweep] [{card}] {v['defines']}: kernel_ms {cases}; "
              f"cuTensorMapEncodeTiled {v['encode_us']:.3f} us; {' | '.join(v['ptxas'])}", flush=True)
    print(json.dumps({"card": card, "kernel": "tv_sweep", **run}))
    return 0


def report_depth(card: str, run: dict) -> int:
    plane_ms = cs.slab_bound(256 * 256, 0, 2, 0, cs.TV_OPS_PER_VOXEL)[0]  # a plane read once and written once
    fits = []
    for r in run["rows"]:
        blocks = r["grid"][0] * r["grid"][1] * r["grid"][2]
        bound = cs.slab_bound(r["planes"] * 256 * 256, 256 * 256, 2, 2, cs.TV_OPS_PER_VOXEL)[0]
        print(f"[depth] [{card}] slab (1, {r['planes']}, 256, 256), z range {r['z_range']}, grid {r['grid']} "
              f"({blocks} blocks): kernel_ms {r['kernel_ms']:.5f} by the profiler, {r['events_ms']:.5f} by events; "
              f"bound {bound:.5f} ms, {bound / r['kernel_ms']:.1%} of it",
              flush=True)
    for zr in DEPTH_Z_RANGES:
        full = [r for r in run["rows"] if r["z_range"] == zr
                and r["grid"][0] * r["grid"][1] * r["grid"][2] >= run["slab_blocks"]]
        for key in ("kernel_ms", "events_ms"):
            b, a = np.polyfit([r["planes"] for r in full], [r[key] for r in full], 1)
            fits.append({"z_range": zr, "by": key, "planes": [r["planes"] for r in full], "a_ms": float(a),
                         "b_ms": float(b), "plane_bound_ms": plane_ms, "b_bound_share": plane_ms / float(b)})
            print(f"[depth] [{card}] z range {zr}, {key} over {fits[-1]['planes']} planes: {a * 1e3:.2f} us a "
                  f"launch + {b * 1e3:.4f} us a plane; a plane's bound {plane_ms * 1e3:.4f} us, "
                  f"{plane_ms / b:.1%} of it", flush=True)
    print(json.dumps({"card": card, "kernel": "tv_depth", **run, "fits": fits}))
    return 0


def report_slab(card: str, root: str, runs: dict, diffs: list) -> int:
    result = {"card": card, "other": root, "kernel": "tv_slab", "slabs": [], "group": {}}
    keys = ("kernel_ms", "device_ms", "call_ms", "kernel_launches", "slab_launches", "slabs_launched")
    for i, (vol, a, b) in enumerate(SLAB_AB):
        nvox, plane = (b - a) * vol[2] * vol[3], vol[2] * vol[3]
        row = {"slab": [1, b - a, *vol[2:]], **diffs[i],
               "bound_ms": cs.slab_bound(nvox, plane, 2, 2, cs.TV_OPS_PER_VOXEL)[0]}
        for key in keys:
            row[key] = {who: [r["slabs"][i][key] for r in rs] for who, rs in runs.items()}
        result["slabs"].append(row)
        t = {k: ", ".join(f"{who} {row[k][who]}" for who in ("other", "this")) for k in keys}
        print(f"[ab] [{card}] slab {row['slab']} with both halos: kernel_ms {t['kernel_ms']}; device_ms "
              f"{t['device_ms']}; call_ms {t['call_ms']} (turns other, this, this, other); kernels a call "
              f"{t['kernel_launches']}; gradients: {row['grad_elements_differing']} elements differ, largest "
              f"{row['grad_max_ulp']} ulp; costs {row['cost_max_rel']:.3g} rel; bound {row['bound_ms']:.4f} ms, "
              f"this at {row['bound_ms'] / min(row['kernel_ms']['this']):.1%}, other at "
              f"{row['bound_ms'] / min(row['kernel_ms']['other']):.1%}", flush=True)
    vol = SLAB_AB[0][0][1:]
    nvox, plane = int(np.prod(vol)), vol[1] * vol[2]
    row = {"volume": list(vol), "slabs": GROUP_SLABS, **diffs[len(SLAB_AB)],
           "bound_ms": cs.slab_bound(nvox, plane, 2, 2 * (GROUP_SLABS - 1), cs.TV_OPS_PER_VOXEL)[0]}
    keys = (*keys, "copy_ms", "whole_kernel_ms", "whole_call_ms")
    for key in keys:
        row[key] = {who: [r["group"][key] for r in rs] for who, rs in runs.items()}
    result["group"] = row
    t = {k: ", ".join(f"{who} {row[k][who]}" for who in ("other", "this")) for k in keys}
    print(f"[ab] [{card}] TV of {vol} in {GROUP_SLABS} slabs on (1, {GROUP_SLABS}) of the one card, an evaluation: "
          f"TV kernel_ms {t['kernel_ms']}; copies {t['copy_ms']} ms; device_ms {t['device_ms']}; call_ms "
          f"{t['call_ms']}; TV kernels {t['kernel_launches']}, slab_launches {t['slab_launches']}, slabs_launched "
          f"{t['slabs_launched']}; whole-volume kernel_ms {t['whole_kernel_ms']}, call_ms {t['whole_call_ms']}; "
          f"costs {row['cost_max_rel']:.3g} rel, gradients {row['grad_elements_differing']} elements differ "
          f"(largest {row['grad_max_ulp']} ulp); bound {row['bound_ms']:.4f} ms, this at "
          f"{row['bound_ms'] / min(row['kernel_ms']['this']):.1%}", flush=True)
    print(json.dumps(result))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root", help="the other checkout's root (with --worker: the tree to measure)")
    ap.add_argument("--kernel", choices=("tv", "tv_slab", "tv_sweep", "tv_depth", "admm_split"), default="tv")
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
        elif args.kernel == "tv_slab":
            print(json.dumps(slab_worker(root, args.save)))
        elif args.kernel == "tv_sweep":
            print(json.dumps(sweep_worker(root)))
        elif args.kernel == "tv_depth":
            print(json.dumps(depth_worker(root)))
        else:
            print(json.dumps(admm_worker(root, args.states, args.save, args.against)))
        return 0
    module = "admm_split" if args.kernel == "admm_split" else "hyperbolic_tv"
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

    if args.kernel == "tv_sweep":
        return report_sweep(card, json.loads(run([root, "--worker"]).strip().splitlines()[-1]))
    if args.kernel == "tv_depth":
        return report_depth(card, json.loads(run([root, "--worker"]).strip().splitlines()[-1]))

    with tempfile.TemporaryDirectory() as tmp:
        states = os.path.join(tmp, "states")
        if args.kernel == "admm_split":
            run([here, "--capture", "--states", states])
        for who in ("other", "this", "this", "other"):
            cmd = [root if who == "other" else here, "--worker", "--states", states]
            if not runs[who]:
                if args.kernel != "admm_split" or who == "other":
                    cmd += ["--save", os.path.join(tmp, who)]
                else:
                    cmd += ["--against", os.path.join(tmp, "other")]
            runs[who].append(json.loads(run(cmd).strip().splitlines()[-1]))
        if args.kernel != "admm_split":
            outputs = len(SHAPES) if args.kernel == "tv" else len(SLAB_AB) + 1
            diffs = [compare(os.path.join(tmp, "this"), os.path.join(tmp, "other"), i) for i in range(outputs)]

    if args.kernel == "tv_slab":
        return report_slab(card, root, runs, diffs)

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
