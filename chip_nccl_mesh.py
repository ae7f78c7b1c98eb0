#!/usr/bin/env python3
"""The sharded paths on a mesh over NCCL ranks, one CUDA card a rank.

    python3 chip_nccl_mesh.py

Run from the root of a checkout on a host with CUDA cards (H100s). It builds
the kernels (``chip_smoke.py`` phase 1), then spawns one process a card (as
many as divide ``chip_smoke.SLABS``, at most that many), each a rank of an
NCCL group (file rendezvous, ``chip_smoke.MP_GROUP_TIMEOUT_S``), which run
``chip_smoke.py`` phase 31's jobs (``chip_smoke.MP_JOBS``: the 256^3 VMLMB,
blind loop, ADMM and blind loop by ADMM, RL-TV and depthvar at 64x256x256 on
the (1, SLABS) mesh over the ranks, and VMLMB of one 256^3 volume on (2,
SLABS // 2)): the halo planes, the ADMM slabs' planes and the distributed
FFT's transposes go through NCCL's sends and receives between the cards, the
reductions through its all-gather. This process then runs the same jobs on
one process over the same cards, and over cuda:0 alone, and holds every rank
against each (bit for bit the aim, else within ``chip_smoke.SLAB_F_RTOL``;
a reference that fails is reported and fails the script at the end), checks
each rank's first TV slab launch, ADMM split update and rhs that took planes
from other ranks against their plain versions and times them here alone,
and prints the walls, the bytes sent between ranks by kind and the slab
launches (lines tagged as phase 31's), then one JSON line. On one card it runs one rank, where nothing crosses
ranks. Any failure exits non-zero.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import tempfile
import time
import traceback

import torch

import chip_smoke as cs


def rank_main(rank: int, world: int, tmp: str) -> None:
    """Rank ``rank``: the jobs on card ``rank``, saved to ``rank<rank>.pt``; a
    failure leaves its traceback in ``rank<rank>.err``."""
    import torch.distributed as dist

    try:
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl", world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=cs.MP_GROUP_TIMEOUT_S))
        try:
            out = cs._mp_jobs(dist.group.WORLD, [torch.device("cuda", rank)] * (cs.SLABS // world))
        finally:
            dist.destroy_process_group()
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(world: int, root: str) -> list:
    """Every rank's results (loaded onto cuda:0), once all exited 0 within
    ``chip_smoke.MP_DEADLINE_S``; ranks still running then are killed."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix=".chip_nccl_ranks_", dir=root) as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=rank_main, args=(r, world, tmp)) for r in range(world)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        end = time.monotonic() + cs.MP_DEADLINE_S
        try:
            for p in procs:
                p.join(max(0.0, end - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = [p.exitcode for p in procs]
        errors = "".join(open(os.path.join(tmp, f)).read() for f in sorted(os.listdir(tmp)) if f.endswith(".err"))
        if codes != [0] * world:
            raise AssertionError(f"NCCL ranks: exit codes {codes}\n{errors}")
        cs.log(31, f"{world} spawned NCCL ranks ran {time.perf_counter() - t0:.1f} s (start-up included)")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), map_location="cuda:0", weights_only=False)
                for r in range(world)]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_nccl_mesh.py needs CUDA cards: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import microtipi_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    card = cs.phase0_card()
    cs.phase1_build()
    world = max(w for w in range(1, min(torch.cuda.device_count(), cs.SLABS) + 1) if cs.SLABS % w == 0)
    ranks = spawn(world, root)
    name = f"NCCL, {world} processes, one card each"
    failures, line = [], {"world": world, "cards": torch.cuda.device_count()}
    cards = [torch.device("cuda", r) for r in range(world) for _ in range(cs.SLABS // world)]
    for label, devices in (("the same cards", cards), ("cuda:0", [torch.device("cuda", 0)] * cs.SLABS)):
        try:
            refs = cs._mp_jobs(None, devices)
            counts = cs._mp_check(f"{name}, against one process over {label}", ranks, refs, card)
        except Exception as e:  # noqa: BLE001  (the other reference still runs; the script fails at the end)
            traceback.print_exc()
            failures.append(f"one process over {label}: {type(e).__name__}: {e}")
            continue
        line[label] = counts
    if world > 1:
        _, data, _ = cs.bench_scene(cs.SHAPE, torch.device("cuda", 0), torch.float32)
        err, times = cs._mp_first_launch(ranks, torch.clamp_min(data, 0.0))
        ms, bound, by, _, _ = max(times)
        line["cross_rank_launch"] = {"max_abs_err": err, "kernel_ms": [t[0] for t in times],
                                     "call_ms": [t[3] for t in times], "plain_ms": [t[4] for t in times],
                                     "bound_ms": bound, "bound_by": by, "bound_share": bound / ms}
        cs.log(31, f"[{card}] {name}: each rank's first TV slab launch, with planes from other ranks, against its "
                   f"plain version: gradient max abs err {err:.3g}; kernel_ms {[round(t[0], 4) for t in times]} by "
                   f"rank (timed here alone), bound {bound:.4f} ms ({by})")
        line["cross_rank_admm_launches"] = cs._mp_first_admm_launches(ranks)
        for kind, e in line["cross_rank_admm_launches"].items():
            cs.log(31, f"[{card}] {name}: each rank's first ADMM {kind} slab launch with a plane from another rank, "
                       f"bit for bit its plain version; kernel_ms {[round(t, 4) for t in e['kernel_ms_by_rank']]} "
                       f"by rank (timed here alone), bound {e['bound_ms']:.4f} ms ({e['bound_by']})")
    print(json.dumps({"nccl_mesh": line}))
    if failures:
        print("\n".join(failures), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
