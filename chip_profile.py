#!/usr/bin/env python3
"""Where the card's time goes in the PyTorch port's object steps.

    python3 chip_profile.py

Run from the root of a checkout on a machine with one CUDA card, after
``chip_smoke.py`` has shown that everything builds and is right. It traces
with ``torch.profiler`` (CPU and CUDA activities), after one untraced
warm-up of each:

- ``deconvolve`` of the bench scene at 256^3, 20 iterations (``chip_smoke.py``
  phase 3's solve), then ``admm_deconvolve`` of the same scene, untracked,
  tracked and weighted (phase 10's solves);
- ``batched_deconvolve`` of 4 bench scenes at 64x256x256, 20 iterations
  (phase 7), then the same batch with ``engine="admm"`` (phase 12);
- ``deconvolve_depthvar`` of phase 18's weighted scene at 64x256x256 with 4
  Gibson-Lanni anchors, 20 iterations, and ``richardson_lucy_depthvar`` of
  it with RL-TV, 50 iterations (phase 18);
- ``tiled_deconvolve`` of a 256x464x464 volume made as phase 8 makes its
  design-scale volume: 4 tiles of 256^3 with overlap 24, one batch of 4,
  10 iterations, which is one of the design-scale run's 19 batches; then
  the same batch with ``method="rl"`` and RL-TV (phase 14);
- ``richardson_lucy`` of the bench scene at 256^3, 50 iterations, matched
  and RL-TV (phase 13), and ``object_uncertainty`` at 256^3 with 8 probes
  and 25 CG iterations at most on a 30-iteration ``deconvolve`` solution
  (phase 16).

For each it prints one line: the wall of the traced region (host clock,
synchronized), the device busy time (the sum of kernel and copy times; one
stream, so they do not overlap), the idle share 1 - busy / wall, the share of
the busy time by class (the TV kernels, the ADMM kernels, cuFFT, reductions,
copies, the other elementwise kernels) and the number of kernels launched. The card's name and
power limit come first.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

CLASSES = ("tv", "admm", "cufft", "reduction", "copy", "elementwise")


def kernel_class(name: str) -> str:
    low = name.lower()
    if "hyperbolic_tv" in low:
        return "tv"
    if "admm_" in low:
        return "admm"
    if "fft" in low:
        return "cufft"
    if "memcpy" in low or "memset" in low:
        return "copy"
    if "reduce" in low or "dot" in low or "gemv" in low:
        return "reduction"
    return "elementwise"


def trace(name: str, fn) -> None:
    """One untraced warm-up of ``fn``, then one traced run, summarised."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_class = dict.fromkeys(CLASSES, 0.0)
    launches = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_class[kernel_class(ev.name)] += ev.device_time_total * 1e-6  # us -> s
            launches += 1
    busy = sum(by_class.values())
    if busy == 0.0:
        raise RuntimeError(f"{name}: the trace holds no device time")
    shares = ", ".join(f"{k} {v / busy:.3f}" for k, v in by_class.items())
    print(f"{name}: wall {wall:.4f} s, device busy {busy:.4f} s, idle share {1 - busy / wall:.3f}; "
          f"busy by class: {shares}; {launches} device operations", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_profile.py needs a CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from microtipi_tpu_torch.jobs.admm import admm_deconvolve
    from microtipi_tpu_torch.jobs.batch import batched_deconvolve
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, deconvolve
    from microtipi_tpu_torch.jobs.depthvar import deconvolve_depthvar, depth_anchor_psfs, richardson_lucy_depthvar
    from microtipi_tpu_torch.jobs.richardson_lucy import richardson_lucy
    from microtipi_tpu_torch.jobs.tiled import tiled_deconvolve
    from microtipi_tpu_torch.jobs.uncertainty import object_uncertainty
    from microtipi_tpu_torch.weights.updaters import InverseVarianceWeights

    print(cs.phase0_card(), flush=True)
    dev = torch.device("cuda")
    cfg20 = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=20, grtol=0.0, gatol=0.0)
    cfg10 = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=10, grtol=0.0, gatol=0.0)

    _, data, psf = cs.bench_scene(cs.SHAPE, dev, torch.float32)
    trace(f"deconvolve {cs.SHAPE}", lambda: deconvolve(data, psf, config=cfg20))
    trace(f"admm_deconvolve {cs.SHAPE}, untracked",
          lambda: admm_deconvolve(data, psf, config=cfg20, track_objective=False))
    trace(f"admm_deconvolve {cs.SHAPE}, tracked", lambda: admm_deconvolve(data, psf, config=cfg20))
    weights = InverseVarianceWeights().from_data(data)
    trace(f"admm_deconvolve {cs.SHAPE}, weighted, untracked",
          lambda: admm_deconvolve(data, psf, weights=weights, config=cfg20, track_objective=False))
    trace(f"richardson_lucy {cs.SHAPE}, matched, 50 iterations", lambda: richardson_lucy(data, psf, iterations=50))
    trace(f"richardson_lucy {cs.SHAPE}, RL-TV, 50 iterations",
          lambda: richardson_lucy(data, psf, iterations=50, mu=0.01, epsilon=1.0))
    cfg30 = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=30, grtol=0.0, gatol=0.0)
    x_hat = deconvolve(data, psf, config=cfg30).x
    trace(f"object_uncertainty {cs.SHAPE}, 8 probes, 25 CG iterations at most",
          lambda: object_uncertainty(data, psf, x_hat, config=cfg30, n_probes=8, cg_maxiter=25))
    del data, psf, weights, x_hat

    scenes = [cs.bench_scene(cs.LANE_SHAPE, dev, torch.float32, seed=s) for s in range(4)]
    batch, psf = torch.stack([d for _, d, _ in scenes]), scenes[0][2]
    trace(f"batched_deconvolve 4 x {cs.LANE_SHAPE}", lambda: batched_deconvolve(batch, psf, config=cfg20))
    trace(f"batched_deconvolve engine='admm' 4 x {cs.LANE_SHAPE}",
          lambda: batched_deconvolve(batch, psf, config=cfg20, engine="admm"))
    del scenes, batch, psf

    model = cs.depthvar_model(cs.LANE_SHAPE, torch.float32, dev)
    anchors = np.linspace(0.0, cs.LANE_SHAPE[0] - 1.0, cs.DEPTH_K)
    with torch.no_grad():
        psfs = depth_anchor_psfs(model, model.init_params(), anchors)
    data, _ = cs.depthvar_scene(psfs, anchors, cs.LANE_SHAPE, dev, torch.float32)
    weights = InverseVarianceWeights().from_data(data)
    trace(f"deconvolve_depthvar {cs.LANE_SHAPE}, K {cs.DEPTH_K}, weighted, 20 iterations",
          lambda: deconvolve_depthvar(data, psfs, anchors, weights=weights, config=cfg20))
    trace(f"richardson_lucy_depthvar {cs.LANE_SHAPE}, K {cs.DEPTH_K}, RL-TV, 50 iterations",
          lambda: richardson_lucy_depthvar(data, psfs, anchors, iterations=50, mu=0.01, epsilon=1.0))
    del model, psfs, data, weights

    psf = cs.design_psf()
    volume = cs.design_volume(psf, (256, 464, 464))
    trace("tiled_deconvolve (256, 464, 464), 4 tiles of 256^3 in one batch",
          lambda: tiled_deconvolve(volume, psf, tile=cs.TILE, overlap=cs.OVERLAP, config=cfg10,
                                   max_batch=cs.MAX_BATCH))
    trace("tiled_deconvolve method='rl' (256, 464, 464), RL-TV, 10 iterations, 4 tiles of 256^3 in one batch",
          lambda: tiled_deconvolve(volume, psf, tile=cs.TILE, overlap=cs.OVERLAP, config=cfg10, method="rl",
                                   rl_iterations=10, max_batch=cs.MAX_BATCH))
    return 0


if __name__ == "__main__":
    sys.exit(main())
