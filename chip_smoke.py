#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (any CUDA
card of compute capability 9.0a). It imports ``microtipi_tpu_torch`` and
never jax. Phases, one line of findings each (``[phase N] ...``); any failure
raises and the script exits non-zero:

0. the card: name and power limit (nvidia-smi), torch and CUDA versions, and
   that float32 matmuls run in full float32 (TF32 off);
1. build the CUDA kernels from ``microtipi_tpu_torch/csrc`` (hyperbolic TV and
   the ADMM split update and right-hand side; one ``nvcc`` a source, started
   together), with ptxas's report (registers, shared memory, spills);
2. the kernel against its plain PyTorch version on the card, at 256^3, at
   phase 15's padded grid 288^3, at phase 22's 64x512x512 and at ragged
   shapes, its TMA and its 4-byte-copy (unaligned) instantiations, then its
   time at 256^3:
   ``kernel_ms`` from CUDA events around 50 back-to-back raw launches into
   preallocated outputs, ``call_ms`` per wrapper call (allocation and host
   launch latency included), and the plain version's;
3. the slice at full size on the bench scene of ``bench.py`` (256^3):
   ``deconvolve`` (20 VMLMB iterations) and ``blind_deconvolve`` (5 rounds,
   joint defocus+phase fit), with the kernel's launch count;
4. card (float32, kernels) against CPU (float64, plain versions) parity, of
   ``deconvolve``, of ``batched_deconvolve`` at 3 lanes, of
   ``admm_deconvolve``, of ``richardson_lucy`` (matched, RL-TV,
   Wiener-Butterworth accelerated), of ``deconvolve_auto_mu`` (the same
   decisions and mu), of the Laplace uncertainty (the same probes), of
   ``deconvolve_depthvar`` and ``richardson_lucy_depthvar`` (RL-TV) on
   Gibson-Lanni anchors, and of the bead pieces: ``center_bead_stack``,
   ``bead_anchor_term`` and its gradient, ``fit_psf_beads``,
   ``bead_fit_uncertainty`` and ``calibrate_depth``; and of every joint solver
   (time series, multichannel joint and separate, unmixing, 5D, superres,
   by VMLMB and by ADMM) at 16x64x64 volumes, 10 iterations; and of the
   batched blind loops, the streamed statistics and fit, ``retrieve_pupil``,
   the diversity cost and fit, SIM, ISM and the image ops at 16x64x64;
5. cuFFT float32 precision against float64 NumPy at 256^3;
6. the batched hyperbolic-TV kernel against its plain version, each lane
   against the single-volume kernel (bitwise), at phase 22's 8, 3 and 2
   lanes of 64x512x512 too, unaligned batches and lane views, then its ``kernel_ms`` and ``call_ms`` at 4x64x256x256 and at the
   tiled run's 4x256^3 beside the plain version, and 4 single-volume
   launches at 4x64x256x256;
7. ``batched_deconvolve`` at full width: 4 bench scenes of 64x256x256, each
   lane against ``deconvolve`` of that scene, with both launch counts;
8. ``tiled_deconvolve`` at design scale: a 512x1024x1024 volume in 75 tiles
   of 256^3 (overlap 24) streamed 4 at a time, after a warm-up on two corners
   of 4 and 3 tiles;
   and one tile covering a 64x256x256 volume against ``deconvolve``, with
   the witnesses of where the two part;
9. the ADMM kernels (``admm_split_update``, ``admm_rhs``) against their plain
   versions, bit for bit, at ragged and full shapes, single and batched,
   aligned and as views off 16-byte alignment (the split update's 4-byte
   instantiation), over-relaxation on and off, positivity on and off, at
   unit, power-of-two and inexact scales, per-lane ``rho``s that differ; the
   Newton prox against float64; the split update on the states that the
   256^3 solve hands it at iterations 1, 10 and 20 (over-relaxed 1.8 and 1),
   on the random timing state and on a zero-gradient state: bitwise against
   plain, the histograms of Newton steps to the bitwise fixed point and to a
   period-2 orbit, the share of zero gradients, the launch's time on a fresh
   copy; the SASS counts of the division and square-root sequences
   (``cuobjdump``); then both kernels' ``kernel_ms``, ``call_ms`` and plain
   times at 256^3, 4x64x256x256 and the tiled run's 4x256^3 (its ragged
   3x256^3 batch is compared too, and phase 22's 8, 3, 2 and 1 lanes of
   64x512x512);
10. ``admm_deconvolve`` at full width on the bench scene (256^3, 20
    iterations): untracked (the ``admm_value`` lane of ``bench.py``), tracked
    (``f_history`` must fall and end below phase 3's VMLMB objective),
    weighted by ``InverseVarianceWeights.from_data`` (the data split), and
    stopped by the Boyd residual test; then two 200-iteration float32 runs
    that must agree bit for bit;
11. ``blind_deconvolve`` with the ADMM engine, the recommended recipe (the
    ``blind_admm_value`` lane of ``bench.py``);
12. ``batched_deconvolve(engine="admm")`` at 4x64x256x256, each lane against
    ``admm_deconvolve`` of its scene, and ``tiled_deconvolve(method="admm")``
    on the two warm-up corners (4 and 3 tiles, run cold) and on the design
    volume, and one tile covering a 64x256x256 volume against
    ``admm_deconvolve``;
13. ``richardson_lucy`` at 256^3 on phase 3's scene: matched (50
    iterations), RL-TV (50, the TV kernel once an iteration), Wiener-
    Butterworth accelerated (10) and the same with the Gaussian discrepancy
    stop on the estimated sigma (tau just above the 10-iteration residual);
    ``multiview_richardson_lucy`` of two views through two widefield PSFs;
14. ``tiled_deconvolve(method="rl", rl_iterations=10)`` with RL-TV on phase
    8's design volume (190 batched TV launches, none single), and one RL
    tile covering a 64x256x256 volume against ``richardson_lucy``;
15. ``deconvolve`` at 256^3 with the sparsity and Hessian priors on the
    padded grid 288^3, ``deconvolve_auto_mu`` at 256^3 (tau 4, 8 probes of
    20 iterations) and ``batched_deconvolve_auto_mu`` at 4x64x256x256, each
    discrepancy beside its target, and the TV launches equal to the
    evaluations of the solves (of their lockstep steps for the batch);
16. ``object_uncertainty`` at 256^3 (8 probes, 25 preconditioned CG
    iterations at most) on a 30-iteration ``deconvolve`` solution;
17. every PSF family at 256^3 float32 (wide-field, Gibson-Lanni, confocal
    with and without a pinhole, two-photon, vectorial, Gaussian, Bessel and
    lattice light sheets, ISM, 4Pi A and C, STED donut and bottle):
    ``compute_psf`` wall and sum, the gradient for each of its families,
    card float32 against CPU float64 at 16x64x64; then ``blind_deconvolve``
    through a ``ConfocalModel`` as phase 3's loop;
18. the depth-varying object step at ``BASELINE.json`` config 2's size,
    64x256x256, 4 Gibson-Lanni anchors from one batched synthesis:
    ``deconvolve_depthvar`` (weighted, 20 iterations), RL-TV
    ``richardson_lucy_depthvar`` (50), ``batched_deconvolve_depthvar`` of 4
    scenes, each lane against the single solve, and a DEPTH ``fit_psf``;
19. ``tiled_deconvolve(depthvar_anchors=...)`` with ``field_depthvar_psf``
    on phase 8's design volume, 10 iterations;
20. bead calibration with the bench optics: a 64x512x512 bead slide (8
    beads, two halves of different phase, Poisson), ``detect_beads``,
    ``average_beads`` (64^3 patch), ``fit_psf_beads``,
    ``bead_fit_uncertainty``, ``empirical_psf``, ``calibrate_field`` and
    ``field_psf`` against the truth; then ``blind_deconvolve`` on phase 3's
    scene, free and from the calibration with the calibration prior, the
    bead anchor and the fit window, and ``fit_uncertainty`` at 256^3;
21. the depth ladder: ``calibrate_depth`` on 4 Gibson-Lanni beads of 64^3
    from a wrong sample index, ``ladder_fit_uncertainty``,
    ``fit_psf_depthvar`` at 64x256x256 and ``blind_deconvolve_depthvar``
    from the ladder, with the prior and with a bead anchor;
22. the joint solvers on the bench optics, volumes of 64x512x512: a time
    series of 8 frames (fixed beads, more appearing at frame 4) by
    ``deconvolve_timeseries`` at mu_t 0 and 0.01 and by
    ``admm_deconvolve_timeseries`` (untracked at both, tracked, weighted with
    bleaching gains, Boyd-stopped at reltol 1e-2), the temporal prior
    lowering each engine's error to the truth under 0.94x and both engines
    keeping the event; 3 channels through 460/525/610 nm PSFs, joint and
    separate by both engines, joint coupling lowering the dim channel's
    error (ADMM under 0.92x, VMLMB under 1x), and 2 dyes behind README's mixing
    matrix; a 4 x 2 (T, C) block with mu_t and bleach by both engines; camera
    data of 64x256x256 onto the 64x512x512 grid by ``deconvolve_superres``
    and ``admm_deconvolve_superres``, localising off-lattice beads better
    than the coarse solves;
23. ``batched_blind_deconvolve`` of 4 bench scenes of 64x256x256 blurred by
    the bench phase, 3 rounds of 20 object iterations and joint
    defocus+phase fits of 5: per frame by VMLMB (one lockstep
    ``batched_deconvolve`` a round) and by ADMM (the recommended recipe),
    each lane against its own ``blind_deconvolve`` (also with the batch's
    FFTs taken lane by lane), and with ``joint_psf=True`` (one
    VMLMB over the stack, one fit over the sum of the frames' data terms);
24. ``blind_deconvolve_tiled`` on phase 8's in-focus volume from the bench
    phase: 3 rounds of 10 iterations in TILE tiles and phase fits of 5 (Z4
    pinned) on the streamed statistics, the phase error ending below three
    quarters of the start's, the object-step, host-gather, statistics and
    fit walls apart;
    and the streamed statistics of a 64x256x256 cut against the dense
    circulant objective in float64 on the card;
25. ``retrieve_pupil`` on phase 20's averaged bead (the gauge-fixed map error
    below the start's) and ``fit_psf_diversity`` with its error bars on two
    +-200 nm defocus images of a 64x256x256 scene;
26. 2D SIM, 3 x 3 at 512^2 onto 1024^2 with ``estimate_sim_pattern`` from 0.3
    bins off; 3D SIM, 3 x 5 at 32x256x256; ISM, 19 elements of 64x256x256
    (gains, reassignment, 50 joint RL iterations), each against its truth;
27. the image ops: ``register_timeseries`` of phase 22's series with planted
    drifts, the FSC of two 256^3 solves, ``strehl_ratio`` (wide-field and
    confocal) and ``strehl_ratio_from_pupil``, ``deskew`` at 31.8 degrees, and
    destriping, bleach gains, hot pixels and background on 64x512x512;
28. a stack from file to restored file through the port at 256^3: phase 3's
    blind scene written as OME-NGFF v2 (zlib) and read back bit for bit with
    its pixel sizes and emission (host walls and MiB/s);
    ``api.DeconvolutionJob`` with the true PSF against ``deconvolve`` bit for
    bit; ``api.BlindDeconvJob`` (5 rounds, sequential defocus and phase fits
    of 5, object steps of 20) with a model built from the metadata read
    back; abort from ``progress`` within one slice; the state through
    ``utils.checkpoint`` and the object back to NGFF, bit for bit. The
    OME-TIFF half and ``StackPrefetcher`` need libtiff, which the card's
    machine lacks: the CPU tests hold them.
30. the mesh-sharded paths (``microtipi_tpu_torch/parallel``) on meshes whose
    entries are all ``cuda:0``: phase 3's 256^3 PSF from each cell's own
    planes on (1, 4), put together, against ``compute_psf`` (bit for bit, or
    the largest gap in ulps), and a fit evaluation's float32 gradient by
    those planes and by the whole synthesis against float64; the blind
    loop's object step at 256^3 on (1, 4), its PSF by each cell's planes and
    by the whole synthesis and cut (its peak memory and its synthesis's,
    walls, ``deconv_f`` of both routes bit for bit or within 1e-4); the three slab
    entries (the TV kernel, the ADMM split update and rhs on a z-slab with
    its neighbours' planes) against their plain versions and, put together,
    against the whole-volume launches at 256^3 in 4 slabs and 2 x 256^3 in 2
    (gradients and ADMM state bit for bit), then their times at one 64-plane
    slab;
    ``sharded_deconvolve`` at 256^3 on (1, 1), (1, 4) and (2, 2) (f(x0) and
    the first iteration's f within 1e-4 of the dense run, walls beside
    dense); phase 3's blind loop on (1, 4) (round 1's f within 1e-4 of phase
    3's); ``sharded_admm_deconvolve`` at 256^3 on (1, 4), tracked; a blind
    loop of 2 x 256^3 on (2, 2); RL-TV and the depth-varying step at
    64x256x256 on (1, 4); ``blind --mesh 1 1`` through ``cli.main`` on NGFF,
    bit for bit the sharded job; and the counterpart of
    ``__graft_entry__.dryrun_multichip`` on (2, 2).
31. the sharded paths on a mesh over processes (``make_mesh(...,
    group=pg)``, the counterpart of ``__graft_entry__.dryrun_multiprocess``):
    two spawned ranks on cuda:0 in a gloo group (CUDA tensors staged through
    the host) run phase 30's 256^3 VMLMB and blind loop on (1, 4), two slabs
    a rank; their f against phase 30's one-process run (bit for bit the aim,
    else the largest relative gap), each rank's first TV slab launch, which
    took a plane from the other rank, against its plain version (and timed
    here once the ranks have exited), and which collectives gloo takes on
    CUDA tensors; then NCCL: the same two ranks, or, where NCCL refuses two
    ranks on one card (its refusal printed), a group of one rank running the
    same jobs, which reaches NCCL's all-gather and broadcast but sends
    nothing between ranks (``chip_nccl_mesh.py`` runs one rank a card);
    walls beside the one-process run's, bytes exchanged in an evaluation,
    TV slab launches by rank; one wide-field and one depth-varying PSF fit
    evaluation, each cell synthesizing its own planes (no ``cells`` bytes,
    the pupil's gradient within its bound) beside the whole synthesis and
    cut, with each rank's peak memory; the blind loop's object step on each
    rank by both routes (no ``cells`` or ``pupil`` byte by each cell's
    planes, each rank's peaks and walls beside phase 30's).

The main paths are phases 3, 13, 15, 17, 18, 20, 21, 22's superres and 28 (the
single-volume TV kernel), phases 7-8, 14, 15, 18, 19, 22, 23 and 24 (the
batched TV kernel), phases 10-12, 22 and 23 (the ADMM kernels) and phases 30's
and 31's sharded paths (the slab entries, and no whole-volume launch; phase
31's counted on each rank and summed): each is driven with the
launch counts set to 0 just before and read just after, and none may take the
TV kernel's unaligned instantiation or the split update's 4-byte one; every
entry of the kernels line gives its launches path by path
(``launches_by_path``). Phase 16 must launch no
TV kernel: its Hessian comes from the plain objective.
The line before the last is ``{"kernels": [...]}`` with each kernel's
launches on its paths, error, times and bound (``ms`` is the wrapper call's
time, ``call_ms``; ``kernel_ms`` the raw launches'; the split update's
``solve_state`` its time on the solve's iteration-10 state); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card it exits 2 and prints
no result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

SHAPE = (256, 256, 256)
PARITY_SHAPE = (16, 64, 64)
# Phase 15's padded variable grid: the TV kernel runs there on a main path.
PAD_SHAPE = (288, 288, 288)
# Phase 22's volumes: a frame, channel or fine grid; the lanes of its series and 5D block (8), its channels (3)
# and its dyes (2).
JOINT_VOL = (64, 512, 512)
JOINT_LANES = (8, 3, 2)
KERNEL_SHAPES = (SHAPE, PAD_SHAPE, (37, 64, 96), (256, 8, 128), JOINT_VOL)
# nx % 4 != 0: the kernel's 4-byte-copy instantiation.
UNALIGNED_SHAPE = (33, 45, 67)
# The first is timed; the last two are the tiled run's full and ragged batches.
BATCH_SHAPES = ((4, 64, 256, 256), (3, 37, 64, 96), (2, 256, 8, 128), (4, 256, 256, 256), (3, 256, 256, 256),
                *((b, *JOINT_VOL) for b in JOINT_LANES),
                # phase 23's and 24's lockstep batches once lanes finish: fewer lanes of 64x256x256 and 256^3
                (3, 64, 256, 256), (2, 64, 256, 256), (1, 64, 256, 256), (2, 256, 256, 256), (1, 256, 256, 256))
UNALIGNED_BATCH = (3, 33, 45, 67)  # its lanes x[1], x[2] start off 16-byte alignment too
LANE_SHAPE = (64, 256, 256)  # one lane of the batched object step
VOLUME, TILE, OVERLAP, MAX_BATCH = (512, 1024, 1024), (256, 256, 256), 24, 4  # BASELINE.md:1241-1251
# Two corners of VOLUME (tile stride 256 - 2*24 = 208) that warm the FFT plans
# of both of the tiled run's batch sizes: 4 tiles along x, one full batch, and
# 3 tiles along z, the ragged batch (75 tiles are 18 batches of 4 and one of 3).
WARM_VOLUMES = ((256, 256, 256 + 3 * 208), (512, 256, 256))
PSF_SHAPE = (64, 64, 64)
# The fused-TV tolerances of tests/test_pallas_tv.py:25-26 (float32 kernel
# against the float32 plain version: sums in another order), and its 256-plane
# accumulation bound against float64 (:50-57).
TV_COST_RTOL, TV_GRAD_RTOL, TV_GRAD_ATOL, TV_F64_RTOL = 1e-5, 1e-4, 1e-5, 5e-7
# The card's peaks (H100 SXM data sheet): HBM bytes/s and float32 (non-tensor)
# operations/s. The TV per voxel: 3 differences and 3 scalings, 3 squares and
# 3 adds, a square root and a reciprocal, 6 multiplies for the weights, 5
# adds for the gradient and 2 for the cost.
HBM_BYTES_PER_S, F32_OPS_PER_S, TV_OPS_PER_VOXEL = 3.35e12, 67e12, 27
# The ADMM kernels: volumes of float32 moved (each input read once, each output
# written once) and float32 operations a voxel, a division, reciprocal or square
# root counted as one. Split update: x, u1 x 3, u2 in and z1 x 3, u1 x 3, z2, u2
# out (over-relaxed: z1 x 3 and z2 in as well); 15 operations a Newton step
# (a square root, a reciprocal, a division, 12 others), counted for all 8 steps
# though the kernel stops once a voxel's iterates repeat, and 29 around them
# (12 more over-relaxed): even so the operations take a seventh of the bytes' time or less,
# so the bound is the bytes'. Right-hand side: z1 x 3, u1 x 3, z2, u2 in, one
# volume out; 12 operations of the adjoint, 6 after it.
SPLIT_VOLUMES, SPLIT_VOLUMES_RELAXED, SPLIT_OPS, SPLIT_OPS_RELAXED, RHS_VOLUMES, RHS_OPS = 13, 17, 149, 161, 9, 18
ADMM_KERNEL_SHAPES = ((1, 37, 64, 96), (1, 33, 45, 67), (3, 37, 64, 96))
# The first three are timed; the next is the tiled run's ragged batch; the rest phase 22's lanes and its
# superres fine grid (B = 1).
ADMM_FULL_SHAPES = ((1, *SHAPE), (4, *LANE_SHAPE), (MAX_BATCH, *TILE), (3, *TILE),
                    *((b, *JOINT_VOL) for b in (*JOINT_LANES, 1)))
# Scales: unit, a power of two, and reciprocals that float32 does not hold
# exactly (the kernels and the plain versions multiply by the same rounded ones).
ADMM_SCALES = (None, (2.0, 1.0, 1.0), (3.0, 1.0, 0.7))
ADMM_VIEW_SHAPES = ((1, 37, 64, 96), (3, 37, 64, 96))  # also compared as views off 16-byte alignment
ADMM_ULPS = 4  # float32 ulp of the largest value: the Newton prox against the float64 prox
# The split update's inputs phase 9 captures from the 256^3 bench solve, at
# these iterations and over-relaxations; a vmag at or below TINY_VMAG is a zero
# gradient (vmag = sqrt(tiny), 1.1e-19); the SASS instructions it counts.
SOLVE_ITERATIONS, SOLVE_ALPHAS, TINY_VMAG = (1, 10, 20), (1.8, 1.0), 1e-18
SASS_OPS = ("MUFU.RCP", "MUFU.RSQ", "FCHK", "CALL.REL")


def tv_bound(x: torch.Tensor) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for one TV evaluation of ``x``:
    x read once and the gradient written once, against the operations."""
    t_bytes = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S
    t_ops = TV_OPS_PER_VOXEL * x.numel() / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def log(phase: int, msg: str) -> None:
    print(f"[phase {phase}] {msg}", flush=True)


def phase0_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log(0, f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
           f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
           f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    # The Zernike tensordot (ops/pupil.py) runs on the card: it must be float32.
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is True; the PSF synthesis needs float32")
    return smi


def phase1_build() -> None:
    from microtipi_tpu_torch._build import build_report, load_library

    names = ("hyperbolic_tv", "admm_split")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:  # one nvcc a source, side by side
        for built in [pool.submit(load_library, name) for name in names]:
            built.result()
    log(1, f"built {', '.join(n + '.cu' for n in names)} with nvcc in {time.perf_counter() - t0:.2f} s")
    for name in names:
        for line in build_report(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(1, line.strip())


def raw_ms(launch, n: int = 50, warmup: int = 5) -> float:
    """The kernel's time: CUDA events around ``n`` back-to-back launches of
    ``launch`` (a raw launch into preallocated outputs), over ``n``."""
    for _ in range(warmup):
        launch()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        launch()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def kernel_times(x: torch.Tensor, call, plain) -> dict:
    """``kernel_ms`` (raw launches), ``call_ms`` (one wrapper call, median of
    20), ``plain_ms``, the bound and the bound's share of ``kernel_ms``."""
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

    kernel_ms = raw_ms(hv.prepare_launch(x, 1.0)[0])
    call_ms = _median_ms(call)
    plain_ms = _median_ms(plain)
    bound_ms, bound_by = tv_bound(x)
    return {"kernel_ms": kernel_ms, "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / kernel_ms}


def times_line(shape, t: dict) -> str:
    moved = 2 * int(np.prod(shape)) * 4
    return (f"kernel_ms {t['kernel_ms']:.4f} (50 raw launches, {moved / (t['kernel_ms'] * 1e-3) / 1e9:.1f} GB/s), "
            f"call_ms {t['call_ms']:.4f} (wrapper call, median of 20), plain {t['plain_ms']:.4f} ms; bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {moved / 2**20:.0f} MiB at {HBM_BYTES_PER_S / 1e12} TB/s), "
            f"{t['bound_share']:.1%} of it")


def _median_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Median over ``n`` calls of the CUDA-event time of one call into an
    idle queue: host launch latency and allocations included."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase2_kernel(card: str) -> dict:
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

    dev = torch.device("cuda")
    max_err = 0.0
    hv.unaligned_launches = 0
    for shape in KERNEL_SHAPES:
        x = torch.as_tensor(np.random.default_rng(7).standard_normal(shape, dtype=np.float32), device=dev)
        for eps in (0.1, 1.0):
            for scales in (None, (2.0, 1.0, 1.0)):
                f, g = hv.hyperbolic_tv_fused(x, eps, scales)
                f_ref, g_ref = hv.hyperbolic_tv_plain(x, eps, scales)
                rel = abs(f.item() - f_ref.item()) / abs(f_ref.item())
                err = (g - g_ref).abs().max().item()
                max_err = max(max_err, err)
                if rel > TV_COST_RTOL or not torch.allclose(g, g_ref, rtol=TV_GRAD_RTOL, atol=TV_GRAD_ATOL):
                    raise AssertionError(f"kernel != plain at {shape} eps={eps} scales={scales}: "
                                         f"cost rel {rel:.3g}, grad max abs {err:.3g}")
                if shape == (256, 8, 128):
                    f64 = hv.hyperbolic_tv_plain(x.double(), eps, scales)[0].item()
                    if abs(f.item() - f64) / abs(f64) > TV_F64_RTOL:
                        raise AssertionError(f"256-plane cost off float64 by {abs(f.item() - f64) / abs(f64):.3g}")
                f2, g2 = hv.hyperbolic_tv_fused(x, eps, scales)
                if not (torch.equal(f, f2) and torch.equal(g, g2)):
                    raise AssertionError(f"two launches differ at {shape} eps={eps} scales={scales}")
        const = torch.full(shape, 2.5, device=dev)
        f, g = hv.hyperbolic_tv_fused(const, 0.1)
        if abs(f.item()) > 1e-5 or g.abs().max().item() != 0.0:
            raise AssertionError(f"constant volume gives cost {f.item()}, grad {g.abs().max().item()}")
    if hv.unaligned_launches != 0:
        raise AssertionError(f"aligned shapes took the unaligned instantiation {hv.unaligned_launches} times")

    # The 4-byte-copy instantiation: nx % 4 != 0, and nx % 4 == 0 at a base
    # 4 bytes off 16-byte alignment; the latter bitwise equal to the TMA
    # instantiation on an aligned copy of the same data.
    rng = np.random.default_rng(9)
    odd = torch.as_tensor(rng.standard_normal(UNALIGNED_SHAPE, dtype=np.float32), device=dev)
    shifted_shape = (33, 44, 68)
    flat = torch.as_tensor(rng.standard_normal(int(np.prod(shifted_shape)) + 1, dtype=np.float32), device=dev)
    shifted = flat[1:].view(shifted_shape)
    for xu in (odd, shifted):
        for eps, scales in ((0.1, None), (1.0, (2.0, 1.0, 1.0))):
            before = hv.unaligned_launches
            f, g = hv.hyperbolic_tv_fused(xu, eps, scales)
            if hv.unaligned_launches != before + 1:
                raise AssertionError(f"{tuple(xu.shape)} at {xu.data_ptr() % 16} bytes off alignment did not take "
                                     "the unaligned instantiation")
            f_ref, g_ref = hv.hyperbolic_tv_plain(xu, eps, scales)
            rel = abs(f.item() - f_ref.item()) / abs(f_ref.item())
            err = (g - g_ref).abs().max().item()
            max_err = max(max_err, err)
            if rel > TV_COST_RTOL or not torch.allclose(g, g_ref, rtol=TV_GRAD_RTOL, atol=TV_GRAD_ATOL):
                raise AssertionError(f"unaligned kernel != plain at {tuple(xu.shape)} eps={eps} scales={scales}: "
                                     f"cost rel {rel:.3g}, grad max abs {err:.3g}")
            f2, g2 = hv.hyperbolic_tv_fused(xu, eps, scales)
            if not (torch.equal(f, f2) and torch.equal(g, g2)):
                raise AssertionError(f"two unaligned launches differ at {tuple(xu.shape)}")
    fa, ga = hv.hyperbolic_tv_fused(shifted.clone(), 0.1)
    fo, go = hv.hyperbolic_tv_fused(shifted, 0.1)
    if not (torch.equal(fa, fo) and torch.equal(ga, go)):
        raise AssertionError("the unaligned instantiation differs from the TMA one on the same data")
    torch.cuda.synchronize()
    log(2, f"kernel == plain at {list(KERNEL_SHAPES)}, eps (0.1, 1.0), scales (None, (2,1,1)): "
           f"cost rtol {TV_COST_RTOL}, grad rtol {TV_GRAD_RTOL} atol {TV_GRAD_ATOL} "
           f"(max grad abs err {max_err:.3g}); 256-plane cost within {TV_F64_RTOL} of float64; "
           "constant volume 0; two launches bitwise equal; unaligned instantiation at "
           f"{UNALIGNED_SHAPE} and {shifted_shape} 4 bytes off alignment: == plain, launches bitwise equal, "
           "bitwise the TMA instantiation's on the same data")

    x = torch.as_tensor(np.random.default_rng(0).standard_normal(SHAPE, dtype=np.float32), device=dev)
    t = kernel_times(x, lambda: hv.hyperbolic_tv_fused(x, 1.0), lambda: hv.hyperbolic_tv_plain(x, 1.0))
    log(2, f"[{card}] TV at {SHAPE}: {times_line(SHAPE, t)}")
    return {"max_abs_err": max_err, "ms": t["call_ms"], **t, "library_ms": None}


def bead_objects(shape, device, dtype, seed=0) -> tuple[torch.Tensor, torch.Tensor]:
    """The bench scene's object (sparse random beads) and unit Gaussian
    noise (``bench.py:182-189``)."""
    rng = np.random.default_rng(seed)
    obj = rng.random(shape, dtype=np.float32) * (rng.random(shape) > 0.999) * 300
    noise = rng.standard_normal(shape).astype(np.float32)
    return (torch.as_tensor(obj, dtype=dtype, device=device), torch.as_tensor(noise, dtype=dtype, device=device))


def bench_scene(shape, device, dtype, phase=None, seed=0, model=None):
    """The bench's widefield model and data (``bench.py:79-92,182-189``):
    sparse random beads blurred by the PSF, plus 1% Gaussian noise; ``seed``
    draws another scene, ``model`` blurs it through another PSF model."""
    from microtipi_tpu_torch.models.widefield import WideFieldConfig, WideFieldModel
    from microtipi_tpu_torch.ops.convolution import convolve, convolve_spectrum

    if model is None:
        model = WideFieldModel(WideFieldConfig(shape=shape, na=1.4, wavelength=561e-9, ni=1.518, dxy=80e-9,
                                               dz=200e-9, n_phase=6, n_modulus=1, dtype=dtype), device=device)
    obj, noise = bead_objects(shape, device, dtype, seed)
    params = model.init_params()
    if phase is not None:
        params = params._replace(phase=torch.as_tensor(phase, dtype=dtype, device=device))
    with torch.no_grad():
        d = convolve(obj, convolve_spectrum(model.compute_psf(params)), shape)
        return model, d + 0.01 * d.max() * noise, model.compute_psf(model.init_params())


def _check_object(name: str, x: torch.Tensor) -> None:
    if not bool(torch.isfinite(x).all()) or float(x.min()) < 0:
        raise AssertionError(f"{name}: object not finite and non-negative")


def phase3_slice(card: str) -> tuple[int, float, float, np.ndarray]:
    """Returns the TV kernel's launches on the path, the objective that
    ``deconvolve`` reached (in the residual form, for phase 10), the blind
    loop's wall (for phases 28 and 30) and its ``deconv_f`` (for phase 30)."""
    from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig, blind_deconvolve
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, deconvolve, make_objective
    from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig
    from microtipi_tpu_torch.models.microscope import DEFOCUS, PHASE
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

    dev, nvox = torch.device("cuda"), float(np.prod(SHAPE))
    _, data, psf = bench_scene(SHAPE, dev, torch.float32)
    cfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=20, grtol=0.0, gatol=0.0)
    torch.cuda.reset_peak_memory_stats()
    hv.launches = hv.batched_launches = hv.unaligned_launches = 0
    deconvolve(data, psf, config=cfg)  # warm-up (cuFFT plans, the kernel's first load)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = deconvolve(data, psf, config=cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    deconv_launches, x_vmlmb, data_vmlmb = hv.launches, res.x, data
    wall = float(np.median(walls))
    _check_object("deconvolve", res.x)
    if not np.isfinite(res.f) or deconv_launches == 0:
        raise AssertionError(f"deconvolve: f={res.f}, TV kernel launches {deconv_launches}")
    log(3, f"[{card}] deconvolve {SHAPE}: {res.iterations} iterations, {res.evaluations} evaluations, "
           f"status {res.status}, f {float(res.f):.6g}, wall {wall:.4f} s (median of 3 after 1 warm-up), "
           f"{nvox * res.iterations / wall / 1e6:.1f} Mvox*iter/s, TV kernel launches {deconv_launches}")

    model, data, _ = bench_scene(SHAPE, dev, torch.float32, phase=[0.15, -0.1, 0.08, 0.0, 0.05, 0.0])
    bcfg = BlindDeconvConfig(
        loops=5, families=(DEFOCUS, PHASE), psf_max_iter=(5, 5), joint_fit=True,
        deconv=DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=20, grtol=0.0, gatol=0.0),
        fit=PsfFitConfig(grtol=0.0),
    )
    before = hv.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bres = blind_deconvolve(data, model, config=bcfg)
    torch.cuda.synchronize()
    bwall = time.perf_counter() - t0
    blind_launches = hv.launches - before
    _check_object("blind_deconvolve", bres.obj)
    df = bres.deconv_f
    if not (np.isfinite(df).all() and np.all(np.diff(df) < 0)):
        raise AssertionError(f"blind deconv_f does not decrease across rounds: {df}")
    if not (np.isnan(bres.fit_f[-1]).all() and np.isfinite(bres.fit_f[:-1]).all()):
        raise AssertionError(f"blind fit_f: the last row must be NaN, the others finite: {bres.fit_f}")
    if not bool(torch.isfinite(bres.psf).all()) or blind_launches == 0:
        raise AssertionError(f"blind: PSF not finite or TV kernel launches {blind_launches}")
    iters = int(bres.deconv_iters.sum())
    log(3, f"[{card}] blind_deconvolve {SHAPE}, 5 rounds, joint defocus+phase fit: object iterations "
           f"{bres.deconv_iters.tolist()}, deconv_f {df.tolist()}, wall {bwall:.3f} s (1 run), "
           f"{nvox * iters / bwall / 1e6:.1f} Mvox*obj_iter/s, TV kernel launches {blind_launches}")
    log(3, f"[{card}] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if hv.batched_launches != 0 or hv.unaligned_launches != 0:
        raise AssertionError(f"the single-volume path launched the batched kernel {hv.batched_launches} times, "
                             f"the unaligned instantiation {hv.unaligned_launches} times")
    launches = hv.launches  # the path's count, read before the evaluation below
    return launches, float(make_objective(psf, data_vmlmb, None, cfg, accurate=True)(x_vmlmb)[0]), bwall, df


def phase4_parity() -> None:
    """Card float32 (kernel) against CPU float64 (plain version) at
    PARITY_SHAPE. Tolerances are float32 against float64: the PSF to 1e-5 of
    its maximum (float32 FFT round-off, ~1e-7 per element, grown by the
    2D FFT's log2(N) stages); f over the first iterations to 1e-4 relative
    (the quadratic form loses eps32 * c / f with c/f ~ 1e2); the final f
    after 10 iterations to 1e-3 relative (the float32 trajectory drifts from
    the float64 one as line searches round differently)."""
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, deconvolve
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

    cfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=10, grtol=0.0, gatol=0.0)
    out = {}
    for dev, dtype in ((torch.device("cuda"), torch.float32), (torch.device("cpu"), torch.float64)):
        _, data, psf = bench_scene(PARITY_SHAPE, dev, dtype)
        before = hv.launches
        res = deconvolve(data, psf, config=cfg)
        out[dev.type] = (psf.double().cpu(), res, hv.launches - before)
    (psf32, r32, n32), (psf64, r64, n64) = out["cuda"], out["cpu"]
    psf_err = float((psf32 - psf64).abs().max() / psf64.abs().max())
    f4 = np.max(np.abs(r32.f_history[:4] - r64.f_history[:4]) / np.abs(r64.f_history[:4]))
    ff = abs(float(r32.f) - float(r64.f)) / abs(float(r64.f))
    if psf_err > 1e-5 or f4 > 1e-4 or ff > 1e-3 or n32 == 0 or n64 != 0:
        raise AssertionError(f"card/CPU parity: psf {psf_err:.3g}, f_history[:4] {f4:.3g}, final f {ff:.3g}, "
                             f"kernel launches cuda {n32} cpu {n64}")
    log(4, f"card float32 vs CPU float64 at {PARITY_SHAPE}: PSF {psf_err:.3g} of max (< 1e-5), "
           f"f_history[:4] {f4:.3g} rel (< 1e-4), final f {ff:.3g} rel (< 1e-3); "
           f"iterations {r32.iterations}/{r64.iterations}")

    # The batched path, 3 lanes of PARITY_SHAPE, with the same bounds per lane.
    from microtipi_tpu_torch.jobs.batch import batched_deconvolve

    out = {}
    for dev, dtype in ((torch.device("cuda"), torch.float32), (torch.device("cpu"), torch.float64)):
        scenes = [bench_scene(PARITY_SHAPE, dev, dtype, seed=s) for s in range(3)]
        before = hv.batched_launches
        res = batched_deconvolve(torch.stack([d for _, d, _ in scenes]), scenes[0][2], config=cfg)
        out[dev.type] = (res, hv.batched_launches - before)
    (r32, n32), (r64, n64) = out["cuda"], out["cpu"]
    f4 = np.max(np.abs(r32.f_history[:, :4] - r64.f_history[:, :4]) / np.abs(r64.f_history[:, :4]))
    ff = np.max(np.abs(r32.f - r64.f) / np.abs(r64.f))
    if f4 > 1e-4 or ff > 1e-3 or n32 == 0 or n64 != 0:
        raise AssertionError(f"batched card/CPU parity: f_history[:4] {f4:.3g}, final f {ff:.3g}, "
                             f"batched kernel launches cuda {n32} cpu {n64}")
    log(4, f"batched card float32 vs CPU float64 at 3 x {PARITY_SHAPE}: f_history[:4] {f4:.3g} rel "
           f"(< 1e-4), final f {ff:.3g} rel (< 1e-3); iterations {r32.iterations.tolist()}/"
           f"{r64.iterations.tolist()}")

    # The ADMM engine, tracked: the card through both kernels, the CPU through
    # their plain versions. An ADMM iteration is a contraction with no line
    # search, so float32 follows float64 all the way: f_history to 1e-4
    # relative (the float32 residual sum), x to 1e-3 relative L2.
    from microtipi_tpu_torch.jobs.admm import admm_deconvolve
    from microtipi_tpu_torch.ops.kernels import admm_split as ak

    out = {}
    for dev, dtype in ((torch.device("cuda"), torch.float32), (torch.device("cpu"), torch.float64)):
        _, data, psf = bench_scene(PARITY_SHAPE, dev, dtype)
        before = ak.split_launches, ak.rhs_launches
        res = admm_deconvolve(data, psf, config=cfg)
        out[dev.type] = (res, ak.split_launches - before[0], ak.rhs_launches - before[1])
    (r32, s32, h32), (r64, s64, h64) = out["cuda"], out["cpu"]
    fh = float(np.max(np.abs(r32.f_history - r64.f_history) / np.abs(r64.f_history)))
    xe = float(torch.linalg.norm(r32.x.double().cpu() - r64.x) / torch.linalg.norm(r64.x))
    if fh > 1e-4 or xe > 1e-3 or (s32, h32) != (cfg.max_iter,) * 2 or (s64, h64) != (0, 0):
        raise AssertionError(f"ADMM card/CPU parity: f_history {fh:.3g}, x {xe:.3g}, kernel launches cuda "
                             f"{s32}/{h32} (expected {cfg.max_iter} each), cpu {s64}/{h64}")
    log(4, f"admm_deconvolve card float32 (kernels) vs CPU float64 (plain) at {PARITY_SHAPE}, {cfg.max_iter} "
           f"iterations: f_history {fh:.3g} rel (< 1e-4), x {xe:.3g} relative L2 (< 1e-3)")


def phase5_cufft(card: str) -> None:
    """cuFFT float32 against NumPy float64 at SHAPE: a white-noise rfftn ->
    irfftn round trip and a white-noise circular convolution."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(SHAPE)
    k = rng.standard_normal(SHAPE)
    xg = torch.as_tensor(x, dtype=torch.float32, device="cuda")
    kg = torch.as_tensor(k, dtype=torch.float32, device="cuda")
    back = torch.fft.irfftn(torch.fft.rfftn(xg), s=SHAPE).double().cpu().numpy()
    conv = torch.fft.irfftn(torch.fft.rfftn(xg) * torch.fft.rfftn(kg), s=SHAPE).double().cpu().numpy()
    ref = np.fft.irfftn(np.fft.rfftn(x) * np.fft.rfftn(k), s=SHAPE, axes=(0, 1, 2))

    def rms_rel(a, b):
        return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))

    e_rt, e_conv = rms_rel(back, x), rms_rel(conv, ref)
    if e_rt > 1e-5 or e_conv > 1e-5:
        raise AssertionError(f"cuFFT float32 error above round-off: round trip {e_rt:.3g}, convolution {e_conv:.3g}")
    log(5, f"[{card}] cuFFT float32 vs NumPy float64 at {SHAPE}: RMS relative error round trip "
           f"{e_rt:.3g}, white-noise convolution {e_conv:.3g} (< 1e-5)")


def phase6_batched_kernel(card: str) -> dict:
    """The batched kernel against its plain version at BATCH_SHAPES and
    UNALIGNED_BATCH over the eps/scales grid of phase 2; each lane's cost
    and gradient bitwise equal to the single-volume kernel's (the same
    partials, summed per volume in the same order inside the kernel), the
    lane views of UNALIGNED_BATCH taking the unaligned instantiation; then
    its times at BATCH_SHAPES[0] and at the tiled run's 4x256^3."""
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

    dev = torch.device("cuda")
    max_err = 0.0
    hv.unaligned_launches = 0
    for shape in (*BATCH_SHAPES, UNALIGNED_BATCH):
        x = torch.as_tensor(np.random.default_rng(8).standard_normal(shape, dtype=np.float32), device=dev)
        for eps in (0.1, 1.0):
            for scales in (None, (2.0, 1.0, 1.0)):
                f, g = hv.hyperbolic_tv_batched_fused(x, eps, scales)
                f_ref, g_ref = hv.hyperbolic_tv_batched_plain(x, eps, scales)
                rel = float(((f - f_ref).abs() / f_ref.abs()).max())
                err = (g - g_ref).abs().max().item()
                max_err = max(max_err, err)
                if rel > TV_COST_RTOL or not torch.allclose(g, g_ref, rtol=TV_GRAD_RTOL, atol=TV_GRAD_ATOL):
                    raise AssertionError(f"batched kernel != plain at {shape} eps={eps} scales={scales}: "
                                         f"cost rel {rel:.3g}, grad max abs {err:.3g}")
                if shape[1] == 256:
                    f64 = hv.hyperbolic_tv_batched_plain(x.double(), eps, scales)[0]
                    rel64 = float(((f.double() - f64).abs() / f64.abs()).max())
                    if rel64 > TV_F64_RTOL:
                        raise AssertionError(f"256-plane batched cost off float64 by {rel64:.3g}")
                for b in range(shape[0]):
                    fb, gb = hv.hyperbolic_tv_fused(x[b], eps, scales)
                    if not (torch.equal(g[b], gb) and torch.equal(f[b], fb)):
                        raise AssertionError(f"lane {b} != single-volume kernel at {shape} eps={eps} "
                                             f"scales={scales}: cost {f[b].item()} vs {fb.item()}")
                f2, g2 = hv.hyperbolic_tv_batched_fused(x, eps, scales)
                if not (torch.equal(f, f2) and torch.equal(g, g2)):
                    raise AssertionError(f"two batched launches differ at {shape} eps={eps} scales={scales}")
        f, g = hv.hyperbolic_tv_batched_fused(torch.full(shape, 2.5, device=dev), 0.1)
        if f.abs().max().item() > 1e-5 or g.abs().max().item() != 0.0:
            raise AssertionError(f"constant batch gives costs {f.tolist()}, grad {g.abs().max().item()}")
        # Every launch of the odd-shaped batch and of its lanes is unaligned (nx % 4 != 0).
        want = 0 if shape != UNALIGNED_BATCH else 4 * (2 + shape[0]) + 1
        if hv.unaligned_launches != want:
            raise AssertionError(f"unaligned launches at {shape}: {hv.unaligned_launches}, expected {want}")
    ptrs = [x[b].data_ptr() % 16 for b in range(UNALIGNED_BATCH[0])]
    torch.cuda.synchronize()
    log(6, f"batched kernel == plain at {list(BATCH_SHAPES) + [UNALIGNED_BATCH]}, eps (0.1, 1.0), scales (None, "
           f"(2,1,1)): cost rtol {TV_COST_RTOL}, grad rtol {TV_GRAD_RTOL} atol {TV_GRAD_ATOL} (max grad abs err "
           f"{max_err:.3g}); 256-plane costs within {TV_F64_RTOL} of float64; every lane's cost and gradient "
           f"bitwise equal to the single-volume kernel's (lanes of {UNALIGNED_BATCH} at {ptrs} bytes off "
           "16-byte alignment, unaligned instantiation); constant batch 0; two launches bitwise equal")

    out = {}
    for shape in (BATCH_SHAPES[0], BATCH_SHAPES[3]):
        x = torch.as_tensor(np.random.default_rng(0).standard_normal(shape, dtype=np.float32), device=dev)
        t = kernel_times(x, lambda: hv.hyperbolic_tv_batched_fused(x, 1.0),
                         lambda: hv.hyperbolic_tv_batched_plain(x, 1.0))
        extra = ""
        if shape == BATCH_SHAPES[0]:
            t["singles_ms"] = _median_ms(lambda: [hv.hyperbolic_tv_fused(x[b], 1.0) for b in range(shape[0])])
            extra = f"; {shape[0]} single-volume wrapper calls {t['singles_ms']:.4f} ms"
        log(6, f"[{card}] batched TV at {shape}: {times_line(shape, t)}{extra}")
        out[shape] = t
        del x
    lanes, tiled = out[BATCH_SHAPES[0]], out[BATCH_SHAPES[3]]
    return {"max_abs_err": max_err, "ms": lanes["call_ms"], **lanes, "library_ms": None,
            "tiled_batch": {"shape": list(BATCH_SHAPES[3]), **tiled}}


def phase7_batched(card: str) -> int:
    """``batched_deconvolve`` of 4 bench scenes at LANE_SHAPE, phase 3's
    config: wall, throughput and the launch counts; then each lane against
    ``deconvolve`` of its scene, with phase 4's float32 bounds (f over the
    first iterations to 1e-4, the final f to 1e-3 relative)."""
    from microtipi_tpu_torch.jobs.batch import batched_deconvolve
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, deconvolve
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

    dev, nvox = torch.device("cuda"), float(np.prod(LANE_SHAPE))
    scenes = [bench_scene(LANE_SHAPE, dev, torch.float32, seed=s) for s in range(4)]
    data, psf = torch.stack([d for _, d, _ in scenes]), scenes[0][2]
    cfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=20, grtol=0.0, gatol=0.0)
    batched_deconvolve(data, psf, config=cfg)  # warm-up (cuFFT plans for the batch)
    torch.cuda.reset_peak_memory_stats()
    hv.launches = hv.batched_launches = hv.unaligned_launches = 0
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = batched_deconvolve(data, psf, config=cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    single, batched, unaligned = hv.launches, hv.batched_launches, hv.unaligned_launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    wall = float(np.median(walls))
    _check_object("batched_deconvolve", res.x)
    if batched == 0 or single != 0 or unaligned != 0 or not np.isfinite(res.f).all():
        raise AssertionError(f"batched_deconvolve: f={res.f}, batched kernel launches {batched}, "
                             f"single-volume launches {single}, unaligned {unaligned} (both must be 0)")
    log(7, f"[{card}] batched_deconvolve 4 x {LANE_SHAPE}: iterations {res.iterations.tolist()}, "
           f"evaluations {res.evaluations.tolist()}, status {res.status.tolist()}, wall {wall:.4f} s "
           f"(median of 3 after 1 warm-up), {nvox * res.iterations.sum() / wall / 1e6:.1f} Mvox*iter/s, "
           f"batched kernel launches {batched} (3 runs; single-volume launches {single}, unaligned {unaligned}), "
           f"peak device memory {peak:.3f} GiB")
    worst4 = worstf = worstx = 0.0
    for b in range(4):
        r = deconvolve(data[b], psf, config=cfg)
        worst4 = max(worst4, np.max(np.abs(res.f_history[b, :4] - r.f_history[:4]) / np.abs(r.f_history[:4])))
        worstf = max(worstf, abs(float(res.f[b]) - float(r.f)) / abs(float(r.f)))
        worstx = max(worstx, float(torch.linalg.norm(res.x[b] - r.x) / torch.linalg.norm(r.x)))
    if worst4 > 1e-4 or worstf > 1e-3:
        raise AssertionError(f"batched lanes != deconvolve: f_history[:4] {worst4:.3g}, final f {worstf:.3g}")
    log(7, f"each lane against deconvolve of its scene: f_history[:4] {worst4:.3g} rel (< 1e-4), "
           f"final f {worstf:.3g} rel (< 1e-3); x {worstx:.3g} relative L2")
    return batched


def design_volume(psf: torch.Tensor, shape=None) -> np.ndarray:
    """A float32 scene of ``shape`` (default VOLUME) on the host from a
    fixed seed: 0.1% random beads x 300, blurred on the card by ``psf`` (one
    circular FFT convolution of the whole volume), plus 1% Gaussian noise."""
    from microtipi_tpu_torch.ops.convolution import convolve, convolve_spectrum
    from microtipi_tpu_torch.utils.arrays import pad_fft_kernel

    shape = tuple(shape or VOLUME)
    rng = np.random.default_rng(11)
    n = int(np.prod(shape))
    obj = np.zeros(n, np.float32)
    obj[rng.integers(0, n, n // 1000)] = rng.random(n // 1000, dtype=np.float32) * 300
    noise = rng.standard_normal(shape, dtype=np.float32)
    with torch.no_grad():
        d = convolve(torch.as_tensor(obj.reshape(shape), device="cuda"),
                     convolve_spectrum(pad_fft_kernel(psf, shape)), shape)
        d += 0.01 * d.max() * torch.as_tensor(noise, device="cuda")
        out = d.cpu().numpy()
    del d
    torch.cuda.empty_cache()
    return out


def design_psf() -> torch.Tensor:
    """The design-scale run's PSF_SHAPE widefield PSF (NA 1.4, 561 nm,
    80/200 nm sampling, in focus) on the card."""
    from microtipi_tpu_torch.models.widefield import WideFieldConfig, WideFieldModel

    model = WideFieldModel(WideFieldConfig(shape=PSF_SHAPE, na=1.4, wavelength=561e-9, ni=1.518, dxy=80e-9,
                                           dz=200e-9, n_phase=6, dtype=torch.float32))
    with torch.no_grad():
        return model.compute_psf(model.init_params())


def phase8_tiled(card: str, psf: torch.Tensor, data: np.ndarray, setup: float) -> int:
    """``tiled_deconvolve`` at design scale (BASELINE.md:1241-1251): the
    VOLUME scene ``data`` (made in ``setup`` seconds), the PSF of
    :func:`design_psf`, tiles of TILE with OVERLAP, MAX_BATCH lanes a batch,
    10 VMLMB iterations, timed after a warm-up on the WARM_VOLUMES corners
    (the FFT plans of both batch sizes); then one tile covering a LANE_SHAPE
    volume against ``deconvolve``."""
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
    from microtipi_tpu_torch.jobs.tiled import tile_plan, tiled_deconvolve
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

    plan = tile_plan(VOLUME, TILE, (OVERLAP,) * 3)
    n_tiles = int(np.prod([len(starts) for starts, _ in plan]))
    n_batches = -(-n_tiles // MAX_BATCH)
    cfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=10, grtol=0.0, gatol=0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for corner in WARM_VOLUMES:
        tiled_deconvolve(data[tuple(slice(n) for n in corner)], psf, tile=TILE, overlap=OVERLAP, config=cfg,
                         max_batch=MAX_BATCH)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    hv.launches = hv.batched_launches = hv.unaligned_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tiled_deconvolve(data, psf, tile=TILE, overlap=OVERLAP, config=cfg, max_batch=MAX_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    single, batched, unaligned = hv.launches, hv.batched_launches, hv.unaligned_launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    if out.shape != VOLUME or not np.isfinite(out).all() or out.min() < 0:
        raise AssertionError(f"tiled_deconvolve: output shape {out.shape}, finite {np.isfinite(out).all()}, "
                             f"min {out.min()}")
    if batched == 0 or single != 0 or unaligned != 0:
        raise AssertionError(f"tiled_deconvolve: batched kernel launches {batched}, single-volume {single}, "
                             f"unaligned {unaligned}")
    vox, halo_vox = float(np.prod(VOLUME)), float(n_tiles * np.prod(TILE))
    log(8, f"[{card}] tiled_deconvolve {VOLUME} float32 (made in {setup:.1f} s), tile {TILE}, overlap "
           f"{OVERLAP}, max_batch {MAX_BATCH}: {n_tiles} tiles in {n_batches} batches, wall {wall:.3f} s "
           f"(1 run after a warm-up of {WARM_VOLUMES} in 4 and 3 tiles, {warm:.3f} s), at max_iter {cfg.max_iter}: "
           f"{vox * cfg.max_iter / wall / 1e6:.1f} Mvox*iter/s of output, "
           f"{halo_vox * cfg.max_iter / wall / 1e6:.1f} including halos; batched kernel launches "
           f"{batched} (single-volume {single}, unaligned {unaligned}); peak device memory {peak:.3f} GiB")
    del out
    phase8_single_tile(cfg)
    return batched


@contextlib.contextmanager
def _per_lane_fft():
    """The data terms' FFTs of a batch taken lane by lane, each as one
    volume's: the batched path with the single path's FFT rounding."""
    from microtipi_tpu_torch.ops import convolution as conv

    rfftn, irfftn = conv._rfftn, conv._irfftn
    conv._rfftn = lambda x: torch.stack([rfftn(v) for v in x]) if x.ndim == 4 else rfftn(x)
    conv._irfftn = lambda z, s: torch.stack([irfftn(v, s) for v in z]) if z.ndim == 4 else irfftn(z, s)
    try:
        yield
    finally:
        conv._rfftn, conv._irfftn = rfftn, irfftn


def phase8_single_tile(cfg) -> None:
    """One tile covering a LANE_SHAPE volume. The tiling itself is exact, so
    the output is bitwise the batched solve of that volume. Against
    ``deconvolve`` the two are held to phase 4's float32 bounds on f. Then
    the witnesses of where they part: with the batch's FFTs taken lane by
    lane, the batched solve IS ``deconvolve``, bit for bit (the driver, the
    lane sums and the batched TV add no rounding); and ``deconvolve`` of the
    data after one batch-of-one FFT round trip (a float32 round-off change)
    moves x as far."""
    from microtipi_tpu_torch.jobs.batch import batched_deconvolve
    from microtipi_tpu_torch.jobs.deconv import deconvolve, make_objective
    from microtipi_tpu_torch.jobs.tiled import tiled_deconvolve

    _, vol, lane_psf = bench_scene(LANE_SHAPE, torch.device("cuda"), torch.float32, seed=5)
    got = tiled_deconvolve(vol.cpu().numpy(), lane_psf, tile=LANE_SHAPE, overlap=4, config=cfg)
    lane = batched_deconvolve(vol[None], lane_psf, config=cfg)
    want = deconvolve(vol, lane_psf, config=cfg)
    with _per_lane_fft():
        split = batched_deconvolve(vol[None], lane_psf, config=cfg)
    dims = (-3, -2, -1)
    nudged = torch.fft.irfftn(torch.fft.rfftn(vol[None], dim=dims), s=LANE_SHAPE, dim=dims)[0]
    other = deconvolve(nudged, lane_psf, config=cfg)

    f_of = make_objective(lane_psf, vol, None, cfg, accurate=True)

    def against_want(x, f_history):
        """(f_history[:4] rel, objective rel, x relative L2) against ``want``."""
        f4 = float(np.max(np.abs(f_history[:4] - want.f_history[:4]) / np.abs(want.f_history[:4])))
        f_x, f_w = float(f_of(x)[0]), float(f_of(want.x)[0])
        return f4, abs(f_x - f_w) / abs(f_w), float(torch.linalg.norm(x - want.x) / torch.linalg.norm(want.x))

    tile_f4, tile_f, tile_x = against_want(torch.as_tensor(got, device="cuda"), lane.f_history[0])
    nudge_f4, nudge_f, nudge_x = against_want(other.x, other.f_history)
    nudge = float(torch.linalg.norm(nudged - vol) / torch.linalg.norm(vol))
    same = torch.equal(split.x[0], want.x) and np.array_equal(split.f_history[0], want.f_history, equal_nan=True)
    if not np.array_equal(got, lane.x[0].cpu().numpy()) or tile_f4 > 1e-4 or tile_f > 1e-3 or not same:
        raise AssertionError(f"single-tile tiled_deconvolve: bitwise the batched solve "
                             f"{np.array_equal(got, lane.x[0].cpu().numpy())}; against deconvolve f_history[:4] "
                             f"{tile_f4:.3g}, objective {tile_f:.3g}; with per-lane FFTs bitwise deconvolve {same}")
    log(8, f"one tile covering {LANE_SHAPE}: bitwise equal to batched_deconvolve of the volume; against "
           f"deconvolve on the card f_history[:4] {tile_f4:.3g} rel (< 1e-4), objective {tile_f:.3g} rel "
           f"(< 1e-3), x {tile_x:.3g} relative L2. With the batch's FFTs taken lane by lane the batched "
           f"solve is deconvolve bit for bit. deconvolve of the data after one batch-of-one FFT round trip "
           f"(changed by {nudge:.3g} relative L2): f_history[:4] {nudge_f4:.3g} rel, objective {nudge_f:.3g} "
           f"rel, x {nudge_x:.3g} relative L2")


def admm_state(shape, seed: int = 0) -> dict:
    """Random x, z1, u1, z2, u2 of a batch ``shape`` drawn on the card (from
    ``seed``) and per-lane lam, rho1, rho2 that differ between lanes."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    nb = shape[0]

    def normal(s):
        return torch.randn(s, generator=gen, device="cuda")

    st = {"x": normal(shape), "z1": normal((nb, 3, *shape[1:])), "u1": normal((nb, 3, *shape[1:])),
          "z2": normal(shape), "u2": normal(shape)}
    st.update({k: 0.05 + 1.95 * torch.rand(nb, generator=gen, device="cuda") for k in ("lam", "rho1", "rho2")})
    return st


def admm_bound(shape, volumes: int, ops: int) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") of an ADMM kernel over ``shape``."""
    n = float(np.prod(shape))
    t_bytes, t_ops = volumes * n * 4 / HBM_BYTES_PER_S, ops * n / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def capture_split_states(data, psf, cfg, alpha: float) -> dict:
    """The split update's inputs at SOLVE_ITERATIONS of ``admm_deconvolve``
    (untracked, over-relaxation ``alpha``), captured by wrapping the engine's
    ``admm_split_update`` name for the run: {iteration: (tensors, args)}."""
    from microtipi_tpu_torch.jobs import admm

    wrapped, states, calls = admm.admm_split_update, {}, [0]

    def capture(*call):
        calls[0] += 1
        if calls[0] in SOLVE_ITERATIONS:
            states[calls[0]] = ([t.clone() for t in call[:6]], call[6:])
        wrapped(*call)

    admm.admm_split_update = capture
    try:
        admm.admm_deconvolve(data, psf, config=cfg, track_objective=False, over_relax=alpha)
    finally:
        admm.admm_split_update = wrapped
    return states


def newton_steps(vmag: torch.Tensor, lam, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Per voxel, the Newton steps of the prox (that step counted) up to the
    first whose result repeats its input bit for bit (a fixed point), and up
    to the first whose result repeats its input or the iterate before it (a
    fixed point or an orbit of period 2: where the kernel stops); each
    NEWTON_ITERS + 1 where none of the NEWTON_ITERS steps does. A plain count
    by the plain prox."""
    from microtipi_tpu_torch.ops.kernels import admm_split as ak

    fixed = torch.full(vmag.shape, ak.NEWTON_ITERS + 1, dtype=torch.uint8, device=vmag.device)
    settled = fixed.clone()
    prev2, prev = None, ak.hyperbolic_prox(vmag, lam, eps, newton_iters=0).view(torch.int32)
    for k in range(1, ak.NEWTON_ITERS + 1):
        cur = ak.hyperbolic_prox(vmag, lam, eps, newton_iters=k).view(torch.int32)
        fixed.masked_fill_((cur == prev) & (fixed > k), k)
        repeat = (cur == prev) if prev2 is None else (cur == prev) | (cur == prev2)
        settled.masked_fill_(repeat & (settled > k), k)
        prev2, prev = prev, cur
    return fixed, settled


def fresh_launch_ms(tensors, args, n: int = 20, warmup: int = 3) -> float:
    """Median over ``n`` launches of the split-update kernel, each on a fresh
    copy of the state ``tensors`` (x, z1, u1, z2, u2, lam), CUDA events around
    the launch alone."""
    from microtipi_tpu_torch.ops.kernels import admm_split as ak

    work = [t.clone() for t in tensors]
    launch = ak.prepare_split_update(*work, *args)
    times = []
    for i in range(warmup + n):
        for w, t in zip(work[1:5], tensors[1:5]):
            w.copy_(t)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def sass_counts(name: str) -> dict:
    """Per kernel of the library built from ``csrc/<name>.cu`` (``cuobjdump
    -sass``, beside nvcc): the instructions and the count of each of SASS_OPS,
    the division and square-root sequences (a correctly rounded division is
    MUFU.RCP + FCHK, a reciprocal MUFU.RCP, a square root MUFU.RSQ) and the
    calls to their slow paths."""
    import re
    from pathlib import Path

    from microtipi_tpu_torch._build import library_path, nvcc_path

    tool = Path(nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(library_path(name))], capture_output=True, text=True,
                          check=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : \S*?(admm_\w+?_kernel)(\w*)", line)
        if fn:
            flags = "".join(re.findall(r"Lb([01])E", fn.group(2)))
            kernel = fn.group(1) + (f"<{','.join(flags)}>" if flags else "")
            counts[kernel] = dict.fromkeys(("instructions", *SASS_OPS), 0)
        elif kernel and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[kernel]["instructions"] += 1
            for op in SASS_OPS:
                counts[kernel][op] += op in line
    if not counts:
        raise AssertionError(f"cuobjdump -sass of {name} shows no ADMM kernel")
    return counts


def phase9_solve_states(card: str) -> dict:
    """The split update on the states the 256^3 bench solve hands it
    (phase 10's scene and config) at SOLVE_ITERATIONS, over-relaxed 1.8 and 1,
    beside phase 9's random state and a zero-gradient state (x = z1 = u1 = 0,
    every vmag sqrt(tiny)): per state the histogram of Newton steps to the
    bitwise fixed point (per voxel, and the most over each 128 voxels in a
    row, a warp of four voxels a thread), the share of voxels with vmag at or
    below TINY_VMAG, and the launch's time on a fresh copy; then the SASS
    counts. Returns the iteration-10 times, by alpha."""
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
    from microtipi_tpu_torch.ops.kernels import admm_split as ak

    _, data, psf = bench_scene(SHAPE, torch.device("cuda"), torch.float32)
    cfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=max(SOLVE_ITERATIONS), grtol=0.0, gatol=0.0)
    rnd = admm_state((1, *SHAPE), seed=0)
    rnd_tensors = [rnd[k] for k in ("x", "z1", "u1", "z2", "u2", "lam")]
    zero_tensors = [torch.zeros_like(t) for t in rnd_tensors[:5]] + [rnd["lam"]]
    out = {}
    for alpha in SOLVE_ALPHAS:
        volumes, ops = (SPLIT_VOLUMES, SPLIT_OPS) if alpha == 1.0 else (SPLIT_VOLUMES_RELAXED, SPLIT_OPS_RELAXED)
        bound_ms = admm_bound((1, *SHAPE), volumes, ops)[0]
        states = capture_split_states(data, psf, cfg, alpha)
        rows = [*((f"solve iteration {it}", *states[it]) for it in SOLVE_ITERATIONS),
                ("random (phase 9's timing state)", rnd_tensors, (1.0, alpha, True, None)),
                ("zero gradient", zero_tensors, (1.0, alpha, True, None))]
        for name, tensors, args in rows:
            eps, al, _, scales = args
            _, _, vmag = ak.split_magnitude(*tensors[:3], al, scales)
            hists = []
            for steps in newton_steps(vmag, ak.per_lane(tensors[5]), eps):
                warps = steps.view(-1, 128).amax(1)
                hists += [[round(float(c) / t.numel(), 4) for c in torch.bincount(t.flatten().long(),
                                                                                  minlength=ak.NEWTON_ITERS + 2)[1:]]
                          for t in (steps, warps)]
            tiny = float((vmag <= TINY_VMAG).double().mean())
            got, want = [t.clone() for t in tensors], [t.clone() for t in tensors]
            ak.admm_split_update(*got, *args)
            ak.admm_split_update_plain(*want, *args)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"admm_split_update != plain on {name}, alpha {al}")
            del got, want
            ms = fresh_launch_ms(tensors, args)
            log(9, f"[{card}] split update on {name}, alpha {al}, lam {float(tensors[5][0]):.4g}: shares of Newton "
                   f"steps 1..{ak.NEWTON_ITERS} and 'not by {ak.NEWTON_ITERS}', to the bitwise fixed point: voxels "
                   f"{hists[0]}, 128-voxel warps (their most) {hists[1]}; to a fixed point or a period-2 orbit: "
                   f"voxels {hists[2]}, warps {hists[3]}; vmag <= {TINY_VMAG:g}: {tiny:.4f} of voxels; kernel == plain "
                   f"bit for bit; {ms:.4f} ms a "
                   f"launch on a fresh copy (median of 20), {bound_ms / ms:.1%} of the bound {bound_ms:.4f} ms")
            if name == f"solve iteration {SOLVE_ITERATIONS[1]}":
                out[alpha] = {"shape": [1, *SHAPE], "iteration": SOLVE_ITERATIONS[1], "fresh_copy_ms": ms,
                              "bound_ms": bound_ms, "bound_share": bound_ms / ms}
        del states, rows
    for kernel, c in sass_counts("admm_split").items():
        log(9, f"SASS of {kernel}: " + ", ".join(f"{k} {v}" for k, v in c.items()))
    return out


def phase9_admm_kernels(card: str) -> tuple[dict, dict]:
    """Both ADMM kernels against their plain versions on the card, bit for bit
    at every scale, in both instantiations of the split update; two launches
    bitwise equal; the Newton prox against float64; then the solve states
    (phase9_solve_states) and the times at the first three of
    ADMM_FULL_SHAPES (one volume, the batched step's lanes, the tiled run's
    full batch)."""
    worst = phase9_compare()
    return phase9_times(card, worst, phase9_solve_states(card))


def offset_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` whose base lies 4 bytes off 16-byte alignment (a view
    into a buffer one element longer)."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


def phase9_compare() -> dict:
    """The comparisons of phase 9; returns the largest abs error of each kernel."""
    from microtipi_tpu_torch.ops.kernels import admm_split as ak

    eps32 = float(np.finfo(np.float32).eps)
    worst = {"split": 0.0, "rhs": 0.0}  # max abs error over every comparison

    def compare(base, alpha, positivity, scales, offset=False):
        shape = tuple(base["x"].shape)
        pl = {k: v.clone() for k, v in base.items()}
        st, again = ({k: offset_copy(v) if offset and v.ndim > 1 else v.clone() for k, v in base.items()}
                     for _ in range(2))
        args = (0.3, alpha, positivity, scales)
        before = ak.split_unaligned_launches
        ak.admm_split_update(st["x"], st["z1"], st["u1"], st["z2"], st["u2"], st["lam"], *args)
        ak.admm_split_update(again["x"], again["z1"], again["u1"], again["z2"], again["u2"], again["lam"], *args)
        ak.admm_split_update_plain(pl["x"], pl["z1"], pl["u1"], pl["z2"], pl["u2"], pl["lam"], *args)
        where = f"at {shape}{' (a view off 16-byte alignment)' if offset else ''} alpha={alpha} " \
                f"positivity={positivity} scales={scales}"
        unaligned = offset or shape[-1] % 4 != 0
        if ak.split_unaligned_launches - before != 2 * unaligned:
            raise AssertionError(f"the split update took the wrong instantiation {where}")
        pairs = [("split", k, st[k], pl[k], again[k]) for k in ("z1", "u1", "z2", "u2")]
        rhs_args = (st["z1"], st["u1"], st["z2"], st["u2"], st["rho1"], st["rho2"], scales)
        pairs.append(("rhs", "rhs", ak.admm_rhs(*rhs_args), ak.admm_rhs_plain(*rhs_args), ak.admm_rhs(*rhs_args)))
        for kernel, name, got, want, twice in pairs:
            err = float((got - want).abs().max())
            worst[kernel] = max(worst[kernel], err)
            if not torch.equal(got, want):
                raise AssertionError(f"kernel != plain, bitwise expected: {name} {where}: max abs {err:.3g} "
                                     f"({err / (eps32 * float(want.abs().max())):.2f} ulp of the largest value)")
            if not torch.equal(got, twice):
                raise AssertionError(f"two launches differ: {name} {where}")
        if not torch.equal(st["x"], pl["x"]):
            raise AssertionError(f"the split update wrote x {where}")

    n = 0
    for shape in ADMM_KERNEL_SHAPES:
        base = admm_state(shape, seed=9)
        for alpha in (1.0, 1.8):
            for positivity in (True, False):
                for scales in ADMM_SCALES:
                    for offset in (False, True) if shape in ADMM_VIEW_SHAPES else (False,):
                        compare(base, alpha, positivity, scales, offset)
                        n += 1
    for shape in ADMM_FULL_SHAPES:
        base = admm_state(shape, seed=9)
        for alpha, positivity, scales in ((1.8, True, None), (1.0, False, ADMM_SCALES[1]), (1.8, True, ADMM_SCALES[2]),
                                          (1.0, True, ADMM_SCALES[2])):
            compare(base, alpha, positivity, scales)
            n += 1
    del base

    # The Newton prox against float64: with x = u1 = 0 and z1 = v, alpha = 0
    # makes the relaxed difference v itself, so z1 comes back as prox(|v|) v/|v|.
    shape, lam, eps = (1, 16, 32, 64), 0.4, 0.3
    v = torch.as_tensor(np.random.default_rng(2).uniform(-3.0, 3.0, (1, 3, *shape[1:])).astype(np.float32), device="cuda")
    z1, zeros = v.clone(), torch.zeros(shape, device="cuda")
    ak.admm_split_update(zeros, z1, torch.zeros_like(v), zeros.clone(), zeros.clone(),
                         torch.tensor([lam], device="cuda"), eps, alpha=0.0)
    inner = (slice(None), slice(None), slice(0, -1), slice(0, -1), slice(0, -1))  # off the trailing faces
    v64 = v.double()
    mag = torch.sqrt((v64 * v64).sum(1, keepdim=True))
    want = (ak.hyperbolic_prox(mag, lam, eps, newton_iters=50) / mag * v64)[inner]
    prox_ulps = float((z1.double()[inner] - want).abs().max()) / (eps32 * float(want.abs().max()))
    if prox_ulps > ADMM_ULPS:
        raise AssertionError(f"the kernel's Newton prox is {prox_ulps:.2f} float32 ulp off the float64 prox")
    torch.cuda.synchronize()
    log(9, f"admm_split_update and admm_rhs == plain bit for bit over {n} cases at "
           f"{list(ADMM_KERNEL_SHAPES + ADMM_FULL_SHAPES)} (and views off 16-byte alignment at "
           f"{list(ADMM_VIEW_SHAPES)}: the 4-byte instantiation, as nx = 67), alpha (1.0, 1.8), positivity on and off, "
           f"scales {list(ADMM_SCALES)}, per-lane lam and rho; two launches bitwise equal; Newton prox "
           f"{prox_ulps:.2f} ulp off the float64 prox (bound {ADMM_ULPS})")
    return worst


def phase9_times(card: str, worst: dict, solve: dict) -> tuple[dict, dict]:
    """Both kernels' times at the first three of ADMM_FULL_SHAPES, and their
    entries of the kernels line (``solve_state``: the split update on the
    solve's iteration-10 state)."""
    from microtipi_tpu_torch.ops.kernels import admm_split as ak

    split, rhs = {}, {}
    for shape in ADMM_FULL_SHAPES[:3]:
        st = admm_state(shape, seed=0)
        vols = (st["x"], st["z1"], st["u1"], st["z2"], st["u2"], st["lam"])
        for alpha, volumes, ops in ((1.8, SPLIT_VOLUMES_RELAXED, SPLIT_OPS_RELAXED), (1.0, SPLIT_VOLUMES, SPLIT_OPS)):
            t = {"kernel_ms": raw_ms(ak.prepare_split_update(*vols, 1.0, alpha)),
                 "call_ms": _median_ms(lambda: ak.admm_split_update(*vols, 1.0, alpha)),
                 "plain_ms": _median_ms(lambda: ak.admm_split_update_plain(*vols, 1.0, alpha), n=5, warmup=1)}
            t["bound_ms"], t["bound_by"] = admm_bound(shape, volumes, ops)
            t["bound_share"] = t["bound_ms"] / t["kernel_ms"]
            split[(shape, alpha)] = t
            log(9, f"[{card}] admm_split_update at {shape}, alpha {alpha}: {admm_times_line(shape, volumes, t)}")
        st = admm_state(shape, seed=1)  # the update above has grown u1 and u2 launch by launch
        rhs_args = (st["z1"], st["u1"], st["z2"], st["u2"], st["rho1"], st["rho2"])
        t = {"kernel_ms": raw_ms(ak.prepare_rhs(*rhs_args)[0]), "call_ms": _median_ms(lambda: ak.admm_rhs(*rhs_args)),
             "plain_ms": _median_ms(lambda: ak.admm_rhs_plain(*rhs_args), n=5, warmup=1)}
        t["bound_ms"], t["bound_by"] = admm_bound(shape, RHS_VOLUMES, RHS_OPS)
        t["bound_share"] = t["bound_ms"] / t["kernel_ms"]
        rhs[shape] = t
        log(9, f"[{card}] admm_rhs at {shape}: {admm_times_line(shape, RHS_VOLUMES, t)}")
        del st, vols, rhs_args
    single, lanes, tiled = ADMM_FULL_SHAPES[:3]

    def entry(main, err, others: dict) -> dict:
        return {"max_abs_err": err, "ms": main["call_ms"], **main, "library_ms": None,
                **{k: {"shape": list(sh), **t} for k, (sh, t) in others.items()}}

    split_entry = entry(split[(single, 1.8)], worst["split"], {
        "alpha_1": (single, split[(single, 1.0)]), "batched": (lanes, split[(lanes, 1.8)]),
        "batched_alpha_1": (lanes, split[(lanes, 1.0)]), "tiled_batch": (tiled, split[(tiled, 1.8)]),
        "tiled_batch_alpha_1": (tiled, split[(tiled, 1.0)])})
    split_entry["solve_state"] = {f"alpha_{alpha:g}": t for alpha, t in solve.items()}
    return split_entry, entry(rhs[single], worst["rhs"], {"batched": (lanes, rhs[lanes]),
                                                           "tiled_batch": (tiled, rhs[tiled])})


def admm_times_line(shape, volumes: int, t: dict) -> str:
    moved = volumes * int(np.prod(shape)) * 4
    return (f"kernel_ms {t['kernel_ms']:.4f} (50 raw launches, {moved / (t['kernel_ms'] * 1e-3) / 1e9:.1f} GB/s), "
            f"call_ms {t['call_ms']:.4f} (wrapper call, median of 20), plain {t['plain_ms']:.4f} ms; bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {volumes} volumes, {moved / 2**20:.0f} MiB at "
            f"{HBM_BYTES_PER_S / 1e12} TB/s), {t['bound_share']:.1%} of it")


class AdmmCounts:
    """The ADMM and TV kernels' launch counts over a stretch of the main path:
    set to 0 on entry, read on exit."""

    def __enter__(self):
        from microtipi_tpu_torch.ops.kernels import admm_split as ak
        from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

        self.ak, self.hv = ak, hv
        ak.split_launches = ak.rhs_launches = ak.split_unaligned_launches = 0
        hv.launches = hv.batched_launches = hv.unaligned_launches = 0
        return self

    def __exit__(self, *exc):
        self.split, self.rhs = self.ak.split_launches, self.ak.rhs_launches
        self.tv_single, self.tv_batched = self.hv.launches, self.hv.batched_launches
        self.tv = self.tv_single + self.tv_batched
        self.unaligned = self.hv.unaligned_launches + self.ak.split_unaligned_launches
        return False

    def check(self, name: str, iterations: int, objective_values: int, split: int | None = None,
              tv: str = "batched") -> str:
        """Each ADMM kernel once an iteration (the split update ``split`` times
        where given), the TV kernel of kind ``tv`` ("batched" or "single")
        once an objective value and the other never."""
        split = iterations if split is None else split
        want_tv = (objective_values, 0) if tv == "single" else (0, objective_values)
        if (self.split, self.rhs, (self.tv_single, self.tv_batched), self.unaligned) != (split, iterations, want_tv, 0):
            raise AssertionError(f"{name}: admm_split_update {self.split} and admm_rhs {self.rhs} launches (expected "
                                 f"{split} and {iterations}), TV launches single {self.tv_single} and batched "
                                 f"{self.tv_batched} (expected {want_tv}), unaligned instantiations (TV, split "
                                 f"update) {self.unaligned}")
        return f"admm_split_update {self.split}, admm_rhs {self.rhs}, {tv} TV {self.tv} launches"


def _timed(fn, runs: int = 3):
    """(median wall of ``runs`` calls after one warm-up, the last result)."""
    fn()
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls)), res


def phase10_admm(card: str, f_vmlmb: float) -> tuple[int, int]:
    """``admm_deconvolve`` on phase 3's scene and config (``bench.py:150-153``).
    Returns the two ADMM kernels' launches on these paths."""
    from microtipi_tpu_torch.jobs.admm import admm_deconvolve
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
    from microtipi_tpu_torch.weights.updaters import InverseVarianceWeights

    dev, nvox = torch.device("cuda"), float(np.prod(SHAPE))
    _, data, psf = bench_scene(SHAPE, dev, torch.float32)
    cfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=20, grtol=0.0, gatol=0.0)
    launched = np.zeros(2, np.int64)

    def rate(wall, iterations):
        return f"wall {wall:.4f} s (median of 3 after 1 warm-up), {nvox * iterations / wall / 1e6:.1f} Mvox*iter/s"

    torch.cuda.reset_peak_memory_stats()
    with AdmmCounts() as c:
        wall, res = _timed(lambda: admm_deconvolve(data, psf, config=cfg, track_objective=False))
    launched += (c.split, c.rhs)
    _check_object("admm_deconvolve", res.x)
    if not np.isfinite(res.f) or not np.isnan(res.f_history[1:]).all():
        raise AssertionError(f"admm_deconvolve untracked: f={res.f}, f_history {res.f_history}")
    log(10, f"[{card}] admm_deconvolve {SHAPE}, 20 iterations, untracked: f {float(res.f):.6g}, {rate(wall, 20)}, "
            f"{c.check('untracked', 4 * 20, 4 * 2)} (4 runs), peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    with AdmmCounts() as c:
        wall, res = _timed(lambda: admm_deconvolve(data, psf, config=cfg))
    launched += (c.split, c.rhs)
    fh = res.f_history
    if not (np.isfinite(fh).all() and np.all(np.diff(fh[2:]) < 0) and fh[-1] < f_vmlmb and float(res.f) == fh[-1]):
        raise AssertionError(f"admm_deconvolve tracked: f_history must fall from iteration 2 on and end below "
                             f"deconvolve's {f_vmlmb:.6g}: {fh.tolist()}")
    log(10, f"[{card}] admm_deconvolve tracked: f_history {fh[0]:.6g} -> {fh[-1]:.6g}, falling from iteration 2 on, "
            f"below deconvolve's 20-iteration objective {f_vmlmb:.6g}; {rate(wall, 20)}, "
            f"{c.check('tracked', 4 * 20, 4 * 22)} (4 runs)")

    weights = InverseVarianceWeights(gain=1.0, readout_variance=1.0).from_data(data)
    torch.cuda.reset_peak_memory_stats()
    with AdmmCounts() as c:
        wall, res = _timed(lambda: admm_deconvolve(data, psf, weights=weights, config=cfg, track_objective=False))
    launched += (c.split, c.rhs)
    _check_object("weighted admm_deconvolve", res.x)
    if not np.isfinite(res.f):
        raise AssertionError(f"weighted admm_deconvolve: f={res.f}")
    log(10, f"[{card}] admm_deconvolve weighted by InverseVarianceWeights.from_data (the data split, 4 FFTs an "
            f"iteration, its prox and dual update PyTorch operators): f {float(res.f):.6g}, {rate(wall, 20)}, "
            f"{c.check('weighted', 4 * 20, 4 * 2)} (4 runs), peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    budget = 600
    bcfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=budget, admm_reltol=1e-3, admm_abstol=1e-6)
    with AdmmCounts() as c:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = admm_deconvolve(data, psf, config=bcfg, track_objective=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched += (c.split, c.rhs)
    if res.status != 0 or not 0 < res.iterations < budget or res.iterations % bcfg.admm_check_every:
        raise AssertionError(f"Boyd-stopped admm_deconvolve: status {res.status} after {res.iterations} of {budget}")
    log(10, f"[{card}] admm_deconvolve stopped by the Boyd test (reltol 1e-3, abstol 1e-6, checked every "
            f"{bcfg.admm_check_every}): status 0 after {res.iterations} of {budget} iterations, f {float(res.f):.6g}, "
            f"wall {wall:.4f} s (1 run), {nvox * res.iterations / wall / 1e6:.1f} Mvox*iter/s, "
            f"{c.check('Boyd-stopped', res.iterations, 2)}")

    # Two float32 runs of 200 tracked iterations in one process: cuFFT and
    # both kernels are deterministic, so f and x must agree bit for bit. (The
    # bench scene stands in for the blobs scene of BASELINE.md:1679-1691,
    # which has no generator in the repository.)
    lcfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=200)
    with AdmmCounts() as c:
        one, two = (admm_deconvolve(data, psf, config=lcfg) for _ in range(2))
    launched += (c.split, c.rhs)
    same_f = np.array_equal(one.f_history, two.f_history) and one.f == two.f
    if not (same_f and torch.equal(one.x, two.x)):
        raise AssertionError(
            f"two 200-iteration float32 ADMM runs differ: f_history by "
            f"{np.max(np.abs(one.f_history - two.f_history) / np.abs(one.f_history)):.3g} relative, x by "
            f"{float(torch.linalg.norm(one.x - two.x) / torch.linalg.norm(one.x)):.3g} relative L2")
    log(10, f"two float32 runs of 200 tracked iterations at {SHAPE}: f_history, f ({float(one.f):.6g}) and x equal bit "
            f"for bit; {c.check('determinism', 400, 404)}")
    return int(launched[0]), int(launched[1])


def blind_admm_config():
    """The blind loop with the ADMM engine, the recommended recipe of
    ``bench.py:243-251``, as phases 11, 30 and 31 run it."""
    from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
    from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig
    from microtipi_tpu_torch.models.microscope import DEFOCUS, PHASE

    return BlindDeconvConfig.recommended(
        loops=5, families=(DEFOCUS, PHASE), psf_max_iter=(5, 5), deconv_engine="admm",
        deconv=DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=20, grtol=0.0, gatol=0.0),
        fit=PsfFitConfig(grtol=0.0))


def phase11_blind_admm(card: str) -> tuple[int, int]:
    """The blind loop with the ADMM engine (:func:`blind_admm_config`) on
    phase 3's blind scene."""
    from microtipi_tpu_torch.jobs.blind import blind_deconvolve

    nvox = float(np.prod(SHAPE))
    model, data, _ = bench_scene(SHAPE, torch.device("cuda"), torch.float32, phase=[0.15, -0.1, 0.08, 0.0, 0.05, 0.0])
    bcfg = blind_admm_config()
    torch.cuda.reset_peak_memory_stats()
    with AdmmCounts() as c:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = blind_deconvolve(data, model, config=bcfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _check_object("blind_deconvolve (admm)", res.obj)
    iters = int(res.deconv_iters.sum())
    if not (np.isfinite(res.deconv_f).all() and np.isnan(res.fit_f[-1]).all() and np.isfinite(res.fit_f[:-1]).all()
            and bool(torch.isfinite(res.psf).all()) and iters == 100):
        raise AssertionError(f"blind (admm): deconv_f {res.deconv_f}, fit_f {res.fit_f}, object iterations {iters}")
    if (c.split, c.rhs) != (100, 100) or c.tv < 10 or c.unaligned:
        raise AssertionError(f"blind (admm): admm_split_update {c.split}, admm_rhs {c.rhs} launches (expected 100 "
                             f"each), TV {c.tv}, unaligned {c.unaligned}")
    log(11, f"[{card}] blind_deconvolve {SHAPE}, recommended recipe with the ADMM engine (wiener start, mu "
            f"{[round(m, 4) for m in bcfg.mu_schedule]}, 5 rounds of 20 iterations, joint defocus+phase fits of 5): "
            f"deconv_f {res.deconv_f.tolist()}, wall {wall:.3f} s (1 run), {nvox * iters / wall / 1e6:.1f} "
            f"Mvox*obj_iter/s, admm_split_update {c.split}, admm_rhs {c.rhs}, TV {c.tv} launches, peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return c.split, c.rhs


def phase12_batched_tiled_admm(card: str, psf: torch.Tensor, volume: np.ndarray) -> tuple[int, int]:
    """``batched_deconvolve(engine="admm")`` on phase 7's batch, each lane
    against ``admm_deconvolve`` of its scene (float32 lanes are compared by
    f: cuFFT rounds a batch otherwise than one volume; an ADMM trajectory
    does not amplify that, so x is held to 1e-3 relative L2 as well); then
    ``tiled_deconvolve(method="admm")`` on the WARM_VOLUMES corners (cold:
    one run each, the ADMM path's first at its batch size) and on the whole
    design volume, phase 8's geometry and iterations; then one tile covering a
    LANE_SHAPE volume, which must be the batched solve of that volume bit for
    bit (the tiling is exact) and ``admm_deconvolve`` of it within the lanes'
    bounds."""
    from microtipi_tpu_torch.jobs.admm import admm_deconvolve
    from microtipi_tpu_torch.jobs.batch import batched_deconvolve
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, make_objective
    from microtipi_tpu_torch.jobs.tiled import tile_plan, tiled_deconvolve

    dev, nvox = torch.device("cuda"), float(np.prod(LANE_SHAPE))
    scenes = [bench_scene(LANE_SHAPE, dev, torch.float32, seed=s) for s in range(4)]
    data, lane_psf = torch.stack([d for _, d, _ in scenes]), scenes[0][2]
    cfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=20, grtol=0.0, gatol=0.0)
    launched = np.zeros(2, np.int64)
    torch.cuda.reset_peak_memory_stats()
    with AdmmCounts() as c:
        wall, res = _timed(lambda: batched_deconvolve(data, lane_psf, config=cfg, engine="admm"))
    launched += (c.split, c.rhs)
    _check_object("batched_deconvolve (admm)", res.x)
    if not np.isfinite(res.f).all() or res.iterations.tolist() != [20] * 4:
        raise AssertionError(f"batched_deconvolve (admm): f={res.f}, iterations {res.iterations}")
    log(12, f"[{card}] batched_deconvolve engine='admm' 4 x {LANE_SHAPE}, 20 iterations: wall {wall:.4f} s (median of "
            f"3 after 1 warm-up), {4 * nvox * 20 / wall / 1e6:.1f} Mvox*iter/s, {c.check('batched', 4 * 20, 4 * 2)} "
            f"(4 runs), peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    worstf = worstx = 0.0
    for b in range(4):
        r = admm_deconvolve(data[b], lane_psf, config=cfg, track_objective=False)
        worstf = max(worstf, abs(float(res.f[b]) - float(r.f)) / abs(float(r.f)))
        worstx = max(worstx, float(torch.linalg.norm(res.x[b] - r.x) / torch.linalg.norm(r.x)))
    if worstf > 1e-4 or worstx > 1e-3:
        raise AssertionError(f"batched ADMM lanes != admm_deconvolve: f {worstf:.3g}, x {worstx:.3g}")
    log(12, f"each lane against admm_deconvolve of its scene: f {worstf:.3g} rel (< 1e-4), x {worstx:.3g} relative L2 "
            f"(< 1e-3)")

    tcfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=10, grtol=0.0, gatol=0.0)
    corners = [(f"warm-up corner {i + 1} (cold: 1 run, no warm-up of its own)",
                volume[tuple(slice(n) for n in c)]) for i, c in enumerate(WARM_VOLUMES)]
    for name, vol in (*corners, ("design scale", volume)):
        n_tiles = int(np.prod([len(starts) for starts, _ in tile_plan(vol.shape, TILE, (OVERLAP,) * 3)]))
        torch.cuda.reset_peak_memory_stats()
        with AdmmCounts() as c:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = tiled_deconvolve(vol, psf, tile=TILE, overlap=OVERLAP, config=tcfg, method="admm", max_batch=MAX_BATCH)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launched += (c.split, c.rhs)
        if out.shape != vol.shape or not np.isfinite(out).all() or out.min() < 0:
            raise AssertionError(f"tiled_deconvolve (admm), {name}: shape {out.shape}, finite "
                                 f"{np.isfinite(out).all()}, min {out.min()}")
        n_batches = -(-n_tiles // MAX_BATCH)
        vox = float(np.prod(vol.shape))
        log(12, f"[{card}] tiled_deconvolve method='admm', {name} {vol.shape}: {n_tiles} tiles of {TILE} in "
                f"{n_batches} batches, 10 iterations, wall {wall:.3f} s (1 run), {vox * 10 / wall / 1e6:.1f} "
                f"Mvox*iter/s of output, {c.check(name, 10 * n_batches, 2 * n_batches)}, peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        del out

    vol = data[3]
    with AdmmCounts() as c:
        got = tiled_deconvolve(vol.cpu().numpy(), lane_psf, tile=LANE_SHAPE, overlap=4, config=tcfg, method="admm")
    launched += (c.split, c.rhs)
    counts = c.check("single tile", 10, 2)
    lane = batched_deconvolve(vol[None], lane_psf, config=tcfg, engine="admm")
    want = admm_deconvolve(vol, lane_psf, config=tcfg, track_objective=False)
    bitwise = np.array_equal(got, lane.x[0].cpu().numpy())
    f_of, x_got = make_objective(lane_psf, vol, None, tcfg, accurate=True), torch.as_tensor(got, device=dev)
    f_got, f_want = float(f_of(x_got)[0]), float(f_of(want.x)[0])
    tile_f = abs(f_got - f_want) / abs(f_want)
    tile_x = float(torch.linalg.norm(x_got - want.x) / torch.linalg.norm(want.x))
    if not bitwise or tile_f > 1e-4 or tile_x > 1e-3:
        raise AssertionError(f"single-tile tiled_deconvolve (admm): bitwise the batched solve {bitwise}; against "
                             f"admm_deconvolve f {tile_f:.3g}, x {tile_x:.3g}")
    log(12, f"one tile covering {LANE_SHAPE}, method='admm': bitwise equal to batched_deconvolve(engine='admm') of the "
            f"volume; against admm_deconvolve on the card objective {tile_f:.3g} rel (< 1e-4), x {tile_x:.3g} relative "
            f"L2 (< 1e-3); {counts}")
    return int(launched[0]), int(launched[1])


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm(a.double().cpu() - b.double().cpu()) / torch.linalg.norm(b.double().cpu()))


def phase4_new_paths() -> None:
    """Card float32 (kernels) against CPU float64 (plain versions) at
    PARITY_SHAPE for the paths of phases 13-16. RL has no line search, so
    float32 follows float64: matched and RL-TV (20 iterations) to 1e-4
    relative L2, Wiener-Butterworth accelerated (10) to 1e-3 (the
    extrapolation amplifies round-off). Auto-mu (tau 5, so that the
    bisection goes both ways): the same decisions and mu_history to 1e-6
    relative (float32 rounding of sqrt(lo*hi)), with the float64 run's
    discrepancies at least 1e-3 relative from their target.
    Uncertainty with the same 4 probes at the float64 solve x_hat, 25 CG
    iterations at most: var to 1e-2 relative L2 (both CG runs stop with
    residuals near 3e-3)."""
    from microtipi_tpu_torch.jobs import uncertainty as tu
    from microtipi_tpu_torch.jobs.autotune import deconvolve_auto_mu
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, deconvolve
    from microtipi_tpu_torch.jobs.richardson_lucy import richardson_lucy
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

    rl_runs = {"matched": (dict(iterations=20), 1e-4), "RL-TV": (dict(iterations=20, mu=0.01, epsilon=1.0), 1e-4),
               "Wiener-Butterworth accelerated": (dict(iterations=10, backprojector="wiener-butterworth",
                                                       accelerate=True), 1e-3)}
    cfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=10, grtol=0.0, gatol=0.0)
    out, inputs = {}, {}
    for dev, dtype in ((torch.device("cuda"), torch.float32), (torch.device("cpu"), torch.float64)):
        _, data, psf = bench_scene(PARITY_SHAPE, dev, dtype)
        inputs[dev.type] = (data, psf)
        hv.launches = hv.batched_launches = 0
        rl = {name: richardson_lucy(data, psf, **kw) for name, (kw, _) in rl_runs.items()}
        launches = hv.launches, hv.batched_launches
        out[dev.type] = (rl, launches, deconvolve_auto_mu(data, psf, config=cfg, steps=6, tau=5.0))
    (rl32, n32, a32), (rl64, n64, a64) = out["cuda"], out["cpu"]
    errs = {name: _rel_l2(rl32[name], rl64[name]) for name in rl_runs}
    if any(errs[name] > bound for name, (_, bound) in rl_runs.items()) or n32 != (20, 0) or n64 != (0, 0):
        raise AssertionError(f"RL card/CPU parity: {errs}, TV launches cuda {n32} (expected (20, 0)), cpu {n64}")
    log(4, f"richardson_lucy card float32 (kernels) vs CPU float64 (plain) at {PARITY_SHAPE}: "
           + ", ".join(f"{name} {err:.3g} relative L2 (< {rl_runs[name][1]:g})" for name, err in errs.items())
           + "; RL-TV launched the TV kernel 20 times on the card")
    margin = float(np.min(np.abs(a64.discrepancy_history - a64.target) / a64.target))
    same = np.array_equal(a32.discrepancy_history > a32.target, a64.discrepancy_history > a64.target)
    mu_err = float(np.max(np.abs(a32.mu_history - a64.mu_history) / a64.mu_history))
    if margin < 1e-3 or not same or mu_err > 1e-6:
        raise AssertionError(f"auto-mu card/CPU parity: margin {margin:.3g}, same decisions {same}, "
                             f"mu_history {mu_err:.3g}")
    log(4, f"deconvolve_auto_mu card vs CPU at {PARITY_SHAPE}, tau 5, 6 probes of 10 iterations: the same decisions "
           f"{(a64.discrepancy_history > a64.target).astype(int).tolist()} (1: over the target), "
           f"mu_history within {mu_err:.3g} relative (< 1e-6), mu {float(a32.mu):.6g} / {float(a64.mu):.6g}; "
           f"the float64 discrepancies are at least {margin:.3g} relative from the target (> 1e-3)")

    data64, psf64 = inputs["cpu"]
    x_hat = deconvolve(data64, psf64, config=cfg).x
    probes = torch.randint(0, 2, (4, *PARITY_SHAPE), generator=torch.Generator().manual_seed(0)) * 2.0 - 1.0
    est = {}
    for dev, dtype in ((torch.device("cuda"), torch.float32), (torch.device("cpu"), torch.float64)):
        data, psf = inputs[dev.type]
        hv.launches = hv.batched_launches = 0
        est[dev.type] = tu._uncertainty(data, psf, x_hat.to(dev, dtype), None, cfg, probes.to(dev, dtype), 1e-5, 25,
                                        0.0, True)
        if hv.launches or hv.batched_launches:
            raise AssertionError("object_uncertainty launched the TV kernel")
    (u32, it32), (u64, it64) = est["cuda"], est["cpu"]
    var_err = _rel_l2(u32.var, u64.var)
    if var_err > 1e-2 or not torch.equal(u32.free.cpu().double(), u64.free):
        raise AssertionError(f"uncertainty card/CPU parity: var {var_err:.3g}, free sets equal "
                             f"{torch.equal(u32.free.cpu().double(), u64.free)}")
    log(4, f"object uncertainty card float32 vs CPU float64 at {PARITY_SHAPE}, the same 4 probes, preconditioned CG "
           f"of at most 25 iterations ({it32.tolist()} / {it64.tolist()}): var {var_err:.3g} relative L2 (< 1e-2), "
           f"residual {float(u32.residual):.3g} / {float(u64.residual):.3g}, the same free set, no TV kernel launch")


OTHER_PHASE = [0.1, 0.05, -0.12, 0.04, 0.0, 0.06]  # the multi-view run's second PSF


def phase13_rl(card: str) -> int:
    """``richardson_lucy`` on phase 3's scene at SHAPE: matched (50
    iterations), RL-TV (50; the TV kernel once an iteration), Wiener-
    Butterworth accelerated (10), the same with the Gaussian discrepancy stop
    on the estimated sigma (its tau just above the 10-iteration run's final
    residual, so that the stop decides inside the run), and
    ``multiview_richardson_lucy`` of two views. Returns the TV kernel's
    launches."""
    from microtipi_tpu_torch.jobs.autotune import estimate_noise_sigma
    from microtipi_tpu_torch.jobs.richardson_lucy import multiview_richardson_lucy, richardson_lucy
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

    dev, nvox = torch.device("cuda"), float(np.prod(SHAPE))
    model, data, psf = bench_scene(SHAPE, dev, torch.float32)
    sigma = float(estimate_noise_sigma(data))

    def residual_ratio(x) -> float:
        """sum (H x - d)^2 / (N sigma^2): the Gaussian stop's discrepancy over its tau-1 target."""
        r = torch.fft.irfftn(torch.fft.rfftn(psf) * torch.fft.rfftn(x), s=SHAPE) - data
        return float((r * r).sum()) / (nvox * sigma ** 2)

    runs = [("matched", dict(iterations=50)),
            ("RL-TV (mu 0.01, epsilon 1)", dict(iterations=50, mu=0.01, epsilon=1.0)),
            ("Wiener-Butterworth, accelerated", dict(iterations=10, backprojector="wiener-butterworth",
                                                     accelerate=True))]
    richardson_lucy(data, psf, iterations=2, mu=0.01, epsilon=1.0)  # warm-up (cuFFT plans, the kernel's first load)
    tv_launches = 0
    while runs:
        name, kw = runs.pop(0)
        hv.launches = hv.batched_launches = hv.unaligned_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, k = richardson_lucy(data, psf, return_iterations=True, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _check_object(f"richardson_lucy {name}", x)
        want = k if kw.get("mu") else 0
        if (hv.launches, hv.batched_launches, hv.unaligned_launches) != (want, 0, 0):
            raise AssertionError(f"richardson_lucy {name}: TV launches {hv.launches} (expected {want}), batched "
                                 f"{hv.batched_launches}, unaligned {hv.unaligned_launches}")
        tv_launches += hv.launches
        ratio = residual_ratio(x)
        extra = f", residual {ratio:.4g} N sigma^2 (sigma {sigma:.6g})"
        if kw.get("backprojector") and "stop" not in kw:
            # On this sparse scene the residual stays far above N sigma^2 (tau 1) for hundreds of
            # iterations, and matched RL barely lowers it (5.6 N sigma^2 after 50 on an H100); the
            # stop runs the same Wiener-Butterworth iteration with its target just above where 10
            # iterations ended.
            tau = 1.05 * ratio
            runs.append((f"{name}, gaussian stop on the estimated sigma, tau {tau:.4g}",
                         dict(kw, iterations=100, stop="gaussian", stop_tau=tau)))
        if "stop" in kw:
            if not 1 < k < kw["iterations"]:
                raise AssertionError(f"the Gaussian stop did not decide inside the run: k {k}")
            extra += f"; stopped at k {k} of {kw['iterations']}"
        log(13, f"[{card}] richardson_lucy {SHAPE} {name}: {k} iterations, wall {wall:.4f} s (1 run), "
                f"{nvox * k / wall / 1e6:.1f} Mvox*iter/s, TV kernel launches {hv.launches}{extra}")

    phase = torch.as_tensor(OTHER_PHASE, dtype=torch.float32, device=dev)
    _, other, _ = bench_scene(SHAPE, dev, torch.float32, phase=OTHER_PHASE)
    with torch.no_grad():
        psf2 = model.compute_psf(model.init_params()._replace(phase=phase))
    views, psfs = torch.stack([data, other]), torch.stack([psf, psf2])
    multiview_richardson_lucy(views, psfs, iterations=2)  # warm-up (the 2-view batched plans)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = multiview_richardson_lucy(views, psfs, iterations=20)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check_object("multiview_richardson_lucy", x)
    log(13, f"[{card}] multiview_richardson_lucy 2 x {SHAPE} (the bench PSF and one with phase {OTHER_PHASE}), 20 "
            f"iterations: wall {wall:.4f} s (1 run), {nvox * 20 / wall / 1e6:.1f} Mvox*iter/s of the object")
    return tv_launches


def phase14_tiled_rl(card: str, psf: torch.Tensor, volume: np.ndarray) -> int:
    """``tiled_deconvolve(method="rl", rl_iterations=10)`` with RL-TV on phase
    8's design volume and geometry (its batch sizes' FFT plans are warm from
    phase 8): one batched TV launch an iteration and batch, none of one
    volume. Then one RL tile covering a LANE_SHAPE volume: bitwise the
    batched RL of that volume (a batch of one; the tiling is exact) and
    within 1e-4 relative L2 of ``richardson_lucy`` of the volume (cuFFT rounds
    a batch of one otherwise than one volume; RL has no line search to
    amplify it). Returns the batched launches."""
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
    from microtipi_tpu_torch.jobs.richardson_lucy import richardson_lucy
    from microtipi_tpu_torch.jobs.tiled import tile_plan, tiled_deconvolve
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

    n_batches = -(-int(np.prod([len(starts) for starts, _ in tile_plan(VOLUME, TILE, (OVERLAP,) * 3)])) // MAX_BATCH)
    cfg = DeconvolutionConfig(mu=0.01, epsilon=1.0)
    torch.cuda.reset_peak_memory_stats()
    hv.launches = hv.batched_launches = hv.unaligned_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tiled_deconvolve(volume, psf, tile=TILE, overlap=OVERLAP, config=cfg, method="rl", rl_iterations=10,
                           max_batch=MAX_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    single, batched, unaligned = hv.launches, hv.batched_launches, hv.unaligned_launches
    if out.shape != VOLUME or not np.isfinite(out).all() or out.min() < 0:
        raise AssertionError(f"tiled RL: shape {out.shape}, finite {np.isfinite(out).all()}, min {out.min()}")
    if (single, batched, unaligned) != (0, 10 * n_batches, 0):
        raise AssertionError(f"tiled RL: batched TV launches {batched} (expected {10 * n_batches}), single-volume "
                             f"{single}, unaligned {unaligned}")
    log(14, f"[{card}] tiled_deconvolve method='rl' {VOLUME}, RL-TV (mu 0.01, epsilon 1), 10 iterations, tile {TILE}, "
            f"overlap {OVERLAP}, max_batch {MAX_BATCH}: {n_batches} batches, wall {wall:.3f} s (1 run), "
            f"{float(np.prod(VOLUME)) * 10 / wall / 1e6:.1f} Mvox*iter/s of output; batched TV launches {batched} "
            f"(10 x {n_batches}), single-volume {single}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del out

    _, vol, lane_psf = bench_scene(LANE_SHAPE, torch.device("cuda"), torch.float32, seed=5)
    got = tiled_deconvolve(vol.cpu().numpy(), lane_psf, tile=LANE_SHAPE, overlap=4, config=cfg, method="rl",
                           rl_iterations=10)
    lane = richardson_lucy(vol[None], lane_psf, iterations=10, mu=0.01, epsilon=1.0)[0]
    want = richardson_lucy(vol, lane_psf, iterations=10, mu=0.01, epsilon=1.0)
    bitwise = np.array_equal(got, lane.cpu().numpy())
    err = _rel_l2(torch.as_tensor(got), want)
    if not bitwise or err > 1e-4:
        raise AssertionError(f"single RL tile: bitwise the batched RL {bitwise}, against richardson_lucy {err:.3g}")
    log(14, f"one RL tile covering {LANE_SHAPE}: bitwise the batched RL of the volume, {err:.3g} relative L2 from "
            "richardson_lucy of it (< 1e-4)")
    return batched


@contextlib.contextmanager
def _counted_solves(module):
    """The objective calls of each VMLMB solve that ``module`` makes (for
    ``jobs.autotune``: its probes, then the final solve; for ``jobs.batch``:
    each lockstep batch), counted by wrapping its ``minimize_vmlmb`` and
    ``minimize_vmlmb_batched`` names for the run. Yields a list that gets, a
    solve, (calls, VMLMB's evaluations): one count for one volume, one a lane
    for a lockstep batch, whose calls are its steps."""
    names = [n for n in ("minimize_vmlmb", "minimize_vmlmb_batched") if hasattr(module, n)]
    wrapped = [getattr(module, n) for n in names]
    solves = []

    def counting(minimize):
        def run(fun, *args, **kw):
            calls = [0]

            def counted(*a):
                calls[0] += 1
                return fun(*a)

            res = minimize(counted, *args, **kw)
            solves.append((calls[0], [r.evaluations for r in res] if isinstance(res, list) else res.evaluations))
            return res

        return run

    for n, fn in zip(names, wrapped):
        setattr(module, n, counting(fn))
    try:
        yield solves
    finally:
        for n, fn in zip(names, wrapped):
            setattr(module, n, fn)


def phase15_priors_auto_mu(card: str) -> tuple[int, int]:
    """``deconvolve`` with the sparsity and Hessian priors on a padded grid,
    ``deconvolve_auto_mu`` at SHAPE and ``batched_deconvolve_auto_mu`` of 4
    scenes at LANE_SHAPE, each discrepancy beside its target. Each run's TV
    launches equal its objective evaluations: the solve's, the probes' and
    the final solve's, or the lockstep steps of the batch's. Returns the TV
    kernel's single and batched launches."""
    from microtipi_tpu_torch.jobs import autotune
    from microtipi_tpu_torch.jobs.autotune import _build_data_cost, deconvolve_auto_mu, estimate_noise_sigma
    from microtipi_tpu_torch.jobs.batch import batched_deconvolve_auto_mu
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, deconvolve
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

    dev, nvox = torch.device("cuda"), float(np.prod(SHAPE))
    _, data, psf = bench_scene(SHAPE, dev, torch.float32)
    sigma = float(estimate_noise_sigma(data))
    target = nvox * sigma ** 2
    var_shape = PAD_SHAPE
    cfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, sparsity=0.01, hessian=0.01, var_shape=var_shape, max_iter=20,
                              grtol=0.0, gatol=0.0)
    torch.cuda.reset_peak_memory_stats()
    hv.launches = hv.batched_launches = hv.unaligned_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = deconvolve(data, psf, config=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check_object("deconvolve with priors on a padded grid", res.x)
    with torch.no_grad():
        disc = 2.0 * float(_build_data_cost(psf, data, None, cfg)[0].cost(res.x))
    if (tuple(res.x.shape) != var_shape or hv.launches != res.evaluations or hv.batched_launches
            or hv.unaligned_launches):
        raise AssertionError(f"deconvolve with priors: x {tuple(res.x.shape)}, TV launches {hv.launches} for "
                             f"{res.evaluations} evaluations, batched {hv.batched_launches}")
    single = hv.launches
    log(15, f"[{card}] deconvolve {SHAPE} with sparsity 0.01, hessian 0.01 on var_shape {var_shape}, 20 iterations: "
            f"{res.iterations} iterations, {res.evaluations} evaluations, f {float(res.f):.6g}, wall {wall:.4f} s "
            f"(1 run, cold), discrepancy {disc:.6g} against the target N sigma^2 = {target:.6g} (sigma {sigma:.6g}), "
            f"TV kernel launches {hv.launches}, peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del res

    # tau 4: at tau 1 every probe of 20 iterations ends over the target on this sparse scene (2.97
    # N sigma^2 at the bracket's floor on an H100), and mu falls to the floor.
    acfg, tau, steps = DeconvolutionConfig(epsilon=1.0, max_iter=20, grtol=0.0, gatol=0.0), 4.0, 8
    hv.launches = hv.batched_launches = hv.unaligned_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _counted_solves(autotune) as solves:
        auto = deconvolve_auto_mu(data, psf, config=acfg, steps=steps, tau=tau)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check_object("deconvolve_auto_mu", auto.result.x)
    calls = [c for c, _ in solves]
    if (len(solves) != steps + 1 or hv.launches != sum(calls) or calls != [e for _, e in solves]
            or hv.batched_launches or hv.unaligned_launches or not np.isfinite(auto.discrepancy)):
        raise AssertionError(f"deconvolve_auto_mu: TV launches {hv.launches} for the solves' evaluations {solves} "
                             f"(objective calls, VMLMB's count), batched {hv.batched_launches}, unaligned "
                             f"{hv.unaligned_launches}, discrepancy {auto.discrepancy}")
    single += hv.launches
    log(15, f"[{card}] deconvolve_auto_mu {SHAPE}, tau {tau}, {steps} probes of 20 iterations: mu {float(auto.mu):.6g}, "
            f"mu_history "
            f"{[float(f'{m:.4g}') for m in auto.mu_history]}, discrepancy {float(auto.discrepancy):.6g} against the "
            f"target {float(auto.target):.6g} (sigma {float(auto.sigma):.6g}), wall {wall:.3f} s (1 run), TV kernel "
            f"launches {hv.launches} = the evaluations of the probes and the final solve {calls}")

    scenes = [bench_scene(LANE_SHAPE, dev, torch.float32, seed=s) for s in range(4)]
    batch, lane_psf = torch.stack([d for _, d, _ in scenes]), scenes[0][2]
    hv.launches = hv.batched_launches = hv.unaligned_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _counted_solves(autotune) as solves:
        bauto = batched_deconvolve_auto_mu(batch, lane_psf, config=acfg, steps=steps, tau=tau)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check_object("batched_deconvolve_auto_mu", bauto.result.x)
    calls = [c for c, _ in solves]
    if (len(solves) != steps + 1 or hv.batched_launches != sum(calls) or calls != [max(e) for _, e in solves]
            or hv.launches or hv.unaligned_launches or not np.isfinite(bauto.discrepancy).all()):
        raise AssertionError(f"batched_deconvolve_auto_mu: batched TV launches {hv.batched_launches} for the "
                             f"lockstep solves' steps {solves} (objective calls, each lane's evaluations), "
                             f"single-volume {hv.launches}, unaligned {hv.unaligned_launches}, discrepancy "
                             f"{bauto.discrepancy}")
    log(15, f"[{card}] batched_deconvolve_auto_mu 4 x {LANE_SHAPE}, tau {tau}, {steps} probes of 20 iterations a "
            f"lane: mu {[float(f'{m:.4g}') for m in bauto.mu]}, discrepancy / target "
            f"{[round(float(d / t), 4) for d, t in zip(bauto.discrepancy, bauto.target)]}, sigma "
            f"{[float(f'{s:.4g}') for s in bauto.sigma]}, wall {wall:.3f} s (1 run), batched TV launches "
            f"{hv.batched_launches} = the lockstep steps of the probes and the final solve {calls}, single-volume "
            f"{hv.launches}")
    return single, hv.batched_launches


def phase16_uncertainty(card: str) -> None:
    """``object_uncertainty`` at SHAPE on a 30-iteration ``deconvolve``
    solution, 8 probes, 25 preconditioned CG iterations at most: the CG
    residual, the mean free-set sigma, sigma exactly 0 on the active set, no
    TV kernel launch (the Hessian comes from the plain objective), peak
    device memory."""
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, deconvolve
    from microtipi_tpu_torch.jobs.uncertainty import object_uncertainty
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

    _, data, psf = bench_scene(SHAPE, torch.device("cuda"), torch.float32)
    cfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=30, grtol=0.0, gatol=0.0)
    x_hat = deconvolve(data, psf, config=cfg).x
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hv.launches = hv.batched_launches = 0
    t0 = time.perf_counter()
    est = object_uncertainty(data, psf, x_hat, config=cfg, n_probes=8, cg_maxiter=25)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    free = est.free > 0
    pinned_max = float(est.sigma[~free].abs().max()) if bool((~free).any()) else 0.0
    if (hv.launches or hv.batched_launches or pinned_max != 0.0 or not bool(torch.isfinite(est.sigma).all())
            or not np.isfinite(float(est.residual))):
        raise AssertionError(f"object_uncertainty: TV launches {hv.launches}/{hv.batched_launches}, sigma on the "
                             f"active set up to {pinned_max}, residual {float(est.residual)}")
    log(16, f"[{card}] object_uncertainty {SHAPE} at a 30-iteration deconvolve solution, 8 probes, preconditioned CG "
            f"of at most 25 iterations: residual {float(est.residual):.4g}, mean sigma on the free set "
            f"{float(est.sigma[free].mean()):.6g} ({float(free.double().mean()):.4f} of the voxels free), sigma "
            f"exactly "
            f"0 on the active set, wall {wall:.3f} s (1 run, cold), no TV kernel launch, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")


# Phases 17-19: every PSF family, the depth-varying object step.
OPTICS = dict(na=1.4, wavelength=561e-9, ni=1.518, dxy=80e-9, dz=200e-9, n_phase=6)
# The light sheet's detection arm: a water-dipping NA 0.8 objective.
SHEET_OPTICS = dict(OPTICS, na=0.8, ni=1.33, dxy=150e-9, dz=400e-9, wavelength=520e-9)
BENCH_PHASE = [0.15, -0.1, 0.08, 0.0, 0.05, 0.0]  # phase 3's blind scene's aberration
# Card float32 against CPU float64 of each family's PSF at PARITY_SHAPE:
# relative L2. The pupil phases reach ~30 rad, so float32 rounds them by
# ~2e-6 rad; the FFTs and the composite products add ~1e-6.
FAMILY_F32_REL = 1e-4
DEPTH0, DEPTH_K = 10e-6, 4  # phase 18: Gibson-Lanni depth of plane 0, anchors


def family_configs(shape, dtype) -> dict:
    """Every PSF family of the port at ``shape``, with three modulus modes:
    name -> config."""
    from microtipi_tpu_torch import models as m

    # three modulus modes: one alone is normalised away and carries no gradient
    base = dict(OPTICS, shape=shape, dtype=dtype, n_modulus=3)
    sheet = dict(SHEET_OPTICS, shape=shape, dtype=dtype, n_modulus=3)
    return {
        "widefield": m.WideFieldConfig(**base),
        "gibson_lanni": m.GibsonLanniConfig(ns=1.38, depth=DEPTH0, **base),
        "confocal": m.ConfocalConfig(wavelength_exc=488e-9, **base),
        "confocal_pinhole": m.ConfocalConfig(wavelength_exc=488e-9, pinhole=120e-9, **base),
        "two_photon": m.TwoPhotonConfig(**dict(base, wavelength=920e-9)),
        "vectorial": m.VectorialConfig(**base),
        "lightsheet": m.LightSheetConfig(sheet_na=0.1, wavelength_exc=488e-9, **sheet),
        "bessel": m.StructuredSheetConfig(wavelength_exc=488e-9, **sheet),
        "lattice": m.StructuredSheetConfig(sheet_mode="lattice", lattice_ky=(0.0, 0.5), wavelength_exc=488e-9,
                                           **sheet),
        "ism": m.ISMConfig(wavelength_exc=488e-9, pinhole=40e-9, element_pitch=60e-9, rings=2, **base),
        "fourpi_a": m.FourPiConfig(fourpi_type="A", wavelength_exc=488e-9, pinhole=120e-9, cavity_phase=0.3, **base),
        "fourpi_c": m.FourPiConfig(fourpi_type="C", wavelength_exc=488e-9, cavity_phase=0.3, **base),
        "sted_donut": m.STEDConfig(wavelength_exc=488e-9, wavelength_dep=660e-9, pinhole=120e-9, saturation=10.0,
                                   **base),
        "sted_bottle": m.STEDConfig(depletion="bottle", wavelength_exc=488e-9, wavelength_dep=660e-9,
                                    pinhole=120e-9, saturation=5.0, **base),
    }


def _family_params(model):
    """The model's initial params with phase 3's aberration."""
    p = model.init_params()
    return p._replace(phase=torch.as_tensor(BENCH_PHASE, dtype=model.dtype, device=model.device))


def _psf_sum_check(name: str, model, params, psf: torch.Tensor) -> float:
    """The PSF's sum against what it must be: 1 for the unit-sum families;
    for the wide-field and Gibson-Lanni ones, by Parseval, sum(rho^2) (each
    plane's |FFT2(A)|^2 sums to Nx*Ny*sum|A|^2, |A| = rho, over Nx*Ny*Nz)."""
    total = float(psf.double().sum())
    want = float((model.compute_pupil(params)[0].double() ** 2).sum()) if name in ("widefield",
                                                                                  "gibson_lanni") else 1.0
    return abs(total - want) / want


def phase17_families(card: str) -> int:
    """Every family's ``compute_psf`` at SHAPE in float32 on the card: its
    sum, finite, its wall (median of 3, no autograd); the gradient of
    sum(psf * w) with respect to each of its families (finite and non-zero),
    the forward-and-backward wall (after a warm-up) and peak memory; the card
    float32 against the CPU float64 at PARITY_SHAPE. Then ``blind_deconvolve`` of phase 3's
    scene blurred through a confocal PSF, by a ``ConfocalModel``. Returns the
    TV kernel's launches."""
    from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig, blind_deconvolve
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
    from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig
    from microtipi_tpu_torch.models import model_for
    from microtipi_tpu_torch.models.microscope import DEFOCUS, PHASE
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

    dev = torch.device("cuda")
    cards, cpus = family_configs(SHAPE, torch.float32), family_configs(PARITY_SHAPE, torch.float64)
    small32 = family_configs(PARITY_SHAPE, torch.float32)
    w = torch.as_tensor(np.random.default_rng(17).random(SHAPE, dtype=np.float32), device=dev)
    for name, cfg in cards.items():
        model = model_for(cfg, dev)
        params = _family_params(model)
        with torch.no_grad():
            psf = model.compute_psf(params)
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                psf = model.compute_psf(params)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
        sum_err = _psf_sum_check(name, model, params, psf)
        if tuple(psf.shape) != SHAPE or not bool(torch.isfinite(psf).all()) or sum_err > 1e-4:
            raise AssertionError(f"{name}: PSF shape {tuple(psf.shape)}, finite {bool(torch.isfinite(psf).all())}, "
                                 f"sum off by {sum_err:.3g}")
        del psf
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):  # the first backward warms autograd's complex kernels; the second is timed
            leaves = params._replace(**{k: v.clone().requires_grad_() for k, v in params._asdict().items()})
            t0 = time.perf_counter()
            torch.sum(model.compute_psf(leaves) * w).backward()
            torch.cuda.synchronize()
            grad_wall = time.perf_counter() - t0
        grads = {k: getattr(leaves, k).grad for k in leaves._fields}
        bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all()) or float(g.abs().max()) == 0.0]
        if bad:
            raise AssertionError(f"{name}: gradient not finite or zero for {bad}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        with torch.no_grad():
            pair = [model_for(c[name], d) for c, d in ((small32, dev), (cpus, "cpu"))]
            rel = _rel_l2(*(m.compute_psf(_family_params(m)) for m in pair))
        if rel > FAMILY_F32_REL:
            raise AssertionError(f"{name}: card float32 vs CPU float64 at {PARITY_SHAPE}: {rel:.3g} relative L2")
        log(17, f"[{card}] {name} {SHAPE} float32: compute_psf wall {float(np.median(walls)) * 1e3:.2f} ms (median "
                f"of 3), sum off by {sum_err:.2g}; gradient of sum(psf * w) for {list(grads)} finite and non-zero, "
                f"forward+backward {grad_wall * 1e3:.1f} ms (1 run after a warm-up), peak device memory {peak:.3f} GiB; card float32 "
                f"vs CPU float64 at {PARITY_SHAPE}: {rel:.3g} relative L2 (< {FAMILY_F32_REL:g})")
        del model, leaves, grads

    model = model_for(cards["confocal_pinhole"], dev)
    _, data, _ = bench_scene(SHAPE, dev, torch.float32, phase=BENCH_PHASE, model=model)
    bcfg = BlindDeconvConfig(
        loops=5, families=(DEFOCUS, PHASE), psf_max_iter=(5, 5), joint_fit=True,
        deconv=DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=20, grtol=0.0, gatol=0.0),
        fit=PsfFitConfig(grtol=0.0),
    )
    hv.launches = hv.batched_launches = hv.unaligned_launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bres = blind_deconvolve(data, model, config=bcfg)
    torch.cuda.synchronize()
    bwall = time.perf_counter() - t0
    _check_object("confocal blind_deconvolve", bres.obj)
    df = bres.deconv_f
    if not (np.isfinite(df).all() and np.all(np.diff(df) < 0)):
        raise AssertionError(f"confocal blind deconv_f does not decrease across rounds: {df}")
    if not (np.isnan(bres.fit_f[-1]).all() and np.isfinite(bres.fit_f[:-1]).all()):
        raise AssertionError(f"confocal blind fit_f: the last row must be NaN, the others finite: {bres.fit_f}")
    if hv.launches == 0 or hv.batched_launches or hv.unaligned_launches:
        raise AssertionError(f"confocal blind: TV launches {hv.launches}, batched {hv.batched_launches}, unaligned "
                             f"{hv.unaligned_launches}")
    phase_err = float(torch.linalg.norm(bres.params.phase.cpu() - torch.tensor(BENCH_PHASE)))
    log(17, f"[{card}] blind_deconvolve {SHAPE} through a ConfocalModel (488/561 nm, pinhole 120 nm), 5 rounds, joint "
            f"defocus+phase fit: object iterations {bres.deconv_iters.tolist()}, deconv_f {df.tolist()}, phase "
            f"{[round(float(v), 4) for v in bres.params.phase]} (true {BENCH_PHASE}, L2 off {phase_err:.4f}), wall "
            f"{bwall:.3f} s (1 run), TV kernel launches {hv.launches}, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return hv.launches


def depthvar_model(shape, dtype, device):
    """The Gibson-Lanni model of BASELINE.json config 2: NA 1.4, 561 nm,
    ni 1.518, ns 1.38, 80/200 nm sampling, plane 0 at 10 um depth."""
    from microtipi_tpu_torch.models import GibsonLanniConfig, GibsonLanniModel

    return GibsonLanniModel(GibsonLanniConfig(shape=shape, ns=1.38, depth=DEPTH0, dtype=dtype, **OPTICS), device)


def depthvar_scene(psfs, anchors, shape, device, dtype, seed=0):
    """Bench beads blurred by the depth-varying operator of ``psfs`` at
    ``anchors``, plus 1% Gaussian noise; and the object."""
    from microtipi_tpu_torch.ops.depthconv import DepthVaryingConvCost

    obj, noise = bead_objects(shape, device, dtype, seed)
    with torch.no_grad():
        d = DepthVaryingConvCost.build(psfs, obj, anchors=anchors).model(obj)
        return d + 0.01 * d.max() * noise, obj


def phase18_depthvar(card: str) -> tuple[int, int]:
    """The depth-varying object step at BASELINE.json config 2's size,
    LANE_SHAPE: DEPTH_K Gibson-Lanni anchors in one batched synthesis, the
    scene weighted by ``InverseVarianceWeights.from_data``;
    ``deconvolve_depthvar`` (20 VMLMB iterations, its TV launches equal to
    its evaluations), ``richardson_lucy_depthvar`` with RL-TV (50, one TV
    launch an iteration), ``batched_deconvolve_depthvar`` of 4 scenes (its
    batched launches equal to its lockstep steps), each lane against
    ``deconvolve_depthvar`` of its scene with phase 4's float32 bounds on f,
    and ``fit_psf`` of the depth (ns held) on the beads blurred by the PSF at
    DEPTH0, from 7 um. Returns the single and batched TV launches."""
    from microtipi_tpu_torch.jobs.batch import batched_deconvolve_depthvar
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
    from microtipi_tpu_torch.jobs.depthvar import deconvolve_depthvar, depth_anchor_psfs, richardson_lucy_depthvar
    from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig, fit_psf
    from microtipi_tpu_torch.models.microscope import DEPTH
    from microtipi_tpu_torch.ops.convolution import convolve, convolve_spectrum
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv
    from microtipi_tpu_torch.weights.updaters import InverseVarianceWeights

    dev, nvox = torch.device("cuda"), float(np.prod(LANE_SHAPE))
    model = depthvar_model(LANE_SHAPE, torch.float32, dev)
    anchors = np.linspace(0.0, LANE_SHAPE[0] - 1.0, DEPTH_K)
    with torch.no_grad():
        depth_anchor_psfs(model, model.init_params(), anchors)  # warm-up (the batched FFT plan)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        psfs = depth_anchor_psfs(model, model.init_params(), anchors)
        torch.cuda.synchronize()
    synth = time.perf_counter() - t0
    scenes = [depthvar_scene(psfs, anchors, LANE_SHAPE, dev, torch.float32, seed=s) for s in range(4)]
    wmodel = InverseVarianceWeights()
    weights = [wmodel.from_data(d) for d, _ in scenes]
    data, obj = scenes[0]
    cfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=20, grtol=0.0, gatol=0.0)
    deconvolve_depthvar(data, psfs, anchors, weights=weights[0],
                        config=DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=2))  # warm-up (FFT plans)
    torch.cuda.reset_peak_memory_stats()
    hv.launches = hv.batched_launches = hv.unaligned_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = deconvolve_depthvar(data, psfs, anchors, weights=weights[0], config=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check_object("deconvolve_depthvar", res.x)
    if (hv.launches, hv.batched_launches, hv.unaligned_launches) != (res.evaluations, 0, 0) or not np.isfinite(res.f):
        raise AssertionError(f"deconvolve_depthvar: f {res.f}, TV launches {hv.launches} for {res.evaluations} "
                             f"evaluations, batched {hv.batched_launches}, unaligned {hv.unaligned_launches}")
    single = hv.launches
    log(18, f"[{card}] Gibson-Lanni anchors: {DEPTH_K} PSFs of {LANE_SHAPE} at depths "
            f"{[round(DEPTH0 * 1e6 + float(a) * 0.2, 2) for a in anchors]} um in one batched synthesis, {synth * 1e3:.2f} ms")
    log(18, f"[{card}] deconvolve_depthvar {LANE_SHAPE}, K {DEPTH_K}, inverse-variance weights, 20 iterations: "
            f"{res.iterations} iterations, {res.evaluations} evaluations, status {res.status}, f {float(res.f):.6g}, "
            f"wall {wall:.4f} s (1 run after a warm-up), {nvox * res.iterations / wall / 1e6:.1f} Mvox*iter/s, TV "
            f"kernel launches {hv.launches} = evaluations, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    hv.launches = hv.batched_launches = hv.unaligned_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, k = richardson_lucy_depthvar(data, psfs, anchors, iterations=50, mu=0.01, epsilon=1.0, return_iterations=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check_object("richardson_lucy_depthvar", x)
    if (hv.launches, hv.batched_launches, hv.unaligned_launches) != (50, 0, 0) or k != 50:
        raise AssertionError(f"richardson_lucy_depthvar RL-TV: {k} iterations, TV launches {hv.launches} (expected "
                             f"50), batched {hv.batched_launches}, unaligned {hv.unaligned_launches}")
    single += hv.launches
    log(18, f"[{card}] richardson_lucy_depthvar {LANE_SHAPE}, RL-TV (mu 0.01, epsilon 1), 50 iterations: wall "
            f"{wall:.4f} s (1 run), {nvox * 50 / wall / 1e6:.1f} Mvox*iter/s, TV kernel launches {hv.launches}, "
            f"relative L2 to the true object {_rel_l2(x, obj):.4f} (the data's {_rel_l2(data, obj):.4f})")

    batch, wbatch = torch.stack([d for d, _ in scenes]), torch.stack(weights)
    batched_deconvolve_depthvar(batch, psfs, anchors, weights=wbatch,
                                config=DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=2))  # warm-up
    torch.cuda.reset_peak_memory_stats()
    hv.launches = hv.batched_launches = hv.unaligned_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bres = batched_deconvolve_depthvar(batch, psfs, anchors, weights=wbatch, config=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = int(np.max(bres.evaluations))
    _check_object("batched_deconvolve_depthvar", bres.x)
    if (hv.launches, hv.batched_launches, hv.unaligned_launches) != (0, steps, 0):
        raise AssertionError(f"batched_deconvolve_depthvar: batched TV launches {hv.batched_launches} for {steps} "
                             f"lockstep steps, single {hv.launches}, unaligned {hv.unaligned_launches}")
    batched = hv.batched_launches
    log(18, f"[{card}] batched_deconvolve_depthvar 4 x {LANE_SHAPE}, K {DEPTH_K}, weighted, 20 iterations: iterations "
            f"{bres.iterations.tolist()}, evaluations {bres.evaluations.tolist()}, wall {wall:.4f} s (1 run after a "
            f"warm-up), {nvox * bres.iterations.sum() / wall / 1e6:.1f} Mvox*iter/s, batched TV launches {batched} = "
            f"lockstep steps, peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    worst4 = worstf = worstx = 0.0
    for b in range(4):
        r = res if b == 0 else deconvolve_depthvar(batch[b], psfs, anchors, weights=wbatch[b], config=cfg)
        worst4 = max(worst4, np.max(np.abs(bres.f_history[b, :4] - r.f_history[:4]) / np.abs(r.f_history[:4])))
        worstf = max(worstf, abs(float(bres.f[b]) - float(r.f)) / abs(float(r.f)))
        worstx = max(worstx, _rel_l2(bres.x[b], r.x))
    if worst4 > 1e-4 or worstf > 1e-3:
        raise AssertionError(f"batched depthvar lanes != deconvolve_depthvar: f_history[:4] {worst4:.3g}, final f "
                             f"{worstf:.3g}")
    log(18, f"each lane against deconvolve_depthvar of its scene: f_history[:4] {worst4:.3g} rel (< 1e-4), final f "
            f"{worstf:.3g} rel (< 1e-3); x {worstx:.3g} relative L2")
    del batch, wbatch, bres

    truth = model.init_params()
    with torch.no_grad():
        fit_data = convolve(obj, convolve_spectrum(model.compute_psf(truth)), LANE_SHAPE)
        fit_data = fit_data + 0.01 * fit_data.max() * bead_objects(LANE_SHAPE, dev, torch.float32, seed=0)[1]
    start = truth._replace(depth=torch.tensor([float(truth.depth[0]), 7e-6], device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit = fit_psf(model, start, DEPTH, fit_data, obj, config=PsfFitConfig(max_iter=15, grtol=0.0), freeze_head=1,
                  precondition=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = float(fit.params.depth[1])
    if not abs(got - DEPTH0) < 0.1 * abs(7e-6 - DEPTH0):
        raise AssertionError(f"fit_psf(DEPTH): depth {got:.6g} m from 7e-6, true {DEPTH0}")
    log(18, f"[{card}] fit_psf DEPTH (ns held, preconditioned) on the beads of {LANE_SHAPE} blurred at {DEPTH0 * 1e6} "
            f"um + 1% noise, given the object: depth {got * 1e6:.4f} um from 7 um (true {DEPTH0 * 1e6} um), "
            f"{fit.iterations} iterations, {fit.evaluations} evaluations, wall {wall:.3f} s (1 run)")
    return single, batched


def phase19_tiled_depthvar(card: str, volume: np.ndarray) -> int:
    """``tiled_deconvolve(depthvar_anchors=...)`` on phase 8's design volume
    and geometry, 10 VMLMB iterations, the PSF field of
    ``field_depthvar_psf``: a Gibson-Lanni model at TILE, two lateral
    calibrations (the second 20% deeper), DEPTH_K anchors per tile at its
    absolute depths, so the anchors differ between the rows of tiles in z.
    Timed after a warm-up on the first of WARM_VOLUMES (one full batch). Its
    batched TV launches equal the lockstep steps of its batches. Returns
    them."""
    from microtipi_tpu_torch.jobs import batch as jbatch
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
    from microtipi_tpu_torch.jobs.tiled import field_depthvar_psf, tile_plan, tiled_deconvolve
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

    dev = torch.device("cuda")
    plan = tile_plan(VOLUME, TILE, (OVERLAP,) * 3)
    n_tiles = int(np.prod([len(starts) for starts, _ in plan]))
    model = depthvar_model(TILE, torch.float32, dev)
    p = model.init_params()
    calib = [((0.0, 0.0), p), ((0.0, float(VOLUME[2])), p._replace(depth=p.depth * torch.tensor([1.0, 1.2],
                                                                                                device=dev)))]
    zs = np.linspace(0.0, TILE[0] - 1.0, DEPTH_K)
    fn = field_depthvar_psf(model, calib, zs)
    rows = [s + TILE[0] / 2.0 for s in plan[0][0]]
    first, last = fn((rows[0], 512.0, 512.0)), fn((rows[-1], 512.0, 512.0))
    row_diff = _rel_l2(last, first)
    del first, last
    cfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=10, grtol=0.0, gatol=0.0)
    corner = volume[tuple(slice(n) for n in WARM_VOLUMES[0])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tiled_deconvolve(corner, fn, tile=TILE, overlap=OVERLAP, config=cfg, max_batch=MAX_BATCH, depthvar_anchors=zs)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    hv.launches = hv.batched_launches = hv.unaligned_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _counted_solves(jbatch) as solves:
        out = tiled_deconvolve(volume, fn, tile=TILE, overlap=OVERLAP, config=cfg, max_batch=MAX_BATCH,
                               depthvar_anchors=zs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    calls = [c for c, _ in solves]
    if out.shape != VOLUME or not np.isfinite(out).all() or out.min() < 0:
        raise AssertionError(f"tiled depthvar: shape {out.shape}, finite {np.isfinite(out).all()}, min {out.min()}")
    if (hv.launches, hv.unaligned_launches) != (0, 0) or hv.batched_launches != sum(calls) \
            or calls != [max(e) for _, e in solves] or len(solves) != -(-n_tiles // MAX_BATCH) or row_diff < 1e-3:
        raise AssertionError(f"tiled depthvar: batched TV launches {hv.batched_launches} for the batches' lockstep "
                             f"steps {solves}, single {hv.launches}, unaligned {hv.unaligned_launches}; anchors of "
                             f"the first and last rows of tiles differ by {row_diff:.3g}")
    log(19, f"[{card}] tiled_deconvolve depthvar_anchors {VOLUME}, tile {TILE}, overlap {OVERLAP}, max_batch "
            f"{MAX_BATCH}, K {DEPTH_K} Gibson-Lanni anchors a tile from field_depthvar_psf (two lateral calibrations, "
            f"rows of tiles at z {rows}; the first and last rows' anchors differ by {row_diff:.3g} relative L2), 10 "
            f"iterations: {n_tiles} tiles in {len(solves)} batches, wall {wall:.3f} s (1 run after a warm-up of "
            f"{WARM_VOLUMES[0]} in 4 tiles, {warm:.3f} s), {float(np.prod(VOLUME)) * 10 / wall / 1e6:.1f} "
            f"Mvox*iter/s of output; batched TV launches {hv.batched_launches} = the batches' lockstep steps "
            f"(single {hv.launches}, unaligned {hv.unaligned_launches}); peak device memory {peak:.3f} GiB")
    return hv.batched_launches


def phase4_depthvar() -> None:
    """Card float32 (kernel) against CPU float64 (plain TV) at PARITY_SHAPE
    for the depth-varying solvers, a Gibson-Lanni model with 3 anchors. The
    anchors' float32 synthesis is held against float64 first (FAMILY_F32_REL:
    the depth term's phase reaches ~170 rad at 10 um, rounded by ~1e-5 rad);
    both solves then start from the card's anchors and data, so that they
    differ by the solver's arithmetic alone. ``deconvolve_depthvar`` (10
    iterations): f at the start and after the first iteration to 1e-4
    relative and the final f to 1e-3, phase 4's bounds; from the second
    iteration on the float32 line search takes other steps than the float64
    one on this steep start (f falls 8% in one iteration) and the two part by
    ~2e-4 before they meet again (2e-4 at iteration 2 in a float32 CPU run),
    so f_history[:4] is shown, not held. ``richardson_lucy_depthvar`` with
    RL-TV (20 iterations) to 1e-4 relative L2, as RL-TV in phase 4."""
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
    from microtipi_tpu_torch.jobs.depthvar import deconvolve_depthvar, depth_anchor_psfs, richardson_lucy_depthvar
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

    cfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=10, grtol=0.0, gatol=0.0)
    anchors = np.linspace(0.0, PARITY_SHAPE[0] - 1.0, 3)
    synth = {}
    for dev, dtype in ((torch.device("cuda"), torch.float32), (torch.device("cpu"), torch.float64)):
        model = depthvar_model(PARITY_SHAPE, dtype, dev)
        with torch.no_grad():
            synth[dtype] = depth_anchor_psfs(model, model.init_params(), anchors)
    psf_err = _rel_l2(synth[torch.float32], synth[torch.float64])
    psfs = synth[torch.float32]
    data, _ = depthvar_scene(psfs, anchors, PARITY_SHAPE, psfs.device, torch.float32)
    out = {}
    for dev, dtype in ((torch.device("cuda"), torch.float32), (torch.device("cpu"), torch.float64)):
        hv.launches = hv.batched_launches = 0
        res = deconvolve_depthvar(data.to(dev, dtype), psfs.to(dev, dtype), anchors, config=cfg)
        n_vmlmb = hv.launches
        rl = richardson_lucy_depthvar(data.to(dev, dtype), psfs.to(dev, dtype), anchors, iterations=20, mu=0.01,
                                      epsilon=1.0)
        out[dtype] = (res, rl, n_vmlmb, hv.launches - n_vmlmb, hv.batched_launches)
    (r32, rl32, v32, l32, b32), (r64, rl64, v64, l64, b64) = out[torch.float32], out[torch.float64]
    rel = np.abs(r32.f_history[:4] - r64.f_history[:4]) / np.abs(r64.f_history[:4])
    f2, f4 = np.max(rel[:2]), np.max(rel)
    ff = abs(float(r32.f) - float(r64.f)) / abs(float(r64.f))
    rl_err = _rel_l2(rl32, rl64)
    if (psf_err > FAMILY_F32_REL or f2 > 1e-4 or ff > 1e-3 or rl_err > 1e-4
            or (v32, l32, b32) != (r32.evaluations, 20, 0) or (v64, l64, b64) != (0, 0, 0)):
        raise AssertionError(f"depthvar card/CPU parity: anchors {psf_err:.3g}, f_history[:2] {f2:.3g}, final f "
                             f"{ff:.3g}, RL-TV {rl_err:.3g}; TV launches cuda {v32}/{l32}/{b32} cpu {v64}/{l64}/{b64}")
    log(4, f"depth-varying solvers at {PARITY_SHAPE}, 3 Gibson-Lanni anchors (card float32 synthesis {psf_err:.3g} "
           f"relative L2 from CPU float64, < {FAMILY_F32_REL:g}), both solves from the card's anchors and data, card "
           f"float32 (kernel) vs CPU float64 (plain): deconvolve_depthvar f_history[:2] {f2:.3g} rel (< 1e-4), "
           f"f_history[:4] {f4:.3g}, final f {ff:.3g} rel (< 1e-3), TV launches {v32} = evaluations; "
           f"richardson_lucy_depthvar RL-TV 20 iterations "
           f"{rl_err:.3g} relative L2 (< 1e-4), TV launches {l32}")


# Phase 20: a bead slide of 8 beads in two rows of four, at least 96 voxels
# apart laterally; the left half's beads are blurred by BENCH_PHASE (phase
# 3's aberration), the right half's by OTHER_PHASE. Each bead's peak holds
# SLIDE_PEAK photons minus 5% a bead (so that the brightness order is known)
# over a background of SLIDE_BG; Poisson noise (1% at a peak).
SLIDE_SHAPE, BEAD_PATCH = (64, 512, 512), (64, 64, 64)
SLIDE_BEADS = ((128, 96), (384, 96), (128, 192), (384, 192), (128, 320), (384, 320), (128, 416), (384, 416))
SLIDE_PEAK, SLIDE_BG, SLIDE_SPLIT = 1e4, 100.0, 256
FIT_WINDOW = (128, 128, 128)
# Phase 21: the depth ladder's rungs (planes of phase 18's geometry) and the
# wrong sample index the fit starts from (the basin of this 10 um ladder is
# narrow: from ns 1.375 or 1.39 a float32 CPU fit of the same ladder stops in
# a local minimum of the axial shifts).
LADDER_Z, LADDER_NS, LADDER_NS_START = (0.0, 16.0, 32.0, 48.0), 1.38, 1.385


def bead_photons(psf: torch.Tensor, peak: float, generator) -> torch.Tensor:
    """A bead stack from a corner-origin PSF: centred, scaled to ``peak``
    photons over SLIDE_BG, Poisson."""
    from microtipi_tpu_torch.utils.arrays import roll

    return torch.poisson(peak * roll(psf) / psf.max() + SLIDE_BG, generator=generator)


def bead_model(dev, dtype=torch.float32):
    """The bench's widefield optics (phase 3's model) on the bead patch."""
    from microtipi_tpu_torch.models.widefield import WideFieldConfig, WideFieldModel

    return WideFieldModel(WideFieldConfig(shape=BEAD_PATCH, dtype=dtype, **OPTICS), dev)


def _with_phase(model, phase):
    return model.init_params()._replace(phase=torch.as_tensor(phase, dtype=model.dtype, device=model.device))


def _phase_err(params, truth) -> float:
    return float(torch.linalg.norm(params.phase.double().cpu() - torch.tensor(truth, dtype=torch.float64)))


def _params_like(params, model):
    """``params`` in ``model``'s dtype and device."""
    return type(params)(*(t.to(model.device, model.dtype) for t in params))


def phase4_calibration() -> None:
    """Card float32 against CPU float64 at PARITY_SHAPE for the bead pieces:
    one bead of the bench optics with BENCH_PHASE (Poisson, SLIDE_PEAK
    photons), made once in float64. ``center_bead_stack`` to 1e-5 relative
    L2 (float32 FFTs, ~3e-6 in a float32 CPU run); ``bead_anchor_term`` at a
    fixed point: value to 1e-5 relative, gradient to 1e-3 relative L2 (sums
    over 65k voxels; ~2e-4 in a float32 CPU run); ``fit_psf_beads`` (PHASE,
    20 iterations) final f to 1e-4 (the float32 trajectory takes other
    steps; the phases are shown); ``bead_fit_uncertainty`` (DEFOCUS, PHASE,
    at the float64 fit's params): std to 1e-3 relative, the cov gap shown.
    ``calibrate_depth`` on three rungs (planes 0, 5 and 10) of a Gibson-Lanni
    ladder at PARITY_SHAPE from ns 1.385: f_history[:2] to 1e-4, final f to
    1e-3, as phase 4's solves."""
    from microtipi_tpu_torch.jobs.depthvar import calibrate_depth
    from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig, bead_anchor_term, bead_fit_uncertainty
    from microtipi_tpu_torch.jobs.psf_fit import center_bead_stack, fit_psf_beads, model_at
    from microtipi_tpu_torch.models.microscope import DEFOCUS, DEPTH, PHASE
    from microtipi_tpu_torch.optim.treeutil import value_and_grad

    cpu, card = torch.device("cpu"), torch.device("cuda")
    m64 = model_at(bead_model(cpu, torch.float64), PARITY_SHAPE)
    with torch.no_grad():
        bead = bead_photons(m64.compute_psf(_with_phase(m64, BENCH_PHASE)), SLIDE_PEAK,
                            torch.Generator().manual_seed(4))
    out = {}
    for dev, dtype in ((cpu, torch.float64), (card, torch.float32)):
        model = model_at(bead_model(dev, dtype), PARITY_SHAPE)
        b = bead.to(dev, dtype)
        p = _with_phase(model, [0.1, 0.0, 0.05, 0.0, 0.0, 0.0])
        term = bead_anchor_term(model, b / b.max())
        f, g = value_and_grad(lambda sub: term(p._replace(**sub)))({"defocus": p.defocus, "phase": p.phase})
        fit, amp = fit_psf_beads(model, b, (PHASE,), config=PsfFitConfig(max_iter=20, grtol=0.0))
        at = out[torch.float64][3].params if dtype == torch.float32 else fit.params
        unc = bead_fit_uncertainty(model, _params_like(at, model), (DEFOCUS, PHASE), b)
        out[dtype] = (center_bead_stack(b), f, g, fit, unc)
    (c64, f64, g64, fit64, u64), (c32, f32, g32, fit32, u32) = out[torch.float64], out[torch.float32]
    errs = {"center": _rel_l2(c32, c64), "term": abs(float(f32) - float(f64)) / abs(float(f64)),
            "gradient": max(_rel_l2(g32[k], g64[k]) for k in g64),
            "fit f": abs(float(fit32.f) - float(fit64.f)) / abs(float(fit64.f)),
            "std": max(_rel_l2(u32.std[k].reshape(-1), u64.std[k].reshape(-1)) for k in u64.std)}
    bounds = {"center": 1e-5, "term": 1e-5, "gradient": 1e-3, "fit f": 1e-4, "std": 1e-3}
    if any(errs[k] > bounds[k] for k in bounds):
        raise AssertionError(f"bead pieces card/CPU parity: {errs} (bounds {bounds})")
    log(4, f"bead pieces card float32 vs CPU float64 at {PARITY_SHAPE}: " + ", ".join(
        f"{k} {v:.3g} (< {bounds[k]:g})" for k, v in errs.items())
        + f"; fit_psf_beads phase {[round(float(v), 4) for v in fit32.params.phase]} / "
          f"{[round(float(v), 4) for v in fit64.params.phase]}, {fit32.iterations} / {fit64.iterations} iterations; "
          f"bead_fit_uncertainty cov {_rel_l2(u32.cov, u64.cov):.3g} relative L2")

    ladder_z = np.array([0.0, 5.0, 10.0])
    gl64 = depthvar_model(PARITY_SHAPE, torch.float64, cpu)
    truth = gl64.init_params()
    with torch.no_grad():
        psfs = gl64.compute_depth_psfs(truth, truth.depth[1] + torch.tensor(ladder_z * OPTICS["dz"]))
        gen = torch.Generator().manual_seed(5)
        beads = torch.stack([bead_photons(h, SLIDE_PEAK, gen) for h in psfs])
    res = {}
    for dev, dtype in ((cpu, torch.float64), (card, torch.float32)):
        gl = depthvar_model(PARITY_SHAPE, dtype, dev)
        p0 = gl.init_params()._replace(depth=torch.tensor([LADDER_NS_START / OPTICS["wavelength"], DEPTH0],
                                                          dtype=dtype, device=dev))
        res[dtype] = calibrate_depth(gl, beads.to(dev, dtype), ladder_z, families=(DEPTH,), params0=p0,
                                     config=PsfFitConfig(max_iter=20, grtol=0.0))
    (l64, z64), (l32, z32) = res[torch.float64], res[torch.float32]
    f2 = float(np.max(np.abs(l32.f_history[:2] - l64.f_history[:2]) / np.abs(l64.f_history[:2])))
    ff = abs(float(l32.f) - float(l64.f)) / abs(float(l64.f))
    ns = [float(r.params.depth[0]) * OPTICS["wavelength"] for r in (l32, l64)]
    if f2 > 1e-4 or ff > 1e-3:
        raise AssertionError(f"calibrate_depth card/CPU parity: f_history[:2] {f2:.3g}, final f {ff:.3g}")
    log(4, f"calibrate_depth card float32 vs CPU float64, 3 Gibson-Lanni rungs of {PARITY_SHAPE} at planes "
           f"{ladder_z.tolist()} from ns {LADDER_NS_START}: f_history[:2] {f2:.3g} rel (< 1e-4), final f {ff:.3g} "
           f"rel (< 1e-3); ns {ns[0]:.6f} / {ns[1]:.6f}, zshifts {[round(float(v), 3) for v in z32]} / "
           f"{[round(float(v), 3) for v in z64]}, {l32.iterations} / {l64.iterations} iterations")


def calibration_slide(dev) -> tuple[torch.Tensor, dict]:
    """The phase-20 bead slide (float32, on ``dev``) and each half's true
    corner-origin PSF on BEAD_PATCH."""
    model = bead_model(dev)
    with torch.no_grad():
        truths = {"left": model.compute_psf(_with_phase(model, BENCH_PHASE)),
                  "right": model.compute_psf(_with_phase(model, OTHER_PHASE))}
        lam = torch.full(SLIDE_SHAPE, SLIDE_BG, device=dev)
        from microtipi_tpu_torch.utils.arrays import roll

        for i, (y, x) in enumerate(SLIDE_BEADS):
            h = truths["left" if x < SLIDE_SPLIT else "right"]
            lam[:, y - 32:y + 32, x - 32:x + 32] += SLIDE_PEAK * (1.0 - 0.05 * i) * roll(h) / h.max()
        return torch.poisson(lam, generator=torch.Generator(device=dev).manual_seed(20)), truths


def _blind_run(name: str, run, module, falls: str):
    """``run()``, one blind loop on the card, with the TV counts set to 0
    just before; the object steps' VMLMB solves are counted through
    ``module``'s ``minimize_vmlmb``. Checks that deconv_f is finite and
    ``falls``: "each round" (a free loop: every step lowers the same
    objective), "overall" (an anchored fit also weighs the prior or the
    bead, so the object's cost may rise a little in a round: the last round
    ends below the first) or "no" (a windowed fit minimizes the crop's
    cost, not the volume's); that the last fit row is NaN and the TV
    launches equal the object steps' objective calls. Returns (result,
    wall, launches)."""
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

    hv.launches = hv.batched_launches = hv.unaligned_launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _counted_solves(module) as solves:
        res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check_object(name, res.obj)
    df, calls = res.deconv_f, [c for c, _ in solves]
    fell = {"each round": bool(np.all(np.diff(df) < 0)), "overall": bool(df[-1] < df[0]), "no": True}[falls]
    if not (np.isfinite(df).all() and fell):
        raise AssertionError(f"{name}: deconv_f does not fall ({falls}): {df}")
    if not (np.isnan(res.fit_f[-1]).all() and np.isfinite(res.fit_f[:-1]).all()):
        raise AssertionError(f"{name}: the last fit_f row must be NaN, the others finite: {res.fit_f}")
    if (hv.launches, hv.batched_launches, hv.unaligned_launches) != (sum(calls), 0, 0) or calls != [
            e for _, e in solves] or hv.launches == 0:
        raise AssertionError(f"{name}: TV launches {hv.launches} for the object steps' objective calls {calls} "
                             f"(evaluations {[e for _, e in solves]}), batched {hv.batched_launches}, unaligned "
                             f"{hv.unaligned_launches}")
    return res, wall, hv.launches


def phase20_calibration(card: str) -> dict:
    """Bead calibration and the anchored blind loop with the bench optics.
    The slide (SLIDE_SHAPE float32): ``detect_beads`` finds the 8 beads;
    ``average_beads`` averages the left half's 4 (patch BEAD_PATCH);
    ``fit_psf_beads`` fits the average with DEFOCUS + PHASE (the families'
    default; on a centred bead defocus's starting gradient is ~1e-8, so the
    gradient-balanced step can stall at the start, in the JAX package too)
    and with PHASE alone, the calibration; ``bead_fit_uncertainty``;
    ``empirical_psf``; ``calibrate_field`` (PHASE, 8 fits) and ``field_psf``
    at each half's centre against its truth. Then ``blind_deconvolve`` on
    phase 3's scene and config: free, and from the calibration with the
    calibration prior (weight 1e-2), with the averaged bead as an anchor
    (weight sigma_sample^2 / sigma_bead^2) and with ``fit_window``
    FIT_WINDOW under the same prior (unanchored, the windowed fit drifts: a
    CPU run of the loop at 128^3 with a 64^3 window ended 17 from the true
    phase in L2); each anchored run's phase must end nearer the truth than
    the free loop's, and its TV launches equal its object steps' objective
    calls. ``fit_uncertainty`` (PHASE) at SHAPE on the prior run. Returns
    the TV launches by run."""
    from microtipi_tpu_torch.jobs import deconv as jdeconv
    from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig, blind_deconvolve
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
    from microtipi_tpu_torch.jobs.psf_fit import (
        PsfFitConfig, average_beads, bead_fit_uncertainty, calibrate_field, detect_beads, empirical_psf,
        fit_psf_beads, fit_uncertainty)
    from microtipi_tpu_torch.jobs.tiled import field_psf
    from microtipi_tpu_torch.models.microscope import DEFOCUS, PHASE

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slide, truths = calibration_slide(dev)
    torch.cuda.synchronize()
    t_make = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, positions = detect_beads(slide, n_beads=8, patch=BEAD_PATCH)
    t_detect = time.perf_counter() - t0
    if sorted((y, x) for _, y, x in positions) != sorted(SLIDE_BEADS) or [(y, x) for _, y, x in positions] != list(
            SLIDE_BEADS):
        raise AssertionError(f"detect_beads: {positions}, planted (brightest first) {SLIDE_BEADS}")
    left = slide[:, :, :SLIDE_SPLIT]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    avg, used = average_beads(left, n_beads=4, patch=BEAD_PATCH)
    torch.cuda.synchronize()
    t_avg = time.perf_counter() - t0
    model = bead_model(dev)
    init_err = _phase_err(model.init_params(), BENCH_PHASE)
    fits = {}
    for fams in ((DEFOCUS, PHASE), (PHASE,)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit, amp = fit_psf_beads(model, avg, fams, config=PsfFitConfig(max_iter=40, grtol=0.0))
        torch.cuda.synchronize()
        fits[fams] = (fit, float(amp), time.perf_counter() - t0)
    calib, amp, t_fit = fits[(PHASE,)]
    calib_err = _phase_err(calib.params, BENCH_PHASE)
    if used != 4 or not calib_err < 0.5 * init_err or not np.isfinite(fits[(DEFOCUS, PHASE)][0].f):
        raise AssertionError(f"bead calibration: {used} beads averaged, PHASE fit {calib_err:.4g} from the truth "
                             f"(the start is {init_err:.4g})")
    unc = bead_fit_uncertainty(model, calib.params, (PHASE,), avg)
    std = unc.std["phase"].cpu()
    emp = empirical_psf(left, n_beads=4, patch=BEAD_PATCH)
    with torch.no_grad():  # the noiseless bead through the same centring
        from microtipi_tpu_torch.utils.arrays import roll

        emp_err = _rel_l2(emp, empirical_psf(roll(truths["left"])))
    if not bool(torch.isfinite(std).all()) or not bool((std > 0).all()) or abs(float(emp.sum()) - 1.0) > 1e-4:
        raise AssertionError(f"bead error bars {std.tolist()}, empirical PSF sum {float(emp.sum())}")
    df_fit = fits[(DEFOCUS, PHASE)][0]
    log(20, f"[{card}] bead slide {SLIDE_SHAPE} float32 (8 beads, {SLIDE_PEAK:g} photons at the brightest peak over "
            f"{SLIDE_BG:g}, Poisson), made in {t_make:.3f} s; detect_beads found the 8 in brightness order in "
            f"{t_detect:.3f} s (z {[z for z, _, _ in positions]}); average_beads of the left half's {used} in "
            f"{t_avg:.3f} s; fit_psf_beads of the average: DEFOCUS+PHASE status {df_fit.status}, {df_fit.iterations} "
            f"iterations, phase {[round(float(v), 4) for v in df_fit.params.phase]}; PHASE status {calib.status}, "
            f"{calib.iterations} iterations, {calib.evaluations} evaluations, {t_fit:.3f} s, phase "
            f"{[round(float(v), 4) for v in calib.params.phase]} (true {BENCH_PHASE}, L2 off {calib_err:.4f}, the "
            f"start {init_err:.4f}), amplitude {amp:.6g}; bead_fit_uncertainty phase std "
            f"{[round(float(v), 5) for v in std]}; empirical_psf {emp_err:.4f} relative L2 from the noiseless bead's")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    anchors, ffits = calibrate_field(model, slide, families=(PHASE,), n_beads=8,
                                     config=PsfFitConfig(max_iter=40, grtol=0.0))
    torch.cuda.synchronize()
    t_field = time.perf_counter() - t0
    fn, field_errs = field_psf(model, anchors), {}
    for half, x in (("left", SLIDE_SPLIT / 2), ("right", 3 * SLIDE_SPLIT / 2)):
        psf = fn((32.0, SLIDE_SHAPE[1] / 2, x))
        other = truths["right" if half == "left" else "left"]
        field_errs[half] = (_rel_l2(psf, truths[half]), _rel_l2(psf, other))
    if len(anchors) != 8 or any(own >= other for own, other in field_errs.values()):
        raise AssertionError(f"calibrate_field: {len(anchors)} anchors, field_psf relative L2 (own truth, other "
                             f"half's) {field_errs}")
    log(20, f"[{card}] calibrate_field (PHASE, 8 fits of {BEAD_PATCH}) in {t_field:.3f} s, statuses "
            f"{[f.status for f in ffits]}, iterations {[f.iterations for f in ffits]}; field_psf at each half's "
            f"centre, relative L2 to its true PSF and to the other half's: "
            + ", ".join(f"{h} {a:.4f} / {b:.4f}" for h, (a, b) in field_errs.items())
            + f"; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del slide, left

    blind_model, data, _ = bench_scene(SHAPE, dev, torch.float32, phase=BENCH_PHASE)
    base = BlindDeconvConfig(
        loops=5, families=(DEFOCUS, PHASE), psf_max_iter=(5, 5), joint_fit=True,
        deconv=DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=20, grtol=0.0, gatol=0.0),
        fit=PsfFitConfig(grtol=0.0))
    sigma_bead2 = SLIDE_BG / used  # Poisson background variance of the 4-bead average
    bead_w = float((0.01 * data.max()) ** 2) / sigma_bead2
    runs = {"free": dict(config=base),
            "prior": dict(config=dataclasses.replace(base, phase_prior_weight=1e-2), params0=calib.params),
            "bead": dict(config=dataclasses.replace(base, bead_weight=bead_w), params0=calib.params, bead_data=avg),
            "window": dict(config=dataclasses.replace(base, phase_prior_weight=1e-2,
                                                      fit=PsfFitConfig(grtol=0.0, fit_window=FIT_WINDOW)),
                           params0=calib.params)}
    counts, errs = {}, {}
    for name, kw in runs.items():
        falls = {"free": "each round", "window": "no"}.get(name, "overall")
        res, wall, counts[name] = _blind_run(f"blind_deconvolve {name}", lambda: blind_deconvolve(
            data, blind_model, **kw), jdeconv, falls)
        errs[name] = _phase_err(res.params, BENCH_PHASE)
        log(20, f"[{card}] blind_deconvolve {SHAPE}, phase 3's loop, {name}"
                + ("" if name == "free" else " from the bead calibration") + f": deconv_f {res.deconv_f.tolist()} "
                f"(checked to fall: {falls}), object iterations {res.deconv_iters.tolist()}, defocus "
                f"{[round(float(v), 2) for v in res.params.defocus]}, phase "
                f"{[round(float(v), 4) for v in res.params.phase]} (L2 off {errs[name]:.4f}), wall {wall:.3f} "
                f"s (1 run), TV launches {counts[name]} = the object steps' objective calls, peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        if name == "prior":
            prior_res = res
    if not all(errs[n] < errs["free"] for n in ("prior", "bead", "window")):
        raise AssertionError(f"the anchored loops' phase errors {errs} are not all below the free loop's")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u = fit_uncertainty(blind_model, prior_res.params, PHASE, data, prior_res.obj)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not bool(torch.isfinite(u.std).all()) or not bool((u.std > 0).all()):
        raise AssertionError(f"fit_uncertainty at {SHAPE}: std {u.std.tolist()}")
    log(20, f"[{card}] fit_uncertainty PHASE at {SHAPE} on the prior run: std {[f'{float(v):.3g}' for v in u.std]}, "
            f"sigma {float(u.sigma):.4g}, wall {wall:.3f} s, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return counts


def phase21_depth_ladder(card: str) -> dict:
    """The depth ladder and the depth-varying blind loop with phase 18's
    Gibson-Lanni optics (ns LADDER_NS, plane 0 at DEPTH0) and BENCH_PHASE:
    ``calibrate_depth`` (DEPTH + PHASE) on DEPTH_K beads of BEAD_PATCH at
    planes LADDER_Z (Poisson, SLIDE_PEAK photons) from ns LADDER_NS_START and
    no phase, then ``ladder_fit_uncertainty``; ``fit_psf_depthvar`` (PHASE,
    given the object) on phase 18's scene geometry (LANE_SHAPE, DEPTH_K
    anchors) blurred through the true pupil; ``blind_deconvolve_depthvar`` of
    that scene, 5 rounds as phase 3's loop, from the ladder's params with the
    calibration prior, without and with the rung at plane 0 as a bead anchor
    (the bead term centres the bead's peak at the origin while this PSF
    peaks ~8 planes off it, so the anchor pulls Z4 toward the focal shift;
    alone, it took Z4 to ~77 rad in a CPU run at 64^3); their TV launches
    equal their object steps' objective calls. Returns the TV launches by
    run."""
    from microtipi_tpu_torch.jobs import depthvar as jdv
    from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
    from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig
    from microtipi_tpu_torch.models.microscope import DEFOCUS, DEPTH, PHASE

    dev, lam = torch.device("cuda"), OPTICS["wavelength"]
    gl = depthvar_model(BEAD_PATCH, torch.float32, dev)
    truth = _with_phase(gl, BENCH_PHASE)
    ladder_z = np.asarray(LADDER_Z)
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        psfs = gl.compute_depth_psfs(truth, truth.depth[1] + torch.tensor(ladder_z * OPTICS["dz"], device=dev))
        gen = torch.Generator(device=dev).manual_seed(21)
        beads = torch.stack([bead_photons(h, SLIDE_PEAK, gen) for h in psfs])
    p0 = gl.init_params()._replace(depth=torch.tensor([LADDER_NS_START / lam, DEPTH0], device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit, zshifts = jdv.calibrate_depth(gl, beads, ladder_z, families=(DEPTH, PHASE), params0=p0,
                                       config=PsfFitConfig(max_iter=60, grtol=0.0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ns = float(fit.params.depth[0]) * lam
    t0 = time.perf_counter()
    unc = jdv.ladder_fit_uncertainty(gl, fit.params, (DEPTH, PHASE), beads, ladder_z, zshifts)
    torch.cuda.synchronize()
    t_unc = time.perf_counter() - t0
    ns_std = float(unc.std["depth"][0]) * lam
    if not abs(ns - LADDER_NS) < 1e-3 or not np.isfinite(ns_std) or not ns_std > 0:
        raise AssertionError(f"calibrate_depth: ns {ns:.6f} (true {LADDER_NS}), std {ns_std:.3g}")
    log(21, f"[{card}] calibrate_depth DEPTH+PHASE, {len(ladder_z)} Gibson-Lanni beads of {BEAD_PATCH} at planes "
            f"{ladder_z.tolist()} (plane 0 at {DEPTH0 * 1e6:g} um), from ns {LADDER_NS_START} and no phase: ns "
            f"{ns:.6f} +- {ns_std:.2g} (true {LADDER_NS}), d0 {float(fit.params.depth[1]) * 1e6:.4f} um, phase "
            f"{[round(float(v), 4) for v in fit.params.phase]} (true {BENCH_PHASE}), zshifts "
            f"{[round(float(v), 3) for v in zshifts]}, status {fit.status}, {fit.iterations} iterations, "
            f"{fit.evaluations} evaluations, {wall:.3f} s; ladder_fit_uncertainty {t_unc:.3f} s")

    model = depthvar_model(LANE_SHAPE, torch.float32, dev)
    anchors = np.linspace(0.0, LANE_SHAPE[0] - 1.0, DEPTH_K)
    true_lane = _with_phase(model, BENCH_PHASE)
    with torch.no_grad():
        data, obj = depthvar_scene(jdv.depth_anchor_psfs(model, true_lane, anchors), anchors, LANE_SHAPE, dev,
                                   torch.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dfit = jdv.fit_psf_depthvar(model, model.init_params(), (PHASE,), data, obj, anchors,
                                config=PsfFitConfig(max_iter=15, grtol=0.0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    err, err0 = _phase_err(dfit.params, BENCH_PHASE), _phase_err(model.init_params(), BENCH_PHASE)
    if not err < 0.5 * err0:
        raise AssertionError(f"fit_psf_depthvar PHASE: {err:.4g} from the truth, the start {err0:.4g}")
    log(21, f"[{card}] fit_psf_depthvar PHASE on {LANE_SHAPE}, K {DEPTH_K}, given the object: phase "
            f"{[round(float(v), 4) for v in dfit.params.phase]} (L2 off {err:.4f}, the start {err0:.4f}), "
            f"{dfit.iterations} iterations, {dfit.evaluations} evaluations, wall {wall:.3f} s (1 run)")

    cfg = BlindDeconvConfig(
        loops=5, families=(DEFOCUS, PHASE), psf_max_iter=(5, 5), joint_fit=True,
        deconv=DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=20, grtol=0.0, gatol=0.0),
        fit=PsfFitConfig(grtol=0.0), phase_prior_weight=1e-2, bead_weight=float((0.01 * data.max()) ** 2) / SLIDE_BG)
    counts = {}
    for name, bead in (("prior", None), ("prior and bead", beads[0])):
        res, wall, n = _blind_run(f"blind_deconvolve_depthvar {name}", lambda: jdv.blind_deconvolve_depthvar(
            data, model, anchors, params0=fit.params, config=cfg, bead_data=bead), jdv, "overall")
        if res.psf.shape != (DEPTH_K, *LANE_SHAPE):
            raise AssertionError(f"blind_deconvolve_depthvar: psf {tuple(res.psf.shape)}")
        counts[f"depth-varying blind, ladder {name} (phase 21)"] = n
        log(21, f"[{card}] blind_deconvolve_depthvar {LANE_SHAPE}, K {DEPTH_K}, 5 rounds, joint defocus+phase fits, "
                f"from the ladder (ns {ns:.6f}) with the calibration prior (1e-2)"
                + (" and the plane-0 rung as a bead anchor" if bead is not None else "")
                + f": deconv_f {res.deconv_f.tolist()}, phase {[round(float(v), 4) for v in res.params.phase]} (L2 off "
                f"{_phase_err(res.params, BENCH_PHASE):.4f}, the ladder's {_phase_err(fit.params, BENCH_PHASE):.4f}), "
                f"wall {wall:.3f} s (1 run), TV launches {n} = the object steps' objective calls, peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return counts


# Phase 22: the joint solvers (time series, multichannel, 5D, finer grid) on the bench optics.
SERIES_T, EVENT_T, EVENT_BEADS = 8, 4, 32  # frames, the frame where the event beads appear, how many
CHANNEL_NM = (460e-9, 525e-9, 610e-9)  # the channels' emission wavelengths
CHANNEL_SCALES = (1.0, 0.5, 0.15)  # one structure in every channel at these intensities: the last is dim
MIXING = ((0.85, 0.25), (0.15, 0.75))  # README's two-dye bleed-through matrix
BLOCK_TC = (4, 2)  # the 5D block's timepoints and channels
SR_CAMERA, SR_FACTOR = (64, 256, 256), (1, 2, 2)  # camera data; the fine grid is JOINT_VOL
SR_SPACING = 64  # fine pixels between the superres beads
JOINT_PARITY_VOL = (16, 64, 64)  # phase 4's size for the joint solvers
MU_T = 0.01  # the temporal prior's weight (epsilon_t = epsilon = 1)
# The coupling comparison's mus, one for each prior: the coupled norm makes shared edges cheap, so it takes
# the larger one (tests/test_multichannel.py:134-152 gives it 10x).
JOINT_MU, SEPARATE_MU = 1e-2, 3e-3


def joint_psf(shape, device, dtype, wavelength=None, dxy=None) -> torch.Tensor:
    """The bench optics' in-focus widefield PSF (OPTICS) at ``shape``, at
    another emission wavelength or pixel pitch where given."""
    from microtipi_tpu_torch.models.widefield import WideFieldConfig, WideFieldModel

    optics = dict(OPTICS, **{k: v for k, v in (("wavelength", wavelength), ("dxy", dxy)) if v is not None})
    model = WideFieldModel(WideFieldConfig(shape=shape, dtype=dtype, **optics), device=device)
    with torch.no_grad():
        return model.compute_psf(model.init_params())


def blur(obj: torch.Tensor, psf: torch.Tensor) -> torch.Tensor:
    """Circular convolution of a stack (..., Nz, Ny, Nx) by one PSF, or one a
    leading index."""
    from microtipi_tpu_torch.ops.convolution import convolve, convolve_spectrum

    with torch.no_grad():
        return convolve(obj, convolve_spectrum(psf), tuple(obj.shape[-3:]))


def bead_centres(shape, rng, density=5e-5) -> np.ndarray:
    """Random bead centres on the host, float32: ``density`` of the voxels,
    amplitudes uniform in [50, 150]."""
    return (rng.uniform(50.0, 150.0, shape) * (rng.random(shape) < density)).astype(np.float32)


def resolved_beads(centres: np.ndarray, device, dtype) -> torch.Tensor:
    """0.5 um beads resolved over several voxels: the centres blurred by a
    Gaussian of 2 planes (400 nm) by 3 pixels (240 nm) standard deviation,
    peak 1. Point beads under the widefield blur leave 20 iterations far
    from the truth whatever the prior; on these the noise, which a prior
    averages, is a share of the error."""
    vol = centres.shape[-3:]
    ax = [np.minimum(np.arange(n), n - np.arange(n)).astype(np.float64) for n in vol]
    k = np.exp(-ax[0][:, None, None] ** 2 / 8.0 - ax[1][None, :, None] ** 2 / 18.0 - ax[2][None, None, :] ** 2 / 18.0)
    return blur(torch.as_tensor(centres, device=device, dtype=dtype), torch.as_tensor(k, device=device, dtype=dtype))


def with_noise(clean: torch.Tensor, sigma: float, rng) -> torch.Tensor:
    """``clean`` plus Gaussian noise of standard deviation ``sigma`` drawn on
    the host (the same draw for every device and dtype)."""
    noise = rng.standard_normal(tuple(clean.shape), dtype=np.float32)
    return clean + sigma * torch.as_tensor(noise, device=clean.device, dtype=clean.dtype)


def series_truth(vol, nt, device, dtype, rng):
    """``nt`` frames of fixed resolved beads, EVENT_BEADS more of amplitude 150
    appearing at frame EVENT_T (when ``nt`` reaches it). Returns (truth, the
    event beads' centres)."""
    centres = np.repeat(bead_centres(vol, rng)[None], nt, axis=0)
    events = tuple(rng.integers(m, n - m, EVENT_BEADS) for n, m in zip(vol, (2, 4, 4)))
    centres[EVENT_T:, events[0], events[1], events[2]] = 150.0
    return resolved_beads(centres, device, dtype), events


def series_scene(vol, nt, device, dtype, seed=0, noise=0.1):
    """The time series (:func:`series_truth`) blurred by the bench PSF, plus
    noise of ``noise`` times the clean maximum drawn independently for each
    frame. Returns (truth, data, psf, the event beads' centres)."""
    rng = np.random.default_rng(seed)
    truth, events = series_truth(vol, nt, device, dtype, rng)
    psf = joint_psf(vol, device, dtype)
    clean = blur(truth, psf)
    return truth, with_noise(clean, noise * float(clean.max()), rng), psf, events


def event_sums(x: torch.Tensor, events) -> list:
    """Per frame, the sum over 3x3x3 neighbourhoods of the event beads'
    centres (tests/test_timeseries.py:62)."""
    idx = [torch.as_tensor(c, device=x.device) for c in events]
    offs = torch.arange(-1, 2, device=x.device)
    z = (idx[0][:, None, None, None] + offs[None, :, None, None]).expand(-1, 3, 3, 3)
    y = (idx[1][:, None, None, None] + offs[None, None, :, None]).expand(-1, 3, 3, 3)
    xx = (idx[2][:, None, None, None] + offs[None, None, None, :]).expand(-1, 3, 3, 3)
    return x[:, z, y, xx].flatten(1).sum(1).tolist()


def channel_scene(vol, device, dtype, seed=0, noise=0.5):
    """The multichannel scene: one set of boxes (cells 0.5-2 um across, 50-80
    intensity) in every channel at CHANNEL_SCALES, each channel blurred by its
    own PSF (CHANNEL_NM), plus Gaussian noise of ``noise`` (absolute).
    Returns (truth (C,)+vol, data, psfs)."""
    rng = np.random.default_rng(seed)
    nz, ny, nx = vol
    obj = np.zeros(vol, np.float32)
    for _ in range(max(4, ny * nx // 1200)):
        dz, dy, dx = rng.integers(2, max(3, nz // 3)), rng.integers(6, 24), rng.integers(6, 24)
        z, y, x = rng.integers(0, nz - dz), rng.integers(0, ny - dy), rng.integers(0, nx - dx)
        obj[z:z + dz, y:y + dy, x:x + dx] = rng.uniform(50.0, 80.0)
    truth = torch.as_tensor(np.stack([s * obj for s in CHANNEL_SCALES]), device=device, dtype=dtype)
    psfs = torch.stack([joint_psf(vol, device, dtype, wavelength=lam) for lam in CHANNEL_NM])
    return truth, with_noise(blur(truth, psfs), noise, rng), psfs


def mixed_scene(vol, device, dtype, seed=0, noise=0.5):
    """Two dyes behind MIXING: the boxes of :func:`channel_scene` (525 nm)
    and resolved beads (610 nm), detected in two channels, plus noise.
    Returns (truth (K,)+vol, detected data (C,)+vol, psfs, mixing)."""
    boxes, _, _ = channel_scene(vol, device, dtype, seed, noise)
    beads = resolved_beads(bead_centres(vol, np.random.default_rng(seed + 1), density=2e-4), device, dtype)
    truth = torch.stack([boxes[0], beads])
    psfs = torch.stack([joint_psf(vol, device, dtype, wavelength=lam) for lam in CHANNEL_NM[1:]])
    m = torch.tensor(MIXING, device=device, dtype=dtype)
    detected = torch.einsum("ck,kzyx->czyx", m, blur(truth, psfs))
    return truth, with_noise(detected, noise, np.random.default_rng(seed + 2)), psfs, m


def block_scene(vol, device, dtype, seed=0, noise=0.05):
    """The 5D block: BLOCK_TC timepoints x channels of the series' beads
    (:func:`series_truth`), the second channel at half the intensity, through
    the 525 and 610 nm PSFs, each channel fading by its own bleaching gains
    exp(-k_c t), plus noise of ``noise`` times the clean maximum. Returns
    (truth, data, psfs, gains (T, C))."""
    nt, _ = BLOCK_TC
    rng = np.random.default_rng(seed)
    truth, _ = series_truth(vol, nt, device, dtype, rng)
    truth = torch.stack([truth, 0.5 * truth], dim=1)
    psfs = torch.stack([joint_psf(vol, device, dtype, wavelength=lam) for lam in CHANNEL_NM[1:]])
    gains = torch.exp(-torch.outer(torch.arange(nt, dtype=dtype), torch.tensor([0.05, 0.12], dtype=dtype))).to(device)
    clean = gains[:, :, None, None, None] * blur(truth, psfs)
    return truth, with_noise(clean, noise * float(clean.max()), rng), psfs, gains


def superres_scene(camera, factor, device, dtype, seed=0, noise=0.01):
    """Point beads of amplitude 200 off the camera's lattice (odd fine coordinates) every
    SR_SPACING fine pixels, blurred on the fine grid by the PSF synthesised at
    dxy / f, binned to the camera, plus noise of ``noise`` times the
    maximum. Returns (camera data, fine PSF, camera-pitch PSF, bead positions)."""
    from microtipi_tpu_torch.jobs.superres import bin_volume

    fine = tuple(n * f for n, f in zip(camera, factor))
    rng = np.random.default_rng(seed)
    beads = [(int(rng.integers(2, fine[0] - 2)), y + 1, x + 1) for y in range(SR_SPACING // 2, fine[1], SR_SPACING)
             for x in range(SR_SPACING // 2, fine[2], SR_SPACING)]
    obj = torch.zeros(fine, device=device, dtype=dtype)
    for z, y, x in beads:
        obj[z, y, x] = 200.0
    psf_fine = joint_psf(fine, device, dtype, dxy=OPTICS["dxy"] / factor[2])
    clean = bin_volume(blur(obj, psf_fine), factor)
    data = with_noise(clean, noise * float(clean.max()), rng)
    return data, psf_fine, joint_psf(camera, device, dtype), beads


def centroid_error(x: torch.Tensor, bead, scale: int) -> float:
    """The distance in fine pixels from a bead to the centroid of the 5x5
    camera-pixel window around it in the planes z-1..z+1 of ``x`` (sampled
    at ``scale`` fine pixels a pixel): tests/test_superres.py:70-78."""
    z, y, xx = bead
    yc, xc = y // scale, xx // scale
    win = x[max(0, z - 1):z + 2].sum(0)[yc - 2:yc + 3, xc - 2:xc + 3].double()
    g = torch.arange(5, dtype=torch.float64, device=x.device)
    cy = yc - 2 + float((g[:, None] * win).sum() / win.sum())
    cx = xc - 2 + float((g[None, :] * win).sum() / win.sum())
    return float(np.hypot(scale * cy - y, scale * cx - xx))


def _err(x: torch.Tensor, truth: torch.Tensor) -> float:
    return float(torch.linalg.norm(x - truth) / torch.linalg.norm(truth))


def _vmlmb_run(name: str, run, tv: str):
    """``run()``, a VMLMB solve of the joint solvers, timed by :func:`_timed`
    with its objective calls counted over the 4 runs by wrapping
    ``jobs.multichannel``'s ``minimize_vmlmb``: the TV launches of kind ``tv``
    ("batched", "single", or "none" for the joint TV, which is PyTorch
    operators) equal the calls, and the calls VMLMB's evaluations. Returns
    (result, wall, TV launches)."""
    from microtipi_tpu_torch.jobs import multichannel
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

    hv.launches = hv.batched_launches = hv.unaligned_launches = 0
    with _counted_solves(multichannel) as solves:
        wall, res = _timed(run)
    _check_object(name, res.x)
    calls, evaluations = [c for c, _ in solves], [e for _, e in solves]
    want = {"batched": (0, sum(calls)), "single": (sum(calls), 0), "none": (0, 0)}[tv]
    if (hv.launches, hv.batched_launches) != want or calls != evaluations or hv.unaligned_launches:
        raise AssertionError(f"{name}: TV launches single {hv.launches}, batched {hv.batched_launches} (expected "
                             f"{want}), unaligned {hv.unaligned_launches}, for the objective calls {calls}, VMLMB's "
                             f"evaluations {evaluations}")
    return res, wall, hv.launches + hv.batched_launches


def _admm_run(name: str, run, iterations: int, tv_values: int, split: bool = True, timed: bool = True,
              tv: str = "batched"):
    """``run()``, an ADMM solve of the joint solvers, timed by :func:`_timed`
    (4 runs) or once cold, with the kernels counted over every run:
    ``admm_rhs`` once an iteration, ``admm_split_update`` once an iteration
    where ``split`` (the joint TV's prox is PyTorch operators), the TV kernel
    of kind ``tv`` ``tv_values`` times a run and the other TV kernel never.
    ``iterations`` None takes the run's own count. Returns (result, wall,
    counts, the counts' line)."""
    with AdmmCounts() as c:
        if timed:
            wall, res = _timed(run)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    runs = 4 if timed else 1
    _check_object(name, res.x)
    if not np.isfinite(res.f):
        raise AssertionError(f"{name}: f {res.f}")
    n = runs * (res.iterations if iterations is None else iterations)
    return res, wall, c, c.check(name, n, runs * tv_values, split=n if split else 0, tv=tv) + f" ({runs} runs)"


def phase22_series(card: str) -> dict:
    """The time series, SERIES_T frames of JOINT_VOL (:func:`series_scene`,
    noise 10%, mu 0.01, epsilon 1, mu_t 0.01): ``deconvolve_timeseries``, 20
    VMLMB iterations at mu_t 0 and 0.01; ``admm_deconvolve_timeseries``, 20
    iterations untracked at mu_t 0 and 0.01, tracked, weighted by
    ``InverseVarianceWeights.from_data`` with the gains of a 5%-a-frame fade
    (on data faded by them), and stopped by the Boyd test. Checks, as
    tests/test_timeseries.py:49-66 does, that the temporal prior lowers the
    error to the truth by its margin (under 0.94x the error at mu_t 0, for
    each engine) and that both engines keep the event. Returns the kernels'
    launches on these paths."""
    from microtipi_tpu_torch.jobs.admm import admm_deconvolve_timeseries
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
    from microtipi_tpu_torch.jobs.timeseries import deconvolve_timeseries
    from microtipi_tpu_torch.weights.updaters import InverseVarianceWeights

    dev, nt, mu_t = torch.device("cuda"), SERIES_T, MU_T
    t0 = time.perf_counter()
    truth, data, psf, events = series_scene(JOINT_VOL, nt, dev, torch.float32)
    torch.cuda.synchronize()
    log(22, f"[{card}] time series {nt} x {JOINT_VOL}: made in {time.perf_counter() - t0:.3f} s "
            f"({EVENT_BEADS} beads appear at frame {EVENT_T})")
    nvox = float(data.numel())
    cfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=20, grtol=0.0, gatol=0.0)
    launches = {"tv_batched": 0, "split": 0, "rhs": 0}

    def keeps_event(name, x):
        sums = event_sums(x, events)
        before, after = max(sums[EVENT_T - 2:EVENT_T]), min(sums[EVENT_T:EVENT_T + 2])
        if not after > 2.5 * before:
            raise AssertionError(f"{name}: the event is smeared: per-frame sums {sums}")
        return f"event sums {[round(s, 1) for s in sums]}"

    torch.cuda.reset_peak_memory_stats()
    errs = {}
    for m in (0.0, mu_t):
        res, wall, n = _vmlmb_run(f"deconvolve_timeseries mu_t {m}",
                                  lambda: deconvolve_timeseries(data, psf, config=cfg, mu_t=m), "batched")
        launches["tv_batched"] += n
        errs["vmlmb", m] = _err(res.x, truth)
        log(22, f"[{card}] deconvolve_timeseries mu_t {m}, 20 VMLMB iterations: {res.iterations} iterations, "
                f"{res.evaluations} evaluations, f {float(res.f):.6g}, error to the truth {errs['vmlmb', m]:.4f} "
                f"relative L2, {keeps_event('deconvolve_timeseries', res.x)}, wall {wall:.4f} s (median of 3 after 1 "
                f"warm-up), {nvox * res.iterations / wall / 1e6:.1f} Mvox*iter/s, batched TV launches {n} = the "
                f"objective calls (4 runs)")
    log(22, f"[{card}] deconvolve_timeseries peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    torch.cuda.reset_peak_memory_stats()
    for m in (0.0, mu_t):
        res, wall, c, counted = _admm_run(f"admm_deconvolve_timeseries mu_t {m}", lambda: admm_deconvolve_timeseries(
            data, psf, config=cfg, mu_t=m, track_objective=False), 20, 2)
        launches["split"] += c.split
        launches["rhs"] += c.rhs
        launches["tv_batched"] += c.tv_batched
        errs["admm", m] = _err(res.x, truth)
        log(22, f"[{card}] admm_deconvolve_timeseries mu_t {m}, 20 iterations, untracked: f {float(res.f):.6g}, error "
                f"to the truth {errs['admm', m]:.4f} relative L2, {keeps_event('admm_deconvolve_timeseries', res.x)}, "
                f"wall {wall:.4f} s (median of 3 after 1 warm-up), {nvox * 20 / wall / 1e6:.1f} Mvox*iter/s, "
                f"{counted}, peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    ratio = {e: errs[e, mu_t] / errs[e, 0.0] for e in ("vmlmb", "admm")}
    if not max(ratio.values()) < 0.94:
        raise AssertionError(f"the temporal prior does not lower the error to the truth under 0.94x: {errs}")
    log(22, f"the temporal prior lowers the error to the truth (held under 0.94x, as tests/test_timeseries.py:57): "
            f"VMLMB {errs['vmlmb', mu_t]:.4f} against {errs['vmlmb', 0.0]:.4f} at mu_t 0 ({ratio['vmlmb']:.4f}x), "
            f"ADMM {errs['admm', mu_t]:.4f} against {errs['admm', 0.0]:.4f} ({ratio['admm']:.4f}x)")

    res, wall, c, counted = _admm_run("tracked admm_deconvolve_timeseries", lambda: admm_deconvolve_timeseries(
        data, psf, config=cfg, mu_t=mu_t), 20, 22)
    launches["split"] += c.split
    launches["rhs"] += c.rhs
    launches["tv_batched"] += c.tv_batched
    fh = res.f_history
    if not (np.isfinite(fh).all() and fh[-1] < fh[1] and float(res.f) == fh[-1]):
        raise AssertionError(f"tracked admm_deconvolve_timeseries: f_history {fh.tolist()}")
    log(22, f"[{card}] admm_deconvolve_timeseries tracked: f_history {fh[0]:.6g} -> {fh[1]:.6g} -> {fh[-1]:.6g}, wall "
            f"{wall:.4f} s (median of 3 after 1 warm-up), {nvox * 20 / wall / 1e6:.1f} Mvox*iter/s, {counted}")

    gains = torch.exp(-0.05 * torch.arange(nt, dtype=torch.float32, device=dev))
    faded = gains[:, None, None, None] * data
    weights = InverseVarianceWeights(gain=1.0, readout_variance=1.0).from_data(faded)
    torch.cuda.reset_peak_memory_stats()
    res, wall, c, counted = _admm_run("weighted admm_deconvolve_timeseries with bleach", lambda: (
        admm_deconvolve_timeseries(faded, psf, weights, config=cfg, mu_t=mu_t, bleach=gains,
                                   track_objective=False)), 20, 2)
    launches["split"] += c.split
    launches["rhs"] += c.rhs
    launches["tv_batched"] += c.tv_batched
    log(22, f"[{card}] admm_deconvolve_timeseries weighted (InverseVarianceWeights.from_data) with the gains of a "
            f"5%-a-frame fade (the data split, 4 4D FFTs an iteration): f {float(res.f):.6g}, error to the truth "
            f"{_err(res.x, truth):.4f}, wall {wall:.4f} s (median of 3 after 1 warm-up), "
            f"{nvox * 20 / wall / 1e6:.1f} Mvox*iter/s, {counted}, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del faded, weights

    budget = 600  # reltol 1e-2, as tests/test_torch_timeseries.py pins the Boyd stop
    bcfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=budget, admm_reltol=1e-2, admm_abstol=1e-6)
    res, wall, c, counted = _admm_run("Boyd-stopped admm_deconvolve_timeseries", lambda: admm_deconvolve_timeseries(
        data, psf, config=bcfg, mu_t=mu_t, track_objective=False), None, 2, timed=False)
    launches["split"] += c.split
    launches["rhs"] += c.rhs
    launches["tv_batched"] += c.tv_batched
    if res.status != 0 or not 0 < res.iterations < budget or res.iterations % bcfg.admm_check_every:
        raise AssertionError(f"Boyd-stopped admm_deconvolve_timeseries: status {res.status} after {res.iterations} "
                             f"of {budget}")
    log(22, f"[{card}] admm_deconvolve_timeseries stopped by the Boyd test over the whole block (reltol 1e-2, abstol "
            f"1e-6, checked every {bcfg.admm_check_every}): status 0 after {res.iterations} of {budget} iterations, f "
            f"{float(res.f):.6g}, error to the truth {_err(res.x, truth):.4f}, wall {wall:.4f} s (1 run), "
            f"{nvox * res.iterations / wall / 1e6:.1f} Mvox*iter/s, {counted}")
    return launches


def phase22_channels(card: str) -> dict:
    """The multichannel solve, C = 3 channels of JOINT_VOL
    (:func:`channel_scene`): ``deconvolve_multichannel`` and
    ``admm_deconvolve_multichannel``, 40 iterations, joint at JOINT_MU and
    separate at SEPARATE_MU; checks, as tests/test_multichannel.py:134 does,
    that joint coupling lowers the dim channel's error: by ADMM under its
    0.92x margin, by VMLMB below 1x (the bright channel's errors are
    reported).
    Then two dyes behind MIXING (:func:`mixed_scene`) by both engines, 20
    iterations, separate: each dye ends closer to its truth than the clipped
    pseudo-inverse unmix it starts from. Returns the launches."""
    from microtipi_tpu_torch.jobs.admm import admm_deconvolve_multichannel
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
    from microtipi_tpu_torch.jobs.multichannel import deconvolve_multichannel

    dev = torch.device("cuda")
    truth, data, psfs = channel_scene(JOINT_VOL, dev, torch.float32)
    nvox = float(data.numel())
    launches = {"tv_batched": 0, "split": 0, "rhs": 0}
    errs = {}
    torch.cuda.reset_peak_memory_stats()
    for coupling, mu in (("joint", JOINT_MU), ("separate", SEPARATE_MU)):
        cfg = DeconvolutionConfig(mu=mu, epsilon=1.0, max_iter=40, grtol=0.0, gatol=0.0)
        sep = coupling == "separate"
        res, wall, n = _vmlmb_run(f"deconvolve_multichannel {coupling}", lambda: deconvolve_multichannel(
            data, psfs, config=cfg, coupling=coupling), "batched" if sep else "none")
        launches["tv_batched"] += n
        errs["vmlmb", coupling] = [_err(res.x[c], truth[c]) for c in range(3)]
        log(22, f"[{card}] deconvolve_multichannel {coupling} (mu {mu}) 3 x {JOINT_VOL}, 40 VMLMB iterations: "
                f"{res.iterations} iterations, {res.evaluations} evaluations, f {float(res.f):.6g}, errors to the "
                f"truth {[round(e, 4) for e in errs['vmlmb', coupling]]}, wall {wall:.4f} s (median of 3 after 1 "
                f"warm-up), {nvox * res.iterations / wall / 1e6:.1f} Mvox*iter/s, "
                + (f"batched TV launches {n} = the objective calls (4 runs)" if sep else "no TV kernel (the joint "
                   "TV is PyTorch operators)"))
        res, wall, c, counted = _admm_run(f"admm_deconvolve_multichannel {coupling}", lambda: (
            admm_deconvolve_multichannel(data, psfs, config=cfg, coupling=coupling)), 40, 42 if sep else 0, split=sep)
        launches["split"] += c.split
        launches["rhs"] += c.rhs
        launches["tv_batched"] += c.tv_batched
        errs["admm", coupling] = [_err(res.x[c], truth[c]) for c in range(3)]
        log(22, f"[{card}] admm_deconvolve_multichannel {coupling} (mu {mu}), 40 iterations, tracked: f "
                f"{float(res.f):.6g}, errors to the truth {[round(e, 4) for e in errs['admm', coupling]]}, wall "
                f"{wall:.4f} s (median of 3 after 1 warm-up), {nvox * 40 / wall / 1e6:.1f} Mvox*iter/s, {counted}, "
                f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    ratio = {e: errs[e, "joint"][2] / errs[e, "separate"][2] for e in ("vmlmb", "admm")}
    bright = {e: errs[e, "joint"][0] / errs[e, "separate"][0] for e in ("vmlmb", "admm")}
    if not (ratio["admm"] < 0.92 and ratio["vmlmb"] < 1.0):
        raise AssertionError(f"joint coupling does not help the dim channel: {errs}")
    log(22, f"joint coupling lowers the dim channel's error: ADMM {ratio['admm']:.4f}x separate's (held < 0.92), "
            f"VMLMB {ratio['vmlmb']:.4f}x (held < 1); the bright channel's joint/separate {bright['admm']:.4f}x (ADMM), "
            f"{bright['vmlmb']:.4f}x (VMLMB)")
    del data

    truth, data, psfs, m = mixed_scene(JOINT_VOL, dev, torch.float32)
    x0 = torch.clamp_min(torch.einsum("kc,czyx->kzyx", torch.linalg.pinv(m), data), 0.0)
    start = [_err(x0[k], truth[k]) for k in range(2)]
    cfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=20, grtol=0.0, gatol=0.0)
    res, wall, n = _vmlmb_run("deconvolve_multichannel with mixing", lambda: deconvolve_multichannel(
        data, psfs, config=cfg, coupling="separate", mixing=m), "batched")
    launches["tv_batched"] += n
    ends = {"VMLMB": [_err(res.x[k], truth[k]) for k in range(2)]}
    log(22, f"[{card}] deconvolve_multichannel with mixing {MIXING} (the (K, K) Fourier coupling, no extra FFT), "
            f"2 dyes of {JOINT_VOL}, 20 VMLMB iterations: f {float(res.f):.6g}, wall {wall:.4f} s (median of 3 after 1 "
            f"warm-up), batched TV launches {n} = the objective calls (4 runs)")
    res, wall, c, counted = _admm_run("admm_deconvolve_multichannel with mixing", lambda: admm_deconvolve_multichannel(
        data, psfs, config=cfg, coupling="separate", mixing=m), 20, 22)
    launches["split"] += c.split
    launches["rhs"] += c.rhs
    launches["tv_batched"] += c.tv_batched
    ends["ADMM"] = [_err(res.x[k], truth[k]) for k in range(2)]
    if not all(e < s for v in ends.values() for e, s in zip(v, start)):
        raise AssertionError(f"unmixing: the dyes' errors {ends} against the pseudo-inverse start's {start}")
    log(22, f"[{card}] admm_deconvolve_multichannel with mixing (its data prox a (K, K) inverse by a channel einsum), "
            f"20 iterations, tracked: f {float(res.f):.6g}, wall {wall:.4f} s (median of 3 after 1 warm-up), "
            f"{counted}; the dyes' errors to the truth {({k: [round(e, 4) for e in v] for k, v in ends.items()})} "
            f"against the clipped pseudo-inverse unmix's {[round(e, 4) for e in start]}")
    return launches


def phase22_block(card: str) -> dict:
    """The 5D block, BLOCK_TC timepoints x channels of JOINT_VOL
    (:func:`block_scene`), separate coupling, mu_t MU_T and the bleaching
    gains: ``deconvolve_timeseries_multichannel`` (20 VMLMB iterations, one
    batched TV launch over the T * C lanes an evaluation) and
    ``admm_deconvolve_timeseries_multichannel`` (20 iterations tracked, both
    ADMM kernels over the T * C lanes). Returns the launches."""
    from microtipi_tpu_torch.jobs.admm import admm_deconvolve_timeseries_multichannel
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
    from microtipi_tpu_torch.jobs.multichannel import deconvolve_timeseries_multichannel

    dev, mu_t = torch.device("cuda"), MU_T
    truth, data, psfs, gains = block_scene(JOINT_VOL, dev, torch.float32)
    nvox = float(data.numel())
    cfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=20, grtol=0.0, gatol=0.0)
    kw = dict(config=cfg, mu_t=mu_t, bleach=gains, coupling="separate")
    launches = {"tv_batched": 0, "split": 0, "rhs": 0}
    torch.cuda.reset_peak_memory_stats()
    res, wall, n = _vmlmb_run("deconvolve_timeseries_multichannel", lambda: deconvolve_timeseries_multichannel(
        data, psfs, **kw), "batched")
    launches["tv_batched"] += n
    log(22, f"[{card}] deconvolve_timeseries_multichannel {BLOCK_TC} x {JOINT_VOL}, separate, mu_t {mu_t}, bleach, 20 "
            f"VMLMB iterations: {res.iterations} iterations, f {float(res.f):.6g}, error to the truth "
            f"{_err(res.x, truth):.4f}, wall {wall:.4f} s (median of 3 after 1 warm-up), "
            f"{nvox * res.iterations / wall / 1e6:.1f} Mvox*iter/s, batched TV launches {n} = the objective calls (4 "
            f"runs), peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    torch.cuda.reset_peak_memory_stats()
    res, wall, c, counted = _admm_run("admm_deconvolve_timeseries_multichannel", lambda: (
        admm_deconvolve_timeseries_multichannel(data, psfs, **kw)), 20, 22)
    launches["split"] += c.split
    launches["rhs"] += c.rhs
    launches["tv_batched"] += c.tv_batched
    fh = res.f_history
    if not (np.isfinite(fh).all() and fh[-1] < fh[1]):
        raise AssertionError(f"admm_deconvolve_timeseries_multichannel: f_history {fh.tolist()}")
    log(22, f"[{card}] admm_deconvolve_timeseries_multichannel, 20 iterations, tracked (the data split carries the "
            f"gains): f_history {fh[0]:.6g} -> {fh[1]:.6g} -> {fh[-1]:.6g}, error to the truth "
            f"{_err(res.x, truth):.4f}, wall {wall:.4f} s (median of 3 after 1 warm-up), "
            f"{nvox * 20 / wall / 1e6:.1f} Mvox*iter/s, {counted}, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return launches


def phase22_superres(card: str) -> dict:
    """The finer grid: camera data SR_CAMERA at SR_FACTOR (the fine grid
    JOINT_VOL, its PSF synthesised at dxy / 2; :func:`superres_scene`):
    ``deconvolve_superres`` (20 VMLMB iterations, the single-volume TV kernel
    on the fine grid an evaluation) and ``admm_deconvolve_superres`` (20
    iterations tracked, both ADMM kernels with B = 1), each against the
    coarse-grid solve of its engine (``deconvolve``, ``admm_deconvolve``).
    Checks, as tests/test_superres.py:49-92 does, that the fine grid
    localises the off-lattice beads better (mean centroid error under 0.6x
    the coarse grid's). Returns the launches."""
    from microtipi_tpu_torch.jobs.admm import admm_deconvolve
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, deconvolve
    from microtipi_tpu_torch.jobs.superres import admm_deconvolve_superres, deconvolve_superres

    dev = torch.device("cuda")
    data, psf_fine, psf_coarse, beads = superres_scene(SR_CAMERA, SR_FACTOR, dev, torch.float32)
    nvox = float(np.prod(JOINT_VOL))
    cfg = DeconvolutionConfig(mu=0.01, epsilon=0.5, max_iter=20, grtol=0.0, gatol=0.0)
    launches = {"tv_single": 0, "split": 0, "rhs": 0}
    torch.cuda.reset_peak_memory_stats()
    res, wall, n = _vmlmb_run("deconvolve_superres", lambda: deconvolve_superres(
        data, psf_fine, SR_FACTOR, config=cfg), "single")
    launches["tv_single"] += n
    coarse = deconvolve(data, psf_coarse, config=cfg)
    runs = {"VMLMB": (res, coarse, f"{res.iterations} iterations, wall {wall:.4f} s (median of 3 after 1 warm-up), "
                                    f"{nvox * res.iterations / wall / 1e6:.1f} Mvox*iter/s, TV launches {n} = the "
                                    f"objective calls (4 runs)")}
    res, wall, c, counted = _admm_run("admm_deconvolve_superres", lambda: admm_deconvolve_superres(
        data, psf_fine, SR_FACTOR, config=cfg), 20, 22, tv="single")
    launches["split"] += c.split
    launches["rhs"] += c.rhs
    launches["tv_single"] += c.tv_single
    runs["ADMM"] = (res, admm_deconvolve(data, psf_coarse, config=cfg),
                    f"wall {wall:.4f} s (median of 3 after 1 warm-up), {nvox * 20 / wall / 1e6:.1f} Mvox*iter/s, "
                    f"{counted}")
    for engine, (fine, coarse, line) in runs.items():
        e_f = [centroid_error(fine.x, b, 1) for b in beads]
        e_c = [centroid_error(coarse.x, b, 2) for b in beads]
        if not np.mean(e_f) < 0.6 * np.mean(e_c):
            raise AssertionError(f"superres {engine}: mean centroid error {np.mean(e_f):.4f} fine pixels against the "
                                 f"coarse grid's {np.mean(e_c):.4f}")
        log(22, f"[{card}] {engine} superres {SR_CAMERA} at {SR_FACTOR} onto {JOINT_VOL}, 20 iterations: f "
                f"{float(fine.f):.6g}, {len(beads)} off-lattice beads localised to {np.mean(e_f):.4f} fine pixels "
                f"(max {np.max(e_f):.4f}) against the coarse grid's {np.mean(e_c):.4f}, flux "
                f"{float(fine.x.sum()):.1f} for {200.0 * len(beads):.1f}; {line}")
    log(22, f"[{card}] superres peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    return launches


def joint_parity_solves() -> dict:
    """Phase 4's joint solves: name -> (engine, which kernels the card run
    launches: (TV, split update, rhs), ``solve(device, dtype)``), each on its
    scene at JOINT_PARITY_VOL (superres: camera data of (16, 32, 32) at
    SR_FACTOR), 10 iterations, mu_t MU_T."""
    from microtipi_tpu_torch.jobs import admm, multichannel, superres, timeseries
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
    from microtipi_tpu_torch.weights.updaters import InverseVarianceWeights

    vol, kw = JOINT_PARITY_VOL, dict(grtol=0.0, gatol=0.0, max_iter=10)
    cfg, sr_cfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, **kw), DeconvolutionConfig(mu=0.01, epsilon=0.5, **kw)
    joint, separate = (DeconvolutionConfig(mu=mu, epsilon=1.0, **kw) for mu in (JOINT_MU, SEPARATE_MU))

    def series(solve):
        def run(dev, dt):
            _, data, psf, _ = series_scene(vol, 3, dev, dt)
            return solve(data, psf, config=cfg, mu_t=MU_T)
        return run

    def weighted_series(dev, dt):
        _, data, psf, _ = series_scene(vol, 3, dev, dt)
        gains = torch.tensor([1.0, 0.95, 0.9], device=dev, dtype=dt)
        faded = gains[:, None, None, None] * data
        weights = InverseVarianceWeights(gain=1.0, readout_variance=1.0).from_data(faded)
        return admm.admm_deconvolve_timeseries(faded, psf, weights, config=cfg, mu_t=MU_T, bleach=gains)

    def channels(solve, config, **kw_):
        def run(dev, dt):
            _, data, psfs = channel_scene(vol, dev, dt)
            return solve(data, psfs, config=config, **kw_)
        return run

    def mixed(dev, dt):
        _, data, psfs, m = mixed_scene(vol, dev, dt)
        return admm.admm_deconvolve_multichannel(data, psfs, config=cfg, coupling="separate", mixing=m)

    def block(solve):
        def run(dev, dt):
            _, data, psfs, gains = block_scene(vol, dev, dt)
            return solve(data, psfs, config=cfg, mu_t=MU_T, bleach=gains, coupling="separate")
        return run

    def fine(solve):
        def run(dev, dt):
            data, psf_fine, _, _ = superres_scene((16, 32, 32), SR_FACTOR, dev, dt)
            return solve(data, psf_fine, SR_FACTOR, config=sr_cfg)
        return run

    tv, admm_all, rhs = (True, False, False), (True, True, True), (False, False, True)
    return {
        "deconvolve_timeseries": ("vmlmb", tv, series(timeseries.deconvolve_timeseries)),
        "admm_deconvolve_timeseries": ("admm", admm_all, series(admm.admm_deconvolve_timeseries)),
        "admm_deconvolve_timeseries weighted with bleach": ("admm", admm_all, weighted_series),
        "deconvolve_multichannel joint": ("vmlmb", (False,) * 3, channels(multichannel.deconvolve_multichannel,
                                                                           joint)),
        "deconvolve_multichannel separate": ("vmlmb", tv, channels(
            multichannel.deconvolve_multichannel, separate, coupling="separate")),
        "admm_deconvolve_multichannel joint": ("admm", rhs, channels(admm.admm_deconvolve_multichannel, joint)),
        "admm_deconvolve_multichannel with mixing": ("admm", admm_all, mixed),
        "deconvolve_timeseries_multichannel": ("vmlmb", tv, block(multichannel.deconvolve_timeseries_multichannel)),
        "admm_deconvolve_timeseries_multichannel": ("admm", admm_all, block(
            admm.admm_deconvolve_timeseries_multichannel)),
        "deconvolve_superres": ("vmlmb", tv, fine(superres.deconvolve_superres)),
        "admm_deconvolve_superres": ("admm", admm_all, fine(superres.admm_deconvolve_superres)),
    }


def joint_parity_gaps(r32, r64, engine: str) -> dict:
    """The float32 run's gaps to the float64 one, against phase 4's bounds:
    VMLMB f over the first 4 iterates (1e-4 relative) and the final f (1e-3);
    ADMM f_history (1e-4) and x (1e-3 relative L2). Returns name -> (gap,
    bound)."""
    if engine == "vmlmb":
        f4 = np.max(np.abs(r32.f_history[:4] - r64.f_history[:4]) / np.abs(r64.f_history[:4]))
        return {"f_history[:4]": (float(f4), 1e-4), "final f": (abs(float(r32.f) / float(r64.f) - 1.0), 1e-3)}
    fh = np.max(np.abs(r32.f_history - r64.f_history) / np.abs(r64.f_history))
    return {"f_history": (float(fh), 1e-4), "x": (_rel_l2(r32.x, r64.x), 1e-3)}


def phase4_joint() -> None:
    """The joint solvers, card float32 (kernels) against CPU float64 (plain
    versions), :func:`joint_parity_solves` to :func:`joint_parity_gaps`'
    bounds; the card runs launch their kernels (the batched or single TV, the
    rhs, the split update except under the joint TV) and the CPU runs none."""
    from microtipi_tpu_torch.ops.kernels import admm_split as ak
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

    for name, (engine, kernels, solve) in joint_parity_solves().items():
        out = {}
        for dev, dt in ((torch.device("cuda"), torch.float32), (torch.device("cpu"), torch.float64)):
            hv.launches = hv.batched_launches = ak.split_launches = ak.rhs_launches = 0
            res = solve(dev, dt)
            out[dev.type] = res, (hv.launches + hv.batched_launches, ak.split_launches, ak.rhs_launches)
        (r32, n32), (r64, n64) = out["cuda"], out["cpu"]
        gaps = joint_parity_gaps(r32, r64, engine)
        if any(g > b for g, b in gaps.values()) or tuple(n > 0 for n in n32) != kernels or n64 != (0, 0, 0):
            raise AssertionError(f"{name} card/CPU parity: {gaps}, kernel launches (TV, split, rhs) cuda {n32}, "
                                 f"cpu {n64}")
        log(4, f"{name} card float32 vs CPU float64, 10 iterations: "
               + ", ".join(f"{k} {g:.3g} (< {b:g})" for k, (g, b) in gaps.items())
               + f"; card launches (TV, split update, rhs) {n32}")


# Phases 23-27: the batched and tiled blind loops, PSF estimation, SIM and ISM, and the image ops, with the bench
# optics (OPTICS, NA 1.4, 561 nm, 80/200 nm), float32 on the card.
BLIND_FRAMES = 4  # phase 23's frames of LANE_SHAPE: phase 7's batch
STATS_CUT = (64, 256, 256)  # phase 24's float64 exactness check of the streamed statistics
STATS_CUT_PSF, STATS_CUT_TILE = (32, 64, 64), (32, 128, 128)
SIM_CAMERA, SIM3D_VOL = (512, 512), (32, 256, 256)
ISM_VOL, ISM_RINGS = (64, 256, 256), 2
OPS_VOL = JOINT_VOL  # phase 27's preprocessing volume, 64x512x512
DESKEW_VOL, DESKEW_ANGLE = (64, 256, 256), 31.8


def _blind_cfg(engine: str = "vmlmb"):
    """Phase 23's loop: three rounds of 20 object iterations, a joint
    defocus+phase fit of 5 (ADMM: the recommended recipe, as phase 11)."""
    from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
    from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig
    from microtipi_tpu_torch.models.microscope import DEFOCUS, PHASE

    kw = dict(loops=3, families=(DEFOCUS, PHASE), psf_max_iter=(5, 5),
              deconv=DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=20, grtol=0.0, gatol=0.0),
              fit=PsfFitConfig(grtol=0.0))
    if engine == "admm":
        return BlindDeconvConfig.recommended(deconv_engine="admm", **kw)
    return BlindDeconvConfig(joint_fit=True, **kw)


def _lanes_vs_single(name: str, res, data, model, cfg) -> str:
    """Each lane of a per-frame batched blind run against ``blind_deconvolve``
    of its frame on the card: the first round's object-step cost to phase 4's
    float32 bound on a final f (1e-3 relative); the later rounds and the
    phase reported, and the same with the batch's FFTs taken lane by lane
    (what is left then is the lane sums' order: a lane's cost sums over the
    batch's axes, and a line search that compares costs may step otherwise)."""
    from microtipi_tpu_torch.jobs.batch import batched_blind_deconvolve
    from microtipi_tpu_torch.jobs.blind import blind_deconvolve

    singles = [blind_deconvolve(data[b], model, config=cfg) for b in range(data.shape[0])]

    def gaps(r):
        f = [np.abs(r.deconv_f[b] - s.deconv_f) / np.abs(s.deconv_f) for b, s in enumerate(singles)]
        x = max(_err(r.obj[b], s.obj) for b, s in enumerate(singles))
        phase = max(float(torch.linalg.norm(r.params.phase[b] - s.params.phase)) for b, s in enumerate(singles))
        return max(float(g[0]) for g in f), max(float(g.max()) for g in f), x, phase

    first, rounds, x, phase = gaps(res)
    with _per_lane_fft():
        split = gaps(batched_blind_deconvolve(data, model, config=cfg))
    if first > 1e-3:
        raise AssertionError(f"{name}: lanes against blind_deconvolve: first round's f {first:.3g} rel (< 1e-3)")
    return (f"each lane against blind_deconvolve of its frame: round 1's f {first:.3g} rel (< 1e-3), every round's "
            f"f {rounds:.3g} rel, object {x:.3g} relative L2, phase {phase:.3g} L2 apart; with the batch's FFTs "
            f"taken lane by lane {split[0]:.3g}, {split[1]:.3g}, {split[2]:.3g} and {split[3]:.3g}")


def phase23_batched_blind(card: str) -> dict:
    """``batched_blind_deconvolve`` of BLIND_FRAMES bench scenes of LANE_SHAPE
    blurred by the bench phase (BENCH_PHASE), three rounds of 20 object
    iterations and a joint defocus+phase fit of 5: per frame by VMLMB (one
    lockstep ``batched_deconvolve`` a round, one batched TV launch a step)
    and by ADMM (the recommended recipe), and with ``joint_psf=True`` (one
    VMLMB over the stack with one PSF, one fit over the sum of the frames'
    data terms). Each per-frame lane against its own ``blind_deconvolve``
    (:func:`_lanes_vs_single`); deconv_f falls each round on the VMLMB runs;
    the joint fit's phase error to the truth. Returns the kernels' launches
    on these paths."""
    from microtipi_tpu_torch.jobs import batch as batch_mod
    from microtipi_tpu_torch.jobs import deconv as deconv_mod
    from microtipi_tpu_torch.jobs.batch import batched_blind_deconvolve
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

    dev = torch.device("cuda")
    scenes = [bench_scene(LANE_SHAPE, dev, torch.float32, phase=BENCH_PHASE, seed=s) for s in range(BLIND_FRAMES)]
    model, data = scenes[0][0], torch.stack([d for _, d, _ in scenes])
    nvox = float(np.prod(LANE_SHAPE))
    start_err = _phase_err(model.init_params(), BENCH_PHASE)
    launches = {}
    out = {}
    for name, joint in (("per frame", False), ("joint PSF", True)):
        cfg = _blind_cfg()
        batched_blind_deconvolve(data, model, config=dataclasses.replace(cfg, loops=1), joint_psf=joint)  # warm-up
        hv.launches = hv.batched_launches = hv.unaligned_launches = 0
        torch.cuda.reset_peak_memory_stats()
        with _counted_solves(batch_mod) as solves, _counted_solves(deconv_mod) as cont:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = batched_blind_deconvolve(data, model, config=cfg, joint_psf=joint)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        calls = sum(c for c, _ in solves) + sum(c for c, _ in cont)
        _check_object(f"batched_blind_deconvolve ({name})", res.obj)
        df = res.deconv_f if joint else res.deconv_f.T
        if not (np.isfinite(df).all() and np.all(np.diff(df, axis=0) < 0)):
            raise AssertionError(f"batched_blind_deconvolve ({name}): deconv_f does not fall each round: {df}")
        if (hv.launches, hv.unaligned_launches) != (0, 0) or hv.batched_launches != calls or calls == 0:
            raise AssertionError(f"batched_blind_deconvolve ({name}): batched TV launches {hv.batched_launches} for "
                                 f"{calls} lockstep objective calls, single {hv.launches}, unaligned "
                                 f"{hv.unaligned_launches}")
        iters = int(np.sum(res.deconv_iters)) * (BLIND_FRAMES if joint else 1)
        errs = [_phase_err(res.params._replace(phase=p), BENCH_PHASE) for p in
                (res.params.phase[None] if joint else res.params.phase)]
        launches[name] = hv.batched_launches
        out[name] = errs
        log(23, f"[{card}] batched_blind_deconvolve {BLIND_FRAMES} x {LANE_SHAPE} ({name}), 3 rounds of 20 "
                f"iterations, joint defocus+phase fits of 5: deconv_f {np.round(res.deconv_f, 3).tolist()}, object "
                f"iterations {res.deconv_iters.tolist()}, phase error to the truth {[round(e, 4) for e in errs]} "
                f"(start {start_err:.4f}), wall {wall:.3f} s (1 run after a 1-round warm-up), "
                f"{nvox * iters / wall / 1e6:.1f} Mvox*obj_iter/s, batched TV launches {hv.batched_launches} = the "
                f"lockstep objective calls (single 0), peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        if not joint:
            log(23, _lanes_vs_single("batched_blind_deconvolve (per frame)", res, data, model, cfg))
    if not np.isfinite(out["joint PSF"][0]):
        raise AssertionError(f"joint PSF fit: phase error {out['joint PSF']}")
    log(23, f"the joint PSF fit (one optical system, {BLIND_FRAMES} frames) ends {out['joint PSF'][0]:.4f} from the "
            f"true phase against the per-frame fits' {np.round(out['per frame'], 4).tolist()} (start {start_err:.4f})")

    cfg = _blind_cfg("admm")
    batched_blind_deconvolve(data, model, config=dataclasses.replace(cfg, loops=1, mu_schedule=cfg.mu_schedule[:1]))
    torch.cuda.reset_peak_memory_stats()
    with AdmmCounts() as c:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = batched_blind_deconvolve(data, model, config=cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _check_object("batched_blind_deconvolve (admm)", res.obj)
    if not (np.isfinite(res.deconv_f).all() and np.isnan(res.fit_f[:, -1]).all()):
        raise AssertionError(f"batched_blind_deconvolve (admm): deconv_f {res.deconv_f}, fit_f {res.fit_f}")
    counted = c.check("batched_blind_deconvolve (admm)", 3 * 20, 3 * 2)
    errs = [_phase_err(res.params._replace(phase=p), BENCH_PHASE) for p in res.params.phase]
    log(23, f"[{card}] batched_blind_deconvolve {BLIND_FRAMES} x {LANE_SHAPE} per frame by ADMM (recommended recipe: "
            f"wiener start, mu {[round(m, 4) for m in cfg.mu_schedule]}): deconv_f "
            f"{np.round(res.deconv_f, 3).tolist()}, phase error {[round(e, 4) for e in errs]}, wall {wall:.3f} s "
            f"(1 run after a 1-round warm-up), {nvox * BLIND_FRAMES * 60 / wall / 1e6:.1f} Mvox*obj_iter/s, {counted}, "
            f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(23, _lanes_vs_single("batched_blind_deconvolve (admm)", res, data, model, cfg))
    return {"tv_batched": launches, "split": c.split, "rhs": c.rhs}


def phase24_tiled_blind(card: str, volume: np.ndarray) -> int:
    """``blind_deconvolve_tiled`` on phase 8's VOLUME (in focus, PSF of
    :func:`design_psf`) with TILE, OVERLAP and MAX_BATCH, the PSF model at
    PSF_SHAPE starting from the bench phase: three rounds of 10 VMLMB
    iterations and phase fits of 5 with Z4 pinned on the streamed statistics
    (cores of 128^3). Joint defocus+phase fits drift away from the truth
    here (0.1375 -> 0.3287 -> 0.6377 over modes 1-5 with Z4 pinned, 0.9232
    at 20 iterations a round, on an NVIDIA H100 80GB HBM3 at 700 W), and
    even the phase fits end a little above their second round (0.0599 ->
    0.0743): the phase error must end below three quarters of the start's,
    and each round's fit cost below the last. The object-step, host-gather,
    statistics-pass and fit walls are timed apart by wrapping the module's
    functions. Then the streamed
    statistics of a STATS_CUT cut, float64 on the card, against the dense
    circulant objective at 1e-10. Returns the batched TV launches."""
    from microtipi_tpu_torch.jobs import tiled_blind
    from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
    from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig
    from microtipi_tpu_torch.models.microscope import PHASE
    from microtipi_tpu_torch.models.widefield import WideFieldConfig, WideFieldModel
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv
    from microtipi_tpu_torch.utils.arrays import pad_fft_kernel

    dev = torch.device("cuda")
    model = WideFieldModel(WideFieldConfig(shape=PSF_SHAPE, dtype=torch.float32, **OPTICS), dev)
    params0 = _with_phase(model, BENCH_PHASE)
    freeze = 1
    cfg = BlindDeconvConfig(loops=3, families=(PHASE,), psf_max_iter=(5,), phase_freeze_head=freeze,
                            deconv=DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=10, grtol=0.0, gatol=0.0),
                            fit=PsfFitConfig(grtol=0.0))
    walls = {"object step": [], "host gather": [], "stats pass": [], "fit": []}
    fits = []
    names = ("tiled_deconvolve", "_gather_blocks", "streamed_fit_stats", "fit_psf_streamed")
    saved = {n: getattr(tiled_blind, n) for n in names}

    def timed(name, key, record=None):
        host = key == "host gather"  # host NumPy only: the card's last batch may still run meanwhile

        def run(*a, **kw):
            if not host:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = saved[name](*a, **kw)
            if not host:
                torch.cuda.synchronize()
            walls[key].append(time.perf_counter() - t0)
            if record is not None:
                record.append(res)
            return res

        return run

    for n, key, rec in zip(names, walls, (None, None, None, fits)):
        setattr(tiled_blind, n, timed(n, key, rec))
    hv.launches = hv.batched_launches = hv.unaligned_launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        obj, params, psf, df, ff = tiled_blind.blind_deconvolve_tiled(
            volume, model, cfg, params0=params0, tile=TILE, overlap=OVERLAP, max_batch=MAX_BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for n, fn in saved.items():
            setattr(tiled_blind, n, fn)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # The error to the truth (phase 0) over the modes the fit moves: a pinned Z4 stays at the start.
    errs = [float(torch.linalg.norm(p.phase[freeze:].double().cpu())) for p in [params0] + [f[0] for f in fits]]
    gather = sum(walls["host gather"])
    card_share = sum(walls["stats pass"]) - gather
    log(24, f"[{card}] blind_deconvolve_tiled {VOLUME} float32, tile {TILE}, overlap {OVERLAP}, max_batch "
            f"{MAX_BATCH}, PSF support {PSF_SHAPE}, 3 rounds of 10 iterations, phase fits of 5 (Z4 pinned) on "
            f"the streamed statistics (float64 on the card): phase error to the truth by round (modes 1-5) "
            f"{[round(e, 4) for e in errs]}, fit_f {[float(f) for f in ff]}, wall {wall:.3f} s (1 run): object steps "
            f"{[round(w, 3) for w in walls['object step']]} s, statistics passes "
            f"{[round(w, 3) for w in walls['stats pass']]} s of which host gather {gather:.3f} s and the card's "
            f"share {card_share:.3f} s, fits {[round(w, 3) for w in walls['fit']]} s; batched TV launches "
            f"{hv.batched_launches}; peak device memory {peak:.3f} GiB")
    if obj.shape != VOLUME or not np.isfinite(obj).all() or obj.min() < 0 or not np.isnan(ff[-1]) or len(fits) != 2:
        raise AssertionError(f"blind_deconvolve_tiled: object {obj.shape}, fit_f {ff}, fits {len(fits)}")
    if not (errs[-1] < 0.75 * errs[0] and ff[1] < ff[0]):
        raise AssertionError(f"blind_deconvolve_tiled: the phase error to the truth (0) by round {errs} (must end "
                             f"below three quarters of the start's), fit_f {ff} (must fall)")
    if hv.batched_launches == 0 or hv.launches or hv.unaligned_launches:
        raise AssertionError(f"blind_deconvolve_tiled: batched TV {hv.batched_launches}, single {hv.launches}, "
                             f"unaligned {hv.unaligned_launches}")
    launches = hv.batched_launches

    cut = [np.ascontiguousarray(a[tuple(slice(n) for n in STATS_CUT)]).astype(np.float64) for a in (obj, volume)]
    model64 = WideFieldModel(WideFieldConfig(shape=STATS_CUT_PSF, dtype=torch.float64, **OPTICS), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = tiled_blind.streamed_fit_stats(cut[0], cut[1], STATS_CUT_PSF, tile=STATS_CUT_TILE)
    torch.cuda.synchronize()
    t_stats = time.perf_counter() - t0
    cost = tiled_blind.make_streamed_fit_cost(stats, model64)
    obj_hat = torch.fft.rfftn(torch.as_tensor(cut[0], device=dev))
    d = torch.as_tensor(cut[1], device=dev)
    worst = 0.0
    for ph in ([0.0] * 6, BENCH_PHASE, OTHER_PHASE):
        p = _with_phase(model64, ph)
        with torch.no_grad():
            r = torch.fft.irfftn(obj_hat * torch.fft.rfftn(pad_fft_kernel(model64.compute_psf(p), STATS_CUT)),
                                 s=STATS_CUT) - d
            dense, streamed = float(0.5 * torch.sum(r * r)), float(cost(p))
        worst = max(worst, abs(streamed - dense) / abs(dense))
    if worst > 1e-10:
        raise AssertionError(f"streamed statistics != dense circulant objective: {worst:.3g} relative")
    log(24, f"streamed statistics of a {STATS_CUT} cut (float64 on the card, cores {STATS_CUT_TILE}, support "
            f"{STATS_CUT_PSF}, {t_stats:.3f} s) against the dense circulant objective at 3 phases: {worst:.3g} "
            f"relative (< 1e-10)")
    return launches


def _gauge_err(phi, truth, mask, psi) -> float:
    """The relative L2 distance of two pupil maps over the support, each with
    the position gauges (piston, tip/tilt, psi) projected out."""
    from microtipi_tpu_torch.jobs.phase_retrieval import remove_position_gauges

    a = remove_position_gauges(phi.double(), mask.double(), psi.double())
    b = remove_position_gauges(truth.double(), mask.double(), psi.double())
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def phase25_estimation(card: str) -> None:
    """PSF estimation without a parametric fit. ``retrieve_pupil`` on phase
    20's averaged bead (4 beads of the left half, BEAD_PATCH): the
    gauge-fixed map error to the true pupil phase must fall below the
    start's. ``fit_psf_diversity`` on 2 defocus-diverse images (+-2e-7 m) of
    a LANE_SHAPE bench scene (Z4 pinned) with
    ``diversity_fit_uncertainty``'s error bars: the phase error to the truth
    must fall below the start's."""
    from microtipi_tpu_torch.jobs.diversity import (
        defocus_diversity, diversity_fit_uncertainty, diversity_psfs, fit_psf_diversity)
    from microtipi_tpu_torch.jobs.phase_retrieval import retrieve_pupil
    from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig, average_beads
    from microtipi_tpu_torch.models.microscope import PHASE
    from microtipi_tpu_torch.models.widefield import WideFieldConfig, WideFieldModel

    dev = torch.device("cuda")
    slide, _ = calibration_slide(dev)
    avg, used = average_beads(slide[:, :, :SLIDE_SPLIT], n_beads=4, patch=BEAD_PATCH)
    del slide
    model = bead_model(dev)
    with torch.no_grad():
        _, truth, psi, mask = model.compute_pupil(_with_phase(model, BENCH_PHASE))
        _, start, _, _ = model.compute_pupil(model.init_params())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = retrieve_pupil(model, avg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    err, err0 = _gauge_err(res.phi, truth, mask, psi), _gauge_err(start, truth, mask, psi)
    if not (np.isfinite(res.f) and err < err0 and bool(torch.isfinite(res.psf).all())):
        raise AssertionError(f"retrieve_pupil: f {res.f}, gauge-fixed map error {err:.4g} (start {err0:.4g})")
    log(25, f"[{card}] retrieve_pupil on the averaged bead ({used} beads, {BEAD_PATCH}), 30 Gerchberg-Saxton "
            f"rounds then VMLMB ({res.iterations} iterations, {res.evaluations} evaluations, status {res.status}): "
            f"gauge-fixed map error to the true pupil phase {err:.4f} against the start's {err0:.4f}, f "
            f"{float(res.f):.6g}, wall {wall:.3f} s (1 run)")

    dmodel = WideFieldModel(WideFieldConfig(shape=LANE_SHAPE, dtype=torch.float32, **OPTICS), dev)
    phases = defocus_diversity(dmodel, [-2e-7, 2e-7])
    obj = bead_objects(LANE_SHAPE, dev, torch.float32, seed=3)[0]
    with torch.no_grad():
        y = blur(obj[None].expand(2, *LANE_SHAPE), diversity_psfs(dmodel, _with_phase(dmodel, BENCH_PHASE), phases))
    # Noiseless float32 images and gamma 1e-8: a +-200 nm defocus pair barely constrains a 64-plane volume's
    # pupil, and 0.1% noise already stalls the fit at its start (float32 and float64 CPU runs at 32x128x128 and
    # 64x256x256); the module's own docstring advises gamma -> 1e-8 for noiseless data.
    cfg, gamma = PsfFitConfig(max_iter=60, grtol=0.0), 1e-8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit = fit_psf_diversity(dmodel, y, phases, (PHASE,), config=cfg, gamma=gamma)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    unc = diversity_fit_uncertainty(dmodel, fit.params, (PHASE,), y, phases, gamma=gamma)
    torch.cuda.synchronize()
    t_unc = time.perf_counter() - t0
    truth_free = torch.tensor(BENCH_PHASE[1:], dtype=torch.float64)
    err = float(torch.linalg.norm(fit.params.phase[1:].double().cpu() - truth_free))
    err0 = float(torch.linalg.norm(truth_free))
    std = unc.std["phase"].cpu()
    if not (np.isfinite(fit.f) and err < err0 and bool(torch.isfinite(std[1:]).all()) and torch.isnan(std[0])):
        raise AssertionError(f"fit_psf_diversity: f {fit.f}, phase error {err:.4g} (start {err0:.4g}), std {std}")
    log(25, f"[{card}] fit_psf_diversity 2 x {LANE_SHAPE} (defocus +-2e-7 m, noiseless float32, gamma {gamma:g}, "
            f"Z4 pinned), {fit.iterations} iterations, {fit.evaluations} evaluations, status {fit.status}: phase {np.round(fit.params.phase.cpu().numpy(), 4).tolist()} against the truth "
            f"{BENCH_PHASE}, error {err:.4f} (free modes; the start's {err0:.4f}), error bars "
            f"{np.round(std.numpy(), 5).tolist()} (sigma {float(unc.sigma):.4g}), walls: fit {t_fit:.3f} s, error "
            f"bars {t_unc:.3f} s (1 run each)")


def _sim_patterns(n_angles, n_phases, k, offsets):
    a_k = np.stack([[k * np.sin(t), k * np.cos(t)] for t in np.pi / n_angles * np.arange(n_angles)])
    return a_k, np.tile(2 * np.pi / n_phases * np.arange(n_phases), (n_angles, 1)) + np.asarray(offsets)[:, None]


def phase26_sim_ism(card: str) -> None:
    """2D SIM, 3 angles x 3 phases at SIM_CAMERA^2 onto twice that:
    ``estimate_sim_pattern`` from a start 0.3 bins off, then
    ``reconstruct_sim`` from the estimate against the truth-driven one; 3D
    SIM, 3 angles x 5 phases at SIM3D_VOL (physical three-beam pattern), the
    bands against the exact ones and ``reconstruct_sim3d``; ISM with 1 +
    3*ISM_RINGS*(ISM_RINGS + 1) elements at ISM_VOL: ``ism_element_gains``
    against the planted gains, ``ism_reassign`` against the object through
    the reassigned PSF, and 50 iterations of ``ism_richardson_lucy``."""
    from microtipi_tpu_torch.jobs import ism, sim
    from microtipi_tpu_torch.models import ISMConfig, ISMModel
    from microtipi_tpu_torch.models.widefield import WideFieldConfig, WideFieldModel

    dev = torch.device("cuda")
    ny, nx = SIM_CAMERA
    m2 = WideFieldModel(WideFieldConfig(shape=(1, ny, nx), dtype=torch.float64, **OPTICS), dev)
    with torch.no_grad():
        h = m2.compute_psf(m2.init_params())[0]
        otf = torch.fft.fft2((h / h.sum()).to(torch.complex64))
    k = 0.8 * 2 * OPTICS["na"] / OPTICS["wavelength"] * OPTICS["dxy"]
    a_k, ph = _sim_patterns(3, 3, k, [0.0, 0.0, 0.0])
    true_k = a_k + np.array([[0.3 / ny, -0.3 / nx]] * 3)
    true_ph = ph + np.array([[0.5], [-0.3], [0.2]])
    obj, _ = bead_objects((1, ny, nx), dev, torch.float32, seed=7)
    x = obj[0] * 10.0
    data = sim.simulate_sim(x, otf, true_k, true_ph, modulation=0.9)
    data = with_noise(data, 0.002 * float(data.max()), np.random.default_rng(26))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est_k, est_ph = sim.estimate_sim_pattern(data, otf, a_k, ph, modulation=0.9)
    torch.cuda.synchronize()
    t_est = time.perf_counter() - t0
    k_err = float(np.max(np.abs(est_k - true_k) * np.array([ny, nx])))
    k_err0 = float(np.max(np.abs(a_k - true_k) * np.array([ny, nx])))
    ph_err = float(np.max(np.abs((est_ph - ph)[:, 0] - np.array([0.5, -0.3, 0.2]))))
    t0 = time.perf_counter()
    rec = sim.reconstruct_sim(data, otf, est_k, est_ph, modulation=0.9, wiener=1e-3)
    torch.cuda.synchronize()
    t_rec = time.perf_counter() - t0
    ref = sim.reconstruct_sim(data, otf, true_k, true_ph, modulation=0.9, wiener=1e-3)
    rel = _err(rec.x, ref.x)
    # On this bead scene the estimator lands within a few hundredths of a bin (0.052 bins, 0.21 rad, 0.22 from
    # the truth-driven reconstruction in a float32 CPU run at 512^2): held at a third of the start's 0.3 bins.
    if not (k_err < 0.1 and ph_err < 0.3 and rel < 0.3 and tuple(rec.x.shape) == (2 * ny, 2 * nx)):
        raise AssertionError(f"SIM 2D: frequency error {k_err:.3g} bins, phase {ph_err:.3g} rad, reconstruction "
                             f"{rel:.3g} from the truth-driven one")
    log(26, f"[{card}] SIM 2D, 3 x 3 at {SIM_CAMERA} (float32, noise 0.2%): estimate_sim_pattern from 0.3 bins off "
            f"(float64 on the card, {t_est:.3f} s): frequency error {k_err:.4f} bins (< 0.1; the start's {k_err0:.4f}), "
            f"phase {ph_err:.4f} rad (< 0.3); reconstruct_sim onto {tuple(rec.x.shape)} ({t_rec:.3f} s): {rel:.4f} "
            f"relative L2 from the truth-driven reconstruction (< 0.3)")

    nz, ny3, nx3 = SIM3D_VOL
    m3 = WideFieldModel(WideFieldConfig(shape=SIM3D_VOL, dtype=torch.float32, **OPTICS), dev)
    with torch.no_grad():
        h3 = m3.compute_psf(m3.init_params())
        h3 = h3 / h3.sum()
    p = OPTICS["na"] / OPTICS["wavelength"] * OPTICS["dxy"]
    q = OPTICS["ni"] * (1.0 - np.sqrt(1.0 - (OPTICS["na"] / OPTICS["ni"]) ** 2)) / OPTICS["wavelength"] * OPTICS["dz"]
    a3, ph3 = _sim_patterns(3, 5, p, [0.0, 0.4, -0.7])
    x3 = bead_objects(SIM3D_VOL, dev, torch.float32, seed=8)[0] * 10.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data3 = sim.simulate_sim3d(x3, h3, a3, ph3, q=q)
    torch.cuda.synchronize()
    t_sim3 = time.perf_counter() - t0
    bands = sim.separate_bands_3d(data3, ph3)
    otfs = sim.sim3d_order_otfs(h3, q)
    worst = 0.0
    for a in range(3):
        ramp = sim._phase_ramp((ny3, nx3), a3[a], torch.float32, dev)[None]
        for i, m in enumerate(sim.ORDERS_3D):
            xm = x3 * (ramp ** m if m >= 0 else torch.conj(ramp) ** (-m))
            want = otfs[i] * torch.fft.fftn(xm.to(torch.complex64))
            worst = max(worst, float(torch.linalg.norm(bands[a, i] - want) / torch.linalg.norm(want)))
    del bands, otfs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec3 = sim.reconstruct_sim3d(data3, h3, a3, ph3, q=q, wiener=1e-3)
    torch.cuda.synchronize()
    t_rec3 = time.perf_counter() - t0
    if worst > 1e-4 or not bool(torch.isfinite(rec3.x).all()) or tuple(rec3.x.shape) != (2 * nz, 2 * ny3, 2 * nx3):
        raise AssertionError(f"SIM 3D: bands {worst:.3g} from the exact ones, reconstruction {tuple(rec3.x.shape)}")
    log(26, f"[{card}] SIM 3D, 3 x 5 at {SIM3D_VOL} (p {p:.4f} cycles/px, q {q:.4f} cycles/plane): simulate_sim3d "
            f"{t_sim3:.3f} s; separate_bands_3d {worst:.3g} relative L2 from the exact bands O_m S(k - m p) (< 1e-4, "
            f"float32); reconstruct_sim3d onto {tuple(rec3.x.shape)} {t_rec3:.3f} s (1 run), peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del data3, rec3

    icfg = ISMConfig(shape=ISM_VOL, na=OPTICS["na"], wavelength=OPTICS["wavelength"], wavelength_exc=488e-9,
                     ni=OPTICS["ni"], dxy=OPTICS["dxy"], dz=OPTICS["dz"], n_phase=6, dtype=torch.float32,
                     element_pitch=0.5 * OPTICS["dxy"], rings=ISM_RINGS, pinhole=0.0)
    imodel = ISMModel(icfg, dev)
    kel = icfg.n_elements
    params = _with_phase(imodel, BENCH_PHASE)
    xo = bead_objects(ISM_VOL, dev, torch.float32, seed=9)[0]
    gains = torch.as_tensor(np.random.default_rng(26).uniform(0.8, 1.2, kel), dtype=torch.float32, device=dev)
    with torch.no_grad():
        psfs = imodel.compute_psfs(params)
        clean = blur(xo[None].expand(kel, *ISM_VOL), psfs) * gains[:, None, None, None]
        reassigned_truth = blur(xo, imodel.compute_psf(params))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = ism.ism_element_gains(imodel, params, clean)
    img = ism.ism_reassign(imodel, clean, gains=g)
    torch.cuda.synchronize()
    t_ra = time.perf_counter() - t0
    g_err = float(torch.max(torch.abs(g - gains / gains.mean())))
    ra_err = _err(img / img.sum(), reassigned_truth / reassigned_truth.sum())
    t0 = time.perf_counter()
    rl = ism.ism_richardson_lucy(imodel, params, clean, iterations=50, gains=g)
    torch.cuda.synchronize()
    t_rl = time.perf_counter() - t0
    rl_err, d_err = _err(rl, xo), _err(clean.mean(0) / clean.mean(0).sum() * xo.sum(), xo)
    if not (g_err < 1e-3 and ra_err < 1e-2 and rl_err < d_err and float(rl.min()) >= 0):
        raise AssertionError(f"ISM: gains {g_err:.3g}, reassignment {ra_err:.3g}, RL {rl_err:.3g} (data {d_err:.3g})")
    log(26, f"[{card}] ISM {kel} elements (rings {ISM_RINGS}) of {ISM_VOL}, noiseless: ism_element_gains {g_err:.3g} "
            f"from the planted gains (< 1e-3), ism_reassign {ra_err:.3g} relative L2 from the object through "
            f"ISMModel.compute_psf (< 1e-2), {t_ra:.3f} s together; ism_richardson_lucy 50 iterations "
            f"{t_rl:.3f} s: {rl_err:.4f} from the object against the element mean's {d_err:.4f}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")


def phase27_image_ops(card: str) -> None:
    """The image ops at full size: ``register_timeseries`` of phase 22's
    series (SERIES_T x JOINT_VOL) drifted by known subvoxel shifts; the FSC of
    two solves of 256^3 half data (two noise draws of phase 3's scene);
    ``strehl_ratio`` of the bench phase for the wide-field and the confocal
    model at 256^3 and ``strehl_ratio_from_pupil`` of its pupil; ``deskew``
    of DESKEW_VOL at DESKEW_ANGLE, a tilted line of beads that must come out
    straight; and on
    OPS_VOL destriping, bleach gains, hot pixels and background subtraction,
    each against its planted truth."""
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, deconvolve
    from microtipi_tpu_torch.models import ConfocalConfig, ConfocalModel
    from microtipi_tpu_torch.models.widefield import WideFieldConfig, WideFieldModel
    from microtipi_tpu_torch.ops import geometry, metrics, preprocess, register
    from microtipi_tpu_torch.utils.arrays import median

    dev = torch.device("cuda")
    _, data, _, _ = series_scene(JOINT_VOL, SERIES_T, dev, torch.float32)
    drift = np.cumsum(np.random.default_rng(27).uniform(-1.5, 1.5, (SERIES_T, 3)), axis=0)
    drift[0] = 0.0
    with torch.no_grad():
        moved = torch.stack([register.fourier_shift(data[t], -drift[t]) for t in range(SERIES_T)])
    del data
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reg, shifts = register.register_timeseries(moved)
    torch.cuda.synchronize()
    t_reg = time.perf_counter() - t0
    s_err = float(np.max(np.abs(shifts.cpu().numpy() - drift)))
    # The cross-correlation's parabolic vertex is biased by up to ~0.1 voxel a pair on these 0.5 um beads (a CPU
    # run at 64x256x256), and the shifts add up over the pairs: held at 0.5 voxel of cumulated drift.
    if not (s_err < 0.5 and bool(torch.isfinite(reg).all())):
        raise AssertionError(f"register_timeseries: shifts {s_err:.3g} voxels from the planted drift")
    log(27, f"[{card}] register_timeseries {SERIES_T} x {JOINT_VOL} (phase 22's series, drifts up to "
            f"{np.abs(drift).max():.2f} voxels): shifts {s_err:.4f} voxels from the planted ones (< 0.5 cumulated "
            f"over {SERIES_T - 1} pairs), {t_reg:.3f} s "
            f"(1 run), peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del moved, reg

    cfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=20, grtol=0.0, gatol=0.0)
    _, _, psf = bench_scene(SHAPE, dev, torch.float32)
    clean = blur(bead_objects(SHAPE, dev, torch.float32)[0], psf)
    halves = []
    for seed in (0, 1):  # two acquisitions of one scene: independent 1% noise
        noise = torch.randn(SHAPE, device=dev, generator=torch.Generator(device=dev).manual_seed(100 + seed))
        halves.append(deconvolve(clean + 0.01 * clean.max() * noise, psf, config=cfg).x)
    del clean
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    freqs, fsc = metrics.fourier_shell_correlation(halves[0], halves[1],
                                                   spacing=(OPTICS["dz"], OPTICS["dxy"], OPTICS["dxy"]))
    torch.cuda.synchronize()
    t_fsc = time.perf_counter() - t0
    res_nm = metrics.fsc_resolution(freqs, fsc) * 1e9
    if not (np.isfinite(res_nm) and float(fsc[1]) > 0.9):
        raise AssertionError(f"FSC: resolution {res_nm} nm, curve {fsc.cpu().numpy()}")
    log(27, f"[{card}] fourier_shell_correlation of two 20-iteration solves of {SHAPE} (two noise draws): "
            f"resolution {res_nm:.1f} nm at 0.143, {len(fsc)} shells, {t_fsc:.4f} s")
    del halves

    wf = WideFieldModel(WideFieldConfig(shape=SHAPE, dtype=torch.float32, **OPTICS), dev)
    conf = ConfocalModel(ConfocalConfig(shape=SHAPE, wavelength_exc=488e-9, pinhole=0.0, dtype=torch.float32,
                                        **OPTICS), dev)
    s_wf = float(metrics.strehl_ratio(wf, _with_phase(wf, BENCH_PHASE)))
    s_conf = float(metrics.strehl_ratio(conf, _with_phase(conf, BENCH_PHASE)))
    with torch.no_grad():
        _, phi, _, _ = wf.compute_pupil(_with_phase(wf, BENCH_PHASE))
    s_pupil = float(metrics.strehl_ratio_from_pupil(wf, phi))
    if not (0 < s_wf < 1 and 0 < s_conf < 1 and abs(s_pupil - s_wf) < 1e-5):
        raise AssertionError(f"strehl_ratio: widefield {s_wf}, confocal {s_conf}, from the pupil {s_pupil}")
    log(27, f"[{card}] strehl_ratio of the bench phase at {SHAPE}: wide-field {s_wf:.6f}, confocal {s_conf:.6f}; "
            f"strehl_ratio_from_pupil of its pupil {s_pupil:.6f} (the same PSF)")
    del wf, conf

    nz, ny, nx = DESKEW_VOL
    shift, nx_out, _ = geometry.deskew_geometry(DESKEW_VOL, DESKEW_ANGLE, 2e-7, OPTICS["dxy"])
    x0 = nx - 16.0  # a line of Gaussian beads tilted as the stage scan records it: plane k at x0 - k * shift
    zz = torch.arange(nz, device=dev, dtype=torch.float32)[:, None, None]
    yy = torch.arange(ny, device=dev, dtype=torch.float32)[None, :, None]
    xx = torch.arange(nx, device=dev, dtype=torch.float32)[None, None, :]
    raw = sum(torch.exp(-((xx - (x0 - zz * shift)) ** 2 + (yy - y0) ** 2) / 8.0) for y0 in (ny / 4, ny / 2, 3 * ny / 4))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    back, dz_new = geometry.deskew(raw, DESKEW_ANGLE, 2e-7, OPTICS["dxy"])
    torch.cuda.synchronize()
    t_dsk = time.perf_counter() - t0
    xs = torch.arange(nx_out, device=dev, dtype=torch.float32)
    prof = torch.clamp_min(back.sum(dim=1), 0.0)  # (nz, nx_out)
    centroid = (prof * xs).sum(dim=1) / prof.sum(dim=1)
    c_err = float(torch.max(torch.abs(centroid - x0)))
    if tuple(back.shape) != (nz, ny, nx_out) or not c_err < 0.05:
        raise AssertionError(f"deskew: shape {tuple(back.shape)}, line centroids {c_err:.3g} px from x0")
    log(27, f"[{card}] deskew {DESKEW_VOL} at {DESKEW_ANGLE} deg (dz 200 nm): {shift:.3f} px a plane, onto "
            f"{tuple(back.shape)}, dz {dz_new * 1e9:.1f} nm, {t_dsk:.4f} s; a line of beads tilted by the scan comes "
            f"out straight: its plane centroids {c_err:.4f} px from x0 (< 0.05)")
    del raw, back

    clean = 100.0 + blur(bead_objects(OPS_VOL, dev, torch.float32, seed=5)[0] * 5.0, joint_psf(OPS_VOL, dev,
                                                                                              torch.float32))
    yy = torch.arange(OPS_VOL[1], device=dev, dtype=torch.float32)[:, None]
    stripes = 1.0 + 0.2 * torch.sin(2 * np.pi * yy / 16.0)  # shadows along x
    striped = clean * stripes
    t0 = time.perf_counter()
    fixed = preprocess.destripe(striped)
    torch.cuda.synchronize()
    t_str = time.perf_counter() - t0
    st_before, st_after = _err(striped, clean), _err(fixed, clean)
    fades = torch.tensor([1.0, 0.9, 0.8, 0.7], device=dev)
    series = clean[None, :16] * fades[:, None, None, None]
    t0 = time.perf_counter()
    gains = preprocess.estimate_bleach(series)
    torch.cuda.synchronize()
    t_bl = time.perf_counter() - t0
    b_err = float(torch.max(torch.abs(gains - fades)))
    hot = clean.clone()
    idx = torch.randint(0, clean.numel(), (1000,), device=dev, generator=torch.Generator(device=dev).manual_seed(9))
    hot.view(-1)[idx] += 5000.0
    t0 = time.perf_counter()
    cleaned = preprocess.remove_hot_pixels(hot)
    torch.cuda.synchronize()
    t_hot = time.perf_counter() - t0
    h_left = int((torch.abs(cleaned - clean) > 100.0).sum())
    ramp = 50.0 * torch.linspace(0.0, 1.0, OPS_VOL[2], device=dev)
    t0 = time.perf_counter()
    sub = preprocess.subtract_background(clean + ramp, radius=25)
    torch.cuda.synchronize()
    t_bg = time.perf_counter() - t0
    bg_spread = float(median(sub[:, ::8, ::8]))
    if not (st_after < 0.5 * st_before and b_err < 0.05 and h_left == 0 and bg_spread < 10.0):
        raise AssertionError(f"preprocess: destripe {st_before:.3g} -> {st_after:.3g}, bleach {b_err:.3g}, hot pixels "
                             f"left {h_left}, median after background subtraction {bg_spread:.3g}")
    log(27, f"[{card}] on {OPS_VOL}: destripe {t_str:.4f} s, error to the clean volume {st_before:.4f} -> "
            f"{st_after:.4f}; estimate_bleach of 4 x (16, 512, 512) {t_bl:.4f} s, {b_err:.4f} from the planted fade "
            f"(< 0.05); remove_hot_pixels of 1000 impulses {t_hot:.4f} s, {h_left} left; subtract_background "
            f"(radius 25) of a 0-50 ramp over a 100 pedestal {t_bg:.4f} s, median left {bg_spread:.3f} (< 10)")


IO_DXY, IO_DZ, IO_EMISSION = 80e-9, 200e-9, 561e-9  # the metadata phase 28 writes with the scene


def _host_io(label: str, run, nbytes: int):
    """Wall of one host-side file operation, with its rate over ``nbytes``."""
    t0 = time.perf_counter()
    out = run()
    wall = time.perf_counter() - t0
    return out, f"{label} {wall:.4f} s ({nbytes / 2**20 / wall:.1f} MiB/s)"


def phase28_file_to_file(card: str, functional_blind_wall: float) -> int:
    """The stack from file to restored file through the port at 256^3
    float32: the bench scene (phase 3's optics, blurred by the bench phase)
    written as OME-NGFF v2 with zlib and read back bit for bit with its
    metadata; ``api.DeconvolutionJob`` with the true PSF against
    ``deconvolve`` bit for bit, its ``get_model`` against ``convolve``;
    ``api.BlindDeconvJob`` (5 rounds, sequential defocus and phase fits of
    5, object steps of 20) with a ``WideFieldModel`` built from the metadata
    read back; abort from ``progress`` after one slice; the state through
    ``utils.checkpoint`` and the object back to NGFF, both bit for bit. The
    card's machine has no libtiff (``ROADMAP.md``), so the OME-TIFF half of
    the round trips and ``StackPrefetcher`` (TIFF only) are left to the CPU
    tests. Returns the TV kernel's launches on the path."""
    import tempfile

    from microtipi_tpu_torch import api
    from microtipi_tpu_torch.io import zarrstack
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, deconvolve
    from microtipi_tpu_torch.models.microscope import DEFOCUS, PHASE
    from microtipi_tpu_torch.ops.convolution import convolve, convolve_spectrum
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv
    from microtipi_tpu_torch.utils import checkpoint

    dev, nvox = torch.device("cuda"), float(np.prod(SHAPE))
    model, data_dev, _ = bench_scene(SHAPE, dev, torch.float32, phase=BENCH_PHASE)
    truth = bead_objects(SHAPE, dev, torch.float32)[0]
    with torch.no_grad():
        true_psf = model.compute_psf(model.init_params()._replace(
            phase=torch.as_tensor(BENCH_PHASE, dtype=torch.float32, device=dev)))
    scene = data_dev.cpu().numpy()
    nbytes = scene.nbytes
    channels = [{"name": "bench", "emission_wavelength": IO_EMISSION}]
    # Files go into a scratch directory inside the checkout, removed at the end.
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_io_", dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        path = os.path.join(tmp, "scene.zarr")
        _, w_line = _host_io("write", lambda: zarrstack.write_ngff_hyperstack(
            path, scene, dxy=IO_DXY, dz=IO_DZ, channels=channels, compressor="zlib", zarr_format=2), nbytes)
        (arr, meta), r_line = _host_io("read", lambda: zarrstack.read_ngff_hyperstack(path), nbytes)
        if arr.shape != (1, 1, *SHAPE) or not np.array_equal(arr[0, 0], scene):
            raise AssertionError(f"NGFF round trip: shape {arr.shape}, not bit-equal to what was written")
        emission = meta["channels"][0]["emission_wavelength"]
        read_back = (meta["dxy"], meta["dz"], emission)
        if not np.allclose(read_back, (IO_DXY, IO_DZ, IO_EMISSION), rtol=1e-12, atol=0.0):
            raise AssertionError(f"NGFF metadata read back as {read_back}")
        log(28, f"host IO (host CPU walls, not the card's) of the {nbytes / 2**20:.0f} MiB scene as OME-NGFF v2 "
                f"zlib level 1: {w_line}, {r_line}; bit-equal, dxy {meta['dxy']:.6g} m, dz {meta['dz']:.6g} m, "
                f"emission {emission:.6g} m read back (rtol 1e-12: stored in micrometres)")

        data = torch.as_tensor(arr[0, 0], device=dev)
        hv.launches = hv.batched_launches = hv.unaligned_launches = 0
        job = api.DeconvolutionJob(data, psf=true_psf, mu=0.01, epsilon=1.0, max_iter=20, grtol=0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x_api = job.deconv()
        torch.cuda.synchronize()
        t_api = time.perf_counter() - t0
        ref = deconvolve(data, true_psf, config=DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=20, grtol=0.0))
        if not torch.equal(x_api, ref.x) or job.get_cost() != float(ref.f):
            raise AssertionError(f"api.DeconvolutionJob != deconvolve: max |dx| "
                                 f"{float((x_api - ref.x).abs().max()):.3g}, f {job.get_cost()} vs {float(ref.f)}")
        with torch.no_grad():
            hx = convolve(x_api, convolve_spectrum(true_psf), SHAPE)
        if not torch.equal(job.get_model(), hx):
            raise AssertionError("api.DeconvolutionJob.get_model != convolve of its object")
        log(28, f"[{card}] api.DeconvolutionJob (true PSF, mu 0.01, epsilon 1, 20 iterations) == deconvolve bit for "
                f"bit (x and f {job.get_cost():.6g}), get_model == convolve bit for bit; {t_api:.4f} s")

        pupil = api.WideFieldModel(SHAPE, na=1.4, wavelength=emission, ni=1.518, dxy=meta["dxy"], dz=meta["dz"],
                                   n_phase=6, single=True)
        est = api.PSF_Estimation(pupil)
        est.set_data(data)
        dec = api.DeconvolutionJob(data, mu=0.01, epsilon=1.0, max_iter=20, grtol=0.0)
        rounds = []
        solve = dec.deconv

        def counted(obj=None):  # each round's object step: iterations, evaluations, cost
            x = solve(obj)
            rounds.append((dec._result.iterations, dec._result.evaluations, dec.get_cost()))
            return x

        dec.deconv = counted
        blind = api.BlindDeconvJob(5, [DEFOCUS, PHASE], [5, 5], est, dec)
        before = hv.launches
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x_blind = blind.blind_deconv(torch.clamp_min(data, 0.0))
        torch.cuda.synchronize()
        b_wall = time.perf_counter() - t0
        b_launches = hv.launches - before
        peak = torch.cuda.max_memory_allocated() / 2**30
        _check_object("api.BlindDeconvJob", x_blind)
        err_x, err_d = float(torch.linalg.norm(x_blind - truth)), float(torch.linalg.norm(data - truth))
        iters, evals = sum(r[0] for r in rounds), sum(r[1] for r in rounds)
        phase_err = float(np.linalg.norm(pupil.get_phase_coefs() - np.asarray(BENCH_PHASE)))
        if len(rounds) != 5 or not err_x < err_d or b_launches == 0:
            raise AssertionError(f"api.BlindDeconvJob: {len(rounds)} rounds, |x - truth| {err_x:.4g} against the "
                                 f"data's {err_d:.4g}, TV launches {b_launches}")
        log(28, f"[{card}] api.BlindDeconvJob {SHAPE} float32, 5 rounds of 20 object iterations and sequential "
                f"defocus then phase fits of 5 (the reference loop): wall {b_wall:.3f} s (1 run), "
                f"{nvox * iters / b_wall / 1e6:.1f} Mvox*obj_iter/s ({iters} object iterations), TV kernel launches "
                f"{b_launches} ({evals} object-step evaluations), get_cost by round "
                f"{[round(r[2], 4) for r in rounds]}, phase error to the truth {phase_err:.4f} (start "
                f"{float(np.linalg.norm(BENCH_PHASE)):.4f}), |x - truth| {err_x:.7g} < |data - truth| {err_d:.7g}, "
                f"peak device memory {peak:.3f} GiB; phase 3's functional blind_deconvolve (joint fits) took "
                f"{functional_blind_wall:.3f} s on the same scene: the schedules differ, so the walls are not a "
                "comparison of one loop")

        calls = []

        def aborting(done, f):
            calls.append((done, f))
            abort_job.abort()

        abort_job = api.DeconvolutionJob(data, psf=true_psf, mu=0.01, epsilon=1.0, max_iter=20, grtol=0.0,
                                         abort_check_iters=5, progress=aborting)
        abort_job.deconv()
        if abort_job._result.iterations > 5 or len(calls) != 1:
            raise AssertionError(f"abort: {abort_job._result.iterations} iterations, {len(calls)} callbacks")
        log(28, f"abort from progress after one slice of abort_check_iters=5: {abort_job._result.iterations} "
                f"iterations, {len(calls)} callback")

        state = os.path.join(tmp, "state.npz")
        checkpoint.save_state(state, x_blind, pupil.params, 5, cost=dec.get_cost())
        obj2, params2, rnd, extra = checkpoint.load_state(state)
        if not (torch.equal(obj2, x_blind) and all(torch.equal(a, b) for a, b in zip(params2, pupil.params))
                and rnd == 5 and float(extra["cost"]) == dec.get_cost() and obj2.device == x_blind.device):
            raise AssertionError("checkpoint round trip is not bit-equal")
        out_path = os.path.join(tmp, "restored.zarr")
        restored = x_blind.cpu().numpy()
        _, w_line = _host_io("write", lambda: zarrstack.write_ngff_hyperstack(
            out_path, restored, dxy=meta["dxy"], dz=meta["dz"], channels=channels, compressor="zlib"), nbytes)
        (back, _), r_line = _host_io("read", lambda: zarrstack.read_ngff_hyperstack(out_path), nbytes)
        if not np.array_equal(back[0, 0], restored):
            raise AssertionError("the restored object's NGFF round trip is not bit-equal")
        log(28, f"checkpoint save/load bit-equal (loaded onto the card); restored object to OME-NGFF and back "
                f"bit-equal (host CPU walls: {w_line}, {r_line})")
    if hv.batched_launches != 0 or hv.unaligned_launches != 0:
        raise AssertionError(f"phase 28 launched the batched kernel {hv.batched_launches} times, the unaligned "
                             f"instantiation {hv.unaligned_launches} times")
    return hv.launches


CLI_OPTICS = ["--na", "1.4", "--wavelength", "561e-9", "--ni", "1.518", "--n-phase", "6"]
# phase 3's 5-round loop as flags: joint defocus+phase fits of 5, object steps of 20
CLI_LOOP = ["--loops", "5", "--families", "defocus", "phase", "--psf-iters", "5", "--joint-fit", "--mu", "0.01",
            "--epsilon", "1", "--iters", "20", "--grtol", "0", "--gatol", "0"]
WATCH_FILES = 3


def _cli(argv) -> tuple[float, list[str]]:
    """``microtipi_tpu_torch.cli.main(argv)`` on the card, in this process
    (so the kernels' launch counts see it): its wall and printed lines."""
    import io

    from microtipi_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, buf.getvalue().splitlines()


def phase29_cli_serve(card: str) -> dict:
    """The command line and the watch-folder service at 256^3, through
    ``microtipi_tpu_torch.cli.main(argv)`` in process: ``blind`` on phase 3's
    blind scene stored as OME-NGFF, with phase 3's loop as flags, against
    ``jobs.blind.blind_deconvolve`` with the config the CLI built, bit for
    bit; the same with ``--deconv-engine admm``; ``--checkpoint`` for 3
    rounds stopped after round 1 (the save after it raises), then
    ``--resume``, against the uninterrupted 3-round checkpointed run, bit for
    bit; ``watch --method blind-once --max-files 3`` over three 256^3 NGFF
    stores written before it starts (the first calibrates, the others take
    the fixed-PSF path), every output finite and the metrics counting 3
    files; and ``python -m microtipi_tpu_torch doctor`` as a subprocess.
    Returns the kernels' launches on each path."""
    import tempfile

    from microtipi_tpu_torch.cli.blind import _blind_config
    from microtipi_tpu_torch.cli.parser import build_parser
    from microtipi_tpu_torch.cli.shared import _model, _resolve_geometry
    from microtipi_tpu_torch.io import zarrstack
    from microtipi_tpu_torch.jobs.blind import blind_deconvolve
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv
    from microtipi_tpu_torch.utils import checkpoint

    dev, nvox = torch.device("cuda"), float(np.prod(SHAPE))
    root = os.path.dirname(os.path.abspath(__file__))
    channels = [{"name": "bench", "emission_wavelength": IO_EMISSION}]
    launches = {}
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_cli_", dir=root) as tmp:
        scene = os.path.join(tmp, "scene.zarr")
        _, data, _ = bench_scene(SHAPE, dev, torch.float32, phase=BENCH_PHASE)
        zarrstack.write_ngff_hyperstack(scene, data.cpu().numpy(), dxy=IO_DXY, dz=IO_DZ, channels=channels,
                                        compressor="zlib")
        del data

        def blind_run(label, extra):
            out, report = os.path.join(tmp, f"{label}.zarr"), os.path.join(tmp, f"{label}.json")
            argv = ["blind", scene, "--out", out, "--report", report, *CLI_OPTICS, *CLI_LOOP, *extra]
            with AdmmCounts() as c:
                wall, lines = _cli(argv)
            with open(report) as fh:
                rep = json.load(fh)
            obj = zarrstack.read_ngff_hyperstack(out)[0][0, 0]
            if obj.shape != SHAPE or not np.isfinite(obj).all() or obj.min() < 0:
                raise AssertionError(f"blind {label}: output {obj.shape} not finite and non-negative")
            return argv, obj, rep, wall, c

        argv, obj, rep, wall, c = blind_run("vmlmb", [])
        args = build_parser().parse_args(argv)
        args.device = dev
        _resolve_geometry(args, scene, log=lambda *a: None)
        arr = zarrstack.read_ngff_hyperstack(scene)[0][0, 0]
        direct = blind_deconvolve(torch.as_tensor(arr, device=dev), _model(args, SHAPE),
                                  config=_blind_config(args, SHAPE))
        if not np.array_equal(obj, direct.obj.cpu().numpy()) or rep["deconv_f"] != direct.deconv_f.tolist():
            raise AssertionError(f"CLI blind != blind_deconvolve with the CLI's config: max |dx| "
                                 f"{float(np.max(np.abs(obj - direct.obj.cpu().numpy()))):.3g}")
        iters = int(sum(rep["deconv_iters"]))
        if c.tv == 0 or c.unaligned or c.tv_batched:
            raise AssertionError(f"CLI blind: TV launches {c.tv_single} single, {c.tv_batched} batched, "
                                 f"unaligned {c.unaligned}")
        launches["tv"] = {"CLI blind (phase 29)": c.tv_single}
        log(29, f"[{card}] CLI blind {SHAPE} from OME-NGFF (phase 3's loop as flags): wall {wall:.3f} s (1 run, "
                f"file read and write included), {nvox * iters / wall / 1e6:.1f} Mvox*obj_iter/s ({iters} object "
                f"iterations), deconv_f {[round(f, 4) for f in rep['deconv_f']]}, TV kernel launches {c.tv_single}; "
                f"== blind_deconvolve with the CLI's config bit for bit")

        _, obj, rep, wall, c = blind_run("admm", ["--deconv-engine", "admm"])
        iters = int(sum(rep["deconv_iters"]))
        # the ADMM engine's objective values go through the batched TV kernel (B = 1), as in phase 11
        if (c.split, c.rhs) != (iters, iters) or c.unaligned or not np.isfinite(rep["deconv_f"]).all():
            raise AssertionError(f"CLI blind admm: split {c.split}, rhs {c.rhs} for {iters} iterations, "
                                 f"unaligned {c.unaligned}, deconv_f {rep['deconv_f']}")
        launches["split"] = launches["rhs"] = iters
        launches["tv_batched"] = {"CLI blind --deconv-engine admm (phase 29)": c.tv_batched}
        log(29, f"[{card}] CLI blind --deconv-engine admm: wall {wall:.3f} s, {nvox * iters / wall / 1e6:.1f} "
                f"Mvox*obj_iter/s, deconv_f {[round(f, 4) for f in rep['deconv_f']]}, admm_split_update {c.split}, "
                f"admm_rhs {c.rhs}, TV {c.tv_single} single and {c.tv_batched} batched launches")

        three = [*CLI_OPTICS, *CLI_LOOP, "--loops", "3"]
        whole = ["blind", scene, *three, "--out", os.path.join(tmp, "whole.zarr"),
                 "--checkpoint", os.path.join(tmp, "whole.npz"), "--params-out", os.path.join(tmp, "whole.json")]
        cut = ["blind", scene, *three, "--out", os.path.join(tmp, "cut.zarr"),
               "--checkpoint", os.path.join(tmp, "cut.npz"), "--params-out", os.path.join(tmp, "cut.json")]

        class Preempted(Exception):
            pass

        save = checkpoint.save_state

        def save_then_stop(*a, **k):
            save(*a, **k)
            raise Preempted

        with AdmmCounts() as c:
            w_whole, _ = _cli(whole)
            checkpoint.save_state = save_then_stop
            try:
                _cli(cut)
                raise AssertionError("the preempted checkpointed run did not stop after round 1")
            except Preempted:
                pass
            finally:
                checkpoint.save_state = save
            at = checkpoint.load_state(os.path.join(tmp, "cut.npz"))[2]
            w_resume, lines = _cli([*cut, "--resume"])
        got, want = (zarrstack.read_ngff_hyperstack(os.path.join(tmp, f"{n}.zarr"))[0] for n in ("cut", "whole"))
        with open(os.path.join(tmp, "cut.json")) as a, open(os.path.join(tmp, "whole.json")) as b:
            same_params = json.load(a) == json.load(b)
        if at != 1 or not np.array_equal(got, want) or not same_params or c.tv_single == 0 or c.unaligned:
            raise AssertionError(f"checkpoint/resume: stopped at round {at}, objects equal "
                                 f"{np.array_equal(got, want)}, params equal {same_params}, TV {c.tv_single}")
        launches["tv"]["CLI blind --checkpoint / --resume (phase 29)"] = c.tv_single
        log(29, f"[{card}] CLI blind --checkpoint, 3 rounds: uninterrupted {w_whole:.3f} s; stopped after round 1, "
                f"then --resume ({[l for l in lines if l.startswith('resumed')][0]}) {w_resume:.3f} s: object and "
                f"params == the uninterrupted run bit for bit; TV launches {c.tv_single}")

        indir, outdir = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        os.makedirs(indir)
        t0 = time.perf_counter()
        for i in range(WATCH_FILES):
            _, d, _ = bench_scene(SHAPE, dev, torch.float32, phase=BENCH_PHASE, seed=10 + i)
            zarrstack.write_ngff_hyperstack(os.path.join(indir, f"s{i}.zarr"), d.cpu().numpy(), dxy=IO_DXY,
                                            dz=IO_DZ, channels=channels, compressor="zlib")
        setup = time.perf_counter() - t0
        metrics = os.path.join(tmp, "m.json")
        argv = ["watch", indir, outdir, "--method", "blind-once", "--max-files", str(WATCH_FILES), "--metrics",
                metrics, "--poll", "0.1", *CLI_OPTICS, "--loops", "5", "--psf-iters", "5", "--iters", "20"]
        with AdmmCounts() as c:
            wall, lines = _cli(argv)
        with open(metrics) as fh:
            snap = json.load(fh)
        outs = [zarrstack.read_ngff_hyperstack(os.path.join(outdir, f"s{i}.zarr"))[0] for i in range(WATCH_FILES)]
        walls = [float(m.group(1)) for m in (re.search(r"done in ([0-9.]+)s", l) for l in lines) if m]
        if (snap["processed"] != WATCH_FILES or len(walls) != WATCH_FILES or c.tv_single == 0 or c.unaligned
                or not all(o.shape == (1, 1, *SHAPE) and np.isfinite(o).all() for o in outs)
                or sum("calibrated pupil from first file" in l for l in lines) != 1):
            raise AssertionError(f"watch: metrics {snap}, walls {walls}, TV {c.tv_single}, lines {lines[-6:]}")
        launches["tv"]["watch --method blind-once (phase 29)"] = c.tv_single
        log(29, f"[{card}] watch --method blind-once over {WATCH_FILES} NGFF stores of {SHAPE} (written in "
                f"{setup:.2f} s before it started): wall {wall:.3f} s, per-file walls {walls} s (decode, solve, "
                f"atomic NGFF write; the first calibrates), metrics {snap['processed']} files, "
                f"{snap['mvox_per_second']} Mvox/s over its uptime {snap['uptime_seconds']} s, "
                f"compute {snap['compute_seconds']:.3f} s, TV kernel launches {c.tv_single}")
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "microtipi_tpu_torch", "doctor"], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    for line in proc.stdout.strip().splitlines():
        log(29, f"doctor: {line}")
    if proc.returncode != 0 or "doctor: OK" not in proc.stdout:
        raise AssertionError(f"python -m microtipi_tpu_torch doctor exited {proc.returncode}: {proc.stderr[-2000:]}")
    log(29, f"python -m microtipi_tpu_torch doctor: exit 0 in {time.perf_counter() - t0:.2f} s (a process of its own)")
    return launches


def phase4_estimation() -> None:
    """Card float32 against CPU float64 at small sizes for the new functions:
    the per-frame and joint batched blind loops (2 frames of PARITY_SHAPE, 2
    rounds; the first round's f to 1e-3), the streamed statistics (float32
    blocks against float64, 1e-5 of the largest value) and the float64
    streamed fit (1e-8), ``retrieve_pupil`` (5 iterations, f to 1e-2 and its
    PSF to 1e-3), the
    diversity cost (1e-5) and fit (f to 1e-3), 2D SIM estimation (float64 on
    both, 1e-10) and reconstruction (1e-4), ISM gains, reassignment and RL
    (1e-4), and the image ops (1e-4, register shifts to 1e-3 voxels)."""
    from microtipi_tpu_torch.jobs import diversity, ism, phase_retrieval, sim, tiled_blind
    from microtipi_tpu_torch.jobs.batch import batched_blind_deconvolve
    from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
    from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig
    from microtipi_tpu_torch.models import ISMConfig, ISMModel
    from microtipi_tpu_torch.models.microscope import DEFOCUS, PHASE
    from microtipi_tpu_torch.models.widefield import WideFieldConfig, WideFieldModel
    from microtipi_tpu_torch.ops import geometry, metrics, preprocess, register

    gaps = {}

    def both(fn):
        """``fn(device, dtype)`` on the card in float32 and on the CPU in float64."""
        return fn(torch.device("cuda"), torch.float32), fn(torch.device("cpu"), torch.float64)

    def rel(a, b):
        a, b = (torch.as_tensor(v).detach().double().cpu() for v in (a, b))
        return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))

    def blind(dev, dt):
        scenes = [bench_scene(PARITY_SHAPE, dev, dt, phase=BENCH_PHASE, seed=s) for s in range(2)]
        data = torch.stack([d for _, d, _ in scenes])
        cfg = BlindDeconvConfig(loops=2, families=(DEFOCUS, PHASE), psf_max_iter=(3, 3), joint_fit=True,
                                deconv=DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=10, grtol=0.0, gatol=0.0),
                                fit=PsfFitConfig(grtol=0.0))
        return [batched_blind_deconvolve(data, scenes[0][0], config=cfg, joint_psf=j).deconv_f for j in (False, True)]

    (lanes32, joint32), (lanes64, joint64) = both(blind)
    gaps["batched blind round-1 f"] = max(float(np.max(np.abs(lanes32[:, 0] - lanes64[:, 0]) / lanes64[:, 0])),
                                          abs(joint32[0] - joint64[0]) / joint64[0])

    def stats(dev, dt):
        obj = bead_objects(PARITY_SHAPE, torch.device("cpu"), dt, seed=1)[0].numpy()
        d = bead_objects(PARITY_SHAPE, torch.device("cpu"), dt, seed=2)[0].numpy() + obj
        st = tiled_blind.streamed_fit_stats(obj, d, (4, 16, 16), tile=(8, 32, 32), device=dev)
        m = WideFieldModel(WideFieldConfig(shape=(4, 16, 16), dtype=torch.float64, **OPTICS), dev)
        fit = tiled_blind.fit_psf_streamed(m, m.init_params(), (DEFOCUS, PHASE), st, PsfFitConfig(max_iter=5))
        return st, fit

    (st32, fit32), (st64, fit64) = both(stats)
    gaps["streamed stats"] = max(float(torch.max(torch.abs(a.cpu() - b)) / torch.max(torch.abs(b)))
                                 for a, b in ((st32.rho, st64.rho), (st32.b, st64.b)))
    st_on_card = tiled_blind.FitStats(st64.rho.cuda(), st64.b.cuda(), *st64[2:])
    m64 = WideFieldModel(WideFieldConfig(shape=(4, 16, 16), dtype=torch.float64, **OPTICS), torch.device("cuda"))
    fit_card = tiled_blind.fit_psf_streamed(m64, m64.init_params(), (DEFOCUS, PHASE), st_on_card,
                                            PsfFitConfig(max_iter=5))
    gaps["streamed fit, float64 both"] = abs(fit_card[1] - fit64[1]) / abs(fit64[1])

    def retrieve(dev, dt):
        m = WideFieldModel(WideFieldConfig(shape=PARITY_SHAPE, dtype=dt, **OPTICS), dev)
        with torch.no_grad():
            bead = 1e4 * m.compute_psf(_with_phase(m, BENCH_PHASE)) + 10.0
        return phase_retrieval.retrieve_pupil(m, bead, config=PsfFitConfig(max_iter=5, grtol=1e-12),
                                              gs_iterations=5)

    r32, r64 = both(retrieve)
    gaps["retrieve_pupil f"] = abs(float(r32.f) - float(r64.f)) / abs(float(r64.f))
    gaps["retrieve_pupil psf"] = rel(r32.psf, r64.psf)

    def div(dev, dt):
        m = WideFieldModel(WideFieldConfig(shape=PARITY_SHAPE, dtype=dt, **OPTICS), dev)
        ph = diversity.defocus_diversity(m, [-2e-7, 2e-7])
        obj = bead_objects(PARITY_SHAPE, dev, dt, seed=3)[0] + 1.0
        with torch.no_grad():
            y = blur(obj[None].expand(2, *PARITY_SHAPE), diversity.diversity_psfs(m, _with_phase(m, BENCH_PHASE), ph))
        cost = float(diversity.diversity_cost(m, y, ph)(m.init_params()))
        fit = diversity.fit_psf_diversity(m, y, ph, (PHASE,), config=PsfFitConfig(max_iter=5))
        return cost, fit

    (c32, f32), (c64, f64) = both(div)
    gaps["diversity cost"] = abs(c32 - c64) / abs(c64)
    gaps["diversity fit f"] = abs(float(f32.f) - float(f64.f)) / abs(float(f64.f))

    def sim2(dev, dt):
        m = WideFieldModel(WideFieldConfig(shape=(1, 64, 64), dtype=torch.float64, **OPTICS), dev)
        with torch.no_grad():
            h = m.compute_psf(m.init_params())[0]
        otf = torch.fft.fft2((h / h.sum()).to(torch.complex128 if dt == torch.float64 else torch.complex64))
        k = 0.8 * 2 * OPTICS["na"] / OPTICS["wavelength"] * OPTICS["dxy"]
        a_k, ph = _sim_patterns(3, 3, k, [0.0, 0.0, 0.0])
        x = bead_objects((64, 64), dev, dt, seed=6)[0] * 10.0
        true_k, true_ph = a_k + np.array([[0.3 / 64, -0.3 / 64]] * 3), ph + np.array([[0.5], [-0.3], [0.2]])
        data = sim.simulate_sim(x, otf, true_k, true_ph, modulation=0.9)
        est = sim.estimate_sim_pattern(data.double(), otf, a_k, ph, modulation=0.9)
        return est, sim.reconstruct_sim(data, otf, true_k, true_ph, 0.9, 1e-3).x

    ((k32, p32), x32), ((k64, p64), x64) = both(sim2)
    gaps["SIM estimate (float64 of float32 data)"] = float(max(np.max(np.abs(k32 - k64)) * 64, np.max(np.abs(p32 - p64))))
    gaps["SIM reconstruction"] = rel(x32, x64)

    def ism_run(dev, dt):
        cfg = ISMConfig(shape=PARITY_SHAPE, na=OPTICS["na"], wavelength=OPTICS["wavelength"], wavelength_exc=488e-9,
                        ni=OPTICS["ni"], dxy=OPTICS["dxy"], dz=OPTICS["dz"], n_phase=6, dtype=dt,
                        element_pitch=0.5 * OPTICS["dxy"], rings=1, pinhole=0.0)
        m = ISMModel(cfg, dev)
        p = _with_phase(m, BENCH_PHASE)
        obj = bead_objects(PARITY_SHAPE, dev, dt, seed=4)[0]
        with torch.no_grad():
            d = blur(obj[None].expand(7, *PARITY_SHAPE), m.compute_psfs(p)) + 1.0
        g = ism.ism_element_gains(m, p, d, background=1.0)
        return g, ism.ism_reassign(m, d, gains=g), ism.ism_richardson_lucy(m, p, d, iterations=10, background=1.0)

    i32, i64 = both(ism_run)
    gaps["ISM gains, reassign, RL"] = max(rel(a, b) for a, b in zip(i32, i64))

    def ops(dev, dt):
        obj = bead_objects(PARITY_SHAPE, dev, dt, seed=5)[0]
        vol = blur(obj, joint_psf(PARITY_SHAPE, dev, dt)) + 1.0
        moved = register.fourier_shift(vol, (0.4, -1.3, 2.6))
        series = torch.stack([vol, 0.8 * vol, 0.6 * vol])
        f, c = metrics.fourier_shell_correlation(vol, moved)
        return (register.register_translation(vol, moved, method="xcorr"), register.register_timeseries(series)[0],
                c, preprocess.destripe(vol), preprocess.estimate_bleach(series), preprocess.remove_hot_pixels(vol),
                preprocess.subtract_background(vol, 5), geometry.deskew(vol, DESKEW_ANGLE, 2e-7, OPTICS["dxy"])[0])

    o32, o64 = both(ops)
    gaps["register shift (voxels)"] = float(torch.max(torch.abs(o32[0].double().cpu() - o64[0])))
    gaps["image ops"] = max(rel(a, b) for a, b in zip(o32[1:], o64[1:]))
    # retrieve_pupil's f: the float32 Gerchberg-Saxton start differs by round-off, which 5 line-searched
    # iterations on a nonconvex objective carry to 3.5e-3 (an NVIDIA H100 80GB HBM3 at 700 W): held at 1e-2, its
    # PSF at 1e-3.
    bounds = {"batched blind round-1 f": 1e-3, "streamed stats": 1e-5, "streamed fit, float64 both": 1e-8,
              "retrieve_pupil f": 1e-2, "retrieve_pupil psf": 1e-3, "diversity cost": 1e-5, "diversity fit f": 1e-3,
              "SIM estimate (float64 of float32 data)": 1e-3, "SIM reconstruction": 1e-4,
              "ISM gains, reassign, RL": 1e-4, "register shift (voxels)": 1e-3, "image ops": 1e-4}
    bad = {k: v for k, v in gaps.items() if not v <= bounds[k]}
    if bad:
        raise AssertionError(f"card float32 against CPU float64, over the bound: {bad} (bounds {bounds})")
    log(4, "estimation, SIM/ISM and image ops, card float32 against CPU float64: "
           + ", ".join(f"{k} {v:.3g} (< {bounds[k]:g})" for k, v in gaps.items()))


# Phase 30: the mesh-sharded paths (parallel/) on meshes of the one card.
MESH_SHAPES = ((1, 1), (1, 4), (2, 2))
SLABS = 4  # z-slabs of the 256^3 volume on a (1, 4) mesh: 64 planes each
SLAB_F_RTOL = 1e-4  # f(x0) and the first iteration's f, sharded against dense (phase 4's float32 bound)
DRY_SHAPE = (5, 16, 16)  # the dry run's mesh-odd volume, padded to 6 planes: 2 z-slabs of 3
#: (batch, volume, z-slabs) of every slab launch on phase 30's paths: 256^3 on (1, 4), (1, 1) and (2, 2) (VMLMB,
#: blind, ADMM; the batched blind loop's rows of one volume each), 64x256x256 on (1, 4) (RL-TV, depthvar) and (1, 1)
#: (the CLI), the dry run; and 2 x 256^3 in 2 slabs of a row (the kernel's lanes on a slab).
SLAB_CASES = ((1, SHAPE, SLABS), (1, SHAPE, 2), (1, SHAPE, 1), (2, SHAPE, 2), (1, LANE_SHAPE, SLABS),
              (1, LANE_SHAPE, 1), (1, (DRY_SHAPE[0] + 1, *DRY_SHAPE[1:]), 2))


class SlabCounts:
    """The kernels' launch counts over one sharded path: every count set to 0
    on entry and read on exit; :meth:`check` demands slab launches of the
    kinds the path runs and no whole-volume launch at all, and on these
    meshes of the one card one grouped TV launch over all of an evaluation's
    ``slabs`` with no halo copy."""

    def __enter__(self):
        from microtipi_tpu_torch.ops.kernels import admm_split as ak
        from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv
        from microtipi_tpu_torch.parallel import deconv as pd

        self.ak, self.hv, self.pd = ak, hv, pd
        hv.launches = hv.batched_launches = hv.slab_launches = hv.slabs_launched = hv.unaligned_launches = 0
        ak.split_launches = ak.rhs_launches = ak.split_slab_launches = ak.rhs_slab_launches = 0
        ak.split_unaligned_launches = pd.halo_sends = 0
        return self

    def __exit__(self, *exc):
        self.tv, self.split, self.rhs = self.hv.slab_launches, self.ak.split_slab_launches, self.ak.rhs_slab_launches
        self.tv_slabs, self.sends = self.hv.slabs_launched, self.pd.halo_sends
        self.whole = (self.hv.launches, self.hv.batched_launches, self.ak.split_launches, self.ak.rhs_launches)
        self.unaligned = self.hv.unaligned_launches + self.ak.split_unaligned_launches
        return False

    def check(self, name: str, slabs: int, tv: bool = True, admm: bool = False) -> dict:
        got = {"tv": self.tv, "tv_slabs": self.tv_slabs, "halo_sends": self.sends, "split": self.split,
               "rhs": self.rhs}
        want_zero = [k for k, on in (("tv", tv), ("split", admm), ("rhs", admm)) if not on]
        if (any(got[k] == 0 for k, on in (("tv", tv), ("split", admm), ("rhs", admm)) if on)
                or any(got[k] for k in want_zero) or any(self.whole) or self.unaligned
                or self.tv_slabs != slabs * self.tv or self.sends):
            raise AssertionError(f"{name}: slab launches {got} ({slabs} slabs a TV launch expected, no halo copy), "
                                 f"whole-volume launches (tv, tv batched, split, rhs) {self.whole}, unaligned "
                                 f"{self.unaligned}")
        return got


def card_mesh(b: int, z: int):
    """A (b, z) mesh of b * z entries of the one card."""
    from microtipi_tpu_torch.parallel import make_mesh

    return make_mesh(b, z, devices=[torch.device("cuda", 0)] * (b * z))


def slab_bound(nvox: int, plane: int, volumes: int, planes: int, ops: int) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") of a slab launch: ``volumes``
    slabs of ``nvox`` voxels and ``planes`` halo planes of ``plane`` voxels
    moved once, ``ops`` float32 operations a voxel."""
    t_bytes = (volumes * nvox + planes * plane) * 4 / HBM_BYTES_PER_S
    t_ops = ops * nvox / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _slab_entry(t: dict, err: float) -> dict:
    return {"max_abs_err": err, "ms": t["call_ms"], **t, "bound_share": t["bound_ms"] / t["kernel_ms"],
            "library_ms": None}


def _group(x: torch.Tensor, cuts):
    """The slabs of ``x`` cut at ``cuts`` (contiguous copies) and their halo
    planes as the sharded paths hand them to one grouped launch on one card:
    views of the neighbouring slabs' boundary planes."""
    slabs = [x[:, a:b].contiguous() for a, b in zip(cuts[:-1], cuts[1:])]
    return slabs, [None] + [t[:, -1] for t in slabs[:-1]], [t[:, 0] for t in slabs[1:]] + [None]


def _tv_slab_times(x: torch.Tensor, a: int, b: int, dev: torch.device) -> dict:
    """``kernel_ms`` (50 raw launches), ``call_ms``, plain time, halo copies
    and bound of the TV slab entry on planes [a, b) of ``x`` with both halos,
    the slab launched on its own."""
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv
    from microtipi_tpu_torch.parallel.mesh import send

    slab, prev, nxt = x[:, a:b].contiguous(), x[:, a - 1].contiguous(), x[:, b].contiguous()
    launch, _, _, geo = hv.prepare_slabs([slab], [prev], [nxt], 1.0)
    t = {"kernel_ms": raw_ms(launch),
         "call_ms": _median_ms(lambda: hv.hyperbolic_tv_slab_fused(slab, prev, nxt, 1.0)),
         "plain_ms": _median_ms(lambda: hv.hyperbolic_tv_slab_plain(slab, prev, nxt, 1.0)),
         "halo_ms": _median_ms(lambda: (send(x[:, a - 1], dev), send(x[:, b], dev))),
         "grid": list(geo.grid), "z_range": geo.slabs[0].z_range}
    t["bound_ms"], t["bound_by"] = slab_bound(slab.numel(), slab.shape[2] * slab.shape[3], 2, 2, TV_OPS_PER_VOXEL)
    t["bound_share"] = t["bound_ms"] / t["kernel_ms"]
    return t


def phase30_slab_kernels(card: str) -> dict:
    """The three slab entries at every slab shape the sharded paths launch
    (SLAB_CASES). The TV slabs of each case go through one grouped launch as
    the sharded paths make it (neighbours read in place): each slab against
    its plain version (phase 2's tolerances) and bitwise against the same slab
    launched alone with copied halos, the slabs put together against the
    whole-volume launch (gradients bit for bit, costs to float32 round-off);
    the ADMM slab launches against their plain versions and put together
    against the whole-volume launches, bit for bit. Then each entry's
    ``kernel_ms`` (50 raw launches of one 64-plane slab with both halos),
    ``call_ms`` (the wrapper, halo checks included), the plain version's time,
    the halo planes' copy and the bound; for the TV entry also the 16-plane
    slab of 64x256x256, the grouped launch of the 256^3 volume in SLABS
    slabs beside the whole-volume launch, and one TV evaluation of that
    volume on a (1, SLABS) mesh of the card (``parallel.deconv._slab_tv``)
    with its launches, slabs and halo copies counted."""
    from microtipi_tpu_torch.ops.kernels import admm_split as ak
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv
    from microtipi_tpu_torch.parallel import deconv as pd
    from microtipi_tpu_torch.parallel import shard
    from microtipi_tpu_torch.parallel.mesh import send

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(30)
    errs = {"tv": 0.0, "split": 0.0, "rhs": 0.0}
    scales = (3.0, 1.0, 0.7)
    for nb, vol, nslab in SLAB_CASES:
        nz = vol[0]
        x = torch.as_tensor(rng.standard_normal((nb, *vol), dtype=np.float32), device=dev)
        cuts = np.linspace(0, nz, nslab + 1).astype(int)
        whole_c, whole_g = hv.hyperbolic_tv_batched_fused(x, 1.0, (2.0, 1.0, 1.0))
        slabs, prevs, nexts = _group(x, cuts)
        costs, grads = hv.hyperbolic_tv_slab_group(slabs, prevs, nexts, 1.0, (2.0, 1.0, 1.0))
        for a, b, slab, prev, nxt, c, g in zip(cuts[:-1], cuts[1:], slabs, prevs, nexts, costs, grads):
            cp, gp = hv.hyperbolic_tv_slab_plain(slab, prev, nxt, 1.0, (2.0, 1.0, 1.0))
            err = float((g - gp).abs().max())
            errs["tv"] = max(errs["tv"], err)
            if (float(((c - cp).abs() / cp.abs()).max()) > TV_COST_RTOL
                    or not torch.allclose(g, gp, rtol=TV_GRAD_RTOL, atol=TV_GRAD_ATOL)):
                raise AssertionError(f"TV slab [{a}, {b}) of {nb} x {vol} != plain: grad max abs {err:.3g}")
            c1, g1 = hv.hyperbolic_tv_slab_fused(slab, None if prev is None else prev.contiguous(),
                                                 None if nxt is None else nxt.contiguous(), 1.0, (2.0, 1.0, 1.0))
            if not (torch.equal(c, c1) and torch.equal(g, g1)):
                raise AssertionError(f"TV slab [{a}, {b}) of {nb} x {vol}: the grouped launch != the slab alone")
        cost_rel = float(((sum(costs) - whole_c).abs() / whole_c.abs()).max())
        if not torch.equal(torch.cat(grads, 1), whole_g) or cost_rel > TV_COST_RTOL:
            raise AssertionError(f"TV slabs of {nb} x {vol} != the whole-volume launch: cost rel {cost_rel:.3g}")
        log(30, f"TV slab entry at {nb} x {vol} in {nslab} slabs, one grouped launch: each == plain and bitwise "
                f"the slab launched alone; gradients put together bitwise the whole-volume launch's, costs summed "
                f"within {cost_rel:.3g} of its cost")

        st = {"z1": torch.as_tensor(rng.standard_normal((nb, 3, *vol), dtype=np.float32), device=dev),
              "u1": 0.1 * torch.as_tensor(rng.standard_normal((nb, 3, *vol), dtype=np.float32), device=dev),
              "z2": torch.as_tensor(rng.standard_normal((nb, *vol), dtype=np.float32), device=dev),
              "u2": 0.1 * torch.as_tensor(rng.standard_normal((nb, *vol), dtype=np.float32), device=dev)}
        lam, r1, r2 = (torch.full((nb,), v, device=dev) for v in (0.3, 1.5, 0.7))
        for alpha in (1.0, 1.8):
            whole = {k: v.clone() for k, v in st.items()}
            ak.admm_split_update(x, whole["z1"], whole["u1"], whole["z2"], whole["u2"], lam, 0.5, alpha, True, scales)
            whole_rhs = ak.admm_rhs(st["z1"], st["u1"], st["z2"], st["u2"], r1, r2, scales)
            parts, rhs = [], []
            for a, b in zip(cuts[:-1], cuts[1:]):
                sl = [st["z1"][:, :, a:b].clone(), st["u1"][:, :, a:b].clone(), st["z2"][:, a:b].clone(),
                      st["u2"][:, a:b].clone()]
                pl = [t.clone() for t in sl]
                xs, xn = x[:, a:b].clone(), x[:, b % nz].clone()
                ak.admm_split_update_slab(xs, xn, *sl, lam, 0.5, int(a), nz, alpha, True, scales)
                ak.admm_split_update_slab_plain(xs, xn, *pl, lam, 0.5, int(a), nz, alpha, True, scales)
                args = (st["z1"][:, :, a:b].clone(), st["u1"][:, :, a:b].clone(), st["z2"][:, a:b].clone(),
                        st["u2"][:, a:b].clone(), st["z1"][:, 0, a - 1].clone(), st["u1"][:, 0, a - 1].clone(),
                        r1, r2, scales)
                r = ak.admm_rhs_slab(*args)
                rp = ak.admm_rhs_slab_plain(*args)
                errs["split"] = max(errs["split"], *(float((s - p).abs().max()) for s, p in zip(sl, pl)))
                errs["rhs"] = max(errs["rhs"], float((r - rp).abs().max()))
                if not (all(torch.equal(s, p) for s, p in zip(sl, pl)) and torch.equal(r, rp)):
                    raise AssertionError(f"ADMM slab [{a}, {b}) of {nb} x {vol} alpha {alpha} != plain")
                parts.append(sl)
                rhs.append(r)
            got = [torch.cat([p[i] for p in parts], 2 if i < 2 else 1) for i in range(4)]
            if not (all(torch.equal(g, whole[k]) for g, k in zip(got, ("z1", "u1", "z2", "u2")))
                    and torch.equal(torch.cat(rhs, 1), whole_rhs)):
                raise AssertionError(f"ADMM slabs of {nb} x {vol} alpha {alpha} != the whole-volume launches")
        log(30, f"ADMM slab entries at {nb} x {vol} in {nslab} slabs, over-relaxation 1 and 1.8, scales {scales}: "
                "each bitwise plain, put together bitwise the whole-volume launches (ring wrap, global z face)")
        del x, st, whole, whole_g, grads, parts, slabs, prevs, nexts
    torch.cuda.synchronize()

    # Timing: the second of four 64-plane slabs of the 256^3 volume and the second of four 16-plane slabs of
    # 64x256x256 (RL-TV's and depthvar's), each alone with both halos; the 256^3 volume as one grouped launch of its
    # SLABS slabs beside its whole-volume launch.
    x = torch.as_tensor(rng.standard_normal((1, *SHAPE), dtype=np.float32), device=dev)
    a, b = SHAPE[0] // SLABS, 2 * SHAPE[0] // SLABS
    tv = _slab_entry(_tv_slab_times(x, a, b, dev), errs["tv"])
    xl = torch.as_tensor(rng.standard_normal((1, *LANE_SHAPE), dtype=np.float32), device=dev)
    tv["slab_16"] = _tv_slab_times(xl, LANE_SHAPE[0] // SLABS, 2 * LANE_SHAPE[0] // SLABS, dev)
    slabs, prevs, nexts = _group(x, np.linspace(0, SHAPE[0], SLABS + 1).astype(int))
    launch, _, _, geo = hv.prepare_slabs(slabs, prevs, nexts, 1.0)
    whole = hv.prepare_launch(x[0], 1.0)[0]
    group = {"kernel_ms": raw_ms(launch), "whole_kernel_ms": raw_ms(whole), "grid": list(geo.grid),
             "call_ms": _median_ms(lambda: hv.hyperbolic_tv_slab_group(slabs, prevs, nexts, 1.0)),
             "whole_call_ms": _median_ms(lambda: hv.hyperbolic_tv_fused(x[0], 1.0))}
    # One TV evaluation of the same volume as the sharded paths make it, on a (1, SLABS) mesh of the card: its
    # launches, slabs and halo copies counted, then its call timed.
    xs = shard(x[0], card_mesh(1, SLABS))
    hv.slab_launches = hv.slabs_launched = pd.halo_sends = 0
    pd._slab_tv(xs, 1.0, None)
    group.update(eval_launches=hv.slab_launches, eval_slabs=hv.slabs_launched, halo_copies=pd.halo_sends,
                 eval_call_ms=_median_ms(lambda: pd._slab_tv(xs, 1.0, None)))
    if (group["eval_launches"], group["eval_slabs"], group["halo_copies"]) != (1, SLABS, 0):
        raise AssertionError(f"a TV evaluation of {SHAPE} on a (1, {SLABS}) mesh of the card: {group['eval_launches']} "
                             f"launches of {group['eval_slabs']} slabs and {group['halo_copies']} halo copies, "
                             f"not one launch of {SLABS} slabs and none")
    group["bound_ms"], group["bound_by"] = slab_bound(x.numel(), SHAPE[1] * SHAPE[2], 2, 2 * (SLABS - 1),
                                                      TV_OPS_PER_VOXEL)
    group["bound_share"] = group["bound_ms"] / group["kernel_ms"]
    tv["group"] = group
    del launch, whole, slabs, prevs, nexts, xl, xs
    nvox, plane = (b - a) * SHAPE[1] * SHAPE[2], SHAPE[1] * SHAPE[2]
    slab, nxt = x[:, a:b].contiguous(), x[:, b].contiguous()
    z1 = torch.as_tensor(rng.standard_normal((1, 3, *slab.shape[1:]), dtype=np.float32), device=dev)
    vols = [slab, z1, 0.1 * z1, slab.clone(), 0.1 * slab]
    lam1, r11, r21 = (torch.full((1,), v, device=dev) for v in (0.3, 1.5, 0.7))
    t = {"kernel_ms": raw_ms(ak.prepare_split_update(*vols, lam1, 0.5, 1.0, True, None, nxt, a, SHAPE[0])),
         "call_ms": _median_ms(lambda: ak.admm_split_update_slab(slab, nxt, *vols[1:], lam1, 0.5, a, SHAPE[0])),
         "plain_ms": _median_ms(lambda: ak.admm_split_update_slab_plain(slab, nxt, *vols[1:], lam1, 0.5, a,
                                                                        SHAPE[0])),
         "halo_ms": _median_ms(lambda: send(x[:, b], dev))}
    t["bound_ms"], t["bound_by"] = slab_bound(nvox, plane, SPLIT_VOLUMES, 1, SPLIT_OPS)
    split = _slab_entry(t, errs["split"])
    zp, up = z1[:, 0, -1].contiguous(), z1[:, 0, 0].contiguous()
    rhs_args = (z1, 0.1 * z1, slab, 0.1 * slab, zp, up, r11, r21)
    t = {"kernel_ms": raw_ms(ak.prepare_rhs(*rhs_args[:4], r11, r21, None, zp, up)[0]),
         "call_ms": _median_ms(lambda: ak.admm_rhs_slab(*rhs_args)),
         "plain_ms": _median_ms(lambda: ak.admm_rhs_slab_plain(*rhs_args)),
         "halo_ms": _median_ms(lambda: (send(z1[:, 0, -1], dev), send(z1[:, 0, -1], dev)))}
    t["bound_ms"], t["bound_by"] = slab_bound(nvox, plane, RHS_VOLUMES, 2, RHS_OPS)
    rhs = _slab_entry(t, errs["rhs"])
    for name, shape, e in (("TV", 64, tv), ("split update", 64, split), ("rhs", 64, rhs), ("TV", 16, tv["slab_16"])):
        geometry = f"; grid {e['grid']}, z range {e['z_range']}" if "grid" in e else ""
        log(30, f"[{card}] {name} slab entry at (1, {shape}, 256, 256) with its halo planes: kernel_ms "
                f"{e['kernel_ms']:.4f} (50 raw launches), call_ms {e['call_ms']:.4f}, plain {e['plain_ms']:.4f} ms, "
                f"halo copies {e['halo_ms']:.4f} ms; bound {e['bound_ms']:.4f} ms ({e['bound_by']}), "
                f"{e['bound_share']:.1%} of it{geometry}")
    log(30, f"[{card}] TV of {SHAPE} in {SLABS} slabs, one grouped launch reading its neighbours in place (grid "
            f"{group['grid']}): kernel_ms {group['kernel_ms']:.4f}, call_ms {group['call_ms']:.4f}; as a TV "
            f"evaluation on a (1, {SLABS}) mesh of the card {group['eval_launches']} launch of "
            f"{group['eval_slabs']} slabs, {group['halo_copies']} halo copies, call_ms {group['eval_call_ms']:.4f}; "
            f"the whole-volume launch kernel_ms {group['whole_kernel_ms']:.4f}, call_ms "
            f"{group['whole_call_ms']:.4f}; bound {group['bound_ms']:.4f} ms, {group['bound_share']:.1%} of it, "
            f"{group['kernel_ms'] / group['whole_kernel_ms'] - 1:+.1%} against the whole-volume launch")
    return {"tv": tv, "split": split, "rhs": rhs}


def _wall(fn, runs: int = 2):
    """(median wall of ``runs`` synchronized calls after one warm-up, the last result)."""
    fn()
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls)), out


def _rel_f(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) / np.abs(np.asarray(b))))


def mesh_blind_config():
    """Phase 3's blind loop, as phases 30 and 31 run it on a mesh."""
    from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
    from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig
    from microtipi_tpu_torch.models.microscope import DEFOCUS, PHASE

    return BlindDeconvConfig(
        loops=5, families=(DEFOCUS, PHASE), psf_max_iter=(5, 5), joint_fit=True,
        deconv=DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=20, grtol=0.0, gatol=0.0),
        fit=PsfFitConfig(grtol=0.0))


#: Object steps of :func:`_object_step_reading`'s loop: the first a warm-up (its cuFFT plans), then the ones read.
OBJECT_ROUNDS = 3


def _object_step_reading(model, data, mesh, dev: torch.device, whole: bool = False) -> dict:
    """Phase 3's blind loop on ``mesh`` cut to OBJECT_ROUNDS object steps (every
    family's fit budget 0, so no fit runs; the data as the start), each object
    step read between CUDA synchronizations: its wall, this process's memory on
    ``dev`` held before it and its peak during it (``torch.cuda.max_memory_allocated``,
    reset just before), the bytes this rank sent by kind (``collectives.sent``,
    cleared just before), and the wall and peak of its PSF synthesis, the step's
    first work (the peak read just after it is the synthesis's). The PSF by each
    cell's planes (``parallel.psf_fit.psf_slabs``), or with ``whole`` the whole
    PSF on every rank, cut (:func:`whole_psf_slabs`). Returns the readings by
    step and the loop's ``deconv_f``."""
    from microtipi_tpu_torch.parallel import blind as pb
    from microtipi_tpu_torch.parallel import collectives

    cfg = dataclasses.replace(mesh_blind_config(), loops=OBJECT_ROUNDS, psf_max_iter=(0, 0), joint_fit=False)
    plain = pb.run_blind_loop, pb.psf_slabs
    steps, synth = [], {}

    def synchronized(fn):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            if "t0" in synth:  # the first synthesis of a step being read
                torch.cuda.synchronize(dev)
                synth.update(ms=(time.perf_counter() - synth.pop("t0")) * 1e3,
                             peak=torch.cuda.max_memory_allocated(dev))
            return out
        return run

    def loop(config, f_dtype, x0, params0, object_step, *rest):
        def read(x, params, mu):
            torch.cuda.synchronize(dev)
            collectives.sent.clear()
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            synth.clear()
            t0 = synth["t0"] = time.perf_counter()
            out = object_step(x, params, mu)
            torch.cuda.synchronize(dev)
            steps.append({"wall": time.perf_counter() - t0, "before": before,
                          "peak": torch.cuda.max_memory_allocated(dev), "sent": dict(collectives.sent),
                          "synth_ms": synth["ms"], "synth_peak": synth["peak"]})
            return out
        return plain[0](config, f_dtype, x0, params0, read, *rest)

    pb.run_blind_loop, pb.psf_slabs = loop, synchronized(whole_psf_slabs if whole else plain[1])
    model.compute_psf = synchronized(type(model).compute_psf.__get__(model))
    try:
        res = pb.sharded_blind_deconvolve(data, model, mesh, config=cfg)
    finally:
        pb.run_blind_loop, pb.psf_slabs = plain
        del model.compute_psf
    return {"steps": steps, "deconv_f": res.deconv_f}


def whole_psf_slabs(model, params, mesh, field_of=None, grid=None) -> list:
    """``parallel.psf_fit.psf_slabs``' stand-in for the whole route, the
    object steps' route before each cell synthesized its planes: the PSF
    synthesized whole on the model's device, zero-padded in FFT layout to
    ``grid`` and cut."""
    from microtipi_tpu_torch.parallel import shard
    from microtipi_tpu_torch.utils.arrays import pad_fft_kernel

    return [shard(pad_fft_kernel(model.compute_psf(params), tuple(grid or model.shape)), mesh, False)]


def _object_step_summary(r: dict) -> dict:
    """Of :func:`_object_step_reading`'s steps after the warm-up: the median
    walls (s, ms) and the largest peaks (MiB, above what was held and in all)."""
    read, mib = r["steps"][1:], 2.0 ** -20
    return {"wall": float(np.median([t["wall"] for t in read])),
            "synth_ms": float(np.median([t["synth_ms"] for t in read])),
            "peak": max(t["peak"] for t in read) * mib, "held": max(t["before"] for t in read) * mib,
            "step_peak": max(t["peak"] - t["before"] for t in read) * mib,
            "synth_peak": max(t["synth_peak"] - t["before"] for t in read) * mib,
            "sent": {k: sum(t["sent"].get(k, 0) for t in read) for k in SENT_KINDS}}


def _object_step_text(s: dict) -> str:
    return (f"step {s['wall']:.4f} s, peak {s['peak']:.1f} MiB (+{s['step_peak']:.1f} over {s['held']:.1f} held), "
            f"PSF synthesis {s['synth_ms']:.3f} ms (+{s['synth_peak']:.1f} MiB)")


def phase30_object_step(card: str) -> dict:
    """The blind loop's object step on (1, SLABS) of cuda:0 at 256^3, phase 3's
    scene and loop (:func:`_object_step_reading`), its PSF by each cell's
    planes and by the whole synthesis and cut: the object step's and its
    synthesis's peak memory and walls, and the loop's ``deconv_f`` by both
    routes, bit for bit or within SLAB_F_RTOL. Returns both readings (phase
    31's one-process references)."""
    dev = torch.device("cuda", 0)
    model, bdata, _ = bench_scene(SHAPE, dev, torch.float32, phase=BENCH_PHASE)
    mesh = card_mesh(1, SLABS)
    got = {route: _object_step_reading(model, bdata, mesh, dev, whole=route == "whole")
           for route in ("whole", "planes")}
    f, f0 = got["planes"]["deconv_f"], got["whole"]["deconv_f"]
    bitwise, gap = _same_bits(f, f0), _rel_f(f, f0)
    if not (bitwise or gap <= SLAB_F_RTOL) or not np.isfinite(f).all():
        raise AssertionError(f"the object steps fed each cell's planes: deconv_f {f}, by the whole PSF cut {f0}")
    s = {route: _object_step_summary(r) for route, r in got.items()}
    if not s["planes"]["synth_peak"] < s["whole"]["synth_peak"]:
        raise AssertionError(f"the object step's PSF synthesis by each cell's planes peaked at +"
                             f"{s['planes']['synth_peak']:.1f} MiB, the whole PSF's at +{s['whole']['synth_peak']:.1f}")
    log(30, f"[{card}] the blind loop's object step of {SHAPE} on (1, {SLABS}) of cuda:0 ({OBJECT_ROUNDS} steps of "
            f"phase 3's loop without fits; medians and largest peaks of the {OBJECT_ROUNDS - 1} after a warm-up): by "
            f"each cell's planes {_object_step_text(s['planes'])}; by the whole PSF synthesized and cut "
            f"{_object_step_text(s['whole'])}; deconv_f {'bit for bit' if bitwise else f'within {gap:.3g} rel'}")
    return got


#: The PSF's slabs put together against ``compute_psf`` on the card (float32): relative L2 at most this, where
#: cuFFT plans the slabs' batches of planes otherwise than the whole volume's and a unit-sum family's sum is added
#: in another order.
PSF_SLABS_RTOL = 1e-6
#: The families whose fit evaluation phase 31 runs over processes (``family_configs`` names).
MP_FAMILIES = ("confocal_pinhole", "lightsheet")
#: A float32 fit evaluation's gradient by each cell's planes may be at most this many times farther from float64
#: than the whole synthesis's.
PLANES_GRAD_GAP = 2.0


def _synthesis_reading(fn, dev: torch.device) -> tuple[float, float]:
    """(median ms of 20 calls, peak MiB above what was held during one) of a
    PSF synthesis ``fn`` under ``no_grad``."""
    ms = _median_ms(fn)
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize(dev)
    return ms, (torch.cuda.max_memory_allocated(dev) - before) / 2**20


def family_fit_scene(name: str, dev: torch.device):
    """(model, params, data) of family ``name`` (``family_configs`` at
    SHAPE, float32) on ``dev``: phase 3's aberration, and the bench scene
    blurred by the family's PSF there; a fit evaluation takes the data as
    data and, clamped at 0, as the object."""
    from microtipi_tpu_torch.models import model_for

    model = model_for(family_configs(SHAPE, torch.float32)[name], dev)
    return model, _family_params(model), bench_scene(SHAPE, dev, torch.float32, phase=BENCH_PHASE, model=model)[1]


def phase30_psf_slabs(card: str) -> dict:
    """Every family's PSF at 256^3 (``family_configs``, phase 3's aberration)
    synthesized by each cell of a (1, SLABS) mesh of cuda:0 for its own
    planes (``parallel.psf_fit.psf_slabs``, as a sharded fit evaluates it; a
    unit-sum family's planes over the cells' one sum, and ISM's and STED's
    inner reductions over the cells), put together, against ``compute_psf``:
    bit for bit, or the largest gap in float32 ulps (a batched 2D FFT of 64
    planes may take another cuFFT plan than one of 256), within
    PSF_SLABS_RTOL; then both syntheses timed, and each one's peak above what
    was held. Then one fit evaluation on the same mesh (cost and gradient of
    every family of parameters, the family's bench data as data and object)
    by each cell's planes and by the whole synthesis and cut, in float32,
    each against float64 on the card: the planes' gradient may be no farther
    from float64 than twice the whole's. Returns the one-process fit
    evaluations by each cell's planes of MP_FAMILIES (:func:`_fit_evaluation`),
    phase 31's references."""
    from microtipi_tpu_torch.models import model_for
    from microtipi_tpu_torch.parallel import gather
    from microtipi_tpu_torch.parallel import psf_fit as spf
    from microtipi_tpu_torch.parallel.psf_fit import psf_slabs, sharded_fit_cost

    dev, mesh, refs = torch.device("cuda", 0), card_mesh(1, SLABS), {}
    for name, cfg in family_configs(SHAPE, torch.float32).items():
        model, params, data = family_fit_scene(name, dev)
        with torch.no_grad():
            whole = model.compute_psf(params)
            slabs = gather(psf_slabs(model, params, mesh)[0])
            ulps = int((slabs.view(torch.int32) - whole.view(torch.int32)).abs().max())
            rel = _rel_l2(slabs, whole)
            del slabs, whole
            whole_ms, whole_mib = _synthesis_reading(lambda: model.compute_psf(params), dev)
            slabs_ms, slabs_mib = _synthesis_reading(lambda: psf_slabs(model, params, mesh), dev)
        if not rel <= PSF_SLABS_RTOL:
            raise AssertionError(f"{name}: the PSF's {SLABS} slabs put together are {rel:.3g} relative L2 off "
                                 f"compute_psf")
        log(30, f"[{card}] {name}: the PSF of {SHAPE} from each cell's planes on (1, {SLABS}) of cuda:0, put "
                f"together, against compute_psf: "
                f"{'bit for bit' if ulps == 0 else f'largest gap {ulps} float32 ulps, {rel:.3g} relative L2'}; "
                f"synthesis {slabs_ms:.4f} ms as {SLABS} slabs (+{slabs_mib:.1f} MiB), {whole_ms:.4f} ms whole "
                f"(+{whole_mib:.1f} MiB) (medians of 20)")
        m64 = model_for(dataclasses.replace(cfg, dtype=torch.float64), dev)

        def evaluation(m, whole: bool):
            saved = spf.synthesizes_planes
            if whole:
                spf.synthesizes_planes = lambda model, grid: False
            try:
                d = data.to(m.dtype)
                cost = sharded_fit_cost(m, d, torch.clamp_min(d, 0.0), None, mesh)
            finally:
                spf.synthesizes_planes = saved
            leaves = [t.detach().to(m.dtype).requires_grad_(True) for t in params]
            f = cost(type(params)(*leaves))
            grads = torch.autograd.grad(f, leaves, allow_unused=True, materialize_grads=True)
            return float(f.detach()), torch.cat([g.reshape(-1) for g in grads]).double()

        f64, g64 = evaluation(m64, False)
        del m64
        errs = {}
        for route in ("planes", "whole"):
            f32, g32 = evaluation(model, route == "whole")
            errs[route] = (abs(f32 - f64) / abs(f64), float((g32 - g64).abs().max() / g64.abs().max()))
        if not errs["planes"][1] <= PLANES_GRAD_GAP * errs["whole"][1]:
            raise AssertionError(f"{name}: a fit evaluation's float32 gradient by each cell's planes is "
                                 f"{errs['planes'][1]:.3g} of the largest off float64, the whole synthesis's "
                                 f"{errs['whole'][1]:.3g}")
        log(30, f"[{card}] {name}: one fit evaluation of {SHAPE} on (1, {SLABS}), float32 against float64 on the "
                f"card: by each cell's planes f {errs['planes'][0]:.3g} rel, gradient of every family "
                f"{errs['planes'][1]:.3g} of its largest; by the whole synthesis and cut f {errs['whole'][0]:.3g} "
                f"rel, gradient {errs['whole'][1]:.3g}")
        if name in MP_FAMILIES:
            refs[name] = _fit_evaluation(lambda: sharded_fit_cost(model, data, torch.clamp_min(data, 0.0), None,
                                                                  mesh), params, dev)
        del model, data
        torch.cuda.empty_cache()
    return refs


def confocal_blind_run(mesh):
    """Phase 3's blind loop cut to 2 rounds on ``mesh``, for the bench scene
    blurred by the pinhole confocal PSF (``family_fit_scene``) through a
    ``ConfocalModel``: its object steps and fits on each cell's planes over
    the cells' one sum."""
    from microtipi_tpu_torch.parallel import sharded_blind_deconvolve

    model, _, data = family_fit_scene("confocal_pinhole", torch.device("cuda", 0))
    return sharded_blind_deconvolve(data, model, mesh, config=dataclasses.replace(mesh_blind_config(), loops=2))


def phase30_sharded(card: str, dense_blind_f: np.ndarray, dense_blind_wall: float) -> tuple[dict, dict]:
    """The sharded paths at full width on meshes of the one card, each run
    between :class:`SlabCounts` (slab launches only); the sharded blind loop
    beside phase 3's dense one (its ``deconv_f`` and wall). Returns each
    path's slab launches, and the costs (RL-TV: the estimate) and walls of
    the jobs phase 31 runs over processes, its references: VMLMB, the blind
    loop, ADMM, the blind loop by ADMM, the confocal blind loop, RL-TV and
    depthvar on (1, 4), and VMLMB of one volume on (2, 2); and the fit
    evaluations of MP_FAMILIES (:func:`phase30_psf_slabs`)."""
    from microtipi_tpu_torch.jobs.admm import admm_deconvolve
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, deconvolve
    from microtipi_tpu_torch.jobs.depthvar import deconvolve_depthvar, depth_anchor_psfs
    from microtipi_tpu_torch.jobs.richardson_lucy import richardson_lucy
    from microtipi_tpu_torch.parallel import (
        gather,
        sharded_admm_deconvolve,
        sharded_blind_deconvolve,
        sharded_deconvolve,
    )
    from microtipi_tpu_torch.parallel.depthvar import sharded_deconvolve_depthvar
    from microtipi_tpu_torch.parallel.richardson_lucy import sharded_richardson_lucy

    dev, nvox = torch.device("cuda", 0), float(np.prod(SHAPE))
    paths, refs = {}, {}
    refs["family_fits"] = phase30_psf_slabs(card)
    refs["object_step"] = phase30_object_step(card)
    _, data, psf = bench_scene(SHAPE, dev, torch.float32)
    cfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=20, grtol=0.0, gatol=0.0)
    dense_wall, dense = _wall(lambda: deconvolve(data, psf, config=cfg))
    for shape in MESH_SHAPES:
        mesh = card_mesh(*shape)
        with SlabCounts() as c:
            wall, res = _wall(lambda: sharded_deconvolve(data, psf, mesh, config=cfg))
        n = c.check(f"sharded_deconvolve {shape}", slabs=shape[1])  # an unbatched volume: row 0's slabs
        _check_object(f"sharded_deconvolve {shape}", gather(res.x))
        head = _rel_f(res.f_history[:2], dense.f_history[:2])
        if head > SLAB_F_RTOL:
            raise AssertionError(f"sharded_deconvolve {shape}: f(x0), f(x1) {res.f_history[:2]} vs dense "
                                 f"{dense.f_history[:2]}: {head:.3g} rel")
        if shape == (1, 4):
            paths["sharded VMLMB 256^3 (1, 4)"] = {k: v // 3 for k, v in n.items()}  # a run of the 3 (warm-up, 2 timed)
            refs["vmlmb"] = {"f_history": res.f_history, "wall": wall}
        if shape == (2, 2):
            refs["vmlmb_2x2"] = {"f_history": res.f_history, "wall": wall}
        log(30, f"[{card}] sharded_deconvolve {SHAPE} on mesh {shape} of cuda:0: {res.iterations} iterations, "
                f"{res.evaluations} evaluations, f {float(res.f):.6g} (dense {float(dense.f):.6g}, "
                f"{dense.iterations} iterations), f(x0), f(x1) within {head:.3g} rel of dense; wall {wall:.4f} s "
                f"(dense {dense_wall:.4f} s, median of 2 after 1 warm-up), "
                f"{nvox * res.iterations / wall / 1e6:.1f} Mvox*iter/s, TV slab launches {n['tv']} over 3 runs")

    model, bdata, _ = bench_scene(SHAPE, dev, torch.float32, phase=BENCH_PHASE)
    bcfg = mesh_blind_config()
    with SlabCounts() as c:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bres = sharded_blind_deconvolve(bdata, model, card_mesh(1, 4), config=bcfg)
        torch.cuda.synchronize()
        bwall = time.perf_counter() - t0
    paths["sharded blind 256^3 (1, 4)"] = c.check("sharded blind (1, 4)", slabs=SLABS)
    refs["blind"] = {"deconv_f": bres.deconv_f, "wall": bwall}
    _check_object("sharded blind", gather(bres.obj))
    df, dense_df = bres.deconv_f, dense_blind_f
    if not (np.isfinite(df).all() and np.all(np.diff(df) < 0) and np.isnan(bres.fit_f[-1]).all()):
        raise AssertionError(f"sharded blind: deconv_f {df}, fit_f {bres.fit_f}")
    first = _rel_f(df[:1], dense_df[:1])
    if first > SLAB_F_RTOL:
        raise AssertionError(f"sharded blind round 1 f {df[0]} vs dense {dense_df[0]}: {first:.3g} rel")
    phase_err = float(torch.linalg.norm(bres.params.phase.cpu() - torch.tensor(BENCH_PHASE)))
    log(30, f"[{card}] sharded_blind_deconvolve {SHAPE} on (1, 4), phase 3's loop: deconv_f {df.tolist()} (dense "
            f"{dense_df.tolist()}; round 1 within {first:.3g} rel), phase error {phase_err:.4f} (L2), wall "
            f"{bwall:.3f} s (dense {dense_blind_wall:.3f} s), TV slab launches "
            f"{paths['sharded blind 256^3 (1, 4)']['tv']}")

    acfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=20, grtol=0.0, gatol=0.0)
    dense_wall, dense = _wall(lambda: admm_deconvolve(data, psf, config=acfg))
    mesh = card_mesh(1, 4)
    with SlabCounts() as c:
        wall, res = _wall(lambda: sharded_admm_deconvolve(data, psf, mesh, config=acfg))
    n = c.check("sharded ADMM (1, 4)", slabs=SLABS, admm=True)
    paths["sharded ADMM 256^3 (1, 4)"] = {k: v // 3 for k, v in n.items()}
    if n["split"] != 3 * SLABS * acfg.max_iter or n["rhs"] != n["split"]:
        raise AssertionError(f"sharded ADMM: slab launches {n}, expected {SLABS * acfg.max_iter} a run of each")
    hist = _rel_f(res.f_history, dense.f_history)
    _check_object("sharded ADMM", gather(res.x))
    if hist > SLAB_F_RTOL:
        raise AssertionError(f"sharded ADMM f_history {hist:.3g} rel off the dense engine's")
    refs["admm"] = {"f_history": res.f_history, "wall": wall}
    log(30, f"[{card}] sharded_admm_deconvolve {SHAPE} on (1, 4), {acfg.max_iter} iterations tracked: f "
            f"{float(res.f):.6g} (dense {float(dense.f):.6g}), f_history within {hist:.3g} rel, wall {wall:.4f} s "
            f"(dense {dense_wall:.4f} s), {nvox * acfg.max_iter / wall / 1e6:.1f} Mvox*iter/s; slab launches a run "
            f"{paths['sharded ADMM 256^3 (1, 4)']}")

    # Phase 11's blind loop by the ADMM engine on (1, 4): the object steps' slab launches, one TV launch a round.
    with SlabCounts() as c:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ares = sharded_blind_deconvolve(bdata, model, card_mesh(1, 4), config=blind_admm_config())
        torch.cuda.synchronize()
        awall = time.perf_counter() - t0
    n = paths["sharded blind by ADMM 256^3 (1, 4)"] = c.check("sharded blind by ADMM (1, 4)", SLABS, admm=True)
    _check_object("sharded blind by ADMM", gather(ares.obj))
    iters = int(ares.deconv_iters.sum())
    if (not (np.isfinite(ares.deconv_f).all() and np.isnan(ares.fit_f[-1]).all()) or iters != 100
            or n["split"] != SLABS * iters or n["rhs"] != n["split"]):
        raise AssertionError(f"sharded blind by ADMM: deconv_f {ares.deconv_f}, fit_f {ares.fit_f}, object "
                             f"iterations {iters}, slab launches {n}")
    refs["blind_admm"] = {"deconv_f": ares.deconv_f, "wall": awall}
    log(30, f"[{card}] sharded_blind_deconvolve {SHAPE} on (1, 4) by the ADMM engine, phase 11's loop: deconv_f "
            f"{ares.deconv_f.tolist()}, wall {awall:.3f} s (1 run); slab launches {n}")
    del ares

    # A confocal stack's blind loop on (1, 4): object steps and fits on each cell's planes over the cells' one sum.
    with SlabCounts() as c:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cres = confocal_blind_run(card_mesh(1, 4))
        torch.cuda.synchronize()
        cwall = time.perf_counter() - t0
    n = paths["sharded confocal blind 256^3 (1, 4)"] = c.check("sharded confocal blind (1, 4)", slabs=SLABS)
    _check_object("sharded confocal blind", gather(cres.obj))
    if not (np.isfinite(cres.deconv_f).all() and np.all(np.diff(cres.deconv_f) < 0)
            and np.isnan(cres.fit_f[-1]).all()):
        raise AssertionError(f"sharded confocal blind: deconv_f {cres.deconv_f}, fit_f {cres.fit_f}")
    refs["blind_confocal"] = {"deconv_f": cres.deconv_f, "wall": cwall}
    log(30, f"[{card}] sharded_blind_deconvolve {SHAPE} on (1, 4) through a ConfocalModel (pinhole 120 nm), phase "
            f"3's loop cut to 2 rounds: deconv_f {cres.deconv_f.tolist()} falls, wall {cwall:.3f} s (1 run), TV slab "
            f"launches {n['tv']}")
    del cres

    scenes = [bench_scene(SHAPE, dev, torch.float32, phase=BENCH_PHASE, seed=s)[1] for s in (0, 1)]
    b2 = dataclasses.replace(bcfg, loops=2)
    with SlabCounts() as c:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res2 = sharded_blind_deconvolve(torch.stack(scenes), model, card_mesh(2, 2), config=b2)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    paths["sharded batched blind 2 x 256^3 (2, 2)"] = c.check("batched sharded blind (2, 2)", slabs=4)
    _check_object("batched sharded blind", gather(res2.obj))
    if res2.obj.shape != (2, *SHAPE) or not (np.isfinite(res2.deconv_f).all() and res2.deconv_f[1] < res2.deconv_f[0]):
        raise AssertionError(f"batched sharded blind: obj {res2.obj.shape}, deconv_f {res2.deconv_f}")
    log(30, f"[{card}] sharded_blind_deconvolve 2 x {SHAPE} on (2, 2), 2 rounds: deconv_f {res2.deconv_f.tolist()}, "
            f"wall {wall2:.3f} s, TV slab launches {paths['sharded batched blind 2 x 256^3 (2, 2)']['tv']}")
    del scenes, res2, bres

    # RL-TV and the depth-varying step at LANE_SHAPE (64x256x256) on (1, 4).
    _, ldata, lpsf = bench_scene(LANE_SHAPE, dev, torch.float32)
    mesh = card_mesh(1, 4)
    dense_wall, ref = _wall(lambda: richardson_lucy(ldata, lpsf, iterations=20, mu=0.002, epsilon=0.1))
    with SlabCounts() as c:
        wall, got = _wall(lambda: sharded_richardson_lucy(ldata, lpsf, mesh, iterations=20, mu=0.002, epsilon=0.1))
    paths["sharded RL-TV 64x256x256 (1, 4)"] = {k: v // 3 for k, v in c.check("sharded RL-TV", SLABS).items()}
    rel = _rel_l2(gather(got), ref)
    if rel > 1e-4 or c.tv != 3 * 20:
        raise AssertionError(f"sharded RL-TV: {rel:.3g} relative L2 off dense, TV slab launches {c.tv}")
    refs["rl_tv"] = {"x": gather(got), "wall": wall}
    log(30, f"[{card}] sharded_richardson_lucy {LANE_SHAPE} RL-TV, 20 iterations on (1, 4): {rel:.3g} relative L2 "
            f"off dense, wall {wall:.4f} s (dense {dense_wall:.4f} s), TV slab launches a run "
            f"{c.tv // 3} (one an iteration, of {SLABS} slabs)")

    gl = depthvar_model(LANE_SHAPE, torch.float32, dev)
    anchors = np.linspace(0.0, LANE_SHAPE[0] - 1.0, DEPTH_K)
    with torch.no_grad():
        psfs = depth_anchor_psfs(gl, gl.init_params(), anchors)
    ddata, _ = depthvar_scene(psfs, anchors, LANE_SHAPE, dev, torch.float32)
    dcfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=20, grtol=0.0, gatol=0.0)
    dense_wall, ref = _wall(lambda: deconvolve_depthvar(ddata, psfs, anchors, config=dcfg))
    with SlabCounts() as c:
        wall, got = _wall(lambda: sharded_deconvolve_depthvar(ddata, psfs, mesh, anchors, config=dcfg))
    paths["sharded depthvar 64x256x256 (1, 4)"] = {k: v // 3 for k, v in c.check("sharded depthvar", SLABS).items()}
    head = _rel_f(got.f_history[:2], ref.f_history[:2])
    _check_object("sharded depthvar", gather(got.x))
    if head > SLAB_F_RTOL:
        raise AssertionError(f"sharded depthvar f(x0), f(x1) {head:.3g} rel off dense")
    refs["depthvar"] = {"f_history": got.f_history, "wall": wall}
    log(30, f"[{card}] sharded_deconvolve_depthvar {LANE_SHAPE}, {DEPTH_K} anchors, on (1, 4): f {float(got.f):.6g} "
            f"(dense {float(ref.f):.6g}), f(x0), f(x1) within {head:.3g} rel, wall {wall:.4f} s (dense "
            f"{dense_wall:.4f} s), TV slab launches a run {c.tv // 3}")
    paths.update(phase30_cli_dryrun(card, ldata))
    return paths, refs


def phase30_cli_dryrun(card: str, data: torch.Tensor) -> dict:
    """``blind --mesh 1 1`` through ``cli.main`` (``python -m
    microtipi_tpu_torch``'s entry) on an OME-NGFF 64x256x256 store, bit for
    bit ``sharded_blind_deconvolve`` with the model and config the CLI built
    (``deconv --mesh`` needs a ``--psf`` file, which the CLI reads as TIFF,
    and the card's machine has no libtiff); then the counterpart of
    ``__graft_entry__.dryrun_multichip``: one full blind step (2 rounds,
    joint defocus+phase fit with pin-Z4, the Wiener start) of a batch of 2
    mesh-odd volumes on (2, 2), and a temporal-TV time series on (2, 2)."""
    import tempfile

    from microtipi_tpu_torch.cli.blind import _blind_config
    from microtipi_tpu_torch.cli.parser import build_parser
    from microtipi_tpu_torch.cli.shared import _model, _resolve_geometry
    from microtipi_tpu_torch.io import zarrstack
    from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
    from microtipi_tpu_torch.models.microscope import DEFOCUS, PHASE
    from microtipi_tpu_torch.models.widefield import WideFieldConfig, WideFieldModel
    from microtipi_tpu_torch.parallel import gather, sharded_blind_deconvolve, sharded_deconvolve

    dev = torch.device("cuda", 0)
    paths = {}
    shape = tuple(data.shape)
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_mesh_", dir=root) as tmp:
        scene, out = os.path.join(tmp, "d.zarr"), os.path.join(tmp, "o.zarr")
        zarrstack.write_ngff_hyperstack(scene, data.cpu().numpy(), dxy=IO_DXY, dz=IO_DZ)
        argv = ["blind", scene, "--out", out, *CLI_OPTICS, "--loops", "2", "--families", "defocus", "phase",
                "--psf-iters", "3", "--joint-fit", "--mu", "0.01", "--epsilon", "1", "--iters", "10", "--mesh", "1",
                "1"]
        with SlabCounts() as c:
            wall, lines = _cli(argv)
        paths["CLI blind --mesh 1 1 (NGFF)"] = c.check("CLI --mesh", slabs=1)
        got = zarrstack.read_ngff_hyperstack(out)[0][0, 0]
        args = build_parser().parse_args(argv)
        args.device = dev
        _resolve_geometry(args, scene, log=lambda *a: None)
        arr = torch.as_tensor(zarrstack.read_ngff_hyperstack(scene)[0][0, 0], device=dev)
        want = sharded_blind_deconvolve(arr, _model(args, shape), card_mesh(1, 1), config=_blind_config(args, shape))
        if not np.array_equal(got, gather(want.obj).cpu().numpy()):
            raise AssertionError("CLI blind --mesh 1 1 output != sharded_blind_deconvolve with the CLI's config")
    log(30, f"[{card}] python -m microtipi_tpu_torch blind <NGFF {shape}> --mesh 1 1 (in process): {wall:.2f} s, "
            f"output bitwise sharded_blind_deconvolve with the CLI's model and config; "
            f"{[ln for ln in lines if ln.startswith('blind:')]}")

    zp, batch = 2, 2
    vol = DRY_SHAPE  # mesh-odd nz: the loop pads to 6 planes
    model = WideFieldModel(WideFieldConfig(shape=vol, na=1.4, wavelength=561e-9, ni=1.518, dxy=80e-9, dz=200e-9,
                                           n_phase=3), device=dev)
    rng = np.random.default_rng(0)
    d = torch.as_tensor(rng.random((batch, *vol), dtype=np.float32), device=dev)
    cfg = BlindDeconvConfig(loops=2, families=(DEFOCUS, PHASE), psf_max_iter=(2, 2),
                            deconv=DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=2, grtol=0.0),
                            joint_fit=True, phase_freeze_head=1, init="wiener")
    with SlabCounts() as c:
        res = sharded_blind_deconvolve(d, model, card_mesh(batch, zp), config=cfg)
        ts = sharded_deconvolve(torch.as_tensor(rng.random((batch, 6, 16, 16), dtype=np.float32), device=dev),
                                torch.as_tensor(rng.random((6, 16, 16), dtype=np.float32), device=dev),
                                card_mesh(batch, zp), config=DeconvolutionConfig(mu=0.01, max_iter=2), mu_t=0.1)
    paths["dry run: blind step and time series (2, 2)"] = c.check("dry run", slabs=batch * zp)
    if (res.obj.shape != (batch, 2 * zp + 2, 16, 16) or not np.isfinite(res.deconv_f).all()
            or not bool(torch.isfinite(res.params.phase).all()) or float(res.params.phase[0]) != 0.0
            or not np.isfinite(ts.f)):
        raise AssertionError(f"dry run: obj {res.obj.shape}, deconv_f {res.deconv_f}, phase {res.params.phase}, "
                             f"time series f {ts.f}")
    log(30, f"dry run on (2, 2) of cuda:0: blind step of 2 x {vol} (padded to {res.obj.shape[1:]}), deconv_f "
            f"{res.deconv_f.tolist()}, pin-Z4 held; temporal-TV series f {float(ts.f):.6g}")
    return paths


# Phase 31: the sharded paths on a mesh over processes (torch.distributed), ranks on the one card.
MP_RANKS = 2  # ranks of phase 31, each with SLABS // MP_RANKS cells of the (1, SLABS) mesh
MP_GROUP_TIMEOUT_S = 60  # every process group's timeout: a rank that diverges or dies fails the others within it
MP_DEADLINE_S = 240  # the spawned ranks' whole run; past it they are killed and the phase fails
#: The collectives probed with CUDA tensors under gloo. Not send/recv: gloo's point-to-point path hands the tensor's
#: pointer to its transport as host memory, and a fault there would take the rank down.
GLOO_OPS = ("all_gather", "all_to_all_single", "broadcast")


def _gloo_cuda_ops(rank: int, world: int) -> dict:
    """Which of :data:`GLOO_OPS` a gloo group takes on CUDA tensors (True, or
    the error it raised); the mesh's collectives stage every CUDA tensor
    through the host under gloo whatever this finds."""
    import torch.distributed as dist

    dev, out = torch.device("cuda", 0), {}
    t = torch.full((4,), float(rank + 1), device=dev)
    calls = {"all_gather": lambda: dist.all_gather([torch.empty_like(t) for _ in range(world)], t),
             "all_to_all_single": lambda: dist.all_to_all_single(torch.empty_like(t), t),
             "broadcast": lambda: dist.broadcast(t.clone(), 0)}
    for name in GLOO_OPS:
        try:
            calls[name]()
            torch.cuda.synchronize()
            out[name] = True
        except Exception as e:  # noqa: BLE001  (the finding is the error itself)
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    dist.barrier()
    return out


#: Phase 31's jobs: (name, path label, the key of the result held against phase 30's one-process run, the ADMM
#: slab kernels launched). Each launches the TV slab kernel: VMLMB and depthvar each evaluation, RL-TV each
#: iteration, the ADMM engine for its tracked objective (a solve's f in the blind loop).
MP_JOBS = (("vmlmb", "VMLMB 256^3 (1, 4)", "f_history", False), ("blind", "blind 256^3 (1, 4)", "deconv_f", False),
           ("admm", "ADMM 256^3 (1, 4)", "f_history", True),
           ("blind_admm", "blind by ADMM 256^3 (1, 4)", "deconv_f", True),
           ("blind_confocal", "confocal blind 256^3 (1, 4)", "deconv_f", False),
           ("rl_tv", "RL-TV 64x256x256 (1, 4)", "x", False), ("depthvar", "depthvar 64x256x256 (1, 4)", "f_history", False),
           ("vmlmb_2x2", "VMLMB 256^3 (2, 2)", "f_history", False))
SENT_KINDS = ("halo", "transpose", "values", "cells", "rows", "pupil")


def _fit_evaluation(make_cost, params, dev: torch.device, whole: bool = False) -> dict:
    """One PSF fit evaluation on this rank, the cost ``make_cost()`` builds and
    its gradient with respect to every family of ``params``: the bytes this
    rank sent by kind, its peak memory on ``dev`` (and what it held before),
    the wall, f and the gradient. ``whole``: the route of a fit on a padded
    grid (the PSF whole on the model's device, cut, its slabs' gradients
    broadcast), for comparison."""
    from microtipi_tpu_torch.parallel import collectives
    from microtipi_tpu_torch.parallel import depthvar as sdv
    from microtipi_tpu_torch.parallel import psf_fit as spf

    saved = spf.synthesizes_planes, sdv.synthesizes_planes
    if whole:
        spf.synthesizes_planes = sdv.synthesizes_planes = lambda model, grid: False
    try:
        cost = make_cost()
        leaves = [t.detach().clone().requires_grad_(True) for t in params]
        torch.cuda.synchronize(dev)
        collectives.sent.clear()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        f = cost(type(params)(*leaves))
        grads = torch.autograd.grad(f, leaves, allow_unused=True, materialize_grads=True)
        torch.cuda.synchronize(dev)
        return {"sent": dict(collectives.sent), "peak": torch.cuda.max_memory_allocated(dev), "before": before,
                "wall": time.perf_counter() - t0, "f": float(f.detach()), "grads": torch.cat([g.reshape(-1) for g in grads])}
    finally:
        spf.synthesizes_planes, sdv.synthesizes_planes = saved


def _capture_admm_launches(mesh, run) -> dict:
    """Run ``run`` with the ADMM slab entries, as ``parallel.admm`` calls
    them, recording this rank's first split update and first rhs that take
    a plane from another rank's slab: the inputs before the launch, the
    outputs after it, the cell and the neighbour. A call's cell is the
    solve's loop order over this rank's cells."""
    from microtipi_tpu_torch.parallel import admm as padmm

    local, p = mesh.local(mesh.volume_cells(False)), mesh.shape["z"]
    first, calls = {}, {"split": 0, "rhs": 0}
    split, rhs = padmm.admm_split_update_slab, padmm.admm_rhs_slab

    def received(kind: str, step: int):
        b, z = local[calls[kind] % len(local)]
        calls[kind] += 1
        nbr = (b, (z + step) % p)
        return kind not in first and not mesh.is_local(*nbr), {"cell": (b, z), "from": nbr}

    def copies(args):
        return tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)

    def split_capture(*args):
        take, where = received("split", 1)
        before = copies(args) if take else None
        split(*args)
        if take:
            first["split"] = {"inputs": before, "outputs": copies(args[2:6]), **where}

    def rhs_capture(*args):
        take, where = received("rhs", -1)
        out = rhs(*args)
        if take:
            first["rhs"] = {"inputs": copies(args), "outputs": out.clone(), **where}
        return out

    padmm.admm_split_update_slab, padmm.admm_rhs_slab = split_capture, rhs_capture
    try:
        run()
    finally:
        padmm.admm_split_update_slab, padmm.admm_rhs_slab = split, rhs
    return first


def _mp_jobs(group, devices) -> dict:
    """Phase 30's jobs of :data:`MP_JOBS` on meshes over ``group``'s ranks
    ((1, SLABS), and (2, SLABS // 2) for one volume a replica a row), this
    rank holding ``devices``: each run once with its slab launches on this
    rank (counts set to 0 just before, read just after), bytes sent to other
    ranks by kind, and wall; VMLMB after a warm-up, whose first TV launch
    (inputs and outputs) with the planes it took from other ranks is kept for
    the parent to check and time alone on the card once the ranks have
    exited, and likewise the first ADMM split update and rhs with a plane
    from another rank, from a 2-iteration warm-up at over-relaxation 1.
    Then one objective evaluation's traffic, and one wide-field PSF fit
    evaluation (at the blind loop's object), one of each of MP_FAMILIES
    (:func:`family_fit_scene`) and one depth-varying one, cost and gradient
    (:func:`_fit_evaluation`), by each cell's planes and by the whole
    synthesis and cut."""
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
    from microtipi_tpu_torch.jobs.depthvar import depth_anchor_psfs
    from microtipi_tpu_torch.ops.kernels import admm_split as ak
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv
    from microtipi_tpu_torch.parallel import collectives
    from microtipi_tpu_torch.parallel import deconv as pd
    from microtipi_tpu_torch.parallel import (
        gather,
        make_mesh,
        sharded_admm_deconvolve,
        sharded_blind_deconvolve,
        sharded_deconvolve,
    )
    from microtipi_tpu_torch.parallel import depthvar as sdv
    from microtipi_tpu_torch.parallel.psf_fit import sharded_fit_cost
    from microtipi_tpu_torch.parallel.richardson_lucy import sharded_richardson_lucy

    dev = devices[0]
    mesh = make_mesh(1, SLABS, devices=devices, group=group)
    rows = make_mesh(2, SLABS // 2, devices=devices, group=group)
    _, data, psf = bench_scene(SHAPE, dev, torch.float32)
    cfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=20, grtol=0.0, gatol=0.0)
    first, launch = {}, pd.hyperbolic_tv_slab_group

    def capture(slabs, prevs, nexts, epsilon, scales=None):
        costs, grads = launch(slabs, prevs, nexts, epsilon, scales)
        if not first:
            first.update(inputs=([t.clone() for t in slabs], [None if t is None else t.clone() for t in prevs],
                                 [None if t is None else t.clone() for t in nexts], epsilon, scales),
                         outputs=([c.clone() for c in costs], [g.clone() for g in grads]))
        return costs, grads

    pd.hyperbolic_tv_slab_group = capture
    try:
        sharded_deconvolve(data, psf, mesh, config=cfg)
    finally:
        pd.hyperbolic_tv_slab_group = launch
    out = {"cells": mesh.local(mesh.cells()), "first_launch": first, "first_admm_launch": _capture_admm_launches(
        mesh, lambda: sharded_admm_deconvolve(data, psf, mesh, config=dataclasses.replace(cfg, max_iter=2),
                                              over_relax=1.0))}

    def run(name, job):
        hv.slab_launches = hv.slabs_launched = hv.launches = hv.batched_launches = pd.halo_sends = 0
        ak.split_launches = ak.rhs_launches = ak.split_slab_launches = ak.rhs_slab_launches = 0
        hv.unaligned_launches = ak.split_unaligned_launches = 0
        collectives.sent.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = job()
        torch.cuda.synchronize()
        out[name] = {"wall": time.perf_counter() - t0, "tv": hv.slab_launches, "tv_slabs": hv.slabs_launched,
                     "split": ak.split_slab_launches, "rhs": ak.rhs_slab_launches,
                     "whole": hv.launches + hv.batched_launches + ak.split_launches + ak.rhs_launches,
                     "unaligned": hv.unaligned_launches + ak.split_unaligned_launches, "halo_sends": pd.halo_sends,
                     "sent": dict(collectives.sent)}
        return res

    def finite(x) -> bool:
        return bool(torch.isfinite(x).all()) and float(x.min()) >= 0

    res = run("vmlmb", lambda: sharded_deconvolve(data, psf, mesh, config=cfg))
    out["vmlmb"].update(f_history=res.f_history, finite=finite(gather(res.x)))
    model, bdata, _ = bench_scene(SHAPE, dev, torch.float32, phase=BENCH_PHASE)
    bres = run("blind", lambda: sharded_blind_deconvolve(bdata, model, mesh, config=mesh_blind_config()))
    out["blind"].update(deconv_f=bres.deconv_f, fit_f=bres.fit_f, phase=bres.params.phase.cpu(),
                        finite=finite(gather(bres.obj)))
    # The blind loop's object step on this rank, its PSF by each cell's planes and by the whole synthesis and cut.
    out["object_step"] = {route: _object_step_reading(model, bdata, mesh, dev, whole=route == "whole")
                          for route in ("whole", "planes")}
    # One PSF fit evaluation of the blind loop's last fit: the bench model, the data, the loop's object.
    out["fit_evaluation"] = {route: _fit_evaluation(lambda: sharded_fit_cost(model, bdata, bres.obj, None, mesh),
                                                    bres.params, dev, whole=route == "whole")
                             for route in ("planes", "whole")}
    res = run("admm", lambda: sharded_admm_deconvolve(data, psf, mesh, config=cfg))
    out["admm"].update(f_history=res.f_history, finite=finite(gather(res.x)), iterations=res.iterations)
    bres = run("blind_admm", lambda: sharded_blind_deconvolve(bdata, model, mesh, config=blind_admm_config()))
    out["blind_admm"].update(deconv_f=bres.deconv_f, finite=finite(gather(bres.obj)),
                             iterations=int(bres.deconv_iters.sum()))
    del model, bdata, bres
    cres = run("blind_confocal", lambda: confocal_blind_run(mesh))
    out["blind_confocal"].update(deconv_f=cres.deconv_f, finite=finite(gather(cres.obj)))
    del cres
    # One fit evaluation of each of MP_FAMILIES, as phase 30 evaluates it on one process.
    for name in MP_FAMILIES:
        fmodel, fparams, fdata = family_fit_scene(name, dev)
        out[f"{name}_fit_evaluation"] = {route: _fit_evaluation(
            lambda: sharded_fit_cost(fmodel, fdata, torch.clamp_min(fdata, 0.0), None, mesh), fparams, dev,
            whole=route == "whole") for route in ("planes", "whole")}
        del fmodel, fdata
    _, ldata, lpsf = bench_scene(LANE_SHAPE, dev, torch.float32)
    x = gather(run("rl_tv", lambda: sharded_richardson_lucy(ldata, lpsf, mesh, iterations=20, mu=0.002,
                                                            epsilon=0.1)))
    out["rl_tv"].update(x=x, finite=finite(x))
    gl = depthvar_model(LANE_SHAPE, torch.float32, dev)
    anchors = np.linspace(0.0, LANE_SHAPE[0] - 1.0, DEPTH_K)
    with torch.no_grad():
        psfs = depth_anchor_psfs(gl, gl.init_params(), anchors)
    ddata, _ = depthvar_scene(psfs, anchors, LANE_SHAPE, dev, torch.float32)
    res = run("depthvar", lambda: sdv.sharded_deconvolve_depthvar(ddata, psfs, mesh, anchors, config=cfg))
    out["depthvar"].update(f_history=res.f_history, finite=finite(gather(res.x)))
    # One depth-varying PSF fit evaluation at the solve's object, each cell's planes of the K anchor PSFs.
    out["depthvar_fit_evaluation"] = {route: _fit_evaluation(
        lambda: sdv.sharded_depthvar_fit_cost(gl, ddata, res.x, None, mesh, anchors), gl.init_params(), dev,
        whole=route == "whole") for route in ("planes", "whole")}
    del ldata, ddata, psfs, res
    res = run("vmlmb_2x2", lambda: sharded_deconvolve(data, psf, rows, config=cfg))
    whole, nzs = gather(res.x), SHAPE[0] // rows.shape["z"]
    out["vmlmb_2x2"].update(f_history=res.f_history, finite=finite(whole), replicas_are_row0=all(
        torch.equal(t, whole[z * nzs:(z + 1) * nzs].to(t.device)) for (_, z), t in res.x.tiles.items()))
    # One objective evaluation's traffic: the halo planes, the transposes' blocks, the reductions' values.
    fun = pd.make_sharded_objective(psf, data, None, cfg, mesh)
    x0 = pd.sharded_start(data, SHAPE, mesh)
    collectives.sent.clear()
    fun(x0.variable())
    out["per_evaluation"] = dict(collectives.sent)
    return out


def phase31_rank(rank: int, world: int, tmp: str) -> None:
    """Rank ``rank`` of phase 31 (a spawned process on cuda:0): a gloo group
    (file rendezvous in ``tmp``) and the jobs of :func:`_mp_jobs`, saved to
    ``gloo<rank>.pt``; then an NCCL group of the same ranks, saved to
    ``nccl<rank>.pt`` (its refusal, or the same jobs). A failure leaves its
    traceback in ``rank<rank>.err``."""
    import datetime
    import traceback

    import torch.distributed as dist

    timeout = datetime.timedelta(seconds=MP_GROUP_TIMEOUT_S)
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{tmp}/gloo", world_size=world, rank=rank,
                                timeout=timeout)
        out = {"gloo_cuda_ops": _gloo_cuda_ops(rank, world)}
        out.update(_mp_jobs(dist.group.WORLD, [torch.device("cuda", 0)] * (SLABS // world)))
        torch.save(out, os.path.join(tmp, f"gloo{rank}.pt"))
        nccl = {}
        try:
            pg = dist.new_group(backend="nccl", timeout=timeout)
            t = torch.full((1,), float(rank), device="cuda")
            dist.all_gather([torch.empty_like(t) for _ in range(world)], t, group=pg)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001  (NCCL refusing ranks that share a card is the finding)
            nccl["refused"] = f"{type(e).__name__}: {' '.join(str(e).split())[:400]}"
        else:
            nccl.update(_mp_jobs(pg, [torch.device("cuda", 0)] * (SLABS // world)))
        torch.save(nccl, os.path.join(tmp, f"nccl{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _same_bits(a, b) -> bool:
    if isinstance(b, torch.Tensor):
        return torch.equal(torch.as_tensor(a).cpu(), b.cpu())
    return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


def _gap(a, b) -> float:
    return _rel_l2(torch.as_tensor(a), b) if isinstance(b, torch.Tensor) else _rel_f(a, b)


def _mp_check(name: str, ranks: list, refs: dict, card: str) -> dict:
    """Hold every rank's result of each job of :data:`MP_JOBS` against phase
    30's run of it on one process (bit for bit the aim, else the largest
    relative gap, within SLAB_F_RTOL), the ranks against each other bit for
    bit, the jobs' launches (TV slab launches on every rank, of all its
    cells; the ADMM jobs' split and rhs slab launches, one a cell and an
    iteration; no whole-volume or unaligned launch), the (2, 2) job's
    replicas (each rank's tiles row 0's); log the walls, the traffic and the
    launches. Returns, by job and summed over the ranks, the TV slab
    launches ("tv"), the slabs they covered ("tv_slabs"), the split and rhs
    slab launches, the bytes of halo planes sent between ranks ("halo"),
    whether the result is the one-process run's bit for bit, and the walls."""
    counts = {}
    for job, label, key, admm in MP_JOBS:
        ref = refs[job][key]
        got = [r[job][key] for r in ranks]
        if not all(_same_bits(g, got[0]) for g in got):
            raise AssertionError(f"{name} {job}: the ranks' {key} differ")
        bitwise, gap = _same_bits(got[0], ref), _gap(got[0], ref)
        if not bitwise and not gap <= SLAB_F_RTOL:
            raise AssertionError(f"{name} {job}: {key} {gap:.3g} rel off the one-process run's")
        if not all(r[job]["finite"] for r in ranks) or any(r[job]["whole"] or r[job]["unaligned"] for r in ranks):
            raise AssertionError(f"{name} {job}: an object not finite or negative, or a whole-volume or unaligned "
                                 f"launch: {[(r[job]['finite'], r[job]['whole'], r[job]['unaligned']) for r in ranks]}")
        if any(r[job]["tv"] == 0 or r[job]["tv_slabs"] != r[job]["tv"] * len(r["cells"]) for r in ranks):
            raise AssertionError(f"{name} {job}: TV slab launches {[r[job]['tv'] for r in ranks]} of slabs "
                                 f"{[r[job]['tv_slabs'] for r in ranks]}")
        slab = [(r[job]["split"], r[job]["rhs"]) for r in ranks]
        want = [(len(r["cells"]) * r[job]["iterations"],) * 2 if admm else (0, 0) for r in ranks]
        if slab != want or (admm and not all(s for s, _ in slab)):
            raise AssertionError(f"{name} {job}: split, rhs slab launches {slab} by rank, expected {want}")
        if job == "blind_confocal" and not np.all(np.diff(got[0]) < 0):
            raise AssertionError(f"{name} {job}: deconv_f {got[0]} does not fall")
        if job == "vmlmb_2x2" and not all(r[job]["replicas_are_row0"] for r in ranks):
            raise AssertionError(f"{name} {job}: a rank's replica of the volume is not row 0's")
        walls = [r[job]["wall"] for r in ranks]
        sent = {k: sum(r[job]["sent"].get(k, 0) for r in ranks) for k in SENT_KINDS}
        counts[job] = {"label": label, "admm": admm, "tv": sum(r[job]["tv"] for r in ranks),
                       "tv_slabs": sum(r[job]["tv_slabs"] for r in ranks), "split": sum(s for s, _ in slab),
                       "rhs": sum(h for _, h in slab), "halo": sent["halo"], "sent": sent, "bit_for_bit": bitwise,
                       "wall": max(walls), "one_process_wall": refs[job]["wall"]}
        log(31, f"[{card}] {name}, {job} on {label} ({len(ranks)} ranks x {len(ranks[0]['cells'])} cells): {key} "
                f"{'bit for bit' if bitwise else f'within {gap:.3g} rel of'} the one-process run's; wall "
                f"{max(walls):.3f} s (ranks {[round(w, 3) for w in walls]}; one process {refs[job]['wall']:.3f} s); "
                f"slab launches by rank: TV {[r[job]['tv'] for r in ranks]}, split, rhs {slab}; bytes sent between "
                f"ranks {sent}")
    _mp_object_step(name, ranks, refs["object_step"], card)
    per_eval = {k: sum(r["per_evaluation"].get(k, 0) for r in ranks) for k in SENT_KINDS}
    log(31, f"[{card}] {name}: one objective evaluation at x0 moved {per_eval} bytes between ranks (halo planes, "
            f"the distributed FFT's transposes, the reductions' gathered values)")
    for key, what, ny_nx in (("fit_evaluation", f"wide-field PSF fit evaluation of {SHAPE}", SHAPE[1] * SHAPE[2]),
                             ("depthvar_fit_evaluation", f"depth-varying PSF fit evaluation ({DEPTH_K} anchor PSFs of "
                                                         f"{LANE_SHAPE})", LANE_SHAPE[1] * LANE_SHAPE[2])):
        ev = {route: [r[key][route] for r in ranks] for route in ("planes", "whole")}
        sent = {route: {k: sum(e["sent"].get(k, 0) for e in evs) for k in SENT_KINDS} for route, evs in ev.items()}
        bound = sum(len(r["cells"]) for r in ranks) * (len(ranks) - 1) * 3 * ny_nx * 4
        f_gap = _rel_f([ev["planes"][0]["f"]], [ev["whole"][0]["f"]])
        g, g0 = ev["planes"][0]["grads"], ev["whole"][0]["grads"]
        g_gap = float((g - g0).abs().max() / g0.abs().max())
        log(31, f"[{card}] {name}: one {what}, cost and gradient of every family, each cell synthesizing its own "
                f"planes: bytes between ranks {sent['planes']} (the pupil's gradient at most {bound} in all), wall "
                f"{max(e['wall'] for e in ev['planes']):.4f} s, peak memory by rank "
                f"{[round(e['peak'] / 2**20, 1) for e in ev['planes']]} MiB (held before "
                f"{[round(e['before'] / 2**20, 1) for e in ev['planes']]}); by the whole synthesis and cut: bytes "
                f"{sent['whole']}, wall {max(e['wall'] for e in ev['whole']):.4f} s, peak memory "
                f"{[round(e['peak'] / 2**20, 1) for e in ev['whole']]} MiB; f within {f_gap:.3g} rel, gradient "
                f"within {g_gap:.3g} of its largest")
        if sent["planes"]["cells"] or sent["planes"]["pupil"] > bound or f_gap > SLAB_F_RTOL:
            raise AssertionError(f"{name}: the {what} by each cell's planes sent {sent['planes']} (pupil bound "
                                 f"{bound}), f {f_gap:.3g} rel off the whole synthesis")
        if not all(torch.equal(e["grads"].cpu(), g.cpu()) and e["f"] == ev["planes"][0]["f"] for e in ev["planes"]):
            raise AssertionError(f"{name}: the ranks' {what} differ")
    _mp_family_fits(name, ranks, refs["family_fits"], card)
    return counts


def _mp_family_fits(name: str, ranks: list, refs: dict, card: str) -> None:
    """Each rank's fit evaluation of each of MP_FAMILIES by each cell's
    planes against phase 30's on one process (``refs``): f and the gradient
    bit for bit (else within SLAB_F_RTOL), no byte of kind "cells", each
    cell's gradient of the plane inputs to every other rank once (kind
    "pupil"), and, over several ranks, on each a peak below the whole
    route's; log the bytes by kind, the walls and the peaks by route."""
    from microtipi_tpu_torch.models import model_for

    for fam in MP_FAMILIES:
        ev = {route: [r[f"{fam}_fit_evaluation"][route] for r in ranks] for route in ("planes", "whole")}
        sent = {route: {k: sum(e["sent"].get(k, 0) for e in evs) for k in SENT_KINDS} for route, evs in ev.items()}
        model = model_for(family_configs(SHAPE, torch.float32)[fam], torch.device("cuda", 0))
        values = sum(t.numel() for t in model.plane_inputs(_family_params(model)))
        del model
        pupil = sum(len(r["cells"]) for r in ranks) * (len(ranks) - 1) * values * 4
        ref, got = refs[fam], ev["planes"]
        bitwise = all(e["f"] == ref["f"] and torch.equal(e["grads"].cpu(), ref["grads"].cpu()) for e in got)
        f_gap = max(_rel_f([e["f"]], [ref["f"]]) for e in got)
        rise = {route: [(e["peak"] - e["before"]) / 2**20 for e in evs] for route, evs in ev.items()}
        # A rank of several holds its share of the cells' planes; one process holds all four.
        lower = len(ranks) == 1 or all(a < b for a, b in zip(rise["planes"], rise["whole"]))
        same = bitwise or f_gap <= SLAB_F_RTOL
        if sent["planes"]["cells"] or sent["planes"]["pupil"] != pupil or not same or not lower:
            raise AssertionError(f"{name}: the {fam} fit evaluation by each cell's planes sent {sent['planes']} "
                                 f"(pupil {pupil} expected), f {f_gap:.3g} rel off one process, peak rise by rank "
                                 f"{rise['planes']} MiB against the whole route's {rise['whole']}")
        log(31, f"[{card}] {name}: one {fam} PSF fit evaluation of {SHAPE}, cost and gradient of every family, each "
                f"cell synthesizing its own planes over the cells' one sum: "
                f"{'bit for bit' if bitwise else f'f within {f_gap:.3g} rel of'} the one-process run's; bytes "
                f"between ranks {sent['planes']} (pupil {values} values a cell to each other rank); wall "
                f"{max(e['wall'] for e in got):.4f} s, peak by rank {[round(e['peak'] / 2**20, 1) for e in got]} MiB "
                f"(+{[round(v, 1) for v in rise['planes']]} over what it held); by the whole synthesis and cut: "
                f"bytes {sent['whole']}, wall {max(e['wall'] for e in ev['whole']):.4f} s, peak "
                f"{[round(e['peak'] / 2**20, 1) for e in ev['whole']]} MiB (+{[round(v, 1) for v in rise['whole']]})")


def _mp_object_step(name: str, ranks: list, ref: dict, card: str) -> None:
    """Each rank's reading of the blind loop's object step
    (:func:`_object_step_reading`) beside phase 30's one-process one, by
    route: no PSF byte crosses ranks (0 bytes of kinds "cells" and "pupil"),
    the ranks' ``deconv_f`` agree bit for bit and hold phase 30's by the same
    route (bit for bit, or within SLAB_F_RTOL) and the whole route's; log
    each rank's peaks and walls."""
    for route in ("planes", "whole"):
        f = [r["object_step"][route]["deconv_f"] for r in ranks]
        want = ref[route]["deconv_f"]
        if not all(_same_bits(g, f[0]) for g in f) or not (_same_bits(f[0], want) or _rel_f(f[0], want) <= SLAB_F_RTOL):
            raise AssertionError(f"{name}: the object steps' deconv_f by {route} {f}, one process {want}")
        s = [_object_step_summary(r["object_step"][route]) for r in ranks]
        if route == "planes" and any(t["sent"]["cells"] or t["sent"]["pupil"] for t in s):
            raise AssertionError(f"{name}: an object step fed each cell's planes moved PSF bytes between ranks: "
                                 f"{[t['sent'] for t in s]}")
        one, bitwise = _object_step_summary(ref[route]), _same_bits(f[0], want)
        how = "each cell synthesizing its own planes" if route == "planes" else "the whole PSF synthesized and cut"
        log(31, f"[{card}] {name}: the blind loop's object step of {SHAPE} on (1, {SLABS}), {how}, by rank: " + "; ".join(f"rank {k}: {_object_step_text(t)}" for k, t in enumerate(s))
                + f"; bytes between ranks {[t['sent'] for t in s]}; deconv_f "
                  f"{'bit for bit' if bitwise else f'within {_rel_f(f[0], want):.3g} rel of'} the one-process run's "
                  f"(one process: {_object_step_text(one)})")
    f, f0 = ranks[0]["object_step"]["planes"]["deconv_f"], ranks[0]["object_step"]["whole"]["deconv_f"]
    if not (_same_bits(f, f0) or _rel_f(f, f0) <= SLAB_F_RTOL):
        raise AssertionError(f"{name}: the object steps' deconv_f by each cell's planes {f}, by the whole PSF {f0}")


def _mp_first_launch(ranks: list, data_x0: torch.Tensor) -> tuple[float, list]:
    """Each rank's first TV slab launch (it took a plane from the other rank)
    against its plain version on the same inputs; the plane it took equals
    the other rank's boundary plane of x0. Then each launch timed here, in
    this process alone on the card (50 raw launches; the wrapper's call and
    the plain version's, medians of 20), with its own neighbours' planes read
    in place as on the rank. Returns the largest gradient error and, by rank,
    (kernel_ms, bound_ms, bound_by, call_ms, plain_ms)."""
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

    err, times = 0.0, []
    for r in ranks:
        slabs, prevs, nexts, eps, scales = r["first_launch"]["inputs"]
        costs, grads = r["first_launch"]["outputs"]
        cells = r["cells"]
        took, at_ = [], {c: k for k, c in enumerate(cells)}
        for (b, z), prev, nxt in zip(cells, prevs, nexts):
            for nbr, plane, at in (((b, z - 1), prev, -1), ((b, z + 1), nxt, 0)):
                if plane is not None and nbr not in cells:
                    lo = nbr[1] * (SHAPE[0] // SLABS)
                    want = data_x0[lo + (SHAPE[0] // SLABS - 1 if at == -1 else 0)]
                    if not torch.equal(plane[0], want):
                        raise AssertionError(f"the halo plane of cell {nbr} that cell {(b, z)} took != that plane")
                    took.append(nbr)
        if not took:
            raise AssertionError(f"rank of cells {cells}: its first TV launch took no plane from another rank")
        cp, gp = hv.hyperbolic_tv_slab_group_plain(slabs, prevs, nexts, eps, scales)
        for c, g, c0, g0 in zip(costs, grads, cp, gp):
            err = max(err, float((g - g0).abs().max()))
            if (float(((c - c0).abs() / c0.abs()).max()) > TV_COST_RTOL
                    or not torch.allclose(g, g0, rtol=TV_GRAD_RTOL, atol=TV_GRAD_ATOL)):
                raise AssertionError(f"the TV slab launch of cells {cells} with planes from cells {took} != plain")
        # A neighbour in this launch is read in place from its slab, as the rank's launch read it; the bound
        # counts the slabs read and written and the planes received from the other rank read.
        received = sum(p is not None and (b, z + d) not in at_
                       for d, planes in ((-1, prevs), (1, nexts)) for (b, z), p in zip(cells, planes))
        prevs = [slabs[at_[(b, z - 1)]][:, -1] if (b, z - 1) in at_ else p for (b, z), p in zip(cells, prevs)]
        nexts = [slabs[at_[(b, z + 1)]][:, 0] if (b, z + 1) in at_ else p for (b, z), p in zip(cells, nexts)]
        ms = raw_ms(hv.prepare_slabs(slabs, prevs, nexts, eps, scales)[0])
        call_ms = _median_ms(lambda: hv.hyperbolic_tv_slab_group(slabs, prevs, nexts, eps, scales))
        plain_ms = _median_ms(lambda: hv.hyperbolic_tv_slab_group_plain(slabs, prevs, nexts, eps, scales))
        times.append((ms, *slab_bound(sum(t.numel() for t in slabs), slabs[0].shape[-2] * slabs[0].shape[-1], 2,
                                      received, TV_OPS_PER_VOXEL), call_ms, plain_ms))
    return err, times


def _mp_first_admm_launches(ranks: list) -> dict:
    """Each rank's first ADMM split update and rhs slab launch that took a
    plane from another rank's slab, re-run here alone on the card on their
    captured inputs: against the rank's outputs and the plain version's, bit
    for bit; then timed (50 raw launches into fresh copies of the state, the
    wrapper's call and the plain version's, medians of 20) beside the bound.
    Returns by kind the largest error against the plain version, the times
    of the slower rank's launch and each rank's ``kernel_ms``."""
    from microtipi_tpu_torch.ops.kernels import admm_split as ak

    out = {}
    for kind in ("split", "rhs"):
        err, times = 0.0, []
        for r in ranks:
            cap = r["first_admm_launch"].get(kind)
            if cap is None:
                raise AssertionError(f"rank of cells {r['cells']}: no {kind} slab launch took a plane from another rank")
            args = cap["inputs"]
            if kind == "split":
                x, xn, *state = args[:6]
                lam, eps, z_off, nz, al, pos, scales = args[6:]
                got, plain = [t.clone() for t in state], [t.clone() for t in state]
                ak.admm_split_update_slab(x, xn, *got, lam, eps, z_off, nz, al, pos, scales)
                ak.admm_split_update_slab_plain(x, xn, *plain, lam, eps, z_off, nz, al, pos, scales)
                wanted = cap["outputs"]
                fresh = [t.clone() for t in state]
                ms = raw_ms(ak.prepare_split_update(x, *fresh, lam, eps, al, pos, scales, xn, z_off, nz))
                call_ms = _median_ms(lambda: ak.admm_split_update_slab(x, xn, *fresh, lam, eps, z_off, nz, al, pos,
                                                                       scales))
                plain_ms = _median_ms(lambda: ak.admm_split_update_slab_plain(x, xn, *fresh, lam, eps, z_off, nz, al,
                                                                              pos, scales))
                volumes, ops = (SPLIT_VOLUMES, SPLIT_OPS) if al == 1.0 else (SPLIT_VOLUMES_RELAXED, SPLIT_OPS_RELAXED)
                bound = slab_bound(x.numel(), x.shape[-2] * x.shape[-1], volumes, 1, ops)
            else:
                z1, u1, z2, u2, zp, up, r1, r2, scales = args
                got, plain, wanted = [ak.admm_rhs_slab(*args)], [ak.admm_rhs_slab_plain(*args)], [cap["outputs"]]
                ms = raw_ms(ak.prepare_rhs(z1, u1, z2, u2, r1, r2, scales, zp, up)[0])
                call_ms = _median_ms(lambda: ak.admm_rhs_slab(*args))
                plain_ms = _median_ms(lambda: ak.admm_rhs_slab_plain(*args))
                bound = slab_bound(z2.numel(), z2.shape[-2] * z2.shape[-1], RHS_VOLUMES, 2, RHS_OPS)
            err = max(err, *(float((a - b).abs().max()) for a, b in zip(got, plain)))
            if not all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(got, plain, wanted)):
                raise AssertionError(f"the {kind} slab launch of cell {cap['cell']} with a plane from cell "
                                     f"{cap['from']} != its plain version or the rank's launch")
            times.append((ms, *bound, call_ms, plain_ms, cap["cell"], cap["from"]))
        ms, bound, by, call_ms, plain_ms, *_ = max(times)
        out[kind] = {"max_abs_err": err, "kernel_ms": ms, "ms": call_ms, "plain_ms": plain_ms, "library_ms": None,
                     "bound_ms": bound, "bound_by": by, "bound_share": bound / ms,
                     "kernel_ms_by_rank": [t[0] for t in times], "cells": [[t[5], t[6]] for t in times]}
    return out


def phase31_processes(card: str, refs: dict) -> dict:
    """Phase 30's sharded jobs (:data:`MP_JOBS`: VMLMB, the blind loop, ADMM,
    the blind loop by ADMM, RL-TV and depthvar on a (1, SLABS) mesh, VMLMB of
    one volume on (2, SLABS // 2)) over MP_RANKS spawned processes on cuda:0
    (gloo, every CUDA tensor staged through the host), against phase 30's
    one-process runs (``refs``); one cross-rank TV slab launch, split update
    and rhs a rank against their plain versions, timed alone; which gloo
    operations take CUDA tensors; then NCCL: MP_RANKS ranks on the card, or,
    where NCCL refuses ranks that share a card, a group of one rank (this
    process) running the same jobs through the NCCL calls. Returns each
    path's slab launches summed over the ranks (:func:`_mp_check`), the
    cross-rank TV launch's entry (error, time, bound, the gloo paths'
    launches) and the ADMM ones by kind."""
    import datetime
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    root = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()
    paths = {}
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_ranks_", dir=root) as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=phase31_rank, args=(r, MP_RANKS, tmp)) for r in range(MP_RANKS)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        end = time.monotonic() + MP_DEADLINE_S
        try:
            for p in procs:
                p.join(max(0.0, end - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        spawn_wall = time.perf_counter() - t0
        errors = "".join(open(os.path.join(tmp, f)).read() for f in sorted(os.listdir(tmp)) if f.endswith(".err"))
        codes = [p.exitcode for p in procs]
        gloo_files = [os.path.join(tmp, f"gloo{r}.pt") for r in range(MP_RANKS)]
        if not all(os.path.exists(f) for f in gloo_files):
            raise AssertionError(f"phase 31 ranks: exit codes {codes}\n{errors}")
        gloo = [torch.load(f, weights_only=False) for f in gloo_files]
        nccl_files = [os.path.join(tmp, f"nccl{r}.pt") for r in range(MP_RANKS)]
        nccl = [torch.load(f, weights_only=False) for f in nccl_files if os.path.exists(f)]
    log(31, f"{MP_RANKS} spawned ranks ran {spawn_wall:.1f} s (start-up and both groups), exit codes {codes}")
    ops = gloo[0]["gloo_cuda_ops"]
    log(31, f"gloo on CUDA tensors (torch {torch.__version__}): "
            + ", ".join(f"{k} {'takes them' if v is True else 'refuses: ' + v}" for k, v in ops.items()))
    name = f"gloo, {MP_RANKS} processes"
    n = _mp_check(name, gloo, refs, card)
    paths.update({f"sharded {c['label']}, {name} (phase 31)": c for c in n.values()})
    _, data, _ = bench_scene(SHAPE, torch.device("cuda", 0), torch.float32)
    err, times = _mp_first_launch(gloo, torch.clamp_min(data, 0.0))
    ms, bound, by, call_ms, plain_ms = max(times)
    cross = {"max_abs_err": err, "launches": sum(c["tv"] for c in paths.values()), "kernel_ms": ms,
             "ms": call_ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound, "bound_by": by,
             "bound_share": bound / ms}
    log(31, f"[{card}] each rank's first TV slab launch, which took a plane from the other rank (equal to that "
            f"rank's boundary plane of x0), against its plain version: gradient max abs err {err:.3g}; timed in "
            f"this process alone on the card after the ranks exited, 50 raw launches of "
            f"{len(gloo[0]['first_launch']['inputs'][0])} slabs with the received planes: kernel_ms "
            f"{[round(t[0], 4) for t in times]} by rank, call_ms {[round(t[3], 4) for t in times]}, plain "
            f"{[round(t[4], 4) for t in times]} ms; bound {bound:.4f} ms ({by}), {cross['bound_share']:.1%} of it "
            f"(the slower rank's)")
    admm_cross = _mp_first_admm_launches(gloo)
    for kind, e in admm_cross.items():
        e["launches"] = sum(c[kind] for c in paths.values())
        log(31, f"[{card}] each rank's first ADMM {kind} slab launch with a plane from the other rank (cells, "
                f"neighbours {e['cells']}), re-run alone on the card: bit for bit the rank's launch and the plain "
                f"version; kernel_ms {[round(t, 4) for t in e['kernel_ms_by_rank']]} by rank (50 raw launches), "
                f"call_ms {e['ms']:.4f}, plain {e['plain_ms']:.4f} ms; bound {e['bound_ms']:.4f} ms "
                f"({e['bound_by']}), {e['bound_share']:.1%} of it (the slower rank's)")

    if len(nccl) == MP_RANKS and not any("refused" in r for r in nccl):
        name = f"NCCL, {MP_RANKS} processes"
        n = _mp_check(name, nccl, refs, card)
    else:
        refusal = next((r["refused"] for r in nccl if "refused" in r), f"no result (exit codes {codes})")
        log(31, f"NCCL refused {MP_RANKS} ranks on one card: {refusal}")
        name = "NCCL, 1 process"
        torch.cuda.set_device(0)
        with tempfile.TemporaryDirectory(prefix=".chip_smoke_nccl_", dir=root) as tmp:
            dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl", world_size=1, rank=0,
                                    timeout=datetime.timedelta(seconds=MP_GROUP_TIMEOUT_S))
            try:
                one = _mp_jobs(dist.group.WORLD, [torch.device("cuda", 0)] * SLABS)
            finally:
                dist.destroy_process_group()
        n = _mp_check(name, [one], refs, card)
        log(31, "NCCL, 1 process: every cell is this rank's, so no send or receive reached NCCL (the halo planes and "
                "the transposes stay copies on the card); its calls were the reductions' all-gathers and gather's "
                "broadcasts, of one rank")
    paths.update({f"sharded {c['label']}, {name} (phase 31)": c for c in n.values()})
    return paths, cross, admm_cross


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import microtipi_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    card = phase0_card()
    phase1_build()
    kern = phase2_kernel(card)
    launches, f_vmlmb, blind_wall, blind_f = phase3_slice(card)
    if launches == 0:
        raise AssertionError("the main path never launched the TV kernel")
    phase4_parity()
    phase4_new_paths()
    phase4_depthvar()
    phase4_calibration()
    phase4_joint()
    phase4_estimation()
    phase5_cufft(card)
    bkern = phase6_batched_kernel(card)
    psf = design_psf()
    t0 = time.perf_counter()
    volume = design_volume(psf)
    setup = time.perf_counter() - t0
    batched_launches = phase7_batched(card) + phase8_tiled(card, psf, volume, setup)
    split_kern, rhs_kern = phase9_admm_kernels(card)
    admm_launches = np.sum([phase10_admm(card, f_vmlmb), phase11_blind_admm(card),
                            phase12_batched_tiled_admm(card, psf, volume)], axis=0)
    if admm_launches.min() == 0:
        raise AssertionError(f"the ADMM paths never launched a kernel: {admm_launches.tolist()}")
    rl_launches = phase13_rl(card)
    tiled_rl_launches = phase14_tiled_rl(card, psf, volume)
    prior_launches, auto_batched_launches = phase15_priors_auto_mu(card)
    phase16_uncertainty(card)
    family_launches = phase17_families(card)
    depthvar_launches, depthvar_batched_launches = phase18_depthvar(card)
    tiled_depthvar_launches = phase19_tiled_depthvar(card, volume)
    tiled_blind_launches = phase24_tiled_blind(card, volume)
    del volume
    calibration_launches = phase20_calibration(card)
    ladder_launches = phase21_depth_ladder(card)
    joint = {"time series": phase22_series(card), "multichannel separate and mixing": phase22_channels(card),
             "5D": phase22_block(card), "superres": phase22_superres(card)}
    joint_paths = {kind: {f"{name} (phase 22)": n[kind] for name, n in joint.items() if kind in n}
                   for kind in ("tv_single", "tv_batched", "split", "rhs")}
    if min(n for paths in joint_paths.values() for n in paths.values()) == 0:
        raise AssertionError(f"a joint solver's path never launched its kernel: {joint_paths}")
    blind_batch = phase23_batched_blind(card)
    if min(*blind_batch["tv_batched"].values(), blind_batch["split"], blind_batch["rhs"], tiled_blind_launches) == 0:
        raise AssertionError(f"a batched or tiled blind path never launched its kernel: {blind_batch}, tiled "
                             f"{tiled_blind_launches}")
    phase25_estimation(card)
    phase26_sim_ism(card)
    phase27_image_ops(card)
    api_launches = phase28_file_to_file(card, blind_wall)
    cli = phase29_cli_serve(card)
    slab_kern = phase30_slab_kernels(card)
    mesh_paths, mesh_refs = phase30_sharded(card, blind_f, blind_wall)
    slab_paths = {kind: {f"{name} (phase 30)": n[kind] for name, n in mesh_paths.items() if n[kind]}
                  for kind in ("tv", "split", "rhs")}
    if not all(slab_paths.values()):
        raise AssertionError(f"a slab entry was launched on no sharded path: {mesh_paths}")
    process_paths, cross_rank, admm_cross_rank = phase31_processes(card, mesh_refs)
    if not all(n["tv"] and (not n["admm"] or n["split"] and n["rhs"]) for n in process_paths.values()):
        raise AssertionError(f"a path over processes launched none of its slab kernels: {process_paths}")
    for kind in ("tv", "split", "rhs"):
        slab_paths[kind].update({name: n[kind] for name, n in process_paths.items() if n[kind]})
    tv_slabs = {f"{name} (phase 30)": n["tv_slabs"] for name, n in mesh_paths.items() if n["tv"]}
    tv_slabs.update({name: n["tv_slabs"] for name, n in process_paths.items()})
    tv_paths = {"deconvolve and blind (phase 3)": launches, "RL-TV (phase 13)": rl_launches,
                "priors and auto-mu (phase 15)": prior_launches, "confocal blind (phase 17)": family_launches,
                "depthvar and RL-TV depthvar (phase 18)": depthvar_launches,
                **{f"blind, calibration {k} (phase 20)": v for k, v in calibration_launches.items()},
                **ladder_launches, **joint_paths["tv_single"], "api file to file (phase 28)": api_launches,
                **cli["tv"]}
    batched_paths = {"batched and tiled VMLMB (phases 7-8)": batched_launches,
                     "tiled RL-TV (phase 14)": tiled_rl_launches, "batched auto-mu (phase 15)": auto_batched_launches,
                     "batched depthvar (phase 18)": depthvar_batched_launches,
                     "tiled depthvar (phase 19)": tiled_depthvar_launches, **joint_paths["tv_batched"],
                     **{f"batched blind, {k} (phase 23)": v for k, v in blind_batch["tv_batched"].items()},
                     "tiled blind (phase 24)": tiled_blind_launches, **cli["tv_batched"]}
    engine = "3D engine, blind, batched and tiled (phases 10-12)"
    blind_admm = "batched blind, per frame by ADMM (phase 23)"
    cli_admm = "CLI blind --deconv-engine admm (phase 29)"
    split_paths = {engine: int(admm_launches[0]), **joint_paths["split"], blind_admm: blind_batch["split"],
                   cli_admm: cli["split"]}
    rhs_paths = {engine: int(admm_launches[1]), **joint_paths["rhs"], blind_admm: blind_batch["rhs"],
                 cli_admm: cli["rhs"]}
    source, admm_source = "microtipi_tpu_torch/csrc/hyperbolic_tv.cu", "microtipi_tpu_torch/csrc/admm_split.cu"
    fused_by_xla = "fused by XLA under jit, no Pallas kernel"
    print(json.dumps({"kernels": [
        {"name": "hyperbolic_tv", "route": "cuda", "source": source,
         "replaces": "microtipi_tpu/ops/pallas/hyperbolic_tv.py:80 and :111", "launches": sum(tv_paths.values()),
         "launches_by_path": tv_paths, **kern},
        {"name": "hyperbolic_tv_batched", "route": "cuda", "source": source,
         "replaces": "microtipi_tpu/ops/pallas/hyperbolic_tv.py:203", "launches": sum(batched_paths.values()),
         "launches_by_path": batched_paths, **bkern},
        {"name": "admm_split_update", "route": "cuda", "source": admm_source,
         "replaces": f"microtipi_tpu/jobs/admm.py:353-368, the joint engines' :738-747 with :756-758, :1072-1094 and "
                     f":1364-1392, and microtipi_tpu/jobs/superres.py:341-353 ({fused_by_xla})",
         "launches": sum(split_paths.values()), "launches_by_path": split_paths, **split_kern},
        {"name": "admm_rhs", "route": "cuda", "source": admm_source,
         "replaces": f"microtipi_tpu/jobs/admm.py:330-331, the joint engines' :723, :1059 and :1348, and "
                     f"microtipi_tpu/jobs/superres.py:331-332 ({fused_by_xla})",
         "launches": sum(rhs_paths.values()), "launches_by_path": rhs_paths, **rhs_kern},
        {"name": "hyperbolic_tv_slab", "route": "cuda", "source": source,
         "replaces": "microtipi_tpu/ops/pallas/hyperbolic_tv.py:80, :111 and :203 on a z-sharded mesh, with the "
                     "halo exchanges GSPMD inserts around them (microtipi_tpu/parallel/deconv.py:9-14)",
         "launches": sum(slab_paths["tv"].values()), "launches_by_path": slab_paths["tv"],
         "slabs_launched": sum(tv_slabs.values()), "slabs_launched_by_path": tv_slabs,
         "halo_sends_phase30": sum(n["halo_sends"] for n in mesh_paths.values()),
         "halo_bytes_between_ranks_by_path": {name: n["halo"] for name, n in process_paths.items()},
         "over_processes_by_path": {name: {k: n[k] for k in ("bit_for_bit", "wall", "one_process_wall", "sent")}
                                    for name, n in process_paths.items()},
         "cross_rank_launch": cross_rank,
         **slab_kern["tv"]},
        {"name": "admm_split_update_slab", "route": "cuda", "source": admm_source,
         "replaces": f"microtipi_tpu/parallel/admm.py:184-196 with GSPMD's z-halo exchange ({fused_by_xla})",
         "launches": sum(slab_paths["split"].values()), "launches_by_path": slab_paths["split"],
         "cross_rank_launch": admm_cross_rank["split"], **slab_kern["split"]},
        {"name": "admm_rhs_slab", "route": "cuda", "source": admm_source,
         "replaces": f"microtipi_tpu/parallel/admm.py:170-171 with GSPMD's z-halo exchange ({fused_by_xla})",
         "launches": sum(slab_paths["rhs"].values()), "launches_by_path": slab_paths["rhs"],
         "cross_rank_launch": admm_cross_rank["rhs"], **slab_kern["rhs"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
