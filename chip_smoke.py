#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card, and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (any CUDA
card of compute capability 9.0a). It imports ``microtipi_tpu_torch`` and
never jax. Phases, one line of findings each (``[phase N] ...``); any failure
raises and the script exits non-zero:

0. the card: name and power limit (nvidia-smi), torch and CUDA versions, and
   that float32 matmuls run in full float32 (TF32 off);
1. build the hyperbolic-TV CUDA kernel from ``microtipi_tpu_torch/csrc``;
2. the kernel against its plain PyTorch version on the card, then its time
   and the plain version's per evaluation at 256^3;
3. the slice at full size on the bench scene of ``bench.py`` (256^3):
   ``deconvolve`` (20 VMLMB iterations) and ``blind_deconvolve`` (5 rounds,
   joint defocus+phase fit), with the kernel's launch count;
4. card (float32, kernel) against CPU (float64, plain version) parity;
5. cuFFT float32 precision against float64 NumPy at 256^3.

The line before the last is ``{"kernels": [...]}`` with each kernel's launch
count in phase 3, error and times; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card it exits 2 and prints
no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SHAPE = (256, 256, 256)
PARITY_SHAPE = (16, 64, 64)
KERNEL_SHAPES = (SHAPE, (37, 64, 96), (256, 8, 128))
# The fused-TV tolerances of tests/test_pallas_tv.py:25-26 (float32 kernel
# against the float32 plain version: sums in another order), and its 256-plane
# accumulation bound against float64 (:50-57).
TV_COST_RTOL, TV_GRAD_RTOL, TV_GRAD_ATOL, TV_F64_RTOL = 1e-5, 1e-4, 1e-5, 5e-7


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
    from microtipi_tpu_torch._build import load_library

    t0 = time.perf_counter()
    load_library("hyperbolic_tv")
    log(1, f"built hyperbolic_tv.cu with nvcc in {time.perf_counter() - t0:.2f} s")


def _median_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Median over ``n`` calls of the CUDA-event time of one call."""
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
    torch.cuda.synchronize()
    log(2, f"kernel == plain at {list(KERNEL_SHAPES)}, eps (0.1, 1.0), scales (None, (2,1,1)): "
           f"cost rtol {TV_COST_RTOL}, grad rtol {TV_GRAD_RTOL} atol {TV_GRAD_ATOL} "
           f"(max grad abs err {max_err:.3g}); 256-plane cost within {TV_F64_RTOL} of float64; "
           "constant volume 0; two launches bitwise equal")

    x = torch.as_tensor(np.random.default_rng(0).standard_normal(SHAPE, dtype=np.float32), device=dev)
    ms = _median_ms(lambda: hv.hyperbolic_tv_fused(x, 1.0))
    plain_ms = _median_ms(lambda: hv.hyperbolic_tv_plain(x, 1.0))
    moved = 2 * x.numel() * x.element_size()
    log(2, f"[{card}] TV at {SHAPE}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per evaluation "
           f"(median of 20, CUDA events); kernel {moved / (ms * 1e-3) / 1e9:.1f} GB/s "
           f"against its floor of {moved / 2**20:.0f} MiB moved")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def bench_scene(shape, device, dtype, phase=None):
    """The bench's widefield model and data (``bench.py:79-92,182-189``):
    sparse random beads blurred by the PSF, plus 1% Gaussian noise."""
    from microtipi_tpu_torch.models.widefield import WideFieldConfig, WideFieldModel
    from microtipi_tpu_torch.ops.convolution import convolve, convolve_spectrum

    model = WideFieldModel(WideFieldConfig(shape=shape, na=1.4, wavelength=561e-9, ni=1.518, dxy=80e-9,
                                           dz=200e-9, n_phase=6, n_modulus=1, dtype=dtype), device=device)
    rng = np.random.default_rng(0)
    obj = rng.random(shape, dtype=np.float32) * (rng.random(shape) > 0.999) * 300
    noise = rng.standard_normal(shape).astype(np.float32)
    obj = torch.as_tensor(obj, dtype=dtype, device=device)
    noise = torch.as_tensor(noise, dtype=dtype, device=device)
    params = model.init_params()
    if phase is not None:
        params = params._replace(phase=torch.as_tensor(phase, dtype=dtype, device=device))
    with torch.no_grad():
        d = convolve(obj, convolve_spectrum(model.compute_psf(params)), shape)
        return model, d + 0.01 * d.max() * noise, model.compute_psf(model.init_params())


def _check_object(name: str, x: torch.Tensor) -> None:
    if not bool(torch.isfinite(x).all()) or float(x.min()) < 0:
        raise AssertionError(f"{name}: object not finite and non-negative")


def phase3_slice(card: str) -> int:
    from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig, blind_deconvolve
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, deconvolve
    from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig
    from microtipi_tpu_torch.models.microscope import DEFOCUS, PHASE
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

    dev, nvox = torch.device("cuda"), float(np.prod(SHAPE))
    _, data, psf = bench_scene(SHAPE, dev, torch.float32)
    cfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=20, grtol=0.0, gatol=0.0)
    torch.cuda.reset_peak_memory_stats()
    hv.launches = 0
    deconvolve(data, psf, config=cfg)  # warm-up (cuFFT plans, the kernel's first load)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = deconvolve(data, psf, config=cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    deconv_launches = hv.launches
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
    return hv.launches


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import microtipi_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    card = phase0_card()
    phase1_build()
    kern = phase2_kernel(card)
    launches = phase3_slice(card)
    if launches == 0:
        raise AssertionError("the main path never launched the TV kernel")
    phase4_parity()
    phase5_cufft(card)
    print(json.dumps({"kernels": [{
        "name": "hyperbolic_tv", "route": "cuda", "source": "microtipi_tpu_torch/csrc/hyperbolic_tv.cu",
        "replaces": "microtipi_tpu/ops/pallas/hyperbolic_tv.py:111", "launches": launches, **kern,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
