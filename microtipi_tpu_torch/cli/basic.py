"""`doctor`, `info` and `psf` subcommands (deployment self-check, stack
metadata, PSF synthesis).

Port of ``microtipi_tpu/cli/basic.py``. ``info`` and ``psf`` are straight
ports. ``doctor`` probes the CUDA card where the JAX one probed the TPU
runtime's quirks (``basic.py:17-120``): the card's name, compute capability
and power limit, whether the two CUDA kernels (``csrc/hyperbolic_tv.cu``,
``csrc/admm_split.cu``) build and load, and the time of one tiny solve. The
JAX command's subprocess probe of a complex device-to-host transfer served a
TPU runtime quirk and has no counterpart here.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from microtipi_tpu_torch.cli.shared import (
    _is_h5,
    _is_plate,
    _is_zarr,
    _model,
    _np,
    _psf_of,
    _resolve_geometry,
    _write_out,
)

#: The CUDA sources ``doctor`` builds and loads.
KERNEL_SOURCES = ("hyperbolic_tv", "admm_split")


def _power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reports it, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"not read ({type(e).__name__})"


def cmd_doctor(args):
    """Deployment self-check: the card, the kernels' build, a timed solve.

    Prints the torch and CUDA versions and the device; on the card its name,
    compute capability, memory and power limit, then builds and loads each
    CUDA kernel (``_build.load_library``; a failure is reported, not raised,
    so every check runs), and times a tiny 10-iteration ``deconvolve`` twice
    (the first call pays cuFFT's plans and the kernel's first load). Exits 1
    when a check failed."""
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, deconvolve
    from microtipi_tpu_torch.models.widefield import WideFieldConfig, WideFieldModel
    from microtipi_tpu_torch.ops.convolution import convolve, convolve_spectrum

    dev = args.device
    ok = True
    print(f"torch {torch.__version__}; CUDA {torch.version.cuda}; device: {dev}")
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        prop = torch.cuda.get_device_properties(idx)
        print(f"card: {prop.name}, compute capability {prop.major}.{prop.minor}, "
              f"{prop.total_memory / 2**30:.1f} GiB, power limit {_power_limit()}")
        print(f"device count: {torch.cuda.device_count()}")
        if (prop.major, prop.minor) != (9, 0):
            print("WARNING: the kernels are built for sm_90a (Hopper); this card is "
                  f"sm_{prop.major}{prop.minor}")
        from microtipi_tpu_torch._build import load_library

        for name in KERNEL_SOURCES:
            t0 = time.perf_counter()
            try:
                load_library(name)
                print(f"kernel {name}.cu: built and loaded ({time.perf_counter() - t0:.2f} s)")
            except Exception as e:  # report every check, then exit 1
                ok = False
                print(f"kernel {name}.cu: FAILED ({type(e).__name__}: {str(e).strip().splitlines()[0]})")
    else:
        print("no card asked for: the kernels are not built, their wrappers run the plain versions")

    shape = (8, 64, 64)
    model = WideFieldModel(WideFieldConfig(shape=shape, na=1.2, wavelength=500e-9, ni=1.33,
                                           dxy=100e-9, dz=300e-9), dev)
    rng = np.random.default_rng(0)
    obj = torch.as_tensor(np.abs(rng.standard_normal(shape)).astype(np.float32) * 20, device=dev)
    noise = torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=dev)

    def solve():
        psf = _psf_of(model, model.init_params())
        with torch.no_grad():
            d = convolve(obj, convolve_spectrum(psf), shape) + 0.5 * noise
        f = deconvolve(d, psf, config=DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=10, grtol=0.0)).f
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return float(f)

    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        f = solve()
        walls.append(time.perf_counter() - t0)
    finite = bool(np.isfinite(f))
    ok = ok and finite
    print(f"solve (8x64x64, 10 iters): first {walls[0]:.2f}s, then {walls[1] * 1000:.0f} ms, "
          f"cost finite: {finite}")
    print("doctor: OK" if ok else "doctor: PROBLEMS FOUND")
    if not ok:
        sys.exit(1)


def cmd_info(args):
    """Print a stack's geometry and metadata (``basic.py:122-184``)."""
    from microtipi_tpu_torch.io.tiffstack import read_pixel_size, stack_info

    if _is_plate(args.stack):
        from microtipi_tpu_torch.io.plate import plate_info

        print(plate_info(args.stack))
        return
    if _is_zarr(args.stack):
        from microtipi_tpu_torch.io.zarrstack import zarr_info

        print(zarr_info(args.stack))
        return
    if str(args.stack).lower().endswith((".ome", ".xml")):
        from microtipi_tpu_torch.io.ome import parse_ome

        with open(args.stack, "r", encoding="utf-8") as fh:
            meta = parse_ome(fh.read())
        nz, ny, nx = meta["shape"]
        files = sorted({td["filename"] for td in meta["tiff_data"] if td["filename"]})
        print(f"{args.stack}: OME companion set, Z={nz} Y={ny} X={nx} "
              f"C={meta['size_c']} T={meta['size_t']}, {len(files)} files")
        for f in files:
            print(f"  {f}")
        return
    if _is_h5(args.stack):
        from microtipi_tpu_torch.io.hdf5stack import bdv_info, list_datasets

        try:
            res, shapes = bdv_info(args.stack)
            print(f"{args.stack}: BigDataViewer pyramid, {len(shapes)} levels")
            for lvl, (shape, r) in enumerate(zip(shapes, res)):
                print(f"  level {lvl}: Nz={shape[0]} Ny={shape[1]} Nx={shape[2]} "
                      f"(downsampling {tuple(r)})")
        except Exception:
            for name in list_datasets(args.stack):
                print(f"{args.stack}: dataset {name!r}")
        return
    nz, ny, nx = stack_info(args.stack)
    line = f"{args.stack}: Nz={nz} Ny={ny} Nx={nx} ({nz*ny*nx/1e6:.1f} Mvox)"
    dxy, dz = read_pixel_size(args.stack)
    if dxy:
        line += f" dxy={dxy*1e9:.4g}nm"
    if dz:
        line += f" dz={dz*1e9:.4g}nm"
    try:
        from microtipi_tpu_torch.io.ome import read_ome

        meta = read_ome(args.stack)
    except Exception:
        meta = None
    if meta and (meta["size_c"] > 1 or meta["size_t"] > 1):
        line += f" [OME hyperstack: Z={meta['shape'][0]} C={meta['size_c']} T={meta['size_t']}]"
    print(line)
    if meta:
        for i, ch in enumerate(meta.get("channels") or []):
            em = ch.get("emission_wavelength")
            bits = [f"channel {i}"]
            if ch.get("name"):
                bits.append(ch["name"])
            if em:
                bits.append(f"emission {em*1e9:.4g} nm")
            print("  " + ": ".join(bits))


def cmd_psf(args):
    """Synthesize a PSF stack from the model flags (``basic.py:187-206``)."""
    from microtipi_tpu_torch.utils.arrays import roll

    shape = tuple(args.shape)
    _resolve_geometry(args)  # no input stack: fall back to defaults
    model = _model(args, shape)
    params = model.init_params()
    if args.phase:
        if len(args.phase) != args.n_phase:
            sys.exit(f"--phase needs {args.n_phase} coefficients")
        params = params._replace(phase=torch.as_tensor(args.phase, dtype=torch.float32, device=model.device))
    psf = _psf_of(model, params)
    if args.centered:
        psf = roll(psf)
    _write_out(args, args.out, _np(psf), dxy=args.dxy, dz=args.dz)
    print(f"wrote {args.out} (sum={float(psf.sum()):.4g})")
