"""Auxiliary subcommands: ``simulate``, ``register``, ``deskew``, ``fsc``,
``fuse``, ``ism``, ``sim`` (structured illumination) and ``watch`` (the
serving loop).

Port of ``microtipi_tpu/cli/tools.py`` on the ported jobs and image ops run
on ``args.device``. ``watch --devices N`` serves on ``cuda:0`` ..
``cuda:N-1`` and exits when fewer are present, as the JAX command does.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from microtipi_tpu_torch.cli.shared import (
    _build_model,
    _build_preprocess,
    _depthvar_anchor_array,
    _family_map,
    _load_params_json,
    _model,
    _np,
    _psf_of,
    _read_input_volume,
    _resolve_geometry,
    _tensor,
    _write_out,
)


def cmd_simulate(args):
    """Synthesize a realistic acquisition: phantom -> PSF blur -> camera
    noise (``tools.py:21-84``)."""
    from microtipi_tpu_torch.ops.convolution import convolve, convolve_spectrum
    from microtipi_tpu_torch.utils import phantoms

    shape = tuple(args.shape)
    _resolve_geometry(args)
    gen = {
        "beads": lambda: phantoms.beads_phantom(shape, n=args.n, seed=args.seed),
        "filaments": lambda: phantoms.filaments_phantom(shape, n=args.n, seed=args.seed),
        "shells": lambda: phantoms.shells_phantom(shape, n=args.n, seed=args.seed),
    }[args.phantom]
    obj = gen()
    model = _model(args, shape)
    params = model.init_params()
    if args.params_json:
        params = _load_params_json(model, args.params_json)
    if args.phase:
        params = params._replace(phase=torch.as_tensor(args.phase, dtype=model.dtype, device=model.device))

    dv = getattr(args, "depthvar", 0)
    o = _tensor(args, obj, model.dtype)
    with torch.no_grad():
        if dv:
            if args.model != "gl":
                sys.exit("simulate --depthvar requires --model gl")
            from microtipi_tpu_torch.jobs.depthvar import depth_anchor_psfs
            from microtipi_tpu_torch.ops.depthconv import depth_varying_convolve, depth_weights

            anchors = _depthvar_anchor_array(args, dv, shape[0])
            zw = depth_weights(shape[0], anchors)
            psfs = depth_anchor_psfs(model, params, anchors, depth0=params.depth[1])
            clean = depth_varying_convolve(o, torch.fft.rfftn(psfs, dim=(1, 2, 3)),
                                           torch.as_tensor(zw, dtype=model.dtype, device=model.device), shape)
        else:
            clean = convolve(o, convolve_spectrum(model.compute_psf(params)), shape)
    noisy = phantoms.apply_camera(
        _np(clean), photons_at_max=args.photons, gain=args.gain_sim,
        readout_sigma=args.readout_sim, offset=args.offset, seed=args.seed)
    _write_out(args, args.out, noisy, dxy=args.dxy, dz=args.dz)
    print(f"wrote {args.out} ({args.phantom}, {shape}, ~{args.photons:.3g} "
          f"photons at peak; deconvolve with --gain {args.gain_sim} "
          f"--readout {args.readout_sim**2:.3g})")
    if args.truth:
        _write_out(args, args.truth, obj, dxy=args.dxy, dz=args.dz)
        print("wrote", args.truth)
    if args.psf_out:
        _write_out(args, args.psf_out, _np(_psf_of(model, params)), dxy=args.dxy, dz=args.dz)
        print("wrote", args.psf_out)


def cmd_register(args):
    """Align volumes by subvoxel phase correlation + exact Fourier shift
    (``tools.py:87-158``).

    Two modes: ``register ref.tif mov.tif --out aligned.tif`` writes the
    moving volume aligned to the reference (optionally blur-matched with
    ``--psf-ref/--psf-mov``); ``register stack.ome.tif --align-channels
    --out aligned.ome.tif`` registers every channel of a hyperstack to
    ``--to-channel`` (chromatic-shift correction), writing the full
    corrected hyperstack.
    """
    from microtipi_tpu_torch.ops.register import fourier_shift, register_translation

    if args.align_channels:
        from microtipi_tpu_torch.io.ome import read_ome_hyperstack, write_ome_hyperstack

        arr, meta = read_ome_hyperstack(args.ref)
        nt, nc = arr.shape[:2]
        if nc < 2:
            sys.exit(f"--align-channels: input has C={nc}")
        if not 0 <= args.to_channel < nc:
            sys.exit(f"--to-channel {args.to_channel} out of range (C={nc})")
        out = np.array(arr)
        for c in range(nc):
            if c == args.to_channel:
                continue
            # one chromatic shift per channel, measured at timepoint 0 and
            # applied to every timepoint (the offset is an optics property)
            t_ref = _tensor(args, arr[0, args.to_channel])
            shift = register_translation(t_ref, _tensor(args, arr[0, c]))
            print(f"channel {c} -> {args.to_channel}: shift "
                  f"{np.round(_np(shift), 3)} voxels")
            for t in range(nt):
                out[t, c] = _np(fourier_shift(_tensor(args, arr[t, c]), shift))
        write_ome_hyperstack(args.out, out, dxy=meta.get("dxy"), dz=meta.get("dz"))
        print("wrote", args.out)
        return

    if not args.mov:
        sys.exit("two-volume mode needs REF MOV (or use --align-channels)")
    a = _tensor(args, _read_input_volume(args, args.ref))
    b = _tensor(args, _read_input_volume(args, args.mov))
    if a.shape != b.shape:
        sys.exit(f"volume shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    _resolve_geometry(args, args.ref, log=lambda *a: None)
    if args.psf_ref or args.psf_mov:
        from microtipi_tpu_torch.io.tiffstack import read_stack
        from microtipi_tpu_torch.ops.convolution import convolve, convolve_spectrum

        if not (args.psf_ref and args.psf_mov):
            sys.exit("--psf-ref and --psf-mov go together (blur matching)")
        ha = _tensor(args, read_stack(args.psf_ref))
        hb = _tensor(args, read_stack(args.psf_mov))
        am = convolve(a, convolve_spectrum(hb), tuple(a.shape))
        bm = convolve(b, convolve_spectrum(ha), tuple(b.shape))
        shift = register_translation(am, bm)
    else:
        shift = register_translation(a, b)
    print(f"shift: {np.round(_np(shift), 3)} voxels")
    aligned = _np(fourier_shift(b, shift))
    _write_out(args, args.out, aligned, dxy=args.dxy, dz=args.dz)
    print("wrote", args.out)


def cmd_deskew(args):
    """Deskew a stage-scanned light-sheet stack onto an orthogonal grid
    (``tools.py:161-179``)."""
    from microtipi_tpu_torch.ops.geometry import deskew, deskew_geometry

    data = _tensor(args, _read_input_volume(args, args.stack))
    _resolve_geometry(args, args.stack)
    t0 = time.time()
    out = _np(deskew(data, args.angle, args.dz, args.dxy, invert=args.invert)[0])
    _, _, dz_new = deskew_geometry(tuple(data.shape), args.angle, args.dz, args.dxy)
    print(f"deskew: {tuple(data.shape)} -> {out.shape}, angle {args.angle} deg, "
          f"dz {args.dz*1e9:.4g} -> {dz_new*1e9:.4g} nm, "
          f"{time.time()-t0:.1f}s")
    _write_out(args, args.out, out, dxy=args.dxy, dz=dz_new)
    print("wrote", args.out)


def cmd_fsc(args):
    """Fourier Shell Correlation resolution of two registered volumes
    (``tools.py:182-234``)."""
    import json

    from microtipi_tpu_torch.ops.metrics import fourier_shell_correlation, fsc_resolution

    if args.split:
        from microtipi_tpu_torch.ops.metrics import checkerboard_split

        if args.b is not None:
            sys.exit("--split is single-volume mode; drop the second input")
        _resolve_geometry(args, args.a)
        a, b = checkerboard_split(_tensor(args, _read_input_volume(args, args.a)))
        args.dxy *= 2  # decimated lateral pitch
        print("single-image FSC (checkerboard split): resolution bounded at "
              f"{4 * args.dxy / 2 * 1e9:.0f} nm (2x-decimated Nyquist); "
              "prefer two acquisitions when the answer is near that bound")
    else:
        if args.b is None:
            sys.exit("fsc needs two volumes (or one with --split)")
        a = _tensor(args, _read_input_volume(args, args.a))
        b = _tensor(args, _read_input_volume(args, args.b))
        if a.shape != b.shape:
            sys.exit(f"volume shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
        _resolve_geometry(args, args.a)
    if args.register:
        from microtipi_tpu_torch.ops.register import fourier_shift, register_translation

        t = register_translation(a, b)
        b = fourier_shift(b, t)
        print(f"registered shift: {np.round(_np(t), 3)}")
    spacing = (args.dz, args.dxy, args.dxy)
    freqs, fsc = fourier_shell_correlation(a, b, spacing=spacing)
    res = fsc_resolution(freqs, fsc, threshold=args.threshold)
    crossed = bool((_np(fsc)[1:] < args.threshold).any())
    print(f"FSC resolution: {res*1e9:.1f} nm "
          f"(threshold {args.threshold}"
          f"{'' if crossed else '; never crossed - sampling-limited'})")
    if args.report:
        with open(args.report, "w") as fh:
            json.dump({
                "resolution_m": float(res),
                "threshold": args.threshold,
                "sampling_limited": not crossed,
                "freqs_per_m": _np(freqs).tolist(),
                "fsc": _np(fsc).tolist(),
            }, fh, indent=1)
        print("wrote", args.report)


def cmd_fuse(args):
    """Multi-view RL fusion: K registered views, K PSFs, one estimate
    (``tools.py:237-283``)."""
    from microtipi_tpu_torch.io.tiffstack import read_stack
    from microtipi_tpu_torch.jobs.richardson_lucy import multiview_richardson_lucy
    from microtipi_tpu_torch.utils.arrays import unroll

    if len(args.views) != len(args.psf):
        sys.exit(f"{len(args.views)} views but {len(args.psf)} PSFs — need one PSF per view")
    views = torch.stack([_tensor(args, read_stack(p)) for p in args.views])
    psfs = torch.stack([_tensor(args, read_stack(p)) for p in args.psf])
    if args.psf_centered:
        psfs = unroll(psfs, axes=(-3, -2, -1))
    if psfs.shape != views.shape:
        sys.exit(f"view stack {tuple(views.shape[1:])} vs PSF stack {tuple(psfs.shape[1:])} shape mismatch")
    if args.register and len(args.views) > 1:
        from microtipi_tpu_torch.ops.convolution import convolve, convolve_spectrum
        from microtipi_tpu_torch.ops.register import fourier_shift, register_translation

        def reg_one(v0, p0, v, p):
            # Blur-match so phase correlation sees one transfer function
            # (ops/register.py docstring).
            a = convolve(v0, convolve_spectrum(p), tuple(v0.shape))
            b = convolve(v, convolve_spectrum(p0), tuple(v0.shape))
            t = register_translation(a, b)
            return t, torch.clamp_min(fourier_shift(v, t), 0.0)

        regd = [views[0]]
        for k in range(1, views.shape[0]):
            t, vk = reg_one(views[0], psfs[0], views[k], psfs[k])
            print(f"view {k}: shift {np.round(_np(t), 2).tolist()} voxels")
            regd.append(vk)
        views = torch.stack(regd)
    bp = {"matched": "matched", "wb": "wiener-butterworth"}[args.rl_backprojector]
    t0 = time.time()
    x = multiview_richardson_lucy(views, psfs, iterations=args.iters, background=args.background,
                                  backprojector=bp)
    x = _np(x)
    print(f"fuse: {len(args.views)} views, {args.iters} RL iterations, "
          f"{time.time()-t0:.1f}s")
    _write_out(args, args.out, x, dxy=getattr(args, "dxy", None), dz=getattr(args, "dz", None))
    print("wrote", args.out)


def cmd_ism(args):
    """ISM / Airyscan reconstruction (``tools.py:286-359``): pixel
    reassignment or joint MLE over the detector-array element images
    (models/ism.py, jobs/ism.py)."""
    from microtipi_tpu_torch.jobs.ism import ism_reassign, ism_richardson_lucy
    from microtipi_tpu_torch.models.ism import ISMConfig, ISMModel
    from microtipi_tpu_torch.utils.arrays import roll

    if args.model != "widefield":
        sys.exit("ism builds its own detector-array model from the scalar "
                 "pupil; --model is not supported here")
    k = 1 + 3 * args.rings * (args.rings + 1)
    if len(args.data) == 1:
        vol = np.asarray(_read_input_volume(args, args.data[0]))
        if vol.shape[0] % k:
            sys.exit(f"{args.data[0]}: {vol.shape[0]} planes does not split "
                     f"into {k} element volumes (--rings {args.rings}); "
                     "planes must be element-major (element 0's z stack "
                     "first, center-out hex order)")
        data = vol.reshape(k, vol.shape[0] // k, *vol.shape[1:])
    else:
        if len(args.data) != k:
            sys.exit(f"need 1 interleaved stack or {k} element stacks "
                     f"(--rings {args.rings}), got {len(args.data)}")
        vols = [np.asarray(_read_input_volume(args, p)) for p in args.data]
        if len({v.shape for v in vols}) != 1:
            sys.exit(f"element stacks must share one shape, got "
                     f"{[v.shape for v in vols]}")
        data = np.stack(vols)
    _resolve_geometry(args, args.data[0])  # after reads: metadata autofill
    # --element-radius is the ISM name; fall back to _model_args' --pinhole
    # (same physical quantity) instead of silently discarding it
    element_r = args.element_radius if args.element_radius else args.pinhole
    config = ISMConfig(
        shape=tuple(data.shape[1:]), na=args.na, wavelength=args.wavelength,
        wavelength_exc=args.wavelength_exc, ni=args.ni, dxy=args.dxy,
        dz=args.dz, n_phase=args.n_phase, n_modulus=args.n_modulus,
        radial=args.radial, element_pitch=args.pitch, rings=args.rings,
        pinhole=element_r, reassign_factor=args.reassign_factor,
    )
    model = ISMModel(config, args.device)
    params = (_load_params_json(model, args.params_json)
              if args.params_json else model.init_params())
    data = _tensor(args, data, model.dtype)
    gains = None
    if args.auto_gains:
        from microtipi_tpu_torch.jobs.ism import ism_element_gains

        gains = ism_element_gains(model, params, data, background=args.background)
        print("element gains (relative, mean 1):",
              np.round(_np(gains), 4).tolist())
    t0 = time.time()
    if args.method == "reassign":
        x = ism_reassign(model, data, gains=gains)
        what = f"pixel reassignment (s={config.reassign_factor})"
    else:
        bp = {"matched": "matched", "wb": "wiener-butterworth"}[args.rl_backprojector]
        x = ism_richardson_lucy(model, params, data, iterations=args.iters, background=args.background,
                                backprojector=bp, gains=gains)
        what = f"joint MLE over {k} elements, {args.iters} RL iterations"
    x = _np(x)
    print(f"ism: {what}, {time.time()-t0:.1f}s")
    _write_out(args, args.out, x, dxy=args.dxy, dz=args.dz)
    print("wrote", args.out)
    if args.psf_out:
        h = _psf_of(model, params)
        if args.centered:
            h = roll(h)
        _write_out(args, args.psf_out, _np(h), dxy=args.dxy, dz=args.dz)
        print(f"wrote {args.psf_out} (reassigned-sum ISM PSF — feed to "
              f"deconv --psf for Airyscan-style joint deconvolution)")


def _sim_pattern(args, a_n, p_n):
    """(pattern_k (A, 2) cycles/pixel, phases (A, P)) from the period,
    angle and phase-offset flags (``tools.py:398-408``, ``:461-471``)."""
    if len(args.pattern_angle_deg) != a_n:
        sys.exit(f"--pattern-angle-deg needs {a_n} angles")
    k_mag = args.dxy / args.pattern_period
    a_k = np.stack([[k_mag * np.sin(np.deg2rad(t)),
                     k_mag * np.cos(np.deg2rad(t))]
                    for t in args.pattern_angle_deg])
    ph = np.tile(2 * np.pi / p_n * np.arange(p_n), (a_n, 1))
    return a_k, ph


def _cmd_sim3d(args, vol, a_n, p_n):
    """3-beam 3D-SIM reconstruction (``tools.py:362-422``,
    jobs/sim.py::reconstruct_sim3d): five-order band separation per angle,
    axial +-1 bands inside the order OTFs, generalized Wiener on the
    extended 3D grid."""
    from microtipi_tpu_torch.io.tiffstack import read_stack
    from microtipi_tpu_torch.jobs.sim import reconstruct_sim3d

    if p_n < 5:
        sys.exit("3D-SIM needs --phase-count >= 5 (five illumination orders)")
    if getattr(args, "refine", False):
        sys.exit("--refine is 2D-only for now; pass calibrated "
                 "--pattern-period/--pattern-phase0 for 3D-SIM")
    if vol.shape[0] % (a_n * p_n):
        sys.exit(f"{args.data}: {vol.shape[0]} planes not divisible by "
                 f"angles*phases = {a_n * p_n} (angle-major, phase-minor, "
                 "z-innermost order expected)")
    nz = vol.shape[0] // (a_n * p_n)
    ny, nx = vol.shape[1:]
    data = _tensor(args, vol.reshape(a_n, p_n, nz, ny, nx), torch.float64)

    if args.psf:
        h = np.asarray(read_stack(args.psf), np.float64)
        if h.shape != (nz, ny, nx):
            sys.exit(f"--psf must be the 3D detection PSF {(nz, ny, nx)}, "
                     f"got {h.shape}")
        if args.psf_centered:
            h = np.fft.ifftshift(h)
    else:
        model = _model(args, (nz, ny, nx))
        h = _np(_psf_of(model, model.init_params())).astype(np.float64)
    h = _tensor(args, h / h.sum())

    a_k, ph = _sim_pattern(args, a_n, p_n)
    if args.pattern_phase0:
        if len(args.pattern_phase0) != a_n:
            sys.exit(f"--pattern-phase0 needs {a_n} offsets")
        ph = ph + np.asarray(args.pattern_phase0)[:, None]
    q = args.dz / args.axial_period  # cycles per z-plane

    t0 = time.time()
    up_z = not args.no_axial_upsample
    out = _np(reconstruct_sim3d(data, h, a_k, ph, q=q, psi=args.axial_phase, m1=args.m1, m2=args.m2,
                                wiener=args.wiener, upsample_z=up_z).x)
    print(f"sim[3d]: {a_n} angles x {p_n} phases x {nz} planes -> "
          f"{out.shape[0]}x{out.shape[1]}x{out.shape[2]} "
          f"(q = {q:.3f} cyc/plane), {time.time()-t0:.1f}s")
    _write_out(args, args.out, out, dxy=args.dxy / 2,
               dz=args.dz / 2 if up_z else args.dz)
    print("wrote", args.out)


def cmd_sim(args):
    """Structured-illumination reconstruction (``tools.py:425-497``,
    jobs/sim.py): band separation + generalized-Wiener recombination on a 2x
    grid, with optional data-driven pattern self-calibration."""
    from microtipi_tpu_torch.io.tiffstack import read_stack
    from microtipi_tpu_torch.jobs.sim import estimate_sim_pattern, reconstruct_sim

    vol = np.asarray(_read_input_volume(args, args.data))
    _resolve_geometry(args, args.data)
    a_n, p_n = args.angles, args.phase_count
    if getattr(args, "axial_period", None) is not None:
        _cmd_sim3d(args, vol, a_n, p_n)
        return
    if vol.shape[0] != a_n * p_n:
        sys.exit(f"{args.data}: {vol.shape[0]} planes != angles*phases = "
                 f"{a_n * p_n} (angle-major plane order expected)")
    data = _tensor(args, vol.reshape(a_n, p_n, *vol.shape[1:]), torch.float64)

    # 2D PSF/OTF: supplied file or the pupil model at Nz=1
    if args.psf:
        h = np.asarray(read_stack(args.psf), np.float64)
        h = h[0] if h.ndim == 3 else h
        if args.psf_centered:
            h = np.fft.ifftshift(h)
    else:
        model = _model(args, (1,) + vol.shape[1:])
        h = _np(_psf_of(model, model.init_params()))[0].astype(np.float64)
    h = h / h.sum()
    otf = _tensor(args, np.fft.fft2(h.astype(np.complex128)))

    a_k, ph = _sim_pattern(args, a_n, p_n)
    if args.pattern_phase0 is not None and len(args.pattern_phase0) != a_n:
        sys.exit(f"--pattern-phase0 needs {a_n} offsets (one per angle)")
    if args.pattern_phase0:
        ph = ph + np.asarray(args.pattern_phase0)[:, None]

    if args.refine:
        t0 = time.time()
        a_k, ph = estimate_sim_pattern(data, otf, a_k, ph, modulation=args.modulation)
        a_k, ph = np.asarray(a_k), np.asarray(ph)
        print(f"pattern self-calibration ({time.time()-t0:.1f}s):")
        for a in range(a_n):
            period = args.dxy / float(np.hypot(*a_k[a]))
            print(f"  angle {a}: period {period*1e9:.2f} nm, "
                  f"phase0 {ph[a, 0]:+.3f} rad")
    t0 = time.time()
    rec = reconstruct_sim(data, otf, a_k, ph, modulation=args.modulation, wiener=args.wiener).x
    print(f"sim: {a_n} angles x {p_n} phases -> "
          f"{rec.shape[0]}x{rec.shape[1]} (2x grid), "
          f"{time.time()-t0:.1f}s")
    out = _np(rec)[None]  # (1, 2Ny, 2Nx) volume convention
    _write_out(args, args.out, out, dxy=args.dxy / 2, dz=args.dz)
    print("wrote", args.out)


def cmd_watch(args):
    """``watch`` (``tools.py:500-556``): the serving loop of ``serve.watch``
    on ``args.device``, or round-robin over ``cuda:0`` .. ``cuda:N-1`` with
    ``--devices N``."""
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
    from microtipi_tpu_torch.serve import watch

    cfg = DeconvolutionConfig(mu=args.mu, epsilon=args.epsilon, max_iter=args.iters,
                              positivity=not args.no_positivity)
    model_factory = blind_cfg = depthvar_params = None
    if args.method in ("blind", "blind-once"):
        from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig

        _resolve_geometry(args)  # no single input stack: flags or defaults
        fam_map = _family_map()
        if "cavity" in args.families and args.model != "4pi":
            sys.exit("--families cavity requires --model 4pi")
        families = tuple(fam_map[f] for f in args.families)
        kw = dict(loops=args.loops, families=families,
                  psf_max_iter=tuple(args.psf_iters for _ in families), deconv=cfg)
        blind_cfg = (BlindDeconvConfig.recommended(**kw) if args.recipe == "quality"
                     else BlindDeconvConfig(**kw))
        model_factory = lambda shape: _build_model(args, shape)  # noqa: E731
        if getattr(args, "depthvar", 0):
            sys.exit("watch --depthvar rides the vmlmb path")
    elif getattr(args, "depthvar", 0):
        if args.model != "gl":
            sys.exit("watch --depthvar requires --model gl")
        _resolve_geometry(args)
        model_factory = lambda shape: _build_model(args, shape)  # noqa: E731
        if args.params_json:
            # Parameters live on the pupil, not the grid: load against a
            # nominal-shape model, serve at every arriving shape.
            depthvar_params = _load_params_json(_model(args, (8, 32, 32)), args.params_json)
    elif not args.psf:
        sys.exit("--psf is required for method vmlmb/rl")
    devices = [args.device]
    if args.devices:
        if args.device.type != "cuda":
            sys.exit(f"--devices {args.devices} fans out over CUDA cards; this run is on {args.device}")
        present = torch.cuda.device_count()
        if present < args.devices:
            sys.exit(f"--devices {args.devices}: only {present} present")
        devices = [torch.device("cuda", i) for i in range(args.devices)]
    watch(args.indir, args.outdir, args.psf, config=cfg, method=args.method,
          rl_iterations=args.iters, poll_seconds=args.poll,
          max_files=args.max_files, metrics_path=args.metrics,
          metrics_port=args.metrics_port,
          model_factory=model_factory, blind_config=blind_cfg,
          channel=args.channel, timepoint=args.timepoint, devices=devices,
          bead_path=args.bead, bead_n=args.bead_n,
          priority_patterns=args.priority, zarr_levels=args.zarr_levels,
          preprocess=_build_preprocess(args),
          auto_mu=args.auto_mu, auto_mu_tau=args.tau,
          auto_mu_sigma=args.noise_sigma, auto_gain=args.auto_gain,
          depthvar_k=getattr(args, "depthvar", 0),
          depthvar_params=depthvar_params)
