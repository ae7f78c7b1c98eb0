"""Non-blind deconvolution mode variants behind ``deconv``: depth-varying,
HCS plate fan-out, time-series, multichannel (joint + unmixing), 5D
timeseries-multichannel, and super-resolution upsampling.

Port of ``microtipi_tpu/cli/deconv_modes.py``, on the ported jobs
(``jobs/depthvar``, ``timeseries``, ``multichannel``, ``superres``,
``admm``, ``autotune``) run directly on ``args.device``. Where the JAX module
cached one jitted solver per volume shape, the plate fan-out caches one
closure per shape (the model and anchors it builds).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from microtipi_tpu_torch.cli.shared import (
    _deconv_config,
    _depthvar_anchor_array,
    _load_params_json,
    _load_pupil_maps,
    _model,
    _np,
    _plate_fan_out,
    _prep_hyperstack,
    _psf_of,
    _read_hyperstack,
    _resolve_geometry,
    _tensor,
    _weights,
    _write_hyperstack,
    _write_out,
)


def _cmd_deconv_depthvar(args, data):
    """deconv --depthvar K / --depthvar-maps NPZ... (``deconv_modes.py:26-112``):
    depth-varying solve with K anchor PSFs blended along z, synthesized from
    Gibson-Lanni parameters (--params-json) or from measured retrieved pupil
    maps (fitpsf --retrieve-map outputs, one per calibration depth)."""
    from microtipi_tpu_torch.jobs.depthvar import (
        deconvolve_depthvar, depth_anchor_psfs, depth_anchor_psfs_from_maps)

    maps = getattr(args, "depthvar_maps", None)
    if maps and getattr(args, "depthvar", 0):
        sys.exit("--depthvar K and --depthvar-maps are alternative anchor "
                 "routes; pass one")
    if getattr(args, "mesh", None):
        sys.exit("--depthvar is single-device for now (no --mesh)")
    _resolve_geometry(args, args.data)
    k = len(maps) if maps else args.depthvar
    # maps: keep user order here — depths pair with the map files and are
    # argsorted together below.
    anchors = _depthvar_anchor_array(args, k, data.shape[0],
                                     sort=not maps)
    cfg = _deconv_config(args, data.shape)
    w = _weights(args, data)
    t0 = time.time()

    rl = args.method == "rl"
    if rl and w is not None:
        sys.exit("--method rl is Poisson-MLE; it does not take weights "
                 "(drop --gain/--auto-gain or use the VMLMB path)")

    def solve(d, psfs, wt):
        if rl:
            from microtipi_tpu_torch.jobs.depthvar import richardson_lucy_depthvar

            x, iters = richardson_lucy_depthvar(
                d, psfs, anchors, iterations=args.iters, mu=cfg.mu,
                epsilon=cfg.epsilon, accelerate=args.rl_accelerate,
                stop=args.rl_stop, stop_sigma=args.noise_sigma,
                stop_tau=args.tau, return_iterations=True)
            return x, iters, 0.0
        res = deconvolve_depthvar(d, psfs, anchors, weights=wt, config=cfg)
        return res.x, res.iterations, res.f

    if maps:
        if getattr(args, "model", "widefield") != "widefield":
            sys.exit("--depthvar-maps synthesizes through the scalar pupil "
                     "(--model widefield)")
        model = _model(args, data.shape)
        phis, rhos, defoc = _load_pupil_maps(args, model, maps)
        order = np.argsort(anchors, kind="stable")
        anchors = anchors[order]
        phis, defoc = phis[order], defoc[order]
        rhos = None if rhos is None else rhos[order]
        label = f"depthvar maps K={k}"
        with torch.no_grad():
            psfs = depth_anchor_psfs_from_maps(
                model, _tensor(args, phis, model.dtype),
                None if rhos is None else _tensor(args, rhos, model.dtype),
                _tensor(args, defoc, model.dtype))
    else:
        if getattr(args, "model", "gl") != "gl":
            sys.exit("--depthvar requires --model gl "
                     "(anchors vary the DEPTH family)")
        model = _model(args, data.shape)
        params = _load_params_json(model, args.params_json) if args.params_json \
            else model.init_params()
        label = f"depthvar K={k}"
        # depth0 = the calibrated depth of plane z=0 (a ladder fit's d0),
        # not the model's nominal --depth.
        with torch.no_grad():
            psfs = depth_anchor_psfs(model, params, anchors, depth0=params.depth[1])
    x, iters, f = solve(data, psfs, w)
    tail = f"{'' if rl else f'cost {float(f):.6g}, '}"
    print(f"deconv[{label}{' rl' if rl else ''}]: {int(iters)} iters, "
          f"{tail}{time.time()-t0:.1f}s")
    _write_out(args, args.out, _np(x), dxy=args.dxy, dz=args.dz)
    print("wrote", args.out)


def _cmd_deconv_plate(args):
    """deconv on a plate input without --well (``deconv_modes.py:115-227``):
    every well/field gets its own solve (one solver closure per distinct
    shape), results re-enter as an output plate."""
    from microtipi_tpu_torch.io.tiffstack import read_stack
    from microtipi_tpu_torch.jobs.deconv import deconvolve
    from microtipi_tpu_torch.utils.arrays import unroll

    if getattr(args, "mesh", None) or getattr(args, "tile", None) \
            or getattr(args, "depthvar_maps", None):
        sys.exit("plate fan-out composes per-image dispatches; "
                 "drop --mesh/--tile/--depthvar-maps (or select one --well)")
    dv = getattr(args, "depthvar", 0)
    if dv:
        # Depth-varying plate fan-out (thick HCS samples): anchors
        # synthesized per well shape from one calibration — the parametric
        # (--params-json) route only.
        if args.model != "gl":
            sys.exit("plate --depthvar requires --model gl")
        if getattr(args, "auto_mu", False):
            sys.exit("--auto-mu does not compose with --depthvar yet")
        if args.method == "rl" and (args.gain > 0
                                    or getattr(args, "auto_gain", False)):
            sys.exit("--method rl is Poisson-MLE; it does not take weights "
                     "(drop --gain/--auto-gain or use the VMLMB path)")
        psf = None
    elif not args.psf:
        sys.exit("--psf is required for plate deconv")
    if getattr(args, "auto_mu", False) and args.method == "rl":
        sys.exit("--auto-mu does not apply to --method rl (use --rl-stop)")
    _resolve_geometry(args, args.data, log=lambda *a: None)
    if not dv:
        psf = _tensor(args, read_stack(args.psf))
        if args.psf_centered:
            psf = unroll(psf)
    runs = {}

    def solve_one(vol):
        if dv:
            return _solve_one_depthvar(vol)
        return _solve_one_fixed(vol)

    def _solve_one_depthvar(vol):
        from microtipi_tpu_torch.jobs.depthvar import (
            deconvolve_depthvar, depth_anchor_psfs, richardson_lucy_depthvar)

        vol = _tensor(args, vol)
        shape = tuple(vol.shape)
        if shape not in runs:
            model = _model(args, shape)
            params = (_load_params_json(model, args.params_json)
                      if args.params_json else model.init_params())
            anchors = _depthvar_anchor_array(args, dv, shape[0])
            with torch.no_grad():
                psfs = depth_anchor_psfs(model, params, anchors, depth0=params.depth[1])
            if args.method == "rl":
                runs[shape] = lambda d, w, p=psfs, a=anchors: richardson_lucy_depthvar(
                    d, p, a, iterations=args.iters, mu=args.mu,
                    epsilon=args.epsilon, accelerate=args.rl_accelerate,
                    stop=args.rl_stop, stop_sigma=args.noise_sigma,
                    stop_tau=args.tau)
            else:
                cfg = _deconv_config(args, shape)
                runs[shape] = lambda d, w, p=psfs, a=anchors, cfg=cfg: deconvolve_depthvar(
                    d, p, a, weights=w, config=cfg).x
        if args.method == "rl":
            return runs[shape](vol, None)
        return runs[shape](vol, _weights(args, vol))

    def _solve_one_fixed(vol):
        vol = _tensor(args, vol)
        shape = tuple(vol.shape)
        if getattr(args, "auto_mu", False) and args.method != "rl":
            # Calibrate-once across the plate (the serving watch semantics):
            # the first well's discrepancy bisection sets mu, later wells
            # reuse it on the cheap fixed-mu solver.
            from microtipi_tpu_torch.jobs.autotune import deconvolve_auto_mu

            auto = deconvolve_auto_mu(vol, psf, weights=_weights(args, vol),
                                      config=_deconv_config(args, shape),
                                      sigma=args.noise_sigma, tau=args.tau)
            args.mu = float(auto.mu)
            args.auto_mu = False
            print(f"auto-mu (first plate image): mu={args.mu:.4g}")
            return auto.result.x
        if shape not in runs:
            if args.method == "rl":
                from microtipi_tpu_torch.jobs.richardson_lucy import richardson_lucy

                runs[shape] = lambda d, w: richardson_lucy(
                    d, psf, iterations=args.iters, mu=args.mu,
                    epsilon=args.epsilon, accelerate=args.rl_accelerate,
                    stop=args.rl_stop, stop_sigma=args.noise_sigma,
                    stop_tau=args.tau)
            else:
                cfg = _deconv_config(args, shape)
                runs[shape] = lambda d, w, cfg=cfg: deconvolve(d, psf, weights=w, config=cfg).x
        if args.method == "rl":
            return runs[shape](vol, None)
        return runs[shape](vol, _weights(args, vol))

    _plate_fan_out(args, solve_one, "deconv")


def _cmd_deconv_timeseries(args):
    """deconv --mu-t (``deconv_modes.py:230-304``): joint 4D solve over all
    timepoints of a hyperstack with the temporal TV prior
    (jobs/timeseries.py)."""
    from microtipi_tpu_torch.io.tiffstack import read_stack
    from microtipi_tpu_torch.jobs.timeseries import deconvolve_timeseries
    from microtipi_tpu_torch.utils.arrays import unroll

    if getattr(args, "mesh", None) or getattr(args, "tile", None) \
            or getattr(args, "depthvar", 0) or getattr(args, "depthvar_maps", None) \
            or getattr(args, "auto_mu", False):
        sys.exit("--mu-t is the joint 4D time-series solve; drop "
                 "--mesh/--tile/--depthvar/--auto-mu")
    if not args.psf:
        sys.exit("--psf is required for --mu-t")
    arr, _meta = _read_hyperstack(args, "--mu-t")
    nt, nc = arr.shape[:2]
    if nt < 2:
        sys.exit(f"--mu-t couples timepoints; input has SizeT={nt}")
    c = min(args.channel, nc - 1)
    series = _tensor(args, _prep_hyperstack(args, arr[:, c][:, None])[:, 0])
    _resolve_geometry(args, args.data, log=lambda *a: None)
    psf = _tensor(args, read_stack(args.psf))
    if args.psf_centered:
        psf = unroll(psf)
    if getattr(args, "register_t", False):
        from microtipi_tpu_torch.ops.register import register_timeseries

        series, shifts = register_timeseries(series)
        print("drift correction (voxels, cumulative):",
              np.round(_np(shifts), 2).tolist())
    bleach = None
    if getattr(args, "bleach_correct", False):
        from microtipi_tpu_torch.ops.preprocess import estimate_bleach

        bleach = estimate_bleach(series)
        print("bleach gains (relative to frame 0):",
              np.round(_np(bleach), 3).tolist())
    cfg = _deconv_config(args, series.shape[1:])
    w = None
    if getattr(args, "auto_gain", False) or args.gain > 0:
        from microtipi_tpu_torch.weights.updaters import InverseVarianceWeights
        gain, rv = args.gain, args.readout
        if getattr(args, "auto_gain", False):
            from microtipi_tpu_torch.weights.updaters import estimate_gain_readout
            g_est, rv_est = estimate_gain_readout(series[0])
            gain, rv = float(g_est), float(rv_est)
            print(f"auto-gain (frame 0): gain={gain:.4g}, readout var={rv:.4g}")
        w = InverseVarianceWeights(gain=gain, readout_variance=rv).from_data(series)
    if args.method == "admm":
        # The ADMM engine on the joint 4D objective (fixed --iters).
        from microtipi_tpu_torch.jobs.admm import admm_deconvolve_timeseries

        def solver(d, p, w, g):
            return admm_deconvolve_timeseries(d, p, weights=w, config=cfg, mu_t=args.mu_t,
                                              epsilon_t=args.epsilon_t, bleach=g, track_objective=False)
    elif args.method != "vmlmb":
        sys.exit(f"--mu-t takes --method vmlmb or admm, not {args.method} "
                 "(rl has no coupled temporal form)")
    else:
        def solver(d, p, w, g):
            return deconvolve_timeseries(d, p, weights=w, config=cfg, mu_t=args.mu_t,
                                         epsilon_t=args.epsilon_t, bleach=g)
    t0 = time.time()
    res = solver(series, psf, w, bleach)
    f = float(res.f)
    print(f"deconv[timeseries T={nt} {args.method}]: {int(res.iterations)} "
          f"iters, cost {f:.6g}, {time.time()-t0:.1f}s")
    _write_hyperstack(args, _np(res.x)[:, None])  # (T, 1, Z, Y, X)


_MC_EXCLUSIVE_FLAGS = (
    ("mesh", "--mesh"), ("tile", "--tile"), ("depthvar", "--depthvar"),
    ("depthvar_maps", "--depthvar-maps"), ("superres", "--superres"),
    ("auto_mu", "--auto-mu"),
)


def _parse_mixing(spec, nc):
    """--mixing SPEC -> (nc, K) NumPy bleed-through matrix
    (``deconv_modes.py:314-339``). SPEC is a JSON file (list of rows), a CSV
    file, or inline rows 'a,b;c,d'."""
    import json
    import os

    try:
        if os.path.exists(spec):
            if spec.lower().endswith(".json"):
                with open(spec) as fh:
                    m = np.asarray(json.load(fh), np.float64)
            else:
                m = np.loadtxt(spec, delimiter=",", ndmin=2)
        else:
            m = np.asarray([[float(v) for v in row.split(",")]
                            for row in spec.split(";")], np.float64)
    except SystemExit:
        raise
    except Exception as e:
        sys.exit(f"--mixing: could not parse {spec!r}: {e}")
    if m.ndim != 2 or m.shape[0] != nc:
        sys.exit(f"--mixing must be a ({nc}, K) matrix (one row per detected "
                 f"channel of the input); got shape {getattr(m, 'shape', None)}")
    return m


def _resolve_channel_psfs(args, meta, nc, vol, explicit_wl=None):
    """One PSF per channel (or per dye, with --mixing) for the joint
    multi-channel solves (``deconv_modes.py:342-399``): from ``--psf`` (a
    C-channel hyperstack, or one volume broadcast) or synthesized from the
    model flags at each OME channel's EmissionWavelength (chromatic optics,
    ``WideFieldModel.java:165-166``). Returns (C,) + vol or one volume.
    ``explicit_wl`` is --wavelength captured before ``_resolve_geometry``
    defaults it."""
    from microtipi_tpu_torch.io.tiffstack import read_stack
    from microtipi_tpu_torch.utils.arrays import unroll

    if args.psf:
        try:
            from microtipi_tpu_torch.io.ome import read_ome_hyperstack
            parr, _pm = read_ome_hyperstack(args.psf)
            psfs = np.ascontiguousarray(parr[0])  # (Cp, Z, Y, X)
            if psfs.shape[0] == 1:
                psfs = psfs[0]
            elif psfs.shape[0] != nc:
                sys.exit(f"--psf has {psfs.shape[0]} channels, expected {nc} "
                         "(the data's channels, or K dyes with --mixing)")
        except SystemExit:
            raise
        except Exception:
            psfs = read_stack(args.psf)  # one volume, broadcast
        psfs = _tensor(args, psfs)
        if args.psf_centered:
            psfs = unroll(psfs, axes=(-3, -2, -1))
        return psfs
    # Synthesize one PSF per channel at its emission wavelength.
    channels = meta.get("channels") or []
    lams = []
    for c in range(nc):
        em = channels[c].get("emission_wavelength") if c < len(channels) else None
        em = em or explicit_wl
        if not em:
            sys.exit(f"channel {c} has no OME EmissionWavelength and no "
                     "--wavelength was given; pass --psf or --wavelength")
        lams.append(float(em))
    print("per-channel emission wavelengths [nm]:",
          [round(l * 1e9, 1) for l in lams])
    if args.wavelength is None:
        args.wavelength = lams[0]  # _build_model requires a value
    psf_list = []
    for lam in lams:
        saved = args.wavelength
        args.wavelength = lam
        model = _model(args, vol)
        args.wavelength = saved
        psf_list.append(_psf_of(model, model.init_params()))
    return torch.stack(psf_list)


def _channel_weights(nc, frames, first, tag=""):
    """Per-channel --auto-gain weights of the joint solves
    (``deconv_modes.py:443-454``, ``:557-568``): channel c's camera constants
    are estimated on ``first(c)`` and weigh ``frames(c)``; one weight tensor
    a channel."""
    from microtipi_tpu_torch.weights.updaters import InverseVarianceWeights, estimate_gain_readout

    ws = []
    for c in range(nc):  # camera constants are per channel/camera
        g_est, rv_est = estimate_gain_readout(first(c))
        print(f"auto-gain (channel {c}{tag}): gain={float(g_est):.4g}, "
              f"readout var={float(rv_est):.4g}")
        iv = InverseVarianceWeights(gain=float(g_est), readout_variance=float(rv_est))
        ws.append(iv.from_data(frames(c)))
    return ws


def _cmd_deconv_multichannel(args):
    """deconv --all-channels (``deconv_modes.py:402-480``): joint solve over
    every channel of a hyperstack at --timepoint, each channel with its own
    PSF (jobs/multichannel.py), from --psf or synthesized from the model
    flags at each OME channel's emission wavelength."""
    from microtipi_tpu_torch.jobs.multichannel import deconvolve_multichannel

    for flag, name in _MC_EXCLUSIVE_FLAGS:
        if getattr(args, flag, None):
            sys.exit(f"--all-channels does not compose with {name}; run "
                     "per-channel solves instead")
    if args.method not in ("vmlmb", "admm"):
        sys.exit("--all-channels takes --method vmlmb or admm "
                 "(rl has no coupled form; run rl per channel)")
    arr, meta = _read_hyperstack(args, "--all-channels")
    nt, nc = arr.shape[:2]
    if nc < 2:
        sys.exit(f"--all-channels couples channels; input has SizeC={nc}")
    t = int(getattr(args, "timepoint", 0) or 0)
    if not (0 <= t < nt):
        sys.exit(f"--timepoint {t} out of range (T={nt})")
    stack = _tensor(args, _prep_hyperstack(args, arr[t][None])[0])  # (C, Z, Y, X)
    vol = tuple(stack.shape[1:])
    explicit_wl = args.wavelength  # capture before _resolve_geometry defaults it
    _resolve_geometry(args, args.data, log=lambda *a: None)

    mix = _parse_mixing(args.mixing, nc) if getattr(args, "mixing", None) else None
    nk = mix.shape[1] if mix is not None else nc
    psfs = _resolve_channel_psfs(args, meta, nk, vol, explicit_wl)
    cfg = _deconv_config(args, vol)
    w = None
    if getattr(args, "auto_gain", False) or args.gain > 0:
        from microtipi_tpu_torch.weights.updaters import InverseVarianceWeights
        if getattr(args, "auto_gain", False):
            w = torch.stack(_channel_weights(nc, lambda c: stack[c], lambda c: stack[c]))
        else:
            iv = InverseVarianceWeights(gain=args.gain, readout_variance=args.readout)
            w = iv.from_data(stack)

    coupling = getattr(args, "coupling", "joint")
    mixing = None if mix is None else torch.as_tensor(mix, dtype=stack.dtype, device=stack.device)
    t0 = time.time()
    if args.method == "admm":
        # The ADMM engine on the same coupled objective (jobs/admm.py:
        # mixing = constant KxK data prox; weighted/poisson unmixing stays
        # on vmlmb and the engine says so itself).
        from microtipi_tpu_torch.jobs.admm import admm_deconvolve_multichannel

        res = admm_deconvolve_multichannel(stack, psfs, weights=w, config=cfg, coupling=coupling,
                                           mixing=mixing, track_objective=False)
    else:
        res = deconvolve_multichannel(stack, psfs, weights=w, config=cfg, coupling=coupling, mixing=mixing)
    unmix_tag = f" -> K={nk} dyes" if mix is not None else ""
    print(f"deconv[channels C={nc}{unmix_tag}, {coupling} {args.method}]: "
          f"{int(res.iterations)} iters, "
          f"cost {float(res.f):.6g}, {time.time()-t0:.1f}s")
    _write_hyperstack(args, _np(res.x)[None])  # (1, C or K, Z, Y, X)


def _cmd_deconv_timeseries_multichannel(args):
    """deconv --mu-t --all-channels (``deconv_modes.py:483-595``): the full
    (T, C) acquisition in one solve
    (jobs/multichannel.deconvolve_timeseries_multichannel). --register-t
    estimates drift on the brightest channel and applies it to all (channels
    share the stage); --bleach-correct estimates per-channel fading."""
    from microtipi_tpu_torch.jobs.multichannel import deconvolve_timeseries_multichannel

    for flag, name in _MC_EXCLUSIVE_FLAGS:
        if getattr(args, flag, None):
            sys.exit(f"--mu-t --all-channels does not compose with {name}")
    if args.method not in ("vmlmb", "admm"):
        sys.exit("--mu-t --all-channels takes --method vmlmb or admm "
                 "(rl has no coupled form)")
    arr, meta = _read_hyperstack(args, "--mu-t --all-channels")
    nt, nc = arr.shape[:2]
    if nt < 2:
        sys.exit(f"--mu-t couples timepoints; input has SizeT={nt}")
    if nc < 2:
        sys.exit(f"--all-channels couples channels; input has SizeC={nc}")
    mix = _parse_mixing(args.mixing, nc) if getattr(args, "mixing", None) else None
    nk = mix.shape[1] if mix is not None else nc
    if mix is not None and getattr(args, "bleach_correct", False):
        sys.exit("--bleach-correct does not compose with --mixing: the CLI "
                 "estimator reads per-DETECTED-channel flux, but gains under "
                 "unmixing are per DYE — estimate them on unmixed/control "
                 "data and pass bleach= via the API")
    block = _tensor(args, _prep_hyperstack(args, arr))  # (T, C, Z, Y, X)
    vol = tuple(block.shape[2:])
    explicit_wl = args.wavelength  # capture before _resolve_geometry defaults it
    _resolve_geometry(args, args.data, log=lambda *a: None)
    psfs = _resolve_channel_psfs(args, meta, nk, vol, explicit_wl)

    if getattr(args, "register_t", False):
        from microtipi_tpu_torch.ops.register import fourier_shift, register_timeseries

        # Drift is the stage's, shared by every channel: estimate on the
        # brightest channel (best SNR for the matched filter), apply the
        # same per-timepoint shift to all channels.
        ref_c = int(np.argmax([float(np.sum(arr[:, c], dtype=np.float64))
                               for c in range(nc)]))
        _, shifts = register_timeseries(block[:, ref_c])
        block = torch.stack([torch.stack([fourier_shift(block[t, c], shifts[t]) for c in range(nc)])
                             for t in range(nt)])
        print(f"drift correction (voxels, cumulative; estimated on channel "
              f"{ref_c}):", np.round(_np(shifts), 2).tolist())

    bleach = None
    if getattr(args, "bleach_correct", False):
        from microtipi_tpu_torch.ops.preprocess import estimate_bleach

        # (T, C): each fluorophore fades at its own rate.
        bleach = torch.stack([estimate_bleach(block[:, c]) for c in range(nc)], dim=1)
        print("bleach gains (relative to frame 0, per channel):",
              np.round(_np(bleach), 3).tolist())

    cfg = _deconv_config(args, vol)
    w = None
    if getattr(args, "auto_gain", False) or args.gain > 0:
        from microtipi_tpu_torch.weights.updaters import InverseVarianceWeights
        if getattr(args, "auto_gain", False):
            w = torch.stack(_channel_weights(nc, lambda c: block[:, c], lambda c: block[0, c], ", frame 0"),
                            dim=1)  # (T, C) + vol
        else:
            iv = InverseVarianceWeights(gain=args.gain, readout_variance=args.readout)
            w = iv.from_data(block)
    coupling = getattr(args, "coupling", "joint")
    mixing = None if mix is None else torch.as_tensor(mix, dtype=block.dtype, device=block.device)
    t0 = time.time()
    if args.method == "admm":
        # The ADMM engine on the full 5D objective; its unsupported
        # combinations (weighted/poisson unmixing, poisson+bleach) raise
        # with actionable messages (jobs/admm.py).
        from microtipi_tpu_torch.jobs.admm import admm_deconvolve_timeseries_multichannel

        res = admm_deconvolve_timeseries_multichannel(
            block, psfs, weights=w, config=cfg, mu_t=args.mu_t,
            epsilon_t=args.epsilon_t, bleach=bleach, coupling=coupling,
            mixing=mixing, track_objective=False)
    else:
        res = deconvolve_timeseries_multichannel(
            block, psfs, weights=w, config=cfg, mu_t=args.mu_t,
            epsilon_t=args.epsilon_t, bleach=bleach, coupling=coupling, mixing=mixing)
    unmix_tag = f" -> K={nk} dyes" if mix is not None else ""
    print(f"deconv[timeseries T={nt} x channels C={nc}{unmix_tag}, "
          f"{coupling} {args.method}]: {int(res.iterations)} iters, "
          f"cost {float(res.f):.6g}, {time.time()-t0:.1f}s")
    _write_hyperstack(args, _np(res.x))  # (T, C or K, Z, Y, X)


def _cmd_deconv_superres(args, data):
    """deconv --superres FZ FY FX (``deconv_modes.py:598-692``): solve on a
    finer object grid (jobs/superres.py). The fine PSF comes from --psf
    (already at the fine pitch/shape, or a coarse PSF upsampled) or is
    synthesized from the model flags at dxy/f, dz/f."""
    import argparse

    from microtipi_tpu_torch.io.tiffstack import read_stack
    from microtipi_tpu_torch.jobs.superres import deconvolve_superres
    from microtipi_tpu_torch.utils.arrays import unroll

    if getattr(args, "mesh", None) or getattr(args, "tile", None) \
            or getattr(args, "depthvar", 0) or getattr(args, "depthvar_maps", None) \
            or getattr(args, "auto_mu", False) \
            or args.method not in ("vmlmb", "admm") or getattr(args, "pad", 0):
        sys.exit("--superres is a single-chip fine-grid solve (vmlmb/admm); "
                 "drop --mesh/--tile/--depthvar/--auto-mu/--method rl|fista/"
                 "--pad")
    f = tuple(int(v) for v in args.superres)
    fine_shape = tuple(fi * s for fi, s in zip(f, data.shape))
    needs_upsample = False
    if args.psf:
        psf_fine = _tensor(args, read_stack(args.psf))
        if args.psf_centered:
            psf_fine = unroll(psf_fine)
        needs_upsample = tuple(psf_fine.shape) == tuple(data.shape)
        if needs_upsample:
            # Measured coarse-grid PSF (e.g. fitpsf --empirical-out):
            # band-limited Fourier upsampling — exact when the PSF
            # measurement itself was adequately sampled (see
            # jobs.superres.upsample_psf for the aliasing caveat).
            print(f"upsampling the coarse --psf to the fine grid {fine_shape} "
                  "(band-limited; only valid if the PSF measurement was "
                  "adequately sampled)")
        if not needs_upsample and tuple(psf_fine.shape) != fine_shape:
            sys.exit(f"--superres {f}: --psf must be sampled at the FINE "
                     f"grid {fine_shape} or the data grid {tuple(data.shape)} "
                     f"(got {tuple(psf_fine.shape)}); or drop --psf to synthesize "
                     "from the model flags)")
    else:
        sub = argparse.Namespace(**vars(args))
        sub.dxy = args.dxy / f[2]
        sub.dz = args.dz / f[0]
        if f[1] != f[2]:
            sys.exit("--superres needs equal y/x factors (square pixels)")
        model = _model(sub, fine_shape)
        params = (_load_params_json(model, args.params_json)
                  if args.params_json else model.init_params())
        psf_fine = _psf_of(model, params)
    cfg = _deconv_config(args, data.shape)
    w = _weights(args, data)
    if args.psf and needs_upsample:
        from microtipi_tpu_torch.jobs.superres import upsample_psf

        psf_fine = upsample_psf(psf_fine, f)
    t0 = time.time()
    if args.method == "admm":
        from microtipi_tpu_torch.jobs.superres import admm_deconvolve_superres

        res = admm_deconvolve_superres(data, psf_fine, factor=f, weights=w, config=cfg, track_objective=False)
    else:
        res = deconvolve_superres(data, psf_fine, factor=f, weights=w, config=cfg)
    fval = float(res.f)
    wall = time.time() - t0
    print(f"deconv[superres x{f} {args.method}]: {int(res.iterations)} iters, cost "
          f"{fval:.6g}, {wall:.1f}s; fine grid "
          f"{fine_shape}")
    _write_out(args, args.out, _np(res.x),
               dxy=(args.dxy / f[2] if args.dxy else None),
               dz=(args.dz / f[0] if args.dz else None))
    print("wrote", args.out)
    if args.report:
        import json

        it = int(res.iterations)
        with open(args.report, "w") as fh:
            json.dump({
                "cost": fval, "iterations": it,
                "evaluations": int(res.evaluations), "status": int(res.status),
                "wall_seconds": round(wall, 3), "superres_factor": list(f),
                "f_history": _np(res.f_history)[:it + 1].tolist(),
                "pg_history": _np(res.pg_history)[:it + 1].tolist(),
            }, fh, indent=1)
        print("wrote", args.report)
