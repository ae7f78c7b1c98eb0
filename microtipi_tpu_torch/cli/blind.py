"""The ``blind`` subcommand: alternating object/PSF estimation
(``BlindDeconvJob.java:97-138`` loop semantics) with its all-channels,
plate, depth-varying and tiled variants.

Port of ``microtipi_tpu/cli/blind.py`` on the ported loops
(``jobs/blind``, ``jobs/depthvar``, ``jobs/tiled_blind``) run on
``args.device``. ``--checkpoint`` runs host-driven one-round dispatches with
the loop's ``skip_last_fit`` and ``phase_anchor`` and the port's
``utils.checkpoint``; ``--deconv-engine admm`` reaches the ADMM kernels.
``--mesh`` runs ``parallel.blind.sharded_blind_deconvolve`` and, with
``--depthvar``, ``parallel.depthvar.sharded_blind_deconvolve_depthvar``
(``shared._make_mesh``).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from microtipi_tpu_torch.cli.deconv import _emit_object_uncertainty
from microtipi_tpu_torch.cli.shared import (
    _deconv_config,
    _depthvar_anchor_array,
    _family_map,
    _is_plate,
    _load_params_json,
    _make_mesh,
    _model,
    _np,
    _plate_fan_out,
    _psf_of,
    _read_input_volume,
    _resolve_geometry,
    _tensor,
    _weights,
    _write_out,
)


def _blind_config(args, data_shape):
    """The loop's config from the flags (``blind.py:27-66``)."""
    from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig
    from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig
    fam_map = _family_map()
    if "depth" in args.families and args.model != "gl":
        sys.exit("--families depth requires --model gl (the DEPTH family lives on the Gibson-Lanni model)")
    if "sheet" in args.families and args.model != "lightsheet":
        sys.exit("--families sheet requires --model lightsheet (the SHEET family is the excitation-sheet geometry)")
    if "sted" in args.families and args.model != "sted":
        sys.exit("--families sted requires --model sted (the STED family is the depletion saturation factor)")
    if "cavity" in args.families and args.model != "4pi":
        sys.exit("--families cavity requires --model 4pi (the CAVITY family is the interferometric arm phase)")
    families = tuple(fam_map[f] for f in args.families)
    kw = dict(
        loops=args.loops,
        families=families,
        psf_max_iter=tuple(args.psf_iters for _ in families),
        deconv=_deconv_config(args, data_shape),
        fit=PsfFitConfig(),
        phase_schedule=tuple(args.phase_schedule) if args.phase_schedule else None,
        mu_schedule=tuple(args.mu_schedule) if args.mu_schedule else None,
        joint_fit=args.joint_fit,
        phase_freeze_head=1 if args.pin_z4 else 0,
        init="wiener" if args.wiener_init else "data",
        phase_prior_weight=args.phase_prior,
        bead_weight=getattr(args, "bead_weight", 1.0),
        deconv_engine=getattr(args, "deconv_engine", "vmlmb"),
    )
    if args.recipe == "quality":
        # One flag for the measured-best recipe (BlindDeconvConfig.recommended):
        # joint fit + wiener warm start + TV annealing; pin-Z4 stays the
        # user's explicit --pin-z4 call (it assumes the true Z4 is ~0).
        kw["joint_fit"] = True
        kw["init"] = "wiener"
        kw["phase_schedule"] = None  # joint_fit excludes it
        if kw["mu_schedule"] is None and args.mu > 0:
            kw["mu_schedule"] = tuple(
                args.mu * max(1.0, 64.0 / 4.0**i) for i in range(args.loops)
            )
    return BlindDeconvConfig(**kw)


def _bead(args):
    """The --bead stack as a tensor on the device (averaged over --bead-n
    detected beads first), or None."""
    if not args.bead:
        return None
    bead = _tensor(args, _read_input_volume(args, args.bead))
    if getattr(args, "bead_n", 1) > 1:
        from microtipi_tpu_torch.jobs.psf_fit import average_beads

        bead, used = average_beads(bead, n_beads=args.bead_n)
        print(f"averaged {used} beads for the anchor -> patch {tuple(bead.shape)}")
    return bead


def _params_doc(args, params) -> dict:
    """The --params-out JSON of fitted parameters (``blind.py:487-494``)."""
    doc = {"model": args.model, "dxy": args.dxy, "dz": args.dz}
    for name in params._fields:
        doc[name] = _np(getattr(params, name)).tolist()
    return doc


def _cmd_blind_all_channels(args):
    """blind --all-channels (``blind.py:69-114``): every channel of an OME
    hyperstack gets its own blind solve with its own model wavelength;
    results re-enter as one multi-channel OME-TIFF."""
    from microtipi_tpu_torch.io.ome import read_ome_hyperstack, write_ome_hyperstack
    from microtipi_tpu_torch.jobs.blind import blind_deconvolve

    if getattr(args, "mesh", None) or args.checkpoint:
        sys.exit("--all-channels composes per-channel dispatches; drop --mesh/--checkpoint")
    arr, meta = read_ome_hyperstack(args.data)
    nt, nc = arr.shape[:2]
    t = int(args.timepoint or 0)
    if not 0 <= t < nt:
        sys.exit(f"--timepoint {t} out of range (T={nt})")
    explicit_wl = args.wavelength  # capture before _resolve_geometry defaults it
    _resolve_geometry(args, args.data, log=lambda *a: None)
    channels = meta.get("channels") or []
    objs, wls = [], []
    for c in range(nc):
        wl = explicit_wl
        if wl is None:
            em = channels[c].get("emission_wavelength") if c < len(channels) else None
            wl = em or 561e-9
        args.wavelength = wl
        model = _model(args, arr.shape[2:])
        cfg = _blind_config(args, arr.shape[2:])
        p0 = _load_params_json(model, args.params_json) if args.params_json else None
        t0 = time.time()
        res = blind_deconvolve(_tensor(args, arr[t, c]), model, params0=p0, config=cfg)
        df = np.asarray(res.deconv_f)
        print(f"channel {c}: wavelength {wl*1e9:.4g} nm, {args.loops} rounds in "
              f"{time.time()-t0:.1f}s, object cost {df[0]:.6g} -> {df[-1]:.6g}")
        objs.append(_np(res.obj))
        wls.append(wl)
    args.wavelength = explicit_wl
    write_ome_hyperstack(
        args.out, np.stack(objs)[None], dxy=args.dxy, dz=args.dz,
        channel_names=[ch.get("name") for ch in channels[:nc]] if channels else None,
        emission_wavelengths=wls,
    )
    print("wrote", args.out, f"({nc}-channel OME hyperstack)")


def _cmd_blind_plate(args):
    """blind on a plate input without --well (``blind.py:117-157``): every
    well/field gets its own blind solve (shared optics: one model/config per
    shape, a --bead anchor applies to all wells); results re-enter as an
    output plate."""
    from microtipi_tpu_torch.jobs.blind import blind_deconvolve

    if getattr(args, "mesh", None) or args.checkpoint:
        sys.exit("plate fan-out composes per-image dispatches; drop "
                 "--mesh/--checkpoint (or select one --well)")
    _resolve_geometry(args, args.data, log=lambda *a: None)
    bead = _bead(args)
    runs = {}

    def solve_one(vol):
        vol = _tensor(args, vol)
        shape = tuple(vol.shape)
        if shape not in runs:
            model = _model(args, shape)
            cfg = _blind_config(args, shape)
            p0 = (_load_params_json(model, args.params_json)
                  if args.params_json else None)
            runs[shape] = lambda d, w, b, model=model, cfg=cfg, p0=p0: blind_deconvolve(
                d, model, params0=p0, weights=w, config=cfg, bead_data=b)
        res = runs[shape](vol, _weights(args, vol), bead)
        df = np.asarray(res.deconv_f)
        print(f"  object cost {df[0]:.6g} -> {df[-1]:.6g}")
        return res.obj

    _plate_fan_out(args, solve_one, "blind")


def _cmd_blind_depthvar(args):
    """blind --depthvar K (``blind.py:160-262``): the blind alternation with
    the shift-invariant forward model replaced by the depth-varying anchor
    blend end to end (jobs/depthvar.blind_deconvolve_depthvar). The PSF
    written by --psf-out is the (K, Nz, Ny, Nx) anchor stack, one file per
    anchor."""
    from microtipi_tpu_torch.jobs.depthvar import blind_deconvolve_depthvar

    if args.model != "gl":
        sys.exit("blind --depthvar requires --model gl (the anchor stack "
                 "varies the DEPTH family; calibrate ns with "
                 "fitpsf --depth-ladder or fit it with --families ... depth)")
    if args.checkpoint or getattr(args, "all_channels", False) \
            or getattr(args, "auto_mu", False):
        sys.exit("blind --depthvar runs without checkpoints for now; "
                 "drop --checkpoint/--all-channels/--auto-mu")
    if _is_plate(args.data) and not getattr(args, "well", None):
        sys.exit("blind --depthvar solves one volume; select a plate image "
                 "with --well ROW/COL (per-well depth-varying blind fan-out "
                 "is not wired; deconv PLATE --depthvar fans out non-blind)")
    data = _tensor(args, _read_input_volume(args, args.data))
    _resolve_geometry(args, args.data)
    model = _model(args, data.shape)
    params0 = _load_params_json(model, args.params_json) if args.params_json else None
    w = _weights(args, data)
    cfg = _blind_config(args, data.shape)
    anchors = _depthvar_anchor_array(args, args.depthvar, data.shape[0])
    bead = _bead(args)
    t0 = time.time()
    mesh = _make_mesh(args)
    if mesh is not None:
        from microtipi_tpu_torch.parallel.deconv import crop_trailing
        from microtipi_tpu_torch.parallel.depthvar import sharded_blind_deconvolve_depthvar
        from microtipi_tpu_torch.parallel.mesh import gather

        res = sharded_blind_deconvolve_depthvar(data, model, mesh, anchors, params0=params0, weights=w, config=cfg,
                                                bead_data=bead)
        # mesh-odd shapes auto-pad
        res = res._replace(obj=crop_trailing(gather(res.obj, data.device), tuple(data.shape)))
    else:
        res = blind_deconvolve_depthvar(data, model, anchors, params0=params0, weights=w, config=cfg,
                                        bead_data=bead)
    df = np.asarray(res.deconv_f)
    wall = time.time() - t0
    tag = f" mesh {tuple(args.mesh)}" if mesh is not None else ""
    print(f"blind[depthvar K={args.depthvar}{tag}]: {args.loops} rounds in "
          f"{wall:.1f}s; object cost {df[0]:.6g} -> {df[-1]:.6g}")
    print("defocus:", _np(res.params.defocus))
    if model.config.n_phase:
        print("phase:", np.round(_np(res.params.phase), 4))
    ns = float(res.params.depth[0]) * args.wavelength
    print(f"depth family: ns={ns:.4f}, z0 offset={float(res.params.depth[1]):.4g} m"
          + ("" if "depth" in args.families else " (held at the start values)"))
    _write_out(args, args.out, _np(res.obj), dxy=args.dxy, dz=args.dz)
    print("wrote", args.out)
    if args.psf_out:
        import os

        root, ext = os.path.splitext(args.psf_out)
        for i in range(res.psf.shape[0]):
            path = f"{root}_a{i}{ext}"
            _write_out(args, path, _np(res.psf[i]), dxy=args.dxy, dz=args.dz)
            print("wrote", path)
    if args.params_out:
        import json

        with open(args.params_out, "w") as fh:
            json.dump(_params_doc(args, res.params), fh, indent=1)
        print("wrote", args.params_out)
    if args.report:
        import json

        with open(args.report, "w") as fh:
            json.dump({
                "rounds": args.loops, "wall_seconds": round(wall, 3),
                "anchors": np.asarray(anchors).tolist(),
                "deconv_f": np.asarray(res.deconv_f).tolist(),
                "fit_f": np.asarray(res.fit_f).tolist(),
                "deconv_iters": np.asarray(res.deconv_iters).tolist(),
                "defocus": _np(res.params.defocus).tolist(),
                "phase": _np(res.params.phase).tolist(),
                "modulus": _np(res.params.modulus).tolist(),
                "depth": _np(res.params.depth).tolist(),
            }, fh, indent=1)
        print("wrote", args.report)


def _cmd_blind_tiled(args):
    """``blind --tile`` (``blind.py:265-333``): the out-of-core loop
    (jobs/tiled_blind.py)."""
    import json

    for flag, name in (("mesh", "--mesh"), ("checkpoint", "--checkpoint"),
                       ("bead", "--bead"), ("all_channels", "--all-channels"),
                       ("depthvar", "--depthvar"),
                       ("uncertainty", "--uncertainty"),
                       ("auto_mu", "--auto-mu"), ("auto_gain", "--auto-gain")):
        if getattr(args, flag, None):
            sys.exit(f"blind --tile does not compose with {name}")
    if getattr(args, "gain", 0.0):
        sys.exit("blind --tile is uniform-weights only (the streamed fit's "
                 "quadratic reduction needs them); drop --gain")
    from microtipi_tpu_torch.jobs.tiled_blind import blind_deconvolve_tiled

    data = np.asarray(_read_input_volume(args, args.data))
    _resolve_geometry(args, args.data)
    support = getattr(args, "psf_support", None)
    if support is None:
        lat = min(64, data.shape[1] // 2, data.shape[2] // 2)
        lat -= lat % 2
        sz = min(32, data.shape[0] // 2)
        sz = max(sz - sz % 2, 2)
        support = (sz, lat, lat)
    support = tuple(int(s) for s in support)
    if support[1] != support[2]:
        sys.exit("--psf-support lateral dims must be square (SY == SX)")
    model = _model(args, support)
    params0 = (_load_params_json(model, args.params_json)
               if args.params_json else None)
    cfg = _blind_config(args, data.shape)
    overlap = args.overlap
    if isinstance(overlap, list):
        overlap = overlap[0] if len(overlap) == 1 else tuple(overlap)
    t0 = time.time()
    out, params, psf, df, ff = blind_deconvolve_tiled(
        data, model, cfg, params0=params0, tile=tuple(args.tile),
        overlap=overlap, max_batch=args.tile_batch, log=print)
    wall = time.time() - t0
    print(f"blind --tile: {args.loops} rounds over {data.shape} in "
          f"{wall:.1f}s (psf support {support})")
    print("defocus:", _np(params.defocus))
    if model.config.n_phase:
        print("phase:", np.round(_np(params.phase), 4))
    _write_out(args, args.out, out, dxy=args.dxy, dz=args.dz)
    print("wrote", args.out)
    if args.psf_out:
        _write_out(args, args.psf_out, psf, dxy=args.dxy, dz=args.dz)
        print("wrote", args.psf_out)
    if args.params_out:
        with open(args.params_out, "w") as fh:
            json.dump(_params_doc(args, params), fh, indent=1)
        print("wrote", args.params_out)
    if args.report:
        with open(args.report, "w") as fh:
            json.dump({
                "rounds": args.loops, "wall_seconds": round(wall, 3),
                "fit_f": np.asarray(ff).tolist(),
                "psf_support": list(support),
                "phase": _np(params.phase).tolist(),
                "defocus": _np(params.defocus).tolist(),
            }, fh, indent=1)
        print("wrote", args.report)


def run_checkpointed(args, data, model, params0, w, cfg, bead, log=print):
    """Host-driven rounds with atomic ``.npz`` checkpoints
    (``blind.py:417-454``): each round is a one-round ``blind_deconvolve``
    that fits (``skip_last_fit=False``) but the last, its state saved to
    ``args.checkpoint`` after it; with ``args.resume`` a run restarts from
    the checkpoint's round. The calibration prior stays anchored at the
    original calibration (``phase_anchor``) across rounds and resumes.
    Returns the last round's result, or None when the checkpoint is already
    at the final round."""
    import dataclasses
    import os

    from microtipi_tpu_torch.jobs.blind import blind_deconvolve
    from microtipi_tpu_torch.utils.checkpoint import load_state, save_state

    anchor0 = ((params0 if params0 is not None else model.init_params()).phase
               if args.phase_prior > 0 else None)
    x0, start = None, 0
    if args.resume and os.path.exists(args.checkpoint):
        x0, params0, start, _ = load_state(args.checkpoint, device=data.device)
        log(f"resumed {args.checkpoint} at round {start}")
    mid_cfg = dataclasses.replace(cfg, loops=1, skip_last_fit=False)
    last_cfg = dataclasses.replace(cfg, loops=1, skip_last_fit=True)
    res = None
    for i in range(start, args.loops):
        c = last_cfg if i == args.loops - 1 else mid_cfg
        res = blind_deconvolve(data, model, params0=params0, x0=x0, weights=w, config=c, bead_data=bead,
                               phase_anchor=anchor0)
        x0, params0 = res.obj, res.params
        save_state(args.checkpoint, res.obj, res.params, i + 1)
        log(f"round {i+1}/{args.loops}: object cost "
            f"{float(res.deconv_f[0]):.6g} (checkpointed)")
    return res


def cmd_blind(args):
    """``blind`` (``blind.py:336-503``)."""
    from microtipi_tpu_torch.jobs.blind import blind_deconvolve

    if getattr(args, "tile", None):
        _cmd_blind_tiled(args)
        return
    if getattr(args, "uncertainty", 0):
        # Single-volume single-device tail only — fail fast, don't ignore.
        for flag, name in (("depthvar", "--depthvar"),
                           ("all_channels", "--all-channels"),
                           ("mesh", "--mesh")):
            if getattr(args, flag, None):
                sys.exit(f"--uncertainty does not compose with {name}; run "
                         "it on the plain single-volume blind solve")
        if _is_plate(args.data) and not getattr(args, "well", None):
            sys.exit("--uncertainty does not compose with the whole-plate "
                     "fan-out; pick one well (--well)")
    if getattr(args, "depthvar", 0):
        _cmd_blind_depthvar(args)
        return
    if getattr(args, "auto_mu", False) and (
            (_is_plate(args.data) and not getattr(args, "well", None))
            or getattr(args, "all_channels", False)):
        sys.exit("blind --auto-mu calibrates one volume; pick a --well / "
                 "single channel (or use deconv --auto-mu per file)")
    if _is_plate(args.data) and not getattr(args, "well", None):
        _cmd_blind_plate(args)
        return
    if getattr(args, "all_channels", False):
        if args.bead:
            sys.exit("--bead is not supported with --all-channels: each "
                     "channel's PSF lives at its own emission wavelength and "
                     "needs its own bead stack")
        _cmd_blind_all_channels(args)
        return
    data = _tensor(args, _read_input_volume(args, args.data))
    _resolve_geometry(args, args.data)
    model = _model(args, data.shape)
    params0 = _load_params_json(model, args.params_json) if args.params_json else None
    w = _weights(args, data)
    if getattr(args, "auto_mu", False):
        # Calibrate the base TV weight by the discrepancy bisection against
        # the nominal (or --params-json) PSF before the loop; the quality
        # recipe's mu_schedule derives from args.mu, so annealing rescales
        # with it. An explicit --mu-schedule stays absolute.
        from microtipi_tpu_torch.jobs.autotune import deconvolve_auto_mu

        nominal = model.init_params() if params0 is None else params0
        auto = deconvolve_auto_mu(data, _psf_of(model, nominal), weights=w,
                                  config=_deconv_config(args, data.shape),
                                  sigma=args.noise_sigma, tau=args.tau)
        args.mu = float(auto.mu)
        print(f"auto-mu (nominal PSF): mu={args.mu:.4g} "
              f"(discrepancy {float(auto.discrepancy):.4g} "
              f"/ target {float(auto.target):.4g})")
    cfg = _blind_config(args, data.shape)
    bead = _bead(args)
    t0 = time.time()
    mesh = _make_mesh(args)
    if mesh is not None:
        if args.checkpoint:
            sys.exit("--checkpoint is not supported together with --mesh yet")
        from microtipi_tpu_torch.parallel.blind import sharded_blind_deconvolve
        from microtipi_tpu_torch.parallel.mesh import gather

        res = sharded_blind_deconvolve(data, model, mesh, params0=params0, weights=w, config=cfg, bead_data=bead)
        res = res._replace(obj=gather(res.obj, data.device))
        df = np.asarray(res.deconv_f)
    elif args.checkpoint:
        res = run_checkpointed(args, data, model, params0, w, cfg, bead)
        if res is None:
            sys.exit("nothing to do: checkpoint is already at the final round")
        df = np.asarray(res.deconv_f)[-1:]
    else:
        res = blind_deconvolve(data, model, params0=params0, weights=w, config=cfg, bead_data=bead)
        df = np.asarray(res.deconv_f)
    wall = time.time() - t0
    print(f"blind: {args.loops} rounds in {wall:.1f}s; "
          f"object cost {df[0]:.6g} -> {df[-1]:.6g}")
    if args.report:
        import json

        with open(args.report, "w") as fh:
            json.dump({
                "rounds": args.loops, "wall_seconds": round(wall, 3),
                "deconv_f": np.asarray(res.deconv_f).tolist(),
                "fit_f": np.asarray(res.fit_f).tolist(),
                "deconv_iters": np.asarray(res.deconv_iters).tolist(),
                "defocus": _np(res.params.defocus).tolist(),
                "phase": _np(res.params.phase).tolist(),
                "modulus": _np(res.params.modulus).tolist(),
            }, fh, indent=1)
        print("wrote", args.report)
    print("defocus:", _np(res.params.defocus))
    if model.config.n_phase:
        print("phase:", np.round(_np(res.params.phase), 4))
    print("modulus:", np.round(_np(res.params.modulus), 4))
    _write_out(args, args.out, _np(res.obj), dxy=args.dxy, dz=args.dz)
    print("wrote", args.out)
    if args.psf_out:
        _write_out(args, args.psf_out, _np(res.psf), dxy=args.dxy, dz=args.dz)
        print("wrote", args.psf_out)
    if args.params_out:
        import json

        with open(args.params_out, "w") as fh:
            json.dump(_params_doc(args, res.params), fh, indent=1)
        print("wrote", args.params_out)
    if getattr(args, "uncertainty", 0):
        # Curvature at the mu the final object round used (mu_schedule
        # annealing decays to the base mu; an explicit schedule may not).
        ucfg = cfg.deconv
        if cfg.mu_schedule:
            import dataclasses

            ucfg = dataclasses.replace(ucfg, mu=float(cfg.mu_schedule[-1]))
        _emit_object_uncertainty(args, data, res.psf, res.obj, w, ucfg)
