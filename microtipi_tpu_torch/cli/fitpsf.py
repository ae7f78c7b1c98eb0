"""The ``fitpsf`` subcommand: PSF-parameter calibration from bead stacks
(``PSF_Estimation.java`` semantics), including the depth-ladder,
phase-diversity, retrieved-map, empirical-PSF and field-anchor workflows.

Port of ``microtipi_tpu/cli/fitpsf.py`` on the ported jobs
(``jobs/psf_fit``, ``depthvar``, ``diversity``, ``phase_retrieval``) run on
``args.device``.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from microtipi_tpu_torch.cli.shared import (
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


def _std_doc(std: dict) -> dict:
    """Error bars as JSON values: lists, and floats for scalars."""
    return {k: (_np(v).tolist() if np.ndim(_np(v)) else float(v)) for k, v in std.items()}


def _cmd_fitpsf_ladder(args, stacks):
    """fitpsf S1..SK --depth-ladder Z1..ZK (``fitpsf.py:19-120``):
    depth-ladder calibration of the Gibson-Lanni DEPTH family
    (jobs/depthvar.calibrate_depth) — beads at K known depths pin the sample
    index ns through the slope of the spherical aberration vs depth."""
    import json

    from microtipi_tpu_torch.jobs.depthvar import calibrate_depth
    from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig
    from microtipi_tpu_torch.utils.arrays import roll

    if args.model != "gl":
        sys.exit("--depth-ladder requires --model gl (it calibrates the "
                 "DEPTH family of the Gibson-Lanni model)")
    for flag in ("empirical_out", "field_out", "retrieve_map"):
        if getattr(args, flag, None):
            sys.exit(f"--depth-ladder does not compose with --{flag.replace('_', '-')}")
    ladder_z = np.asarray(args.depth_ladder, np.float64)
    if len(stacks) != ladder_z.size:
        sys.exit(f"--depth-ladder needs one bead stack per depth: got "
                 f"{len(stacks)} stacks for {ladder_z.size} depths")
    _resolve_geometry(args, stacks[0])
    beads = []
    for path in stacks:
        b = np.asarray(_read_input_volume(args, path))
        if args.n_beads > 1:
            from microtipi_tpu_torch.jobs.psf_fit import average_beads

            patch = tuple(args.bead_patch) if args.bead_patch else None
            b, used = average_beads(_tensor(args, b), n_beads=args.n_beads, patch=patch)
            b = _np(b)
            print(f"{path}: averaged {used} beads -> patch {b.shape}")
        beads.append(b)
    if len({b.shape for b in beads}) != 1:
        sys.exit(f"ladder bead stacks must share one shape, got "
                 f"{[b.shape for b in beads]} (use --n-beads/--bead-patch "
                 f"to crop a common patch)")
    beads = _tensor(args, np.stack(beads))
    model = _model(args, tuple(beads.shape[1:]))
    params0 = _load_params_json(model, args.params_json) if args.params_json else None

    fam_map = _family_map("defocus", "phase", "modulus", "depth")
    fams = list(args.families)
    if any(f not in fam_map for f in fams):
        sys.exit("--depth-ladder fits defocus/phase/modulus/depth families")
    if "depth" not in fams:
        fams.append("depth")
        print("(DEPTH family added to --families: it is what the ladder "
              "calibrates)")
    families = tuple(fam_map[f] for f in fams)

    t0 = time.time()
    fit, zshifts = calibrate_depth(
        model, beads, ladder_z, families=families, params0=params0,
        config=PsfFitConfig(max_iter=args.iters, grtol=0.0),
        phase_freeze_head=1 if args.pin_z4 else 0,
    )
    ns = float(fit.params.depth[0]) * args.wavelength
    print(f"depth ladder ({ladder_z.size} rungs): {int(fit.iterations)} iters, "
          f"cost {float(fit.f):.6g}, {time.time()-t0:.1f}s")
    print(f"ns = {ns:.4f}, z0 depth offset = {float(fit.params.depth[1]):.4g} m")
    print("per-rung axial origins (voxels):",
          np.round(_np(zshifts), 3))
    params = {name: _np(getattr(fit.params, name)).tolist()
              for name in fit.params._fields}
    std = None
    if args.uncertainty:
        from microtipi_tpu_torch.jobs.depthvar import ladder_fit_uncertainty

        unc = ladder_fit_uncertainty(model, fit.params, families, beads, ladder_z, zshifts)
        std = _std_doc(unc.std)
        dns = float(_np(unc.std["depth"])[0]) * args.wavelength
        print(f"ns 1-sigma: +- {dns:.4g} (GN/Laplace at the ladder fit; "
              f"noise sigma {float(unc.sigma):.4g})")
    for name, vals in params.items():
        line = f"{name}: {np.round(np.asarray(vals), 5)}"
        if std is not None and name in std:
            line += f"  +- {np.round(np.asarray(std[name]), 5)}"
        print(line)
    if args.params_out:
        out = {"cost": float(fit.f), "model": args.model,
               "dxy": args.dxy, "dz": args.dz, "ns_fit": ns,
               "ladder_z": ladder_z.tolist(),
               "zshifts": _np(zshifts).tolist(), **params}
        if std is not None:
            out["std"] = std
            out["ns_std"] = float(np.asarray(std["depth"])[0]) * args.wavelength
        with open(args.params_out, "w") as fh:
            json.dump(out, fh, indent=1)
        print("wrote", args.params_out)
    if args.out:
        h = _psf_of(model, fit.params)
        if args.centered:
            h = roll(h)
        _write_out(args, args.out, _np(h), dxy=args.dxy, dz=args.dz)
        print(f"wrote {args.out} (fitted PSF at the calibration origin)")


def _cmd_fitpsf_diversity(args, stacks):
    """fitpsf S1..SD --diversity-dz DZ1..DZD (``fitpsf.py:123-234``):
    phase-diversity calibration from D acquisitions of one unknown extended
    scene at known diversity phases (jobs/diversity.fit_psf_diversity)."""
    import json

    from microtipi_tpu_torch.jobs.diversity import (
        defocus_diversity, diversity_object_estimate, fit_psf_diversity,
        zernike_diversity)
    from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig
    from microtipi_tpu_torch.utils.arrays import roll

    if args.model != "widefield":
        sys.exit("--diversity-* needs the scalar pupil synthesis "
                 "(--model widefield)")
    for flag in ("empirical_out", "field_out", "retrieve_map", "depth_ladder"):
        if getattr(args, flag, None):
            sys.exit(f"--diversity-* does not compose with "
                     f"--{flag.replace('_', '-')}")
    if args.diversity_dz is not None and args.diversity_astig is not None:
        sys.exit("pick one of --diversity-dz / --diversity-astig")
    divs = (args.diversity_dz if args.diversity_dz is not None
            else args.diversity_astig)
    if len(stacks) != len(divs):
        sys.exit(f"--diversity needs one stack per diversity value: got "
                 f"{len(stacks)} stacks for {len(divs)} values")
    if len(stacks) < 2:
        sys.exit("phase diversity needs >= 2 acquisitions (a single image "
                 "is the non-identifiable blind case — BASELINE.md)")
    # read before resolving geometry: _read_input_volume autofills
    # wavelength/dxy/dz from OME metadata only while they are still None
    vols = [np.asarray(_read_input_volume(args, p)) for p in stacks]
    _resolve_geometry(args, stacks[0])
    if len({v.shape for v in vols}) != 1:
        sys.exit(f"diversity stacks must share one shape, got "
                 f"{[v.shape for v in vols]}")
    data = _tensor(args, np.stack(vols))
    model = _model(args, tuple(data.shape[1:]))
    if args.diversity_astig is not None:
        if args.radial:
            sys.exit("--diversity-astig needs the full basis (drop --radial:"
                     " a radial pupil cannot express astigmatism)")
        coeffs = np.zeros((len(divs), 2))
        coeffs[:, 1] = divs  # full-basis phase mode 1 = Z5 astigmatism
        phases = zernike_diversity(model, coeffs)
    else:
        phases = defocus_diversity(model, divs)

    fam_map = _family_map("defocus", "phase", "modulus")
    if any(f not in fam_map for f in args.families):
        sys.exit("--diversity-* fits the defocus/phase/modulus families")
    families = tuple(fam_map[f] for f in args.families)
    params0 = _load_params_json(model, args.params_json) if args.params_json else None

    t0 = time.time()
    res = fit_psf_diversity(
        model, data, phases, families=families, params0=params0,
        gamma=args.diversity_gamma,
        config=PsfFitConfig(max_iter=args.iters, grtol=0.0),
        phase_freeze_head=1 if args.pin_z4 else None,  # None = auto (3D pins Z4)
    )
    print(f"diversity fit ({len(divs)} channels): {int(res.iterations)} "
          f"iters, metric {float(res.f):.6g}, {time.time()-t0:.1f}s")
    params = {name: _np(getattr(res.params, name)).tolist()
              for name in res.params._fields}
    std = None
    if args.uncertainty:
        from microtipi_tpu_torch.jobs.diversity import diversity_fit_uncertainty

        unc = diversity_fit_uncertainty(
            model, res.params, families, data, phases, gamma=args.diversity_gamma,
            phase_freeze_head=1 if args.pin_z4 else None,  # match the fit
        )
        std = {k: _np(v).tolist() for k, v in unc.std.items()}
        print(f"noise sigma (profiled-residual MLE): {float(unc.sigma):.4g}"
              f" (in-basin error bars; NaN = held-fixed gauge mode; "
              f"BASELINE.md caveat)")
    for name, vals in params.items():
        line = f"{name}: {np.round(np.asarray(vals), 5)}"
        if std is not None and name in std:
            line += f"  +- {np.round(np.asarray(std[name]), 5)}"
        print(line)
    if args.params_out:
        out = {"cost": float(res.f), "model": args.model,
               "dxy": args.dxy, "dz": args.dz,
               "diversity": list(divs),
               "diversity_kind": ("astig" if args.diversity_astig is not None
                                  else "defocus"), **params}
        if std is not None:
            out["std"] = std
        with open(args.params_out, "w") as fh:
            json.dump(out, fh, indent=1)
        print("wrote", args.params_out)
    if args.object_out:
        with torch.no_grad():
            xhat = _np(diversity_object_estimate(model, res.params, data, phases, gamma=args.diversity_gamma))
        _write_out(args, args.object_out, xhat, dxy=args.dxy, dz=args.dz)
        print(f"wrote {args.object_out} (profiled multi-frame Wiener object;"
              f" use deconv --params-json for a regularized solve)")
    if args.out:
        psf = _psf_of(model, res.params)
        if args.centered:
            psf = roll(psf)
        _write_out(args, args.out, _np(psf), dxy=args.dxy, dz=args.dz)
        print("wrote", args.out)


def cmd_fitpsf(args):
    """``fitpsf`` (``fitpsf.py:237-414``)."""
    import json

    from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig, fit_psf_beads
    from microtipi_tpu_torch.utils.arrays import roll

    stacks = args.stack if isinstance(args.stack, list) else [args.stack]
    if getattr(args, "depth_ladder", None):
        _cmd_fitpsf_ladder(args, stacks)
        return
    if (getattr(args, "diversity_dz", None) is not None
            or getattr(args, "diversity_astig", None) is not None):
        _cmd_fitpsf_diversity(args, stacks)
        return
    if len(stacks) > 1:
        sys.exit("several bead stacks only make sense with --depth-ladder "
                 "Z1..ZK or --diversity-dz DZ1..DZD (one stack per known "
                 "depth / diversity)")
    args.stack = stacks[0]
    data = _tensor(args, _read_input_volume(args, args.stack))
    _resolve_geometry(args, args.stack)
    if args.empirical_out:
        # Model-free path: distill the measurement itself into a PSF
        # (center + clamp + unit-sum; see jobs.psf_fit.empirical_psf for
        # the measured recipe incl. why tails must not be thresholded).
        from microtipi_tpu_torch.jobs.psf_fit import empirical_psf

        patch = tuple(args.bead_patch) if args.bead_patch else None
        if args.n_beads > 1:
            from microtipi_tpu_torch.jobs.psf_fit import average_beads

            data, used = average_beads(data, n_beads=args.n_beads, patch=patch)
            print(f"averaged {used} beads -> patch {tuple(data.shape)}")
        h = empirical_psf(data)
        if args.centered:
            h = roll(h)
        _write_out(args, args.empirical_out, _np(h), dxy=args.dxy, dz=args.dz)
        print(f"wrote {args.empirical_out} (empirical PSF, "
              f"{'centered' if args.centered else 'corner-origin'}, unit sum)")
        return
    fam_map = _family_map()
    if "depth" in args.families and args.model != "gl":
        sys.exit("--families depth requires --model gl")
    if "sheet" in args.families and args.model != "lightsheet":
        sys.exit("--families sheet requires --model lightsheet")
    if "sted" in args.families and args.model != "sted":
        sys.exit("--families sted requires --model sted")
    if "cavity" in args.families and args.model != "4pi":
        sys.exit("--families cavity requires --model 4pi")
    families = tuple(fam_map[f] for f in args.families)

    if args.field_out:
        # Field-varying calibration: one fit per detected bead -> anchors
        # JSON for deconv --field-json (jobs.psf_fit.calibrate_field).
        from microtipi_tpu_torch.jobs.psf_fit import calibrate_field

        patch = tuple(args.bead_patch) if args.bead_patch else \
            (int(data.shape[0]), 32, 32)
        model = _model(args, patch)
        anchors, fits = calibrate_field(
            model, data, families=families, n_beads=args.n_beads,
            config=PsfFitConfig(max_iter=args.iters, grtol=0.0),
            phase_freeze_head=1 if args.pin_z4 else 0,
        )
        entries = []
        for ((y, x), params), res in zip(anchors, fits):
            entry = {"position": [y, x], "cost": float(res.f)}
            entry.update({name: _np(getattr(params, name)).tolist()
                          for name in params._fields})
            entries.append(entry)
            print(f"bead @ (y={y:.0f}, x={x:.0f}): cost {float(res.f):.4g}, "
                  f"{int(res.iterations)} iters")
        with open(args.field_out, "w") as fh:
            json.dump({"model": args.model, "dxy": args.dxy, "dz": args.dz,
                       "patch": list(patch), "anchors": entries}, fh, indent=1)
        print(f"wrote {args.field_out} ({len(entries)} anchors)")
        return

    if args.n_beads > 1:
        from microtipi_tpu_torch.jobs.psf_fit import average_beads

        patch = tuple(args.bead_patch) if args.bead_patch else None
        data, used = average_beads(data, n_beads=args.n_beads, patch=patch)
        print(f"averaged {used} beads -> patch {tuple(data.shape)} (~{used**0.5:.1f}x SNR)")
    model = _model(args, data.shape)

    t0 = time.time()
    res, amp = fit_psf_beads(
        model, data, families,
        config=PsfFitConfig(max_iter=args.iters, grtol=0.0),
        phase_freeze_head=1 if args.pin_z4 else 0,
    )
    f = float(res.f)
    print(f"fitpsf: {int(res.iterations)} iters, cost {f:.6g}, bead amplitude "
          f"{float(amp):.4g}, {time.time()-t0:.1f}s")
    params = {
        name: _np(getattr(res.params, name)).tolist()
        for name in res.params._fields
    }
    std = None
    if args.uncertainty:
        from microtipi_tpu_torch.jobs.psf_fit import bead_fit_uncertainty

        unc = bead_fit_uncertainty(model, res.params, families, data)
        std = _std_doc(unc.std)
        print(f"noise sigma (residual MLE): {float(unc.sigma):.4g}")
    for name, vals in params.items():
        line = f"{name}: {np.round(np.asarray(vals), 5)}"
        if std is not None and name in std:
            line += f"  +- {np.round(np.asarray(std[name]), 5)}"
        print(line)
    if args.params_out:
        out = {"cost": f, "amplitude": float(amp), "model": args.model,
               "dxy": args.dxy, "dz": args.dz, **params}
        if std is not None:
            out["std"] = std
        with open(args.params_out, "w") as fh:
            json.dump(out, fh, indent=1)
        print("wrote", args.params_out)
    psf_out = None
    if args.retrieve_map and args.model != "widefield":
        sys.exit("--retrieve-map needs the scalar pupil synthesis "
                 "(--model widefield)")
    if args.retrieve_map:
        # Nonparametric pupil retrieval on top of the parametric fit
        # (jobs/phase_retrieval.py): GS + VMLMB over pixelwise maps,
        # warm-started/anchored at the fitted parameters.
        from microtipi_tpu_torch.jobs.phase_retrieval import project_phase, retrieve_pupil
        from microtipi_tpu_torch.ops.metrics import strehl_ratio_from_pupil

        t0 = time.time()
        ret = retrieve_pupil(
            model, data, params0=res.params, fit_modulus=args.retrieve_modulus,
            config=PsfFitConfig(max_iter=args.iters * 3, grtol=0.0),
        )
        with torch.no_grad():
            coefs = _np(project_phase(model, ret.phi, ret.mask))
            s = float(strehl_ratio_from_pupil(model, ret.phi, rho=ret.rho))
        print(f"retrieve-map: cost {float(ret.f):.6g}, "
              f"{int(ret.iterations)} iters, {time.time()-t0:.1f}s; "
              f"Strehl {s:.3f}; Zernike projection {np.round(coefs, 4)}")
        save = {"phi": _np(ret.phi), "mask": _np(ret.mask),
                "zernike_projection": coefs,
                "defocus": _np(res.params.defocus),
                "dxy": args.dxy, "dz": args.dz}
        if ret.rho is not None:
            save["rho"] = _np(ret.rho)
        np.savez(args.retrieve_map, **save)
        print("wrote", args.retrieve_map)
        psf_out = ret.psf
    if args.out:
        psf = psf_out if psf_out is not None else _psf_of(model, res.params)
        if args.centered:
            psf = roll(psf)
        _write_out(args, args.out, _np(psf), dxy=args.dxy, dz=args.dz)
        print("wrote", args.out)
