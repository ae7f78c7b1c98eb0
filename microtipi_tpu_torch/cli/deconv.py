"""The ``deconv`` subcommand: non-blind object restoration with a known or
synthesized PSF (reference semantics: the TiPi ``DeconvolutionJob`` object
step driven by ``BlindDeconvJob.java:103-108``), plus the shared
``--uncertainty`` tail. Mode variants live in ``deconv_modes``.

Port of ``microtipi_tpu/cli/deconv.py``: the jitted solves are direct calls
of the ported jobs on ``args.device``; ``--mesh`` runs
``parallel.deconv.sharded_deconvolve`` (``shared._make_mesh``).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from microtipi_tpu_torch.cli.deconv_modes import (
    _cmd_deconv_depthvar,
    _cmd_deconv_multichannel,
    _cmd_deconv_plate,
    _cmd_deconv_superres,
    _cmd_deconv_timeseries,
    _cmd_deconv_timeseries_multichannel,
)
from microtipi_tpu_torch.cli.shared import (
    _deconv_config,
    _depthvar_anchor_array,
    _is_plate,
    _load_params_json,
    _make_mesh,
    _model,
    _np,
    _read_input_volume,
    _resolve_geometry,
    _tensor,
    _weights,
    _write_out,
)


def cmd_deconv(args):
    """``deconv`` (``deconv.py:33-300``)."""
    from microtipi_tpu_torch.io.tiffstack import read_stack
    from microtipi_tpu_torch.jobs.deconv import deconvolve
    from microtipi_tpu_torch.utils.arrays import unroll

    if getattr(args, "mixing", None) and not getattr(args, "all_channels", False):
        sys.exit("--mixing is the joint unmixing solve over all channels; "
                 "it requires --all-channels")
    if getattr(args, "uncertainty", 0):
        # Laplace curvature of the single-volume objective only: fail now
        # rather than silently ignoring the flag on other paths.
        for flag, name in (("mu_t", "--mu-t"), ("all_channels", "--all-channels"),
                           ("tile", "--tile"), ("mesh", "--mesh"),
                           ("superres", "--superres"), ("depthvar", "--depthvar"),
                           ("depthvar_maps", "--depthvar-maps")):
            if getattr(args, flag, None):
                sys.exit(f"--uncertainty does not compose with {name}; run it "
                         "on the plain single-volume solve (crop a region of "
                         "interest if the full problem needs those paths)")
        if _is_plate(args.data) and not getattr(args, "well", None):
            sys.exit("--uncertainty does not compose with the whole-plate "
                     "fan-out; pick one well (--well)")
        if args.method not in ("vmlmb", "admm", "fista"):
            # vmlmb/admm/fista converge the same TV objective, so the Laplace
            # curvature is valid at any of their solutions; RL maximizes a
            # different (prior-free) likelihood.
            sys.exit("--uncertainty is the Laplace curvature of the TV "
                     "objective at its converged MAP; use --method "
                     "vmlmb/admm/fista (rl solves a different objective)")
    if getattr(args, "mu_t", None) is not None:
        if getattr(args, "superres", None):
            sys.exit("--mu-t and --superres do not compose yet; run the "
                     "fine-grid solve per timepoint or drop --superres")
        if getattr(args, "all_channels", False):
            _cmd_deconv_timeseries_multichannel(args)
            return
        _cmd_deconv_timeseries(args)
        return
    for flag, name in (("bleach_correct", "--bleach-correct"),
                       ("register_t", "--register-t")):
        if getattr(args, flag, False):
            sys.exit(f"{name} only applies to the time-series solver; "
                     "pass --mu-t to enable it (it would otherwise be "
                     "silently ignored)")
    if getattr(args, "all_channels", False):
        _cmd_deconv_multichannel(args)
        return
    if _is_plate(args.data) and not getattr(args, "well", None):
        _cmd_deconv_plate(args)
        return
    # --tile streams host-side tiles through the device: keep the volume in
    # host memory (a volume beyond the card's memory cannot live there
    # whole). Every other path wants the device tensor.
    data = _read_input_volume(args, args.data)
    if not getattr(args, "tile", None) or getattr(args, "superres", None):
        data = _tensor(args, data)
    depthvar_tiled = bool(getattr(args, "depthvar", 0)) and bool(getattr(args, "tile", None))
    if getattr(args, "depthvar_maps", None) and getattr(args, "tile", None):
        sys.exit("--depthvar-maps does not compose with --tile; use the "
                 "parametric route (--depthvar K --params-json) for tiled "
                 "space-variant solves")
    if (getattr(args, "depthvar", 0) or getattr(args, "depthvar_maps", None)) \
            and not depthvar_tiled:
        _cmd_deconv_depthvar(args, data)
        return
    if getattr(args, "superres", None):
        _resolve_geometry(args, args.data, log=lambda *a: None)
        _cmd_deconv_superres(args, data)
        return
    field_json = getattr(args, "field_json", None)
    if not args.psf and not field_json and not depthvar_tiled:
        sys.exit("--psf is required (or --depthvar K / --depthvar-maps / "
                 "--tile with --field-json)")
    # No model is built on the plain path, but the output metadata should
    # still inherit the input's pixel sizes.
    _resolve_geometry(args, args.data, log=lambda *a: None)
    depthvar_zs = None
    if field_json or depthvar_tiled:
        # Field-varying tiled solve: each JSON is a fitpsf --params-out
        # file with an added "position": [y, x] (field voxels) entry.
        # With --depthvar K on top: the fully space-variant composition
        # (lateral IDW x axial anchor blend, jobs.tiled.field_depthvar_psf).
        import json

        from microtipi_tpu_torch.jobs.tiled import field_depthvar_psf, field_psf

        if not getattr(args, "tile", None):
            sys.exit("--field-json is the per-tile PSF source; it requires --tile")
        if args.psf:
            sys.exit("--field-json/--depthvar and --psf are exclusive under --tile")
        if depthvar_tiled and args.model != "gl":
            sys.exit("--tile --depthvar requires --model gl "
                     "(anchors vary the DEPTH family)")
        # Clamp the tile to the volume first (tiled_deconvolve clamps the
        # same way): the per-tile model and the depthvar tile-z anchors must
        # see the clamped extent.
        args.tile = [min(t, n) for t, n in zip(args.tile, data.shape)]
        model = _model(args, tuple(args.tile))
        anchors = []
        for path in field_json or ():
            with open(path) as fh:
                doc = json.load(fh)
            docs = doc["anchors"] if "anchors" in doc else [doc]  # fitpsf --field-out
            for entry in docs:
                if "position" not in entry:
                    sys.exit(f"{path}: add a \"position\": [y, x] entry "
                             "(field coordinates of the calibration, in voxels)")
                params = model.init_params()
                for name in params._fields:
                    if name in entry:
                        params = params._replace(**{name: torch.as_tensor(
                            entry[name], dtype=model.dtype, device=model.device)})
                anchors.append(
                    (tuple(float(v) for v in entry["position"]), params))
        if depthvar_tiled and not anchors:
            # One calibration (e.g. a depth ladder), laterally constant:
            # the single-anchor degenerate IDW mix.
            params = (_load_params_json(model, args.params_json)
                      if args.params_json else model.init_params())
            anchors = [((0.0, 0.0), params)]
        with torch.no_grad():
            if depthvar_tiled:
                depthvar_zs = _depthvar_anchor_array(
                    args, args.depthvar, args.tile[0])
                psf = field_depthvar_psf(model, anchors, depthvar_zs)
            else:
                psf = field_psf(model, anchors)
    else:
        psf = _tensor(args, read_stack(args.psf))
        if args.psf_centered:
            psf = unroll(psf)
    if getattr(args, "auto_mu", False) and (
            args.method == "rl" or getattr(args, "tile", None)):
        # Must precede the rl/tile branches: both return before the solve.
        sys.exit("--auto-mu selects the VMLMB TV weight; it does not apply "
                 "to --method rl (use --rl-stop) or --tile (tiles share one "
                 "mu — run auto-mu on a representative crop first)")
    if args.method == "rl" and not getattr(args, "tile", None):
        from microtipi_tpu_torch.jobs.richardson_lucy import richardson_lucy

        bp = {"matched": "matched", "wb": "wiener-butterworth"}[args.rl_backprojector]
        t0 = time.time()
        x, iters_used = richardson_lucy(
            data, psf, iterations=args.iters, mu=args.mu, epsilon=args.epsilon,
            accelerate=args.rl_accelerate, backprojector=bp,
            stop=args.rl_stop, stop_sigma=args.noise_sigma, stop_tau=args.tau,
            return_iterations=True)
        iters_used = int(iters_used)
        tag = ("" if args.rl_stop == "fixed"
               else f" ({args.rl_stop} discrepancy stop, cap {args.iters})")
        print(f"rl: {iters_used} iters{tag}, {time.time()-t0:.1f}s")
        _write_out(args, args.out, _np(x), dxy=getattr(args, "dxy", None), dz=getattr(args, "dz", None))
        print("wrote", args.out)
        return
    if args.method in ("admm", "fista"):
        # admm composes with --tile (each tile is a plain circulant solve;
        # jobs/tiled.py); mesh/auto-mu and all of fista stay vmlmb-only.
        gated = (("mesh", "--mesh"), ("auto_mu", "--auto-mu"))
        if args.method == "fista":
            gated = (("tile", "--tile"),) + gated
        for flag, name in gated:
            if getattr(args, flag, None):
                sys.exit(f"--method {args.method} runs the plain single-chip "
                         f"solve; drop {name} or use --method vmlmb")
    cfg = _deconv_config(args, data.shape)
    w = _weights(args, data)

    if getattr(args, "tile", None):
        from microtipi_tpu_torch.jobs.tiled import tiled_deconvolve

        if getattr(args, "mesh", None):
            sys.exit("--tile streams tiles through one chip; drop --mesh")
        overlap = args.overlap
        if isinstance(overlap, list):
            if len(overlap) == 1:
                overlap = overlap[0]
            elif len(overlap) == 3:
                overlap = tuple(overlap)
            else:
                sys.exit("--overlap takes one value or three (OZ OY OX)")
        t0 = time.time()
        x = tiled_deconvolve(
            np.asarray(data), psf, weights=w, tile=tuple(args.tile),
            overlap=overlap, config=cfg, method=args.method,
            rl_iterations=args.iters, max_batch=args.tile_batch,
            depthvar_anchors=depthvar_zs, device=args.device,
        )
        tag = f" depthvar K={args.depthvar}" if depthvar_zs is not None else ""
        print(f"deconv[tiled {tuple(args.tile)}+{overlap}{tag}]: "
              f"{time.time()-t0:.1f}s")
        _write_out(args, args.out, x, dxy=args.dxy, dz=args.dz)
        print("wrote", args.out)
        return

    if getattr(args, "auto_mu", False) and getattr(args, "mesh", None):
        sys.exit("--auto-mu runs on one chip; drop --mesh")
    mesh = _make_mesh(args)
    if getattr(args, "auto_mu", False):
        from microtipi_tpu_torch.jobs.autotune import deconvolve_auto_mu

        t0 = time.time()
        auto = deconvolve_auto_mu(data, psf, weights=w, config=cfg, sigma=args.noise_sigma, tau=args.tau)
        res = auto.result
        print(f"auto-mu: mu={float(auto.mu):.4g} "
              f"(discrepancy {float(auto.discrepancy):.4g} "
              f"/ target {float(auto.target):.4g}"
              + ("" if np.isnan(float(auto.sigma))
                 else f", sigma={float(auto.sigma):.4g}") + ")")
    elif mesh is not None:
        from microtipi_tpu_torch.parallel.deconv import sharded_deconvolve
        from microtipi_tpu_torch.parallel.mesh import gather

        t0 = time.time()
        res = sharded_deconvolve(data, psf, mesh, weights=w, config=cfg)
        res = res._replace(x=gather(res.x, data.device))
    elif args.method in ("admm", "fista"):
        # Alternative first-order engines on the same objective
        # (jobs/admm.py). Fixed iteration count (--iters).
        from microtipi_tpu_torch.jobs.admm import admm_deconvolve, fista_deconvolve

        if args.method == "fista" and cfg.data_term == "poisson":
            sys.exit("--method fista supports the Gaussian data term; use "
                     "--method admm (pointwise KL prox) or vmlmb for poisson")
        eng = admm_deconvolve if args.method == "admm" else fista_deconvolve
        t0 = time.time()
        res = eng(data, psf, weights=w, config=cfg)
    else:
        t0 = time.time()
        res = deconvolve(data, psf, weights=w, config=cfg)
    f = float(res.f)
    wall = time.time() - t0
    print(f"deconv: {int(res.iterations)} iters, cost {f:.6g}, {wall:.1f}s")
    _write_out(args, args.out, _np(res.x), dxy=getattr(args, "dxy", None), dz=getattr(args, "dz", None))
    print("wrote", args.out)
    if args.report:
        import json

        it = int(res.iterations)
        with open(args.report, "w") as fh:
            json.dump({
                "cost": f, "iterations": it, "evaluations": int(res.evaluations),
                "status": int(res.status), "wall_seconds": round(wall, 3),
                "f_history": _np(res.f_history)[:it + 1].tolist(),
                "pg_history": _np(res.pg_history)[:it + 1].tolist(),
            }, fh, indent=1)
        print("wrote", args.report)
    if getattr(args, "uncertainty", 0):
        ucfg = cfg
        if getattr(args, "auto_mu", False):
            # The curvature must be taken at the mu the solve actually used.
            import dataclasses

            ucfg = dataclasses.replace(cfg, mu=float(auto.mu))
        _emit_object_uncertainty(args, data, psf, res.x, w, ucfg)


def _emit_object_uncertainty(args, data, psf, x, w, ucfg):
    """Shared --uncertainty tail of the deconv/blind commands
    (``deconv.py:303-343``): the Laplace sigma (jobs/uncertainty.py) written
    next to --out as *_std. The probes come from a ``torch.Generator``
    seeded with ``--uncertainty-seed`` (JAX draws from ``PRNGKey(seed)``:
    the two packages draw different probes from one seed)."""
    import os

    from microtipi_tpu_torch.jobs.uncertainty import object_uncertainty

    k, seed = args.uncertainty, args.uncertainty_seed
    cg_maxiter = getattr(args, "uncertainty_cg_maxiter", 100)
    t0 = time.time()
    gen = torch.Generator(device=data.device).manual_seed(seed)
    est = object_uncertainty(data, psf, x, weights=w, config=ucfg, n_probes=k,
                             cg_maxiter=cg_maxiter, generator=gen)
    sigma = _np(est.sigma)
    med = float(np.median(sigma[sigma > 0])) if (sigma > 0).any() else 0.0
    std_path = getattr(args, "uncertainty_out", None)
    if not std_path:
        stem, ext = os.path.splitext(str(args.out))
        std_path = stem + "_std" + ext
    resid = float(est.residual)
    print(f"uncertainty: {k} probes, cg residual {resid:.2e}, "
          f"median sigma {med:.4g}, {time.time()-t0:.1f}s")
    if resid > 1e-2:
        # A CG residual that is not << 1 means the H u = z solves did not
        # converge and sigma measures the wrong curvature.
        print(f"WARNING: CG residual {resid:.2e} is not << 1 -- the sigma "
              f"volume is unreliable; raise --uncertainty-cg-maxiter "
              f"(currently {cg_maxiter})")
    _write_out(args, std_path, sigma,
               dxy=getattr(args, "dxy", None), dz=getattr(args, "dz", None))
    print("wrote", std_path)
