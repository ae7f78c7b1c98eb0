"""Shared CLI plumbing: argument groups, geometry/model resolution, IO.

Port of ``microtipi_tpu/cli/shared.py``. Everything here is
command-agnostic: argparse groups reused across subcommands, input readers
(TIFF/HDF5/zarr/raw/hyperstack, NumPy on the host through ``io``), the model
and config builders, output writers, and the plate and hyperstack helpers.

The JAX module's ``jax.jit`` wrappers become plain calls and ``jnp.asarray``
becomes ``torch.as_tensor(..., device=args.device)``: ``main`` puts the
device every command runs on into ``args.device`` (the card unless the
caller asks for the CPU). :func:`_build_model` returns the PSF family's
config, as the JAX one does; :func:`_model` puts the model it describes on
the device (``models.model_for``).

Dropped as TPU-only (``ROADMAP.md``, "Not ported"):

- ``--exact-fft`` / ``--no-exact-fft`` (``shared.py:170-180``, ``:481-482``):
  the matmul DFT stood in for the TPU's bf16-grade FFT; cuFFT float32 is
  float32-exact.
- ``_enable_compile_cache`` (``shared.py:740-779``): JAX's persistent
  compilation cache; the port compiles its kernels once with ``nvcc``.

``--mesh BATCH Z`` runs the sharded jobs (``parallel/``) on a mesh that
:func:`_make_mesh` builds on ``args.device``: B*Z visible cards, or B*Z
entries of the CPU when the command runs on the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def _comma_floats(s: str) -> list[float]:
    """Comma-separated float list CLI type (``shared.py:18-26``). Used where
    values are often negative: argparse's negative-number heuristic does not
    recognize scientific notation (``-2e-7`` parses as an option string), so
    these flags take one ``=``-joined comma list instead of nargs."""
    try:
        return [float(v) for v in s.split(",") if v.strip() != ""]
    except ValueError:
        raise argparse.ArgumentTypeError(f"not a comma-separated float list: {s!r}")


def _family_map(*names):
    """Family-name -> flag map derived from the live registry
    (``shared.py:29-36``). No args = every registered family."""
    from microtipi_tpu_torch.models.microscope import FAMILY_NAMES

    inv = {v: k for k, v in FAMILY_NAMES.items()}
    return {n: inv[n] for n in (names or inv)}


def _np(x) -> np.ndarray:
    """A tensor (on any device) or array as a host NumPy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tensor(args, a, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``a`` on the command's device (``jnp.asarray``'s counterpart)."""
    if isinstance(a, np.ndarray):
        a = np.ascontiguousarray(a)
    return torch.as_tensor(a, dtype=dtype, device=args.device)


def _model_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("optics")
    g.add_argument("--model",
                   choices=["widefield", "gl", "confocal", "2p", "vectorial",
                            "lightsheet", "sted", "4pi"],
                   default="widefield",
                   help="PSF model family: widefield (reference parity), "
                        "gl (Gibson-Lanni depth aberration), confocal, "
                        "2p (two-photon), vectorial (Richards-Wolf high-NA), "
                        "lightsheet (SPIM: widefield detection x Gaussian "
                        "sheet; --sheet-mode for Bessel/lattice), 4pi "
                        "(two-objective interferometric, --fourpi-type A|C)")
    g.add_argument("--ns", type=float, default=1.38,
                   help="[gl] sample refractive index")
    g.add_argument("--depth", type=float, default=0.0,
                   help="[gl] nominal imaging depth [m]")
    g.add_argument("--wavelength-exc", type=float, default=0.0,
                   help="[confocal/lightsheet] excitation wavelength [m] "
                        "(0 = same as emission)")
    g.add_argument("--pinhole", type=float, default=0.0,
                   help="[confocal] object-space pinhole radius [m] (0 = ideal)")
    g.add_argument("--wavelength-dep", type=float, default=0.0,
                   help="[sted] depletion wavelength [m] (0 = emission)")
    g.add_argument("--depletion", choices=["donut", "bottle"], default="donut",
                   help="[sted] depletion mask: lateral vortex donut or "
                        "axial pi-disk bottle beam")
    g.add_argument("--fourpi-type", choices=["A", "C"], default="A",
                   help="[4pi] interference on excitation only (A) or both "
                        "arms (C)")
    g.add_argument("--cavity-phase", type=float, default=0.0,
                   help="[4pi] initial cavity phase [rad] (fittable: "
                        "--families cavity)")
    g.add_argument("--saturation", type=float, default=0.0,
                   help="[sted] saturation factor zeta = I_peak/I_sat "
                        "(fittable via --families sted)")
    g.add_argument("--sheet-na", type=float, default=0.1,
                   help="[lightsheet] illumination NA of the sheet-forming "
                        "optics (sets the default waist)")
    g.add_argument("--sheet-mode", choices=["gaussian", "bessel", "lattice"],
                   default="gaussian",
                   help="[lightsheet] excitation sheet type: gaussian "
                        "(cylindrical focus), bessel (dithered annulus), "
                        "lattice (dithered beam lattice) — the latter two "
                        "use --sheet-na-min/--sheet-na-max")
    g.add_argument("--sheet-na-min", type=float, default=0.4,
                   help="[bessel/lattice] illumination annulus inner NA")
    g.add_argument("--sheet-na-max", type=float, default=0.55,
                   help="[bessel/lattice] illumination annulus outer NA")
    g.add_argument("--lattice-ky", type=_comma_floats, default=[0.0],
                   metavar="U1,U2,..",
                   help="[lattice] beam positions as ky/k fractions on the "
                        "ring (each u spawns the symmetric spot set)")
    g.add_argument("--no-sheet-divergence", action="store_true",
                   help="[lightsheet] ideal uniform sheet (drop the "
                        "Gaussian-beam waist growth across the FOV)")
    g.add_argument("--na", type=float, default=1.4, help="numerical aperture")
    g.add_argument("--wavelength", type=float, default=None,
                   help="emission wavelength [m] (default: the OME channel's "
                        "EmissionWavelength from the input, else 561e-9)")
    g.add_argument("--ni", type=float, default=1.518, help="immersion refractive index")
    g.add_argument("--dxy", type=float, default=None,
                   help="lateral pixel size [m] (default: input TIFF metadata, else 80e-9)")
    g.add_argument("--dz", type=float, default=None,
                   help="axial step [m] (default: input TIFF metadata, else 200e-9)")
    g.add_argument("--n-phase", type=int, default=8, help="Zernike phase modes")
    g.add_argument("--n-modulus", type=int, default=1, help="Zernike modulus modes")
    g.add_argument("--radial", action="store_true", help="radially symmetric pupil")


def _hyperstack_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("hyperstack input")
    g.add_argument("--channel", type=int, default=0,
                   help="channel index for OME hyperstack inputs (default 0)")
    g.add_argument("--timepoint", type=int, default=0,
                   help="timepoint index for OME hyperstack inputs (default 0)")
    g.add_argument("--well", default=None,
                   help="well path (e.g. A/1) for NGFF plate inputs; omit to "
                        "fan out over every well/field (deconv/blind)")
    g.add_argument("--field", type=int, default=0,
                   help="field index within --well for plate inputs (default 0)")


def _deconv_args(p: argparse.ArgumentParser, methods=("vmlmb", "rl")):
    g = p.add_argument_group("object step")
    g.add_argument("--mu", type=float, default=0.01, help="TV weight")
    g.add_argument("--auto-mu", action="store_true",
                   help="pick the TV weight by the Morozov discrepancy "
                        "principle (jobs/autotune.py) instead of --mu; noise "
                        "sigma is estimated from the data unless --noise-sigma")
    g.add_argument("--noise-sigma", type=float, default=None,
                   help="[auto-mu] known Gaussian noise sigma (default: "
                        "Immerkaer-MAD estimate from the data)")
    g.add_argument("--tau", type=float, default=1.0,
                   help="[auto-mu] Morozov safety factor on the discrepancy "
                        "target (>=1; larger regularizes more)")
    g.add_argument("--epsilon", type=float, default=1.0, help="TV edge threshold")
    g.add_argument("--sparsity", type=float, default=0.0,
                   help="smoothed-L1 intensity prior weight (sparse "
                        "deconvolution; confines background halo flux)")
    g.add_argument("--sparsity-epsilon", type=float, default=None,
                   help="L1 smoothing scale (default: --epsilon; smaller = "
                        "closer to exact L1)")
    g.add_argument("--hessian", type=float, default=0.0,
                   help="Hessian continuity prior weight (anti-staircasing "
                        "complement to --mu for smooth specimens)")
    g.add_argument("--iters", type=int, default=50, help="VMLMB iterations")
    g.add_argument("--grtol", type=float, default=None,
                   help="VMLMB relative gradient tolerance (default: the "
                        "solver's 1e-3; 0 disables, running --iters out)")
    g.add_argument("--gatol", type=float, default=None,
                   help="VMLMB absolute gradient tolerance (default 0)")
    g.add_argument("--no-positivity", action="store_true")
    g.add_argument("--pad", type=int, default=0, help="pad object grid by this many voxels per side")
    g.add_argument("--gain", type=float, default=0.0, help="camera gain e-/ADU for variance weights (0 = uniform)")
    g.add_argument("--readout", type=float, default=1.0, help="readout variance [ADU^2]")
    g.add_argument("--auto-gain", action="store_true",
                   help="estimate camera gain + readout variance from the "
                        "data by single-shot photon transfer "
                        "(weights/updaters.py) and use variance weights")
    g.add_argument("--method", choices=list(methods), default="vmlmb",
                   help="object solver: VMLMB+TV (default), Richardson-Lucy, "
                        "admm (first-order engine on the same TV objective, "
                        "fixed --iters; ~5x faster to matched quality — "
                        "BASELINE.md), fista (deconv only), or (watch only) "
                        "blind / blind-once (calibrate on first file)")
    g.add_argument("--admm-reltol", type=float, default=0.0,
                   help="[admm] relative primal/dual residual tolerance "
                        "(Boyd 2011 §3.3; the admm analogue of --grtol). "
                        "0 (default) runs --iters out; 1e-3 is a practical "
                        "production value, 1e-4 tight (--iters becomes the "
                        "cap)")
    g.add_argument("--admm-abstol", type=float, default=0.0,
                   help="[admm] absolute residual tolerance in data units "
                        "(Boyd 2011 §3.3; the admm analogue of --gatol; "
                        "scaled internally by sqrt(#elements))")
    g.add_argument("--rl-accelerate", action="store_true",
                   help="[rl] Biggs-Andrews vector extrapolation (~2-3x fewer "
                        "iterations to a given likelihood)")
    g.add_argument("--rl-backprojector", choices=["matched", "wb"],
                   default="matched",
                   help="[rl] wb = Wiener-Butterworth backprojector (Guo 2020; "
                        "~10x fewer iterations, semiconvergence arrives "
                        "equally sooner on noisy data)")
    g.add_argument("--rl-stop", choices=["fixed", "gaussian", "poisson"],
                   default="fixed",
                   help="[rl] discrepancy-principle early stopping: halt when "
                        "the residual hits its noise expectation (--iters "
                        "becomes the cap; gaussian uses --noise-sigma or a "
                        "blind estimate, --tau scales the target)")
    g.add_argument("--data-term", choices=["gaussian", "poisson"], default="gaussian",
                   help="data fidelity: gaussian least squares (reference semantics) "
                        "or poisson generalized-KL deviance (photon-counting data)")
    g.add_argument("--background", type=float, default=0.0,
                   help="[poisson] known background offset b in d ~ Poisson(Hx + b)")


def _resolve_geometry(args, stack_path=None, log=print):
    """Fill missing --dxy/--dz from the input's pixel-size metadata
    (``shared.py:204-248``), falling back to the historical defaults."""
    meta_dxy = meta_dz = None
    if stack_path is not None and (args.dxy is None or args.dz is None):
        if _is_plate(stack_path):

            def read_pixel_size(p):  # first plate image carries the scale
                from microtipi_tpu_torch.io.plate import list_plate_images, read_plate_image

                well, field = list_plate_images(p)[0]
                _, meta = read_plate_image(p, well, field)
                return meta["dxy"], meta["dz"]

        elif _is_zarr(stack_path):
            from microtipi_tpu_torch.io.zarrstack import read_pixel_size
        elif str(stack_path).lower().endswith((".ome", ".xml")):

            def read_pixel_size(p):  # companion document: sizes in the XML
                from microtipi_tpu_torch.io.ome import parse_ome

                with open(p, "r", encoding="utf-8") as fh:
                    meta = parse_ome(fh.read())
                return meta["dxy"], meta["dz"]

        else:
            from microtipi_tpu_torch.io.tiffstack import read_pixel_size

        try:
            meta_dxy, meta_dz = read_pixel_size(stack_path)
        except Exception:
            pass
    if args.dxy is None:
        args.dxy = meta_dxy or 80e-9
        log(f"dxy = {args.dxy*1e9:.4g} nm ({'metadata' if meta_dxy else 'default'})")
    if args.dz is None:
        args.dz = meta_dz or 200e-9
        log(f"dz = {args.dz*1e9:.4g} nm ({'metadata' if meta_dz else 'default'})")
    if getattr(args, "wavelength", 0) is None:
        # An OME channel EmissionWavelength (set by _read_input_volume) wins
        # before we ever get here; this is the terminal fallback.
        args.wavelength = 561e-9
        log("wavelength = 561 nm (default)")


def _preprocess_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("preprocessing")
    g.add_argument("--flat", default=None, metavar="STACK",
                   help="flat-field reference (uniform slide); corrects "
                        "illumination/gain before solving")
    g.add_argument("--dark", default=None, metavar="STACK",
                   help="dark (camera offset) frame, subtracted first")
    g.add_argument("--hot-pixels", type=float, default=0.0, metavar="SIGMA",
                   help="replace impulsive outliers beyond SIGMA robust "
                        "sigmas with the local 3x3 median (0 = off; 5 is a "
                        "good default)")
    g.add_argument("--subtract-background", type=int, default=0, metavar="R",
                   help="rolling-ball background subtraction with radius R "
                        "pixels (0 = off)")
    g.add_argument("--destripe", choices=["x", "y"], default=None,
                   help="suppress illumination stripes running along this "
                        "in-plane axis (light-sheet shadowing; Fourier "
                        "notch, Muench et al. 2009 core) before solving")
    g.add_argument("--destripe-sigma", type=float, default=2.0, metavar="B",
                   help="[--destripe] notch half-width in frequency bins "
                        "along the stripe axis (how bent a stripe may be)")
    g.add_argument("--destripe-protect", type=float, default=4.0, metavar="B",
                   help="[--destripe] transverse low-frequency protect "
                        "radius in bins (real large-scale structure and DC "
                        "pass through untouched)")


def _build_preprocess(args):
    """Preprocessing callable (or None) from the --flat/--dark/--hot-pixels/
    --destripe/--subtract-background flags (``shared.py:278-317``): NumPy in,
    NumPy out, computed on the command's device. Dark/flat first, then
    impulse removal, then stripe suppression, then background — the order the
    physics composes in."""
    flat = getattr(args, "flat", None)
    dark = getattr(args, "dark", None)
    hot = float(getattr(args, "hot_pixels", 0.0) or 0.0)
    bg = int(getattr(args, "subtract_background", 0) or 0)
    stripe_axis = getattr(args, "destripe", None)
    if not (flat or dark or hot or bg or stripe_axis):
        return None
    from microtipi_tpu_torch.io.tiffstack import read_stack
    from microtipi_tpu_torch.ops import preprocess as pp

    bright_c = _tensor(args, read_stack(flat)) if flat else None
    dark_c = _tensor(args, read_stack(dark)) if dark else None

    def inner(v):
        v = _tensor(args, v, torch.float32)
        if bright_c is not None:
            v = pp.flat_field_correct(v, bright_c, dark_c)
        elif dark_c is not None:
            v = v - dark_c
        if hot:
            v = pp.remove_hot_pixels(v, hot)
        if stripe_axis:
            v = pp.destripe(v, axis=-1 if stripe_axis == "x" else -2,
                            sigma=args.destripe_sigma,
                            protect=args.destripe_protect)
        if bg:
            v = pp.subtract_background(v, bg)
        return _np(v)

    return inner


def _read_input_volume(args, path, log=print):
    """Read one (Nz, Ny, Nx) volume and apply any preprocessing flags
    (``shared.py:320-345``).

    OME hyperstacks (SizeC/SizeT > 1) are sliced at ``--timepoint``/
    ``--channel``; when the selected channel carries an OME
    ``EmissionWavelength`` and ``--wavelength`` was not given, the model
    wavelength is auto-filled from it."""
    vol = _read_raw_volume(args, path, log=log)
    pre = _build_preprocess(args)
    if pre is not None:
        vol = pre(vol)
        log("preprocessed input (ops.preprocess)")
    # Non-finite voxels (dead pixels, file corruption) poison FFT-based
    # solves globally; zero them here with a warning.
    vol = np.asarray(vol)
    bad = ~np.isfinite(vol)
    if bad.any():
        log(f"[input] {path}: zeroed {int(bad.sum())} non-finite voxel(s) "
            "(dead pixels / corruption; --gain adds statistical exclusion)")
        vol = np.where(bad, 0.0, vol).astype(vol.dtype)
    return vol


def _read_raw_volume(args, path, log=print):
    if _is_h5(path):
        from microtipi_tpu_torch.io.hdf5stack import read_bdv, read_h5

        try:
            return read_bdv(path)  # BigDataViewer layout first
        except Exception:
            return read_h5(path)
    if _is_plate(path):
        from microtipi_tpu_torch.io.plate import read_plate_image

        well = getattr(args, "well", None)
        if not well:
            sys.exit("input is an NGFF plate: select one image with "
                     "--well ROW/COL (and --field N), or run deconv/blind "
                     "without --well to process every well")
        arr, meta = read_plate_image(path, well, getattr(args, "field", 0))
    elif _is_zarr(path):
        from microtipi_tpu_torch.io.zarrstack import read_ngff_hyperstack

        arr, meta = read_ngff_hyperstack(path)
    else:
        try:
            from microtipi_tpu_torch.io.ome import read_ome_hyperstack

            arr, meta = read_ome_hyperstack(path)
        except Exception:
            from microtipi_tpu_torch.io.tiffstack import read_stack

            return read_stack(path)
    nt, nc = arr.shape[:2]
    t = int(getattr(args, "timepoint", 0) or 0)
    c = int(getattr(args, "channel", 0) or 0)
    if not (0 <= t < nt and 0 <= c < nc):
        sys.exit(f"--timepoint {t} / --channel {c} out of range (T={nt}, C={nc})")
    if nt > 1 or nc > 1:
        log(f"hyperstack T={nt} C={nc}: processing t={t} c={c} "
            "(select with --timepoint/--channel)")
    channels = meta.get("channels") or []
    if getattr(args, "wavelength", 0) is None and c < len(channels):
        em = channels[c].get("emission_wavelength")
        if em:
            args.wavelength = em
            log(f"wavelength = {em*1e9:.4g} nm (OME channel {c} emission)")
    return np.ascontiguousarray(arr[t, c])


def _build_model(args, shape):
    """The PSF family's config from the optics flags (``shared.py:397-457``)."""
    common = dict(
        shape=tuple(shape), na=args.na, wavelength=args.wavelength, ni=args.ni,
        dxy=args.dxy, dz=args.dz, n_phase=args.n_phase, n_modulus=args.n_modulus,
        radial=args.radial,
    )
    kind = getattr(args, "model", "widefield")
    if kind == "gl":
        from microtipi_tpu_torch.models.gibson_lanni import GibsonLanniConfig

        return GibsonLanniConfig(ns=args.ns, depth=args.depth, **common)
    if kind == "confocal":
        from microtipi_tpu_torch.models.confocal import ConfocalConfig

        return ConfocalConfig(
            wavelength_exc=args.wavelength_exc, pinhole=args.pinhole, **common
        )
    if kind == "2p":
        from microtipi_tpu_torch.models.confocal import TwoPhotonConfig

        return TwoPhotonConfig(**common)
    if kind == "vectorial":
        from microtipi_tpu_torch.models.vectorial import VectorialConfig

        return VectorialConfig(**common)
    if kind == "lightsheet":
        if getattr(args, "sheet_mode", "gaussian") != "gaussian":
            from microtipi_tpu_torch.models.lightsheet import StructuredSheetConfig

            return StructuredSheetConfig(
                sheet_mode=args.sheet_mode,
                sheet_na_min=args.sheet_na_min,
                sheet_na_max=args.sheet_na_max,
                lattice_ky=tuple(args.lattice_ky),
                wavelength_exc=args.wavelength_exc, **common
            )
        from microtipi_tpu_torch.models.lightsheet import LightSheetConfig

        return LightSheetConfig(
            sheet_na=args.sheet_na, wavelength_exc=args.wavelength_exc,
            divergence=not args.no_sheet_divergence, **common
        )
    if kind == "4pi":
        from microtipi_tpu_torch.models.fourpi import FourPiConfig

        return FourPiConfig(
            fourpi_type=args.fourpi_type, cavity_phase=args.cavity_phase,
            wavelength_exc=args.wavelength_exc, pinhole=args.pinhole,
            **common
        )
    if kind == "sted":
        from microtipi_tpu_torch.models.sted import STEDConfig

        return STEDConfig(
            wavelength_exc=args.wavelength_exc, pinhole=args.pinhole,
            wavelength_dep=args.wavelength_dep, depletion=args.depletion,
            saturation=args.saturation, **common
        )
    from microtipi_tpu_torch.models.widefield import WideFieldConfig

    return WideFieldConfig(**common)


def _model(args, shape):
    """The PSF model of :func:`_build_model` on the command's device."""
    from microtipi_tpu_torch.models import model_for

    return model_for(_build_model(args, shape), args.device)


def _psf_of(model, params) -> torch.Tensor:
    """``model.compute_psf(params)`` outside autograd."""
    with torch.no_grad():
        return model.compute_psf(params)


def _deconv_config(args, shape):
    """The object-step config (``shared.py:460-485``), without the TPU-only
    ``exact_fft`` switch."""
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig

    var_shape = None
    if args.pad:
        var_shape = tuple(s + 2 * args.pad for s in shape)
    tol = {}
    if getattr(args, "grtol", None) is not None:
        tol["grtol"] = args.grtol
    if getattr(args, "gatol", None) is not None:
        tol["gatol"] = args.gatol
    return DeconvolutionConfig(
        mu=args.mu, epsilon=args.epsilon, max_iter=args.iters,
        positivity=not args.no_positivity, var_shape=var_shape,
        data_term=getattr(args, "data_term", "gaussian"),
        background=getattr(args, "background", 0.0),
        sparsity=getattr(args, "sparsity", 0.0),
        hessian=getattr(args, "hessian", 0.0),
        sparsity_epsilon=getattr(args, "sparsity_epsilon", None),
        admm_abstol=getattr(args, "admm_abstol", 0.0),
        admm_reltol=getattr(args, "admm_reltol", 0.0),
        **tol,
    )


def _is_h5(path) -> bool:
    import os

    return os.path.splitext(str(path))[1].lower() in (".h5", ".hdf5", ".ims")


def _is_zarr(path) -> bool:
    from microtipi_tpu_torch.io.zarrstack import is_zarr

    return is_zarr(path)


def _is_plate(path) -> bool:
    from microtipi_tpu_torch.io.plate import is_plate

    return is_plate(path)


def _write_out(args, path, volume, dxy=None, dz=None):
    """Write an output volume (``shared.py:506-525``): HDF5/zarr by
    extension, OME-TIFF when --ome is set, plain multi-page TIFF otherwise."""
    volume = _np(volume)
    if _is_h5(path):
        from microtipi_tpu_torch.io.hdf5stack import write_h5

        write_h5(path, volume)
    elif str(path).rstrip("/").lower().endswith(".zarr"):
        from microtipi_tpu_torch.io.zarrstack import write_ngff_hyperstack

        write_ngff_hyperstack(path, volume, dxy=dxy, dz=dz,
                              levels=getattr(args, "zarr_levels", 1))
    elif getattr(args, "ome", False):
        from microtipi_tpu_torch.io.ome import write_ome_stack

        write_ome_stack(path, volume, dxy=dxy, dz=dz)
    else:
        from microtipi_tpu_torch.io.tiffstack import write_stack

        write_stack(path, volume, dxy=dxy, dz=dz)


def _weights(args, data):
    """Inverse-variance weights from --gain/--readout or --auto-gain
    (``shared.py:528-568``).

    ``data`` is a tensor on the device on every path except ``--tile``,
    which keeps the volume host-side: there the weights are built host-side
    too (a NumPy mirror of ``InverseVarianceWeights.from_data``) and
    --auto-gain probes the scalar camera constants on a central crop."""
    auto = getattr(args, "auto_gain", False)
    if not auto and args.gain <= 0:
        return None
    host = isinstance(data, np.ndarray)
    gain, rv = args.gain, args.readout
    if auto:
        from microtipi_tpu_torch.weights.updaters import estimate_gain_readout

        probe = data
        if host:
            crop = tuple(min(n, c) for n, c in zip(data.shape, (64, 512, 512)))
            sl = tuple(slice((n - c) // 2, (n - c) // 2 + c)
                       for n, c in zip(data.shape, crop))
            probe = _tensor(args, data[sl])
        gain, rv = estimate_gain_readout(probe)
        gain, rv = float(gain), float(rv)
        print(f"auto-gain: gain={gain:.4g} e-/ADU, readout variance={rv:.4g} ADU^2"
              + (" (central-crop probe)" if host else ""))
    if host:
        dt = (data.dtype if np.issubdtype(data.dtype, np.floating)
              else np.dtype(np.float32))
        d = np.asarray(data, dt)
        var = np.asarray(rv, dt) + (np.maximum(d, 0.0) / gain if gain > 0 else 0.0)
        w = (1.0 / np.maximum(var, np.finfo(dt).tiny)).astype(dt)
        return w * np.isfinite(d).astype(dt)
    from microtipi_tpu_torch.weights.updaters import InverseVarianceWeights

    return InverseVarianceWeights(gain=gain, readout_variance=rv).from_data(data)


def _load_params_json(model, path):
    """Model params from a ``fitpsf --params-out`` JSON (``shared.py:571-584``;
    unknown keys and metadata fields are ignored; listed families replace the
    defaults), on the model's device at its dtype."""
    import json

    params = model.init_params()
    with open(path) as fh:
        doc = json.load(fh)
    for name in params._fields:
        if name in doc:
            params = params._replace(**{name: torch.as_tensor(doc[name], dtype=model.dtype,
                                                              device=model.device)})
    return params


def _load_pupil_maps(args, model, paths):
    """Load K ``fitpsf --retrieve-map`` npz files and return (phis, rhos,
    defocus) NumPy stacks on the sample model's pupil grid
    (``shared.py:587-626``), resampling each map from its bead-crop frequency
    grid when the geometry differs (``jobs/phase_retrieval.resample_pupil_map``)."""
    from microtipi_tpu_torch.jobs.phase_retrieval import resample_pupil_map

    def resample(m, src_dxy, shape, dst_dxy, mask=None):
        return _np(resample_pupil_map(_tensor(args, m), src_dxy, shape, dst_dxy,
                                      mask=None if mask is None else _tensor(args, mask)))

    ny_d, nx_d = model.shape[1], model.shape[2]
    nominal_defocus = _np(model.init_params().defocus)
    phis, rhos, defoc = [], [], []
    for path in paths:
        with np.load(path) as z:
            if "phi" not in z.files:
                sys.exit(f"{path}: not a fitpsf --retrieve-map npz (no 'phi')")
            phi = np.asarray(z["phi"])
            mask = np.asarray(z["mask"]) if "mask" in z.files else None
            rho = np.asarray(z["rho"]) if "rho" in z.files else None
            src_dxy = float(z["dxy"]) if "dxy" in z.files else args.dxy
            d = np.asarray(z["defocus"]) if "defocus" in z.files \
                else nominal_defocus
        if phi.shape != (ny_d, nx_d) or abs(src_dxy - args.dxy) > 1e-15:
            phi = resample(phi, src_dxy, (ny_d, nx_d), args.dxy, mask=mask)
            if rho is not None:
                rho = resample(rho, src_dxy, (ny_d, nx_d), args.dxy, mask=mask)
        phis.append(np.asarray(phi))
        rhos.append(None if rho is None else np.asarray(rho))
        defoc.append(d)
    have_rho = [r is not None for r in rhos]
    if any(have_rho) and not all(have_rho):
        sys.exit("--depthvar-maps: maps mix --retrieve-modulus and "
                 "phase-only retrievals; re-run fitpsf consistently "
                 "(the nominal flat modulus cannot be spliced per-anchor)")
    return (np.stack(phis),
            np.stack(rhos) if all(have_rho) else None,
            np.stack(defoc))


def _depthvar_anchor_array(args, k, nz, sort=True):
    """K anchor depths from --depthvar-anchors (validated) or evenly spaced
    over the stack (``shared.py:629-644``). Sorted ascending unless the
    caller must keep user order to pair anchors with per-anchor inputs."""
    if getattr(args, "depthvar_anchors", None):
        anchors = np.asarray(args.depthvar_anchors, np.float64)
        if anchors.size != k:
            sys.exit(f"--depthvar-anchors needs {k} depths "
                     f"(one per anchor), got {anchors.size}")
        if np.unique(anchors).size != anchors.size:
            sys.exit("--depthvar-anchors must be distinct depths")
        return np.sort(anchors) if sort else anchors
    return np.linspace(0.0, nz - 1.0, k)


def _plate_fan_out(args, solve_one, label):
    """Shared plate batch path (``shared.py:647-676``): solve every
    well/field, write an output plate mirroring the input layout (and zarr
    format). ``solve_one`` maps one (Nz, Ny, Nx) NumPy volume -> one output
    volume (a tensor or an array)."""
    from microtipi_tpu_torch.io import zarr3
    from microtipi_tpu_torch.io.plate import list_plate_images, read_plate_image, write_plate

    if not str(args.out).rstrip("/").lower().endswith(".zarr"):
        sys.exit("plate outputs are NGFF plates; --out must end in .zarr")
    images = list_plate_images(args.data)
    fmt = 3 if zarr3.is_zarr3_group(args.data) else 2
    t, c = int(args.timepoint or 0), int(args.channel or 0)
    out_wells = {}
    t0 = time.time()
    for well, field in images:
        arr, _meta = read_plate_image(args.data, well, field)
        nt, nc = arr.shape[:2]
        if not (0 <= t < nt and 0 <= c < nc):
            sys.exit(f"--timepoint {t} / --channel {c} out of range "
                     f"(well {well}: T={nt}, C={nc})")
        out = solve_one(np.ascontiguousarray(arr[t, c]))
        out_wells.setdefault(well, []).append(_np(out))
        print(f"{label}: well {well} field {field} done "
              f"({time.time()-t0:.1f}s elapsed)")
    write_plate(args.out, out_wells, dxy=args.dxy, dz=args.dz,
                zarr_format=fmt, levels=getattr(args, "zarr_levels", 1))
    print("wrote", args.out, f"({len(images)} images, zarr v{fmt})")


def _read_hyperstack(args, errprefix):
    """Read a (T, C, Z, Y, X) hyperstack (OME-TIFF or OME-NGFF zarr) or exit
    with a one-line error (``shared.py:679-689``)."""
    try:
        if _is_zarr(args.data):
            from microtipi_tpu_torch.io.zarrstack import read_ngff_hyperstack
            return read_ngff_hyperstack(args.data)
        from microtipi_tpu_torch.io.ome import read_ome_hyperstack
        return read_ome_hyperstack(args.data)
    except Exception as e:
        sys.exit(f"{errprefix} needs a (T, C, Z, Y, X) hyperstack input: {e}")


def _prep_hyperstack(args, arr):
    """Shared preprocessing flags + non-finite fencing for every (Z, Y, X)
    volume of a (T, C, Z, Y, X) hyperstack (``shared.py:692-715``)."""
    arr = np.ascontiguousarray(arr)
    pre = _build_preprocess(args)
    if pre is not None:
        out = np.empty(arr.shape, np.float32)
        for t in range(arr.shape[0]):
            for c in range(arr.shape[1]):
                out[t, c] = pre(arr[t, c])
        arr = out
        print("preprocessed input (ops.preprocess)")
    bad = ~np.isfinite(arr)
    if bad.any():
        print(f"[input] {args.data}: zeroed {int(bad.sum())} non-finite "
              "voxel(s) (dead pixels / corruption; --gain adds statistical "
              "exclusion)")
        arr = np.where(bad, 0.0, arr).astype(arr.dtype)
    return arr


def _write_hyperstack(args, out):
    """Write a (T, C, Z, Y, X) result next to the input's container format
    (``shared.py:718-727``)."""
    out = _np(out)
    if str(args.out).lower().endswith(".zarr"):
        from microtipi_tpu_torch.io.zarrstack import write_ngff_hyperstack
        write_ngff_hyperstack(args.out, out, dxy=args.dxy, dz=args.dz,
                              levels=getattr(args, "zarr_levels", 1))
    else:
        from microtipi_tpu_torch.io.ome import write_ome_hyperstack
        write_ome_hyperstack(args.out, out, dxy=args.dxy, dz=args.dz)
    print("wrote", args.out)


def _make_mesh(args):
    """The (batch, z) mesh of ``--mesh BATCH Z``, None when single-device
    (``shared.py:730-737``). On the card it takes the visible CUDA devices
    and raises unless there are BATCH*Z of them, as the JAX mesh does; a
    command on the CPU (``main(argv, device="cpu")``) gets BATCH*Z entries
    of the CPU, the counterpart of the JAX suite's virtual host devices."""
    if not getattr(args, "mesh", None):
        return None
    from microtipi_tpu_torch.parallel.mesh import make_mesh

    batch, z = args.mesh
    if args.device.type == "cpu":
        return make_mesh(batch=batch, z=z, devices=[args.device] * (batch * z))
    return make_mesh(batch=batch, z=z)
