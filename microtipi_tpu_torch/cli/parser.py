"""The argparse tree and ``main()`` entry point, one ``add_parser`` block
per subcommand.

Port of ``microtipi_tpu/cli/parser.py``: the same subcommands and flags, with
the same defaults, choices and help, minus the TPU-only ``--exact-fft`` /
``--no-exact-fft`` (``cli/shared.py``). :func:`main` takes the device the
command runs on as a keyword: the CUDA card by default, and it raises when
there is none; ``main(argv, device="cpu")`` runs a command on the CPU (no
command-line flag selects it)."""

from __future__ import annotations

import argparse

from microtipi_tpu_torch.api import _device
from microtipi_tpu_torch.cli.basic import cmd_doctor, cmd_info, cmd_psf
from microtipi_tpu_torch.cli.blind import cmd_blind
from microtipi_tpu_torch.cli.deconv import cmd_deconv
from microtipi_tpu_torch.cli.fitpsf import cmd_fitpsf
from microtipi_tpu_torch.cli.shared import (
    _comma_floats,
    _deconv_args,
    _hyperstack_args,
    _model_args,
    _preprocess_args,
)
from microtipi_tpu_torch.cli.tools import (
    cmd_deskew,
    cmd_fsc,
    cmd_fuse,
    cmd_ism,
    cmd_register,
    cmd_sim,
    cmd_simulate,
    cmd_watch,
)

_DESCRIPTION = """Command-line interface: ``python -m microtipi_tpu_torch <command>``.

The reference ships no CLI (SURVEY.md §1: GUI plugins sat above it); a
production framework needs one. The PyTorch port of ``python -m
microtipi_tpu``, with the same commands, over the TIFF, OME-NGFF and HDF5 IO
layer:

  info    print stack geometry
  psf     synthesize a PSF to a TIFF stack (any model family)
  fitpsf  calibrate PSF parameters from a bead stack
  deconv  non-blind deconvolution (known PSF)
  blind   blind deconvolution (PSF parameters estimated)

Every command runs on the CUDA card; volumes are float32.
"""


def build_parser() -> argparse.ArgumentParser:
    """The argparse tree of every subcommand (``parser.py:47-670``)."""
    ap = argparse.ArgumentParser(prog="microtipi_tpu_torch", description=_DESCRIPTION)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("doctor", help="deployment self-check: the card, its "
                                      "kernels' build, a timed solve")
    p.set_defaults(fn=cmd_doctor)

    p = sub.add_parser("info", help="print TIFF stack geometry")
    p.add_argument("stack")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("psf", help="synthesize a widefield PSF stack")
    p.add_argument("out")
    p.add_argument("--shape", type=int, nargs=3, required=True, metavar=("NZ", "NY", "NX"))
    p.add_argument("--phase", type=float, nargs="*", default=[], help="Zernike phase coefficients")
    p.add_argument("--centered", action="store_true", help="write centered layout instead of FFT layout")
    p.add_argument("--ome", action="store_true",
                   help="write outputs as OME-TIFF (OME-XML geometry in the description)")
    p.add_argument("--zarr-levels", type=int, default=1, metavar="L",
                   help="[.zarr outputs] write an L-level 2x mean-downsampled "
                        "NGFF multiscale pyramid (viewers stream from it)")
    _model_args(p)
    p.set_defaults(fn=cmd_psf)

    p = sub.add_parser("fitpsf", help="calibrate PSF parameters from a bead stack")
    p.add_argument("stack", nargs="+",
                   help="bead (point-source) TIFF stack; several (one per "
                        "known depth) with --depth-ladder")
    p.add_argument("--depth-ladder", type=float, nargs="+", default=None,
                   metavar="Z",
                   help="depth-ladder calibration: the K bead stacks were "
                        "acquired at these K KNOWN z positions (data-grid "
                        "voxels, e.g. stage offsets / dz); jointly fits the "
                        "Gibson-Lanni DEPTH family (sample index ns + z=0 "
                        "depth offset) — requires --model gl. Beads at >=2 "
                        "depths pin ns (a single depth cannot; fully-blind "
                        "ns is a measured dead end, BASELINE.md)")
    p.add_argument("--params-json", default=None,
                   help="[--depth-ladder] start from calibrated parameters "
                        "(fitpsf --params-out JSON): the pre-calibrated-pupil "
                        "DEPTH-only ladder is the measured noise-robust "
                        "workflow (TUNING.md)")
    p.add_argument("--out", default=None, help="write the fitted PSF stack here")
    p.add_argument("--params-out", default=None, help="write fitted parameters as JSON")
    p.add_argument("--centered", action="store_true",
                   help="write the fitted PSF in centered layout")
    p.add_argument("--ome", action="store_true",
                   help="write outputs as OME-TIFF (OME-XML geometry in the description)")
    p.add_argument("--zarr-levels", type=int, default=1, metavar="L",
                   help="[.zarr outputs] write an L-level 2x mean-downsampled "
                        "NGFF multiscale pyramid (viewers stream from it)")
    p.add_argument("--iters", type=int, default=60, help="joint-fit VMLMB iterations")
    p.add_argument("--n-beads", type=int, default=1,
                   help="detect and average up to N beads before fitting "
                        "(~sqrt(N) SNR; beads clipping the patch edge are skipped)")
    p.add_argument("--bead-patch", type=int, nargs=3, default=None,
                   metavar=("PZ", "PY", "PX"),
                   help="[--n-beads] averaged patch shape (default: full z, 32x32)")
    p.add_argument("--pin-z4", action="store_true",
                   help="freeze the first phase mode during the fit")
    p.add_argument("--uncertainty", action="store_true",
                   help="report 1-sigma error bars per coefficient "
                        "(Gauss-Newton/Laplace at the fit; adds a 'std' "
                        "object to --params-out)")
    p.add_argument("--field-out", default=None, metavar="JSON",
                   help="field-varying calibration: fit each of --n-beads "
                        "detected beads individually and write position-"
                        "tagged anchors for deconv --field-json")
    p.add_argument("--retrieve-map", default=None, metavar="NPZ",
                   help="nonparametric pupil retrieval on top of the "
                        "parametric fit (GS + gradient, pixelwise phase "
                        "map): writes phi/mask/zernike_projection; --out "
                        "then carries the retrieved-pupil PSF. Needs a "
                        "BRIGHT bead (SNR in the thousands)")
    p.add_argument("--retrieve-modulus", action="store_true",
                   help="[--retrieve-map] also free the pupil modulus map")
    p.add_argument("--empirical-out", default=None, metavar="FILE",
                   help="model-free: distill the bead measurement itself "
                        "into a deconvolution-ready PSF (center + clamp + "
                        "unit-sum; honors --n-beads averaging) and exit — "
                        "no parametric fit")
    p.add_argument("--diversity-dz", type=_comma_floats, default=None,
                   metavar="DZ1,DZ2,..",
                   help="phase-diversity calibration from EXTENDED scenes "
                        "(no bead needed): the K inputs are the SAME unknown "
                        "object acquired at these K KNOWN camera/stage "
                        "defocus offsets (meters, comma-separated; write "
                        "--diversity-dz=-2e-7,2e-7 — the '=' keeps argparse "
                        "from eating the leading minus); the object is "
                        "profiled out in closed form (jobs/diversity). "
                        "Volumetric (Nz>1) fits pin Z4 automatically (the "
                        "axial gauge)")
    p.add_argument("--diversity-astig", type=_comma_floats, default=None,
                   metavar="A1,A2,..",
                   help="like --diversity-dz but with KNOWN astigmatism "
                        "diversity of A radians (Z5) per stack — the "
                        "deformable-mirror / cylindrical-lens variant "
                        "(full basis only, drop --radial)")
    p.add_argument("--diversity-gamma", type=float, default=1e-3,
                   help="[--diversity-*] object-spectrum damping (raise "
                        "with noise; ~1e-8 for noiseless validation)")
    p.add_argument("--object-out", default=None, metavar="FILE",
                   help="[--diversity-*] also write the profiled multi-"
                        "frame Wiener object estimate")
    p.add_argument("--families", nargs="+", default=["defocus", "phase"],
                   choices=["defocus", "phase", "modulus", "depth", "sheet", "sted",
                            "cavity"])
    _preprocess_args(p)
    _model_args(p)
    _hyperstack_args(p)
    p.set_defaults(fn=cmd_fitpsf)

    p = sub.add_parser("deconv", help="non-blind deconvolution")
    p.add_argument("data")
    p.add_argument("--psf", default=None, help="PSF stack (required unless --depthvar)")
    p.add_argument("--psf-centered", action="store_true", help="PSF file is centered; unroll it")
    p.add_argument("--out", required=True)
    p.add_argument("--mu-t", type=float, default=None, metavar="W",
                   help="joint 4D time-series solve over ALL timepoints of a "
                        "hyperstack input, coupled by temporal TV at this "
                        "weight (measured ~11%% better recovery than "
                        "per-frame at heavy noise; step events preserved)")
    p.add_argument("--epsilon-t", type=float, default=None,
                   help="[--mu-t] temporal edge threshold in intensity units "
                        "(default: --epsilon); changes above it count as "
                        "real events, not noise")
    p.add_argument("--register-t", action="store_true",
                   help="[--mu-t] drift-correct the timepoints first "
                        "(cumulative pairwise subvoxel matched-filter "
                        "cross-correlation; uncorrected drift turns the "
                        "temporal prior into motion blur)")
    p.add_argument("--bleach-correct", action="store_true",
                   help="[--mu-t] estimate per-frame photobleaching gains "
                        "from background-corrected frame flux and fold them "
                        "into the forward model (g_t * H x_t) — uncorrected "
                        "fading reads as real change to the temporal prior "
                        "and gets smeared across frames")
    p.add_argument("--all-channels", action="store_true",
                   help="joint multi-channel solve over ALL channels of a "
                        "hyperstack input (at --timepoint; with --mu-t the "
                        "full T x C acquisition in one 5D solve), each "
                        "channel with its own PSF: --psf may hold C "
                        "channels, or per-channel PSFs are synthesized from "
                        "the model flags at each OME channel's emission "
                        "wavelength (chromatic optics)")
    p.add_argument("--coupling", choices=["joint", "separate"],
                   default="joint",
                   help="[--all-channels] channel prior: 'joint' couples "
                        "edge LOCATIONS across channels (color TV — a dim "
                        "channel borrows structure from a bright one; "
                        "intensities stay free), 'separate' keeps "
                        "per-channel TV in one batched solve")
    p.add_argument("--mixing", default=None, metavar="SPEC",
                   help="[--all-channels] joint spectral unmixing: the "
                        "(C_det, K) bleed-through matrix — a JSON/CSV file "
                        "or inline rows 'a,b;c,d' (row c = detected channel "
                        "c's per-dye fractions; columns from dye tables or "
                        "single-stain controls, see mixing_from_controls). "
                        "The solve recovers the K DYE volumes jointly with "
                        "deconvolution; --psf / synthesized PSFs then "
                        "describe the dyes, not the detected channels")
    p.add_argument("--superres", type=int, nargs=3, default=None,
                   metavar=("FZ", "FY", "FX"),
                   help="solve on an FZxFYxFX finer object grid (sub-pixel "
                        "localization; dealiases undersampled cameras). The "
                        "fine PSF is synthesized from the model flags at "
                        "dxy/FX, dz/FZ (use --params-json for calibrated "
                        "optics) or supplied via --psf at the fine grid")
    p.add_argument("--depthvar", type=int, default=0, metavar="K",
                   help="depth-varying solve with K Gibson-Lanni anchor PSFs "
                        "blended along z (requires --model gl; PSF parameters "
                        "from --params-json). With --tile: FULLY space-variant "
                        "solve — per-tile anchor stacks at each tile's "
                        "absolute depth, laterally interpolated from "
                        "--field-json calibrations (K anchors span the TILE z)")
    p.add_argument("--depthvar-maps", nargs="+", default=None, metavar="NPZ",
                   help="depth-varying solve with MEASURED anchors: one "
                        "fitpsf --retrieve-map npz per calibration depth "
                        "(resampled onto the sample pupil grid; anchor PSFs "
                        "synthesized through the scalar pupil, --model "
                        "widefield). Pair with --depthvar-anchors for the "
                        "bead depths")
    p.add_argument("--depthvar-anchors", type=float, nargs="+", default=None,
                   metavar="Z",
                   help="anchor depths as (fractional) z indices of the data "
                        "grid, one per anchor (default: evenly spaced over "
                        "the stack)")
    p.add_argument("--params-json", default=None,
                   help="fitpsf --params-out JSON with the calibrated PSF parameters")
    p.add_argument("--tile", type=int, nargs=3, default=None, metavar=("TZ", "TY", "TX"),
                   help="tiled (out-of-core) solve: stream overlapping tiles of this "
                        "shape through the chip (volumes larger than HBM)")
    p.add_argument("--overlap", type=int, nargs="+", default=16,
                   metavar="O",
                   help="tile halo in voxels (>= PSF half-width; discarded "
                        "on blend): one value for all axes or three (OZ OY "
                        "OX — e.g. '0 24 24' when a single tile spans z)")
    p.add_argument("--tile-batch", type=int, default=8,
                   help="tiles solved per batched dispatch")
    p.add_argument("--field-json", nargs="+", default=None, metavar="JSON",
                   help="[--tile] field-varying PSF from scattered calibrations: "
                        "fitpsf --params-out JSONs, each with an added "
                        "\"position\": [y, x] entry (field voxels); tiles solve "
                        "with the locally interpolated model PSF")
    p.add_argument("--report", default=None,
                   help="write a JSON solve report (cost/grad-norm history, counters)")
    p.add_argument("--uncertainty", type=int, default=0, metavar="K",
                   help="after the solve, estimate the pixelwise Laplace "
                        "posterior std of the restored object with K "
                        "Hutchinson probes (CG over Hessian-vector "
                        "products, ~K*100 extra FFT pairs; voxels pinned "
                        "by positivity read exactly 0) and write it next "
                        "to --out with an _std suffix. Units are data "
                        "units under inverse-variance weights "
                        "(--gain/--auto-gain) or the Poisson term; "
                        "noise-sigma units otherwise")
    p.add_argument("--uncertainty-out", default=None,
                   help="[--uncertainty] path for the std volume "
                        "(default: --out with _std before the extension)")
    p.add_argument("--uncertainty-seed", type=int, default=0,
                   help="[--uncertainty] Rademacher probe RNG seed")
    p.add_argument("--uncertainty-cg-maxiter", type=int, default=100,
                   help="[--uncertainty] CG iteration cap per Hutchinson "
                        "probe solve; raise when the printed CG residual "
                        "is not << 1 (ill-conditioned problems, small mu)")
    p.add_argument("--mesh", type=int, nargs=2, default=None, metavar=("BATCH", "Z"),
                   help="run sharded on a (batch, z) device mesh (needs BATCH*Z devices)")
    p.add_argument("--ome", action="store_true",
                   help="write outputs as OME-TIFF (OME-XML geometry in the description)")
    p.add_argument("--zarr-levels", type=int, default=1, metavar="L",
                   help="[.zarr outputs] write an L-level 2x mean-downsampled "
                        "NGFF multiscale pyramid (viewers stream from it)")
    _preprocess_args(p)
    _model_args(p)  # used by --depthvar (anchor PSF synthesis); inert otherwise
    _deconv_args(p, methods=("vmlmb", "rl", "admm", "fista"))
    _hyperstack_args(p)
    p.set_defaults(fn=cmd_deconv)

    p = sub.add_parser("blind", help="blind deconvolution")
    p.add_argument("data")
    p.add_argument("--out", required=True)
    p.add_argument("--psf-out", default=None)
    p.add_argument("--params-out", default=None,
                   help="write the fitted PSF parameters as JSON (feeds "
                        "deconv --params-json, e.g. for a depth-varying re-solve)")
    p.add_argument("--report", default=None,
                   help="write a JSON solve report (per-round costs, fitted parameters)")
    p.add_argument("--uncertainty", type=int, default=0, metavar="K",
                   help="after the final round, estimate the pixelwise "
                        "Laplace posterior std of the restored object at "
                        "the FITTED PSF (K Hutchinson probes + CG; see "
                        "deconv --uncertainty) and write it next to --out "
                        "with an _std suffix. Local curvature only: PSF-"
                        "basin ambiguity of blind solves is NOT included "
                        "(fitpsf --uncertainty covers the parameter side)")
    p.add_argument("--uncertainty-out", default=None,
                   help="[--uncertainty] path for the std volume "
                        "(default: --out with _std before the extension)")
    p.add_argument("--uncertainty-seed", type=int, default=0,
                   help="[--uncertainty] Rademacher probe RNG seed")
    p.add_argument("--uncertainty-cg-maxiter", type=int, default=100,
                   help="[--uncertainty] CG iteration cap per Hutchinson "
                        "probe solve; raise when the printed CG residual "
                        "is not << 1 (ill-conditioned problems, small mu)")
    p.add_argument("--params-json", default=None,
                   help="start from calibrated PSF parameters (fitpsf/blind "
                        "--params-out JSON) instead of the unaberrated pupil — "
                        "the bead-calibration-anchored blind workflow")
    p.add_argument("--phase-prior", type=float, default=0.0,
                   help="calibration-prior weight on the phase fit (use with "
                        "--params-json; ~1e-2 measured best — BASELINE.md: "
                        "improves on both free refitting and trusting the "
                        "calibration)")
    p.add_argument("--bead", default=None, metavar="STACK",
                   help="bead (point-source) stack on the same optics: the "
                        "structural calibration anchor — the bead measurement "
                        "joins every PSF fit as an auxiliary data term "
                        "(measured: pins phase at the truth where free and "
                        "prior-anchored fits drift, BASELINE.md)")
    p.add_argument("--bead-weight", type=float, default=1.0,
                   help="bead-term weight in natural intensity units (1.0 = "
                        "joint MLE at equal noise; sigma_sample^2/sigma_bead^2 "
                        "otherwise)")
    p.add_argument("--bead-n", type=int, default=1,
                   help="[--bead] average up to N detected beads into the "
                        "anchor patch first (~sqrt(N) SNR)")
    p.add_argument("--all-channels", action="store_true",
                   help="blind-solve EVERY channel of an OME hyperstack, each "
                        "with its own emission wavelength; writes one "
                        "multi-channel OME-TIFF")
    p.add_argument("--ome", action="store_true",
                   help="write outputs as OME-TIFF (OME-XML geometry in the description)")
    p.add_argument("--zarr-levels", type=int, default=1, metavar="L",
                   help="[.zarr outputs] write an L-level 2x mean-downsampled "
                        "NGFF multiscale pyramid (viewers stream from it)")
    p.add_argument("--loops", type=int, default=5)
    p.add_argument("--psf-iters", type=int, default=20)
    p.add_argument("--phase-schedule", type=int, nargs="*", default=None,
                   help="active phase modes per round (graduated optimization)")
    p.add_argument("--mu-schedule", type=float, nargs="*", default=None,
                   help="per-round TV weight (object-prior annealing: strong early, relax late)")
    p.add_argument("--pin-z4", action="store_true",
                   help="freeze the first phase mode (Z4, gauge-degenerate with object z-shift)")
    p.add_argument("--joint-fit", action="store_true",
                   help="fit all families jointly per round (one VMLMB run)")
    p.add_argument("--deconv-engine", choices=["vmlmb", "admm"], default="vmlmb",
                   help="object-step engine inside the loop: vmlmb (reference "
                        "semantics) or admm (closed-form circulant x-update; "
                        "measured +88%% blind throughput at 256^3 — runs "
                        "--iters fixed iterations per round, plain TV "
                        "objective only). Pair admm with --recipe quality / "
                        "--mu-schedule: under a weak constant mu its exactly-"
                        "converged object steps absorb the aberration and "
                        "the PSF fits blow up (BASELINE.md)")
    p.add_argument("--wiener-init", action="store_true",
                   help="round-1 object warm start from the regularized inverse")
    p.add_argument("--mesh", type=int, nargs=2, default=None, metavar=("BATCH", "Z"),
                   help="run on a (batch, z) device mesh (sharded loop; needs "
                        "BATCH*Z devices; odd Nz/Ny auto-pad)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint path: run host-driven rounds, saving state after each")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists")
    p.add_argument("--recipe", choices=["parity", "quality"], default="parity",
                   help="'quality' switches on the measured-best recipe in one flag "
                        "(joint fit + pin-Z4 + wiener init); 'parity' (default) keeps "
                        "the reference's sequential per-family semantics")
    p.add_argument("--depthvar", type=int, default=0, metavar="K",
                   help="blind solve under the DEPTH-VARYING forward model: "
                        "K Gibson-Lanni anchor PSFs blended along z, "
                        "re-synthesized from the fitted parameters every "
                        "round (requires --model gl; start from a "
                        "fitpsf --depth-ladder calibration via --params-json "
                        "— fully-blind ns is a measured dead end, BASELINE.md)")
    p.add_argument("--depthvar-anchors", type=float, nargs="+", default=None,
                   metavar="Z",
                   help="[--depthvar] anchor depths as (fractional) z indices "
                        "of the data grid (default: evenly spaced)")
    p.add_argument("--families", nargs="+", default=["defocus", "phase"],
                   choices=["defocus", "phase", "modulus", "depth", "sheet", "sted",
                            "cavity"])
    p.add_argument("--tile", type=int, nargs=3, default=None,
                   metavar=("TZ", "TY", "TX"),
                   help="out-of-core BLIND loop (beyond-HBM volumes): tiled "
                        "object steps + ONE tile-streamed PSF-fit statistics "
                        "pass per round (exact for the support-limited PSF; "
                        "jobs/tiled_blind.py). Uniform weights only; the PSF "
                        "support is --psf-support")
    p.add_argument("--psf-support", type=int, nargs=3, default=None,
                   metavar=("SZ", "SY", "SX"),
                   help="[--tile] PSF support grid (the model synthesizes at "
                        "this shape; needs 2*support <= volume per axis and "
                        "SY == SX; default: min(volume//2, (32, 64, 64)) "
                        "rounded even)")
    p.add_argument("--overlap", type=int, nargs="+", default=[16],
                   metavar="O",
                   help="[--tile] tile halo in voxels (>= PSF half-width): "
                        "one value or three (OZ OY OX)")
    p.add_argument("--tile-batch", type=int, default=4,
                   help="[--tile] tiles solved per batched dispatch")
    _preprocess_args(p)
    _model_args(p)
    _deconv_args(p)
    _hyperstack_args(p)
    p.set_defaults(fn=cmd_blind)

    p = sub.add_parser("simulate", help="synthesize a phantom acquisition (blur + camera noise)")
    p.add_argument("out", help="output acquisition stack")
    p.add_argument("--shape", type=int, nargs=3, required=True, metavar=("NZ", "NY", "NX"))
    p.add_argument("--phantom", choices=["beads", "filaments", "shells"],
                   default="beads")
    p.add_argument("--n", type=int, default=20, help="number of structures")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--phase", type=float, nargs="*", default=None,
                   help="inject Zernike phase aberration coefficients")
    p.add_argument("--params-json", default=None,
                   help="synthesize through a fitpsf calibration instead")
    p.add_argument("--photons", type=float, default=1e4,
                   help="expected photons at the brightest voxel")
    p.add_argument("--gain-sim", type=float, default=2.0, help="camera gain e-/ADU")
    p.add_argument("--readout-sim", type=float, default=1.5, help="readout sigma [ADU]")
    p.add_argument("--offset", type=float, default=100.0, help="camera offset [ADU]")
    p.add_argument("--truth", default=None, help="also write the ground-truth object")
    p.add_argument("--psf-out", default=None, help="also write the blurring PSF")
    p.add_argument("--depthvar", type=int, default=0, metavar="K",
                   help="blur with the DEPTH-VARYING operator (K Gibson-"
                        "Lanni anchors; --model gl) — phantoms for testing "
                        "deconv/blind --depthvar workflows")
    p.add_argument("--depthvar-anchors", type=float, nargs="+", default=None,
                   metavar="Z", help="[--depthvar] anchor z indices")
    p.add_argument("--ome", action="store_true",
                   help="write outputs as OME-TIFF (OME-XML geometry in the description)")
    p.add_argument("--zarr-levels", type=int, default=1, metavar="L",
                   help="[.zarr outputs] L-level NGFF multiscale pyramid")
    _model_args(p)
    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser("register", help="subvoxel volume / channel registration")
    p.add_argument("ref", help="reference volume (or hyperstack with --align-channels)")
    p.add_argument("mov", nargs="?", default=None, help="moving volume to align to ref")
    p.add_argument("--out", required=True)
    p.add_argument("--align-channels", action="store_true",
                   help="chromatic-shift mode: register every channel of the "
                        "input hyperstack to --to-channel, write the full stack")
    p.add_argument("--to-channel", type=int, default=0,
                   help="[--align-channels] reference channel (default 0)")
    p.add_argument("--psf-ref", default=None,
                   help="reference PSF for blur-matched registration of "
                        "differently-blurred volumes")
    p.add_argument("--psf-mov", default=None, help="moving volume's PSF")
    p.add_argument("--dxy", type=float, default=None)
    p.add_argument("--dz", type=float, default=None)
    p.add_argument("--ome", action="store_true",
                   help="write outputs as OME-TIFF (OME-XML geometry in the description)")
    p.add_argument("--zarr-levels", type=int, default=1, metavar="L",
                   help="[.zarr outputs] L-level NGFF multiscale pyramid")
    _hyperstack_args(p)
    _preprocess_args(p)
    p.set_defaults(fn=cmd_register)

    p = sub.add_parser("deskew", help="deskew a stage-scanned light-sheet stack")
    p.add_argument("stack", help="raw (sheared) stage-scan stack")
    p.add_argument("--out", required=True)
    p.add_argument("--angle", type=float, required=True,
                   help="detection-axis-to-scan angle in degrees "
                        "(31.8 lattice, 45 diSPIM)")
    p.add_argument("--invert", action="store_true",
                   help="flip the shear direction (reverse stage scan)")
    p.add_argument("--dxy", type=float, default=None,
                   help="lateral pixel size [m] (default: input metadata)")
    p.add_argument("--dz", type=float, default=None,
                   help="stage step between frames [m] (default: input metadata)")
    p.add_argument("--ome", action="store_true",
                   help="write outputs as OME-TIFF (OME-XML geometry in the description)")
    p.add_argument("--zarr-levels", type=int, default=1, metavar="L",
                   help="[.zarr outputs] L-level NGFF multiscale pyramid")
    _hyperstack_args(p)
    _preprocess_args(p)
    p.set_defaults(fn=cmd_deskew)

    p = sub.add_parser("fsc", help="Fourier Shell Correlation resolution of two volumes")
    p.add_argument("a", help="first volume (e.g. odd-frame or first acquisition)")
    p.add_argument("b", nargs="?", default=None,
                   help="second, independently-noised volume of the same scene")
    p.add_argument("--split", action="store_true",
                   help="single-volume mode: checkerboard-decimate one "
                        "acquisition into two quasi-independent halves "
                        "(Koho 2019 single-image FRC; lateral resolution "
                        "bounded at the decimated Nyquist)")
    p.add_argument("--threshold", type=float, default=0.143,
                   help="FSC crossing threshold (0.143 for independent noise)")
    p.add_argument("--register", action="store_true",
                   help="subvoxel phase-correlation alignment of b to a first")
    p.add_argument("--report", default=None, metavar="JSON",
                   help="write the full FSC curve + resolution as JSON")
    p.add_argument("--dxy", type=float, default=None,
                   help="lateral pixel size [m] (default: input metadata)")
    p.add_argument("--dz", type=float, default=None,
                   help="axial step [m] (default: input metadata)")
    _hyperstack_args(p)
    p.set_defaults(fn=cmd_fsc)

    p = sub.add_parser("fuse", help="multi-view RL fusion (light-sheet: K registered views, K PSFs)")
    p.add_argument("views", nargs="+", help="registered view stacks (same grid)")
    p.add_argument("--psf", nargs="+", required=True, help="one corner-origin PSF per view")
    p.add_argument("--psf-centered", action="store_true", help="PSF files are centered; unroll them")
    p.add_argument("--out", required=True)
    p.add_argument("--iters", type=int, default=50, help="RL iterations")
    p.add_argument("--background", type=float, default=0.0)
    p.add_argument("--rl-backprojector", choices=["matched", "wb"],
                   default="matched",
                   help="wb = Wiener-Butterworth backprojector (Guo 2020; "
                        "~10x fewer iterations)")
    p.add_argument("--register", action="store_true",
                   help="register views 1..K-1 to view 0 first (blur-matched "
                        "subvoxel phase correlation + Fourier shift)")
    p.add_argument("--ome", action="store_true",
                   help="write output as OME-TIFF")
    p.set_defaults(fn=cmd_fuse)

    p = sub.add_parser(
        "ism", help="ISM/Airyscan: reconstruct detector-array confocal data")
    p.add_argument("data", nargs="+",
                   help="element images: ONE element-major interleaved stack "
                        "(K*Nz planes, element 0's z stack first) or K "
                        "stacks, center-out hex order (ISMConfig.offsets())")
    p.add_argument("--out", required=True)
    p.add_argument("--pitch", type=float, required=True,
                   help="element spacing projected to object space [m] "
                        "(physical pitch / total magnification)")
    p.add_argument("--rings", type=int, default=2,
                   help="hex rings around the center element "
                        "(K = 1 + 3r(r+1): 7/19/37 for 1/2/3)")
    p.add_argument("--element-radius", type=float, default=0.0,
                   help="element aperture radius in object space [m] "
                        "(0 = point elements)")
    p.add_argument("--reassign-factor", type=float, default=0.5,
                   help="pixel-reassignment scale s (0.5 = matched widths; "
                        "slightly less with a large Stokes shift)")
    p.add_argument("--method", choices=["reassign", "rl"], default="reassign",
                   help="reassign = classical pixel reassignment (then "
                        "deconvolve with --psf-out); rl = joint Poisson MLE "
                        "over the raw element images (exact per-element "
                        "physics)")
    p.add_argument("--iters", type=int, default=50, help="[rl] iterations")
    p.add_argument("--background", type=float, default=0.0)
    p.add_argument("--rl-backprojector", choices=["matched", "wb"],
                   default="matched")
    p.add_argument("--params-json", default=None,
                   help="calibrated pupil parameters (fitpsf --params-out)")
    p.add_argument("--auto-gains", action="store_true",
                   help="self-calibrate relative element gains from the "
                        "data's per-element totals vs the model's light "
                        "shares (every element sees the same object) and "
                        "correct both methods")
    p.add_argument("--psf-out", default=None,
                   help="also write the reassigned-sum ISM PSF")
    p.add_argument("--centered", action="store_true",
                   help="[--psf-out] write the PSF in centered layout")
    p.add_argument("--ome", action="store_true", help="write OME-TIFF")
    _preprocess_args(p)
    _model_args(p)
    _hyperstack_args(p)
    p.set_defaults(fn=cmd_ism)

    p = sub.add_parser(
        "sim", help="structured-illumination (SIM) reconstruction, 2x lateral")
    p.add_argument("data",
                   help="raw SIM images: angles*phases 2D planes, "
                        "angle-major order")
    p.add_argument("--out", required=True)
    p.add_argument("--angles", type=int, default=3)
    p.add_argument("--phase-count", type=int, default=3,
                   help="pattern phase steps per angle (>= 3)")
    p.add_argument("--pattern-period", type=float, required=True,
                   help="illumination pattern period in meters "
                        "(object space)")
    p.add_argument("--pattern-angle-deg", type=_comma_floats,
                   default=[0.0, 60.0, 120.0], metavar="A1,A2,..",
                   help="pattern orientations in degrees, one per angle")
    p.add_argument("--pattern-phase0", type=_comma_floats, default=None,
                   metavar="P1,P2,..",
                   help="per-angle phase offsets in radians (default 0; "
                        "the steps are 2pi/phase-count; --refine "
                        "self-calibrates offsets AND frequencies)")
    p.add_argument("--refine", action="store_true",
                   help="data-driven pattern self-calibration (phase-"
                        "coherence maximization; measured 0.004-bin / "
                        "0.012-rad on test scenes — BASELINE.md)")
    p.add_argument("--modulation", type=float, default=1.0,
                   help="pattern modulation depth m")
    p.add_argument("--wiener", type=float, default=1e-2,
                   help="generalized-Wiener damping (raise with noise)")
    p.add_argument("--psf", default=None,
                   help="2D PSF image (default: the pupil model at the "
                        "camera grid from the model flags); with "
                        "--axial-period: 3D PSF stack / 3D pupil model")
    p.add_argument("--psf-centered", action="store_true")
    p.add_argument("--axial-period", type=float, default=None, metavar="M",
                   help="3D-SIM (3-beam): axial pattern period in meters; "
                        "input becomes angles*phases VOLUMES of --nz planes "
                        "each (angle-major, phase-minor, z-innermost), "
                        "phase-count >= 5; adds 2x axial resolution and "
                        "fills the missing cone")
    p.add_argument("--axial-phase", type=float, default=0.0, metavar="RAD",
                   help="[3D-SIM] axial pattern phase at the focal plane")
    p.add_argument("--m1", type=float, default=1.0,
                   help="[3D-SIM] modulation depth of the +-1 (axial) orders")
    p.add_argument("--m2", type=float, default=1.0,
                   help="[3D-SIM] modulation depth of the +-2 orders")
    p.add_argument("--no-axial-upsample", action="store_true",
                   help="[3D-SIM] keep the axial grid (saves memory when "
                        "kz_max + q fits under the axial Nyquist)")
    p.add_argument("--ome", action="store_true", help="write OME-TIFF")
    _preprocess_args(p)
    _model_args(p)
    _hyperstack_args(p)
    p.set_defaults(fn=cmd_sim)

    p = sub.add_parser("watch", help="serve: watch a directory, deconvolve arriving stacks")
    p.add_argument("indir")
    p.add_argument("outdir")
    p.add_argument("--psf", default=None,
                   help="PSF stack (required for vmlmb/rl; blind methods fit it)")
    p.add_argument("--poll", type=float, default=2.0)
    p.add_argument("--max-files", type=int, default=None, help="stop after N files (default: run forever)")
    p.add_argument("--metrics", default=None,
                   help="path of an atomically-updated JSON metrics snapshot")
    p.add_argument("--devices", type=int, default=0,
                   help="serving scale-out: dispatch files round-robin over "
                        "the first N CUDA devices (0 = single-device loop)")
    p.add_argument("--bead", default=None, metavar="STACK",
                   help="[blind-once] calibrate the pupil at startup from this "
                        "bead stack instead of blind-solving the first file")
    p.add_argument("--bead-n", type=int, default=1,
                   help="[--bead] average up to N detected beads first")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="serve the metrics snapshot at http://127.0.0.1:PORT/metrics")
    p.add_argument("--priority", action="append", default=None, metavar="GLOB",
                   help="process files matching this fnmatch pattern first "
                        "(repeatable; earlier flags outrank later ones)")
    p.add_argument("--zarr-levels", type=int, default=1, metavar="L",
                   help="[.zarr outputs] L-level NGFF multiscale pyramid")
    p.add_argument("--loops", type=int, default=5, help="[blind methods] blind rounds")
    p.add_argument("--psf-iters", type=int, default=20, help="[blind methods] fit iterations per family")
    p.add_argument("--families", nargs="+", default=["defocus", "phase"],
                   choices=["defocus", "phase", "modulus", "depth", "sheet", "sted",
                            "cavity"])
    p.add_argument("--recipe", choices=["parity", "quality"], default="quality",
                   help="[blind methods] quality = recommended() recipe (default for serving)")
    p.add_argument("--depthvar", type=int, default=0, metavar="K",
                   help="serve with the DEPTH-VARYING solver: K Gibson-Lanni "
                        "anchor PSFs synthesized at each file's shape from "
                        "--model gl + --params-json (a fitpsf --depth-ladder "
                        "calibration) — thick index-mismatched samples")
    p.add_argument("--params-json", default=None,
                   help="[--depthvar] calibrated PSF parameters "
                        "(fitpsf --params-out / --depth-ladder JSON)")
    _preprocess_args(p)
    _model_args(p)
    _deconv_args(p, methods=("vmlmb", "rl", "admm", "blind", "blind-once"))
    _hyperstack_args(p)
    p.set_defaults(fn=cmd_watch)

    return ap


def main(argv=None, *, device=None):
    """Parse ``argv`` (the command line when None) and run the subcommand on
    ``device`` (``parser.py:47-674``): the CUDA card when None, and an error
    when there is none."""
    args = build_parser().parse_args(argv)
    args.device = _device(device, "microtipi_tpu_torch.cli.main")
    args.fn(args)
