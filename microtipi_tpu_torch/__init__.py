"""microtipi_tpu_torch — the PyTorch / CUDA port of ``microtipi_tpu``.

The same blind-deconvolution main path as the JAX package — wide-field PSF
synthesis, FFT convolution data terms, hyperbolic-TV regularised object steps
by VMLMB or ADMM, and the alternating blind loop — written in PyTorch, with
the hot sweeps as hand-written CUDA kernels for Hopper: the fused
hyperbolic-TV cost and gradient (``csrc/hyperbolic_tv.cu``) and the ADMM
engine's split update and right-hand side (``csrc/admm_split.cu``). Each
module sits at the same relative path as its JAX counterpart, which stays the
reference it is tested against.

This package imports ``torch`` and NumPy only, never ``jax`` and never
``microtipi_tpu``. Importing it builds nothing: the CUDA kernels are compiled
by ``nvcc`` at first use (``_build.py``).

Entry points: ``jobs.deconv.deconvolve``, ``jobs.admm.admm_deconvolve`` and
``fista_deconvolve``, ``jobs.blind.blind_deconvolve`` with a model of any PSF
family of ``models`` (``models.model_for(config)``),
``jobs.batch.batched_deconvolve``, ``jobs.tiled.tiled_deconvolve``, the
depth-varying ``jobs.depthvar.deconvolve_depthvar`` on Gibson-Lanni anchor
PSFs, and the joint solvers by VMLMB and ADMM: the time series
(``jobs.timeseries.deconvolve_timeseries``,
``jobs.admm.admm_deconvolve_timeseries``), the multichannel and 5D solves
with color TV and spectral unmixing (``jobs.multichannel``,
``admm_deconvolve_multichannel``, ``admm_deconvolve_timeseries_multichannel``)
and the finer-grid solve (``jobs.superres``); the batched and out-of-core
blind loops (``jobs.batch.batched_blind_deconvolve``,
``jobs.tiled_blind.blind_deconvolve_tiled``); PSF estimation from a bead map
or phase diversity (``jobs.phase_retrieval``, ``jobs.diversity``); SIM and ISM
(``jobs.sim``, ``jobs.ism``); and the image ops (``ops.register``,
``ops.metrics``, ``ops.preprocess``, ``ops.geometry``);
``weights.updaters.InverseVarianceWeights`` makes the data weights, ``convert``
carries parameters and configurations between the two packages.

Two API levels, as in the JAX package: the functional one above, whose
top-level names are the counterparts of the JAX package's ``__all__``
(``from microtipi_tpu_torch import WideFieldConfig, blind_deconvolve, ...``;
the port's functions take a PSF model, ``models.widefield.WideFieldModel``
or ``models.model_for(config)``, where JAX's take a config), and the
stateful reference-parity one, ``api.WideFieldModel`` /
``api.PSF_Estimation`` / ``api.DeconvolutionJob`` / ``api.BlindDeconvJob``.
``io`` reads and writes TIFF/OME-TIFF, zarr/OME-NGFF, HDF5 and plates as
NumPy on the host (the TIFF reader is built from ``native/stackio.cpp`` at
first use), ``utils.checkpoint`` saves and loads a blind run's state, and
``utils.profiling`` traces with ``torch.profiler`` (``trace``) and names the
program's ranges in such a trace (``span``).

Left out as TPU-only: ``ops/exactfft.py`` and every ``exact_fft`` /
``auto_exact_fft`` / ``fft_pair`` switch, ``mem_dtype`` /
``resolve_mem_dtype``, ``custom_vmap`` routing and the Pallas
``interpret`` / BlockSpec options (``ROADMAP.md``, "Not ported"). The
command line is ``python -m microtipi_tpu_torch`` (``cli``), the
watch-folder service ``serve.watch``; still to port: ``parallel/*``.
"""

from microtipi_tpu_torch.models.microscope import CAVITY, DEFOCUS, DEPTH, MODULUS, PARAMETER_FLAGS, PHASE, SHEET, STED
from microtipi_tpu_torch.models.widefield import WideFieldConfig, WideFieldParams
from microtipi_tpu_torch.models.gibson_lanni import GibsonLanniConfig, GibsonLanniParams
from microtipi_tpu_torch.models.confocal import ConfocalConfig, TwoPhotonConfig
from microtipi_tpu_torch.models.lightsheet import (
    LightSheetConfig, LightSheetParams, StructuredSheetConfig)
from microtipi_tpu_torch.models.fourpi import FourPiConfig, FourPiParams
from microtipi_tpu_torch.models.ism import ISMConfig, hex_offsets
from microtipi_tpu_torch.models.sted import STEDConfig, STEDParams
from microtipi_tpu_torch.models.vectorial import VectorialConfig
from microtipi_tpu_torch.jobs.admm import (
    admm_deconvolve,
    admm_deconvolve_multichannel,
    admm_deconvolve_timeseries,
    admm_deconvolve_timeseries_multichannel,
    fista_deconvolve,
)
from microtipi_tpu_torch.jobs.autotune import AutoMuResult, deconvolve_auto_mu, estimate_noise_sigma
from microtipi_tpu_torch.jobs.phase_retrieval import (
    PupilRetrievalResult, project_phase, remove_position_gauges, retrieve_pupil)
from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig, BlindDeconvResult, blind_deconvolve
from microtipi_tpu_torch.jobs.sim import (
    SIMReconstruction, estimate_sim_pattern, reconstruct_sim,
    separate_bands, simulate_sim)
from microtipi_tpu_torch.jobs.ism import (
    ism_element_gains, ism_reassign, ism_richardson_lucy)
from microtipi_tpu_torch.jobs.diversity import (
    defocus_diversity, diversity_fit_uncertainty, diversity_object_estimate,
    diversity_psfs, fit_psf_diversity, zernike_diversity)
from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, DeconvolutionResult, deconvolve
from microtipi_tpu_torch.jobs.depthvar import deconvolve_depthvar, depth_anchor_psfs
from microtipi_tpu_torch.jobs.superres import (
    admm_deconvolve_superres, bin_volume, deconvolve_superres,
    upsample_psf, upsample_volume)
from microtipi_tpu_torch.jobs.timeseries import deconvolve_timeseries
from microtipi_tpu_torch.jobs.multichannel import (
    deconvolve_multichannel, deconvolve_timeseries_multichannel,
    mixing_from_controls)
from microtipi_tpu_torch.jobs.psf_fit import (
    FitUncertainty, PsfFitConfig, PsfFitResult, average_beads, bead_anchor_term,
    bead_fit_uncertainty, calibrate_field, center_bead_stack, detect_beads,
    empirical_psf, fit_psf, fit_psf_beads, fit_psf_joint, fit_uncertainty,
)
from microtipi_tpu_torch.jobs.richardson_lucy import (
    multiview_richardson_lucy,
    richardson_lucy,
    wb_backprojector,
)
from microtipi_tpu_torch.jobs.tiled import field_psf, tiled_deconvolve
from microtipi_tpu_torch.jobs.uncertainty import ObjectUncertainty, object_uncertainty
from microtipi_tpu_torch.jobs.wiener import wiener
from microtipi_tpu_torch.ops.geometry import deskew
from microtipi_tpu_torch.ops.preprocess import (
    destripe,
    estimate_bleach,
    flat_field_correct,
    remove_hot_pixels,
    rolling_ball_background,
    subtract_background,
)
from microtipi_tpu_torch.ops.metrics import (
    checkerboard_split,
    fourier_shell_correlation,
    fsc_resolution,
    strehl_ratio,
    strehl_ratio_from_pupil,
)
from microtipi_tpu_torch.ops.convolution import (
    PoissonConvCost,
    WeightedConvolutionCost,
    convolve,
    convolve_spectrum,
)
from microtipi_tpu_torch.ops.register import fourier_shift, register_timeseries, register_translation
from microtipi_tpu_torch.ops.regularization import (
    hyperbolic_hessian, hyperbolic_tv, hyperbolic_tv_and_gradient,
    joint_hyperbolic_tv, smoothed_l1)
from microtipi_tpu_torch.optim.vmlmb import VMLMBResult, VMLMBStatus, minimize_vmlmb
from microtipi_tpu_torch.weights.updaters import InverseVarianceWeights, estimate_gain_readout

__version__ = "0.1.0"

__all__ = [
    "DEFOCUS", "PHASE", "MODULUS", "DEPTH", "SHEET", "STED", "CAVITY", "PARAMETER_FLAGS",
    "WideFieldConfig", "WideFieldParams",
    "GibsonLanniConfig", "GibsonLanniParams",
    "ConfocalConfig", "TwoPhotonConfig", "VectorialConfig", "STEDConfig", "STEDParams",
    "SIMReconstruction", "estimate_sim_pattern", "reconstruct_sim",
    "separate_bands", "simulate_sim",
    "ISMConfig", "hex_offsets", "ism_element_gains", "ism_reassign",
    "ism_richardson_lucy",
    "FourPiConfig", "FourPiParams",
    "LightSheetConfig", "LightSheetParams", "StructuredSheetConfig",
    "BlindDeconvConfig", "BlindDeconvResult", "blind_deconvolve",
    "DeconvolutionConfig", "DeconvolutionResult", "deconvolve",
    "admm_deconvolve", "admm_deconvolve_multichannel",
    "admm_deconvolve_timeseries",
    "admm_deconvolve_timeseries_multichannel", "fista_deconvolve",
    "AutoMuResult", "deconvolve_auto_mu", "estimate_noise_sigma",
    "PupilRetrievalResult", "project_phase", "remove_position_gauges", "retrieve_pupil",
    "defocus_diversity", "diversity_fit_uncertainty",
    "diversity_object_estimate", "diversity_psfs",
    "fit_psf_diversity", "zernike_diversity",
    "deconvolve_depthvar", "depth_anchor_psfs", "deconvolve_timeseries",
    "deconvolve_multichannel", "deconvolve_timeseries_multichannel",
    "mixing_from_controls",
    "admm_deconvolve_superres", "bin_volume", "deconvolve_superres",
    "upsample_psf", "upsample_volume",
    "PsfFitConfig", "PsfFitResult", "average_beads", "bead_anchor_term", "center_bead_stack",
    "empirical_psf", "fit_psf", "fit_psf_beads", "fit_psf_joint",
    "FitUncertainty", "fit_uncertainty", "bead_fit_uncertainty",
    "ObjectUncertainty", "object_uncertainty",
    "calibrate_field", "detect_beads",
    "multiview_richardson_lucy", "richardson_lucy", "wb_backprojector", "field_psf", "tiled_deconvolve", "wiener",
    "PoissonConvCost", "WeightedConvolutionCost", "convolve", "convolve_spectrum",
    "fourier_shift", "register_timeseries", "register_translation",
    "checkerboard_split", "fourier_shell_correlation", "fsc_resolution", "strehl_ratio", "strehl_ratio_from_pupil",
    "destripe",
    "estimate_bleach",
    "flat_field_correct", "remove_hot_pixels", "rolling_ball_background", "subtract_background",
    "deskew",
    "hyperbolic_hessian", "hyperbolic_tv", "hyperbolic_tv_and_gradient",
    "joint_hyperbolic_tv", "smoothed_l1",
    "VMLMBResult", "VMLMBStatus", "minimize_vmlmb",
    "InverseVarianceWeights", "estimate_gain_readout",
    "__version__",
]
