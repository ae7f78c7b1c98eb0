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
"""
