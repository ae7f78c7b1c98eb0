"""microtipi_tpu_torch — the PyTorch / CUDA port of ``microtipi_tpu``.

The same blind-deconvolution main path as the JAX package — wide-field PSF
synthesis, FFT convolution data terms, hyperbolic-TV regularised VMLMB object
steps and the alternating blind loop — written in PyTorch, with the fused
hyperbolic-TV cost-and-gradient sweep as a hand-written CUDA kernel for
Hopper (``csrc/hyperbolic_tv.cu``). Each module sits at the same relative
path as its JAX counterpart, which stays the reference it is tested against.

This package imports ``torch`` and NumPy only, never ``jax`` and never
``microtipi_tpu``. Importing it builds nothing: the CUDA kernel is compiled
by ``nvcc`` at first use (``_build.py``).

Entry points: ``jobs.deconv.deconvolve`` and ``jobs.blind.blind_deconvolve``
with a ``models.widefield.WideFieldModel``.
"""
