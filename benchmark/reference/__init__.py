"""The benchmark's plain reference: what the port computes, written again in
plain PyTorch and NumPy, with no kernel, no cache and no batching trick.

It imports nothing of the port (``microtipi_tpu_torch``) and nothing of the
JAX package, and takes nothing the port has made: every PSF, spectrum and
objective it needs it works out again from the benchmark's own inputs and
from the parameters the port reports. It runs in float64 to judge the port,
and in an emulated bfloat16 as the control that the judgement has to fail
(``precision.py``).

- ``geometry.py``: the Zernike basis, the wrapped FFT grids and the pupil
  support (frozen copies of the port's ``ops/zernike.py``, ``utils/grids.py``
  and ``ops/pupil.py``, which follow TiPi's ``Zernike.java`` and
  ``WideFieldModel.java``).
- ``psf.py``: the scalar wide-field PSF (``WideFieldModel.java:60-78,
  202-255``).
- ``objective.py``: the FFT convolution data term and the hyperbolic TV.
- ``admm.py``: the ADMM object step, for uniform or per-voxel weights.
"""
