"""Port geometry: the copied grids and Zernike modules are bit-equal to the
JAX package's, and the torch array helpers round-trip (odd sizes included)."""

import numpy as np
import pytest
import torch

from microtipi_tpu.ops import zernike as jz
from microtipi_tpu.utils import arrays as ja
from microtipi_tpu.utils import grids as jg
from microtipi_tpu_torch.ops import zernike as tz
from microtipi_tpu_torch.utils import arrays as ta
from microtipi_tpu_torch.utils import grids as tg


@pytest.mark.parametrize("n", [1, 7, 8, 33])
def test_grids_bit_equal(n):
    for name in ("fft_index", "wrapped_z"):
        np.testing.assert_array_equal(getattr(tg, name)(n), getattr(jg, name)(n))
    for name in ("fft_dist", "fft_angle"):
        np.testing.assert_array_equal(getattr(tg, name)(n, n + 1), getattr(jg, name)(n, n + 1))
    for a, b in zip(tg.fft_freq2(n, n, 80e-9), jg.fft_freq2(n, n, 80e-9)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("radial", [False, True])
def test_zernike_bit_equal(radial):
    for j in range(1, 40):
        assert tz.noll_to_nm(j) == jz.noll_to_nm(j)
    a = tz.zernike_basis(10, 32, 32, 9.5, radial=radial)
    np.testing.assert_array_equal(a, jz.zernike_basis(10, 32, 32, 9.5, radial=radial))
    np.testing.assert_array_equal(tz.orthonormalize(a), jz.orthonormalize(a))


@pytest.mark.parametrize("shape", [(5, 7, 9), (4, 6, 8)])
def test_arrays_match_jax_and_round_trip(shape):
    x = np.random.default_rng(0).standard_normal(shape)
    t = torch.tensor(x)
    np.testing.assert_array_equal(ta.roll(t).numpy(), np.asarray(ja.roll(x)))
    np.testing.assert_array_equal(ta.unroll(ta.roll(t)).numpy(), x)
    big = tuple(s + 3 for s in shape)
    padded = ta.pad_to_shape(t, big, value=1.5)
    np.testing.assert_array_equal(padded.numpy(), np.asarray(ja.pad_to_shape(x, big, value=1.5)))
    np.testing.assert_array_equal(ta.crop_to_shape(padded, shape).numpy(), x)
    np.testing.assert_array_equal(ta.pad_fft_kernel(t, big).numpy(), np.asarray(ja.pad_fft_kernel(x, big)))
    with pytest.raises(ValueError):
        ta.crop_to_shape(t, big)
