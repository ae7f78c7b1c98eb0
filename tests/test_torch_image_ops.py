"""The port's image ops (``ops/register.py``, ``ops/metrics.py``,
``ops/preprocess.py``, ``ops/geometry.py``) against the JAX package on the CPU
(float64), each at 1e-10 relative (deterministic; measured 1e-15): the same
seeded NumPy inputs through both. The FSC's shell sums are ``index_add_``
here; on the card their float atomics add in no fixed order, which the CPU
comparison does not see. Volumes of at most (8, 24, 24)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.models.confocal import ConfocalConfig as JaxConfocalConfig
from microtipi_tpu.models.widefield import WideFieldConfig as JaxWideFieldConfig
from microtipi_tpu.ops import geometry as jax_geometry
from microtipi_tpu.ops import metrics as jax_metrics
from microtipi_tpu.ops import preprocess as jax_pre
from microtipi_tpu.ops import register as jax_register
from microtipi_tpu_torch import convert
from microtipi_tpu_torch.models import model_for
from microtipi_tpu_torch.ops import geometry, metrics, preprocess, register
from microtipi_tpu_torch.utils.arrays import median

RTOL = 1e-10
VOL = (8, 24, 24)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-300))


def _blob_volume(seed=0):
    """A smooth random volume plus a weak broadband floor: phase correlation
    sets every cross-power bin to unit modulus, so a bin that holds only
    round-off would vote with a random phase in either package."""
    rng = np.random.default_rng(seed)
    f = np.fft.rfftn(rng.uniform(0.0, 1.0, VOL))
    fz, fy, fx = np.meshgrid(np.fft.fftfreq(VOL[0]), np.fft.fftfreq(VOL[1]), np.fft.rfftfreq(VOL[2]), indexing="ij")
    smooth = np.fft.irfftn(f * ((fz ** 2 + fy ** 2 + fx ** 2) < 0.3 ** 2), s=VOL, axes=(0, 1, 2))
    return smooth + 0.05 * rng.uniform(0.0, 1.0, VOL)


A = _blob_volume()
SHIFT = (0.3, -1.7, 2.2)
B = np.asarray(jax_register.fourier_shift(jnp.asarray(A), SHIFT)) + 0.01 * np.random.default_rng(1).standard_normal(VOL)


@pytest.mark.parametrize("method", ["phase", "xcorr"])
@pytest.mark.parametrize("subvoxel", [True, False])
def test_register_translation_matches_jax(method, subvoxel):
    want = jax_register.register_translation(jnp.asarray(A), jnp.asarray(B), subvoxel, method)
    _close(register.register_translation(torch.tensor(A), torch.tensor(B), subvoxel, method), want)


def test_fourier_shift_matches_jax():
    _close(register.fourier_shift(torch.tensor(A), SHIFT), jax_register.fourier_shift(jnp.asarray(A), SHIFT))
    plane = A[0]
    _close(register.fourier_shift(torch.tensor(plane), (0.5, -0.25)),
           jax_register.fourier_shift(jnp.asarray(plane), (0.5, -0.25)))


def test_register_timeseries_matches_jax():
    series = np.stack([np.asarray(jax_register.fourier_shift(jnp.asarray(A), (0.1 * t, -0.4 * t, 0.3 * t)))
                       for t in range(4)])
    want_reg, want_shifts = jax_register.register_timeseries(jnp.asarray(series))
    got_reg, got_shifts = register.register_timeseries(torch.tensor(series))
    _close(got_shifts, want_shifts)
    _close(got_reg, want_reg)


def test_checkerboard_split_matches_jax():
    vol = np.random.default_rng(2).uniform(size=(4, 17, 19))
    for got, want in zip(metrics.checkerboard_split(torch.tensor(vol)),
                         jax_metrics.checkerboard_split(jnp.asarray(vol))):
        _close(got, want)


@pytest.mark.parametrize("spacing,n_shells", [(None, None), ((2e-7, 1e-7, 1e-7), 6)], ids=["index", "physical"])
def test_fsc_and_resolution_match_jax(spacing, n_shells):
    f_w, c_w = jax_metrics.fourier_shell_correlation(jnp.asarray(A), jnp.asarray(B), spacing, n_shells)
    f_g, c_g = metrics.fourier_shell_correlation(torch.tensor(A), torch.tensor(B), spacing, n_shells)
    _close(f_g, f_w)
    _close(c_g, c_w)
    for threshold in (0.143, 0.9, 0.999):
        np.testing.assert_allclose(metrics.fsc_resolution(f_g, c_g, threshold),
                                   jax_metrics.fsc_resolution(f_w, c_w, threshold), rtol=RTOL)


def _widefield():
    return JaxWideFieldConfig(shape=(6, 24, 24), na=1.2, wavelength=500e-9, ni=1.33, dxy=100e-9, dz=200e-9,
                              n_phase=4, radial=True, dtype=jnp.float64)


def _confocal():
    return JaxConfocalConfig(shape=(6, 24, 24), na=1.2, wavelength=520e-9, wavelength_exc=488e-9, ni=1.33,
                             dxy=60e-9, dz=200e-9, n_phase=4, radial=True, dtype=jnp.float64, pinhole=0.0)


@pytest.mark.parametrize("family", [_widefield, _confocal], ids=["widefield", "confocal"])
def test_strehl_ratio_matches_jax(family):
    cfg = family()
    p = cfg.init_params()._replace(phase=jnp.asarray([0.3, -0.2, 0.1, 0.05]))
    want = float(jax_metrics.strehl_ratio(cfg, p))
    got = float(metrics.strehl_ratio(model_for(convert.family_config_from_fields(cfg), device="cpu"),
                                     convert.params_to_torch(p)))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert 0.0 < got < 1.0


def test_strehl_ratio_from_pupil_matches_jax():
    cfg = _widefield()
    _, phi, _, mask = cfg.compute_pupil(cfg.init_params()._replace(phase=jnp.asarray([0.2, 0.1, 0.0, -0.1])))
    phi = np.asarray(phi) + 0.3 * np.asarray(mask) * np.random.default_rng(3).standard_normal(np.shape(phi))
    want = float(jax_metrics.strehl_ratio_from_pupil(cfg, jnp.asarray(phi)))
    got = float(metrics.strehl_ratio_from_pupil(model_for(convert.family_config_from_fields(cfg), device="cpu"),
                                                torch.tensor(phi)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


STACK = np.random.default_rng(4).uniform(size=(3, 8, 20, 22)) + np.linspace(0.0, 1.0, 22)


@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("kw", [dict(), dict(sigma=1.0, protect=2.0, strength=0.7)], ids=["default", "custom"])
def test_destripe_matches_jax(axis, kw):
    _close(preprocess.destripe(torch.tensor(STACK), axis, **kw), jax_pre.destripe(jnp.asarray(STACK), axis, **kw))


def test_destripe_computes_integer_frames_in_float32():
    frames = (STACK[0] * 1000).astype(np.int32)
    got = preprocess.destripe(torch.tensor(frames))
    assert got.dtype == torch.float32
    _close(got, jax_pre.destripe(jnp.asarray(frames.astype(np.uint16))), 1e-6)


def test_estimate_bleach_matches_jax():
    rng = np.random.default_rng(5)
    series = np.stack([rng.poisson(5.0, (8, 20, 20)).astype(np.float64) for _ in range(4)])
    series[:, 2:5, 3:8, 4:9] += np.array([50.0, 40.0, 32.0, 25.0])[:, None, None, None]
    _close(preprocess.estimate_bleach(torch.tensor(series)), jax_pre.estimate_bleach(jnp.asarray(series)))


@pytest.mark.parametrize("dark", [False, True])
def test_flat_field_correct_matches_jax(dark):
    rng = np.random.default_rng(6)
    bright = rng.uniform(0.5, 1.5, (20, 22))
    bright[0, 0] = 0.0  # a dead flat-field pixel clamps at eps_rel * mean
    dk = rng.uniform(0.0, 0.1, (20, 22)) if dark else None
    _close(preprocess.flat_field_correct(torch.tensor(STACK[0]), bright, dk),
           jax_pre.flat_field_correct(jnp.asarray(STACK[0]), bright, dk))


@pytest.mark.parametrize("ndim", [2, 3])
def test_remove_hot_pixels_matches_jax(ndim):
    vol = STACK[0].copy()
    vol[2, 5, 5], vol[3, 0, 0], vol[0, 19, 21] = 50.0, 40.0, 30.0  # one inside, two at the edges
    vol = vol if ndim == 3 else vol[2]
    got = preprocess.remove_hot_pixels(torch.tensor(vol))
    _close(got, jax_pre.remove_hot_pixels(jnp.asarray(vol)))
    assert float(got.max()) < 10.0


@pytest.mark.parametrize("radius", [1, 3, 6])
def test_rolling_ball_and_subtraction_match_jax(radius):
    _close(preprocess.rolling_ball_background(torch.tensor(STACK[1]), radius),
           jax_pre.rolling_ball_background(jnp.asarray(STACK[1]), radius))
    _close(preprocess.subtract_background(torch.tensor(STACK[1][0]), radius),
           jax_pre.subtract_background(jnp.asarray(STACK[1][0]), radius))


@pytest.mark.parametrize("angle,invert", [(31.8, False), (45.0, True), (120.0, False)])
def test_deskew_matches_jax(angle, invert):
    assert geometry.deskew_geometry(STACK[0].shape, angle, 2e-7, 1e-7) == \
        jax_geometry.deskew_geometry(STACK[0].shape, angle, 2e-7, 1e-7)
    want, dz_w = jax_geometry.deskew(jnp.asarray(STACK[0]), angle, 2e-7, 1e-7, invert)
    got, dz_g = geometry.deskew(torch.tensor(STACK[0]), angle, 2e-7, 1e-7, invert)
    assert dz_g == dz_w
    _close(got, want)


@pytest.mark.parametrize("dim", [None, 0, 1, -1])
def test_median_along_an_axis_is_jnp_median(dim):
    """Even counts take the mean of the two middle values, as ``jnp.median``."""
    x = np.random.default_rng(7).standard_normal((4, 6, 5))
    _close(median(torch.tensor(x), dim), jnp.median(jnp.asarray(x), axis=dim))
    _close(median(torch.tensor(x), dim, keepdim=dim is not None),
           jnp.median(jnp.asarray(x), axis=dim, keepdims=dim is not None))


@pytest.mark.parametrize("dim", [None, 0, 1, -1])
def test_median_of_a_slice_with_nan_is_nan(dim):
    """A slice that holds a NaN has the median NaN, as ``jnp.median``: the
    sort puts NaN last, so its middle alone would skip it."""
    x = np.random.default_rng(8).standard_normal((4, 6, 5))
    x[1, 2, 3] = x[3, 0, 0] = np.nan
    for keepdim in (False, dim is not None):
        got = median(torch.tensor(x), dim, keepdim=keepdim).numpy()
        want = np.asarray(jnp.median(jnp.asarray(x), axis=dim, keepdims=keepdim))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(want).any()
        _close(np.nan_to_num(got), np.nan_to_num(want))
    assert np.isnan(float(median(torch.tensor([3.0, np.nan, 1.0, 2.0]))))


def _hot_volume_with_nan():
    """ROADMAP's probe: a uniform 4x16x16 volume with one hot voxel and one NaN."""
    vol = np.random.default_rng(9).uniform(size=(4, 16, 16))
    vol[1, 5, 5], vol[2, 9, 9] = 50.0, np.nan
    return vol


def test_remove_hot_pixels_with_a_nan_voxel_matches_jax():
    """JAX's MAD sigma is NaN, so it changes no voxel; the port did replace
    the hot voxel while its median skipped the NaN."""
    vol = _hot_volume_with_nan()
    got = preprocess.remove_hot_pixels(torch.tensor(vol)).numpy()
    want = np.asarray(jax_pre.remove_hot_pixels(jnp.asarray(vol)))
    np.testing.assert_array_equal(got, want)
    assert got[1, 5, 5] == 50.0


def test_estimate_noise_sigma_with_a_nan_voxel_matches_jax():
    from microtipi_tpu.jobs.autotune import estimate_noise_sigma as jax_sigma
    from microtipi_tpu_torch.jobs.autotune import estimate_noise_sigma

    vol = _hot_volume_with_nan()
    want = float(jax_sigma(jnp.asarray(vol)))
    got = float(estimate_noise_sigma(torch.tensor(vol)))
    assert np.isnan(want) and np.isnan(got)


@pytest.mark.parametrize("dtype", ["int32", "uint16"])
def test_remove_hot_pixels_takes_integer_frames_as_float32(dtype):
    """Camera frames: JAX promotes them to float32; a torch.uint16 frame
    has no replicate padding, so the port converts first."""
    vol = (STACK[0] * 1000).astype(np.int64)
    vol[2, 5, 5], vol[3, 0, 0] = 50000, 40000
    frames = vol.astype(dtype)
    got = preprocess.remove_hot_pixels(torch.from_numpy(frames))
    assert got.dtype == torch.float32
    want = np.asarray(jax_pre.remove_hot_pixels(jnp.asarray(frames)))
    assert want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
