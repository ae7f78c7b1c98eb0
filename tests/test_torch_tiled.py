"""The port's tiled (overlap-discard) deconvolution against the JAX
package's on the CPU (float64): the tile plan, the cases of
tests/test_tiled.py, and the field-varying PSF. Inputs come from numpy with a
seed and feed both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.jobs.deconv import DeconvolutionConfig as JaxDeconvConfig
from microtipi_tpu.jobs.tiled import field_psf as jax_field_psf
from microtipi_tpu.jobs.tiled import tile_plan as jax_tile_plan
from microtipi_tpu.jobs.tiled import tiled_deconvolve as jax_tiled
from microtipi_tpu.models.widefield import WideFieldConfig as JaxConfig
from microtipi_tpu.ops.convolution import convolve, convolve_spectrum
from microtipi_tpu_torch.convert import config_from_fields, params_to_torch
from microtipi_tpu_torch.jobs import tiled as ttiled
from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, deconvolve
from microtipi_tpu_torch.models.widefield import WideFieldModel

# Each tile is one lane of a batched solve: the lane bound of
# tests/test_torch_batch.py (x to 1e-6 relative L2 against JAX; float64 FFT
# summation order, amplified late by the quadratic form's c/f).
X_REL = 1e-6


def _scene(shape, support=2, seed=0):
    """tests/test_tiled.py:33-44: a blurred scene with a compactly supported
    kernel."""
    rng = np.random.default_rng(seed)
    psf = np.zeros(shape, np.float64)
    psf[:support, :support, :support] = rng.random((support,) * 3)
    psf /= psf.sum()
    obj = np.zeros(shape)
    for _ in range(12):
        z, y, x = rng.integers(1, shape[0] - 3), rng.integers(2, shape[1] - 8), rng.integers(2, shape[2] - 8)
        obj[z:z + 2, y:y + 5, x:x + 5] = rng.uniform(30, 100)
    data = np.asarray(convolve(jnp.asarray(obj), convolve_spectrum(jnp.asarray(psf)), shape))
    return psf, obj, data


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("n,t,o", [(100, 40, 8), (64, 64, 0), (65, 32, 4), (128, 48, 10)])
def test_tile_plan_matches_jax(n, t, o):
    assert ttiled.tile_plan((n, 2 * n), (t, t), (o, o)) == jax_tile_plan((n, 2 * n), (t, t), (o, o))


def test_tile_plan_rejects_bad_geometry():
    with pytest.raises(ValueError, match="exceeds"):
        ttiled.tile_plan((32,), (64,), (4,))
    with pytest.raises(ValueError, match="twice the overlap"):
        ttiled.tile_plan((64,), (16,), (8,))


def test_tiled_matches_jax_with_compact_psf():
    """tests/test_tiled.py:47-63: 16x48x48 in 4 tiles of 16x32x32, one batch."""
    shape = (16, 48, 48)
    psf, obj, data = _scene(shape)
    kw = dict(mu=1e-3, epsilon=1.0, max_iter=12, grtol=0.0)
    tk = dict(tile=(16, 32, 32), overlap=(0, 8, 8), max_batch=4)
    want = jax_tiled(data, psf, config=JaxDeconvConfig(**kw), **tk)
    got = ttiled.tiled_deconvolve(data, psf, config=DeconvolutionConfig(**kw), device="cpu", **tk)
    assert got.shape == shape and got.dtype == data.dtype
    assert _rel(got, want) < X_REL


@pytest.mark.parametrize("weighted", [False, True])
def test_tiled_admm_matches_jax(weighted):
    """method="admm": 9 tiles in batches of 4, 4 and 1 through the batched
    ADMM engine, against JAX's tiled ADMM (1e-8: an ADMM trajectory has no
    line search to amplify the FFT libraries' summation order)."""
    shape = (8, 40, 40)
    psf, obj, data = _scene(shape, seed=3)
    w = None
    if weighted:
        w = np.ones(shape)
        w[:, :4] = 0.0
    kw = dict(mu=1e-3, epsilon=1.0, max_iter=8, grtol=0.0)
    tk = dict(weights=w, tile=(8, 24, 24), overlap=(0, 6, 6), max_batch=4, method="admm")
    want = jax_tiled(data, psf, config=JaxDeconvConfig(**kw), **tk)
    got = ttiled.tiled_deconvolve(data, psf, config=DeconvolutionConfig(**kw), device="cpu", **tk)
    assert got.shape == shape and np.isfinite(got).all() and got.min() >= 0.0
    assert _rel(got, want) < 1e-8


def test_tiled_single_tile_is_deconvolve():
    """tile == volume: the one tile's solve is deconvolve's (the port's lane
    equals its single solve; measured bitwise in x) and JAX's tiled result."""
    shape = (8, 24, 24)
    psf, obj, data = _scene(shape, seed=1)
    kw = dict(mu=1e-3, epsilon=1.0, max_iter=6, grtol=0.0)
    got = ttiled.tiled_deconvolve(data, psf, tile=shape, overlap=4, config=DeconvolutionConfig(**kw),
                                  device="cpu")
    full = deconvolve(torch.tensor(data), torch.tensor(psf), config=DeconvolutionConfig(**kw)).x.numpy()
    np.testing.assert_allclose(got, full, rtol=1e-10, atol=1e-12)
    want = jax_tiled(data, psf, tile=shape, overlap=4, config=JaxDeconvConfig(**kw))
    assert _rel(got, want) < X_REL


def test_tiled_weights_and_ragged_tail():
    """tests/test_tiled.py:104-113 with max_batch=4 over 9 tiles: batches of
    4, 4 and 1 lanes."""
    shape = (8, 40, 40)
    psf, obj, data = _scene(shape, seed=3)
    w = np.ones(shape)
    w[:, :4] = 0.0
    kw = dict(mu=1e-3, epsilon=1.0, max_iter=4, grtol=0.0)
    tk = dict(weights=w, tile=(8, 24, 24), overlap=(0, 6, 6), max_batch=4)
    want = jax_tiled(data, psf, config=JaxDeconvConfig(**kw), **tk)
    got = ttiled.tiled_deconvolve(data, psf, config=DeconvolutionConfig(**kw), device="cpu", **tk)
    assert np.isfinite(got).all() and _rel(got, want) < X_REL


def test_tiled_constant_callable_matches_array_path():
    """tests/test_tiled.py:115-123: a psf_fn returning one kernel everywhere
    (one kernel per lane) gives the static-PSF result, and JAX's."""
    psf, obj, data = _scene((8, 48, 48))
    kw = dict(tile=(8, 32, 32), overlap=(0, 8, 8), device="cpu",
              config=DeconvolutionConfig(mu=1e-3, epsilon=1.0, max_iter=8, grtol=0.0))
    ref = ttiled.tiled_deconvolve(data, psf, **kw)
    got = ttiled.tiled_deconvolve(data, lambda center: torch.tensor(psf), **kw)
    np.testing.assert_allclose(got, ref, atol=1e-10)
    want = jax_tiled(data, lambda center: jnp.asarray(psf), tile=(8, 32, 32), overlap=(0, 8, 8),
                     config=JaxDeconvConfig(mu=1e-3, epsilon=1.0, max_iter=8, grtol=0.0))
    assert _rel(got, want) < X_REL


def test_field_psf_matches_jax():
    """Inverse-distance-weighted anchors (tests/test_tiled.py:283-299): at the
    anchors, between them and off their line, carried across by
    convert.params_to_torch; the same float64 synthesis, 1e-10 of the max."""
    jcfg = JaxConfig(shape=(4, 16, 16), na=1.2, wavelength=500e-9, ni=1.33, dxy=100e-9, dz=250e-9,
                     n_phase=2, radial=True, dtype=jnp.float64)
    pa = jcfg.init_params()._replace(phase=jnp.asarray([0.4, 0.0]))
    pb = jcfg.init_params()._replace(phase=jnp.asarray([0.0, 0.4]), defocus=jnp.asarray([2.66e6, 1e4, 0.0]))
    jfn = jax_field_psf(jcfg, [((0.0, 0.0), pa), ((0.0, 100.0), pb)])
    model = WideFieldModel(config_from_fields(jcfg), device="cpu")
    tfn = ttiled.field_psf(model, [((0.0, 0.0), params_to_torch(pa)), ((0.0, 100.0), params_to_torch(pb))])
    for center in ((2, 0.0, 0.0), (2, 0.0, 100.0), (2, 0.0, 50.0), (2, 30.0, 20.0)):
        want = np.asarray(jfn(center))
        got = tfn(center)
        assert not got.requires_grad
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10 * want.max())


def test_unported_options_and_default_device():
    psf, obj, data = _scene((8, 24, 24))
    cfg = DeconvolutionConfig(max_iter=2)
    # the depth-varying path is ported (tests/test_torch_depthvar.py), on
    # the vmlmb method only
    with pytest.raises(ValueError, match="vmlmb path"):
        ttiled.tiled_deconvolve(data, psf, config=cfg, device="cpu", method="rl", depthvar_anchors=[0.0, 7.0])
    with pytest.raises(ValueError, match="at least one"):
        ttiled.field_depthvar_psf(None, [], [0.0])
    with pytest.raises(ValueError, match="unknown method"):
        ttiled.tiled_deconvolve(data, psf, config=cfg, device="cpu", method="sgd")
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttiled.tiled_deconvolve(data, psf, config=cfg)
