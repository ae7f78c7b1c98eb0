"""Port wide-field PSF model against the JAX package (CPU, float64), the
frozen golden values, and JAX gradients; and the convert.py round trip."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.models.widefield import WideFieldConfig as JaxConfig
from microtipi_tpu.models.widefield import WideFieldParams as JaxParams
from microtipi_tpu_torch.convert import config_fields, config_from_fields, params_to_numpy, params_to_torch
from microtipi_tpu_torch.models.widefield import WideFieldModel

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_widefield.npz")
OPTICS = dict(na=1.4, wavelength=561e-9, ni=1.518, dxy=80e-9, dz=200e-9)


def _pair(shape, n_phase=6, n_modulus=3, seed=0):
    """The same config and random params in both packages."""
    jc = JaxConfig(shape=shape, n_phase=n_phase, n_modulus=n_modulus, dtype=jnp.float64, **OPTICS)
    rng = np.random.default_rng(seed)
    jp = jc.init_params()._replace(
        phase=jnp.asarray(0.2 * rng.standard_normal(n_phase)),
        modulus=jnp.asarray(np.r_[1.0, 0.1 * rng.standard_normal(n_modulus - 1)]),
        defocus=jnp.asarray([1.518 / 561e-9, 1e4, -2e4]),
    )
    return jc, jp, WideFieldModel(config_from_fields(jc), device="cpu"), params_to_torch(jp)


def _rel(a, b):
    return np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(np.asarray(b)))


@pytest.mark.parametrize("shape", [(8, 32, 32), (7, 32, 32)])
def test_psf_matches_jax(shape):
    """1e-10 relative: both are the same float64 arithmetic up to FFT order."""
    jc, jp, model, tp = _pair(shape)
    assert _rel(model.compute_psf(tp), jc.compute_psf(jp)) < 1e-10
    for a, b in zip(model.compute_pupil(tp), jc.compute_pupil(jp)):
        assert _rel(a, b) < 1e-10


GOLDEN_CASES = {
    "": (dict(shape=(8, 32, 32), n_phase=5, n_modulus=3, **OPTICS),
         dict(phase=[0.3, -0.2, 0.1, 0.05, -0.15], modulus=[1.0, 0.1, -0.05],
              defocus=[1.518 / 561e-9, 1e4, -2e4])),
    "_radial": (dict(shape=(6, 24, 24), na=1.2, wavelength=500e-9, ni=1.33, dxy=100e-9, dz=250e-9,
                     n_phase=4, n_modulus=2, radial=True),
                dict(phase=[0.25, -0.12, 0.07, 0.02], modulus=[1.0, -0.08], defocus=[1.33 / 500e-9, 0, 0])),
    "_odd": (dict(shape=(9, 25, 25), na=1.3, wavelength=520e-9, ni=1.47, dxy=90e-9, dz=180e-9,
                  n_phase=4, n_modulus=1),
             dict(phase=[0.2, -0.1, 0.05, 0.08], modulus=[1.0], defocus=[1.47 / 520e-9, 5e3, 7e3])),
}


@pytest.mark.parametrize("suffix", list(GOLDEN_CASES))
def test_psf_matches_golden(suffix):
    """The tolerances of tests/test_golden.py."""
    geometry, values = GOLDEN_CASES[suffix]
    model = WideFieldModel(config_from_fields(JaxConfig(dtype=jnp.float64, **geometry)), device="cpu")
    p = model.init_params()._replace(**{k: torch.tensor(v, dtype=torch.float64) for k, v in values.items()})
    rho, phi, psi, mask = (a.numpy() for a in model.compute_pupil(p))
    with np.load(GOLDEN) as z:
        psf = z["psf" + suffix]
        np.testing.assert_allclose(model.compute_psf(p).numpy(), psf, rtol=1e-12, atol=psf.max() * 1e-13)
        np.testing.assert_allclose(rho, z["rho" + suffix], rtol=1e-11, atol=1e-14)
        np.testing.assert_allclose(phi, z["phi" + suffix], rtol=1e-11, atol=1e-13)
        if not suffix:
            np.testing.assert_allclose(psi, z["psi"], rtol=1e-12, atol=1e-12)
            np.testing.assert_array_equal(mask, z["mask"])
            q = p._replace(**{k: v.clone().requires_grad_() for k, v in p._asdict().items()})
            torch.sum(model.compute_psf(q) ** 2).backward()
            np.testing.assert_allclose(q.defocus.grad.numpy(), z["grad_defocus"], rtol=1e-10)
            np.testing.assert_allclose(q.phase.grad.numpy(), z["grad_phase"], rtol=1e-10)
            np.testing.assert_allclose(q.modulus.grad.numpy(), z["grad_modulus"], rtol=1e-10, atol=1e-22)


@pytest.mark.parametrize("shape", [(8, 32, 32), (7, 32, 32)])
def test_gradients_match_jax(shape):
    """Autograd through the complex field and batched FFT against jax.grad,
    1e-8 relative per family (measured ~1e-15)."""
    jc, jp, model, tp = _pair(shape, seed=1)
    w = np.random.default_rng(2).random(shape)
    gj = jax.grad(lambda p: jnp.sum(jc.compute_psf(p) * w))(jp)
    tq = tp._replace(**{k: v.clone().requires_grad_() for k, v in tp._asdict().items()})
    torch.sum(model.compute_psf(tq) * torch.tensor(w)).backward()
    for name in ("defocus", "phase", "modulus"):
        assert _rel(getattr(tq, name).grad, getattr(gj, name)) < 1e-8, name


def test_convert_round_trip():
    jc, jp, model, tp = _pair((8, 32, 32))
    back = JaxParams(**params_to_numpy(tp))
    for a, b in zip(back, jp):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    fields = config_fields(config_from_fields(jc))
    assert np.dtype(fields.pop("dtype")) == np.dtype(jc.dtype)
    assert JaxConfig(**fields, dtype=jc.dtype) == jc
    assert config_from_fields(jc, dtype=torch.float32).dtype == torch.float32
    assert [b.dtype for b in model.buffers()] == [torch.float64] * 3
    tp32 = params_to_torch(jp, dtype=torch.float32)
    assert all(t.dtype == torch.float32 for t in tp32)


def test_model_defaults_to_the_card():
    """Without a device the model's buffers go to the CUDA card; on a host
    without one, construction raises instead of landing on the CPU."""
    cfg = config_from_fields(JaxConfig(shape=(4, 16, 16), dtype=jnp.float64, **OPTICS))
    if torch.cuda.is_available():
        assert WideFieldModel(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            WideFieldModel(cfg)
    assert WideFieldModel(cfg, device="cpu").device.type == "cpu"


def test_mixing_from_controls_defaults_to_the_card():
    """The unmixing matrix made from host data goes to the CUDA card unless
    the caller names another device; on a host without one, it raises."""
    from microtipi_tpu_torch.jobs.multichannel import mixing_from_controls

    controls = [np.ones((2, 3, 3)), np.eye(2)[:, :, None] * np.ones((2, 2, 3))]
    if torch.cuda.is_available():
        assert mixing_from_controls(controls).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mixing_from_controls(controls)
    assert mixing_from_controls(controls, device="cpu").device.type == "cpu"
