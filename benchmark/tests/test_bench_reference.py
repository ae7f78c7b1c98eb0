"""The plain reference computes what the port computes, in float64 on the
CPU at small sizes (a non-square stack among them): the PSF, the kernel's
embedding, the objective, and the ADMM object step."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference.admm import admm
from benchmark.reference.objective import objective, pad_kernel, spectrum
from benchmark.reference.precision import Precision
from benchmark.reference.psf import WideField

F64 = Precision("float64")
SHAPES = [(8, 16, 16), (8, 24, 16), (12, 40, 32)]


def _port_model(shape, n_phase=6):
    from microtipi_tpu_torch.models.widefield import WideFieldConfig, WideFieldModel

    return WideFieldModel(WideFieldConfig(shape=shape, na=1.4, wavelength=6.54e-7, ni=1.518, dxy=6.45e-8, dz=2e-7,
                                          n_phase=n_phase, n_modulus=1, dtype=torch.float64), device="cpu")


def _params(rng, n_phase=6):
    return {"defocus": torch.tensor([1.518 / 6.54e-7 * 1.001, 2e4, -1e4], dtype=torch.float64),
            "phase": torch.as_tensor(rng.uniform(-0.2, 0.2, n_phase)), "modulus": torch.tensor([1.0], dtype=torch.float64)}


@pytest.mark.parametrize("shape", [(8, 16, 16), (16, 32, 32)])
def test_psf_matches_the_port(shape):
    from microtipi_tpu_torch.models.widefield import WideFieldParams

    p = _params(np.random.default_rng(1))
    ref = WideField(shape, 1.4, 6.54e-7, 1.518, 6.45e-8, 2e-7, 6, 1, "cpu", F64).psf(p)
    port = _port_model(shape).compute_psf(WideFieldParams(p["defocus"], p["phase"], p["modulus"]))
    assert torch.allclose(ref, port, rtol=1e-12, atol=1e-15 * float(port.max()))


def _problem(shape, seed=0):
    rng = np.random.default_rng(seed)
    kshape = (shape[0], shape[2], shape[2])
    k = torch.as_tensor(rng.random(kshape) ** 8)
    k = k / k.sum()
    d = torch.as_tensor(rng.random(shape) * 100.0)
    return d, k


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_embedding_and_objective_match_the_port(shape):
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, make_objective
    from microtipi_tpu_torch.utils.arrays import pad_fft_kernel

    d, k = _problem(shape)
    assert torch.equal(pad_kernel(k, shape), pad_fft_kernel(k, shape))
    x = torch.clamp_min(d + 3.0, 0.0)
    f_port, _ = make_objective(k, d, None, DeconvolutionConfig(mu=0.01, epsilon=1.0))(x)
    f_ref = objective(x, d, spectrum(pad_kernel(k, shape), F64), 0.01, 1.0, F64)
    assert float(f_ref) == pytest.approx(float(f_port), rel=1e-12)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("alpha", [1.0, 1.8])
@pytest.mark.parametrize("weighted", [False, True])
def test_admm_matches_the_port(shape, alpha, weighted):
    from microtipi_tpu_torch.jobs.admm import admm_deconvolve
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig

    from benchmark.scene import inverse_variance

    d, k = _problem(shape, 1)
    w = inverse_variance(d, {"read_noise_adu": 1.5, "gain": 2.0}) if weighted else None
    if weighted:
        w[0, 0, :3] = 0.0  # voxels excluded whatever their datum
    cfg = DeconvolutionConfig(mu=0.05, epsilon=1.0, max_iter=10, grtol=0.0, gatol=0.0)
    port = admm_deconvolve(d, k, weights=w, config=cfg, over_relax=alpha, track_objective=False)
    x, f = admm(d, pad_kernel(k, shape), 0.05, 1.0, 10, alpha, F64, w=w)
    assert float(torch.linalg.vector_norm(x - port.x) / torch.linalg.vector_norm(port.x)) < 1e-12
    assert f == pytest.approx(float(port.f), rel=1e-12)


def test_bfloat16_rounds_every_value_it_keeps():
    p = Precision("bfloat16")
    t = torch.tensor([1.0 + 2 ** -12, 3.0], dtype=torch.float32)
    assert p(t).tolist() == [1.0, 3.0] and p(t).dtype == torch.float32
    z = torch.complex(t, -t)
    assert p(z).real.tolist() == [1.0, 3.0]
