"""The port's SIM (``jobs/sim.py``) and ISM (``jobs/ism.py``) reconstructions
against the JAX package on the CPU (float64).

The forward models, band separations and Wiener recombinations are
deterministic and held at 1e-10 relative (measured 1e-15). The pattern
estimation is a decision: before comparing, the test checks that the winning
candidate's coherence beats the runner-up's by far more than round-off at
every zoom level (a 1e-15 gap would turn into another branch), then holds
the frequencies and phases at 1e-10. ISM: gains (no, scalar and median dark
levels), reassignment (with a dead element) at 1e-10, and 8 joint
Richardson-Lucy iterations at 1e-5 (solver output). Scenes: 2D SIM at 48^2,
3D SIM (2 angles x 5 phases) at (8, 16, 16), ISM with 7 elements at
(6, 24, 24)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.jobs import ism as jax_ism
from microtipi_tpu.jobs import sim as jax_sim
from microtipi_tpu.models.ism import ISMConfig as JaxISMConfig
from microtipi_tpu.models.widefield import WideFieldConfig as JaxWideFieldConfig
from microtipi_tpu_torch import convert
from microtipi_tpu_torch.jobs import ism, sim
from microtipi_tpu_torch.models import model_for

DET_RTOL, SOLVE_RTOL = 1e-10, 1e-5
NY = NX = 48
DXY = 80e-9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=DET_RTOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-300))


def _sim2d():
    m = JaxWideFieldConfig(shape=(1, NY, NX), na=1.4, wavelength=500e-9, ni=1.518, dxy=DXY, dz=120e-9,
                           dtype=jnp.float64)
    h = m.compute_psf(m.init_params())[0]
    otf = np.asarray(jnp.fft.fft2((h / jnp.sum(h)).astype(jnp.complex128)))
    k = 0.8 * 2 * 1.4 / 500e-9 * DXY
    a_k = np.stack([[k * np.sin(t), k * np.cos(t)] for t in np.pi / 3 * np.arange(3)])
    ph = np.tile(2 * np.pi / 3 * np.arange(3), (3, 1))
    rng = np.random.default_rng(1)
    x = np.zeros((NY, NX))
    for _ in range(10):
        x[rng.integers(6, 42), rng.integers(6, 42)] = rng.uniform(50, 100)
    true_k = a_k + np.array([[0.4 / NY, -0.3 / NX]] * 3)
    true_ph = ph + np.array([[0.5], [-0.3], [0.2]])
    data = np.asarray(jax_sim.simulate_sim(jnp.asarray(x), otf, true_k, true_ph, modulation=0.9))
    return x, otf, a_k, ph, true_k, true_ph, data


X2, OTF, K0, PH0, TRUE_K, TRUE_PH, DATA2 = _sim2d()


def _sim3d():
    nz, n = 8, 16
    m = JaxWideFieldConfig(shape=(nz, n, n), na=1.2, wavelength=500e-9, ni=1.33, dxy=80e-9, dz=150e-9,
                           dtype=jnp.float64)
    h = m.compute_psf(m.init_params())
    a_k = np.stack([[0.3 * np.sin(t), 0.3 * np.cos(t)] for t in np.pi / 2 * np.arange(2)])
    ph = np.tile(2 * np.pi / 5 * np.arange(5), (2, 1)) + np.array([[0.0], [0.4]])
    x = np.random.default_rng(3).random((nz, n, n)) * 10.0
    return x, np.asarray(h / jnp.sum(h)), a_k, ph


X3, H3, K3, PH3 = _sim3d()
Q3 = dict(q=0.23, psi=0.4, m1=0.8, m2=0.9)


def test_simulate_and_separate_2d_match_jax():
    _close(sim.simulate_sim(torch.tensor(X2), torch.tensor(OTF), TRUE_K, TRUE_PH, modulation=0.9), DATA2)
    _close(sim.separate_bands(torch.tensor(DATA2), PH0, 0.9), jax_sim.separate_bands(DATA2, PH0, 0.9))


@pytest.mark.parametrize("apodize", [True, False])
def test_reconstruct_sim_matches_jax(apodize):
    want = jax_sim.reconstruct_sim(DATA2, OTF, TRUE_K, TRUE_PH, 0.9, 1e-3, apodize)
    got = sim.reconstruct_sim(torch.tensor(DATA2), torch.tensor(OTF), TRUE_K, TRUE_PH, 0.9, 1e-3, apodize)
    assert tuple(got.x.shape) == (2 * NY, 2 * NX)
    _close(got.x, want.x)
    _close(got.spectrum_weight, want.spectrum_weight)


def _coherence_margins():
    """The JAX loop's coherence at every candidate of every zoom level, as
    NumPy: per level, (best, runner-up)."""
    d = DATA2
    ny, nx = d.shape[2:]
    yg, xg = np.arange(ny)[:, None], np.arange(nx)[None, :]
    h = OTF
    habs = np.abs(h)
    thresh = 0.05 * habs.max()
    margins = []
    a_k, ph = K0.copy(), PH0.copy()
    for _ in range(2):
        bands = np.asarray(jax_sim.separate_bands(d, ph, 0.9))
        for a in range(3):
            base = a_k[a].copy()
            ip = np.fft.ifft2(bands[a, 1])
            ramp0 = np.exp(2j * np.pi * (base[0] * yg + base[1] * xg))
            mask = (habs > thresh) & (np.abs(np.fft.fft2(np.fft.ifft2(h) * np.conj(ramp0))) > thresh)
            b0m = np.where(mask, np.conj(bands[a, 0]), 0.0)

            def level(dys, dxs):
                cands = [(dy, dx) for dy in dys for dx in dxs]
                sqs = []
                for dy, dx in cands:
                    q = np.fft.fft2(ip * np.exp(-2j * np.pi * ((base[0] + dy / ny) * yg + (base[1] + dx / nx) * xg)))
                    sqs.append(((q * b0m).sum(), np.abs(q * b0m).sum()))
                coh = np.array([abs(s) / t for s, t in sqs])
                order = np.argsort(-coh, kind="stable")
                margins.append(coh[order[0]] - coh[order[1]])
                return cands[order[0]][0], cands[order[0]][1], sqs[order[0]][0]

            fy, fx, sq = level(np.arange(-2, 3.0), np.arange(-2, 3.0))
            for step in (0.5, 0.1, 0.02, 0.004):
                fy, fx, sq = level(np.linspace(fy - 2 * step, fy + 2 * step, 5),
                                   np.linspace(fx - 2 * step, fx + 2 * step, 5))
            a_k[a] += np.array([fy / ny, fx / nx])
            ph[a] += np.angle(sq)
    return np.array(margins)


def test_estimate_sim_pattern_matches_jax():
    margins = _coherence_margins()
    assert margins.min() > 1e-9, margins.min()  # every decision far above round-off
    want_k, want_ph = jax_sim.estimate_sim_pattern(DATA2, OTF, K0, PH0, modulation=0.9)
    got_k, got_ph = sim.estimate_sim_pattern(torch.tensor(DATA2), torch.tensor(OTF), K0, PH0, modulation=0.9)
    np.testing.assert_allclose(got_k, want_k, rtol=DET_RTOL, atol=1e-14)
    np.testing.assert_allclose(got_ph, want_ph, rtol=DET_RTOL, atol=1e-12)
    np.testing.assert_allclose(got_k, TRUE_K, atol=0.02 / NY)  # and it found the pattern


def test_sim3d_pieces_match_jax():
    _close(sim.sim3d_order_otfs(torch.tensor(H3), **Q3), jax_sim.sim3d_order_otfs(jnp.asarray(H3), **Q3))
    want = np.asarray(jax_sim.simulate_sim3d(jnp.asarray(X3), H3, K3, PH3, **Q3))
    _close(sim.simulate_sim3d(torch.tensor(X3), torch.tensor(H3), K3, PH3, **Q3), want)
    _close(sim.separate_bands_3d(torch.tensor(want), PH3), jax_sim.separate_bands_3d(want, PH3))


@pytest.mark.parametrize("upsample_z", [True, False])
def test_reconstruct_sim3d_matches_jax(upsample_z):
    data = np.asarray(jax_sim.simulate_sim3d(jnp.asarray(X3), H3, K3, PH3, **Q3))
    want = jax_sim.reconstruct_sim3d(data, H3, K3, PH3, wiener=1e-3, upsample_z=upsample_z, **Q3)
    got = sim.reconstruct_sim3d(torch.tensor(data), torch.tensor(H3), K3, PH3, wiener=1e-3, upsample_z=upsample_z,
                                **Q3)
    _close(got.x, want.x)
    _close(got.spectrum_weight, want.spectrum_weight)


def test_sim_refusals():
    with pytest.raises(ValueError, match=">= 3"):
        sim.separate_bands(torch.zeros(1, 2, 8, 8), np.zeros((1, 2)))
    with pytest.raises(ValueError, match=">= 5"):
        sim.separate_bands_3d(torch.zeros(1, 4, 2, 8, 8), np.zeros((1, 4)))


# ISM


def _jax_ism():
    return JaxISMConfig(shape=(6, 24, 24), na=1.2, wavelength=520e-9, wavelength_exc=488e-9, ni=1.33, dxy=60e-9,
                        dz=200e-9, n_phase=2, radial=True, dtype=jnp.float64, element_pitch=120e-9, rings=1,
                        pinhole=0.0)


def _ism_scene():
    m = _jax_ism()
    p = m.init_params()._replace(phase=jnp.asarray([0.2, -0.1]))
    psfs = np.asarray(m.compute_psfs(p))
    rng = np.random.default_rng(2)
    x = np.zeros(m.shape)
    for _ in range(6):
        x[rng.integers(0, 6), rng.integers(4, 20), rng.integers(4, 20)] = rng.uniform(50, 100)
    gains = np.array([1.0, 0.8, 1.2, 1.0, 0.9, 1.1, 1.05])
    blur = np.fft.irfftn(np.fft.rfftn(psfs, axes=(1, 2, 3)) * np.fft.rfftn(x)[None], s=m.shape, axes=(1, 2, 3))
    data = gains[:, None, None, None] * blur + 2.0 + 0.01 * rng.standard_normal(blur.shape)
    return p, data


ISM_P, ISM_DATA = _ism_scene()


def _ism_model():
    return model_for(convert.family_config_from_fields(_jax_ism()), device="cpu")


@pytest.mark.parametrize("background", ["none", "median", 2.0, "per_element"])
def test_ism_element_gains_match_jax(background):
    if background == "per_element":
        background = np.linspace(1.5, 2.5, 7)
    want = jax_ism.ism_element_gains(_jax_ism(), ISM_P, ISM_DATA, background=background)
    got = ism.ism_element_gains(_ism_model(), convert.params_to_torch(ISM_P), torch.tensor(ISM_DATA),
                                background=background)
    _close(got, want)


@pytest.mark.parametrize("with_gains", [False, True])
def test_ism_reassign_matches_jax(with_gains):
    gains = np.array([1.0, 0.8, 1.2, 0.0, 0.9, 1.1, 1.05]) if with_gains else None  # element 3 dead
    want = jax_ism.ism_reassign(_jax_ism(), ISM_DATA, gains=gains)
    _close(ism.ism_reassign(_ism_model(), torch.tensor(ISM_DATA), gains=gains), want)
    _close(ism.ism_reassign(_ism_model(), torch.tensor(ISM_DATA), factor=0.4),
           jax_ism.ism_reassign(_jax_ism(), ISM_DATA, factor=0.4))


@pytest.mark.parametrize("kw", [dict(), dict(backprojector="wiener-butterworth", background=2.0,
                                             gains=(1.0, 0.8, 1.2, 1.0, 0.9, 1.1, 1.05))], ids=["matched", "wb"])
def test_ism_richardson_lucy_matches_jax(kw):
    want = jax_ism.ism_richardson_lucy(_jax_ism(), ISM_P, ISM_DATA, iterations=8, **kw)
    got = ism.ism_richardson_lucy(_ism_model(), convert.params_to_torch(ISM_P), torch.tensor(ISM_DATA),
                                  iterations=8, **kw)
    _close(got, want, SOLVE_RTOL)


def test_ism_refuses_a_wrong_element_count():
    with pytest.raises(ValueError, match="centre-out element"):
        ism.ism_reassign(_ism_model(), torch.zeros((3, 6, 24, 24), dtype=torch.float64))
