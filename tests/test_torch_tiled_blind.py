"""The port's out-of-core blind loop (``jobs/tiled_blind.py``) against the
JAX package on the CPU (float64).

The streamed statistics equal JAX's at 1e-10 relative (deterministic; measured
1e-15), for several stats tiles including flush-shifted ragged blocks, and
the streamed objective equals the dense circulant objective with the
support-limited PSF at 1e-10 (the module's exactness contract). The streamed
fit and the whole tiled loop (VMLMB and ADMM tiles) agree with JAX at 1e-5
relative (solver outputs). Inputs: a (16, 32, 32) volume of sparse beads
blurred by the support-limited true PSF at (4, 12, 12), plus noise. The JAX
references are computed once per module."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.jobs.blind import BlindDeconvConfig as JaxBlindConfig
from microtipi_tpu.jobs.deconv import DeconvolutionConfig as JaxDeconvConfig
from microtipi_tpu.jobs.psf_fit import PsfFitConfig as JaxFitConfig
from microtipi_tpu.jobs.tiled_blind import blind_deconvolve_tiled as jax_tiled_blind
from microtipi_tpu.jobs.tiled_blind import fit_psf_streamed as jax_fit_streamed
from microtipi_tpu.jobs.tiled_blind import make_streamed_fit_cost as jax_streamed_cost
from microtipi_tpu.jobs.tiled_blind import streamed_fit_stats as jax_streamed_stats
from microtipi_tpu.models.microscope import DEFOCUS, PHASE
from microtipi_tpu.models.widefield import WideFieldConfig as JaxWideFieldConfig
from microtipi_tpu_torch import convert
from microtipi_tpu_torch.jobs import tiled_blind
from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig
from microtipi_tpu_torch.models.widefield import WideFieldModel
from microtipi_tpu_torch.utils.arrays import pad_fft_kernel

VOL, PSF_SHAPE = (16, 32, 32), (4, 12, 12)
DET_RTOL, SOLVE_RTOL = 1e-10, 1e-5
OPTICS = dict(na=1.2, wavelength=500e-9, ni=1.33, dxy=100e-9, dz=250e-9, n_modulus=1)
TRUE_PHASE = (0.3, -0.2, 0.1)
STATS_TILES = [None, (8, 16, 16), (16, 24, 24), (6, 20, 32)]
LOOP_CASES = {
    "vmlmb_joint": dict(),
    "admm_sequential": dict(deconv_engine="admm", joint_fit=False, mu_schedule=(0.03, 0.01)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(dtype=jnp.float64):
    return JaxWideFieldConfig(shape=PSF_SHAPE, n_phase=3, dtype=dtype, **OPTICS)


def _port_model(dtype=torch.float64):
    return WideFieldModel(convert.config_from_fields(_jax_model(), dtype), device="cpu")


def _scene():
    rng = np.random.default_rng(0)
    obj = np.zeros(VOL)
    for _ in range(12):
        obj[rng.integers(0, VOL[0]), rng.integers(4, VOL[1] - 4), rng.integers(4, VOL[2] - 4)] = rng.uniform(50, 100)
    m = _jax_model()
    psf = np.asarray(m.compute_psf(m.init_params()._replace(phase=jnp.asarray(TRUE_PHASE))))
    kern = np.asarray(pad_fft_kernel(torch.tensor(psf), VOL))
    data = np.fft.irfftn(np.fft.rfftn(obj) * np.fft.rfftn(kern), s=VOL, axes=(0, 1, 2)) + 0.01 * rng.standard_normal(VOL)
    return obj, data

OBJ, DATA = _scene()
PHASES = [(0.0, 0.0, 0.0), (0.3, -0.2, 0.1), (-0.5, 0.4, 0.2)]


def _blind_config(spec):
    fields = {**dict(loops=2, families=(DEFOCUS, PHASE), psf_max_iter=(4, 4), joint_fit=True), **spec}
    return JaxBlindConfig(deconv=JaxDeconvConfig(mu=0.01, epsilon=0.1, max_iter=5), fit=JaxFitConfig(), **fields)


@pytest.fixture(scope="module")
def jax_refs():
    m = _jax_model()
    stats = {tile: jax_streamed_stats(OBJ, DATA, PSF_SHAPE, tile=tile) for tile in STATS_TILES}
    cost = jax_streamed_cost(stats[None], m)
    costs = [float(cost(m.init_params()._replace(phase=jnp.asarray(ph)))) for ph in PHASES]
    fits = {joint: jax_fit_streamed(m, m.init_params(), (DEFOCUS, PHASE), stats[None], JaxFitConfig(max_iter=6),
                                    joint=joint) for joint in (True, False)}
    loops = {name: jax_tiled_blind(DATA, m, _blind_config(spec), tile=(16, 24, 24), overlap=4, max_batch=2)
             for name, spec in LOOP_CASES.items()}
    return dict(stats=stats, costs=costs, fits=fits, loops=loops)


@pytest.mark.parametrize("tile", STATS_TILES, ids=str)
def test_streamed_stats_match_jax(tile, jax_refs):
    want = jax_refs["stats"][tile]
    got = tiled_blind.streamed_fit_stats(OBJ, DATA, PSF_SHAPE, tile=tile, max_batch=3, device="cpu")
    assert got.rho.dtype == torch.float64 and got.g_shape == want.g_shape
    np.testing.assert_allclose(got.rho.numpy(), want.rho, rtol=DET_RTOL, atol=DET_RTOL * np.abs(want.rho).max())
    np.testing.assert_allclose(got.b.numpy(), want.b, rtol=DET_RTOL, atol=DET_RTOL * np.abs(want.b).max())
    np.testing.assert_allclose(got.c, want.c, rtol=DET_RTOL)


def test_streamed_cost_matches_jax(jax_refs):
    model = _port_model()
    cost = tiled_blind.make_streamed_fit_cost(convert.fit_stats_to_torch(jax_refs["stats"][None]), model)
    got = [float(cost(model.init_params()._replace(phase=torch.tensor(ph, dtype=torch.float64)))) for ph in PHASES]
    np.testing.assert_allclose(got, jax_refs["costs"], rtol=DET_RTOL)


@pytest.mark.parametrize("tile", STATS_TILES[1:], ids=str)
def test_streamed_objective_equals_dense(tile):
    """The exactness contract: the streamed quadratic equals the dense
    circulant objective with the support-limited PSF."""
    model = _port_model()
    cost = tiled_blind.make_streamed_fit_cost(
        tiled_blind.streamed_fit_stats(OBJ, DATA, PSF_SHAPE, tile=tile, device="cpu"), model)
    obj_hat = torch.fft.rfftn(torch.tensor(OBJ))
    for ph in PHASES:
        p = model.init_params()._replace(phase=torch.tensor(ph, dtype=torch.float64))
        r = torch.fft.irfftn(obj_hat * torch.fft.rfftn(pad_fft_kernel(model.compute_psf(p), VOL)), s=VOL)
        dense = float(0.5 * torch.sum((r - torch.tensor(DATA)) ** 2))
        np.testing.assert_allclose(float(cost(p)), dense, rtol=DET_RTOL)


def test_wrapped_blocks_equal_modular_gathers():
    """Interior blocks are plain slices, and a block that crosses the edge
    takes wrapped indices along that axis only; both equal ``np.ix_`` with
    every index taken modulo the volume."""
    vol = np.arange(np.prod(VOL), dtype=np.float64).reshape(VOL)
    for lo in [(0, 0, 0), (-4, 10, -12), (12, 26, 4), (4, 8, 8)]:
        size = (8, 16, 16)
        want = vol[np.ix_(*[np.arange(l, l + s) % n for l, s, n in zip(lo, size, VOL)])]
        np.testing.assert_array_equal(tiled_blind._wrapped_block(vol, lo, size), want)


@pytest.mark.parametrize("joint", [True, False])
def test_fit_psf_streamed_matches_jax(joint, jax_refs):
    want_p, want_f, want_it = jax_refs["fits"][joint]
    model = _port_model()
    p, f, its = tiled_blind.fit_psf_streamed(model, model.init_params(), (DEFOCUS, PHASE),
                                             convert.fit_stats_to_torch(jax_refs["stats"][None]),
                                             PsfFitConfig(max_iter=6), joint=joint)
    assert its == want_it and p.phase.dtype == torch.float64
    np.testing.assert_allclose(f, want_f, rtol=SOLVE_RTOL)
    for name in ("defocus", "phase"):
        w = np.asarray(getattr(want_p, name))
        np.testing.assert_allclose(getattr(p, name).numpy(), w, rtol=SOLVE_RTOL, atol=SOLVE_RTOL * np.abs(w).max())


@pytest.mark.parametrize("case", list(LOOP_CASES))
def test_blind_deconvolve_tiled_matches_jax(case, jax_refs):
    """The loop: a fresh tiled object step a round, one statistics pass and
    one float64 fit, NaN object costs, and no refit after the last round.
    """
    w_obj, w_params, w_psf, w_df, w_ff = jax_refs["loops"][case]
    cfg = convert.blind_config_from_fields(_blind_config(LOOP_CASES[case]))
    obj, params, psf, df, ff = tiled_blind.blind_deconvolve_tiled(DATA, _port_model(), cfg, tile=(16, 24, 24),
                                                                  overlap=4, max_batch=2)
    assert isinstance(obj, np.ndarray) and np.all(np.isnan(df)) and np.isnan(ff[-1]) and len(ff) == 2
    np.testing.assert_allclose(ff[:-1], w_ff[:-1], rtol=SOLVE_RTOL)
    for name in ("defocus", "phase"):
        w = np.asarray(getattr(w_params, name))
        np.testing.assert_allclose(getattr(params, name).numpy(), w, rtol=SOLVE_RTOL,
                                   atol=SOLVE_RTOL * np.abs(w).max())
    np.testing.assert_allclose(obj, w_obj, rtol=SOLVE_RTOL, atol=SOLVE_RTOL * np.abs(w_obj).max())
    np.testing.assert_allclose(psf.numpy(), w_psf, rtol=SOLVE_RTOL, atol=SOLVE_RTOL * np.abs(w_psf).max())


def test_streamed_stats_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tiled_blind.streamed_fit_stats(OBJ, DATA, PSF_SHAPE)


def test_refuses_a_psf_wider_than_half_the_volume():
    with pytest.raises(ValueError, match="2\\*psf_shape"):
        tiled_blind.streamed_fit_stats(OBJ, DATA, (4, 20, 12), device="cpu")
