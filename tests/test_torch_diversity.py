"""The port's phase diversity (``jobs/diversity.py``) against the JAX package
on the CPU (float64).

The diversity phases, channel PSFs, the profiled cost and the object estimate
are deterministic and held at 1e-10 relative; the fit and its error bars at
1e-5 (solver outputs; measured 1e-13). A planar (1, 32, 32) and a volumetric
(6, 24, 24) scene of a uniform random object seen through two defocus- or
astigmatism-diverse pupils, plus noise. The JAX references are computed once
per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.jobs import diversity as jax_div
from microtipi_tpu.jobs.psf_fit import PsfFitConfig as JaxFitConfig
from microtipi_tpu.models.microscope import DEFOCUS, PHASE
from microtipi_tpu.models.widefield import WideFieldConfig as JaxWideFieldConfig
from microtipi_tpu_torch import convert
from microtipi_tpu_torch.jobs import diversity as div
from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig
from microtipi_tpu_torch.models.widefield import WideFieldModel

DET_RTOL, SOLVE_RTOL = 1e-10, 1e-5
TRUE_PHASE = (0.3, -0.2, 0.15, 0.1)
SCENES = {
    "planar_defocus": dict(shape=(1, 32, 32), radial=True, diversity="defocus"),
    "volumetric_astigmatism": dict(shape=(6, 24, 24), radial=False, diversity="zernike"),
}
FIT_CASES = {
    "planar_defocus": dict(families=(PHASE,)),
    "volumetric_astigmatism": dict(families=(PHASE, DEFOCUS), kw=dict(image_weights=(1.0, 0.7))),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(scene):
    s = SCENES[scene]
    return JaxWideFieldConfig(shape=s["shape"], na=1.2, wavelength=500e-9, ni=1.518, dxy=100e-9, dz=200e-9,
                              n_phase=4, radial=s["radial"], dtype=jnp.float64)


def _port_model(scene):
    return WideFieldModel(convert.config_from_fields(_jax_model(scene), torch.float64), device="cpu")


def _phases(scene, mod):
    m = _jax_model(scene) if mod is jax_div else _port_model(scene)
    if SCENES[scene]["diversity"] == "defocus":
        return mod.defocus_diversity(m, [-2e-7, 2e-7])
    return mod.zernike_diversity(m, [[0.0, 0.0, 0.6], [0.0, 0.0, -0.6]])


def _data(scene):
    m = _jax_model(scene)
    rng = np.random.default_rng(0)
    shape = SCENES[scene]["shape"]
    h = np.asarray(jax_div.diversity_psfs(m, m.init_params()._replace(phase=jnp.asarray(TRUE_PHASE)),
                                          _phases(scene, jax_div)))
    x = rng.uniform(0.0, 1.0, shape) + 0.1
    y = np.fft.irfftn(np.fft.rfftn(h, axes=(1, 2, 3)) * np.fft.rfftn(x)[None], s=shape, axes=(1, 2, 3))
    return y + 1e-3 * rng.standard_normal(y.shape)


DATA = {scene: _data(scene) for scene in SCENES}


@pytest.fixture(scope="module")
def jax_refs():
    out = {}
    for scene, spec in FIT_CASES.items():
        m = _jax_model(scene)
        ph = _phases(scene, jax_div)
        kw = spec.get("kw", {})
        # Under jit: JAX's eager dispatch of the same programs takes ~5x longer.
        fit = jax.jit(lambda d: jax_div.fit_psf_diversity(m, d, ph, spec["families"], config=JaxFitConfig(max_iter=8),
                                                          **kw))(DATA[scene])
        unc = jax.jit(lambda p: jax_div.diversity_fit_uncertainty(m, p, spec["families"], DATA[scene], ph,
                                                                  **kw))(fit.params)
        unc_sigma = None if scene != "planar_defocus" else jax.jit(lambda p: jax_div.diversity_fit_uncertainty(
            m, p, (PHASE,), DATA[scene], ph, sigma=1e-3, phase_freeze_head=0))(fit.params)
        obj = jax_div.diversity_object_estimate(m, fit.params, DATA[scene], ph, **kw)
        out[scene] = dict(fit=fit, unc=unc, unc_sigma=unc_sigma, obj=obj)
    return out


def _close(got, want, rtol):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.nanmax(np.abs(want)), 1e-300))


@pytest.mark.parametrize("scene", list(SCENES))
def test_diversity_phases_match_jax(scene):
    _close(_phases(scene, div), _phases(scene, jax_div), DET_RTOL)
    _close(div.defocus_diversity(_port_model(scene), [3e-7], lambda_ni=2.9e6),
           jax_div.defocus_diversity(_jax_model(scene), [3e-7], lambda_ni=2.9e6), DET_RTOL)


@pytest.mark.parametrize("scene", list(SCENES))
def test_diversity_psfs_and_cost_match_jax(scene):
    jm, pm = _jax_model(scene), _port_model(scene)
    p = jm.init_params()._replace(phase=jnp.asarray([0.1, 0.05, -0.1, 0.0]))
    ph = _phases(scene, div)
    _close(div.diversity_psfs(pm, convert.params_to_torch(p), ph), jax_div.diversity_psfs(jm, p, ph), DET_RTOL)
    for kw in (dict(), dict(gamma=1e-6, image_weights=(1.0, 0.5))):
        want = float(jax_div.diversity_cost(jm, DATA[scene], ph, **kw)(p))
        got = float(div.diversity_cost(pm, DATA[scene], ph, **kw)(convert.params_to_torch(p)))
        np.testing.assert_allclose(got, want, rtol=DET_RTOL)


def test_rfft_multiplicity_matches_jax():
    for shape in [(1, 8, 8), (4, 6, 7), (2, 5, 10)]:
        np.testing.assert_array_equal(div._rfft_multiplicity(shape, np.float64),
                                      jax_div._rfft_multiplicity(shape, np.float64))


@pytest.mark.parametrize("scene", list(FIT_CASES))
def test_fit_psf_diversity_matches_jax(scene, jax_refs):
    want = jax_refs[scene]["fit"]
    spec = FIT_CASES[scene]
    got = div.fit_psf_diversity(_port_model(scene), DATA[scene], _phases(scene, div), spec["families"],
                                config=PsfFitConfig(max_iter=8), **spec.get("kw", {}))
    assert (got.iterations, got.evaluations, got.status) == (int(want.iterations), int(want.evaluations),
                                                             int(want.status))
    np.testing.assert_allclose(got.f, float(want.f), rtol=SOLVE_RTOL)
    for name in ("phase", "defocus"):
        _close(getattr(got.params, name), getattr(want.params, name), SOLVE_RTOL)
    if SCENES[scene]["shape"][0] > 1:  # volumetric: Z4 pinned by default
        assert float(got.params.phase[0]) == 0.0


@pytest.mark.parametrize("scene", list(FIT_CASES))
def test_object_estimate_and_error_bars_match_jax(scene, jax_refs):
    ref = jax_refs[scene]
    spec = FIT_CASES[scene]
    pm, ph = _port_model(scene), _phases(scene, div)
    params = convert.params_to_torch(ref["fit"].params)
    kw = spec.get("kw", {})
    _close(div.diversity_object_estimate(pm, params, DATA[scene], ph, **kw), ref["obj"], DET_RTOL)
    unc = div.diversity_fit_uncertainty(pm, params, spec["families"], DATA[scene], ph, **kw)
    for name in unc.std:
        np.testing.assert_array_equal(np.isnan(unc.std[name].numpy()), np.isnan(np.asarray(ref["unc"].std[name])))
        _close(unc.std[name], ref["unc"].std[name], SOLVE_RTOL)
    _close(unc.cov, ref["unc"].cov, SOLVE_RTOL)
    _close(unc.sigma, ref["unc"].sigma, SOLVE_RTOL)
    if ref["unc_sigma"] is not None:  # a given sigma, every phase mode free
        fixed = div.diversity_fit_uncertainty(pm, params, (PHASE,), DATA[scene], ph, sigma=1e-3, phase_freeze_head=0)
        _close(fixed.std["phase"], ref["unc_sigma"].std["phase"], SOLVE_RTOL)
