"""The port's pupil retrieval (``jobs/phase_retrieval.py``) against the JAX
package on the CPU (float64).

``retrieve_pupil`` (Gerchberg-Saxton start, parametric start, free modulus
under per-leaf VMLMB bounds) agrees with JAX at 1e-5 (solver outputs; measured
1e-13). The maps are compared through ``exp(i phi)``: ``torch.angle`` and
``jnp.angle`` may take different branches at +-pi, which parts two maps by
exactly 2 pi at a pixel without changing the pupil. The gauge projection,
the Zernike projection and the resampling are deterministic and held at
1e-10. The retrieved maps feed ``jobs.depthvar.depth_anchor_psfs_from_maps``
once, through ``resample_pupil_map``. Inputs: a bead stack (8, 32, 32) of a
Zernike pupil with a localized non-Zernike defect, plus noise. The JAX
references are computed once per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.jobs import phase_retrieval as jax_pr
from microtipi_tpu.jobs.depthvar import depth_anchor_psfs_from_maps as jax_maps_anchors
from microtipi_tpu.jobs.psf_fit import PsfFitConfig as JaxFitConfig
from microtipi_tpu.models.widefield import WideFieldConfig as JaxWideFieldConfig
from microtipi_tpu_torch import convert
from microtipi_tpu_torch.jobs import phase_retrieval as pr
from microtipi_tpu_torch.jobs.depthvar import depth_anchor_psfs_from_maps
from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig
from microtipi_tpu_torch.models.widefield import WideFieldModel

SHAPE, SAMPLE_SHAPE = (8, 32, 32), (6, 40, 40)
DET_RTOL, SOLVE_RTOL = 1e-10, 1e-5
OPTICS = dict(na=1.2, wavelength=500e-9, ni=1.33, dxy=100e-9, dz=200e-9, n_phase=4, radial=True)
SAMPLE_DXY = 80e-9
CASES = {
    "gs": dict(init="gs"),
    "params_start": dict(init="params", params0=True),
    "fit_modulus": dict(init="gs", fit_modulus=True, smooth=2e-2),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(shape=SHAPE, dxy=OPTICS["dxy"]):
    return JaxWideFieldConfig(shape=shape, dtype=jnp.float64, **{**OPTICS, "dxy": dxy})


def _port_model(shape=SHAPE, dxy=OPTICS["dxy"]):
    return WideFieldModel(convert.config_from_fields(_jax_model(shape, dxy), torch.float64), device="cpu")


def _scene():
    m = _jax_model()
    _, phi_zern, psi, mask = m.compute_pupil(m.init_params()._replace(phase=jnp.asarray([0.4, -0.25, 0.15, 0.0])))
    yy, xx = np.meshgrid(np.fft.fftfreq(32) * 32, np.fft.fftfreq(32) * 32, indexing="ij")
    defect = 0.8 * np.exp(-(((yy - 3) / 2.0) ** 2 + ((xx - 2) / 2.0) ** 2))
    phi_true = np.asarray((phi_zern + defect) * mask)
    rng = np.random.default_rng(0)
    bead = 3e6 * np.asarray(m.compute_psf_from_pupil(jnp.asarray(phi_true))) + 10.0 + 5.0 * rng.standard_normal(SHAPE)
    return phi_true, np.asarray(psi), np.asarray(mask), bead


PHI_TRUE, PSI, MASK, BEAD = _scene()


def _kw(spec, params):
    kw = {k: v for k, v in spec.items() if k in ("init", "fit_modulus", "smooth")}
    if spec.get("params0"):
        kw["params0"] = params
    return kw


def _jax_params(m):
    return m.init_params()._replace(phase=jnp.asarray([0.3, -0.2, 0.1, 0.0]))


@pytest.fixture(scope="module")
def jax_refs():
    m = _jax_model()
    # Under jit: JAX's eager dispatch of the same programs takes ~5x longer.
    out = {name: jax.jit(lambda d, spec=spec: jax_pr.retrieve_pupil(
        m, d, config=JaxFitConfig(max_iter=15, grtol=1e-12), gs_iterations=10, **_kw(spec, _jax_params(m))))(
            jnp.asarray(BEAD)) for name, spec in CASES.items()}
    sample = _jax_model(SAMPLE_SHAPE, SAMPLE_DXY)
    maps = jnp.stack([jax_pr.resample_pupil_map(out[n].phi, OPTICS["dxy"], SAMPLE_SHAPE[1:], SAMPLE_DXY,
                                                mask=out[n].mask) for n in ("gs", "fit_modulus")])
    out["anchors"] = (maps, jax_maps_anchors(sample, maps))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_retrieve_pupil_matches_jax(case, jax_refs):
    want = jax_refs[case]
    model = _port_model()
    got = pr.retrieve_pupil(model, torch.tensor(BEAD), config=PsfFitConfig(max_iter=15, grtol=1e-12),
                            gs_iterations=10, **_kw(CASES[case], convert.params_to_torch(_jax_params(_jax_model()))))
    assert (got.iterations, got.evaluations, got.status) == (int(want.iterations), int(want.evaluations),
                                                             int(want.status))
    np.testing.assert_allclose(got.f, float(want.f), rtol=SOLVE_RTOL)
    np.testing.assert_allclose(np.exp(1j * got.phi.numpy()), np.exp(1j * np.asarray(want.phi)), atol=SOLVE_RTOL)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    psf = np.asarray(want.psf)
    np.testing.assert_allclose(got.psf.numpy(), psf, rtol=SOLVE_RTOL, atol=SOLVE_RTOL * psf.max())
    if CASES[case].get("fit_modulus"):
        assert float(got.rho.min()) >= 0.0
        np.testing.assert_allclose(got.rho.numpy(), np.asarray(want.rho), atol=SOLVE_RTOL)
    else:
        assert got.rho is None and want.rho is None


def test_remove_position_gauges_matches_jax():
    rng = np.random.default_rng(1)
    phi = rng.standard_normal(SHAPE[1:]) * MASK
    want = np.asarray(jax_pr.remove_position_gauges(jnp.asarray(phi), jnp.asarray(MASK), jnp.asarray(PSI)))
    got = pr.remove_position_gauges(torch.tensor(phi), torch.tensor(MASK), torch.tensor(PSI)).numpy()
    np.testing.assert_allclose(got, want, rtol=DET_RTOL, atol=DET_RTOL * np.abs(want).max())


def test_project_phase_matches_jax():
    want = np.asarray(jax_pr.project_phase(_jax_model(), jnp.asarray(PHI_TRUE), jnp.asarray(MASK)))
    got = pr.project_phase(_port_model(), torch.tensor(PHI_TRUE), torch.tensor(MASK)).numpy()
    np.testing.assert_allclose(got, want, rtol=DET_RTOL, atol=DET_RTOL * np.abs(want).max())


@pytest.mark.parametrize("dst", [((40, 40), 80e-9), ((24, 24), 120e-9), ((32, 32), 100e-9)], ids=str)
@pytest.mark.parametrize("masked", [False, True])
def test_resample_pupil_map_matches_jax(dst, masked):
    shape, dxy = dst
    mask = MASK if masked else None
    want = np.asarray(jax_pr.resample_pupil_map(jnp.asarray(PHI_TRUE), OPTICS["dxy"], shape, dxy,
                                                mask=None if mask is None else jnp.asarray(mask)))
    got = pr.resample_pupil_map(torch.tensor(PHI_TRUE), OPTICS["dxy"], shape, dxy,
                                mask=None if mask is None else torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=DET_RTOL, atol=DET_RTOL * np.abs(want).max())


def test_retrieved_maps_feed_the_depth_anchors(jax_refs):
    """The hand-off: JAX's retrieved results cross over (``convert.
    pupil_result_to_torch``), are resampled onto the sample grid and
    synthesize the depth anchors as JAX's do."""
    maps_want, anchors_want = (np.asarray(a) for a in jax_refs["anchors"])
    results = [convert.pupil_result_to_torch(jax_refs[n]) for n in ("gs", "fit_modulus")]
    maps = torch.stack([pr.resample_pupil_map(r.phi, OPTICS["dxy"], SAMPLE_SHAPE[1:], SAMPLE_DXY, mask=r.mask)
                        for r in results])
    np.testing.assert_allclose(maps.numpy(), maps_want, rtol=DET_RTOL, atol=DET_RTOL * np.abs(maps_want).max())
    anchors = depth_anchor_psfs_from_maps(_port_model(SAMPLE_SHAPE, SAMPLE_DXY), maps).numpy()
    np.testing.assert_allclose(anchors, anchors_want, rtol=DET_RTOL, atol=DET_RTOL * anchors_want.max())


def test_rejects_a_model_off_the_bead_grid():
    with pytest.raises(ValueError, match="bead stack shape"):
        pr.retrieve_pupil(_port_model(SAMPLE_SHAPE), torch.tensor(BEAD))
