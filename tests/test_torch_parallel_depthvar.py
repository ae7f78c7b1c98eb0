"""The port's sharded depth-varying solvers (``parallel/depthvar.py``) on
meshes of CPU entries (float64) against the port's dense ones
(``jobs/depthvar.py``), on a Gibson-Lanni scene of 16x32x32 with 3 anchors:
the object step (plain, weighted, on a padded grid), the PSF fit (PHASE, and
DEPTH jointly with PHASE) and the blind loop. The blend rows are taken by
global z offset, so a slab boundary must not move them.

Tolerances as ``tests/test_parallel_jobs.py``'s sharded-vs-dense ones: f to
1e-8 relative, the object to 1e-6 absolute, the fitted coefficients to 1e-7
(the depth, in metres, to 1e-7 relative).
"""

import dataclasses

import numpy as np
import pytest
import torch

from microtipi_tpu_torch.jobs import depthvar as dv
from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig
from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig
from microtipi_tpu_torch.models.gibson_lanni import GibsonLanniConfig, GibsonLanniModel
from microtipi_tpu_torch.models.microscope import DEFOCUS, DEPTH, PHASE
from microtipi_tpu_torch.ops.depthconv import DepthVaryingConvCost
from microtipi_tpu_torch.parallel import depthvar as sdv
from microtipi_tpu_torch.parallel.mesh import gather, make_mesh
from microtipi_tpu_torch.utils.arrays import pad_to_shape

SHAPE = (16, 32, 32)
ANCHORS = np.array([0.0, 7.5, 15.0])
F_REL, X_ABS, P_ABS = 1e-8, 1e-6, 1e-7
CFG = dict(mu=0.01, epsilon=1.0, grtol=0.0, gatol=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(b, z):
    return make_mesh(b, z, devices=[torch.device("cpu")] * (b * z))


@pytest.fixture(scope="module")
def scene():
    model = GibsonLanniModel(GibsonLanniConfig(shape=SHAPE, na=1.4, wavelength=561e-9, ni=1.518, dxy=80e-9,
                                               dz=200e-9, n_phase=4, ns=1.38, depth=10e-6, dtype=torch.float64),
                             device="cpu")
    true = model.init_params()._replace(phase=torch.tensor([0.2, -0.1, 0.05, 0.1], dtype=torch.float64))
    with torch.no_grad():
        psfs = dv.depth_anchor_psfs(model, true, ANCHORS)
        rng = np.random.default_rng(0)
        obj = torch.as_tensor((rng.random(SHAPE) > 0.97) * rng.random(SHAPE) * 100.0)
        data = DepthVaryingConvCost.build(psfs, obj, None, SHAPE, ANCHORS).model(obj)
    data = data + 0.01 * torch.as_tensor(rng.standard_normal(SHAPE))
    return model, psfs, obj, data


def _same(got, ref):
    assert abs(float(got.f) - float(ref.f)) <= F_REL * abs(float(ref.f))
    assert float((gather(got.x) - ref.x).abs().max()) <= X_ABS


@pytest.mark.parametrize("mesh_shape", [(1, 2), (1, 4), (2, 2)])
def test_sharded_deconvolve_depthvar_matches_dense(mesh_shape, scene):
    _, psfs, _, data = scene
    cfg = DeconvolutionConfig(max_iter=10, **CFG)
    _same(sdv.sharded_deconvolve_depthvar(data, psfs, _mesh(*mesh_shape), ANCHORS, config=cfg),
          dv.deconvolve_depthvar(data, psfs, ANCHORS, config=cfg))


@pytest.mark.parametrize("var_shape", [None, (20, 36, 36)])
def test_sharded_deconvolve_depthvar_weighted_and_padded(var_shape, scene):
    """Weights with a zero, and the padded grid (the blend rows shifted by
    the padding's z offset). From one start: the sharded default starts from
    the masked data, as the JAX module's does, the dense one from the data."""
    _, psfs, _, data = scene
    w = torch.as_tensor(0.5 + np.random.default_rng(3).random(SHAPE))
    w[3, 4, 5] = 0.0
    cfg = DeconvolutionConfig(max_iter=8, var_shape=var_shape, **CFG)
    x0 = pad_to_shape(torch.clamp_min(data, 0.0), var_shape or SHAPE)
    got = sdv.sharded_deconvolve_depthvar(data, psfs, _mesh(1, 4), ANCHORS, weights=w, x0=x0, config=cfg)
    assert got.x.shape == (var_shape or SHAPE)
    _same(got, dv.deconvolve_depthvar(data, psfs, ANCHORS, weights=w, x0=x0, config=cfg))


@pytest.mark.parametrize("flags", [(PHASE,), (DEPTH, PHASE)])
def test_sharded_fit_psf_depthvar_matches_dense(flags, scene):
    model, _, obj, data = scene
    cfg = PsfFitConfig(max_iter=6, grtol=0.0)
    got = sdv.sharded_fit_psf_depthvar(model, model.init_params(), flags, data, obj, _mesh(1, 4), ANCHORS,
                                       config=cfg)
    ref = dv.fit_psf_depthvar(model, model.init_params(), flags, data, obj, ANCHORS, config=cfg)
    assert float((got.params.phase - ref.params.phase).abs().max()) <= P_ABS
    assert float(((got.params.depth - ref.params.depth) / ref.params.depth).abs().max()) <= P_ABS
    assert abs(float(got.f) - float(ref.f)) <= 1e-7 * abs(float(ref.f))


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
def test_sharded_blind_depthvar_matches_dense(mesh_shape, scene):
    model, _, _, data = scene
    cfg = BlindDeconvConfig(loops=2, families=(DEFOCUS, PHASE), psf_max_iter=(3, 3), joint_fit=True,
                            deconv=DeconvolutionConfig(max_iter=5, **CFG))
    got = sdv.sharded_blind_deconvolve_depthvar(data, model, _mesh(*mesh_shape), ANCHORS, config=cfg)
    ref = dv.blind_deconvolve_depthvar(data, model, ANCHORS, config=cfg)
    np.testing.assert_allclose(got.deconv_f, ref.deconv_f, rtol=F_REL)
    assert float((got.params.phase - ref.params.phase).abs().max()) <= P_ABS
    assert float((gather(got.obj) - ref.obj).abs().max()) <= X_ABS
    assert got.psf.shape == (3, *SHAPE)


def test_sharded_blind_depthvar_guards(scene):
    model, _, _, data = scene
    cfg = BlindDeconvConfig(loops=1, families=(PHASE,), psf_max_iter=(1,))
    with pytest.raises(ValueError, match="circulant"):
        sdv.sharded_blind_deconvolve_depthvar(data, model, _mesh(1, 4), 3,
                                              config=dataclasses.replace(cfg, deconv_engine="admm"))
    with pytest.raises(ValueError, match="fit_window"):
        sdv.sharded_blind_deconvolve_depthvar(data, model, _mesh(1, 4), 3, config=dataclasses.replace(
            cfg, fit=PsfFitConfig(fit_window=(8, 16, 16))))
