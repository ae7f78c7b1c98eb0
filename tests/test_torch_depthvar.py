"""The depth-varying object step of the port against the JAX package on the
CPU (float64): ``depth_weights``, ``DepthVaryingConvCost`` (plain, padded,
weighted, and over lanes), the anchor PSFs from a Gibson-Lanni model and
from pupil maps, ``deconvolve_depthvar`` (Gaussian, Poisson, padded),
``richardson_lucy_depthvar`` (matched, RL-TV, accelerated),
``batched_deconvolve_depthvar``, the tiled depth-varying path with
``field_depthvar_psf``, ``fit_psf_depthvar`` (with the calibration prior and
a bead anchor), ``blind_deconvolve_depthvar``, the depth ladder
``calibrate_depth`` and its ``ladder_fit_uncertainty``. Inputs come from
numpy with a seed and feed both packages; the JAX references are computed
once, in module fixtures.

Tolerances: the operator, its costs and gradients and the anchor PSFs to
1e-10 relative (the same float64 arithmetic up to FFT and summation order);
every solver's object to 1e-5 relative L2, the BASELINE.json fidelity bar,
and its final cost to 1e-8 relative with the same iteration count; the PSF
fits' and the ladder's cost at the start to 1e-10, their params and f to
1e-5; the ladder's error bars to 1e-8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.jobs.batch import batched_deconvolve_depthvar as jax_batched_depthvar
from microtipi_tpu.jobs.deconv import DeconvolutionConfig as JaxDeconvConfig
from microtipi_tpu.jobs.depthvar import depth_anchor_psfs as jax_anchor_psfs
from microtipi_tpu.jobs.depthvar import depth_anchor_psfs_from_maps as jax_anchor_psfs_from_maps
from microtipi_tpu.jobs.depthvar import deconvolve_depthvar as jax_deconvolve_depthvar
from microtipi_tpu.jobs.depthvar import richardson_lucy_depthvar as jax_rl_depthvar
from microtipi_tpu.jobs.tiled import field_depthvar_psf as jax_field_depthvar_psf
from microtipi_tpu.jobs.tiled import tiled_deconvolve as jax_tiled
from microtipi_tpu.models.gibson_lanni import GibsonLanniConfig as JaxGLConfig
from microtipi_tpu.models.widefield import WideFieldConfig as JaxConfig
from microtipi_tpu.ops.depthconv import DepthVaryingConvCost as JaxDepthCost
from microtipi_tpu.ops.depthconv import depth_weights as jax_depth_weights
from microtipi_tpu_torch.convert import family_config_from_fields, params_to_torch
from microtipi_tpu_torch.jobs import depthvar as tdepthvar
from microtipi_tpu_torch.jobs.batch import batched_deconvolve_depthvar
from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
from microtipi_tpu_torch.jobs.tiled import field_depthvar_psf, tiled_deconvolve
from microtipi_tpu_torch.models import model_for
from microtipi_tpu_torch.models.microscope import DEFOCUS, DEPTH, PHASE
from microtipi_tpu_torch.ops.depthconv import DepthVaryingConvCost, depth_weights

SHAPE = (8, 16, 16)
PAD = (12, 20, 20)
ANCHORS = np.array([0.0, 3.5, 7.0])
OPTICS = dict(na=1.4, wavelength=561e-9, ni=1.518, dxy=80e-9, dz=200e-9, n_phase=4, ns=1.38, depth=10e-6,
              dtype=jnp.float64)
OP_RTOL, X_REL, F_REL = 1e-10, 1e-5, 1e-8
CFG = dict(mu=0.01, epsilon=1.0, max_iter=15, grtol=0.0, gatol=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tensors this small run fastest on one intra-op thread, and the suite
    runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _gl(shape=SHAPE):
    """The JAX Gibson-Lanni config, its params with an aberration, and the
    port's model and params."""
    cfg = JaxGLConfig(shape=shape, **OPTICS)
    p = cfg.init_params()._replace(phase=jnp.asarray([0.2, -0.1, 0.05, 0.1]))
    return cfg, p, model_for(family_config_from_fields(cfg), device="cpu"), params_to_torch(p)


def _scenes(n=3, seed=0):
    """The K = 3 anchor PSFs at depth 10 um and ``n`` sparse bead scenes
    blurred by the depth-varying operator, with 2% Gaussian noise."""
    cfg, p, _, _ = _gl()
    psfs = np.asarray(jax_anchor_psfs(cfg, p, ANCHORS))
    rng = np.random.default_rng(seed)
    objs = rng.random((n, *SHAPE)) * (rng.random((n, *SHAPE)) > 0.97) * 100 + 1.0
    op = JaxDepthCost.build(jnp.asarray(psfs), jnp.asarray(objs[0]), anchors=ANCHORS)
    blurred = np.stack([np.asarray(op.model(jnp.asarray(o))) for o in objs])
    return psfs, objs, blurred + 0.02 * blurred.max() * rng.standard_normal(blurred.shape)


def test_depth_weights_match_jax():
    for nz, anchors in ((8, ANCHORS), (12, ANCHORS + 2), (5, [1.0]), (9, [0.5, 2.0, 2.5, 8.0])):
        np.testing.assert_array_equal(depth_weights(nz, anchors), jax_depth_weights(nz, anchors))
    with pytest.raises(ValueError, match="strictly increasing"):
        depth_weights(8, [3.0, 1.0])


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_depth_varying_cost_matches_jax(padded, weighted):
    """The model, the cost and its gradient, on the data grid and on a
    padded grid, where the anchors move onto the centred data window."""
    psfs, objs, data = _scenes(1)
    rng = np.random.default_rng(3)
    var_shape = PAD if padded else SHAPE
    w = rng.uniform(0.5, 2.0, SHAPE) * (rng.random(SHAPE) > 0.1) if weighted else None
    x = rng.random(var_shape) * 10
    kern = np.stack([np.asarray(jnp.fft.ifftshift(jnp.pad(jnp.fft.fftshift(h), [((b - s) // 2, b - s - (b - s) // 2)
                                                                             for s, b in zip(SHAPE, var_shape)])))
                     for h in psfs])
    want = JaxDepthCost.build(jnp.asarray(kern), jnp.asarray(data[0]), None if w is None else jnp.asarray(w),
                              var_shape, ANCHORS)
    got = DepthVaryingConvCost.build(torch.tensor(kern), torch.tensor(data[0]),
                                     None if w is None else torch.tensor(w), var_shape, ANCHORS)
    off = (var_shape[0] - SHAPE[0]) // 2
    np.testing.assert_array_equal(got.zweights.numpy(), depth_weights(var_shape[0], ANCHORS + off))
    assert padded == (off > 0)
    np.testing.assert_array_equal(got.zweights.numpy(), np.asarray(want.zweights))
    assert _rel(got.model(torch.tensor(x)), want.model(jnp.asarray(x))) < OP_RTOL
    f_want, g_want = jax.value_and_grad(want.cost)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    f = got.cost(xt)
    f.backward()
    f = f.detach()
    assert abs(float(f) - float(f_want)) / float(f_want) < OP_RTOL and _rel(xt.grad, g_want) < OP_RTOL


def test_padded_anchors_follow_the_data_window():
    """On a 12-plane padded grid the 8-plane data window starts at plane 2:
    data plane 0 blurs with anchor 0 alone and data plane 7 with anchor 2
    alone, at variable planes 2 and 9 (unshifted, anchor 2 would own plane 7
    and the window's last two planes would blend)."""
    psfs, _, data = _scenes(1)
    kern = torch.stack([torch.tensor(np.asarray(jnp.fft.ifftshift(jnp.pad(jnp.fft.fftshift(h), ((2, 2), (0, 0),
                                                                                                  (0, 0))))))
                        for h in psfs])
    cost = DepthVaryingConvCost.build(kern, torch.tensor(data[0]), var_shape=(12, 16, 16), anchors=ANCHORS)
    zw = cost.zweights.numpy()
    np.testing.assert_array_equal(zw[:, 2], [1.0, 0.0, 0.0])
    np.testing.assert_array_equal(zw[:, 9], [0.0, 0.0, 1.0])
    assert zw[0, 7] == 0.0 and zw[1, 7] > 0.0 and zw[2, 7] > 0.0
    np.testing.assert_array_equal(depth_weights(12, ANCHORS)[:, 7], [0.0, 0.0, 1.0])


def test_lanes_are_the_single_volume_costs():
    """A batch with one shared stack or one stack a lane gives, lane for
    lane, the single volume's cost and gradient; a lane subset indexes the
    per-lane fields only."""
    psfs, objs, data = _scenes(3)
    rng = np.random.default_rng(4)
    w = rng.uniform(0.5, 2.0, data.shape)
    x = rng.random(data.shape) * 10
    per_lane = np.stack([psfs, psfs[::-1].copy(), 0.5 * (psfs + psfs[::-1])])
    for kern in (psfs, per_lane):
        batch = DepthVaryingConvCost.build(torch.tensor(kern), torch.tensor(data), torch.tensor(w), anchors=ANCHORS)
        xt = torch.tensor(x, requires_grad=True)
        f = batch.cost(xt)
        f.sum().backward()
        f = f.detach()
        sub = batch.select_lanes(torch.tensor([2, 0]))
        f_sub = sub.cost(torch.tensor(x[[2, 0]]))
        for b in range(3):
            one = DepthVaryingConvCost.build(torch.tensor(kern if kern.ndim == 4 else kern[b]), torch.tensor(data[b]),
                                             torch.tensor(w[b]), anchors=ANCHORS)
            xb = torch.tensor(x[b], requires_grad=True)
            fb = one.cost(xb)
            fb.backward()
            fb = fb.detach()
            assert abs(float(f[b]) - float(fb)) / float(fb) < 1e-13 and _rel(xt.grad[b], xb.grad) < 1e-13
        assert torch.allclose(f_sub, f[[2, 0]], rtol=1e-13, atol=0)


def test_anchor_psfs_match_jax():
    """The Gibson-Lanni anchors (one batched synthesis) and the anchors from
    pupil maps, with and without moduli, one defocus or one a map."""
    cfg, p, model, tp = _gl()
    for depth0 in (None, 4e-6):
        want = np.asarray(jax_anchor_psfs(cfg, p, ANCHORS, depth0=depth0))
        got = tdepthvar.depth_anchor_psfs(model, tp, ANCHORS, depth0=depth0)
        assert got.shape == want.shape == (3, *SHAPE) and _rel(got, want) < OP_RTOL
    wcfg = JaxConfig(shape=SHAPE, **{k: v for k, v in OPTICS.items() if k not in ("ns", "depth")})
    wmodel = model_for(family_config_from_fields(wcfg), device="cpu")
    rng = np.random.default_rng(5)
    phis, rhos = 0.3 * rng.standard_normal((3, 16, 16)), 1.0 + 0.1 * rng.standard_normal((3, 16, 16))
    per_map = np.array([[2.706e6, 0.0, 0.0], [2.706e6, 1e4, 0.0], [2.71e6, 0.0, -1e4]])
    for r, d in ((None, None), (rhos, None), (rhos, per_map), (None, per_map[1])):
        want = np.asarray(jax_anchor_psfs_from_maps(wcfg, phis, r, d))
        got = tdepthvar.depth_anchor_psfs_from_maps(wmodel, phis, r, d)
        assert _rel(got, want) < OP_RTOL
    with pytest.raises(ValueError, match="DEPTH family"):
        tdepthvar.depth_anchor_psfs(wmodel, wmodel.init_params(), ANCHORS)


# name: the JAX solve and the port's, on the scenes of _scenes
SOLVES = {
    "gaussian_weighted": dict(config=CFG, weighted=True),
    "poisson": dict(config=dict(CFG, data_term="poisson", background=1.0)),
    "padded": dict(config=dict(CFG, var_shape=PAD)),
}
RL_CASES = {
    "matched": dict(iterations=20),
    "rl_tv": dict(iterations=20, mu=0.01, epsilon=1.0),
    "accelerated": dict(iterations=15, accelerate=True),
}


def _weights(data):
    return np.random.default_rng(6).uniform(0.5, 2.0, data.shape)


@pytest.fixture(scope="module")
def jax_runs():
    """Every JAX solve of the file, once."""
    psfs, objs, data = _scenes(3)
    counts = np.random.default_rng(7).poisson(np.maximum(data, 0.0)).astype(np.float64)
    out = {}
    for name, case in SOLVES.items():
        d = counts[0] if name == "poisson" else data[0]
        w = jnp.asarray(_weights(d)) if case.get("weighted") else None
        r = jax_deconvolve_depthvar(jnp.asarray(d), jnp.asarray(psfs), ANCHORS, weights=w,
                                    config=JaxDeconvConfig(**case["config"]))
        out[name] = (np.asarray(r.x), float(r.f), int(r.iterations))
    for name, kw in RL_CASES.items():
        out["rl_" + name] = np.asarray(jax_rl_depthvar(jnp.asarray(data[0]), jnp.asarray(psfs), ANCHORS, **kw))
    r = jax_batched_depthvar(jnp.asarray(data), jnp.asarray(psfs), ANCHORS, weights=jnp.asarray(_weights(data)),
                             config=JaxDeconvConfig(**CFG))
    out["batched"] = (np.asarray(r.x), np.asarray(r.f), np.asarray(r.iterations))
    return psfs, data, counts, out


@pytest.mark.parametrize("name", list(SOLVES))
def test_deconvolve_depthvar_matches_jax(name, jax_runs):
    psfs, data, counts, want = jax_runs
    case = SOLVES[name]
    d = counts[0] if name == "poisson" else data[0]
    w = torch.tensor(_weights(d)) if case.get("weighted") else None
    got = tdepthvar.deconvolve_depthvar(torch.tensor(d), torch.tensor(psfs), ANCHORS, weights=w,
                                        config=DeconvolutionConfig(**case["config"]))
    x, f, iterations = want[name]
    assert got.iterations == iterations and abs(float(got.f) - f) / abs(f) < F_REL
    assert got.x.shape == x.shape and _rel(got.x, x) < X_REL and float(got.x.min()) >= 0.0


@pytest.mark.parametrize("name", list(RL_CASES))
def test_richardson_lucy_depthvar_matches_jax(name, jax_runs):
    psfs, data, _, want = jax_runs
    got = tdepthvar.richardson_lucy_depthvar(torch.tensor(data[0]), torch.tensor(psfs), ANCHORS, **RL_CASES[name])
    assert _rel(got, want["rl_" + name]) < X_REL and float(got.min()) >= 0.0


def test_richardson_lucy_depthvar_of_a_constant_stack_is_plain_rl():
    """Partition of unity: K copies of one PSF is shift-invariant RL."""
    from microtipi_tpu_torch.jobs.richardson_lucy import richardson_lucy

    psfs, _, data = _scenes(1)
    stack = torch.tensor(np.stack([psfs[1]] * 3))
    got = tdepthvar.richardson_lucy_depthvar(torch.tensor(data[0]), stack, ANCHORS, iterations=10, mu=0.01,
                                             epsilon=1.0)
    want = richardson_lucy(torch.tensor(data[0]), torch.tensor(psfs[1]), iterations=10, mu=0.01, epsilon=1.0)
    assert _rel(got, want) < 1e-12


def test_batched_deconvolve_depthvar_matches_jax(jax_runs):
    """The lanes in lockstep against the JAX package's vmap, and lane for
    lane against deconvolve_depthvar of each scene."""
    psfs, data, _, want = jax_runs
    w = _weights(data)
    cfg = DeconvolutionConfig(**CFG)
    got = batched_deconvolve_depthvar(torch.tensor(data), torch.tensor(psfs), ANCHORS, weights=torch.tensor(w),
                                      config=cfg)
    x, f, iterations = want["batched"]
    np.testing.assert_array_equal(got.iterations, iterations)
    assert np.max(np.abs(got.f - f) / np.abs(f)) < F_REL and _rel(got.x, x) < X_REL
    for b in range(data.shape[0]):
        one = tdepthvar.deconvolve_depthvar(torch.tensor(data[b]), torch.tensor(psfs), ANCHORS,
                                            weights=torch.tensor(w[b]), config=cfg)
        assert one.iterations == got.iterations[b] and _rel(got.x[b], one.x) < 1e-10
    with pytest.raises(ValueError, match="a batch of volumes is 4D"):
        batched_deconvolve_depthvar(torch.tensor(data[0]), torch.tensor(psfs), ANCHORS)


VOLUME, TILE, OVERLAP = (14, 16, 16), (8, 16, 16), 2
ZS = np.array([0.0, 3.5, 7.0])


@pytest.fixture(scope="module")
def tiled_runs():
    """A 14x16x16 volume in two z tiles of 8 planes; the JAX tiled solves
    with one static anchor stack and with ``field_depthvar_psf`` (two
    lateral calibrations, each with a DEPTH family)."""
    cfg, p, _, _ = _gl(TILE)
    rng = np.random.default_rng(8)
    obj = rng.random(VOLUME) * (rng.random(VOLUME) > 0.97) * 100
    stack = np.asarray(jax_anchor_psfs(cfg, p, ZS))
    vol_psf = np.asarray(JaxGLConfig(shape=VOLUME, **OPTICS).compute_psf(p))
    blurred = np.fft.irfftn(np.fft.rfftn(obj) * np.fft.rfftn(vol_psf), s=VOLUME, axes=(0, 1, 2))
    data = blurred + 0.5 * rng.standard_normal(VOLUME)
    calib = [((0.0, 0.0), p), ((0.0, 40.0), p._replace(depth=p.depth * jnp.asarray([1.0, 1.3])))]
    jcfg = JaxDeconvConfig(**dict(CFG, max_iter=10))
    static = jax_tiled(data, stack, tile=TILE, overlap=OVERLAP, config=jcfg, depthvar_anchors=ZS)
    field = jax_tiled(data, jax_field_depthvar_psf(cfg, calib, ZS), tile=TILE, overlap=OVERLAP, config=jcfg,
                      depthvar_anchors=ZS)
    return cfg, calib, stack, data, static, field


def test_field_depthvar_psf_matches_jax(tiled_runs):
    cfg, calib, _, _, _, _ = tiled_runs
    model = model_for(family_config_from_fields(cfg), device="cpu")
    jfn = jax_field_depthvar_psf(cfg, calib, ZS)
    tfn = field_depthvar_psf(model, [(pos, params_to_torch(p)) for pos, p in calib], ZS)
    for center in ((4.0, 8.0, 8.0), (10.0, 8.0, 8.0), (4.0, 8.0, 30.0)):
        got, want = tfn(center), np.asarray(jfn(center))
        assert got.shape == (3, *TILE) and not got.requires_grad and _rel(got, want) < OP_RTOL
    # the deeper tile's anchors sit 6 planes deeper
    assert _rel(tfn((10.0, 8.0, 8.0)), tfn((4.0, 8.0, 8.0))) > 1e-3


def test_tiled_depthvar_matches_jax(tiled_runs):
    cfg, calib, stack, data, static, field = tiled_runs
    tcfg = DeconvolutionConfig(**dict(CFG, max_iter=10))
    got = tiled_deconvolve(data, torch.tensor(stack), tile=TILE, overlap=OVERLAP, config=tcfg, depthvar_anchors=ZS,
                           device="cpu")
    assert got.shape == VOLUME and _rel(got, static) < X_REL
    model = model_for(family_config_from_fields(cfg), device="cpu")
    fn = field_depthvar_psf(model, [(pos, params_to_torch(p)) for pos, p in calib], ZS)
    got = tiled_deconvolve(data, fn, tile=TILE, overlap=OVERLAP, config=tcfg, depthvar_anchors=ZS, device="cpu")
    assert _rel(got, field) < X_REL
    with pytest.raises(ValueError, match="vmlmb path"):
        tiled_deconvolve(data, torch.tensor(stack), tile=TILE, config=tcfg, depthvar_anchors=ZS, method="rl",
                         device="cpu")
    with pytest.raises(ValueError, match=r"\(K, \.\.\.\) anchor stack"):
        tiled_deconvolve(data, torch.tensor(stack[0]), tile=TILE, overlap=OVERLAP, config=tcfg, depthvar_anchors=ZS,
                         device="cpu")


# The depth-varying fits, the blind loop and the depth ladder, on a
# Gibson-Lanni model at plane-0 depth 0 (the JAX tests' optics).
FIT_SHAPE = (12, 16, 16)
FIT_OPTICS = dict(na=1.3, wavelength=500e-9, ni=1.518, dxy=100e-9, dz=250e-9, n_phase=3, ns=1.36, depth=0.0,
                  dtype=jnp.float64)
FIT_ANCHORS = np.array([0.0, 5.5, 11.0])
LADDER_Z = np.array([0.0, 5.5, 11.0])
NS_TRUE, NS_START = 1.36, 1.45
UNC_RTOL = 1e-8


def _fit_scene(phase=(0.2, -0.1, 0.05), seed=11):
    """Sparse beads under the depth-varying blur of ``phase`` at
    FIT_ANCHORS, 1% noise; the JAX config and the port's model."""
    cfg = JaxGLConfig(shape=FIT_SHAPE, **FIT_OPTICS)
    p = cfg.init_params()._replace(phase=jnp.asarray(phase))
    stack = jax_anchor_psfs(cfg, p, FIT_ANCHORS, depth0=0.0)
    rng = np.random.default_rng(seed)
    obj = rng.random(FIT_SHAPE) * (rng.random(FIT_SHAPE) > 0.9) * 100 + 1.0
    data = np.asarray(JaxDepthCost.build(stack, jnp.asarray(obj), anchors=FIT_ANCHORS).model(jnp.asarray(obj)))
    data = data + 0.01 * data.max() * rng.standard_normal(FIT_SHAPE)
    return cfg, model_for(family_config_from_fields(cfg), device="cpu"), obj, data


def _ladder_beads(seed=13):
    """Beads at LADDER_Z planes under the true sample index, x2e4, with a
    background of 10 and unit noise (``tests/test_depthvar.py:273``)."""
    cfg = JaxGLConfig(shape=FIT_SHAPE, **FIT_OPTICS)
    p = cfg.init_params()._replace(depth=jnp.asarray([NS_TRUE / 500e-9, 0.0]))
    rng = np.random.default_rng(seed)
    return cfg, p, np.stack([2e4 * np.asarray(cfg.compute_psf(p._replace(depth=jnp.asarray([NS_TRUE / 500e-9,
                                                                                             z * cfg.dz]))))
                             + 10.0 + rng.standard_normal(FIT_SHAPE) for z in LADDER_Z])


# name: (families, keyword arguments) of fit_psf_depthvar; "prior" pulls the
# phase toward PRIOR_ANCHOR, "bead" adds a bead anchor term.
DV_FITS = {
    "phase_prior_bead": ((PHASE,), dict(phase_prior_weight=1e-2, bead=10.0)),
    "phase_active": ((PHASE,), dict(phase_active=2, phase_freeze_head=1)),
    "joint_defocus_depth": ((DEFOCUS, DEPTH), dict()),
}
PRIOR_ANCHOR = [0.15, -0.05, 0.0]


def _dv_fit(pkg_fit, cfg_or_model, p0, obj, data, bead_term, flags, kw, config):
    kw = dict(kw)
    weight = kw.pop("bead", None)
    if weight is not None:
        kw["aux_terms"] = ((bead_term, weight),)
    return pkg_fit(cfg_or_model, p0, flags, data, obj, FIT_ANCHORS, config=config, **kw)


@pytest.fixture(scope="module")
def dv_runs():
    """The JAX depth-varying fits, ladder, ladder error bars and blind
    loops of this file, once."""
    from microtipi_tpu.jobs import depthvar as jdv
    from microtipi_tpu.jobs.psf_fit import PsfFitConfig as JaxFitConfig
    from microtipi_tpu.jobs.psf_fit import bead_anchor_term as jax_bead_term

    cfg, model, obj, data = _fit_scene()
    bead = 300.0 * np.asarray(cfg.compute_psf(cfg.init_params()._replace(phase=jnp.asarray([0.2, -0.1, 0.05])))) + 1.0
    out = {}
    start = {"joint_defocus_depth": cfg.init_params()._replace(depth=jnp.asarray([1.40 / 500e-9, 0.0]))}
    for name, (flags, kw) in DV_FITS.items():
        p0 = start.get(name, cfg.init_params()._replace(phase=jnp.asarray(PRIOR_ANCHOR)))
        res = _dv_fit(jdv.fit_psf_depthvar, cfg, p0, jnp.asarray(obj), jnp.asarray(data),
                      jax_bead_term(cfg, jnp.asarray(bead)), flags, kw, JaxFitConfig(max_iter=15, grtol=0.0))
        out[name] = (p0, {k: np.asarray(v) for k, v in res.params._asdict().items()}, float(res.f),
                     np.asarray(res.f_history))
    lcfg, p_true, beads = _ladder_beads()
    p0 = p_true._replace(depth=jnp.asarray([NS_START / 500e-9, 0.0]))
    fit, zs = jdv.calibrate_depth(lcfg, jnp.asarray(beads), LADDER_Z, families=(DEPTH,), params0=p0,
                                  config=JaxFitConfig(max_iter=50, grtol=0.0))
    unc = jdv.ladder_fit_uncertainty(lcfg, fit.params, (DEPTH,), jnp.asarray(beads), LADDER_Z, zs)
    out["ladder"] = (p0, fit, np.asarray(zs), unc)
    for name, case in DV_BLIND.items():
        res = jdv.blind_deconvolve_depthvar(jnp.asarray(data), cfg, FIT_ANCHORS, **_dv_blind_args(cfg, bead, case,
                                                                                                   jax_side=True))
        out["blind_" + name] = res
    return cfg, model, obj, data, bead, beads, out


@pytest.mark.parametrize("name", list(DV_FITS))
def test_fit_psf_depthvar_matches_jax(name, dv_runs):
    """f at the start (the prior and bead term before a step) to 1e-10; the
    fit's params and f to 1e-5."""
    from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig, bead_anchor_term

    cfg, model, obj, data, bead, _, out = dv_runs
    p0, params, f, f_history = out[name]
    flags, kw = DV_FITS[name]
    res = _dv_fit(tdepthvar.fit_psf_depthvar, model, params_to_torch(p0), torch.tensor(obj), torch.tensor(data),
                  bead_anchor_term(model, torch.tensor(bead)), flags, kw, PsfFitConfig(max_iter=15, grtol=0.0))
    assert abs(res.f_history[0] - f_history[0]) / f_history[0] < OP_RTOL
    assert abs(float(res.f) - f) / f < X_REL
    for k, v in params.items():  # an unfitted family is equal, zero or not
        assert np.linalg.norm(getattr(res.params, k).numpy() - v) <= X_REL * np.linalg.norm(v), k
    if name == "joint_defocus_depth":  # the sample index moves toward the truth from 1.40
        assert abs(float(res.params.depth[0]) * 500e-9 - 1.36) < 0.04 / 4


def test_cyclic_shift_z_matches_jax():
    from microtipi_tpu.jobs.depthvar import _cyclic_shift_z as jax_shift

    h = np.random.default_rng(12).random(FIT_SHAPE)
    for s in (0.0, 2.3, -5.7, 12.0):
        want = np.asarray(jax_shift(jnp.asarray(h), s, jnp.complex128))
        assert _rel(tdepthvar._cyclic_shift_z(torch.tensor(h), s, torch.complex128), want) < OP_RTOL
    stack = np.stack([h, h[::-1].copy()])
    got = tdepthvar._cyclic_shift_z(torch.tensor(stack), torch.tensor([2.3, -5.7], dtype=torch.float64),
                                 torch.complex128)
    for b, s in enumerate((2.3, -5.7)):
        assert _rel(got[b], jax_shift(jnp.asarray(stack[b]), s, jnp.complex128)) < OP_RTOL
    np.testing.assert_allclose(tdepthvar._cyclic_shift_z(torch.tensor(h), 3.0, torch.complex128).numpy(),
                               np.roll(h, 3, axis=0), atol=1e-12)


def test_calibrate_depth_matches_jax(dv_runs):
    """The ladder's cost at the start (its zshift start included) to 1e-10,
    the fitted index, d0 and shifts and f to 1e-5; ns is recovered."""
    from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig

    cfg, _, _, _, _, beads, out = dv_runs
    p0, fit_j, zs_j, _ = out["ladder"]
    model = model_for(family_config_from_fields(cfg), device="cpu")
    fit, zs = tdepthvar.calibrate_depth(model, torch.tensor(beads), LADDER_Z, families=(DEPTH,),
                                        params0=params_to_torch(p0), config=PsfFitConfig(max_iter=50, grtol=0.0))
    fh = np.asarray(fit_j.f_history)
    assert abs(fit.f_history[0] - fh[0]) / fh[0] < OP_RTOL
    assert abs(float(fit.f) - float(fit_j.f)) / float(fit_j.f) < X_REL
    assert _rel(fit.params.depth, fit_j.params.depth) < X_REL and _rel(zs, zs_j) < X_REL
    assert abs(float(fit.params.depth[0]) * 500e-9 - NS_TRUE) < 5e-3
    with pytest.raises(ValueError, match="include it"):
        tdepthvar.calibrate_depth(model, torch.tensor(beads), LADDER_Z, families=(PHASE,))
    with pytest.raises(ValueError, match="one z position per bead"):
        tdepthvar.calibrate_depth(model, torch.tensor(beads), LADDER_Z[:2])


def test_ladder_fit_uncertainty_matches_jax(dv_runs):
    cfg, _, _, _, _, beads, out = dv_runs
    _, fit_j, zs_j, unc = out["ladder"]
    model = model_for(family_config_from_fields(cfg), device="cpu")
    got = tdepthvar.ladder_fit_uncertainty(model, params_to_torch(fit_j.params), (DEPTH,), torch.tensor(beads),
                                           LADDER_Z, torch.tensor(zs_j))
    assert set(got.std) == {"depth", "zshift", "amp", "background"}
    for k in got.std:
        assert _rel(got.std[k], unc.std[k]) < UNC_RTOL, k
    assert _rel(got.cov, unc.cov) < UNC_RTOL and abs(float(got.sigma) - float(unc.sigma)) / float(unc.sigma) < UNC_RTOL


# name: the depth-varying blind loop's options
DV_BLIND = {"prior_bead": dict(joint_fit=False, phase_prior_weight=1e-2, params0=True, bead_weight=10.0, bead=True)}


def _dv_blind_args(cfg, bead, case, jax_side):
    """The keyword arguments of blind_deconvolve_depthvar for ``case``:
    3 rounds of 4 object iterations, DEFOCUS and PHASE fits of 4."""
    from microtipi_tpu.jobs.blind import BlindDeconvConfig as JaxBlindConfig
    from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig

    case = dict(case)
    use_prior, use_bead = case.pop("params0", False), case.pop("bead", False)
    fields = dict(loops=3, families=(DEFOCUS, PHASE), psf_max_iter=(4, 4), **case)
    dcfg = dict(mu=1e-3, epsilon=1.0, max_iter=4, grtol=0.0)
    p0 = cfg.init_params()._replace(phase=jnp.asarray(PRIOR_ANCHOR)) if use_prior else None
    if jax_side:
        return dict(params0=p0, bead_data=jnp.asarray(bead) if use_bead else None,
                    config=JaxBlindConfig(deconv=JaxDeconvConfig(**dcfg), **fields))
    return dict(params0=None if p0 is None else params_to_torch(p0),
                bead_data=torch.tensor(bead) if use_bead else None,
                config=BlindDeconvConfig(deconv=DeconvolutionConfig(**dcfg), **fields))


@pytest.mark.parametrize("name", list(DV_BLIND))
def test_blind_deconvolve_depthvar_matches_jax(name, dv_runs):
    """3 rounds with the calibration prior and a bead anchor, sequential
    fits: params, every round's f and the object to 1e-5; the loop refuses
    ADMM, a fit window and a model without DEPTH."""
    from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig
    from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig

    cfg, model, _, data, bead, _, out = dv_runs
    want = out["blind_" + name]
    got = tdepthvar.blind_deconvolve_depthvar(torch.tensor(data), model, FIT_ANCHORS,
                                              **_dv_blind_args(cfg, bead, DV_BLIND[name], jax_side=False))
    for k in ("defocus", "phase", "depth"):
        assert _rel(getattr(got.params, k), getattr(want.params, k)) < X_REL, k
    wd, wf = np.asarray(want.deconv_f), np.asarray(want.fit_f)
    assert np.max(np.abs(got.deconv_f - wd) / wd) < X_REL
    np.testing.assert_array_equal(np.isnan(got.fit_f), np.isnan(wf))
    ok = ~np.isnan(wf)
    assert np.max(np.abs(got.fit_f[ok] - wf[ok]) / wf[ok]) < X_REL
    assert got.psf.shape == (3, *FIT_SHAPE) and _rel(got.obj, want.obj) < X_REL and _rel(got.psf, want.psf) < X_REL
    if name == "prior_bead":
        for bad, match in ((dict(deconv_engine="admm"), "circulant"),
                           (dict(fit=PsfFitConfig(fit_window=(12, 8, 8))), "fit_window")):
            with pytest.raises(ValueError, match=match):
                tdepthvar.blind_deconvolve_depthvar(torch.tensor(data), model, 3, config=BlindDeconvConfig(**bad))
        wmodel = model_for(family_config_from_fields(JaxConfig(shape=FIT_SHAPE, **{
            k: v for k, v in FIT_OPTICS.items() if k not in ("ns", "depth")})), device="cpu")
        with pytest.raises(ValueError, match="DEPTH family"):
            tdepthvar.blind_deconvolve_depthvar(torch.tensor(data), wmodel, 3)


def test_blind_deconvolve_depthvar_phase_anchor_matches_jax():
    """``phase_anchor``: the calibration prior pulls the phase toward an
    anchor other than ``params0``'s phase, 2 rounds on SHAPE against the JAX
    loop given the same anchor (params, every round's f and the object to
    1e-5); the anchor moves the result away from the default's."""
    from microtipi_tpu.jobs.blind import BlindDeconvConfig as JaxBlindConfig
    from microtipi_tpu.jobs.depthvar import blind_deconvolve_depthvar as jax_blind_depthvar
    from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig

    cfg, _, model, _ = _gl()
    _, _, data = _scenes(1, seed=5)
    anchor = [0.3, -0.2, 0.0, 0.1]
    fields = dict(loops=2, families=(DEFOCUS, PHASE), psf_max_iter=(3, 3), phase_prior_weight=0.1)
    dcfg = dict(mu=1e-3, epsilon=1.0, max_iter=4, grtol=0.0)
    want = jax_blind_depthvar(jnp.asarray(data[0]), cfg, ANCHORS, phase_anchor=jnp.asarray(anchor),
                              config=JaxBlindConfig(deconv=JaxDeconvConfig(**dcfg), **fields))
    tcfg = BlindDeconvConfig(deconv=DeconvolutionConfig(**dcfg), **fields)
    got = tdepthvar.blind_deconvolve_depthvar(torch.tensor(data[0]), model, ANCHORS, phase_anchor=torch.tensor(anchor),
                                              config=tcfg)
    for k in ("defocus", "phase", "depth"):
        assert _rel(getattr(got.params, k), getattr(want.params, k)) < X_REL, k
    wd, wf = np.asarray(want.deconv_f), np.asarray(want.fit_f)
    assert np.max(np.abs(got.deconv_f - wd) / wd) < X_REL
    ok = ~np.isnan(wf)
    np.testing.assert_array_equal(np.isnan(got.fit_f), ~ok)
    assert np.max(np.abs(got.fit_f[ok] - wf[ok]) / wf[ok]) < X_REL
    assert _rel(got.obj, want.obj) < X_REL
    default = tdepthvar.blind_deconvolve_depthvar(torch.tensor(data[0]), model, ANCHORS, config=tcfg)
    assert _rel(default.params.phase, got.params.phase) > 1e3 * X_REL
