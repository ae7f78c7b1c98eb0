"""Every PSF family of the port against the JAX package on the CPU (float64):
``compute_psf`` and its gradient with respect to every family, the Gibson-
Lanni depth stack, the ISM element PSFs, the STED depletion beam and the tie
at zeta = 0, pupil-map synthesis and the MTF, ``fit_psf`` of the DEPTH,
SHEET, STED and CAVITY families, the blind loop with a confocal model, and
the ``convert.py`` round trip of every params type and family config. Inputs come from numpy with a seed and feed
both packages.

Tolerances: PSFs, pupil-map PSFs, MTFs and depletion beams to 1e-10 of their
maximum and gradients to 1e-10 relative per family (both packages compute
the same float64 arithmetic up to FFT and summation order, ~1e-14 measured);
the fits' cost histories to 1e-10 relative over the iterations both ran and
the fitted family to 1e-5 relative, the BASELINE.json fidelity bar: each fit
ends in the flat bottom of its cost, where float64 round-off decides when the
line search gives up and moves the parameters by ~1e-7 relative."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.jobs.blind import BlindDeconvConfig as JaxBlindConfig
from microtipi_tpu.jobs.blind import blind_deconvolve as jax_blind
from microtipi_tpu.jobs.deconv import DeconvolutionConfig as JaxDeconvConfig
from microtipi_tpu.jobs.psf_fit import PsfFitConfig as JaxFitConfig
from microtipi_tpu.jobs.psf_fit import fit_psf as jax_fit_psf
from microtipi_tpu.models import confocal as jconf
from microtipi_tpu.models import fourpi as jfourpi
from microtipi_tpu.models import gibson_lanni as jgl
from microtipi_tpu.models import ism as jism
from microtipi_tpu.models import lightsheet as jls
from microtipi_tpu.models import sted as jsted
from microtipi_tpu.models import vectorial as jvec
from microtipi_tpu.models import widefield as jwf
from microtipi_tpu.ops.convolution import convolve, convolve_spectrum
from microtipi_tpu_torch import models as tmodels
from microtipi_tpu_torch.convert import family_config_from_fields, params_to_numpy, params_to_torch
from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig, blind_deconvolve
from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig, fit_psf
from microtipi_tpu_torch.models.microscope import (
    CAVITY,
    DEFOCUS,
    DEPTH,
    FAMILY_NAMES,
    PHASE,
    SHEET,
    STED,
    family_name,
)

SHAPE = (8, 32, 32)
OPTICS = dict(shape=SHAPE, na=1.4, wavelength=561e-9, ni=1.518, dxy=80e-9, dz=200e-9, n_phase=6, n_modulus=3,
              dtype=jnp.float64)
SHEET_OPTICS = dict(OPTICS, na=0.8, ni=1.33, dxy=150e-9, dz=400e-9, wavelength=520e-9)
RTOL = 1e-10

# Each family: its JAX config and the values of its extension family in the
# test's params (None: the wide-field families only).
FAMILIES = {
    "widefield": (jwf.WideFieldConfig(**OPTICS), None),
    "gibson_lanni": (jgl.GibsonLanniConfig(ns=1.38, depth=8e-6, **OPTICS),
                     lambda c: [1.01 * c.ns / c.wavelength, 6e-6]),
    "confocal": (jconf.ConfocalConfig(wavelength_exc=488e-9, **OPTICS), None),
    "confocal_pinhole": (jconf.ConfocalConfig(wavelength_exc=488e-9, pinhole=150e-9, **OPTICS), None),
    "two_photon": (jconf.TwoPhotonConfig(**dict(OPTICS, wavelength=920e-9)), None),
    "vectorial": (jvec.VectorialConfig(**OPTICS), None),
    "lightsheet": (jls.LightSheetConfig(sheet_na=0.15, wavelength_exc=488e-9, **SHEET_OPTICS),
                   lambda c: [0.3e-6, 1.1 * c.waist]),
    "lightsheet_thin": (jls.LightSheetConfig(sheet_na=0.15, divergence=False, **SHEET_OPTICS),
                        lambda c: [-0.2e-6, 0.9 * c.waist]),
    "bessel": (jls.StructuredSheetConfig(wavelength_exc=488e-9, sheet_samples=48, **SHEET_OPTICS),
               lambda c: [0.1e-6, 1.05]),
    "lattice": (jls.StructuredSheetConfig(sheet_mode="lattice", lattice_ky=(0.0, 0.5), sheet_samples=48,
                                          **SHEET_OPTICS), lambda c: [-0.1e-6, 0.97]),
    "ism": (jism.ISMConfig(wavelength_exc=488e-9, pinhole=40e-9, element_pitch=60e-9, rings=1, **OPTICS), None),
    "fourpi_a": (jfourpi.FourPiConfig(fourpi_type="A", wavelength_exc=488e-9, pinhole=150e-9, **OPTICS),
                 lambda c: [0.3]),
    "fourpi_c": (jfourpi.FourPiConfig(fourpi_type="C", **OPTICS), lambda c: [-0.4]),
    "sted_donut": (jsted.STEDConfig(wavelength_exc=488e-9, wavelength_dep=775e-9, pinhole=100e-9, **OPTICS),
                   lambda c: [3.0]),
    "sted_bottle": (jsted.STEDConfig(depletion="bottle", wavelength_dep=660e-9, **OPTICS), lambda c: [2.0]),
}
EXTRA = {"gibson_lanni": "depth", "lightsheet": "sheet", "lightsheet_thin": "sheet", "bessel": "sheet",
         "lattice": "sheet", "fourpi_a": "cavity", "fourpi_c": "cavity", "sted_donut": "sted", "sted_bottle": "sted"}


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
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _jax_params(name, seed=0):
    """Random wide-field families and the extension family's test values."""
    cfg, extra = FAMILIES[name]
    rng = np.random.default_rng(seed)
    p = cfg.init_params()._replace(
        phase=jnp.asarray(0.2 * rng.standard_normal(cfg.n_phase)),
        modulus=jnp.asarray(np.r_[1.0, 0.1 * rng.standard_normal(cfg.n_modulus - 1)]),
        defocus=jnp.asarray([cfg.ni / cfg.wavelength * 1.002, 1e4, -2e4]),
    )
    return p if extra is None else p._replace(**{EXTRA[name]: jnp.asarray(extra(cfg), jnp.float64)})


def _port(name, seed=0):
    cfg, _ = FAMILIES[name]
    jp = _jax_params(name, seed)
    return cfg, jp, tmodels.model_for(family_config_from_fields(cfg), device="cpu"), params_to_torch(jp)


@pytest.fixture(scope="module")
def jax_refs():
    """Each family's JAX PSF and the gradient of sum(psf * w) with respect
    to every family, from one jitted vjp a family."""
    w = np.random.default_rng(2).random(SHAPE)
    out = {}
    for name, (cfg, _) in FAMILIES.items():
        psf, vjp = jax.vjp(jax.jit(cfg.compute_psf), _jax_params(name))
        out[name] = (np.asarray(psf), {k: np.asarray(v) for k, v in vjp(jnp.asarray(w))[0]._asdict().items()})
    return w, out


@pytest.mark.parametrize("name", list(FAMILIES))
def test_psf_and_gradients_match_jax(name, jax_refs):
    w, refs = jax_refs
    want_psf, want_grads = refs[name]
    _, _, model, tp = _port(name)
    tq = tp._replace(**{k: v.clone().requires_grad_() for k, v in tp._asdict().items()})
    psf = model.compute_psf(tq)
    assert tuple(psf.shape) == SHAPE and _rel(psf.detach(), want_psf) < RTOL
    torch.sum(psf * torch.tensor(w)).backward()
    assert set(want_grads) == set(tq._fields)
    for field, want in want_grads.items():
        got = getattr(tq, field).grad.numpy()
        assert np.max(np.abs(want)) > 0, field
        assert _rel(got, want) < RTOL, field


def test_gibson_lanni_depth_stack_is_the_psf_at_each_depth():
    """One batched synthesis over K depths gives, plane for plane, the PSF
    with ``depth[1]`` set to each depth, bitwise, and the JAX package's."""
    cfg, jp, model, tp = _port("gibson_lanni")
    depths = np.array([2e-6, 5e-6, 9e-6, 14e-6])
    stack = model.compute_depth_psfs(tp, torch.tensor(depths))
    for k, d in enumerate(depths):
        one = model.compute_psf(tp._replace(depth=torch.tensor([float(tp.depth[0]), d])))
        assert torch.equal(stack[k], one)
        want = cfg.compute_psf(jp._replace(depth=jp.depth.at[1].set(d)))
        assert _rel(stack[k], want) < RTOL


def test_ism_element_psfs_and_sted_depletion_match_jax():
    cfg, jp, model, tp = _port("ism")
    want = np.asarray(cfg.compute_psfs(jp))
    got = model.compute_psfs(tp)
    assert got.shape == want.shape == (7, *SHAPE) and _rel(got, want) < RTOL
    for name in ("sted_donut", "sted_bottle"):
        cfg, jp, model, tp = _port(name)
        dep = model.depletion_intensity(tp)
        assert _rel(dep, cfg.depletion_intensity(jp)) < RTOL and float(dep.max()) == 1.0


def test_sted_tie_at_zero_saturation():
    """zeta = 0 is the default start and sits exactly at the tie of
    max(zeta, 0): torch.maximum gives the gradient jnp.maximum gives (half
    of it), where torch.clamp would give all of it."""
    jcfg = FAMILIES["sted_donut"][0]
    model = tmodels.model_for(family_config_from_fields(jcfg), device="cpu")
    w = np.random.default_rng(3).random(SHAPE)
    jp = jcfg.init_params()
    assert jcfg.saturation == 0.0
    want = jax.grad(lambda p: jnp.sum(jcfg.compute_psf(p) * w))(jp).sted
    tp = params_to_torch(jp)
    assert float(tp.sted[0]) == 0.0
    tq = tp._replace(sted=tp.sted.clone().requires_grad_())
    torch.sum(model.compute_psf(tq) * torch.tensor(w)).backward()
    assert float(want[0]) != 0.0 and _rel(tq.sted.grad, want) < RTOL
    # on the physical side of the tie the gradient doubles
    above = jp._replace(sted=jnp.asarray([1e-300]))
    full = jax.grad(lambda p: jnp.sum(jcfg.compute_psf(p) * w))(above).sted
    assert float(full[0]) == pytest.approx(2.0 * float(want[0]), rel=1e-9)


def test_pupil_maps_and_mtf_match_jax():
    """compute_psf_from_pupil, one map or a stack of K with per-map
    defocus, and compute_mtf."""
    cfg, jp, model, tp = _port("widefield")
    rng = np.random.default_rng(4)
    phis = 0.3 * rng.standard_normal((3, 32, 32))
    rhos = 1.0 + 0.1 * rng.standard_normal((3, 32, 32))
    defocus = np.array([[cfg.ni / cfg.wavelength, 0.0, 0.0], [cfg.ni / cfg.wavelength, 1e4, 0.0],
                        [cfg.ni / cfg.wavelength * 1.001, 0.0, -1e4]])
    want = [np.asarray(cfg.compute_psf_from_pupil(jnp.asarray(p), rho=jnp.asarray(r), defocus=jnp.asarray(d)))
            for p, r, d in zip(phis, rhos, defocus)]
    got = model.compute_psf_from_pupil(torch.tensor(phis), rho=torch.tensor(rhos), defocus=torch.tensor(defocus))
    assert all(_rel(g, w) < RTOL for g, w in zip(got, want))
    flat = model.compute_psf_from_pupil(torch.tensor(phis[0]))
    assert _rel(flat, cfg.compute_psf_from_pupil(jnp.asarray(phis[0]))) < RTOL
    mtf, want_mtf = model.compute_mtf(tp).numpy(), np.asarray(cfg.compute_mtf(jp))
    assert mtf.dtype == np.complex128 and _rel(mtf, want_mtf) < RTOL


# Each fit: the family's model, the flag, the start (the truth's values
# times these), the fit's options, whether it is preconditioned, and the
# coefficients frozen at the head. The depth fit keeps ns/lambda: with both
# free, the first step of an unscaled search is metres of depth, and the
# backtracking through that aliased landscape turns 1e-14 differences into
# different iterates.
FITS = {
    "depth": ("gibson_lanni", DEPTH, [1.0, 0.5], dict(max_iter=12, grtol=0.0), True, 1),
    "sheet": ("lightsheet", SHEET, [0.0, 0.9], dict(max_iter=12, grtol=0.0), True, 0),
    "sted": ("sted_donut", STED, [0.5], dict(max_iter=12, grtol=0.0), False, 0),
    "cavity": ("fourpi_a", CAVITY, [0.4], dict(max_iter=12, grtol=0.0), False, 0),
}


@pytest.fixture(scope="module")
def fit_problems():
    """Each fit's data (a sparse object blurred by the true PSF, with 1%
    Gaussian noise, so that the optimum's cost stands far above the float64
    round-off where the two packages' searches would part), its start and the
    JAX fit."""
    out = {}
    for key, (name, flag, factors, opts, precondition, head) in FITS.items():
        cfg, truth = FAMILIES[name][0], _jax_params(name, seed=5)
        rng = np.random.default_rng(6)
        obj = rng.random(SHAPE) * (rng.random(SHAPE) > 0.98) * 100
        data = np.asarray(convolve(jnp.asarray(obj), convolve_spectrum(cfg.compute_psf(truth)), SHAPE))
        data = data + 0.01 * data.max() * rng.standard_normal(SHAPE)
        field = FAMILY_NAMES[flag]
        start = truth._replace(**{field: getattr(truth, field) * jnp.asarray(factors)})
        res = jax_fit_psf(cfg, start, flag, jnp.asarray(data), jnp.asarray(obj), config=JaxFitConfig(**opts),
                          precondition=precondition, freeze_head=head)
        out[key] = (obj, data, start, truth, res)
    return out


@pytest.mark.parametrize("key", list(FITS))
def test_fit_psf_of_extension_families_matches_jax(key, fit_problems):
    name, flag, _, opts, precondition, head = FITS[key]
    obj, data, start, truth, want = fit_problems[key]
    _, _, model, _ = _port(name)
    got = fit_psf(model, params_to_torch(start), flag, torch.tensor(data), torch.tensor(obj),
                  config=PsfFitConfig(**opts), precondition=precondition, freeze_head=head)
    field = family_name(flag)
    fitted, want_v = getattr(got.params, field).numpy(), np.asarray(getattr(want.params, field))
    n = min(got.iterations, int(want.iterations)) + 1
    want_f = np.asarray(want.f_history)
    assert n > 3 and np.max(np.abs(got.f_history[:n] - want_f[:n]) / want_f[:n]) < 1e-10
    assert abs(float(got.f) - float(want.f)) / float(want.f) < 1e-10
    assert np.max(np.abs(fitted - want_v) / np.abs(want_v)) < 1e-5
    # and the fit went toward the truth
    true_v, start_v = np.asarray(getattr(truth, field)), np.asarray(getattr(start, field))
    assert np.linalg.norm(fitted - true_v) < 0.5 * np.linalg.norm(start_v - true_v)


def test_blind_loop_drives_a_confocal_model_like_jax():
    """``blind_deconvolve`` with a ``ConfocalModel`` (pinhole, two pupils)
    against the JAX loop with its config, 2 rounds of a joint defocus+phase
    fit: deconv_f, fit_f and the fitted params to 1e-6 relative, the bound of
    tests/test_torch_slice.py's wide-field blind test."""
    cfg, truth = FAMILIES["confocal_pinhole"][0], _jax_params("confocal_pinhole", seed=7)
    rng = np.random.default_rng(8)
    obj = rng.random(SHAPE) * (rng.random(SHAPE) > 0.98) * 100
    data = np.asarray(convolve(jnp.asarray(obj), convolve_spectrum(cfg.compute_psf(truth)), SHAPE))
    data = data + 0.01 * data.max() * rng.standard_normal(SHAPE)
    kw = dict(loops=2, families=(DEFOCUS, PHASE), psf_max_iter=(5, 5), joint_fit=True)
    dk = dict(mu=0.01, epsilon=1.0, max_iter=5, grtol=0.0, gatol=0.0)
    want = jax_blind(jnp.asarray(data), cfg, config=JaxBlindConfig(**kw, deconv=JaxDeconvConfig(**dk),
                                                                   fit=JaxFitConfig(grtol=0.0)))
    model = tmodels.model_for(family_config_from_fields(cfg), device="cpu")
    got = blind_deconvolve(torch.tensor(data), model, config=BlindDeconvConfig(
        **kw, deconv=DeconvolutionConfig(**dk), fit=PsfFitConfig(grtol=0.0)))
    np.testing.assert_allclose(got.deconv_f, np.asarray(want.deconv_f), rtol=1e-6)
    assert np.isnan(got.fit_f[-1]).all() and np.isfinite(got.fit_f[:-1]).all()
    np.testing.assert_allclose(got.fit_f, np.asarray(want.fit_f), rtol=1e-6)
    for name in ("defocus", "phase"):
        g, w = getattr(got.params, name).numpy(), np.asarray(getattr(want.params, name))
        assert np.max(np.abs(g - w)) / np.max(np.abs(w)) < 1e-6, name


def test_family_name_takes_every_family():
    assert [family_name(f) for f in sorted(FAMILY_NAMES)] == list(FAMILY_NAMES.values())
    with pytest.raises(ValueError, match="unknown parameter family"):
        family_name(7)


@pytest.mark.parametrize("name", ["widefield", "gibson_lanni", "lightsheet", "fourpi_c", "sted_bottle"])
def test_convert_round_trip(name):
    """Every params type converts both ways with its extension family, and
    every family config maps onto the port's config of the same class name
    and back onto the JAX one, field for field."""
    cfg, jp, model, tp = _port(name)
    assert type(tp).__name__ == type(jp).__name__ and tp._fields == jp._fields
    back = type(jp)(**params_to_numpy(tp))
    for a, b in zip(back, jp):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    pcfg = family_config_from_fields(cfg)
    fields = {f.name: getattr(pcfg, f.name) for f in dataclasses.fields(pcfg) if f.name != "dtype"}
    assert type(cfg)(**fields, dtype=cfg.dtype) == cfg
    assert family_config_from_fields(cfg, dtype=torch.float32).dtype == torch.float32
    assert all(b.dtype in (torch.float64, torch.complex128) for b in model.buffers())


@pytest.mark.parametrize("name", ["confocal_pinhole", "vectorial", "bessel", "ism", "sted_donut"])
def test_models_default_to_the_card(name):
    """Without a device every model's buffers, its second pupils' included,
    go to the CUDA card; on a host without one, construction raises."""
    pcfg = family_config_from_fields(FAMILIES[name][0])
    if torch.cuda.is_available():
        assert all(b.device.type == "cuda" for b in tmodels.model_for(pcfg).buffers())
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmodels.model_for(pcfg)
    assert all(b.device.type == "cpu" for b in tmodels.model_for(pcfg, device="cpu").buffers())
