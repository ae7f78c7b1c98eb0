"""The PSF synthesized plane by plane, and the sharded fits that synthesize
each cell's planes on its own device (CPU, float64, one torch thread).

- ``psf_planes`` of any index set of the FFT-layout z axis, put together,
  is ``compute_psf`` bit for bit: wide-field, Gibson-Lanni, and its K
  anchor PSFs (``compute_depth_psfs``);
- ``parallel.psf_fit.sharded_fit_cost`` and the depth-varying fit's cost on
  meshes driven by one process, (1, 4) and (2, 2), one volume or a stack:
  cost and parameter gradient against the dense cost to 1e-12 relative, on
  the model's grid (each cell's planes) and on the padded grid of a ragged
  stack (the whole synthesis, zero-padded and cut); the route each takes;
- every PSF family: ``compute_psf`` and its gradient bit for bit the
  module's composition of whole-volume PSFs, in float32 and float64; its
  sharded fit cost equals its dense one, on each cell's planes; its planes of any index sets, put together (the reductions
  ISM's and STED's planes wait on taken over the whole), are its
  ``compute_psf`` numerator bit for bit, and ``compute_psf`` that numerator
  over its sum; each cell's slabs over the cells' one sum are
  ``compute_psf`` to 1e-13, on the model's grid and a padded one; its fit
  cost and gradient at an aberration are the dense ones on (1, 4) and
  (2, 2); a maximum over the cells splits its gradient over ties as
  ``torch.amax`` does;
- forward mode (``torch.func.jacfwd``) through the replicated pupil;
- ``sharded_fit_psf`` (the wide-field, confocal, light-sheet and STED
  models) and ``sharded_fit_psf_depthvar`` against the JAX module's sharded
  functions on the conftest's virtual devices, to
  ``tests/test_torch_parallel_jobs.py``'s tolerances (P_ABS, F_REL), and a
  confocal blind round against its ``sharded_blind_deconvolve``;
- the sharded loops' object steps fed each cell's planes: a blind round by
  VMLMB and by ADMM, of one volume, a stack on (2, 2) and a ragged stack's
  padded grid, against the same round with the whole PSF cut (to REL), and
  which planes each cell synthesized; a blind round with its fit against
  the JAX module's ``sharded_blind_deconvolve`` (F_REL, X_ABS, P_ABS); the
  depth-varying loop's K anchor PSFs from each cell's planes against its
  whole route, and its round by either route.

Inputs come from numpy with a seed; the JAX references are computed once.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.jobs.blind import BlindDeconvConfig as JaxBlindConfig
from microtipi_tpu.jobs.deconv import DeconvolutionConfig as JaxDeconvConfig
from microtipi_tpu.jobs.psf_fit import PsfFitConfig as JaxFitConfig
from microtipi_tpu.models.confocal import ConfocalConfig as JaxConfocalConfig
from microtipi_tpu.models.gibson_lanni import GibsonLanniConfig as JaxGibsonLanniConfig
from microtipi_tpu.models.lightsheet import LightSheetConfig as JaxLightSheetConfig
from microtipi_tpu.models.sted import STEDConfig as JaxSTEDConfig
from microtipi_tpu.models.widefield import WideFieldConfig as JaxWideFieldConfig
from microtipi_tpu.parallel.blind import sharded_blind_deconvolve as jax_sharded_blind
from microtipi_tpu.parallel.depthvar import sharded_fit_psf_depthvar as jax_sharded_fit_psf_depthvar
from microtipi_tpu.parallel.mesh import make_mesh as jax_make_mesh
from microtipi_tpu.parallel.psf_fit import sharded_fit_psf as jax_sharded_fit_psf
from microtipi_tpu_torch import models as m
from microtipi_tpu_torch.jobs import depthvar as dv
from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig
from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig
from microtipi_tpu_torch.models.microscope import DEFOCUS, PHASE
from microtipi_tpu_torch.models.confocal import _scaled_params
from microtipi_tpu_torch.models.widefield import REDUCTIONS, UnitSumModel, WideFieldModel, WideFieldParams, run_steps
from microtipi_tpu_torch.ops.convolution import convolve, convolve_spectrum
from microtipi_tpu_torch.ops.depthconv import DepthVaryingConvCost
from microtipi_tpu_torch.parallel import blind as pb
from microtipi_tpu_torch.parallel import depthvar as sdv
from microtipi_tpu_torch.parallel import psf_fit as spf
from microtipi_tpu_torch.parallel.mesh import gather, make_mesh, shard
from microtipi_tpu_torch.utils.arrays import pad_fft_kernel
from microtipi_tpu_torch.utils.grids import fft_index, wrapped_z

SHAPE = (8, 16, 16)
KW = dict(na=1.2, wavelength=500e-9, ni=1.33, dxy=100e-9, dz=250e-9, n_phase=3, radial=True)
GL_KW = dict(na=1.4, wavelength=561e-9, ni=1.518, dxy=80e-9, dz=200e-9, n_phase=4, ns=1.38, depth=10e-6)
OPTICS = dict(shape=SHAPE, dtype=torch.float64, na=1.4, wavelength=561e-9, ni=1.518, dxy=80e-9, dz=200e-9, n_phase=4,
              n_modulus=3)
SHEET = dict(OPTICS, na=0.8, ni=1.33, dxy=150e-9, dz=400e-9, wavelength=520e-9)
ANCHORS = np.array([0.0, 3.5, 7.0])
#: Sharded against dense, the same float64 arithmetic summed in another order.
REL = 1e-12
#: ``tests/test_torch_parallel_jobs.py``'s tolerances for the JAX sharded jobs.
F_REL, X_ABS, P_ABS = 1e-8, 1e-6, 1e-7
#: Every family, at SHAPE: the port's config.
FAMILIES = {
    "widefield": m.WideFieldConfig(**OPTICS),
    "gibson_lanni": m.GibsonLanniConfig(ns=1.38, depth=8e-6, **OPTICS),
    "confocal": m.ConfocalConfig(wavelength_exc=488e-9, pinhole=150e-9, **OPTICS),
    "two_photon": m.TwoPhotonConfig(**dict(OPTICS, wavelength=920e-9)),
    "vectorial": m.VectorialConfig(**OPTICS),
    "lightsheet": m.LightSheetConfig(sheet_na=0.15, wavelength_exc=488e-9, **SHEET),
    "bessel": m.StructuredSheetConfig(wavelength_exc=488e-9, sheet_samples=24, **SHEET),
    "ism": m.ISMConfig(wavelength_exc=488e-9, pinhole=40e-9, element_pitch=60e-9, rings=1, **OPTICS),
    "fourpi": m.FourPiConfig(fourpi_type="A", wavelength_exc=488e-9, pinhole=150e-9, **OPTICS),
    "sted": m.STEDConfig(wavelength_exc=488e-9, wavelength_dep=775e-9, pinhole=100e-9, **OPTICS),
}
#: Every family and the variants whose planes are built otherwise: the light sheet without divergence, 4Pi type C
#: (interference in the detection arm too), the STED bottle beam (its depletion peaks off focus).
VARIANTS = {
    **FAMILIES,
    "lightsheet_flat": m.LightSheetConfig(sheet_na=0.15, wavelength_exc=488e-9, divergence=False, **SHEET),
    "fourpi_c": m.FourPiConfig(fourpi_type="C", wavelength_exc=488e-9, cavity_phase=0.3, **OPTICS),
    "sted_bottle": m.STEDConfig(depletion="bottle", wavelength_exc=488e-9, wavelength_dep=660e-9, pinhole=120e-9,
                                saturation=5.0, **OPTICS),
}
#: The families whose sharded fit takes each cell's planes on the model's grid: every one.
PLANE_FAMILIES = set(FAMILIES)
#: The blind rounds: the object step's settings, and a fit round's families.
OBJ_CFG = dict(mu=0.002, epsilon=1.0, grtol=0.0, max_iter=4)
ROUND = dict(families=(DEFOCUS, PHASE), psf_max_iter=(3, 3), joint_fit=True, phase_freeze_head=1, init="wiener")
#: A ragged stack (the models are laterally square) and the grid a (1, 4) loop pads it to.
RAGGED, RAGGED_GRID = (7, 15, 15), (8, 16, 15)
#: The blind rounds' cases: (engine, mesh, the data's shape: a stack of 2 on (2, 2), a ragged stack).
BLIND_CASES = {"vmlmb_1x4": ("vmlmb", (1, 4), SHAPE), "admm_1x4": ("admm", (1, 4), SHAPE),
               "vmlmb_2x2": ("vmlmb", (2, 2), (2, *SHAPE)), "padded_1x4": ("vmlmb", (1, 4), RAGGED)}
#: The rounds held against the JAX module's loop (its ragged stacks: ``tests/test_torch_multiprocess.py``).
JAX_BLIND = ("vmlmb_1x4", "admm_1x4")
#: The families whose sharded fit is held against the JAX module's, and the JAX config class of each.
JAX_FAMILIES = {"confocal": JaxConfocalConfig, "lightsheet": JaxLightSheetConfig, "sted": JaxSTEDConfig}
#: Each cell's slabs of a unit-sum PSF against ``compute_psf``: one sum in another order.
SLAB_REL = 1e-13
#: The CPU's FFT library (MKL) rounds the inverse real 2D transform of a batch of one plane otherwise than the same
#: plane's in a larger batch: a set of one plane of a family that blurs by the pinhole (confocal, 4Pi, STED) is held
#: to this gap relative to the PSF's largest value (measured: 1.6e-17); every other set bit for bit.
ONE_PLANE_REL = 1e-15


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(b, z):
    return make_mesh(b, z, devices=[torch.device("cpu")] * (b * z))


def _widefield(shape=SHAPE):
    return m.WideFieldModel(m.WideFieldConfig(shape=shape, dtype=torch.float64, **KW), device="cpu")


def _gibson_lanni(shape=SHAPE):
    return m.GibsonLanniModel(m.GibsonLanniConfig(shape=shape, dtype=torch.float64, **GL_KW), device="cpu")


def _params(model, seed=0):
    """``model``'s initial params with a seeded aberration and defocus shift."""
    rng = np.random.default_rng(seed)
    p = model.init_params()
    defocus = p.defocus + torch.as_tensor([0.0, *(2e4 * rng.standard_normal(2))])
    return p._replace(defocus=defocus, phase=torch.as_tensor(0.2 * rng.standard_normal(p.phase.shape[0])))


def _volumes(shape, seed=0):
    """(obj, data) on ``shape`` from numpy: a sparse positive object and
    positive data."""
    rng = np.random.default_rng(seed)
    obj = torch.as_tensor((rng.random(shape) > 0.9) * rng.random(shape) * 50.0)
    return obj, torch.as_tensor(rng.random(shape))


@pytest.fixture(scope="module")
def scene():
    """(wide-field model, obj, data blurred by its PSF at a seeded aberration, Gibson-Lanni model)."""
    model = _widefield()
    obj, _ = _volumes(SHAPE)
    with torch.no_grad():
        data = convolve(obj, convolve_spectrum(model.compute_psf(_params(model, 1))), SHAPE)
    data = data + 0.01 * torch.as_tensor(np.random.default_rng(2).standard_normal(SHAPE))
    return model, obj, data, _gibson_lanni()


def _blind_data(scene, shape):
    """The scene's data cut or stacked to ``shape``."""
    data = scene[2]
    if len(shape) == 4:
        return torch.stack([data, 1.1 * data])
    return data[:shape[0], :shape[1], :shape[2]].contiguous()


def _blind_config(engine: str, fit: bool) -> BlindDeconvConfig:
    """One round: the object step, and with ``fit`` the joint fit after it."""
    return BlindDeconvConfig(loops=1, skip_last_fit=not fit, deconv=DeconvolutionConfig(**OBJ_CFG),
                             deconv_engine=engine, **ROUND)


@pytest.fixture(scope="module")
def jax_refs(scene):
    """JAX's sharded PHASE fit and depth-varying DEFOCUS fit on (1, 4), and
    a round of its sharded blind loop with the fit, by VMLMB and by ADMM."""
    model, obj, data, _ = scene
    mesh = jax_make_mesh(1, 4, devices=jax.devices()[:4])
    d, o = jnp.asarray(data.numpy()), jnp.asarray(obj.numpy())
    blind = {}
    for case in JAX_BLIND:
        engine, _, shape = BLIND_CASES[case]
        jb = JaxWideFieldConfig(shape=shape[-3:], dtype=jnp.float64, **KW)
        cfg = JaxBlindConfig(loops=1, skip_last_fit=False, deconv=JaxDeconvConfig(**OBJ_CFG), deconv_engine=engine,
                             **ROUND)
        r = jax.jit(lambda v, jb=jb, cfg=cfg: jax_sharded_blind(v, jb, mesh, config=cfg))(
            jnp.asarray(_blind_data(scene, shape).numpy()))
        blind[case] = {"obj": np.asarray(r.obj), "phase": np.asarray(r.params.phase),
                       "deconv_f": np.asarray(r.deconv_f), "fit_f": np.asarray(r.fit_f), "psf": np.asarray(r.psf)}
    jm = JaxWideFieldConfig(shape=SHAPE, dtype=jnp.float64, **KW)
    fit = jax.jit(lambda d, o: jax_sharded_fit_psf(jm, jm.init_params(), PHASE, d, o, mesh,
                                                   config=JaxFitConfig(max_iter=6, grtol=0.0)))(d, o)
    jg = JaxGibsonLanniConfig(shape=SHAPE, dtype=jnp.float64, **GL_KW)
    dfit = jax.jit(lambda d, o: jax_sharded_fit_psf_depthvar(jg, jg.init_params(), (DEFOCUS,), d, o, mesh, ANCHORS,
                                                             config=JaxFitConfig(max_iter=4, grtol=0.0)))(d, o)
    return {"phase": np.asarray(fit.params.phase), "f": float(fit.f),
            "defocus": np.asarray(dfit.params.defocus), "depthvar_f": float(dfit.f), "blind": blind}


def _spy(model) -> list:
    """The ``planes`` of every ``psf_planes`` call on ``model`` from now on."""
    calls, plain = [], model.psf_planes

    def spy(inputs, planes=slice(None), **field):
        calls.append(planes)
        return plain(inputs, planes, **field)

    model.psf_planes = spy
    return calls


def _value_and_grads(cost, p):
    """``cost(p)`` and its gradient with respect to every field of ``p``."""
    leaves = [t.detach().clone().requires_grad_(True) for t in p]
    f = cost(type(p)(*leaves))
    grads = torch.autograd.grad(f, leaves, allow_unused=True, materialize_grads=True)
    return f.detach(), grads


def _close(got, ref):
    """Cost and gradients, sharded against dense, within REL relative."""
    (f, g), (f0, g0) = got, ref
    assert abs(float(f - f0)) <= REL * abs(float(f0))
    for a, b in zip(g, g0):
        assert float((a - b).abs().max()) <= REL * max(float(b.abs().max()), 1e-300)


def _dense_cost(model, obj, data, shape):
    """The dense fit cost on the grid ``shape`` (the PSF zero-padded to it)."""
    obj_hat = convolve_spectrum(obj)

    def cost(p):
        r = convolve(pad_fft_kernel(model.compute_psf(p), shape), obj_hat, shape) - data
        return 0.5 * (r * r).sum()

    return cost


def _cell_planes(n: int, nz: int, z_size: int) -> list:
    """The model planes each of ``z_size`` cells synthesizes for the PSF of
    ``n`` planes zero-padded in FFT layout to ``nz`` (``pad_fft_kernel`` of
    the plane numbers, -1 a zero plane)."""
    src = (pad_fft_kernel(torch.arange(1.0, n + 1, dtype=torch.float64), (nz,)) - 1).long().tolist()
    step = nz // z_size
    return [[i for i in src[z * step:(z + 1) * step] if i >= 0] for z in range(z_size)]


PLANE_SETS = {
    "slabs": [slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)],
    "one_plane_each": [slice(k, k + 1) for k in range(8)],
    "scattered": [torch.tensor([5, 0, 7]), torch.tensor([2]), torch.tensor([6, 1, 4, 3])],
}


@pytest.mark.parametrize("sets", list(PLANE_SETS))
@pytest.mark.parametrize("kind", ["widefield", "gibson_lanni", "gibson_lanni_anchors"])
def test_planes_put_together_are_compute_psf_bit_for_bit(kind, sets):
    model = _widefield() if kind == "widefield" else _gibson_lanni()
    p = _params(model)
    field = {}
    if kind == "gibson_lanni_anchors":
        field = {"depths": p.depth[1] + torch.as_tensor(ANCHORS * model.config.dz)}
        whole = model.compute_depth_psfs(p, field["depths"])
    else:
        whole = model.compute_psf(p)
    got = torch.empty_like(whole)
    inputs = model.plane_inputs(p)
    for planes in PLANE_SETS[sets]:
        got[..., planes, :, :] = model.psf_planes(inputs, planes, **field)
    assert torch.equal(got, whole)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
def test_sharded_fit_cost_synthesizes_each_cells_planes(mesh_shape, batched, scene):
    """On the model's grid each cell synthesizes its own planes (no whole
    PSF), and the cost and its gradient are the dense ones."""
    model, obj, data, _ = scene
    p = _params(model, 3)
    if batched:
        obj, data = torch.stack([obj, 0.5 * obj]), torch.stack([data, 2.0 * data])
    dense = _dense_cost(model, obj, data, SHAPE)
    ref = _value_and_grads(dense, p)
    spied = _widefield()
    calls = _spy(spied)
    got = _value_and_grads(spf.sharded_fit_cost(spied, data, obj, None, _mesh(*mesh_shape)), p)
    step = SHAPE[0] // mesh_shape[1]
    assert calls == [slice(z * step, (z + 1) * step) for z in range(mesh_shape[1])]  # row 0's cells
    _close(got, ref)


@pytest.mark.parametrize("shapes", [((15, 16, 16), (16, 16, 16)), ((16, 15, 15), (16, 16, 15))])
def test_padded_grid_synthesizes_whole_and_cuts(shapes):
    """A ragged stack's padded grid (a sharded blind loop's when Nz or Ny does
    not divide the mesh): the model's PSF is synthesized whole, zero-padded in
    FFT layout and cut; cost and gradient are the dense ones on that grid."""
    model_shape, grid = shapes
    model = _widefield(model_shape)
    obj, data = _volumes(grid, 4)
    p = _params(model, 5)
    ref = _value_and_grads(_dense_cost(model, obj, data, grid), p)
    calls = _spy(model)
    got = _value_and_grads(spf.sharded_fit_cost(model, data, obj, None, _mesh(1, 4)), p)
    assert calls == [slice(None)]
    _close(got, ref)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_family_sharded_fit_cost_is_the_dense_one(family):
    model = m.model_for(FAMILIES[family], device="cpu")
    assert spf.synthesizes_planes(model, SHAPE) == (family in PLANE_FAMILIES)
    obj, data = _volumes(SHAPE, 6)
    p = model.init_params()
    ref = _value_and_grads(_dense_cost(model, obj, data, SHAPE), p)
    got = _value_and_grads(spf.sharded_fit_cost(model, data, obj, None, _mesh(1, 4)), p)
    _close(got, ref)


def _family(family):
    """The port's model of ``family`` on the CPU and its params with a seeded
    aberration and defocus shift."""
    model = m.model_for(VARIANTS[family], device="cpu")
    p = _params(model, 12)
    return model, p._replace(sted=torch.tensor([3.0], dtype=torch.float64)) if hasattr(p, "sted") else p


def _put_together(model, inputs, sets) -> torch.Tensor:
    """The planes of each of ``sets`` (``model.plane_steps``, run side by
    side), put together; each reduction they wait on is taken over their
    tensors put together, the whole volume's, as ``compute_psf`` takes it."""
    nz = model.shape[0]

    def total(op, parts):
        like = next(iter(parts.values()))
        whole = like.new_empty((*like.shape[:-3], nz, *like.shape[-2:]))
        for k, t in parts.items():
            whole[..., sets[k], :, :] = t
        value = REDUCTIONS[op](whole)
        return {k: value for k in parts}

    got = run_steps({k: model.plane_steps(inputs, planes) for k, planes in enumerate(sets)}, total)
    out = torch.empty((*got[0].shape[:-3], nz, *got[0].shape[-2:]), dtype=got[0].dtype)
    for k, planes in enumerate(sets):
        out[..., planes, :, :] = got[k]
    return out


@pytest.mark.parametrize("sets", list(PLANE_SETS))
@pytest.mark.parametrize("family", list(VARIANTS))
def test_every_familys_planes_put_together_are_its_numerator_bit_for_bit(family, sets):
    """Each family's planes of any index sets, put together (the reductions
    they wait on taken over the whole), are ``psf_planes`` over every plane
    bit for bit, and ``compute_psf`` is that numerator over its sum (a
    unit-sum family) or the numerator itself (see ONE_PLANE_REL)."""
    model, p = _family(family)
    inputs = model.plane_inputs(p)
    whole = model.psf_planes(inputs)
    assert torch.equal(model.compute_psf(p), whole / torch.sum(whole) if isinstance(model, UnitSumModel) else whole)
    got = _put_together(model, inputs, PLANE_SETS[sets])
    one_plane = any(len(_as_list(planes)) == 1 for planes in PLANE_SETS[sets])
    if one_plane and isinstance(model, m.ConfocalModel) and not isinstance(model, m.ISMModel) and \
            model.pinhole_otf is not None:
        assert _rel(got, whole) <= ONE_PLANE_REL
    else:
        assert torch.equal(got, whole)


def _wide(m, p):
    """The wide-field PSF of ``m``'s own pupil at ``p``'s wide-field families."""
    return WideFieldModel.psf_planes(m, WideFieldModel.plane_inputs(m, WideFieldParams(p.defocus, p.phase, p.modulus)))


def _blur(m, h):
    ny, nx = m.shape[1:]
    return h if m.pinhole_otf is None else torch.fft.irfft2(torch.fft.rfft2(h) * m.pinhole_otf, s=(ny, nx))


def _exc(m, p, arm=None):
    """The excitation pupil's PSF from the emission-referred ``p``, or with
    ``arm`` the 4Pi interference of ``arm``'s fields at ``p`` (scaled for the
    excitation arm)."""
    wf = WideFieldParams(p.defocus, p.phase, p.modulus)
    scaled = _scaled_params(wf, m.config.wavelength / m.config.lambda_exc)
    if arm is None:
        return m.exc.compute_psf(scaled)
    rho, phi, psi, _ = arm.compute_pupil(scaled if arm is m.exc else wf)
    e_plus, e_minus = torch.fft.fft2(arm._field_from_pupil(rho, phi, torch.stack([psi, -psi])))
    return arm._intensity(e_plus + torch.exp(1j * p.cavity[0].to(arm.cdtype)) * e_minus)


def _unit(h):
    return h / torch.sum(h)


def _sheet(m, sheet):
    """The light sheet's profile over every plane, (Nz, 1, Nx or 1)."""
    c = m.config
    z = torch.as_tensor(wrapped_z(m.shape[0]) * c.dz, dtype=m.dtype)
    if hasattr(m, "illumination"):  # the structured sheet
        phase = (sheet[1] * m.kz)[:, None] * (z - sheet[0])[None, :]
        e_re, e_im = m.illumination @ torch.cos(phase), m.illumination @ torch.sin(phase)
        s = torch.sum(e_re * e_re + e_im * e_im, dim=0)
        return (s / torch.amax(s))[:, None, None]
    z0, w0 = sheet[0], sheet[1]
    dz2 = (z - z0) ** 2
    if not c.divergence:
        return torch.exp(-2.0 * dz2 / (w0 * w0))[:, None, None]
    xc = torch.as_tensor(fft_index(m.shape[2]) * c.dxy, dtype=m.dtype)
    x_r = (np.pi * c.ni / c.lambda_exc) * w0 * w0
    w2 = w0 * w0 * (1.0 + (xc / x_r) ** 2)
    return (torch.sqrt(w0 * w0 / w2)[None, :] * torch.exp(-2.0 * dz2[:, None] / w2[None, :]))[:, None, :]


def _ism(m, p):
    ny, nx = m.shape[1:]
    h = _exc(m, p)[None] * torch.fft.irfft2(torch.fft.rfft2(_wide(m, p))[None] * m.element_ramps, s=(ny, nx))
    return _unit(torch.sum(torch.fft.irfft2(torch.fft.rfft2(_unit(h)) * m.reassign_ramps, s=(ny, nx)), dim=0))


def _sted(m, p):
    conf = _unit(_exc(m, p) * _blur(m, _wide(m, p)))
    wf = _scaled_params(WideFieldParams(p.defocus, p.phase, p.modulus), m.config.wavelength / m.config.lambda_dep)
    rho, phi, _, _ = m.dep.compute_pupil(wf)
    d = m.dep.compute_psf_from_pupil(phi + m.dep_mask_phase, rho=rho * m.dep_centre, defocus=wf.defocus)
    zeta = torch.maximum(p.sted[0], torch.zeros((), dtype=m.dtype))
    return _unit(conf * torch.exp(-torch.tensor(math.log(2.0), dtype=m.dtype) * zeta * (d / torch.amax(d))))


def _composition(model, p):
    """Each family's PSF as its module composed it before it was a function
    of a plane range: the pupils' PSFs over every plane, combined, over their
    sum (``microtipi_tpu/models/*.py``'s formulas)."""
    if type(model) in (m.WideFieldModel, m.GibsonLanniModel):
        return WideFieldModel.compute_psf(model, p)
    if isinstance(model, m.STEDModel):
        return _sted(model, p)
    if isinstance(model, m.ISMModel):
        return _ism(model, p)
    if isinstance(model, m.FourPiModel):
        h_det = _exc(model, p, model) if model.config.fourpi_type == "C" else _wide(model, p)
        return _unit(_exc(model, p, model.exc) * _blur(model, h_det))
    if isinstance(model, m.ConfocalModel):
        return _unit(_exc(model, p) * _blur(model, _wide(model, p)))
    if isinstance(model, m.TwoPhotonModel):
        h = _wide(model, p)
        return _unit(h * h)
    if isinstance(model, m.VectorialModel):
        wf = WideFieldParams(p.defocus, p.phase, p.modulus)
        a = WideFieldModel.planes_field(model, WideFieldModel.plane_inputs(model, wf))
        fields = torch.fft.fft2(model.vector_factors[:, None] * a[None])
        return _unit(torch.sum(fields.real ** 2 + fields.imag ** 2, dim=0))
    return _unit(_wide(model, p) * _sheet(model, p.sheet))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("family", list(VARIANTS))
def test_every_familys_compute_psf_is_its_composition_bit_for_bit(family, dtype):
    """Every family's ``compute_psf`` and the gradient of a weighted sum of
    it against its module's composition of whole-volume PSFs (the pupils'
    PSFs over every plane, combined and divided by their sum), bit for bit
    in float32 and float64."""
    model = m.model_for(dataclasses.replace(VARIANTS[family], dtype=dtype), device="cpu")
    p = _params(model, 12)
    p = type(p)(*(t.to(dtype) for t in (p._replace(sted=torch.tensor([3.0])) if hasattr(p, "sted") else p)))
    w = torch.as_tensor(np.random.default_rng(17).random(SHAPE), dtype=dtype)
    out = []
    for fn in (type(model).compute_psf, _composition):
        leaves = [t.clone().requires_grad_(True) for t in p]
        psf = fn(model, type(p)(*leaves))
        out.append((psf.detach(), torch.autograd.grad((psf * w).sum(), leaves, allow_unused=True,
                                                      materialize_grads=True)))
    (got, g), (want, g0) = out
    assert torch.equal(got, want) and all(torch.equal(a, b) for a, b in zip(g, g0))


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2), (1, 8)])
@pytest.mark.parametrize("family", list(VARIANTS))
def test_every_familys_cell_slabs_are_compute_psf(family, mesh_shape):
    """Each cell's slab of every family's PSF (``psf_slabs``: its planes over
    the sum of every cell's, the reductions taken over the cells), put
    together, against ``compute_psf`` to SLAB_REL relative; on the model's
    grid and zero-padded in FFT layout to a larger one."""
    model, p = _family(family)
    mesh, whole = _mesh(*mesh_shape), model.compute_psf(p)
    for grid in (SHAPE, (16, 20, 20)):
        got = gather(spf.psf_slabs(model, p, mesh, grid=grid)[0])
        assert _rel(got, pad_fft_kernel(whole, grid)) <= SLAB_REL


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("family", list(VARIANTS))
def test_every_family_fit_cost_at_an_aberration_is_the_dense_one(family, mesh_shape):
    """Each family's sharded fit cost and its gradient, each cell's planes
    over the cells' reductions, at a seeded aberration and defocus shift
    (every family's gradient non-zero) against the dense cost, to REL."""
    model, p = _family(family)
    obj, data = _volumes(SHAPE, 6)
    ref = _value_and_grads(_dense_cost(model, obj, data, SHAPE), p)
    got = _value_and_grads(spf.sharded_fit_cost(model, data, obj, None, _mesh(*mesh_shape)), p)
    _close(got, ref)


def test_the_cells_maximum_splits_its_gradient_over_ties_as_amax_does():
    """A maximum over the cells (STED's depletion peak) reached on planes of
    two cells: its value and its gradient are ``torch.amax``'s over the whole,
    equal shares over every tied element."""
    mesh = _mesh(1, 4)
    x = torch.as_tensor(np.random.default_rng(13).random((8, 3, 3)))
    x[1, 2, 0] = x[6, 0, 1] = x[6, 1, 1] = 2.0
    leaves = [t.clone().requires_grad_(True) for t in x.split(2)]
    peak = spf._cell_total(mesh, "max", dict(zip(mesh.cells(), leaves)), mesh.cells(), mesh.cells())
    grads = torch.autograd.grad(3.0 * peak[(0, 0)], leaves)
    whole = x.clone().requires_grad_(True)
    want = torch.autograd.grad(3.0 * torch.amax(whole), whole)[0]
    assert all(float(v) == 2.0 for v in peak.values()) and torch.equal(torch.cat(grads), want)


def _family_scene(model):
    """(obj, data): a sparse object blurred by ``model``'s PSF at a seeded
    aberration, with 1% noise."""
    obj, _ = _volumes(SHAPE, 14)
    with torch.no_grad():
        data = convolve(obj, convolve_spectrum(model.compute_psf(_params(model, 15))), SHAPE)
    return obj, data + 0.01 * float(data.max()) * torch.as_tensor(np.random.default_rng(16).standard_normal(SHAPE))


def _jax_family(family):
    """The JAX config of the port's ``family`` config, in float64."""
    cfg = FAMILIES[family]
    fields = {f: getattr(cfg, f) for f in cfg.__dataclass_fields__ if f != "dtype"}
    return JAX_FAMILIES[family](**fields, dtype=jnp.float64)


@pytest.fixture(scope="module")
def jax_family_refs():
    """JAX's sharded PHASE fit of each of JAX_FAMILIES on (1, 4), and a round
    of its sharded blind loop (the fit with it) of the confocal model, on
    each family's scene."""
    mesh = jax_make_mesh(1, 4, devices=jax.devices()[:4])
    out = {}
    for family in JAX_FAMILIES:
        obj, data = _family_scene(m.model_for(FAMILIES[family], device="cpu"))
        jm = _jax_family(family)
        fit = jax.jit(lambda d, o, jm=jm: jax_sharded_fit_psf(jm, jm.init_params(), PHASE, d, o, mesh,
                                                              config=JaxFitConfig(max_iter=4, grtol=0.0)))(
            jnp.asarray(data.numpy()), jnp.asarray(obj.numpy()))
        out[family] = {"phase": np.asarray(fit.params.phase), "f": float(fit.f)}
    jm = _jax_family("confocal")
    cfg = JaxBlindConfig(loops=1, skip_last_fit=False, deconv=JaxDeconvConfig(**OBJ_CFG), **ROUND)
    data = _family_scene(m.model_for(FAMILIES["confocal"], device="cpu"))[1]
    r = jax.jit(lambda v: jax_sharded_blind(v, jm, mesh, config=cfg))(jnp.asarray(data.numpy()))
    out["blind"] = {"obj": np.asarray(r.obj), "phase": np.asarray(r.params.phase),
                    "deconv_f": np.asarray(r.deconv_f), "fit_f": np.asarray(r.fit_f), "psf": np.asarray(r.psf)}
    return out


@pytest.mark.parametrize("family", list(JAX_FAMILIES))
def test_family_sharded_fits_match_the_jax_sharded_fit(family, jax_family_refs):
    """The PHASE fit of a family whose PSF is a product of pupils' planes
    over one sum (confocal, light sheet, STED with its depletion peak), each
    cell synthesizing its own planes, against the JAX module's sharded fit."""
    model = m.model_for(FAMILIES[family], device="cpu")
    obj, data = _family_scene(model)
    got = spf.sharded_fit_psf(model, model.init_params(), PHASE, data, obj, _mesh(1, 4),
                              config=PsfFitConfig(max_iter=4, grtol=0.0))
    ref = jax_family_refs[family]
    assert float(np.abs(got.params.phase.numpy() - ref["phase"]).max()) <= P_ABS
    assert abs(float(got.f) - ref["f"]) <= F_REL * abs(ref["f"])


def test_a_confocal_blind_round_matches_the_jax_sharded_loop(jax_family_refs):
    """One round of the sharded blind loop by VMLMB on (1, 4) of a confocal
    stack (the Wiener start and the object step fed each cell's planes, over
    the cells' one sum; the joint fit) against the JAX module's."""
    model = m.model_for(FAMILIES["confocal"], device="cpu")
    data = _family_scene(model)[1]
    got = pb.sharded_blind_deconvolve(data, model, _mesh(1, 4), config=_blind_config("vmlmb", True))
    ref = jax_family_refs["blind"]
    np.testing.assert_allclose(got.deconv_f, ref["deconv_f"], rtol=F_REL)
    np.testing.assert_allclose(got.fit_f, ref["fit_f"], rtol=F_REL)
    assert float(np.abs(got.params.phase.numpy() - ref["phase"]).max()) <= P_ABS
    assert float(np.abs(gather(got.obj).numpy() - ref["obj"]).max()) <= X_ABS
    assert _rel(got.psf.numpy(), ref["psf"]) <= F_REL


@pytest.mark.parametrize("mesh_shape, padded", [((1, 4), False), ((2, 2), False), ((1, 4), True)])
def test_depthvar_fit_cost_is_the_dense_one(mesh_shape, padded):
    """The depth-varying fit's cost and gradient (every family, DEPTH among
    them) against the dense one; on the model's grid each cell synthesizes
    its planes of the K anchor PSFs, on a padded grid the K PSFs are
    synthesized whole and cut."""
    model = _gibson_lanni((7, 16, 16) if padded else SHAPE)
    obj, data = _volumes(SHAPE, 7)
    p = _params(model, 8)
    data_cost = dv._depthvar_fit_cost(obj, data, None, ANCHORS)

    def dense(q):
        return data_cost(pad_fft_kernel(dv.depth_anchor_psfs(model, q, ANCHORS, depth0=q.depth[1]), SHAPE))

    ref = _value_and_grads(dense, p)
    calls = _spy(model)
    mesh = _mesh(*mesh_shape)
    got = _value_and_grads(sdv.sharded_depthvar_fit_cost(model, data, obj, None, mesh, ANCHORS), p)
    assert len(calls) == (1 if padded else mesh.shape["z"])
    _close(got, ref)


def test_forward_mode_through_the_replicated_pupil(scene):
    """``torch.func.jacfwd`` of each cell's planes, put together, with respect
    to the phase: the dense Jacobian of ``compute_psf`` bit for bit."""
    model = scene[0]
    p, mesh = _params(model), _mesh(1, 4)

    def sharded(phase):
        return gather(spf.psf_slabs(model, p._replace(phase=phase), mesh)[0])

    def dense(phase):
        return model.compute_psf(p._replace(phase=phase))

    assert torch.equal(torch.func.jacfwd(sharded)(p.phase), torch.func.jacfwd(dense)(p.phase))


def test_sharded_fits_match_the_jax_sharded_fits(scene, jax_refs):
    model, obj, data, gl = scene
    got = spf.sharded_fit_psf(model, model.init_params(), PHASE, data, obj, _mesh(1, 4),
                              config=PsfFitConfig(max_iter=6, grtol=0.0))
    assert float(np.abs(got.params.phase.numpy() - jax_refs["phase"]).max()) <= P_ABS
    assert abs(float(got.f) - jax_refs["f"]) <= F_REL * abs(jax_refs["f"])
    dgot = sdv.sharded_fit_psf_depthvar(gl, gl.init_params(), (DEFOCUS,), data, obj, _mesh(1, 4), ANCHORS,
                                        config=PsfFitConfig(max_iter=4, grtol=0.0))
    scale = np.abs(jax_refs["defocus"])
    assert float((np.abs(dgot.params.defocus.numpy() - jax_refs["defocus"]) / scale).max()) <= P_ABS
    assert abs(float(dgot.f) - jax_refs["depthvar_f"]) <= F_REL * abs(jax_refs["depthvar_f"])


def _whole_route(model, params, mesh, field_of=None, grid=None):
    """``psf_slabs``'s stand-in for the whole route: the PSF (or the K
    anchor PSFs at ``field_of``'s depths) synthesized whole on the model's
    device, zero-padded in FFT layout to ``grid`` and cut."""
    if field_of is None:
        whole = model.compute_psf(params)[None]
    else:
        whole = model.compute_depth_psfs(params, field_of(model.plane_inputs(params))["depths"])
    return [shard(h, mesh, False) for h in pad_fft_kernel(whole, tuple(model.shape if grid is None else grid))]


def _rel(a, b) -> float:
    """The largest gap of ``a`` from ``b`` relative to ``b``'s largest value."""
    a, b = (np.asarray(t, dtype=np.float64) for t in (a, b))
    return float(np.abs(a - b).max() / np.abs(b).max())


def _as_list(planes):
    return list(range(*planes.indices(SHAPE[0]))) if isinstance(planes, slice) else planes.tolist()


@pytest.mark.parametrize("case", list(BLIND_CASES))
def test_blind_object_step_on_each_cells_planes_is_the_whole_psf_cut(case, scene, monkeypatch):
    """One round of the sharded blind loop (the Wiener start and the object
    step, by VMLMB or ADMM): its PSFs from each cell's planes (z-sharded on
    the loop's grid; on a padded grid the planes of the PSF zero-padded in
    FFT layout) against the same round with the whole PSF synthesized and
    cut, to REL; each cell synthesized its own planes, never the whole PSF
    but for the result's."""
    engine, mesh_shape, shape = BLIND_CASES[case]
    data, cfg, mesh = _blind_data(scene, shape), _blind_config(engine, False), _mesh(*mesh_shape)
    model = _widefield(tuple(shape[-3:]))
    calls = _spy(model)
    got = pb.sharded_blind_deconvolve(data, model, mesh, config=cfg)
    grid_z = RAGGED_GRID[0] if shape == RAGGED else SHAPE[0]
    step = grid_z // mesh_shape[1]
    if shape[-3] == grid_z:
        cells = [list(range(z * step, (z + 1) * step)) for z in range(mesh_shape[1])]
    else:
        cells = _cell_planes(shape[-3], grid_z, mesh_shape[1])
    assert [_as_list(c) for c in calls[:-1]] == 2 * cells  # the start's and the object step's
    assert calls[-1] == slice(None)  # the result's whole PSF
    monkeypatch.setattr(pb, "psf_slabs", _whole_route)
    ref = pb.sharded_blind_deconvolve(data, model, mesh, config=cfg)
    assert len(calls) == 2 * len(cells) + 1 + 3  # the whole route's start, object step and result
    assert _rel(got.deconv_f, ref.deconv_f) <= REL
    assert _rel(gather(got.obj), gather(ref.obj)) <= REL
    assert torch.equal(got.psf, ref.psf)


@pytest.mark.parametrize("case", JAX_BLIND)
def test_a_blind_round_matches_the_jax_sharded_loop(case, scene, jax_refs):
    """One round of the sharded blind loop (the Wiener start, the object
    step fed each cell's planes, the joint fit) against the JAX module's
    ``sharded_blind_deconvolve``; the result's PSF is the fitted one."""
    engine, mesh_shape, shape = BLIND_CASES[case]
    model = _widefield(tuple(shape[-3:]))
    got = pb.sharded_blind_deconvolve(_blind_data(scene, shape), model, _mesh(*mesh_shape),
                                      config=_blind_config(engine, True))
    ref = jax_refs["blind"][case]
    np.testing.assert_allclose(got.deconv_f, ref["deconv_f"], rtol=F_REL)
    np.testing.assert_allclose(got.fit_f, ref["fit_f"], rtol=F_REL)
    assert float(np.abs(got.params.phase.numpy() - ref["phase"]).max()) <= P_ABS
    assert float(np.abs(gather(got.obj).numpy() - ref["obj"]).max()) <= X_ABS
    assert _rel(got.psf.numpy(), ref["psf"]) <= F_REL


@pytest.mark.parametrize("mesh_shape, padded", [((1, 4), False), ((2, 2), False), ((1, 4), True)])
def test_depthvar_anchor_psfs_from_each_cells_planes_are_synths_whole_route(mesh_shape, padded):
    """The depth-varying blind loop's object-step anchor PSFs, each cell's
    planes of the K PSFs at the fits' depths on the loop's grid, put
    together, against ``depth_anchor_psfs`` zero-padded in FFT layout to
    that grid (the whole route), to REL."""
    model, grid = _gibson_lanni(RAGGED if padded else SHAPE), RAGGED_GRID if padded else SHAPE
    p, mesh = _params(model, 9), _mesh(*mesh_shape)
    with torch.no_grad():
        got = spf.psf_slabs(model, p, mesh, sdv._anchor_depths(model, ANCHORS), grid=grid)
        want = pad_fft_kernel(dv.depth_anchor_psfs(model, p, ANCHORS, depth0=p.depth[1]), grid)
    assert len(got) == len(ANCHORS)
    for h, w in zip(got, want):
        assert _rel(gather(h), w) <= REL


@pytest.mark.parametrize("padded", [False, True])
def test_depthvar_blind_round_on_each_cells_planes_is_the_whole_route(padded, monkeypatch):
    """A round of the sharded depth-varying blind loop (object step, fit,
    object step) fed each cell's planes of the anchor PSFs, against the same
    loop with the K PSFs synthesized whole and cut, to REL."""
    shape = RAGGED if padded else SHAPE
    model, anchors = _gibson_lanni(shape), np.linspace(0.0, shape[0] - 1.0, 3)
    obj, _ = _volumes(shape, 10)
    with torch.no_grad():
        psfs = dv.depth_anchor_psfs(model, _params(model, 11), anchors)
        data = DepthVaryingConvCost.build(psfs, obj, None, shape, anchors).model(obj)
    cfg = BlindDeconvConfig(loops=2, families=(DEFOCUS,), psf_max_iter=(2,), deconv=DeconvolutionConfig(**OBJ_CFG))
    got = sdv.sharded_blind_deconvolve_depthvar(data, model, _mesh(1, 4), anchors, config=cfg)
    monkeypatch.setattr(sdv, "psf_slabs", _whole_route)
    ref = sdv.sharded_blind_deconvolve_depthvar(data, model, _mesh(1, 4), anchors, config=cfg)
    assert _rel(got.deconv_f, ref.deconv_f) <= REL
    assert _rel(gather(got.obj), gather(ref.obj)) <= REL
    assert torch.equal(got.psf, ref.psf)
