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
- every PSF family: its sharded fit cost equals its dense one, and only the
  wide-field and Gibson-Lanni models take the planes;
- forward mode (``torch.func.jacfwd``) through the replicated pupil;
- ``sharded_fit_psf`` and ``sharded_fit_psf_depthvar`` against the JAX
  module's sharded functions on the conftest's virtual devices, to
  ``tests/test_torch_parallel_jobs.py``'s tolerances (P_ABS, F_REL);
- the sharded loops' object steps fed each cell's planes: a blind round by
  VMLMB and by ADMM, of one volume, a stack on (2, 2) and a ragged stack's
  padded grid, against the same round with the whole PSF cut (to REL), and
  which planes each cell synthesized; a blind round with its fit against
  the JAX module's ``sharded_blind_deconvolve`` (F_REL, X_ABS, P_ABS); the
  depth-varying loop's K anchor PSFs from each cell's planes against its
  whole route, and its round by either route.

Inputs come from numpy with a seed; the JAX references are computed once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.jobs.blind import BlindDeconvConfig as JaxBlindConfig
from microtipi_tpu.jobs.deconv import DeconvolutionConfig as JaxDeconvConfig
from microtipi_tpu.jobs.psf_fit import PsfFitConfig as JaxFitConfig
from microtipi_tpu.models.gibson_lanni import GibsonLanniConfig as JaxGibsonLanniConfig
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
from microtipi_tpu_torch.ops.convolution import convolve, convolve_spectrum
from microtipi_tpu_torch.ops.depthconv import DepthVaryingConvCost
from microtipi_tpu_torch.parallel import blind as pb
from microtipi_tpu_torch.parallel import depthvar as sdv
from microtipi_tpu_torch.parallel import psf_fit as spf
from microtipi_tpu_torch.parallel.mesh import gather, make_mesh
from microtipi_tpu_torch.utils.arrays import pad_fft_kernel

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
PLANE_FAMILIES = {"widefield", "gibson_lanni"}
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
    monkeypatch.setattr(pb, "plane_by_plane", lambda model: False)
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
    monkeypatch.setattr(sdv, "plane_by_plane", lambda model: False)
    ref = sdv.sharded_blind_deconvolve_depthvar(data, model, _mesh(1, 4), anchors, config=cfg)
    assert _rel(got.deconv_f, ref.deconv_f) <= REL
    assert _rel(gather(got.obj), gather(ref.obj)) <= REL
    assert torch.equal(got.psf, ref.psf)
