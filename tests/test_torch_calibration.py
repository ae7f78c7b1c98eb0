"""Bead calibration and the anchored blind loop of the port against the JAX
package on the CPU (float64): ``median``, ``center_bead_stack``,
``bead_anchor_term``, ``detect_beads``, ``average_beads``,
``empirical_psf``, the calibration prior and auxiliary terms of the fits,
``fit_psf_beads``, ``calibrate_field`` (with ``convert.anchors_to_torch``
and ``field_psf``), ``fit_families_with_cost``, the Gauss-Newton error bars,
and ``blind_deconvolve`` with ``phase_prior_weight``, ``bead_data`` and
``fit_window``. Inputs come from numpy with a seed and feed both packages;
each JAX reference is computed once, in a module fixture.

Tolerances: the deterministic pieces (centring, the bead term and its
gradient, detection, averaging, the empirical PSF, the fits' objectives at a
fixed point) to 1e-10 relative; the error bars (``std`` and ``cov``) to
1e-8; every solver's params and f to 1e-5 relative, the BASELINE.json
fidelity bar. Detection is a decision, so its test asserts a margin first."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.jobs import psf_fit as J
from microtipi_tpu.jobs.blind import BlindDeconvConfig as JaxBlindConfig
from microtipi_tpu.jobs.blind import blind_deconvolve as jax_blind
from microtipi_tpu.jobs.deconv import DeconvolutionConfig as JaxDeconvConfig
from microtipi_tpu.jobs.tiled import field_psf as jax_field_psf
from microtipi_tpu.models.widefield import WideFieldConfig as JaxConfig
from microtipi_tpu.ops.convolution import convolve as jax_convolve
from microtipi_tpu.ops.convolution import convolve_spectrum as jax_spectrum
from microtipi_tpu.utils.arrays import roll as jax_roll
from microtipi_tpu_torch.convert import anchors_to_torch, family_config_from_fields, params_to_torch
from microtipi_tpu_torch.jobs import psf_fit as T
from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig, blind_deconvolve
from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
from microtipi_tpu_torch.jobs.tiled import field_psf
from microtipi_tpu_torch.models import model_for
from microtipi_tpu_torch.models.microscope import DEFOCUS, PHASE
from microtipi_tpu_torch.ops.convolution import convolve, convolve_spectrum
from microtipi_tpu_torch.optim.treeutil import value_and_grad
from microtipi_tpu_torch.utils.arrays import median

OP_RTOL, UNC_RTOL, SOLVE_RTOL = 1e-10, 1e-8, 1e-5
BEAD_SHAPE = (12, 32, 32)
BEAD_OPTICS = dict(na=1.3, wavelength=520e-9, ni=1.518, dxy=90e-9, dz=220e-9, n_phase=3, dtype=jnp.float64)
TRUE_PHASE = [0.3, -0.2, 0.15]
SMALL = (8, 16, 16)
SMALL_OPTICS = dict(na=1.2, wavelength=500e-9, ni=1.33, dxy=100e-9, dz=250e-9, n_phase=2, radial=True,
                    dtype=jnp.float64)
SMALL_PHASE = [0.3, -0.15]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tensors this small run fastest on one intra-op thread, and the suite
    runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    """Relative L2 distance; 0 for two zero vectors (a family left at 0)."""
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), np.finfo(np.float64).tiny)


def _frel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def _pair(shape, optics):
    """The JAX config and the port's model on the CPU."""
    cfg = JaxConfig(shape=shape, **optics)
    return cfg, model_for(family_config_from_fields(cfg), device="cpu")


def _bead_stack(shift=(0.0, 0.0), seed=0):
    """A bead of TRUE_PHASE at the centre of BEAD_SHAPE (moved laterally by
    ``shift`` voxels), x800, with a background of 0.5 and 0.2% noise."""
    cfg, _ = _pair(BEAD_SHAPE, BEAD_OPTICS)
    psf = np.asarray(cfg.compute_psf(cfg.init_params()._replace(phase=jnp.asarray(TRUE_PHASE))))
    nz, ny, nx = BEAD_SHAPE
    fz, fy, fx = (np.fft.fftfreq(nz)[:, None, None], np.fft.fftfreq(ny)[None, :, None],
                  np.fft.rfftfreq(nx)[None, None, :])
    ramp = np.exp(-2j * np.pi * (fz * (nz // 2) + fy * (ny // 2 + shift[0]) + fx * (nx // 2 + shift[1])))
    bead = 800.0 * np.fft.irfftn(np.fft.rfftn(psf) * ramp, s=BEAD_SHAPE, axes=(0, 1, 2))
    return bead + 0.5 + 0.002 * bead.max() * np.random.default_rng(seed).standard_normal(BEAD_SHAPE)


BEAD_POSITIONS = [(20, 20), (20, 70), (60, 40), (64, 100), (100, 24), (104, 84)]


def _bead_field(seed=0, noise=1.5):
    """Six beads of one PSF (phase SMALL_PHASE, patch 8x24x24) scattered in
    an 8x128x128 stack, amplitudes 4000-8000, background 5."""
    cfg, _ = _pair((8, 24, 24), SMALL_OPTICS)
    h = np.asarray(jax_roll(cfg.compute_psf(cfg.init_params()._replace(phase=jnp.asarray(SMALL_PHASE)))))
    rng = np.random.default_rng(seed)
    stack = np.zeros((8, 128, 128))
    for y, x in BEAD_POSITIONS:
        stack[:, y - 12:y + 12, x - 12:x + 12] += rng.uniform(4000, 8000) * h
    return stack + 5.0 + noise * rng.standard_normal(stack.shape)


@pytest.mark.parametrize("n", [7, 8, 2**12])
def test_median_is_jnp_median(n):
    """Even counts take the mean of the two middle values (torch.median
    takes the lower one, which would shift the background)."""
    v = np.random.default_rng(n).standard_normal(n)
    got = median(torch.tensor(v))
    assert float(got) == float(jnp.median(jnp.asarray(v))) == float(np.median(v))
    if n % 2 == 0:
        assert float(torch.median(torch.tensor(v))) < float(got)


@pytest.mark.parametrize("subvoxel", [True, False])
@pytest.mark.parametrize("shape", [BEAD_SHAPE, (9, 15, 15)])
def test_center_bead_stack_matches_jax(shape, subvoxel):
    """An even-sized stack (the median is the middle pair's mean) and an
    odd one; the peak is unique by a margin."""
    rng = np.random.default_rng(1)
    bead = _bead_stack((0.31, -0.42)) if shape == BEAD_SHAPE else rng.random(shape) + 5.0 * (
        np.arange(np.prod(shape)).reshape(shape) == 700)
    top2 = np.sort(bead.ravel())[-2:]
    assert top2[1] - top2[0] > 1e-3 * top2[1]
    want = np.asarray(J.center_bead_stack(jnp.asarray(bead), subvoxel=subvoxel))
    got = T.center_bead_stack(torch.tensor(bead), subvoxel=subvoxel)
    assert got.dtype == torch.float64 and _rel(got, want) < OP_RTOL


def test_bead_anchor_term_matches_jax():
    """Value and gradient with respect to defocus and phase at a point off
    the truth; a model at another grid is refused."""
    cfg, model = _pair(BEAD_SHAPE, BEAD_OPTICS)
    bead = _bead_stack((0.31, -0.42))
    p = cfg.init_params()._replace(phase=jnp.asarray([0.1, 0.05, -0.02]))
    term_j = J.bead_anchor_term(cfg, jnp.asarray(bead))
    term_t = T.bead_anchor_term(model, torch.tensor(bead))
    names = ("defocus", "phase")
    f_want, g_want = jax.value_and_grad(lambda sub: term_j(p._replace(**sub)))({n: getattr(p, n) for n in names})
    pt = params_to_torch(p)
    f, g = value_and_grad(lambda sub: term_t(pt._replace(**sub)))({n: getattr(pt, n) for n in names})
    assert _frel(f, f_want) < OP_RTOL
    for n in names:
        assert _rel(g[n], g_want[n]) < OP_RTOL
    with pytest.raises(ValueError, match="model_at"):
        T.bead_anchor_term(T.model_at(model, (8, 32, 32)), torch.tensor(bead))


def _greedy_margins(data, n_beads, sep, rel_threshold):
    """The smallest gap between a pick and the best other voxel of its
    search, and the smallest distance of a peak value to the cut."""
    work = np.asarray(data, np.float64) - np.median(data)
    first, gaps, cuts = None, [], []
    for _ in range(n_beads):
        flat = np.sort(work.ravel())
        val = flat[-1]
        first = val if first is None else first
        cuts.append(abs(val - rel_threshold * first) / first)
        if val < rel_threshold * first:
            break
        gaps.append((flat[-1] - flat[-2]) / first)
        _, y0, x0 = np.unravel_index(np.argmax(work), work.shape)
        work[:, max(0, y0 - sep):y0 + sep + 1, max(0, x0 - sep):x0 + sep + 1] = -np.inf
    return min(gaps), min(cuts)


def test_detect_beads_matches_jax():
    field = _bead_field()
    gap, cut = _greedy_margins(field, 8, 24, 0.3)
    assert gap > 1e-4 and cut > 1e-2
    patches_j, pos_j = J.detect_beads(field, n_beads=8, patch=(8, 24, 24))
    patches_t, pos_t = T.detect_beads(torch.tensor(field), n_beads=8, patch=(8, 24, 24))
    assert pos_t == [tuple(int(v) for v in p) for p in pos_j] and len(pos_t) == 6
    assert sorted((y, x) for _, y, x in pos_t) == sorted(BEAD_POSITIONS)
    for a, b in zip(patches_t, patches_j):
        assert a.dtype == torch.float64 and _rel(a, b) < OP_RTOL


@pytest.mark.parametrize("n_beads", [8, 1])
def test_average_beads_matches_jax(n_beads):
    field = _bead_field()
    want, used_j = J.average_beads(field, n_beads=n_beads, patch=(8, 24, 24))
    got, used = T.average_beads(torch.tensor(field), n_beads=n_beads, patch=(8, 24, 24))
    assert used == used_j == min(n_beads, 6) and _rel(got, want) < OP_RTOL


def test_edge_beads_are_skipped_and_numpy_goes_to_the_card():
    """A bead whose lateral tails would clip is skipped, as in JAX; with no
    usable bead detection raises; a NumPy stack goes to the card, which
    this host does not have."""
    stack = np.zeros((4, 64, 64))
    stack[2, 32, 4] = 100.0  # clips a 24-wide lateral patch
    stack[2, 32, 40] = 90.0
    want, used_j = J.average_beads(stack, n_beads=4, patch=(4, 24, 24))
    got, used = T.average_beads(torch.tensor(stack), n_beads=4, patch=(4, 24, 24))
    assert used == used_j == 1 and _rel(got, want) < OP_RTOL
    with pytest.raises(ValueError, match="no usable bead"):
        T.detect_beads(torch.tensor(stack[:, :, :12]), n_beads=2, patch=(4, 24, 24))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            T.detect_beads(stack)


@pytest.mark.parametrize("n_beads", [1, 8])
def test_empirical_psf_matches_jax(n_beads):
    data = _bead_stack((0.31, -0.42)) if n_beads == 1 else _bead_field()
    patch = None if n_beads == 1 else (8, 24, 24)
    want = np.asarray(J.empirical_psf(data, n_beads=n_beads, patch=patch))
    got = T.empirical_psf(torch.tensor(data), n_beads=n_beads, patch=patch)
    assert _rel(got, want) < OP_RTOL and abs(float(got.sum()) - 1.0) < 1e-12 and float(got.min()) >= 0


def _small_scene(seed=0):
    """|N(0,1)| x 10 objects blurred by SMALL_PHASE, with 1% noise (on
    noiseless data the float64 quadratic data term resolves f only to
    eps * 0.5||d||^2, ~1e-9 of f here, below the deterministic bound), and
    a bead stack of the same optics."""
    cfg, model = _pair(SMALL, SMALL_OPTICS)
    rng = np.random.default_rng(seed)
    obj = np.abs(rng.standard_normal(SMALL)) * 10
    true = cfg.init_params()._replace(phase=jnp.asarray(SMALL_PHASE))
    data = np.asarray(jax_convolve(jnp.asarray(obj), jax_spectrum(cfg.compute_psf(true)), SMALL))
    data = data + 0.01 * data.max() * rng.standard_normal(SMALL)
    bead = 500.0 * np.asarray(jax_roll(cfg.compute_psf(true))) + 0.5
    return cfg, model, obj, data, bead


ANCHOR = [0.25, -0.1]
# name: (fit, keyword arguments); the fixed-point and the solver cases.
FITS = {
    "prior": ("fit_psf", dict(prior_weight=1e-2, anchor=True)),
    "aux": ("fit_psf", dict(aux=10.0)),
    "joint_prior_aux": ("fit_psf_joint", dict(phase_prior_weight=1e-2, phase_anchor=True, aux=10.0)),
    "families_one": ("fit_families_with_cost", dict(names=("phase",), phase_prior_weight=1e-2, aux=10.0)),
    "families_joint": ("fit_families_with_cost", dict(names=("defocus", "phase"), phase_prior_weight=1e-2)),
}


def _run_fit(pkg, name, max_iter):
    """The fit ``name`` of FITS through package ``pkg`` (J or T) from the
    phase ANCHOR on the small scene, with the bead stack as an auxiliary
    term."""
    cfg, model, obj, data, bead = _small_scene()
    jax_side = pkg is J
    m = cfg if jax_side else model
    arr = (lambda a: jnp.asarray(a)) if jax_side else torch.tensor
    p0 = cfg.init_params()._replace(phase=jnp.asarray(ANCHOR))
    p0 = p0 if jax_side else params_to_torch(p0)
    fn, kw = FITS[name]
    kw = dict(kw)
    aux = kw.pop("aux", None)
    if aux is not None:
        kw["aux_terms"] = ((pkg.bead_anchor_term(m, arr(bead)), aux),)
    for key in ("anchor", "phase_anchor"):
        if kw.get(key):
            kw[key] = arr(np.asarray(ANCHOR) + 0.05)
    config = pkg.PsfFitConfig(max_iter=max_iter, grtol=0.0)
    if fn == "fit_psf":
        return pkg.fit_psf(m, p0, PHASE, arr(data), arr(obj), config=config, **kw)
    if fn == "fit_psf_joint":
        return pkg.fit_psf_joint(m, p0, (DEFOCUS, PHASE), arr(data), arr(obj), config=config, **kw)
    conv = (lambda h: jax_convolve(h, jax_spectrum(jnp.asarray(obj)), SMALL)) if jax_side else (
        lambda h: convolve(h, convolve_spectrum(torch.tensor(obj)), SMALL))

    def cost(p):
        r = conv(m.compute_psf(p)) - arr(data)
        return 0.5 * (r * r).sum()

    return pkg.fit_families_with_cost(cost, p0, kw.pop("names"), config, **kw)


@pytest.fixture(scope="module")
def jax_fits():
    return {name: _result(_run_fit(J, name, 8)) for name in FITS}


def _result(res):
    return {"params": {k: np.asarray(v) for k, v in res.params._asdict().items()}, "f": float(res.f),
            "f0": float(res.f_history[0])}


@pytest.mark.parametrize("name", list(FITS))
def test_fit_objective_at_a_fixed_point_matches_jax(name, jax_fits):
    """The prior (normalized by the data cost at the start) and the
    auxiliary bead term at the start, before any step: f_history[0]."""
    got = _run_fit(T, name, 0)
    assert got.iterations == 0 and _frel(got.f, jax_fits[name]["f0"]) < OP_RTOL


@pytest.mark.parametrize("name", list(FITS))
def test_anchored_fits_match_jax(name, jax_fits):
    want = jax_fits[name]
    got = _run_fit(T, name, 8)
    assert _frel(got.f, want["f"]) < SOLVE_RTOL
    for k, v in want["params"].items():
        assert _rel(getattr(got.params, k), v) < SOLVE_RTOL, k


BEAD_FITS = {
    "phase": dict(families=(PHASE,)),
    "phase_pin_z4": dict(families=(PHASE,), phase_freeze_head=1),
    "defocus_phase_integer_centring": dict(families=(DEFOCUS, PHASE), subvoxel=False),
}


@pytest.fixture(scope="module")
def jax_bead_fits():
    cfg, _ = _pair(BEAD_SHAPE, BEAD_OPTICS)
    bead = _bead_stack((0.31, -0.42))
    out = {}
    for name, kw in BEAD_FITS.items():
        res, amp = J.fit_psf_beads(cfg, jnp.asarray(bead), config=J.PsfFitConfig(max_iter=40, grtol=0.0), **kw)
        out[name] = (_result(res), float(amp))
    res = out["phase"][0]
    p = cfg.init_params()._replace(**{k: jnp.asarray(v) for k, v in res["params"].items()})
    unc = J.bead_fit_uncertainty(cfg, p, (DEFOCUS, PHASE), jnp.asarray(bead))
    out["uncertainty"] = (p, {k: np.asarray(v) for k, v in unc.std.items()}, np.asarray(unc.cov), float(unc.sigma))
    return bead, out


@pytest.mark.parametrize("name", list(BEAD_FITS))
def test_fit_psf_beads_matches_jax(name, jax_bead_fits):
    bead, want = jax_bead_fits
    (res, amp) = want[name]
    _, model = _pair(BEAD_SHAPE, BEAD_OPTICS)
    got, got_amp = T.fit_psf_beads(model, torch.tensor(bead), config=T.PsfFitConfig(max_iter=40, grtol=0.0),
                                   **BEAD_FITS[name])
    assert _frel(got.f, res["f"]) < SOLVE_RTOL and _frel(got_amp, amp) < SOLVE_RTOL
    for k, v in res["params"].items():
        assert _rel(getattr(got.params, k), v) < SOLVE_RTOL, k
    if name == "phase":  # the fit recovers the aberration (the ML noise scatter ~0.02)
        np.testing.assert_allclose(got.params.phase.numpy(), TRUE_PHASE, atol=0.03)
        assert got_amp.item() == pytest.approx(800.0, rel=0.05)


def test_bead_fit_uncertainty_matches_jax(jax_bead_fits):
    bead, want = jax_bead_fits
    p, std, cov, sigma = want["uncertainty"]
    _, model = _pair(BEAD_SHAPE, BEAD_OPTICS)
    got = T.bead_fit_uncertainty(model, params_to_torch(p), (DEFOCUS, PHASE), torch.tensor(bead))
    assert set(got.std) == set(std) == {"defocus", "phase", "amp", "background"}
    for k, v in std.items():
        assert _rel(got.std[k], v) < UNC_RTOL, k
    assert _rel(got.cov, cov) < UNC_RTOL and _frel(got.sigma, sigma) < UNC_RTOL


@pytest.mark.parametrize("case", ["plain", "weighted", "sigma"])
def test_fit_uncertainty_matches_jax(case):
    cfg, model, obj, data, _ = _small_scene()
    data = data + 0.05 * np.random.default_rng(2).standard_normal(SMALL)
    p = cfg.init_params()._replace(phase=jnp.asarray(SMALL_PHASE))
    w = np.random.default_rng(3).uniform(0.5, 2.0, SMALL) if case == "weighted" else None
    sigma = 0.05 if case == "sigma" else None
    want = J.fit_uncertainty(cfg, p, PHASE, jnp.asarray(data), jnp.asarray(obj),
                             weights=None if w is None else jnp.asarray(w), sigma=sigma)
    got = T.fit_uncertainty(model, params_to_torch(p), PHASE, torch.tensor(data), torch.tensor(obj),
                            weights=None if w is None else torch.tensor(w), sigma=sigma)
    assert _rel(got.std, want.std) < UNC_RTOL and _rel(got.cov, want.cov) < UNC_RTOL
    assert _frel(got.sigma, want.sigma) < UNC_RTOL


FIELD_PHASES = {24.0: [0.35, -0.15], 72.0: [-0.2, 0.25]}  # left / right field


def test_calibrate_field_matches_jax():
    """Two regions of different phase, one fit a bead; the anchors carried
    across by convert.anchors_to_torch give the JAX field_psf's PSFs."""
    cfg, model = _pair((8, 24, 24), SMALL_OPTICS)
    p0 = cfg.init_params()
    slide = np.zeros((8, 48, 96))
    for x0, ph in FIELD_PHASES.items():
        h = np.asarray(jax_roll(cfg.compute_psf(p0._replace(phase=jnp.asarray(ph)))))
        slide[:, 12:36, int(x0) - 12:int(x0) + 12] += 3000.0 * h
    slide += 1.0 + 0.2 * np.random.default_rng(0).standard_normal(slide.shape)
    kw = dict(families=(PHASE,), n_beads=2)
    anchors_j, fits_j = J.calibrate_field(cfg, slide, config=J.PsfFitConfig(max_iter=40, grtol=0.0), **kw)
    anchors, fits = T.calibrate_field(model, torch.tensor(slide), config=T.PsfFitConfig(max_iter=40, grtol=0.0), **kw)
    assert [pos for pos, _ in anchors] == [pos for pos, _ in anchors_j] and len(anchors) == 2
    for ((y, x), p), (_, pj), f, fj in zip(anchors, anchors_j, fits, fits_j):
        assert _rel(p.phase, pj.phase) < SOLVE_RTOL and _frel(f.f, fj.f) < SOLVE_RTOL
        np.testing.assert_allclose(p.phase.numpy(), FIELD_PHASES[x], atol=0.05)
    jfn, tfn = jax_field_psf(cfg, anchors_j), field_psf(model, anchors_to_torch(anchors_j))
    for center in ((4.0, 24.0, 24.0), (4.0, 24.0, 48.0)):
        assert _rel(tfn(center), jfn(center)) < OP_RTOL


# name: the blind loop's options (besides the scene's), its fit window, and
# the rounds whose object step is held to SOLVE_RTOL. Two trajectories part
# later, as the JAX loop's own do (ROADMAP.md section 3): with the bead, the
# third object step turns round inputs ~7e-8 apart into 1e-4 in f (the JAX
# object step from the port's inputs gives the port's value); with the
# window, a third round's fit parts by 1.4e-4 in phase at equal f (3e-10),
# as the JAX loop from data one ulp off does (1.43e-4).
BLIND = {
    "prior": dict(config=dict(loops=3, joint_fit=False, phase_prior_weight=1e-2), params0=True, held=3),
    "bead": dict(config=dict(loops=3, joint_fit=True, bead_weight=10.0), bead=True, held=2),
    "window": dict(config=dict(loops=2, joint_fit=False), shape=(8, 24, 24), window=(8, 16, 16), held=2),
}


def _blind_inputs(case):
    shape = case.get("shape", SMALL)
    cfg = JaxConfig(shape=shape, **SMALL_OPTICS)
    obj = np.abs(np.random.default_rng(4).standard_normal(shape)) * 10
    true = cfg.init_params()._replace(phase=jnp.asarray(SMALL_PHASE))
    data = np.asarray(jax_convolve(jnp.asarray(obj), jax_spectrum(cfg.compute_psf(true)), shape))
    data = data + 0.01 * data.max() * np.random.default_rng(5).standard_normal(shape)
    bcfg = JaxConfig(shape=SMALL, **SMALL_OPTICS)
    bead = 300.0 * np.asarray(jax_roll(bcfg.compute_psf(true))) + 0.5 if case.get("bead") else None
    p0 = cfg.init_params()._replace(phase=jnp.asarray(ANCHOR)) if case.get("params0") else None
    fields = dict(families=(DEFOCUS, PHASE), psf_max_iter=(4, 4), **case["config"])
    if "window" in case:
        fields["fit"] = dict(fit_window=case["window"])
    return cfg, data, bead, p0, fields


def _deconv_fields():
    return dict(mu=1e-3, epsilon=1.0, max_iter=4, grtol=0.0)


@pytest.fixture(scope="module")
def jax_blinds():
    out = {}
    for name, case in BLIND.items():
        cfg, data, bead, p0, fields = _blind_inputs(case)
        fit = J.PsfFitConfig(**fields.pop("fit", {}))
        res = jax_blind(jnp.asarray(data), cfg, params0=p0, config=JaxBlindConfig(
            deconv=JaxDeconvConfig(**_deconv_fields()), fit=fit, **fields),
            bead_data=None if bead is None else jnp.asarray(bead))
        out[name] = (np.asarray(res.obj), {k: np.asarray(v) for k, v in res.params._asdict().items()},
                     np.asarray(res.deconv_f), np.asarray(res.fit_f))
    return out


@pytest.mark.parametrize("name", list(BLIND))
def test_anchored_blind_matches_jax(name, jax_blinds):
    cfg, data, bead, p0, fields = _blind_inputs(BLIND[name])
    model = model_for(family_config_from_fields(cfg), device="cpu")
    fit = T.PsfFitConfig(**fields.pop("fit", {}))
    res = blind_deconvolve(torch.tensor(data), model, params0=None if p0 is None else params_to_torch(p0),
                           config=BlindDeconvConfig(deconv=DeconvolutionConfig(**_deconv_fields()), fit=fit,
                                                    **fields),
                           bead_data=None if bead is None else torch.tensor(bead))
    obj, params, deconv_f, fit_f = jax_blinds[name]
    for k, v in params.items():
        assert _rel(getattr(res.params, k), v) < SOLVE_RTOL, k
    held = BLIND[name]["held"]
    df = np.abs(res.deconv_f - deconv_f) / np.abs(deconv_f)
    assert np.max(df[:held]) < SOLVE_RTOL, df
    np.testing.assert_array_equal(np.isnan(res.fit_f), np.isnan(fit_f))
    ok = ~np.isnan(fit_f)
    assert np.max(np.abs(res.fit_f[ok] - fit_f[ok]) / np.abs(fit_f[ok])) < SOLVE_RTOL
    if held == len(deconv_f):
        assert _rel(res.obj, obj) < SOLVE_RTOL


def test_anchors_pin_the_blind_phase():
    """A dominant prior holds the phase at params0; a dominant bead anchor
    at the truth the bead carries."""
    cfg, model, obj, data, bead = _small_scene()
    p0 = params_to_torch(cfg.init_params()._replace(phase=jnp.asarray(ANCHOR)))
    base = dict(loops=3, families=(PHASE,), psf_max_iter=(6,), joint_fit=True,
                deconv=DeconvolutionConfig(**_deconv_fields()))
    res = blind_deconvolve(torch.tensor(data), model, params0=p0,
                           config=BlindDeconvConfig(phase_prior_weight=1e6, **base))
    np.testing.assert_allclose(res.params.phase.numpy(), ANCHOR, atol=1e-3)
    res = blind_deconvolve(torch.tensor(data), model, config=BlindDeconvConfig(bead_weight=1e4, **base),
                           bead_data=torch.tensor(bead))
    np.testing.assert_allclose(res.params.phase.numpy(), SMALL_PHASE, atol=2e-2)


def test_blind_guards():
    """The window must fit inside the data and be laterally square; the
    bead stack must be laterally square."""
    _, model, _, data, bead = _small_scene()
    for window, match in (((8, 32, 32), "exceeds"), ((8, 16, 12), "square")):
        with pytest.raises(ValueError, match=match):
            blind_deconvolve(torch.tensor(data), model, config=BlindDeconvConfig(
                loops=1, fit=T.PsfFitConfig(fit_window=window)))
    with pytest.raises(ValueError, match="laterally square"):
        blind_deconvolve(torch.tensor(data), model, config=BlindDeconvConfig(loops=1),
                         bead_data=torch.tensor(bead[:, :, :12]))
