"""The port's stateful API (``microtipi_tpu_torch/api.py``) against the JAX
package's (``microtipi_tpu/api.py``) on the CPU in float64, through the
sequences of ``tests/test_api.py``: the getters and adjoints to 1e-10, the
resize rules identical, ``PSF_Estimation.fit_psf`` (one solve and chunked)
to 1e-5 relative in the parameters with the same iteration and evaluation
counts, ``DeconvolutionJob`` (one solve, chunked at K = 7, the
grtol-anchored early stop, abort from ``progress``) to 1e-5 relative in x
and 1e-8 in ``f_history`` with the same counts, and ``BlindDeconvJob``
(3 rounds, with and without ``InverseVarianceWeights``) to 1e-5 relative.
The JAX references are computed once, in a module fixture; volumes of
8x32x32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu import api as jax_api
from microtipi_tpu.ops.convolution import convolve, convolve_spectrum
from microtipi_tpu.weights.updaters import InverseVarianceWeights as JaxWeights
from microtipi_tpu_torch import api
from microtipi_tpu_torch.api import DEFOCUS, MODULUS, PHASE
from microtipi_tpu_torch.weights.updaters import InverseVarianceWeights

SHAPE = (8, 32, 32)
KW = dict(na=1.2, wavelength=500e-9, ni=1.33, dxy=100e-9, dz=250e-9)
TRUE_PHASE = [0.3, -0.2, 0.1]
GETTERS = ("get_psf", "get_mtf", "get_cpx_psf", "get_rho", "get_phi", "get_psi", "get_mask_pupil", "get_zernike",
           "get_defocus", "get_defocus_multiply_by_lambda", "get_pupil_shift", "get_phase_coefs",
           "get_modulus_coefs", "get_ni", "get_n_zern", "get_lambda")
# The fits stop before their round-off floor: at 12 iterations in slices of 4
# the chunked fit reaches f's last digits, where the count of the stalled slice
# is rounding's (JAX gives 6 or 7 iterations with the data perturbed by 1e-14).
FIT_ITERS, FIT_MODES = 6, {"single": None, "chunked": 3}
DECONV_MODES = {"single": dict(max_iter=21, grtol=0.0), "chunked": dict(max_iter=21, grtol=0.0, abort_check_iters=7),
                "grtol_anchored": dict(max_iter=60, grtol=3e-2, abort_check_iters=10)}
DECONV_KW = dict(mu=0.01, epsilon=0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(n_phase=3, n_modulus=1, radial=True):
    """The same model in both packages: (JAX api model, port api model)."""
    kw = dict(n_phase=n_phase, n_modulus=n_modulus, radial=radial, single=False, **KW)
    return jax_api.WideFieldModel(SHAPE, **kw), api.WideFieldModel(SHAPE, device="cpu", **kw)


def _scene():
    """``tests/test_api.py``'s scene (six point sources, 1% noise) through
    the JAX model with TRUE_PHASE: (object, data, true PSF) as NumPy."""
    m, _ = _models()
    m.set_phase(TRUE_PHASE)
    rng = np.random.default_rng(3)
    obj = np.zeros(SHAPE)
    for _ in range(6):
        obj[rng.integers(0, 8), rng.integers(4, 28), rng.integers(4, 28)] = rng.uniform(50, 100)
    psf = np.array(m.get_psf())  # writable, as the port's tensors want
    data = convolve(jnp.asarray(obj), convolve_spectrum(jnp.asarray(psf)), SHAPE)
    return obj, np.asarray(data) + 0.01 * rng.standard_normal(SHAPE), psf


def _configured(m):
    """A model state with every family off its default."""
    m.set_phase([0.2, -0.1, 0.05, 0.1])
    m.set_modulus([0.9, 0.1])
    m.set_defocus([KW["ni"] / KW["wavelength"] * 1.02, 0.3, -0.2])
    return m


def _jax_fit(obj, data, k):
    m, _ = _models()
    est = jax_api.PSF_Estimation(m)
    est.set_data(jnp.asarray(data))
    est.set_obj(jnp.asarray(obj))
    est.set_maximum_iterations(FIT_ITERS)
    est.set_relative_tolerance(0.0)
    est.set_abort_check_iters(k)
    est.fit_psf(PHASE)
    return m.get_phase_coefs(), est.get_cost(), est.get_iterations(), est.get_evaluations()


def _jax_deconv(data, psf, kw):
    job = jax_api.DeconvolutionJob(jnp.asarray(data), psf=jnp.asarray(psf), **DECONV_KW, **kw)
    x = np.asarray(job.deconv())
    r = job._result
    return x, np.asarray(r.f_history), int(r.iterations), int(r.evaluations), np.asarray(job.get_model())


def _aborting_job(module, data, psf, **kw):
    calls = []

    def progress(done, f):
        calls.append((done, f))
        job.abort()

    job = module.DeconvolutionJob(data, psf=psf, max_iter=50, grtol=0.0, abort_check_iters=5, progress=progress,
                                  **DECONV_KW, **kw)
    return job, calls


def _blind(module, obj_start, data, weighted, **kw):
    """``tests/test_api.py``'s host loop: 3 rounds, phase fits of 10."""
    m = module.WideFieldModel(SHAPE, n_phase=3, n_modulus=1, radial=True, single=False, **KW, **kw)
    est = module.PSF_Estimation(m)
    est.set_data(data)
    dec = module.DeconvolutionJob(data, mu=0.002, epsilon=2.0, max_iter=20, **kw)
    updater = None
    if weighted:
        updater = (InverseVarianceWeights if kw else JaxWeights)(gain=2.0, readout_variance=0.5)
    job = module.BlindDeconvJob(3, [DEFOCUS, PHASE], [5, 10], est, dec, weight_updater=updater)
    out = job.blind_deconv(obj_start)
    return out, m, job


@pytest.fixture(scope="module")
def ref():
    obj, data, psf = _scene()
    out = {"scene": (obj, data, psf)}
    jm = _configured(_models(n_phase=4, n_modulus=2)[0])
    out["getters"] = {name: getattr(jm, name)() for name in GETTERS}
    q = np.random.default_rng(0).standard_normal(SHAPE)
    out["q"] = q
    out["jacobian"] = {flag: jm.apply_jacobian(q, flag) for flag in (DEFOCUS, PHASE, MODULUS)}
    out["fit"] = {mode: _jax_fit(obj, data, k) for mode, k in FIT_MODES.items()}
    out["deconv"] = {mode: _jax_deconv(data, psf, kw) for mode, kw in DECONV_MODES.items()}
    job, calls = _aborting_job(jax_api, jnp.asarray(data), jnp.asarray(psf))
    out["abort"] = (np.asarray(job.deconv()), int(job._result.iterations), calls)
    for weighted in (False, True):
        x, m, _ = _blind(jax_api, jnp.maximum(jnp.asarray(data), 0.0), jnp.asarray(data), weighted)
        out["blind", weighted] = (np.asarray(x), m.get_defocus(), m.get_phase_coefs())
    return out


def _rel(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(float(np.abs(want).max()), 1e-300))


@pytest.mark.parametrize("name", GETTERS)
def test_getter_matches_jax(ref, name):
    """Complex getters return the complex array directly in the port."""
    got = getattr(_configured(_models(n_phase=4, n_modulus=2)[1]), name)()
    want = ref["getters"][name]
    if isinstance(want, (int, float)):
        assert type(got) is type(want)
        np.testing.assert_allclose(got, want, rtol=1e-10)
    else:
        assert got.dtype == want.dtype
        _rel(got, want, 1e-10)


@pytest.mark.parametrize("flag", [DEFOCUS, PHASE, MODULUS], ids=["defocus", "phase", "modulus"])
def test_apply_jacobian_matches_jax(ref, flag):
    pm = _configured(_models(n_phase=4, n_modulus=2)[1])
    got = pm.apply_jacobian(ref["q"], flag)
    _rel(got, ref["jacobian"][flag], 1e-10)
    named = {DEFOCUS: pm.apply_j_defocus, PHASE: pm.apply_j_phase, MODULUS: pm.apply_j_modulus}[flag]
    np.testing.assert_array_equal(named(ref["q"]), got)


def test_resize_rules_match_jax():
    """``tests/test_api.py::test_rebuild_family_isolation``'s sequence in
    both packages: identical coefficients and mode counts at every step."""
    jm, pm = _models(n_modulus=2, radial=False)
    steps = [("set_modulus", [0.9, 0.1]), ("set_n_phase", 5), ("set_phase", [0.1, 0.2, 0.3, 0.4, 0.5]),
             ("set_n_modulus", 3), ("set_modulus", [0.8, 0.2, 0.0]), ("set_phase", [0.4, -0.2]),
             ("set_ni", 1.4), ("set_pupil_axis", [0.1, -0.1]), ("set_pupil_axis", 0.2), ("set_param", (MODULUS, [1.0])),
             ("set_param", (DEFOCUS, [2.6e6]))]
    for name, arg in steps:
        for m in (jm, pm):
            getattr(m, name)(*(arg if name == "set_param" else (arg,)))
        for getter in ("get_phase_coefs", "get_modulus_coefs", "get_defocus"):
            np.testing.assert_array_equal(getattr(pm, getter)(), getattr(jm, getter)())
        assert (pm.get_n_phase(), pm.get_n_modulus(), pm.get_n_zern()) == \
            (jm.get_n_phase(), jm.get_n_modulus(), jm.get_n_zern())
    _rel(pm.get_psf(), jm.get_psf(), 1e-10)


@pytest.mark.parametrize("mode", list(FIT_MODES))
def test_fit_psf_matches_jax(ref, mode):
    obj, data, _ = ref["scene"]
    _, pm = _models()
    est = api.PSF_Estimation(pm)
    est.set_data(data)
    est.set_obj(obj)
    est.set_maximum_iterations(FIT_ITERS)
    est.set_relative_tolerance(0.0)
    est.set_abort_check_iters(FIT_MODES[mode])
    est.fit_psf(PHASE)
    phase, f, iterations, evaluations = ref["fit"][mode]
    assert (est.get_iterations(), est.get_evaluations()) == (iterations, evaluations)
    _rel(pm.get_phase_coefs(), phase, 1e-5)
    np.testing.assert_allclose(est.get_cost(), f, rtol=1e-5)


@pytest.mark.parametrize("mode", list(DECONV_MODES))
def test_deconvolution_job_matches_jax(ref, mode):
    _, data, psf = ref["scene"]
    job = api.DeconvolutionJob(data, psf=psf, device="cpu", **DECONV_KW, **DECONV_MODES[mode])
    x = job.deconv()
    x_w, hist_w, iterations, evaluations, model_w = ref["deconv"][mode]
    r = job._result
    assert (r.iterations, r.evaluations) == (iterations, evaluations)
    assert r.f_history.shape == hist_w.shape
    np.testing.assert_array_equal(np.isnan(r.f_history), np.isnan(hist_w))
    np.testing.assert_allclose(r.f_history, hist_w, rtol=1e-8)
    _rel(x.numpy(), x_w, 1e-5)
    _rel(job.get_model().numpy(), model_w, 1e-5)
    if mode == "grtol_anchored":
        assert iterations < 60  # the anchored rule stops the run early


def test_abort_from_progress_matches_jax(ref):
    """``abort()`` from the callback stops after the first slice, never inside it."""
    _, data, psf = ref["scene"]
    job, calls = _aborting_job(api, data, psf, device="cpu")
    x = job.deconv()
    x_w, iterations, calls_w = ref["abort"]
    assert job._result.iterations == iterations <= 5
    assert len(calls) == len(calls_w) == 1 and calls[0][0] == calls_w[0][0]
    np.testing.assert_allclose(calls[0][1], calls_w[0][1], rtol=1e-8)
    _rel(x.numpy(), x_w, 1e-5)
    assert not job.is_running()


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "inverse_variance"])
def test_blind_deconv_job_matches_jax(ref, weighted):
    obj, data, _ = ref["scene"]
    t = torch.tensor(data)
    out, m, job = _blind(api, torch.clamp_min(t, 0.0), t, weighted, device="cpu")
    x_w, defocus_w, phase_w = ref["blind", weighted]
    _rel(out.numpy(), x_w, 1e-5)
    _rel(m.get_defocus(), defocus_w, 1e-5)
    _rel(m.get_phase_coefs(), phase_w, 1e-5)
    assert not job.is_running() and job.get_psf() is not None
    assert job.get_model().shape == SHAPE
    assert float(torch.linalg.norm(out - torch.tensor(obj))) < float(np.linalg.norm(data - obj))


def test_debug_mode_prints_the_jax_line(ref, capsys):
    """``set_debug_mode`` prints ``fit_psf(flag=...) f=... f_history=...``
    as JAX does: the same text up to the float digits."""
    obj, data, _ = ref["scene"]
    lines = []
    for module, kw in ((jax_api, {}), (api, dict(device="cpu"))):
        m = module.WideFieldModel(SHAPE, n_phase=3, n_modulus=1, radial=True, single=False, **KW, **kw)
        est = module.PSF_Estimation(m)
        est.set_data(data)
        est.set_obj(obj)
        est.set_maximum_iterations(3)
        est.set_debug_mode(True)
        est.fit_psf(PHASE)
        lines.append(capsys.readouterr().out.strip())
    strip = [line.split(" f=")[0] + line.split(" iters=")[1].split(" f_history=")[0] for line in lines]
    assert lines[1].startswith("fit_psf(flag=1): f=") and "f_history=[" in lines[1]
    assert strip[0] == strip[1]


def test_api_raises_without_a_card_unless_given_the_cpu(monkeypatch, tmp_path):
    """No CPU fallback: with no card, a constructor that was not given a
    device raises; given ``device="cpu"`` it runs."""
    from microtipi_tpu_torch.utils.checkpoint import load_state, save_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.WideFieldModel(SHAPE, **KW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.DeconvolutionJob(np.zeros(SHAPE))
    m = api.WideFieldModel(SHAPE, device="cpu", **KW)
    assert m.compute_psf().device.type == "cpu"
    assert api.DeconvolutionJob(np.zeros(SHAPE), device="cpu")._data.device.type == "cpu"
    path = str(tmp_path / "state.npz")
    save_state(path, np.zeros(SHAPE), m.params, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_state(path)
    assert load_state(path, device="cpu")[0].device.type == "cpu"


def test_numpy_data_goes_to_the_model_device_and_dtype():
    m = api.WideFieldModel(SHAPE, single=True, device="cpu", **KW)
    est = api.PSF_Estimation(m)
    est.set_data(np.ones(SHAPE))
    assert est.get_data().dtype == torch.float32 and est.get_psf().dtype == torch.float32
    job = api.DeconvolutionJob(np.ones(SHAPE, np.float32), psf=np.ones(SHAPE), device="cpu")
    assert job._psf.dtype == torch.float32
