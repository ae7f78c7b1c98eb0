"""The port's batched blind loops (``jobs/batch.batched_blind_deconvolve``)
against the JAX package on the CPU (float64).

Per frame (``joint_psf=False``) the JAX package runs a ``vmap`` of
``blind_deconvolve``; the port runs each round's object step as one lockstep
batch over the lanes and the fits lane by lane. Each port lane equals the
port's own ``blind_deconvolve`` of its frame (bit for bit here, held at
1e-12), and the batch equals the JAX one at 1e-5 relative (solver outputs;
measured 1e-11; the ADMM lanes are held against the port's single loop). With ``joint_psf=True`` the JAX package runs its mesh path
on one device (``parallel/blind.py``); the port's one-card loop is held
against it at 1e-5. Inputs: 2 frames of (8, 16, 16), sparse rectified noise
blurred by an aberrated wide-field PSF, plus noise. The JAX references are
computed once per module."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.jobs.batch import batched_blind_deconvolve as jax_batched_blind
from microtipi_tpu.jobs.blind import BlindDeconvConfig as JaxBlindConfig
from microtipi_tpu.jobs.deconv import DeconvolutionConfig as JaxDeconvConfig
from microtipi_tpu.jobs.psf_fit import PsfFitConfig as JaxFitConfig
from microtipi_tpu.models.microscope import DEFOCUS, PHASE
from microtipi_tpu.models.widefield import WideFieldConfig as JaxWideFieldConfig
from microtipi_tpu_torch.convert import blind_config_from_fields, config_from_fields, params_to_torch
from microtipi_tpu_torch.jobs.batch import batched_blind_deconvolve
from microtipi_tpu_torch.jobs.blind import blind_deconvolve
from microtipi_tpu_torch.models.widefield import WideFieldModel

B, VOL = 2, (8, 16, 16)
RTOL, LANE_RTOL = 1e-5, 1e-12
OPTICS = dict(na=1.4, wavelength=561e-9, ni=1.518, dxy=80e-9, dz=200e-9, n_phase=4)
TRUE_PHASE = (0.15, -0.1, 0.08, 0.05)
BASE = dict(loops=2, families=(DEFOCUS, PHASE), psf_max_iter=(3, 3), joint_fit=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(shape=VOL):
    return JaxWideFieldConfig(shape=shape, dtype=jnp.float64, **OPTICS)


def _scene():
    rng = np.random.default_rng(0)
    m = _jax_model()
    psf = np.asarray(m.compute_psf(m.init_params()._replace(phase=jnp.asarray(TRUE_PHASE))))
    truth = np.maximum(rng.standard_normal((B, *VOL)), 0.0) * 5.0
    blur = np.fft.irfftn(np.fft.rfftn(truth, axes=(1, 2, 3)) * np.fft.rfftn(psf), s=VOL, axes=(1, 2, 3))
    data = blur + 0.01 * rng.standard_normal(blur.shape)
    weights = rng.uniform(0.5, 2.0, data.shape)
    bead = 1e3 * np.fft.fftshift(psf) + 0.5 * rng.standard_normal(VOL)
    return data, weights, bead


DATA, WEIGHTS, BEAD = _scene()

CASES = {
    "vmlmb_bead": dict(bead=True, blind=dict(bead_weight=0.5)),
    "wiener_batched_params_weights_sequential": dict(
        blind=dict(init="wiener", joint_fit=False), weighted=True, params="batched"),
    "joint": dict(joint=True),
    "joint_padded_weighted_sequential_wiener": dict(
        joint=True, weighted=True, deconv=dict(var_shape=(10, 20, 20)), blind=dict(init="wiener", joint_fit=False)),
}
# The ADMM lanes are held against the port's single loop only: that loop is
# held against JAX's in test_torch_admm.py, and a JAX vmap lane is JAX's
# single loop by construction (one more JAX blind compile costs ~8 s here).
LANE_CASES = {**{k: v for k, v in CASES.items() if not v.get("joint")},
              "admm": dict(blind=dict(deconv_engine="admm", mu_schedule=(0.04, 0.01)))}


def _configs(spec):
    deconv = JaxDeconvConfig(mu=0.01, epsilon=0.1, max_iter=5, **spec.get("deconv", {}))
    return JaxBlindConfig(**{**BASE, "deconv": deconv, "fit": JaxFitConfig(), **spec.get("blind", {})})


def _params0(m, spec):
    if spec.get("params") != "batched":
        return None
    p = m.init_params()
    return p._replace(phase=jnp.asarray([[0.05, 0.0, 0.0, 0.0], [-0.05, 0.02, 0.0, 0.0]]),
                      defocus=jnp.broadcast_to(p.defocus, (B, 3)), modulus=jnp.broadcast_to(p.modulus, (B, 1)))


def _jax_run(spec):
    m = _jax_model()
    # Under jit: JAX's eager dispatch of the same program takes longer.
    return jax.jit(lambda d: jax_batched_blind(
        d, m, params0=_params0(m, spec), weights=jnp.asarray(WEIGHTS) if spec.get("weighted") else None,
        config=_configs(spec), joint_psf=bool(spec.get("joint")),
        bead_data=jnp.asarray(BEAD) if spec.get("bead") else None))(jnp.asarray(DATA))


@pytest.fixture(scope="module")
def jax_refs():
    return {name: _jax_run(spec) for name, spec in CASES.items()}


def _port_inputs(spec):
    m = _jax_model()
    model = WideFieldModel(config_from_fields(m, torch.float64), device="cpu")
    p0 = _params0(m, spec)
    return dict(data=torch.tensor(DATA), model=model, params0=None if p0 is None else params_to_torch(p0),
                weights=torch.tensor(WEIGHTS) if spec.get("weighted") else None,
                config=blind_config_from_fields(_configs(spec)),
                bead_data=torch.tensor(BEAD) if spec.get("bead") else None)


def _assert_result(got, want, rtol):
    np.testing.assert_allclose(got.deconv_f, np.asarray(want.deconv_f), rtol=rtol)
    np.testing.assert_array_equal(np.isnan(got.fit_f), np.isnan(np.asarray(want.fit_f)))
    np.testing.assert_allclose(got.fit_f, np.asarray(want.fit_f), rtol=rtol)
    np.testing.assert_array_equal(got.deconv_iters, np.asarray(want.deconv_iters))
    for name in ("defocus", "phase", "modulus"):
        w = np.asarray(getattr(want.params, name))
        np.testing.assert_allclose(getattr(got.params, name).numpy(), w, rtol=rtol, atol=rtol * np.abs(w).max())
    scale = np.abs(np.asarray(want.obj)).max()
    np.testing.assert_allclose(got.obj.numpy(), np.asarray(want.obj), rtol=rtol, atol=rtol * scale)
    np.testing.assert_allclose(got.psf.numpy(), np.asarray(want.psf), rtol=rtol,
                               atol=rtol * np.abs(np.asarray(want.psf)).max())


@pytest.mark.parametrize("case", list(CASES))
def test_batched_blind_matches_jax(case, jax_refs):
    spec = CASES[case]
    res = batched_blind_deconvolve(**_port_inputs(spec), joint_psf=bool(spec.get("joint")))
    lead = () if spec.get("joint") else (B,)
    assert res.deconv_f.shape == lead + (2,) and res.fit_f.shape == lead + (2, 2)
    assert tuple(res.obj.shape) == (B,) + tuple(spec.get("deconv", {}).get("var_shape", VOL))
    _assert_result(res, jax_refs[case], RTOL)


@pytest.mark.parametrize("case", list(LANE_CASES))
def test_each_lane_is_its_own_blind_deconvolve(case):
    """Lane b of the lockstep loop is ``blind_deconvolve`` of frame b."""
    kw = _port_inputs(LANE_CASES[case])
    res = batched_blind_deconvolve(**kw)
    for b in range(B):
        p0 = None if kw["params0"] is None else kw["params0"]._replace(
            **{n: getattr(kw["params0"], n)[b] for n in kw["params0"]._fields})
        one = blind_deconvolve(kw["data"][b], kw["model"], params0=p0,
                               weights=None if kw["weights"] is None else kw["weights"][b], config=kw["config"],
                               bead_data=kw["bead_data"])
        lane = res._replace(obj=res.obj[b], params=res.params._replace(
            **{n: getattr(res.params, n)[b] for n in res.params._fields}), psf=res.psf[b],
            deconv_f=res.deconv_f[b], fit_f=res.fit_f[b], deconv_iters=res.deconv_iters[b])
        _assert_result(lane, one, LANE_RTOL)


def test_shared_params0_broadcasts_to_every_lane():
    kw = _port_inputs({})
    shared = batched_blind_deconvolve(**{**kw, "params0": kw["model"].init_params()})
    default = batched_blind_deconvolve(**kw)
    np.testing.assert_array_equal(shared.obj.numpy(), default.obj.numpy())
    np.testing.assert_array_equal(shared.params.phase.numpy(), default.params.phase.numpy())


@pytest.mark.parametrize("bad", ["fit_window", "admm", "volume"])
def test_joint_psf_refusals(bad):
    """The JAX package's refusals (``parallel/blind.py:80-90``) and a 3D
    input."""
    kw = _port_inputs(CASES["joint"])
    if bad == "fit_window":
        cfg = kw["config"]
        kw["config"] = dataclasses.replace(cfg, fit=dataclasses.replace(cfg.fit, fit_window=(8, 8, 8)))
    elif bad == "admm":
        kw["config"] = dataclasses.replace(kw["config"], deconv_engine="admm")
    else:
        kw["data"] = kw["data"][0]
    with pytest.raises(ValueError):
        batched_blind_deconvolve(**kw, joint_psf=True)
