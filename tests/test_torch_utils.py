"""The port's small utilities against the JAX package's: phantoms
(``utils/phantoms.py``) bit-equal from the same seed, checkpoints
(``utils/checkpoint.py``) that load across the two packages in both
directions bit for bit, and the profiler (``utils/profiling.py``): ``trace``
writes a Chrome trace that holds a ``span``'s name."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.models.widefield import WideFieldParams as JaxParams
from microtipi_tpu.utils import checkpoint as jax_checkpoint
from microtipi_tpu.utils import phantoms as jax_phantoms
from microtipi_tpu_torch.models.widefield import WideFieldParams
from microtipi_tpu_torch.utils import checkpoint, phantoms, profiling

SHAPE = (8, 32, 32)
PHANTOMS = {"beads": dict(n=12, seed=3), "filaments": dict(n=3, steps=120, seed=4),
            "shells": dict(n=2, radius=(3.0, 6.0), seed=5)}


@pytest.mark.parametrize("kind", list(PHANTOMS))
def test_phantom_is_bit_equal_to_jax(kind):
    got = getattr(phantoms, f"{kind}_phantom")(SHAPE, **PHANTOMS[kind])
    want = getattr(jax_phantoms, f"{kind}_phantom")(SHAPE, **PHANTOMS[kind])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got.max() > 0


def test_apply_camera_is_bit_equal_to_jax():
    clean = jax_phantoms.shells_phantom(SHAPE, n=2, radius=(3.0, 6.0), seed=5)
    np.testing.assert_array_equal(phantoms.apply_camera(clean, seed=7), jax_phantoms.apply_camera(clean, seed=7))


def _state(rng):
    obj = rng.random(SHAPE)
    return obj, (np.array([2.66e6, 0.1, -0.2]), rng.standard_normal(4), np.array([1.0, 0.05]))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_loads_across_packages(tmp_path, direction):
    obj, fams = _state(np.random.default_rng(0))
    path = str(tmp_path / "state.npz")
    if direction == "jax_to_port":
        jax_checkpoint.save_state(path, jnp.asarray(obj), JaxParams(*map(jnp.asarray, fams)), 7, cost=1.25)
        obj2, params2, rnd, extra = checkpoint.load_state(path, device="cpu")
        assert isinstance(obj2, torch.Tensor) and obj2.device.type == "cpu"
        assert isinstance(params2, WideFieldParams)
        obj2, fams2 = obj2.numpy(), [t.numpy() for t in params2]
    else:
        checkpoint.save_state(path, torch.tensor(obj), WideFieldParams(*map(torch.tensor, fams)), 7, cost=1.25)
        obj2, params2, rnd, extra = jax_checkpoint.load_state(path)
        obj2, fams2 = np.asarray(obj2), [np.asarray(t) for t in params2]
    assert obj2.dtype == np.float64
    np.testing.assert_array_equal(obj2, obj)
    for got, want in zip(fams2, fams):
        np.testing.assert_array_equal(got, want)
    assert rnd == 7 and float(extra["cost"]) == 1.25
    assert not os.path.exists(path + ".tmp")


def test_checkpoint_files_hold_the_same_arrays(tmp_path):
    """Both packages write the same keys, dtypes and values."""
    obj, fams = _state(np.random.default_rng(1))
    pj, pp = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jax_checkpoint.save_state(pj, jnp.asarray(obj), JaxParams(*map(jnp.asarray, fams)), 3, loss=np.arange(3.0))
    checkpoint.save_state(pp, torch.tensor(obj), WideFieldParams(*map(torch.tensor, fams)), 3, loss=np.arange(3.0))
    with np.load(pj) as zj, np.load(pp) as zp:
        assert sorted(zj.files) == sorted(zp.files)
        for k in zj.files:
            assert zj[k].dtype == zp[k].dtype
            np.testing.assert_array_equal(zj[k], zp[k])


def test_trace_holds_the_annotated_range(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir):
        with profiling.span("admm.setup"):
            torch.fft.rfftn(torch.ones(4, 8, 8)).abs().sum()
    (name,) = os.listdir(logdir)
    with open(os.path.join(logdir, name)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "admm.setup" for e in events)
