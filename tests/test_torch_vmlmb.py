"""Port VMLMB (host loop) against the JAX package's (lax.while_loop), float64
on the CPU: the same iterations, evaluations and status, and f histories to
1e-10 relative — the same arithmetic, so only summation order differs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.optim.vmlmb import minimize_vmlmb as jax_vmlmb
from microtipi_tpu_torch.optim.treeutil import value_and_grad
from microtipi_tpu_torch.optim.vmlmb import VMLMBStatus, minimize_vmlmb

RTOL = 1e-10


def _quadratic(n=24, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n))
    a = m @ m.T / n + 0.05 * np.eye(n)
    b = rng.standard_normal(n)
    return a, b


def _rosen(x, xp):
    return xp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def _compare(rj, rt, dict_x=False):
    assert (int(rj.iterations), int(rj.evaluations), int(rj.status)) == (rt.iterations, rt.evaluations, rt.status)
    fj = np.asarray(rj.f_history)
    np.testing.assert_array_equal(np.isnan(fj), np.isnan(rt.f_history))
    np.testing.assert_allclose(rt.f_history, fj, rtol=RTOL)
    np.testing.assert_allclose(np.asarray(rj.pg_history), rt.pg_history, rtol=1e-8, atol=1e-12)
    if dict_x:
        for k in rt.x:
            np.testing.assert_allclose(rt.x[k].numpy(), np.asarray(rj.x[k]), rtol=1e-8, atol=1e-12)
    else:
        np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("grtol", [1e-3, 1e-8])
def test_bounded_quadratic(grtol):
    a, b = _quadratic()
    x0 = np.full(a.shape[0], 0.5)
    kw = dict(lower=0.0, maxiter=40, grtol=grtol)
    rj = jax_vmlmb(jax.value_and_grad(lambda x: 0.5 * x @ (jnp.asarray(a) @ x) - jnp.asarray(b) @ x),
                   jnp.asarray(x0), **kw)
    ta, tb = torch.tensor(a), torch.tensor(b)
    rt = minimize_vmlmb(value_and_grad(lambda x: 0.5 * x @ (ta @ x) - tb @ x), torch.tensor(x0), **kw)
    _compare(rj, rt)
    assert float(rt.x.min()) >= 0.0


@pytest.mark.parametrize("as_dict", [False, True])
def test_unbounded_rosenbrock(as_dict):
    x0 = np.array([-1.2, 1.0, -0.5, 0.8, 1.1])
    kw = dict(maxiter=30, grtol=1e-6)
    if as_dict:
        def split(v, xp):
            return xp.concatenate([v["a"], v["b"]])

        rj = jax_vmlmb(jax.value_and_grad(lambda v: _rosen(split(v, jnp), jnp)),
                       {"a": jnp.asarray(x0[:2]), "b": jnp.asarray(x0[2:])}, **kw)
        rt = minimize_vmlmb(value_and_grad(lambda v: _rosen(torch.cat([v["a"], v["b"]]), torch)),
                            {"b": torch.tensor(x0[2:]), "a": torch.tensor(x0[:2])}, **kw)
    else:
        rj = jax_vmlmb(jax.value_and_grad(lambda x: _rosen(x, jnp)), jnp.asarray(x0), **kw)
        rt = minimize_vmlmb(value_and_grad(lambda x: _rosen(x, torch)), torch.tensor(x0), **kw)
    _compare(rj, rt, dict_x=as_dict)


@pytest.mark.parametrize("maxeval", [5, 9])
def test_maxeval_fires_mid_search(maxeval):
    x0 = np.array([-1.2, 1.0, -0.5])
    rj = jax_vmlmb(jax.value_and_grad(lambda x: _rosen(x, jnp)), jnp.asarray(x0), maxiter=30, maxeval=maxeval)
    rt = minimize_vmlmb(value_and_grad(lambda x: _rosen(x, torch)), torch.tensor(x0), maxiter=30, maxeval=maxeval)
    _compare(rj, rt)
    assert rt.status == VMLMBStatus.MAX_EVAL and rt.evaluations == maxeval


@pytest.mark.parametrize("cap", [0, 3])
def test_maxiter_cap(cap):
    a, b = _quadratic(seed=1)
    x0 = np.full(a.shape[0], 0.5)
    kw = dict(lower=0.0, maxiter=20, maxiter_cap=cap, grtol=0.0)
    rj = jax_vmlmb(jax.value_and_grad(lambda x: 0.5 * x @ (jnp.asarray(a) @ x) - jnp.asarray(b) @ x),
                   jnp.asarray(x0), **kw)
    ta, tb = torch.tensor(a), torch.tensor(b)
    rt = minimize_vmlmb(value_and_grad(lambda x: 0.5 * x @ (ta @ x) - tb @ x), torch.tensor(x0), **kw)
    _compare(rj, rt)
    assert rt.iterations == cap and len(rt.f_history) == 21


@pytest.mark.parametrize("bounds", ["per_leaf_scalars", "per_leaf_array", "upper_dict"])
def test_per_leaf_bounds_of_a_dict_iterate(bounds):
    """Bounds as a dict matching the iterate (``_normalize_bound``): a free
    leaf at -inf beside one bounded at 0 (``retrieve_pupil(fit_modulus=True)``),
    an array bound a coefficient, and an upper dict."""
    a, b = _quadratic(12, seed=3)
    x0 = {"p": np.full(6, 0.5), "q": np.full(6, 0.5)}
    lower = upper = None
    if bounds == "per_leaf_scalars":
        lower = {"p": -np.inf, "q": 0.0}
    elif bounds == "per_leaf_array":
        lower = {"p": np.linspace(-1.0, 0.2, 6), "q": 0.1}
    else:
        upper = {"p": 0.3, "q": np.inf}

    def fj(x):
        v = jnp.concatenate([x["p"], x["q"]])
        return 0.5 * v @ (jnp.asarray(a) @ v) - jnp.asarray(b) @ v

    ta, tb = torch.tensor(a), torch.tensor(b)

    def ft(x):
        v = torch.cat([x["p"], x["q"]])
        return 0.5 * v @ (ta @ v) - tb @ v

    kw = dict(maxiter=40, grtol=1e-8)
    rj = jax_vmlmb(jax.value_and_grad(fj), {k: jnp.asarray(v) for k, v in x0.items()},
                   lower=lower, upper=upper, **kw)
    rt = minimize_vmlmb(value_and_grad(ft), {k: torch.tensor(v) for k, v in x0.items()},
                        lower=lower, upper=upper, **kw)
    _compare(rj, rt, dict_x=True)
    # Each bound is active somewhere, and the free leaf crosses 0.
    if bounds == "upper_dict":
        assert float(rt.x["p"].max()) == 0.3
    else:
        lo_q = 0.0 if bounds == "per_leaf_scalars" else 0.1
        assert float(rt.x["q"].min()) == lo_q
    if bounds == "per_leaf_scalars":
        assert float(rt.x["p"].min()) < 0.0
