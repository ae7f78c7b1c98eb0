"""The plain versions of the ADMM engine's kernels (``ops/kernels/admm_split.py``)
against the JAX package on the CPU (float64, 1e-10): the circular differences
and their adjoint, the Newton hyperbolic prox, the gradient spectrum, and the
split update and right-hand side against a transcription of ``step_core``
(``jobs/admm.py:327-368``) built from the JAX module's own pieces, with its
stored mask volumes. Inputs come from numpy with a seed and feed both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.jobs import admm as jadmm
from microtipi_tpu_torch.jobs import admm as tadmm
from microtipi_tpu_torch.ops.kernels import admm_split as ak

RTOL = 1e-10
SHAPES = [(6, 12, 12), (5, 7, 9)]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)  # an all-zero pair (u2 without the clamp) is 0


def _state(shape, nb, seed=0):
    """x, z1, u1, z2, u2 of a batch and per-lane lam, rho1, rho2 (all differ)."""
    rng = np.random.default_rng(seed)
    st = {k: rng.standard_normal((nb, *shape)) for k in ("x", "z2", "u2")}
    st.update({k: rng.standard_normal((nb, 3, *shape)) for k in ("z1", "u1")})
    st.update({k: rng.uniform(0.05, 2.0, nb) for k in ("lam", "rho1", "rho2")})
    return st


def _jax_masks(shape):
    """The stored replicate-boundary masks of admm.py:300-304."""
    masks = []
    for a in range(3):
        m = jnp.ones(shape)
        masks.append(m.at[tuple(slice(-1, None) if i == a else slice(None) for i in range(3))].set(0.0))
    return masks


def _jax_split_update(x, z1, u1, z2, u2, lam, eps, al, positivity, scales):
    """admm.py:353-368 for one volume, from the JAX module's pieces."""
    masks = _jax_masks(x.shape)
    dx = jadmm._circ_diffs(x, scales)
    dxr = dx if al == 1.0 else [al * d + (1.0 - al) * z for d, z in zip(dx, z1)]
    v = [d + u for d, u in zip(dxr, u1)]
    vmag = jnp.sqrt(sum(m * t * t for m, t in zip(masks, v)) + jnp.finfo(x.dtype).tiny)
    scale = jadmm._hyperbolic_prox(vmag, lam, eps) / vmag
    z1 = [jnp.where(m > 0, scale * t, t) for m, t in zip(masks, v)]
    xr = x if al == 1.0 else al * x + (1.0 - al) * z2
    z2 = jnp.maximum(xr + u2, 0.0) if positivity else xr + u2
    u1 = [u + d - z for u, d, z in zip(u1, dxr, z1)]
    return jnp.stack(z1), jnp.stack(u1), z2, u2 + xr - z2


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("scales", [None, (2.0, 1.0, 1.5)])
def test_circ_diffs_and_adjoint_match_jax(shape, scales):
    st = _state(shape, 2)
    d = ak.circ_diffs(torch.tensor(st["x"]), scales)
    adj = ak.circ_diffs_adjoint(torch.tensor(st["z1"]), scales)
    for b in range(2):
        want = jnp.stack(jadmm._circ_diffs(jnp.asarray(st["x"][b]), scales))
        assert _rel(d[b], want) < RTOL
        assert _rel(adj[b], jadmm._circ_diffs_adjoint(list(jnp.asarray(st["z1"][b])), scales)) < RTOL
    # <D x, g> == <x, D^T g>, per lane
    lhs = (d * torch.tensor(st["z1"])).flatten(1).sum(1)
    rhs = (torch.tensor(st["x"]) * adj).flatten(1).sum(1)
    torch.testing.assert_close(lhs, rhs, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("lam,eps", [(0.1, 0.05), (1.0, 0.5), (0.2, 0.01), (0.01, 1.0)])
def test_hyperbolic_prox_matches_jax_and_its_optimality(lam, eps):
    v = np.concatenate([[0.0], np.random.default_rng(1).uniform(0.0, 4.0, 200)])
    s = ak.hyperbolic_prox(torch.tensor(v), lam, eps)
    assert _rel(s, jadmm._hyperbolic_prox(jnp.asarray(v), lam, eps)) < RTOL
    # g(s) = s + lam s / sqrt(s^2 + eps^2) - v vanishes at the prox (s = 0 where v = 0)
    g = s + lam * s / torch.sqrt(s * s + eps * eps) - torch.tensor(v)
    assert float(g.abs().max()) < 1e-9 and float(s[0]) == 0.0
    per_lane = ak.hyperbolic_prox(torch.tensor(v).expand(2, -1), torch.tensor([[lam], [2 * lam]], dtype=torch.float64), eps)
    torch.testing.assert_close(per_lane[0], s, rtol=1e-14, atol=0)  # a lam per row, as the engine passes it
    assert float((per_lane[1] - s)[1:].max()) < 0  # a larger lam shrinks more


@pytest.mark.parametrize("shape", SHAPES + [(4, 8, 6)])
@pytest.mark.parametrize("scales", [None, (2.0, 1.0, 0.5)])
def test_grad_sq_spectrum_matches_jax(shape, scales):
    got = tadmm._grad_sq_spectrum(shape, scales, torch.float64)
    want = jadmm._grad_sq_spectrum(shape, scales, jnp.float64)
    assert tuple(got.shape) == want.shape and _rel(got, want) < RTOL
    # it is the spectrum of D^T D: apply both to one volume
    x = torch.tensor(np.random.default_rng(2).standard_normal((1, *shape)))
    dtd = ak.circ_diffs_adjoint(ak.circ_diffs(x, scales), scales)[0]
    via = torch.fft.irfftn(got * torch.fft.rfftn(x[0]), s=shape)
    torch.testing.assert_close(dtd, via, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("alpha", [1.0, 1.8])
@pytest.mark.parametrize("positivity", [True, False])
@pytest.mark.parametrize("scales", [None, (2.0, 1.0, 1.5)])
def test_split_update_plain_matches_jax_step(shape, alpha, positivity, scales):
    """Two lanes with their own lam, updated in place, each against the JAX
    lines on that lane; the wrapper on CPU tensors takes the plain version
    and counts no launch."""
    st = _state(shape, 2, seed=3)
    t = {k: torch.tensor(v) for k, v in st.items()}
    ak.split_launches = 0
    ak.admm_split_update(t["x"], t["z1"], t["u1"], t["z2"], t["u2"], t["lam"], 0.3, alpha, positivity, scales)
    assert ak.split_launches == 0
    for b in range(2):
        want = _jax_split_update(jnp.asarray(st["x"][b]), list(jnp.asarray(st["z1"][b])),
                                 list(jnp.asarray(st["u1"][b])), jnp.asarray(st["z2"][b]), jnp.asarray(st["u2"][b]),
                                 float(st["lam"][b]), 0.3, alpha, positivity, scales)
        for name, w in zip(("z1", "u1", "z2", "u2"), want):
            assert _rel(t[name][b], w) < RTOL, (name, b)
    np.testing.assert_array_equal(t["x"].numpy(), st["x"])  # x is read only


def test_split_update_trailing_faces_and_zero_magnitude():
    """On a trailing face the component passes through unscaled and carries no
    weight in the magnitude; a zero gradient stays finite (tiny under the
    square root keeps s / vmag defined) and gives z1 = 0."""
    shape = (4, 5, 6)
    st = _state(shape, 1, seed=4)
    t = {k: torch.tensor(v) for k, v in st.items()}
    v = ak.circ_diffs(t["x"]) + t["u1"]
    ak.admm_split_update_plain(t["x"], t["z1"], t["u1"], t["z2"], t["u2"], t["lam"], 0.3)
    torch.testing.assert_close(t["z1"][0, 0, -1], v[0, 0, -1], rtol=0, atol=0)
    torch.testing.assert_close(t["z1"][0, 1, :, -1], v[0, 1, :, -1], rtol=0, atol=0)
    torch.testing.assert_close(t["z1"][0, 2, :, :, -1], v[0, 2, :, :, -1], rtol=0, atol=0)
    assert float((t["z1"][0, :, :-1, :-1, :-1].abs() - v[0, :, :-1, :-1, :-1].abs()).max()) < 0  # shrunk inside
    for dtype in (torch.float64, torch.float32):
        z = {k: torch.zeros_like(torch.tensor(st[k]), dtype=dtype) for k in ("x", "z1", "u1", "z2", "u2")}
        ak.admm_split_update_plain(z["x"], z["z1"], z["u1"], z["z2"], z["u2"], torch.tensor([0.5], dtype=dtype), 0.1)
        assert all(bool(torch.isfinite(z[k]).all()) and float(z[k].abs().max()) == 0.0 for k in ("z1", "u1", "z2"))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("scales", [None, (2.0, 1.0, 1.5)])
def test_rhs_plain_matches_jax(shape, scales):
    st = _state(shape, 2, seed=5)
    t = {k: torch.tensor(v) for k, v in st.items()}
    ak.rhs_launches = 0
    got = ak.admm_rhs(t["z1"], t["u1"], t["z2"], t["u2"], t["rho1"], t["rho2"], scales)
    assert ak.rhs_launches == 0 and tuple(got.shape) == (2, *shape)
    for b in range(2):
        diff = [jnp.asarray(z - u) for z, u in zip(st["z1"][b], st["u1"][b])]
        want = st["rho1"][b] * jadmm._circ_diffs_adjoint(diff, scales) + st["rho2"][b] * jnp.asarray(
            st["z2"][b] - st["u2"][b])
        assert _rel(got[b], want) < RTOL


def _prox_settled(vmag, lam, eps):
    """The kernel's Newton loop on float32, element by element: stop after
    step k once the iterate repeats the one before it (a fixed point) or the
    one two before (an orbit of period 2), compared as bit patterns, and
    return step 8's value: the iterate if 8 - k is even, else the one before."""
    f = ak.hyperbolic_prox
    seq = [f(vmag, lam, eps, newton_iters=k).view(torch.int32) for k in range(ak.NEWTON_ITERS + 1)]
    out = seq[-1].clone()
    done = torch.zeros(vmag.shape, dtype=torch.bool)
    for k in range(1, ak.NEWTON_ITERS + 1):
        settled = ~done & ((seq[k] == seq[k - 1]) | (seq[k] == seq[max(k - 2, 0)]))
        out = torch.where(settled, seq[k] if (ak.NEWTON_ITERS - k) % 2 == 0 else seq[k - 1], out)
        done |= settled
    return out.view(torch.float32), done


@pytest.mark.parametrize("lam,eps", [(1.0, 1.0), (0.05, 1.0), (2.0, 0.3), (0.4, 0.01)])
def test_prox_stopped_where_it_settles_is_eight_steps_bitwise(lam, eps):
    """float32: the prox stopped at its bitwise fixed point or period-2 orbit
    (the kernel's rule) equals 8 full steps bit for bit, at v = 0 (vmag =
    sqrt(tiny)), +0 and -0 and across the range; most voxels settle early."""
    tiny = np.finfo(np.float32).tiny
    v = np.concatenate([[np.sqrt(tiny), 0.0, -0.0, tiny, lam, np.nextafter(lam, 0)],
                        np.random.default_rng(6).uniform(0.0, 8.0, 4000),
                        10.0 ** np.random.default_rng(7).uniform(-20, 2, 4000)]).astype(np.float32)
    vmag = torch.tensor(v)
    lam_t = torch.full_like(vmag, lam)
    got, done = _prox_settled(vmag, lam_t, eps)
    want = ak.hyperbolic_prox(vmag, lam_t, eps)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert float(done.double().mean()) > 0.99
    # some settle in an orbit of period 2, which a fixed point alone would run to 8 steps
    seq = [ak.hyperbolic_prox(vmag, lam_t, eps, newton_iters=k).view(torch.int32) for k in (7, 8)]
    assert bool(((seq[1] != seq[0]) & done).any())


def test_reciprocals_round_to_the_tensor_type():
    """1/s in double, rounded to float32 (what PyTorch's CUDA ``t / s``
    multiplies by; 1000 for 0.001, where float32 division gives 999.99994)
    and to float64; the plain differences multiply by them."""
    scales = (3.0, 0.001, 0.7)
    r32 = ak.reciprocals(scales)
    assert r32 == tuple(float(np.float32(1.0 / s)) for s in scales) and r32[1] == 1000.0
    assert ak.reciprocals(scales, torch.float64) == tuple(1.0 / s for s in scales)
    assert ak.reciprocals(None) == (1.0, 1.0, 1.0)
    x = torch.tensor(np.random.default_rng(8).standard_normal((1, 4, 5, 6), dtype=np.float32))
    d = ak.circ_diffs(x, scales)
    for a in range(3):
        want = (torch.roll(x, -1, dims=a + 1) - x).numpy() * np.float32(r32[a])
        np.testing.assert_array_equal(d[:, a].numpy(), want)

