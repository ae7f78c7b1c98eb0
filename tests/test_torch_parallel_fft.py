"""The port's mesh, distributed FFT and the kernels' slab modes on the CPU
(float64), against dense PyTorch and against the JAX package's
``parallel/fft.py`` on the conftest's virtual devices.

- The mesh: ``make_mesh`` shapes and refusals, shard/gather round trips,
  ``constrain_volume`` leaving indivisible shapes whole, the fixed-order dot.
- The distributed rfftn / irfftn / convolution on meshes (1, 2), (1, 4) and
  (2, 2) of CPU entries, against ``torch.fft`` and against JAX's
  ``sharded_rfftn`` on the same mesh shape, to 1e-12 (the same float64
  transforms taken in another order); gradients through the convolution.
- The slab modes' plain versions (what the CPU runs in place of the CUDA slab
  launches): the TV's slab costs summed and gradients concatenated against
  the whole-volume plain version to 1e-12 (autograd may sum a voxel's terms
  in another order); the ADMM split update and rhs concatenated over slabs
  bit for bit equal to the whole-volume plain versions, with the ring wrap
  and the volume's trailing z face in any slab.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.parallel.fft import sharded_rfftn as jax_sharded_rfftn
from microtipi_tpu.parallel.mesh import make_mesh as jax_make_mesh
from microtipi_tpu_torch.ops.kernels import admm_split as ak
from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv
from microtipi_tpu_torch.optim.treeutil import tdot
from microtipi_tpu_torch.parallel.fft import sharded_convolve, sharded_irfftn, sharded_rfftn, sharded_spectrum
from microtipi_tpu_torch.parallel.mesh import (
    Z_AXIS,
    constrain_volume,
    gather,
    make_mesh,
    shard,
    volume_sharding,
)

SHAPE = (16, 32, 32)
MESHES = [(1, 2), (1, 4), (2, 2)]
TOL = 1e-12


def _mesh(b, z):
    return make_mesh(b, z, devices=[torch.device("cpu")] * (b * z))


def _volume(shape, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape))


def _close(a, b, tol=TOL):
    a, b = (torch.as_tensor(np.array(t)) for t in (a, b))
    assert float((a - b).abs().max()) <= tol * max(float(b.abs().max()), 1.0)


def test_make_mesh_shapes_and_refusals(monkeypatch):
    cpu = torch.device("cpu")
    m = make_mesh(2, devices=[cpu] * 6)
    assert m.shape == {"batch": 2, "z": 3} and m.cells()[:4] == [(0, 0), (0, 1), (0, 2), (1, 0)]
    with pytest.raises(ValueError, match="mesh 2x2 != 3 devices"):
        make_mesh(2, 2, devices=[cpu] * 3)
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(2, devices=[cpu] * 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="visible CUDA devices"):
        make_mesh(1, 2)


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("batched", [False, True])
def test_shard_gather_round_trip(mesh_shape, batched):
    mesh = _mesh(*mesh_shape)
    x = _volume((4, *SHAPE) if batched else SHAPE)
    s = shard(x, volume_sharding(mesh, batched))
    assert s.batched == batched and len(s.tiles) == (len(mesh.cells()) if batched else mesh.shape[Z_AXIS])
    assert torch.equal(gather(s), x)
    for t in s.tiles.values():  # every tile is its own copy
        assert t.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()
    assert float(abs(s.sum() - x.sum())) <= 1e-12 * float(x.abs().sum())


def test_constrain_volume_leaves_indivisible_shapes_whole():
    mesh = _mesh(2, 4)
    odd = _volume((10, 16, 16))
    assert constrain_volume(odd, mesh) is odd
    stack = _volume((3, 16, 16, 16))  # 3 frames do not divide 2 rows
    assert constrain_volume(stack, mesh) is stack
    assert torch.equal(gather(constrain_volume(_volume((16, 8, 8)), mesh)), _volume((16, 8, 8)))


def test_tdot_sums_tiles_in_key_order():
    mesh = _mesh(2, 2)
    x = shard(_volume((2, *SHAPE)), mesh)
    v = x.variable()
    assert list(sorted(v)) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    expect = sum((torch.dot(v[k].reshape(-1), v[k].reshape(-1)) for k in sorted(v)[1:]),
                 torch.dot(v[(0, 0)].reshape(-1), v[(0, 0)].reshape(-1)))
    assert torch.equal(tdot(v, v), expect)


@pytest.fixture(scope="module")
def jax_spectra():
    """JAX's distributed rfftn of the same volumes on the same mesh shapes."""
    out = {}
    for b, z in MESHES:
        shape = (2 * b, *SHAPE) if b > 1 else SHAPE
        mesh = jax_make_mesh(b, z, devices=jax.devices()[:b * z])
        out[(b, z)] = np.asarray(jax.jit(lambda v: jax_sharded_rfftn(v, mesh))(jnp.asarray(_volume(shape).numpy())))
    return out


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_sharded_rfftn_matches_torch_and_jax(mesh_shape, jax_spectra):
    b, z = mesh_shape
    x = _volume((2 * b, *SHAPE) if b > 1 else SHAPE)
    y = gather(sharded_rfftn(x, _mesh(b, z)))
    _close(y, torch.fft.rfftn(x, dim=(-3, -2, -1)))
    _close(y, jax_spectra[mesh_shape])


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("shape", [SHAPE, (12, 14, 14)])
def test_irfftn_round_trip_and_convolution(mesh_shape, shape):
    mesh = _mesh(*mesh_shape)
    if shape[0] % mesh.shape[Z_AXIS] or shape[1] % mesh.shape[Z_AXIS]:
        with pytest.raises(ValueError, match="divisible"):
            sharded_rfftn(_volume(shape), mesh)
        return
    x, k = _volume(shape, 1), _volume(shape, 2)
    _close(gather(sharded_irfftn(sharded_rfftn(x, mesh), shape, mesh)), x)
    want = torch.fft.irfftn(torch.fft.rfftn(x) * torch.fft.rfftn(k), s=shape)
    _close(gather(sharded_convolve(x, sharded_spectrum(k, mesh), shape, mesh)), want)


def test_batched_convolution_broadcasts_one_kernel():
    mesh = _mesh(2, 2)
    x, k = _volume((4, *SHAPE), 3), _volume(SHAPE, 4)
    want = torch.fft.irfftn(torch.fft.rfftn(x, dim=(-3, -2, -1)) * torch.fft.rfftn(k), s=SHAPE, dim=(-3, -2, -1))
    _close(gather(sharded_convolve(x, sharded_spectrum(k, mesh), SHAPE, mesh)), want)


def test_gradient_through_sharded_convolve():
    mesh = _mesh(1, 4)
    x, k, d = _volume(SHAPE, 5), _volume(SHAPE, 6), _volume(SHAPE, 7)
    xs = shard(x, mesh)
    leaves = {c: t.requires_grad_(True) for c, t in xs.tiles.items()}
    r = sharded_convolve(xs.with_tiles(leaves), sharded_spectrum(k, mesh), SHAPE, mesh) - shard(d, mesh)
    g = torch.autograd.grad(0.5 * (r * r).sum(), [leaves[c] for c in sorted(leaves)])
    xd = x.clone().requires_grad_(True)
    rd = torch.fft.irfftn(torch.fft.rfftn(xd) * torch.fft.rfftn(k), s=SHAPE) - d
    (gd,) = torch.autograd.grad(0.5 * (rd * rd).sum(), xd)
    _close(torch.cat(g), gd)


CUTS = [(0, 16), (0, 4, 8, 12, 16), (0, 1, 9, 15, 16), (0, 5, 16)]


def _slabs_tv(x, cuts, eps, scales):
    nz = x.shape[1]
    cost, grads = 0.0, []
    for a, b in zip(cuts[:-1], cuts[1:]):
        prev = x[:, a - 1].contiguous() if a > 0 else None
        nxt = x[:, b].contiguous() if b < nz else None
        c, g = hv.hyperbolic_tv_slab_fused(x[:, a:b].contiguous(), prev, nxt, eps, scales)
        cost, grads = cost + c, grads + [g]
    return cost, torch.cat(grads, 1)


@pytest.mark.parametrize("cuts", CUTS)
@pytest.mark.parametrize("eps,scales", [(0.5, None), (1.0, (2.0, 1.0, 0.7))])
def test_tv_slab_plain_sums_to_the_volume(cuts, eps, scales):
    x = _volume((2, *SHAPE), 8)
    costs, grad = _slabs_tv(x, cuts, eps, scales)
    want_c, want_g = hv.hyperbolic_tv_batched_plain(x, eps, scales)
    _close(costs, want_c)
    _close(grad, want_g)


def _admm_state(nb, seed=9):
    rng = np.random.default_rng(seed)

    def t(*s):
        return torch.as_tensor(rng.standard_normal(s))

    return (t(nb, *SHAPE), t(nb, 3, *SHAPE), 0.1 * t(nb, 3, *SHAPE), t(nb, *SHAPE), 0.1 * t(nb, *SHAPE))


@pytest.mark.parametrize("cuts", CUTS)
@pytest.mark.parametrize("alpha,positivity,scales", [(1.0, True, None), (1.8, False, (3.0, 1.0, 0.7))])
def test_admm_slab_plain_versions_put_together_are_the_volume(cuts, alpha, positivity, scales):
    x, z1, u1, z2, u2 = _admm_state(2)
    lam, rho1, rho2 = (torch.tensor(v, dtype=torch.float64) for v in ([0.3, 0.7], [1.0, 2.0], [0.5, 3.0]))
    want = [t.clone() for t in (z1, u1, z2, u2)]
    ak.admm_split_update_plain(x, *want, lam, 0.5, alpha, positivity, scales)
    want_rhs = ak.admm_rhs_plain(z1, u1, z2, u2, rho1, rho2, scales)
    nz = SHAPE[0]
    parts, rhs = [], []
    for a, b in zip(cuts[:-1], cuts[1:]):
        st = [z1[:, :, a:b].clone(), u1[:, :, a:b].clone(), z2[:, a:b].clone(), u2[:, a:b].clone()]
        ak.admm_split_update_slab(x[:, a:b].clone(), x[:, b % nz].clone(), *st, lam, 0.5, a, nz, alpha, positivity,
                                  scales)
        parts.append(st)
        rhs.append(ak.admm_rhs_slab(z1[:, :, a:b], u1[:, :, a:b], z2[:, a:b], u2[:, a:b], z1[:, 0, a - 1].clone(),
                                    u1[:, 0, a - 1].clone(), rho1, rho2, scales))
    got = [torch.cat([p[i] for p in parts], 2 if i < 2 else 1) for i in range(4)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(torch.cat(rhs, 1), want_rhs)
