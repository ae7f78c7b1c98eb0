"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``cuda`` and skipped without a card (the kernels have no CPU or
interpret mode). This file imports neither jax nor the JAX package, so it
also runs on a machine with only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from microtipi_tpu_torch.ops.kernels import admm_split as ak
from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

# float32 against float32 in another summation order (tests/test_pallas_tv.py:25-26).
COST_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 64, 96), (256, 8, 128)])
def test_tv_kernel_matches_plain(shape, cuda_device):
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(shape, dtype=np.float32), device=cuda_device)
    hv.launches = 0
    f, g = hv.hyperbolic_tv_fused(x, 0.1, (2.0, 1.0, 1.0))
    fp, gp = hv.hyperbolic_tv_plain(x, 0.1, (2.0, 1.0, 1.0))
    torch.cuda.synchronize()
    assert hv.launches == 1
    np.testing.assert_allclose(f.item(), fp.item(), rtol=COST_RTOL)
    torch.testing.assert_close(g, gp, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.cuda
def test_tv_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros((4, 8, 8), device=cuda_device)
    with pytest.raises(TypeError):
        hv.hyperbolic_tv_fused(x.double(), 0.1)
    with pytest.raises(ValueError):
        hv.hyperbolic_tv_fused(x[None], 0.1)
    with pytest.raises(ValueError):
        hv.hyperbolic_tv_fused(x.transpose(1, 2), 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 37, 64, 96), (2, 256, 8, 128)])
def test_batched_tv_kernel_matches_plain_and_single(shape, cuda_device):
    """One batched launch: costs and gradient against the plain version,
    and each lane's gradient bitwise equal to the single-volume kernel's."""
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(shape, dtype=np.float32), device=cuda_device)
    hv.launches = hv.batched_launches = 0
    f, g = hv.hyperbolic_tv_batched_fused(x, 0.1, (2.0, 1.0, 1.0))
    fp, gp = hv.hyperbolic_tv_batched_plain(x, 0.1, (2.0, 1.0, 1.0))
    torch.cuda.synchronize()
    assert (hv.launches, hv.batched_launches) == (0, 1)
    np.testing.assert_allclose(f.cpu().numpy(), fp.cpu().numpy(), rtol=COST_RTOL)
    torch.testing.assert_close(g, gp, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    for b in range(shape[0]):
        _, gb = hv.hyperbolic_tv_fused(x[b], 0.1, (2.0, 1.0, 1.0))
        assert torch.equal(g[b], gb)
    with pytest.raises(ValueError):
        hv.hyperbolic_tv_batched_fused(x[0], 0.1)


@pytest.mark.cuda
def test_tv_kernel_unaligned_shapes_and_views(cuda_device):
    """nx % 4 != 0, and nx % 4 == 0 at a base 4 bytes off 16-byte alignment,
    take the 4-byte-copy instantiation: against the plain version, and the
    latter bitwise equal to the TMA instantiation on an aligned copy."""
    rng = np.random.default_rng(5)
    odd = torch.as_tensor(rng.standard_normal((33, 45, 67), dtype=np.float32), device=cuda_device)
    flat = torch.as_tensor(rng.standard_normal(33 * 44 * 68 + 1, dtype=np.float32), device=cuda_device)
    shifted = flat[1:].view(33, 44, 68)
    assert shifted.data_ptr() % 16 != 0
    for x in (odd, shifted):
        hv.launches = hv.unaligned_launches = 0
        f, g = hv.hyperbolic_tv_fused(x, 0.1, (2.0, 1.0, 1.0))
        fp, gp = hv.hyperbolic_tv_plain(x, 0.1, (2.0, 1.0, 1.0))
        torch.cuda.synchronize()
        assert (hv.launches, hv.unaligned_launches) == (1, 1)
        np.testing.assert_allclose(f.item(), fp.item(), rtol=COST_RTOL)
        torch.testing.assert_close(g, gp, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    hv.unaligned_launches = 0
    fa, ga = hv.hyperbolic_tv_fused(shifted.clone(), 0.1)
    assert hv.unaligned_launches == 0
    fo, go = hv.hyperbolic_tv_fused(shifted, 0.1)
    assert hv.unaligned_launches == 1
    assert torch.equal(fa, fo) and torch.equal(ga, go)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 33, 45, 67), (2, 40, 24, 72)])
def test_batched_lanes_bitwise_the_single_volume_launch(shape, cuda_device):
    """Each lane's cost and gradient are the single-volume launch's bit for
    bit (the kernel sums each volume's partials in the same order), for
    aligned lanes and for the lane views of an odd-shaped batch."""
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(shape, dtype=np.float32), device=cuda_device)
    hv.unaligned_launches = 0
    f, g = hv.hyperbolic_tv_batched_fused(x, 0.1, (2.0, 1.0, 1.0))
    for b in range(shape[0]):
        fb, gb = hv.hyperbolic_tv_fused(x[b], 0.1, (2.0, 1.0, 1.0))
        assert torch.equal(f[b], fb) and torch.equal(g[b], gb)
    unaligned = shape[-1] % 4 != 0
    assert hv.unaligned_launches == (1 + shape[0] if unaligned else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 128, 128), (2, 33, 45, 67)])
def test_two_launches_bitwise_equal(shape, cuda_device):
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(shape, dtype=np.float32), device=cuda_device)
    fused = hv.hyperbolic_tv_batched_fused if len(shape) == 4 else hv.hyperbolic_tv_fused
    f1, g1 = fused(x, 1.0)
    f2, g2 = fused(x, 1.0)
    assert torch.equal(f1, f2) and torch.equal(g1, g2)


def _admm_state(shape, device, seed=0):
    """x, z1, u1, z2, u2 of a batch and per-lane lam, rho1, rho2 that differ."""
    rng = np.random.default_rng(seed)
    nb = shape[0]

    def normal(s):
        return torch.as_tensor(rng.standard_normal(s, dtype=np.float32), device=device)

    st = {"x": normal(shape), "z1": normal((nb, 3, *shape[1:])), "u1": normal((nb, 3, *shape[1:])),
          "z2": normal(shape), "u2": normal(shape)}
    st.update({k: torch.as_tensor(rng.uniform(0.05, 2.0, nb).astype(np.float32), device=device)
               for k in ("lam", "rho1", "rho2")})
    return st


def _offset_copy(t):
    """A copy of ``t`` whose base lies 4 bytes off 16-byte alignment."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


def _split_and_rhs_match_plain(st, alpha, positivity, scales):
    """The split update and the rhs on ``st`` against their plain versions on
    clones: bit for bit at every scale (both multiply by the same float32
    reciprocals of the scales). Returns the split update's launches of its
    4-byte instantiation."""
    pl = {k: v.clone() for k, v in st.items()}
    ak.split_launches = ak.rhs_launches = ak.split_unaligned_launches = 0
    ak.admm_split_update(st["x"], st["z1"], st["u1"], st["z2"], st["u2"], st["lam"], 0.3, alpha, positivity, scales)
    ak.admm_split_update_plain(pl["x"], pl["z1"], pl["u1"], pl["z2"], pl["u2"], pl["lam"], 0.3, alpha, positivity,
                               scales)
    rhs = ak.admm_rhs(st["z1"], st["u1"], st["z2"], st["u2"], st["rho1"], st["rho2"], scales)
    rhs_plain = ak.admm_rhs_plain(st["z1"], st["u1"], st["z2"], st["u2"], st["rho1"], st["rho2"], scales)
    torch.cuda.synchronize()
    assert (ak.split_launches, ak.rhs_launches) == (1, 1)
    for name in ("z1", "u1", "z2", "u2"):
        assert torch.equal(st[name], pl[name]), name
    assert torch.equal(rhs, rhs_plain)
    assert torch.equal(st["x"], pl["x"])  # read only
    return ak.split_unaligned_launches


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 37, 64, 96), (1, 33, 45, 67), (3, 37, 64, 96)])
@pytest.mark.parametrize("alpha", [1.0, 1.8])
@pytest.mark.parametrize("positivity", [True, False])
@pytest.mark.parametrize("scales", [None, (2.0, 1.0, 1.0), (3.0, 1.0, 0.7)])
def test_admm_kernels_match_plain(shape, alpha, positivity, scales, cuda_device):
    """Bit for bit at every scale; nx = 67 takes the 4-byte instantiation."""
    st = _admm_state(shape, cuda_device)
    assert _split_and_rhs_match_plain(st, alpha, positivity, scales) == (shape[-1] % 4 != 0)


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [1.0, 1.8])
@pytest.mark.parametrize("scales", [None, (3.0, 1.0, 0.7)])
def test_admm_split_update_unaligned_views_match_plain(alpha, scales, cuda_device):
    """Views 4 bytes off 16-byte alignment (nx % 4 == 0) take the 4-byte
    instantiation and equal the plain version, and so the 16-byte
    instantiation on aligned copies, bit for bit."""
    base = _admm_state((2, 20, 24, 36), cuda_device, seed=4)
    st = {k: _offset_copy(v) if v.ndim > 1 else v.clone() for k, v in base.items()}
    assert st["x"].data_ptr() % 16 != 0
    assert _split_and_rhs_match_plain(st, alpha, True, scales) == 1
    aligned = {k: v.clone() for k, v in base.items()}
    assert _split_and_rhs_match_plain(aligned, alpha, True, scales) == 0
    assert all(torch.equal(st[k], aligned[k]) for k in ("z1", "u1", "z2", "u2"))


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [1.0, 1.8])
def test_admm_split_update_zero_gradient_regions(alpha, cuda_device):
    """A state whose first half along z has v = 0 (x constant, u1 = z1 = 0:
    vmag = sqrt(tiny)) and a random second half: bit for bit the plain
    version, and z1 = 0 where v = 0."""
    st = _admm_state((1, 16, 32, 64), cuda_device, seed=5)
    for k in ("z1", "u1"):
        st[k][:, :, :8] = 0.0
    st["x"][:, :9] = 1.5
    _split_and_rhs_match_plain(st, alpha, True, (3.0, 1.0, 0.7))
    assert float(st["z1"][:, :, :8].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("s", [3.0, 0.7, 1.3, 2.0, 0.2, 1e-3, 7.77])
def test_host_reciprocal_is_what_cuda_division_multiplies_by(s, cuda_device):
    """PyTorch's CUDA ``t / s`` for a Python scalar is ``t * r`` with r the
    reciprocal that ``reciprocals`` rounds on the host (the double 1/s
    rounded to float32), here and at 500 scales around s."""
    t = torch.as_tensor(np.random.default_rng(6).standard_normal(4096, dtype=np.float32), device=cuda_device)
    one = torch.ones(1, device=cuda_device)
    for sc in [s, *(s * np.random.default_rng(7).uniform(0.5, 2.0, 500))]:
        r = ak.reciprocals((sc, sc, sc))[0]
        assert float((one / sc).item()) == r, sc
        assert torch.equal(t / sc, t * r), sc


@pytest.mark.cuda
def test_admm_kernel_lanes_are_single_launches(cuda_device):
    """Each lane of a batched launch is bitwise the launch on that lane alone
    with its own lam and rhos."""
    st = _admm_state((3, 20, 33, 47), cuda_device, seed=1)
    one = [{k: v[b:b + 1].clone() for k, v in st.items()} for b in range(3)]
    ak.admm_split_update(st["x"], st["z1"], st["u1"], st["z2"], st["u2"], st["lam"], 0.3, 1.8)
    rhs = ak.admm_rhs(st["z1"], st["u1"], st["z2"], st["u2"], st["rho1"], st["rho2"])
    for b, o in enumerate(one):
        ak.admm_split_update(o["x"], o["z1"], o["u1"], o["z2"], o["u2"], o["lam"], 0.3, 1.8)
        assert all(torch.equal(st[k][b], o[k][0]) for k in ("z1", "u1", "z2", "u2"))
        assert torch.equal(rhs[b], ak.admm_rhs(o["z1"], o["u1"], o["z2"], o["u2"], o["rho1"], o["rho2"])[0])


@pytest.mark.cuda
def test_admm_prox_against_float64(cuda_device):
    """With x = u1 = 0 and z1 = v the relaxed difference is (1 - alpha) v, so
    at alpha = 0 the update returns prox(|v|) v / |v|: the kernel's float32
    Newton steps against the float64 prox, to 4 float32 ulp of the largest
    value."""
    shape, lam, eps = (1, 8, 16, 32), 0.4, 0.3
    rng = np.random.default_rng(2)
    v = torch.as_tensor(rng.uniform(-3.0, 3.0, (1, 3, *shape[1:])).astype(np.float32), device=cuda_device)
    z1, u1 = v.clone(), torch.zeros_like(v)
    x = torch.zeros(shape, device=cuda_device)
    ak.admm_split_update(x, z1, u1, torch.zeros_like(x), torch.zeros_like(x),
                         torch.tensor([lam], device=cuda_device), eps, alpha=0.0)
    inner = (slice(None), slice(None), slice(0, -1), slice(0, -1), slice(0, -1))  # off the trailing faces
    v64 = v.double()
    mag = torch.sqrt((v64 * v64).sum(1, keepdim=True))
    want = (ak.hyperbolic_prox(mag, lam, eps, newton_iters=50) / mag * v64)[inner]
    assert float((z1.double()[inner] - want).abs().max()) <= 4 * np.finfo(np.float32).eps * float(want.abs().max())


@pytest.mark.cuda
def test_admm_kernels_reject_what_they_do_not_take(cuda_device):
    st = _admm_state((2, 4, 8, 8), cuda_device)
    args = [st[k] for k in ("x", "z1", "u1", "z2", "u2", "lam")]
    with pytest.raises(TypeError):
        ak.admm_split_update(*[a.double() for a in args], 0.3)
    with pytest.raises(ValueError, match="contiguous"):
        ak.admm_split_update(st["x"].transpose(2, 3).contiguous().transpose(2, 3), *args[1:], 0.3)
    with pytest.raises(ValueError, match="expected shape"):
        ak.admm_split_update(st["x"], st["z1"][:, :2].contiguous(), *args[2:], 0.3)
    with pytest.raises(ValueError, match="batch"):
        ak.admm_split_update(st["x"][0], *args[1:], 0.3)
    with pytest.raises(ValueError, match="one device"):
        ak.admm_rhs(st["z1"], st["u1"], st["z2"], st["u2"], st["rho1"].cpu(), st["rho2"])
    with pytest.raises(TypeError):
        ak.admm_rhs(st["z1"], st["u1"], st["z2"].double(), st["u2"].double(), st["rho1"], st["rho2"])


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True])
def test_admm_engine_launches_its_kernels_once_an_iteration(batched, cuda_device):
    """On the card the engine goes through both kernels once an iteration and
    through the TV kernel for every objective value (f0, one an iteration when
    tracking, the final f); two runs agree bit for bit."""
    from microtipi_tpu_torch.jobs.admm import admm_deconvolve
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig

    rng = np.random.default_rng(3)
    shape = (2, 16, 32, 32) if batched else (16, 32, 32)
    data = torch.as_tensor(rng.uniform(0.0, 10.0, shape).astype(np.float32), device=cuda_device)
    psf = torch.zeros(shape[-3:], device=cuda_device)
    psf[:2, :2, :2] = 0.125
    cfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=7)
    runs = []
    for track in (True, False, False):
        ak.split_launches = ak.rhs_launches = hv.launches = hv.batched_launches = 0
        runs.append(admm_deconvolve(data, psf, config=cfg, track_objective=track))
        assert (ak.split_launches, ak.rhs_launches) == (7, 7)
        assert hv.launches + hv.batched_launches == (9 if track else 2)
    assert torch.equal(runs[1].x, runs[2].x) and torch.equal(runs[0].x, runs[1].x)
    assert np.array_equal(runs[1].f, runs[2].f) and bool(torch.isfinite(runs[0].x).all())


def _rl_inputs(shape, lanes, device):
    """Float32 sparse beads blurred by a separable Gaussian PSF, plus noise;
    ``lanes`` scenes of ``shape``, and the PSF."""
    rng = np.random.default_rng(6)
    axes = [np.minimum(np.arange(n), n - np.arange(n)) for n in shape]
    psf = np.exp(-axes[0][:, None, None] ** 2 / 2.0 - axes[1][None, :, None] ** 2 / 4.0
                 - axes[2][None, None, :] ** 2 / 4.0)
    psf = torch.as_tensor(psf / psf.sum(), dtype=torch.float32, device=device)
    obj = rng.random((lanes, *shape), dtype=np.float32) * (rng.random((lanes, *shape)) > 0.99) * 300
    obj = torch.as_tensor(obj, device=device)
    dims = (-3, -2, -1)
    data = torch.fft.irfftn(torch.fft.rfftn(obj, dim=dims) * torch.fft.rfftn(psf), s=shape, dim=dims)
    noise = torch.as_tensor(rng.standard_normal((lanes, *shape), dtype=np.float32), device=device)
    return data + 0.5 * noise, psf


@pytest.mark.cuda
def test_rl_tv_steps_through_the_kernel_match_plain(cuda_device, monkeypatch):
    """RL-TV, 3 iterations at 32x64x64: the TV kernel once an iteration, and
    x against the same run with its TV gradient from the plain version, to
    1e-5 relative L2 (the gradients agree to the kernel's 1e-4 rtol, scaled
    by mu = 0.01 inside a denominator near 1)."""
    import importlib

    rl = importlib.import_module("microtipi_tpu_torch.jobs.richardson_lucy")  # the package exports the function
    data, psf = _rl_inputs((32, 64, 64), 1, cuda_device)
    hv.launches = hv.batched_launches = 0
    got = rl.richardson_lucy(data[0], psf, iterations=3, mu=0.01, epsilon=1.0)
    torch.cuda.synchronize()
    assert (hv.launches, hv.batched_launches) == (3, 0)
    monkeypatch.setattr(rl, "hyperbolic_tv_fused", hv.hyperbolic_tv_plain)
    want = rl.richardson_lucy(data[0], psf, iterations=3, mu=0.01, epsilon=1.0)
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) < 1e-5
    assert bool(torch.isfinite(got).all()) and float(got.min()) >= 0.0


@pytest.mark.cuda
def test_batched_rl_lanes_match_single_rl(cuda_device):
    """Three lanes of RL-TV in one batched run, 10 iterations: one batched TV
    launch an iteration and no single-volume launch; each lane against
    ``richardson_lucy`` of its volume to 1e-4 relative L2 (cuFFT rounds a
    batch otherwise than one volume; RL has no line search to amplify it)."""
    from microtipi_tpu_torch.jobs.richardson_lucy import richardson_lucy

    data, psf = _rl_inputs((16, 64, 64), 3, cuda_device)
    hv.launches = hv.batched_launches = 0
    xs = richardson_lucy(data, psf, iterations=10, mu=0.01, epsilon=1.0)
    torch.cuda.synchronize()
    assert (hv.launches, hv.batched_launches) == (0, 10)
    for b in range(3):
        one = richardson_lucy(data[b], psf, iterations=10, mu=0.01, epsilon=1.0)
        assert float(torch.linalg.norm(xs[b] - one) / torch.linalg.norm(one)) < 1e-4


def _depthvar_inputs(shape, lanes, device):
    """``lanes`` scenes of :func:`_rl_inputs` and 3 Gaussian anchor PSFs that
    widen with depth, at anchors 0, (nz-1)/2 and nz-1."""
    data, _ = _rl_inputs(shape, lanes, device)
    axes = [np.minimum(np.arange(n), n - np.arange(n)) for n in shape]
    psfs = []
    for width in (1.0, 2.0, 3.0):
        h = np.exp(-axes[0][:, None, None] ** 2 / (2.0 * width) - (axes[1][None, :, None] ** 2
                                                                     + axes[2][None, None, :] ** 2) / (4.0 * width))
        psfs.append(h / h.sum())
    return data, torch.as_tensor(np.stack(psfs), dtype=torch.float32, device=device), np.linspace(0, shape[0] - 1, 3)


@pytest.mark.cuda
def test_depthvar_steps_through_the_kernel_match_plain(cuda_device, monkeypatch):
    """``deconvolve_depthvar``, 3 VMLMB iterations at 32x64x64: the TV kernel
    once an evaluation, and the run against the same run with the plain TV:
    f_history to 1e-4 relative, x to 1e-3 relative L2 (the TV costs agree to
    the kernel's 1e-5 rtol, a small part of f)."""
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
    from microtipi_tpu_torch.jobs.depthvar import deconvolve_depthvar

    data, psfs, anchors = _depthvar_inputs((32, 64, 64), 1, cuda_device)
    cfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=3, grtol=0.0, gatol=0.0)
    hv.launches = hv.batched_launches = hv.unaligned_launches = 0
    got = deconvolve_depthvar(data[0], psfs, anchors, config=cfg)
    torch.cuda.synchronize()
    assert (hv.launches, hv.batched_launches, hv.unaligned_launches) == (got.evaluations, 0, 0)
    monkeypatch.setattr(hv, "hyperbolic_tv_fused", hv.hyperbolic_tv_plain)
    want = deconvolve_depthvar(data[0], psfs, anchors, config=cfg)
    assert np.max(np.abs(got.f_history - want.f_history) / np.abs(want.f_history)) < 1e-4
    assert float(torch.linalg.norm(got.x - want.x) / torch.linalg.norm(want.x)) < 1e-3
    assert bool(torch.isfinite(got.x).all()) and float(got.x.min()) >= 0.0


@pytest.mark.cuda
def test_rl_tv_depthvar_steps_through_the_kernel_match_plain(cuda_device, monkeypatch):
    """``richardson_lucy_depthvar`` with RL-TV, 3 iterations at 32x64x64: one
    TV launch an iteration, x against the plain TV's to 1e-5 relative L2,
    as RL-TV's own test above."""
    import importlib

    from microtipi_tpu_torch.jobs.depthvar import richardson_lucy_depthvar

    rl = importlib.import_module("microtipi_tpu_torch.jobs.richardson_lucy")
    data, psfs, anchors = _depthvar_inputs((32, 64, 64), 1, cuda_device)
    hv.launches = hv.batched_launches = 0
    got = richardson_lucy_depthvar(data[0], psfs, anchors, iterations=3, mu=0.01, epsilon=1.0)
    torch.cuda.synchronize()
    assert (hv.launches, hv.batched_launches) == (3, 0)
    monkeypatch.setattr(rl, "hyperbolic_tv_fused", hv.hyperbolic_tv_plain)
    want = richardson_lucy_depthvar(data[0], psfs, anchors, iterations=3, mu=0.01, epsilon=1.0)
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) < 1e-5
    assert bool(torch.isfinite(got).all()) and float(got.min()) >= 0.0


@pytest.mark.cuda
def test_batched_depthvar_launches_the_batched_kernel(cuda_device):
    """Two lanes of ``batched_deconvolve_depthvar``, 5 iterations: one batched
    TV launch a lockstep step and none of one volume; each lane against
    ``deconvolve_depthvar`` of its scene, f over the first iterations to 1e-4
    relative and the final f to 1e-3 (``chip_smoke.py`` phase 4's bounds)."""
    from microtipi_tpu_torch.jobs.batch import batched_deconvolve_depthvar
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
    from microtipi_tpu_torch.jobs.depthvar import deconvolve_depthvar

    data, psfs, anchors = _depthvar_inputs((16, 64, 64), 2, cuda_device)
    cfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=5, grtol=0.0, gatol=0.0)
    hv.launches = hv.batched_launches = hv.unaligned_launches = 0
    res = batched_deconvolve_depthvar(data, psfs, anchors, config=cfg)
    torch.cuda.synchronize()
    assert (hv.launches, hv.batched_launches, hv.unaligned_launches) == (0, int(np.max(res.evaluations)), 0)
    for b in range(2):
        one = deconvolve_depthvar(data[b], psfs, anchors, config=cfg)
        assert np.max(np.abs(res.f_history[b, :4] - one.f_history[:4]) / np.abs(one.f_history[:4])) < 1e-4
        assert abs(float(res.f[b]) - float(one.f)) / abs(float(one.f)) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("block", [(3, 20, 33, 48), (2, 3, 20, 33, 48)], ids=["series", "5d_view"])
@pytest.mark.parametrize("alpha", [1.0, 1.8])
def test_admm_kernels_on_joint_blocks_match_plain(block, alpha, cuda_device):
    """The joint engines' lanes: a (T, Nz, Ny, Nx) series and the (T * C)
    view of a (T, C) + vol block (the stacks (T * C, 3) + vol), bit for bit
    against the plain versions."""
    vol, nb = block[-3:], int(np.prod(block[:-3]))
    st = _admm_state((nb, *vol), cuda_device, seed=8)
    five = {k: v.view(*block[:-3], *v.shape[1:]) for k, v in st.items() if v.ndim > 1}
    views = {k: v.view(nb, *v.shape[len(block) - 3:]) for k, v in five.items()}
    views.update({k: st[k] for k in ("lam", "rho1", "rho2")})
    assert views["x"].data_ptr() == st["x"].data_ptr() and views["z1"].shape == (nb, 3, *vol)
    assert _split_and_rhs_match_plain(views, alpha, True, (2.0, 1.0, 1.0)) == 0


@pytest.mark.cuda
def test_batched_tv_lane_sum_is_the_plain_4d_tv(cuda_device):
    """The time series' spatial TV, one batched launch summed over its T
    lanes, against the plain TV of the 4D tensor over its last three axes:
    the sum and the gradient."""
    from microtipi_tpu_torch.ops.regularization import hyperbolic_tv

    x = torch.as_tensor(np.random.default_rng(9).standard_normal((4, 20, 32, 48), dtype=np.float32),
                        device=cuda_device).requires_grad_(True)
    hv.batched_launches = 0
    f = hv.hyperbolic_tv_batched_value(x, 0.1, (2.0, 1.0, 1.0)).sum()
    (g,) = torch.autograd.grad(f, x)
    fp = hyperbolic_tv(x, 0.1, (2.0, 1.0, 1.0), axes=(-3, -2, -1))
    (gp,) = torch.autograd.grad(fp, x)
    assert hv.batched_launches == 1
    np.testing.assert_allclose(f.item(), fp.item(), rtol=COST_RTOL)
    torch.testing.assert_close(g, gp, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def _joint_inputs(device, t=3, c=2, vol=(8, 16, 32)):
    """Float32 (T, C) + vol data on the card (sparse beads blurred by one
    separable Gaussian PSF a channel, plus noise) and the PSFs."""
    rng = np.random.default_rng(10)
    axes = [np.minimum(np.arange(n), n - np.arange(n)) for n in vol]
    psfs = np.stack([np.exp(-axes[0][:, None, None] ** 2 / w - axes[1][None, :, None] ** 2 / (2 * w)
                            - axes[2][None, None, :] ** 2 / (2 * w)) for w in (1.5, 2.5)[:c]])
    psfs /= psfs.sum(axis=(1, 2, 3), keepdims=True)
    obj = rng.random((t, c, *vol)) * (rng.random((t, c, *vol)) > 0.98) * 300
    data = np.fft.irfftn(np.fft.rfftn(obj, axes=(2, 3, 4)) * np.fft.rfftn(psfs, axes=(1, 2, 3)), s=vol,
                         axes=(2, 3, 4)) + rng.standard_normal((t, c, *vol))
    return (torch.as_tensor(data, dtype=torch.float32, device=device),
            torch.as_tensor(psfs, dtype=torch.float32, device=device))


@pytest.mark.cuda
def test_joint_entry_points_run_on_the_card(cuda_device):
    """Each joint entry point on CUDA tensors keeps them on the card and goes
    through its kernels: one batched TV launch a VMLMB evaluation (time
    series, separate, 5D), none for the joint TV; one split update and one
    rhs an iteration (no split update for joint), one TV launch a tracked
    ADMM iteration plus f0 and the final f; superres on the single-volume
    TV kernel."""
    from microtipi_tpu_torch.jobs import admm, multichannel, superres, timeseries
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig

    data, psfs = _joint_inputs(cuda_device)
    cfg = DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=5, grtol=0.0)

    def counted(run):
        hv.launches = hv.batched_launches = hv.unaligned_launches = 0
        ak.split_launches = ak.rhs_launches = ak.split_unaligned_launches = 0
        res = run()
        torch.cuda.synchronize()
        assert res.x.device.type == "cuda" and bool(torch.isfinite(res.x).all()) and np.isfinite(res.f)
        assert hv.unaligned_launches == ak.split_unaligned_launches == 0
        return res, (hv.launches, hv.batched_launches, ak.split_launches, ak.rhs_launches)

    bleach = torch.tensor([1.0, 0.9, 0.8], device=cuda_device)
    res, n = counted(lambda: timeseries.deconvolve_timeseries(data[:, 0], psfs[0], config=cfg, mu_t=0.05,
                                                              bleach=bleach))
    assert n == (0, res.evaluations, 0, 0)
    res, n = counted(lambda: admm.admm_deconvolve_timeseries(data[:, 0], psfs[0], config=cfg, mu_t=0.05))
    assert n == (0, 7, 5, 5)
    for coupling, tv in (("separate", 1), ("joint", 0)):
        res, n = counted(lambda: multichannel.deconvolve_multichannel(data[0], psfs, config=cfg, coupling=coupling))
        assert n == (0, tv * res.evaluations, 0, 0)
        res, n = counted(lambda: admm.admm_deconvolve_multichannel(data[0], psfs, config=cfg, coupling=coupling))
        assert n == (0, tv * 7, tv * 5, 5)
    mix = torch.tensor([[0.85, 0.25], [0.15, 0.75]], device=cuda_device)
    res, n = counted(lambda: multichannel.deconvolve_timeseries_multichannel(
        data, psfs, config=cfg, mu_t=0.05, coupling="separate", mixing=mix))
    assert n == (0, res.evaluations, 0, 0) and res.x.shape == data.shape
    res, n = counted(lambda: admm.admm_deconvolve_timeseries_multichannel(
        data, psfs, config=cfg, mu_t=0.05, bleach=torch.ones(3, 2, device=cuda_device), coupling="separate",
        track_objective=False))
    assert n == (0, 2, 5, 5)
    fine = superres.upsample_psf(psfs[0], (1, 2, 2))
    assert fine.device.type == "cuda" and fine.shape == (8, 32, 64)
    res, n = counted(lambda: superres.deconvolve_superres(data[0, 0], fine, (1, 2, 2), config=cfg))
    assert n == (res.evaluations, 0, 0, 0) and res.x.shape == (8, 32, 64)
    res, n = counted(lambda: superres.admm_deconvolve_superres(data[0, 0], fine, (1, 2, 2), config=cfg))
    assert n == (7, 0, 5, 5)
    assert multichannel.mixing_from_controls([np.ones((2, 3, 3)), np.ones((2, 3, 3))]).device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 64, 256, 256), (3, 64, 256, 256), (2, 64, 256, 256), (1, 64, 256, 256),
                                   (2, 256, 256, 256), (1, 256, 256, 256)])
def test_batched_tv_kernel_at_the_blind_batches(shape, cuda_device):
    """The batched blind loop's lockstep batches (4 frames of 64x256x256, and
    fewer once lanes finish) and the tiled loop's last lanes of 256^3: costs
    and gradient against the plain version, each lane bitwise the
    single-volume kernel."""
    x = torch.as_tensor(np.random.default_rng(11).standard_normal(shape, dtype=np.float32), device=cuda_device)
    hv.batched_launches = hv.unaligned_launches = 0
    f, g = hv.hyperbolic_tv_batched_fused(x, 1.0)
    fp, gp = hv.hyperbolic_tv_batched_plain(x, 1.0)
    torch.cuda.synchronize()
    assert (hv.batched_launches, hv.unaligned_launches) == (1, 0)
    np.testing.assert_allclose(f.cpu().numpy(), fp.cpu().numpy(), rtol=COST_RTOL)
    torch.testing.assert_close(g, gp, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    for b in range(shape[0]):
        assert torch.equal(g[b], hv.hyperbolic_tv_fused(x[b], 1.0)[1])


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [1.0, 1.8])
def test_admm_kernels_at_the_blind_batch(alpha, cuda_device):
    """The per-frame ADMM blind loop's lanes, 4 x 64x256x256, bit for bit
    against the plain versions."""
    assert _split_and_rhs_match_plain(_admm_state((4, 64, 256, 256), cuda_device, seed=12), alpha, True, None) == 0


def _blind_inputs(device, frames=2, shape=(16, 64, 64)):
    """Float32 frames of sparse beads blurred by an aberrated wide-field PSF on
    the card, and the model."""
    from microtipi_tpu_torch.models.widefield import WideFieldConfig, WideFieldModel

    model = WideFieldModel(WideFieldConfig(shape=shape, na=1.4, wavelength=561e-9, ni=1.518, dxy=80e-9, dz=200e-9,
                                           n_phase=6, dtype=torch.float32), device)
    params = model.init_params()._replace(phase=torch.tensor([0.15, -0.1, 0.08, 0.0, 0.05, 0.0], device=device))
    rng = np.random.default_rng(13)
    obj = torch.as_tensor(rng.random((frames, *shape), dtype=np.float32) * (rng.random((frames, *shape)) > 0.99)
                          * 300, device=device)
    with torch.no_grad():
        k_hat = torch.fft.rfftn(model.compute_psf(params))
        data = torch.fft.irfftn(torch.fft.rfftn(obj, dim=(1, 2, 3)) * k_hat, s=shape, dim=(1, 2, 3))
    return data + 0.01 * data.max() * torch.as_tensor(rng.standard_normal(data.shape, dtype=np.float32),
                                                      device=device), model


@pytest.mark.cuda
@pytest.mark.parametrize("joint_psf", [False, True])
def test_batched_blind_runs_through_the_batched_kernel(joint_psf, cuda_device):
    """Two rounds of ``batched_blind_deconvolve`` on the card: the object
    steps launch the batched TV kernel (none of one volume), the result stays
    on the card, and the object cost falls."""
    from microtipi_tpu_torch.jobs.batch import batched_blind_deconvolve
    from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig
    from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
    from microtipi_tpu_torch.models.microscope import DEFOCUS, PHASE

    data, model = _blind_inputs(cuda_device)
    cfg = BlindDeconvConfig(loops=2, families=(DEFOCUS, PHASE), psf_max_iter=(3, 3), joint_fit=True,
                            deconv=DeconvolutionConfig(mu=0.01, epsilon=1.0, max_iter=5, grtol=0.0, gatol=0.0))
    hv.launches = hv.batched_launches = hv.unaligned_launches = 0
    res = batched_blind_deconvolve(data, model, config=cfg, joint_psf=joint_psf)
    torch.cuda.synchronize()
    assert (hv.launches, hv.unaligned_launches) == (0, 0) and hv.batched_launches > 0
    assert res.obj.device.type == "cuda" and bool(torch.isfinite(res.obj).all())
    df = res.deconv_f if joint_psf else res.deconv_f.T
    assert np.all(np.diff(df, axis=0) < 0)


@pytest.mark.cuda
def test_streamed_statistics_on_the_card(cuda_device):
    """The streamed fit statistics default to the card: float32 blocks there
    against the float64 CPU pass to 1e-5 of the largest value, and the
    float64 fit on the card against the CPU one."""
    from microtipi_tpu_torch.jobs import tiled_blind
    from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig
    from microtipi_tpu_torch.models.microscope import DEFOCUS, PHASE
    from microtipi_tpu_torch.models.widefield import WideFieldConfig, WideFieldModel

    rng = np.random.default_rng(14)
    obj = (rng.random((16, 64, 64)) * (rng.random((16, 64, 64)) > 0.99) * 300).astype(np.float32)
    data = obj + rng.random((16, 64, 64), dtype=np.float32)
    card = tiled_blind.streamed_fit_stats(obj, data, (4, 16, 16), tile=(8, 32, 32))
    host = tiled_blind.streamed_fit_stats(obj.astype(np.float64), data.astype(np.float64), (4, 16, 16),
                                          tile=(8, 32, 32), device="cpu")
    assert card.rho.device.type == "cuda" and card.rho.dtype == torch.float64
    for a, b in ((card.rho, host.rho), (card.b, host.b)):
        assert float(torch.max(torch.abs(a.cpu() - b)) / torch.max(torch.abs(b))) < 1e-5
    fits = []
    for stats, dev in ((card, cuda_device), (host, torch.device("cpu"))):
        m = WideFieldModel(WideFieldConfig(shape=(4, 16, 16), na=1.4, wavelength=561e-9, ni=1.518, dxy=80e-9,
                                           dz=200e-9, n_phase=6, dtype=torch.float64), dev)
        fits.append(tiled_blind.fit_psf_streamed(m, m.init_params(), (DEFOCUS, PHASE), stats,
                                                 PsfFitConfig(max_iter=4)))
    assert fits[0][0].phase.device.type == "cuda"
    np.testing.assert_allclose(fits[0][1], fits[1][1], rtol=1e-6)


@pytest.mark.cuda
def test_estimation_and_image_ops_stay_on_the_card(cuda_device):
    """Every new entry point on CUDA tensors returns CUDA tensors: pupil
    retrieval, the diversity fit and its error bars, SIM, ISM and the image
    ops."""
    from microtipi_tpu_torch.jobs import diversity, ism, phase_retrieval, sim
    from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig
    from microtipi_tpu_torch.models import ISMConfig, ISMModel
    from microtipi_tpu_torch.models.microscope import PHASE
    from microtipi_tpu_torch.ops import geometry, metrics, preprocess, register

    data, model = _blind_inputs(cuda_device, frames=2)
    bead = phase_retrieval.retrieve_pupil(model, data[0], config=PsfFitConfig(max_iter=3), gs_iterations=2)
    ph = diversity.defocus_diversity(model, [-2e-7, 2e-7])
    fit = diversity.fit_psf_diversity(model, data, ph, (PHASE,), config=PsfFitConfig(max_iter=3))
    unc = diversity.diversity_fit_uncertainty(model, fit.params, (PHASE,), data, ph)
    otf = torch.fft.fft2(model.compute_psf(model.init_params())[0].to(torch.complex64))
    raw = sim.simulate_sim(data[0, 0], otf, np.array([[0.2, 0.1]]), np.array([[0.0, 2.1, 4.2]]))
    icfg = ISMConfig(shape=(16, 64, 64), na=1.4, wavelength=561e-9, wavelength_exc=488e-9, ni=1.518, dxy=80e-9,
                     dz=200e-9, n_phase=6, dtype=torch.float32, element_pitch=80e-9, rings=1)
    imodel = ISMModel(icfg, cuda_device)
    elements = data[0][None].expand(7, -1, -1, -1)
    outs = [bead.phi, bead.psf, fit.params.phase, unc.cov, raw, sim.reconstruct_sim(raw, otf, [[0.2, 0.1]],
                                                                                      [[0.0, 2.1, 4.2]]).x,
            ism.ism_element_gains(imodel, imodel.init_params(), elements), ism.ism_reassign(imodel, elements),
            ism.ism_richardson_lucy(imodel, imodel.init_params(), elements, iterations=2),
            register.register_timeseries(data)[1], metrics.fourier_shell_correlation(data[0], data[1])[1],
            preprocess.destripe(data), preprocess.estimate_bleach(data), preprocess.remove_hot_pixels(data[0]),
            preprocess.subtract_background(data[0], 3), geometry.deskew(data[0], 31.8, 2e-7, 80e-9)[0]]
    torch.cuda.synchronize()
    for i, t in enumerate(outs):
        assert t.device.type == "cuda", i


SLAB_CUTS = [(0, 64), (0, 16, 32, 48, 64), (0, 1, 31, 63, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 64, 96), (1, 64, 45, 67)])
@pytest.mark.parametrize("cuts", SLAB_CUTS)
def test_tv_slab_launches_match_plain_and_the_volume(shape, cuts, cuda_device):
    """Each slab launch (the TMA instantiation, and the 4-byte one at nx =
    67) against its plain version; the slabs' gradients put together are the
    whole-volume launch's bit for bit, their costs its cost to float32
    round-off."""
    x = torch.as_tensor(np.random.default_rng(11).standard_normal(shape, dtype=np.float32), device=cuda_device)
    whole_c, whole_g = hv.hyperbolic_tv_batched_fused(x, 1.0, (2.0, 1.0, 1.0))
    hv.slab_launches = 0
    costs, grads = 0.0, []
    for a, b in zip(cuts[:-1], cuts[1:]):
        prev = x[:, a - 1].contiguous() if a > 0 else None
        nxt = x[:, b].contiguous() if b < shape[1] else None
        slab = x[:, a:b].contiguous()
        c, g = hv.hyperbolic_tv_slab_fused(slab, prev, nxt, 1.0, (2.0, 1.0, 1.0))
        cp, gp = hv.hyperbolic_tv_slab_plain(slab, prev, nxt, 1.0, (2.0, 1.0, 1.0))
        torch.cuda.synchronize()
        assert torch.allclose(c, cp, rtol=COST_RTOL) and torch.allclose(g, gp, rtol=GRAD_RTOL, atol=GRAD_ATOL)
        costs, grads = costs + c, grads + [g]
    assert hv.slab_launches == len(cuts) - 1
    assert torch.equal(torch.cat(grads, 1), whole_g)
    assert torch.allclose(costs, whole_c, rtol=1e-6)


def _group_inputs(x, cuts):
    """The slabs of ``x`` cut at ``cuts`` (contiguous copies) and their halo
    planes as a grouped launch on one device takes them: views of the
    neighbouring slabs' boundary planes, read in place."""
    slabs = [x[:, a:b].contiguous() for a, b in zip(cuts[:-1], cuts[1:])]
    prevs = [None] + [t[:, -1] for t in slabs[:-1]]
    nexts = [t[:, 0] for t in slabs[1:]] + [None]
    return slabs, prevs, nexts


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 64, 96), (1, 64, 45, 67)])
@pytest.mark.parametrize("cuts", SLAB_CUTS)
def test_tv_slab_group_is_its_slabs_one_at_a_time_and_the_volume(shape, cuts, cuda_device):
    """One grouped launch over the slabs (neighbours read in place) against
    the same slabs launched one at a time with copied halos: costs and
    gradients bit for bit; put together, the whole-volume launch's gradient
    bit for bit and its cost within 1e-6; each slab against its plain
    version. Both instantiations (nx = 67 takes the 4-byte copies) and a
    batch of 2."""
    x = torch.as_tensor(np.random.default_rng(13).standard_normal(shape, dtype=np.float32), device=cuda_device)
    scales = (2.0, 1.0, 1.0)
    whole_c, whole_g = hv.hyperbolic_tv_batched_fused(x, 1.0, scales)
    slabs, prevs, nexts = _group_inputs(x, cuts)
    hv.slab_launches = hv.slabs_launched = hv.unaligned_launches = 0
    costs, grads = hv.hyperbolic_tv_slab_group(slabs, prevs, nexts, 1.0, scales)
    assert (hv.slab_launches, hv.slabs_launched, hv.unaligned_launches) == (1, len(slabs), int(shape[-1] % 4 != 0))
    plain_c, plain_g = hv.hyperbolic_tv_slab_group_plain(slabs, prevs, nexts, 1.0, scales)
    for t, p, n, c, g, cp, gp in zip(slabs, prevs, nexts, costs, grads, plain_c, plain_g):
        c1, g1 = hv.hyperbolic_tv_slab_fused(t, None if p is None else p.contiguous(),
                                             None if n is None else n.contiguous(), 1.0, scales)
        torch.cuda.synchronize()
        assert torch.equal(c, c1) and torch.equal(g, g1)
        assert torch.allclose(c, cp, rtol=COST_RTOL) and torch.allclose(g, gp, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert hv.slab_launches == 1 + len(slabs)
    assert torch.equal(torch.cat(grads, 1), whole_g)
    assert torch.allclose(sum(costs), whole_c, rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 64, 64, 96), (1, 64, 45, 67)])
def test_tv_slab_group_with_a_neighbour_on_another_device(shape, cuda_device):
    """Four slabs in two groups, as on a mesh of two devices: within a group
    the neighbour is read in place, across the groups it comes as a halo
    buffer (a copy). Put together: the whole-volume launch's gradient bit for
    bit; each group equal to its slabs launched alone."""
    x = torch.as_tensor(np.random.default_rng(14).standard_normal(shape, dtype=np.float32), device=cuda_device)
    whole_c, whole_g = hv.hyperbolic_tv_batched_fused(x, 0.5)
    slabs, prevs, nexts = _group_inputs(x, (0, 16, 32, 48, 64))
    nexts[1], prevs[2] = nexts[1].clone(), prevs[2].clone()  # the halo buffers sent across the two groups
    hv.slab_launches = hv.slabs_launched = 0
    c01, g01 = hv.hyperbolic_tv_slab_group(slabs[:2], prevs[:2], nexts[:2], 0.5)
    c23, g23 = hv.hyperbolic_tv_slab_group(slabs[2:], prevs[2:], nexts[2:], 0.5)
    assert (hv.slab_launches, hv.slabs_launched) == (2, 4)
    for i, (c, g) in enumerate(zip(c01 + c23, g01 + g23)):
        p, n = (None if h is None else h.contiguous() for h in (prevs[i], nexts[i]))
        c1, g1 = hv.hyperbolic_tv_slab_fused(slabs[i], p, n, 0.5)
        assert torch.equal(c, c1) and torch.equal(g, g1)
    assert torch.equal(torch.cat(g01 + g23, 1), whole_g)
    assert torch.allclose(sum(c01 + c23), whole_c, rtol=1e-6)


@pytest.mark.cuda
def test_tv_slab_group_twice_bitwise_and_its_cap(cuda_device):
    """Two grouped launches give bitwise-equal outputs (tickets reset, costs
    summed in index order); a group above the cap is refused before any
    launch."""
    x = torch.as_tensor(np.random.default_rng(15).standard_normal((1, 40, 37, 68), dtype=np.float32),
                        device=cuda_device)
    slabs, prevs, nexts = _group_inputs(x, (0, 5, 10, 15, 20, 25, 30, 35, 40))
    c1, g1 = hv.hyperbolic_tv_slab_group(slabs, prevs, nexts, 0.1, (3.0, 1.0, 0.7))
    c2, g2 = hv.hyperbolic_tv_slab_group(slabs, prevs, nexts, 0.1, (3.0, 1.0, 0.7))
    assert all(torch.equal(a, b) for a, b in zip(c1 + g1, c2 + g2))
    nine, p9, n9 = _group_inputs(x, tuple(range(0, 37, 4)))
    hv.slab_launches = 0
    with pytest.raises(ValueError, match="1 to 8 slabs"):
        hv.hyperbolic_tv_slab_group(nine, p9, n9, 0.1)
    assert hv.slab_launches == 0


@pytest.mark.cuda
def test_sharded_tv_on_one_card_is_one_launch(cuda_device):
    """The sharded TV on a (1, 4) mesh of the one card: one grouped launch of
    4 slabs and no halo copy, its gradient the whole volume's bit for bit."""
    from microtipi_tpu_torch.parallel import deconv as pd
    from microtipi_tpu_torch.parallel import make_mesh, shard

    x = torch.as_tensor(np.random.default_rng(16).standard_normal((64, 32, 96), dtype=np.float32),
                        device=cuda_device)
    mesh = make_mesh(1, 4, devices=[torch.device("cuda", 0)] * 4)
    hv.slab_launches = hv.slabs_launched = pd.halo_sends = 0
    total, grads = pd._slab_tv(shard(x, mesh), 1.0, None)
    assert (hv.slab_launches, hv.slabs_launched, pd.halo_sends) == (1, 4, 0)
    whole_c, whole_g = hv.hyperbolic_tv_fused(x, 1.0)
    assert torch.equal(torch.cat(grads, 0), whole_g)
    assert torch.allclose(total, whole_c, rtol=1e-6)
    (launch,) = pd.plan_slab_launches(mesh, mesh.cells())
    by = {c: t[None].contiguous() for c, t in zip(mesh.cells(), grads)}
    assert hv.prepare_slabs(*pd._launch_inputs(mesh, by, launch), 1.0)[3].maps == 4  # no map of a halo buffer


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 64, 64, 96), (2, 64, 45, 67)])
@pytest.mark.parametrize("cuts", SLAB_CUTS)
@pytest.mark.parametrize("alpha", [1.0, 1.8])
def test_admm_slab_launches_match_plain_and_the_volume(shape, cuts, alpha, cuda_device):
    """The split update's and the rhs's slab launches against their plain
    versions, and put together against the whole-volume launches, bit for
    bit: the ring wrap (x's first plane after the last slab, z1_z - u1_z's
    last plane before the first) and the volume's trailing z face."""
    st = _admm_state(shape, cuda_device, seed=12)
    scales = (3.0, 1.0, 0.7)
    whole = {k: st[k].clone() for k in ("z1", "u1", "z2", "u2")}
    ak.admm_split_update(st["x"], whole["z1"], whole["u1"], whole["z2"], whole["u2"], st["lam"], 0.3, alpha, True,
                         scales)
    whole_rhs = ak.admm_rhs(st["z1"], st["u1"], st["z2"], st["u2"], st["rho1"], st["rho2"], scales)
    nz = shape[1]
    ak.split_slab_launches = ak.rhs_slab_launches = 0
    parts, rhs = [], []
    for a, b in zip(cuts[:-1], cuts[1:]):
        sl = [st["z1"][:, :, a:b].clone(), st["u1"][:, :, a:b].clone(), st["z2"][:, a:b].clone(),
              st["u2"][:, a:b].clone()]
        pl = [t.clone() for t in sl]
        x, x_next = st["x"][:, a:b].clone(), st["x"][:, b % nz].clone()
        ak.admm_split_update_slab(x, x_next, *sl, st["lam"], 0.3, a, nz, alpha, True, scales)
        ak.admm_split_update_slab_plain(x, x_next, *pl, st["lam"], 0.3, a, nz, alpha, True, scales)
        args = (st["z1"][:, :, a:b].clone(), st["u1"][:, :, a:b].clone(), st["z2"][:, a:b].clone(),
                st["u2"][:, a:b].clone(), st["z1"][:, 0, a - 1].clone(), st["u1"][:, 0, a - 1].clone(), st["rho1"],
                st["rho2"], scales)
        r = ak.admm_rhs_slab(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(s, p) for s, p in zip(sl, pl))
        assert torch.equal(r, ak.admm_rhs_slab_plain(*args))
        parts.append(sl)
        rhs.append(r)
    assert (ak.split_slab_launches, ak.rhs_slab_launches) == (len(cuts) - 1,) * 2
    for i, k in enumerate(("z1", "u1", "z2", "u2")):
        assert torch.equal(torch.cat([p[i] for p in parts], 2 if i < 2 else 1), whole[k]), k
    assert torch.equal(torch.cat(rhs, 1), whole_rhs)
