"""The Laplace uncertainty of the port against the JAX package and a dense
Hessian on the CPU (float64): ``laplace_objective``'s value and gradient,
the batched Hessian-vector product against ``jax.linearize(jax.grad(f))``,
``object_uncertainty`` fed JAX's Rademacher probes, and the estimate against
the diagonal of a dense inverse Hessian. Inputs come from numpy with a seed
and feed both packages.

Tolerances: objective values, gradients and Hessian-vector products to 1e-10
relative. Against JAX (two cases): ``var`` to 1e-8 relative, the residual
(||B u - z|| / ||z|| ~ 1e-5, the difference of two nearly equal vectors, so
the CG iterates' 1e-10 gap is 1e-5 of it) to 1e-4 relative, and the same CG
iteration count for every probe (read from a copy of
``jax.scipy.sparse.linalg.cg``'s loop that must return JAX's x exactly). Against the dense float64 Hessian built by
``torch.autograd.functional.hessian``: with the rows of a Hadamard matrix as
probes the Hutchinson mean is the diagonal exactly, so ``var`` equals
diag((M H M + I - M)^{-1}) on the free set to 1e-8 relative at CG
tolerance 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from microtipi_tpu.jobs.deconv import DeconvolutionConfig as JaxDeconvConfig
from microtipi_tpu.jobs.uncertainty import laplace_objective as jax_laplace
from microtipi_tpu.jobs.uncertainty import object_uncertainty as jax_uncertainty
from microtipi_tpu_torch.jobs import uncertainty as tu
from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig

SHAPE = (4, 8, 8)



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tensors this small run fastest on one intra-op thread, and the suite
    runs several workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b))


def _problem(seed=0, shape=SHAPE, var_shape=None, poisson=False, weighted=False, zeros=0.0):
    """A near-delta PSF (well-conditioned Hessian), data from a random
    object, a positive point x_hat with a share ``zeros`` of voxels at the
    bound (the Laplace machinery takes any point; it need not be a
    solution), and weights when asked."""
    rng = np.random.default_rng(seed)
    grid = np.meshgrid(*(np.minimum(np.arange(n), n - np.arange(n)) for n in shape), indexing="ij")
    g = np.exp(-sum(a ** 2 for a in grid) / (2 * 0.8 ** 2))
    psf = 0.5 * g / g.sum()
    psf[0, 0, 0] += 0.5
    truth = rng.uniform(0.2, 1.0, shape)
    data = np.fft.irfftn(np.fft.rfftn(truth) * np.fft.rfftn(psf), s=shape, axes=(0, 1, 2))
    data = rng.poisson(20.0 * data + 2.0).astype(np.float64) if poisson else data + 0.02 * rng.standard_normal(shape)
    x_hat = rng.uniform(0.1, 1.2, var_shape or shape) * (20.0 if poisson else 1.0)
    x_hat[rng.random(x_hat.shape) < zeros] = 0.0
    weights = rng.uniform(0.5, 3.0, shape) if weighted else None
    return psf, data, x_hat, weights


OBJECTIVE_CASES = {
    "gaussian": (dict(mu=0.05, epsilon=0.05), {}),
    "weighted_priors_scales": (dict(mu=0.03, epsilon=0.1, sparsity=0.02, sparsity_epsilon=0.05, hessian=0.01,
                                    scales=(2.0, 1.0, 1.0)), dict(weighted=True)),
    "poisson_var_shape": (dict(mu=0.02, epsilon=0.2, data_term="poisson", background=2.0, var_shape=(6, 10, 10)),
                          dict(poisson=True, var_shape=(6, 10, 10))),
}


def _t(a):
    return None if a is None else torch.tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("name", list(OBJECTIVE_CASES))
def test_laplace_objective_and_hvp_match_jax(name):
    """Value, gradient and two Hessian-vector products (one batched call)."""
    kw, opts = OBJECTIVE_CASES[name]
    psf, data, x_hat, weights = _problem(**opts)
    jobj = jax_laplace(_j(psf), _j(data), _j(weights), JaxDeconvConfig(**kw))
    tobj = tu.laplace_objective(_t(psf), _t(data), _t(weights), DeconvolutionConfig(**kw))
    fj, gj = jax.value_and_grad(jobj)(jnp.asarray(x_hat))
    xt = torch.tensor(x_hat, requires_grad=True)
    ft = tobj(xt)
    (gt,) = torch.autograd.grad(ft, xt)
    np.testing.assert_allclose(float(ft.detach()), float(fj), rtol=1e-10)
    assert _rel(gt.numpy(), gj) < 1e-10
    vs = np.random.default_rng(4).standard_normal((2,) + x_hat.shape)
    _, hvp = jax.linearize(jax.grad(jobj), jnp.asarray(x_hat))
    got = tu._batched_hvp(_t(psf), _t(data), _t(weights), DeconvolutionConfig(**kw), torch.tensor(x_hat), 2)(
        torch.tensor(vs)).numpy()
    for k in range(2):
        assert _rel(got[k], hvp(jnp.asarray(vs[k]))) < 1e-10


JAX_CASES = {
    "gaussian_active_set_preconditioned": (dict(mu=0.05, epsilon=0.05), dict(zeros=0.2), True),
    "poisson_plain_cg": (dict(mu=0.02, epsilon=0.2, data_term="poisson", background=2.0),
                                    dict(poisson=True, zeros=0.1), False),
}


def _jax_cg_with_count(record):
    """``jax.scipy.sparse.linalg.cg`` plus a copy of its loop
    (``_cg_solve``) that also counts iterations; the copy's x must be JAX's
    bit for bit, and each probe's count goes to ``record``."""
    real_cg = jax.scipy.sparse.linalg.cg

    def cg(A, b, x0=None, *, tol=1e-5, atol=0.0, maxiter=None, M=None):
        x_ref, info = real_cg(A, b, x0, tol=tol, atol=atol, maxiter=maxiter, M=M)
        precond = M is not None
        M = M or (lambda v: v)
        atol2 = jnp.maximum(tol ** 2 * jnp.vdot(b, b), atol ** 2)

        def cond(c):
            _, r, gamma, _, k = c
            return ((jnp.vdot(r, r) if precond else gamma) > atol2) & (k < maxiter)

        def body(c):
            x, r, gamma, p, k = c
            ap = A(p)
            alpha = gamma / jnp.vdot(p, ap)
            x_, r_ = x + alpha * p, r - alpha * ap
            z_ = M(r_)
            gamma_ = jnp.vdot(r_, z_)
            return x_, r_, gamma_, z_ + (gamma_ / gamma) * p, k + 1

        r0 = b - A(jnp.zeros_like(b))
        z0 = M(r0)
        x, *_, k = jax.lax.while_loop(cond, body, (jnp.zeros_like(b), r0, jnp.vdot(r0, z0), z0, 0))
        jax.debug.callback(lambda k, same: record.append((np.asarray(k), np.asarray(same))), k,
                           jnp.all(x == x_ref))
        return x_ref, info

    return cg


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_object_uncertainty_matches_jax_with_its_probes(name, monkeypatch):
    kw, opts, precondition = JAX_CASES[name]
    psf, data, x_hat, weights = _problem(seed=1, **opts)
    key = jax.random.PRNGKey(3)
    record = []
    monkeypatch.setattr(jax.scipy.sparse.linalg, "cg", _jax_cg_with_count(record))
    want = jax_uncertainty(_j(data), _j(psf), _j(x_hat), _j(weights), JaxDeconvConfig(positivity=True, **kw),
                           n_probes=4, key=key, precondition=precondition)
    want_iterations = np.concatenate([np.ravel(k) for k, _ in record])
    assert all(np.all(same) for _, same in record) and want_iterations.shape == (4,)
    probes = np.asarray(jax.random.rademacher(key, (4,) + SHAPE, jnp.float64))
    got, iterations = tu._uncertainty(_t(data), _t(psf), _t(x_hat), _t(weights),
                                      DeconvolutionConfig(positivity=True, **kw), torch.tensor(probes), 1e-5, 100,
                                      0.0, precondition)
    np.testing.assert_array_equal(iterations, want_iterations)
    assert _rel(got.var.numpy(), want.var) < 1e-8
    np.testing.assert_array_equal(got.free.numpy(), np.asarray(want.free))
    np.testing.assert_allclose(float(got.residual), float(want.residual), rtol=1e-4)
    assert float(got.sigma[got.free == 0].abs().max()) == 0.0


def _hadamard(n):
    h = np.ones((1, 1))
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


DENSE = (4, 4, 8)  # 128 voxels: 128 Hadamard probes
DENSE_CASES = {
    "gaussian_plain_cg": (dict(mu=0.05, epsilon=0.05, positivity=False), dict(shape=DENSE), False),
    "gaussian_active_set_priors": (dict(mu=0.03, epsilon=0.1, sparsity=0.05, hessian=0.02, scales=(2.0, 1.0, 1.0)),
                                   dict(shape=DENSE, zeros=0.25), True),
    "weighted": (dict(mu=0.05, epsilon=0.05), dict(shape=DENSE, weighted=True, zeros=0.1), True),
    "poisson_var_shape": (dict(mu=0.02, epsilon=0.2, data_term="poisson", background=2.0, var_shape=DENSE),
                          dict(poisson=True, shape=(3, 4, 6), var_shape=DENSE, zeros=0.1), True),
}


@pytest.mark.parametrize("name", list(DENSE_CASES))
def test_variance_is_the_dense_inverse_hessian_diagonal(name):
    kw, opts, precondition = DENSE_CASES[name]
    psf, data, x_hat, weights = _problem(seed=2, **opts)
    cfg = DeconvolutionConfig(**kw)
    obj = tu.laplace_objective(_t(psf), _t(data), _t(weights), cfg)
    n = x_hat.size
    h = torch.autograd.functional.hessian(lambda v: obj(v.reshape(x_hat.shape)), torch.tensor(x_hat).reshape(-1))
    m = (x_hat.reshape(-1) > 0).astype(np.float64) if cfg.positivity else np.ones(n)
    b = m[:, None] * h.numpy() * m[None, :] + np.diag(1.0 - m)
    dense = m * np.diag(np.linalg.inv(b))
    probes = torch.tensor(_hadamard(n).reshape((n,) + x_hat.shape))
    got, iterations = tu._uncertainty(_t(data), _t(psf), _t(x_hat), _t(weights), cfg, probes, 1e-12, 500, 0.0,
                                      precondition)
    assert iterations.max() < 500 and float(got.residual) < 1e-10
    assert _rel(got.var.numpy().reshape(-1), dense) < 1e-8
    np.testing.assert_array_equal(got.free.numpy().reshape(-1), m)


def test_object_uncertainty_uses_no_fused_fast_path(monkeypatch):
    """The kernel's autograd.Function and the quadratic / uniform fast paths
    return saved gradients, so the Laplace Hessian must not go through them;
    with all three made to raise, object_uncertainty runs unchanged, and its
    default probes come from a generator seeded with 0."""
    from microtipi_tpu_torch.ops import convolution
    from microtipi_tpu_torch.ops.kernels import hyperbolic_tv as hv

    def refuse(*args, **kw):
        raise AssertionError("the Laplace objective reached a fused fast path")

    for cls in (hv.HyperbolicTV, hv.HyperbolicTVBatched, convolution._QuadraticCost, convolution._UniformCost):
        monkeypatch.setattr(cls, "forward", staticmethod(refuse))
    psf, data, x_hat, _ = _problem(seed=3, zeros=0.1)
    cfg = DeconvolutionConfig(mu=0.05, epsilon=0.05)
    one = tu.object_uncertainty(_t(data), _t(psf), _t(x_hat), config=cfg)
    two = tu.object_uncertainty(_t(data), _t(psf), _t(x_hat), config=cfg,
                                generator=torch.Generator().manual_seed(0))
    assert torch.equal(one.var, two.var) and float(one.residual) < 1e-4
    assert bool((one.sigma[one.free == 1] > 0).all())
