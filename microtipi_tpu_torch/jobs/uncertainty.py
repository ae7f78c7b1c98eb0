"""Pixelwise uncertainty of the restored object (Laplace + Hutchinson).

Port of ``microtipi_tpu/jobs/uncertainty.py``. At the solver's MAP point x*
of the object step's objective the Laplace approximation models the
posterior as N(x*, H^{-1}) with H = grad^2 f(x*); the pixelwise variance
diag(H^{-1}) is estimated without materializing H:

- Hessian-vector products come from a double backward of the **plain**
  objective (:func:`laplace_objective`: ``WeightedConvolutionCost`` /
  ``PoissonConvCost`` and ``regularization_cost``). The solver's fast paths
  (``_QuadraticCost``, ``_UniformCost``, the fused TV kernel's
  ``autograd.Function``) return a saved gradient in their backward, so a
  second derivative through them would silently drop their curvature.
- diag(H^{-1}) is the Hutchinson estimate ``E[z * H^{-1} z]`` over Rademacher
  probes z, each ``H u = z`` solved by conjugate gradients. All probes run as
  one batch: one batched Hessian-vector product a CG iteration, each probe
  stopping at its own iteration, one host read an iteration.
- The positivity bound's active set (voxels at the bound) is masked out:
  ``B = M H M + (I - M)``, probes restricted to the free set, sigma exactly 0
  on pinned voxels.

The CG follows ``jax.scipy.sparse.linalg.cg``: from x0 = 0, steps
``gamma / <p, A p>`` and ``gamma' / gamma`` with ``gamma = <r, M r>``, stopping
when ``<r, r>`` (with a preconditioner; ``gamma`` without) is at most
``tol^2 ||b||^2``. The circulant preconditioner is the JAX module's
(``uncertainty.py:174-210``). Units and caveats as there: with the
unweighted Gaussian term sigma is in units of the noise sigma.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, regularization_cost, var_shape_of
from microtipi_tpu_torch.ops.convolution import PoissonConvCost, WeightedConvolutionCost
from microtipi_tpu_torch.utils.arrays import crop_to_shape, pad_fft_kernel

__all__ = ["ObjectUncertainty", "laplace_objective", "object_uncertainty"]

_VOLUME = (-3, -2, -1)


class ObjectUncertainty(NamedTuple):
    """Pixelwise Laplace uncertainty (``uncertainty.py:65-82``).

    sigma: posterior standard deviation per voxel (0 on the active set).
    var: the Hutchinson estimate of diag(H^{-1}) on the free set, clipped at 0.
    free: 1.0 where the voxel is free, 0.0 where the positivity bound pins it.
    residual: mean over probes of ||B u - z|| / ||z|| after CG (a 0-dim tensor).
    """

    sigma: torch.Tensor
    var: torch.Tensor
    free: torch.Tensor
    residual: torch.Tensor


def _plain_cost(psf, data, weights, config: DeconvolutionConfig):
    """The data term in its plain, twice-differentiable form."""
    var_shape = var_shape_of(config, data)
    kernel = pad_fft_kernel(psf, var_shape)
    if config.data_term == "poisson":
        if weights is not None:
            raise ValueError("data_term='poisson' models the noise itself; per-voxel "
                             "Gaussian weights do not compose with it")
        return PoissonConvCost.build(kernel, data, config.background, var_shape)
    if config.data_term == "gaussian":
        return WeightedConvolutionCost.build(kernel, data, weights, var_shape)
    raise ValueError(f"unknown data_term {config.data_term!r}")


def laplace_objective(psf, data, weights, config: DeconvolutionConfig):
    """The object step's objective in plain, twice-differentiable form
    (``uncertainty.py:85-121``): the value of ``jobs.deconv.make_objective``'s
    objective, built without the fast paths' ``autograd.Function``s."""
    cost = _plain_cost(psf, data, weights, config)

    def objective(x):
        return cost.cost(x) + regularization_cost(x, config)

    return objective


def _batched_hvp(psf, data, weights, config: DeconvolutionConfig, x_hat: torch.Tensor, n: int):
    """``V (n, *x_hat.shape) -> H V``, lane by lane, at x_hat: the gradient
    of the objective summed over n copies of x_hat, kept with its graph, then
    one backward of it against V a call."""
    cost = _plain_cost(psf, data, weights, config)
    xs = x_hat.detach().expand(n, *x_hat.shape).clone().requires_grad_(True)
    with torch.enable_grad():
        f = cost.cost(xs).sum() + regularization_cost(xs, config, axes=_VOLUME)
        (g,) = torch.autograd.grad(f, xs, create_graph=True)

    def hvp(v):
        (hv,) = torch.autograd.grad(g, xs, grad_outputs=v, retain_graph=True)
        return hv

    return hvp


def _lane_dot(a, b):
    return (a * b).sum(dim=_VOLUME)


def _lanes(t):
    return t.reshape(t.shape + (1, 1, 1))


def _cg(matvec, b, minv, tol: float, maxiter: int):
    """``jax.scipy.sparse.linalg.cg`` on each lane of ``b`` (K, ...) at once,
    each lane frozen once it stops; returns (x, iterations per lane). It
    starts from x0 = 0, where ``b - A x0`` is ``b`` exactly."""
    atol2 = tol * tol * _lane_dot(b, b)  # max(tol^2 ||b||^2, atol^2) with atol = 0
    x, r = torch.zeros_like(b), b
    z = r if minv is None else minv(r)
    p, gamma = z, _lane_dot(r, z)
    k = torch.zeros(b.shape[:1], dtype=torch.int64, device=b.device)

    def running(r, gamma, k):
        rs = gamma if minv is None else _lane_dot(r, r)
        return (rs > atol2) & (k < maxiter)

    active = running(r, gamma, k)
    while bool(active.any()):
        ap = matvec(p)
        alpha = _lanes(gamma / _lane_dot(p, ap))
        x_, r_ = x + alpha * p, r - alpha * ap
        z_ = r_ if minv is None else minv(r_)
        gamma_ = _lane_dot(r_, z_)
        p_ = z_ + _lanes(gamma_ / gamma) * p
        on = _lanes(active)
        x, r, p = torch.where(on, x_, x), torch.where(on, r_, r), torch.where(on, p_, p)
        gamma, k = torch.where(active, gamma_, gamma), k + active
        active = running(r, gamma, k)
    return x, k


def _preconditioner(data, psf, x_hat, weights, config: DeconvolutionConfig, free):
    """The circulant preconditioner (``uncertainty.py:174-210``): data
    curvature ``mean(w)|H^|^2`` (Poisson: the mean of ``d/m^2``) plus the TV
    curvature bound ``mu/eps * sum|D^|^2``, inverted in the rfftn basis."""
    var_shape = var_shape_of(config, data)
    dtype, dev = x_hat.dtype, x_hat.device
    h_hat = torch.fft.rfftn(pad_fft_kernel(psf, var_shape))
    h2 = (h_hat * h_hat.conj()).real
    if config.data_term == "poisson":
        m = torch.fft.irfftn(h_hat * torch.fft.rfftn(x_hat), s=var_shape)
        if m.shape != data.shape:
            m = crop_to_shape(m, tuple(data.shape))
        m = torch.clamp_min(m + config.background, torch.finfo(dtype).eps)
        w_mean = torch.mean(data / (m * m))
    elif weights is None:
        w_mean = torch.ones((), dtype=dtype, device=dev)
    else:
        w_mean = torch.mean(weights)
    sz = (1.0, 1.0, 1.0) if config.scales is None else tuple(float(s) for s in config.scales)
    freqs = [np.fft.fftfreq(var_shape[0]), np.fft.fftfreq(var_shape[1]), np.fft.rfftfreq(var_shape[2])]
    fz, fy, fx = (torch.as_tensor(f, dtype=dtype, device=dev) for f in freqs)
    s2 = ((4.0 / sz[0] ** 2) * torch.sin(np.pi * fz)[:, None, None] ** 2
          + (4.0 / sz[1] ** 2) * torch.sin(np.pi * fy)[None, :, None] ** 2
          + (4.0 / sz[2] ** 2) * torch.sin(np.pi * fx)[None, None, :] ** 2)
    den = w_mean * h2 + (config.mu / max(config.epsilon, 1e-30)) * s2
    den = den + torch.finfo(dtype).eps * torch.max(den)

    def minv(v):
        p = torch.fft.irfftn(torch.fft.rfftn(free * v, dim=_VOLUME) / den, s=var_shape, dim=_VOLUME)
        return free * p + (1.0 - free) * v

    return minv


def _uncertainty(data, psf, x_hat, weights, config: DeconvolutionConfig, probes, cg_tol: float, cg_maxiter: int,
                 active_tol: float, precondition: bool):
    """:func:`object_uncertainty` from given probes (K, *x_hat.shape);
    returns (the estimate, the CG iterations of each probe)."""
    free = (x_hat > active_tol).to(x_hat.dtype) if config.positivity else torch.ones_like(x_hat)
    hvp = _batched_hvp(psf, data, weights, config, x_hat, probes.shape[0])

    def matvec(v):
        return free * hvp(free * v) + (1.0 - free) * v

    minv = _preconditioner(data, psf, x_hat, weights, config, free) if precondition else None
    zf = free * probes.to(x_hat.dtype)
    u, iterations = _cg(matvec, zf, minv, cg_tol, cg_maxiter)
    r = matvec(u) - zf
    tiny = torch.finfo(x_hat.dtype).tiny
    rel = torch.sqrt(_lane_dot(r, r)) / torch.clamp_min(torch.sqrt(_lane_dot(zf, zf)), tiny)
    var = torch.clamp_min(free * torch.mean(zf * u, dim=0), 0.0)
    return ObjectUncertainty(torch.sqrt(var), var, free, torch.mean(rel)), iterations.cpu().numpy()


def object_uncertainty(
    data: torch.Tensor,
    psf: torch.Tensor,
    x_hat: torch.Tensor,
    weights: torch.Tensor | None = None,
    config: DeconvolutionConfig = DeconvolutionConfig(),
    *,
    n_probes: int = 8,
    generator: torch.Generator | None = None,
    cg_tol: float = 1e-5,
    cg_maxiter: int = 100,
    active_tol: float = 0.0,
    precondition: bool = True,
) -> ObjectUncertainty:
    """Laplace posterior standard deviation of a deconvolved object
    (``uncertainty.py:124-226``). ``x_hat`` is the converged solution of
    ``jobs.deconv.deconvolve`` for the same (data, psf, weights, config).
    ``generator`` draws the Rademacher probes (default: one seeded with 0 on
    ``x_hat``'s device). With ``config.positivity`` voxels with ``x_hat <=
    active_tol`` count as pinned. ``precondition``: the circulant
    preconditioner, one extra FFT pair a CG iteration. Runs on the device of
    its tensors."""
    if generator is None:
        generator = torch.Generator(device=x_hat.device).manual_seed(0)
    probes = torch.randint(0, 2, (n_probes, *x_hat.shape), generator=generator, device=x_hat.device)
    probes = probes.to(x_hat.dtype) * 2.0 - 1.0
    est, _ = _uncertainty(data, psf, x_hat, weights, config, probes, cg_tol, cg_maxiter, active_tol, precondition)
    return est
