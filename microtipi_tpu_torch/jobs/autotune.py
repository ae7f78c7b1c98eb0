"""Automatic regularization selection for the object step.

Port of ``microtipi_tpu/jobs/autotune.py``: mu is chosen by the Morozov
discrepancy principle, so that the residual of the regularized solution
matches its statistical expectation,

    Gaussian:  sum_i w_i (H x_mu - d)_i^2  =  tau * N_eff,
               (unweighted:  sum r^2 = tau * N * sigma^2)
    Poisson:   2 * KL(d, H x_mu + b)       =  tau * N.

D(mu) is nondecreasing in mu, so ``steps`` geometric bisection steps on a
bracket [lo, hi] pin mu to a factor (hi/lo)^(2^-steps). The JAX
``lax.fori_loop`` becomes a host loop of warm-started VMLMB probe solves
(``jobs/deconv.py``'s objective with mu scaling the TV term only), one host
read of the discrepancy a probe, then a full-length solve at the selected
mu. The bisection's arithmetic is the JAX module's, in the data's dtype: the
probe at ``sqrt(lo*hi)`` and the comparison ``d > target``.

:func:`estimate_noise_sigma` recovers the Gaussian sigma from the data itself
(Immerkaer 1996 3x3 Laplacian, made robust by the median absolute deviation),
per z-plane on volumes. ``jobs/batch.batched_deconvolve_auto_mu`` runs one
bisection a lane through ``_auto_mu_lanes``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from microtipi_tpu_torch.jobs.deconv import (
    DeconvolutionConfig,
    DeconvolutionResult,
    _data_cost,
    _stacked,
    _vmlmb_options,
    lane_objective,
    make_regularizer,
    var_shape_of,
)
from microtipi_tpu_torch.jobs.wiener import wiener
from microtipi_tpu_torch.optim.treeutil import value_and_grad
from microtipi_tpu_torch.optim.vmlmb import minimize_vmlmb, minimize_vmlmb_batched
from microtipi_tpu_torch.utils.arrays import median, pad_to_shape
from microtipi_tpu_torch.weights.updaters import laplacian_residuals

__all__ = ["AutoMuResult", "deconvolve_auto_mu", "estimate_noise_sigma"]


def estimate_noise_sigma(data: torch.Tensor) -> torch.Tensor:
    """The Gaussian noise sigma of an image or stack (``autotune.py:55-73``):
    ``median(|L * d|) / (0.6745 * 6)`` with Immerkaer's Laplacian difference
    ``L`` over each z plane's valid interior
    (``weights.updaters.laplacian_residuals``, already divided by 6). A 0-dim
    tensor on the data's device."""
    r, _ = laplacian_residuals(data)
    return median(r.abs()) / 0.6745


class AutoMuResult(NamedTuple):
    """Outcome of :func:`deconvolve_auto_mu` (``autotune.py:76-85``), NumPy
    values of the data's dtype; from a batch, each with a leading batch axis."""

    mu: np.ndarray  #: selected regularization weight
    sigma: np.ndarray  #: noise sigma used for the target (nan if weighted/poisson)
    target: np.ndarray  #: the discrepancy target tau * N_eff(*sigma^2)
    discrepancy: np.ndarray  #: D(mu) of the returned solution (compare to target)
    mu_history: np.ndarray  #: (steps,) probed mus
    discrepancy_history: np.ndarray  #: (steps,) their discrepancies
    result: DeconvolutionResult  #: full-length solve at the selected mu


def _build_data_cost(psf, data, weights, config: DeconvolutionConfig):
    """The pure data-fidelity term (no prior) and the object grid, the same
    dispatch as ``deconv.make_objective`` (``autotune.py:88-101``)."""
    return _data_cost(psf, data, weights, config, accurate=False), var_shape_of(config, data)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _check_search(bracket, steps: int) -> tuple[float, float]:
    if steps < 1:
        raise ValueError("steps must be >= 1")
    lo0, hi0 = float(bracket[0]), float(bracket[1])
    if not (0.0 < lo0 < hi0):
        raise ValueError(f"bracket must satisfy 0 < lo < hi, got {bracket}")
    return lo0, hi0


def _start(data, psf, var_shape, config: DeconvolutionConfig, init: str, lanes: bool):
    if init == "wiener":
        x0 = torch.stack([wiener(d, psf) for d in data]) if lanes else wiener(data, psf)
    elif init == "data":
        x0 = data
    else:
        raise ValueError(f"unknown init {init!r}")
    x0 = pad_to_shape(x0, var_shape)
    return torch.clamp_min(x0, 0.0) if config.positivity else x0


def _target(data, weights, config: DeconvolutionConfig, sigma, tau: float, lanes: bool):
    """(sigma, target) per lane as NumPy values of the data's dtype
    (``autotune.py:151-161``): sigma is nan for weighted or Poisson data."""
    dt = torch.zeros((), dtype=data.dtype).numpy().dtype
    shape = data.shape[:1] if lanes else ()
    n = int(np.prod(data.shape[-3:]))
    if config.data_term == "poisson":
        return np.full(shape, np.nan, dt), np.full(shape, tau * n, dt)
    if weights is not None:
        count = (weights > 0).sum(dim=(-3, -2, -1)).to(data.dtype)
        return np.full(shape, np.nan, dt), (tau * _host(count)).astype(dt)
    if sigma is None:
        sig = _host(torch.stack([estimate_noise_sigma(d) for d in data]) if lanes else estimate_noise_sigma(data))
    else:
        sig = np.broadcast_to(np.asarray(sigma, dt), shape).copy()
    sig = sig.astype(dt)
    return sig, dt.type(tau * n) * sig ** 2


def _bisect(solve, discrepancy, target: np.ndarray, x, lo0: float, hi0: float, steps: int, probe_iter: int,
            max_iter: int):
    """The bisection (``autotune.py:201-216``) on every lane at once:
    ``solve(mu, x, maxiter) -> (x, results)`` with one mu a lane,
    ``discrepancy(x)`` one value a lane. Returns (mu, mu history,
    discrepancy history, results of the final solve, their discrepancy)."""
    dt = target.dtype
    lo, hi = np.full(target.shape, lo0, dt), np.full(target.shape, hi0, dt)
    mus = np.zeros(target.shape + (steps,), dt)
    ds = np.zeros_like(mus)
    for i in range(steps):
        mu = np.sqrt(lo * hi)
        x, _ = solve(mu, x, probe_iter)
        d = discrepancy(x)
        # D too large -> over-regularized -> shrink from above; else from below.
        over = d > target
        hi, lo = np.where(over, mu, hi), np.where(over, lo, mu)
        mus[..., i], ds[..., i] = mu, d
    mu_star = np.sqrt(lo * hi)
    x, results = solve(mu_star, x, max_iter)
    return mu_star, mus, ds, results, discrepancy(x)


def _probe_regularizers(config: DeconvolutionConfig):
    """(TV at weight 1, the fixed priors): mu scales the TV term only; the
    sparsity and Hessian priors enter every probe at their own weights
    (``autotune.py:163-169``)."""
    return (make_regularizer(dataclasses.replace(config, mu=1.0, sparsity=0.0, hessian=0.0)),
            make_regularizer(dataclasses.replace(config, mu=0.0)))


def _result(res) -> DeconvolutionResult:
    return DeconvolutionResult(res.x, res.f, res.iterations, res.evaluations, res.status, res.f_history,
                               res.pg_history)


def deconvolve_auto_mu(
    data: torch.Tensor,
    psf: torch.Tensor,
    weights: torch.Tensor | None = None,
    config: DeconvolutionConfig = DeconvolutionConfig(),
    *,
    sigma=None,
    tau: float = 1.0,
    bracket: tuple[float, float] = (1e-7, 1e3),
    steps: int = 12,
    search_max_iter: int | None = None,
    init: str = "data",
) -> AutoMuResult:
    """Deconvolve with mu selected by the discrepancy principle
    (``autotune.py:104-224``).

    ``sigma``: the data's Gaussian noise sigma, None = estimated by
    :func:`estimate_noise_sigma`; ignored with ``weights`` (the target is
    then the count of positive weights) and for ``data_term='poisson'``.
    ``tau``: the safety factor on the target. ``bracket``: the geometric
    search interval. ``steps``: bisection iterations. ``search_max_iter``:
    VMLMB iterations a probe (default ``config.max_iter``); probes
    warm-start from the previous solution. ``config.mu`` is ignored. Runs on
    the device of its tensors."""
    lo0, hi0 = _check_search(bracket, steps)
    cost, var_shape = _build_data_cost(psf, data, weights, config)
    sigma_out, target = _target(data, weights, config, sigma, tau, lanes=False)
    reg1, reg_fixed = _probe_regularizers(config)

    def solve(mu, x0, maxiter):
        mu = float(mu)
        fun = value_and_grad(lambda x: cost.cost(x) + mu * reg1(x) + reg_fixed(x))
        res = minimize_vmlmb(fun, x0, **{**_vmlmb_options(config), "maxiter": maxiter}, maxeval=config.max_eval)
        return res.x, res

    def discrepancy(x):
        with torch.no_grad():
            return _host(2.0 * cost.cost(x))

    probe_iter = int(config.max_iter if search_max_iter is None else search_max_iter)
    x0 = _start(data, psf, var_shape, config, init, lanes=False)
    mu, mus, ds, res, d = _bisect(solve, discrepancy, np.asarray(target), x0, lo0, hi0, steps, probe_iter,
                                  int(config.max_iter))
    return AutoMuResult(mu, sigma_out, target, d, mus, ds, _result(res))


def _auto_mu_lanes(data, psf, weights, config: DeconvolutionConfig, *, sigma=None, tau: float = 1.0,
                   bracket=(1e-7, 1e3), steps: int = 12, search_max_iter: int | None = None,
                   init: str = "data") -> AutoMuResult:
    """:func:`deconvolve_auto_mu` of each lane of a batch (B, Nz, Ny, Nx):
    each lane has its own noise estimate, target and bisection, and each
    probe round is one lockstep ``minimize_vmlmb_batched`` solve with one mu
    a lane (one batched FFT pair and one batched TV launch a step). Every
    field of the result has a leading batch axis."""
    lo0, hi0 = _check_search(bracket, steps)
    cost, var_shape = _build_data_cost(psf, data, weights, config)
    sigma_out, target = _target(data, weights, config, sigma, tau, lanes=True)
    reg1, reg_fixed = _probe_regularizers(config)
    nb = data.shape[0]

    def solve(mu, x0, maxiter):
        mu_t = torch.as_tensor(mu, dtype=data.dtype, device=data.device)

        def build(lane_cost, lanes):
            m = mu_t[list(lanes)]
            return value_and_grad(lambda x: lane_cost.cost(x) + m * reg1(x) + reg_fixed(x))

        results = minimize_vmlmb_batched(lane_objective(cost, nb, build), x0,
                                         **{**_vmlmb_options(config), "maxiter": maxiter}, maxeval=config.max_eval)
        return torch.stack([r.x for r in results]), results

    def discrepancy(x):
        with torch.no_grad():
            return _host(2.0 * cost.cost(x))

    probe_iter = int(config.max_iter if search_max_iter is None else search_max_iter)
    x0 = _start(data, psf, var_shape, config, init, lanes=True)
    mu, mus, ds, results, d = _bisect(solve, discrepancy, target, x0, lo0, hi0, steps, probe_iter,
                                      int(config.max_iter))
    return AutoMuResult(mu, sigma_out, target, d, mus, ds, _stacked(results))
