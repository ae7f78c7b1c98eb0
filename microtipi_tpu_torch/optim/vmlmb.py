"""VMLMB: bound-constrained limited-memory quasi-Newton minimizer.

Port of ``microtipi_tpu/optim/vmlmb.py`` (TiPi's ``VMLMB`` as
``microscopy/PSF_Estimation.java`` drives it): L-BFGS two-loop recursion with
memory 5 (``:188``), More-Thuente ``(0.05, 0.1, 1e-17)`` when unbounded
(``:186``), projected-path Armijo backtracking when bounded, stopping on
``||pg|| <= max(gatol, grtol*||pg0||)`` (``:190-191``), ``maxiter`` and a
``maxeval`` that caps the line search itself (``:221,243-248``), and the best
point tracked per *evaluation* (``:208-216,254``).

The JAX ``lax.while_loop`` becomes a host loop. Vectors stay tensors on
their device; the scalars that steer control flow (f, directional
derivatives, norms, the curvature test) come to the host as NumPy scalars of
the objective's dtype. The L-BFGS history is a circular buffer whose empty
slots (``rho = 0``) are exact no-ops of the two-loop and are skipped. It is
kept in the iterate's dtype.

The loop is a generator (:func:`vmlmb_steps`) that yields each point to
evaluate, through both line searches. :func:`minimize_vmlmb` drives one with
the objective; :func:`minimize_vmlmb_batched` drives one per lane of a batch
in lockstep, with one batched objective call per step: the port's
counterpart of ``jax.vmap`` over the JAX while-loop, where each lane keeps
its own iterate, memory and stopping and a finished lane freezes.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from microtipi_tpu_torch.optim.linesearch import drive, more_thuente_steps
from microtipi_tpu_torch.optim.treeutil import like, taxpy, tdot, tmap, tnorm, tscale, tsub, twhere

__all__ = ["minimize_vmlmb", "minimize_vmlmb_batched", "vmlmb_steps", "VMLMBResult", "VMLMBStatus"]


class VMLMBStatus:
    """Termination codes (``vmlmb.py:49-61``)."""

    CONVERGED = 0
    MAX_ITER = 1
    MAX_EVAL = 2
    LINESEARCH_FAIL = 3
    NO_DESCENT = 4


class VMLMBResult(NamedTuple):
    x: Any  # best-seen iterate (PSF_Estimation.java:254)
    f: Any  # its cost, a NumPy scalar
    g: Any  # gradient at the final (not necessarily best) iterate
    iterations: int
    evaluations: int
    status: int
    f_history: np.ndarray  # per-iteration cost, NaN-padded, length maxiter+1
    pg_history: np.ndarray  # per-iteration projected-gradient norm


def _host(t: torch.Tensor):
    """A 0-dim tensor as a NumPy scalar of its dtype (one device sync)."""
    return t.detach().cpu().numpy()[()]


def _leaf_bounds(bound, x) -> dict | float | None:
    """A bound as ``vmlmb.py:111-120``'s ``_normalize_bound`` reads it: None
    (unbounded), a scalar for every element, or a tree matching ``x`` whose
    leaves are scalars or arrays broadcast to their leaf (per-variable
    bounds of a dict iterate, ``-inf`` for a free one). Returns None, one
    float, or a dict of per-leaf floats or tensors on each leaf's device."""
    if bound is None or isinstance(bound, (int, float, np.integer, np.floating)):
        return None if bound is None else float(bound)
    if isinstance(bound, np.ndarray) and bound.ndim == 0:
        return float(bound)

    def leaf(b, xi):
        if isinstance(b, (int, float, np.integer, np.floating)) or np.ndim(b) == 0:
            return float(b)
        return torch.broadcast_to(torch.as_tensor(b, dtype=xi.dtype, device=xi.device), xi.shape)

    if isinstance(x, dict):
        if not isinstance(bound, dict) or sorted(bound) != sorted(x):
            raise TypeError(f"a bound of a dict iterate is a scalar or a dict with its keys {sorted(x)}")
        return {k: leaf(bound[k], x[k]) for k in sorted(x)}
    return {None: leaf(bound, x)}


def _bound_of(bounds, key):
    return bounds if not isinstance(bounds, dict) else bounds[key]


def minimize_vmlmb(fun: Callable[[Any], tuple[torch.Tensor, Any]], x0: Any, **options) -> VMLMBResult:
    """Minimize ``fun(x) -> (f, g)`` from ``x0`` (a tensor or a dict of
    tensors); ``vmlmb.py:123-347`` step for step. ``options``: those of
    :func:`vmlmb_steps`."""
    return drive(vmlmb_steps(x0, **options), fun)


def minimize_vmlmb_batched(
    fun: Callable[[torch.Tensor, tuple[int, ...]], tuple[torch.Tensor, torch.Tensor]],
    x0: torch.Tensor,
    *,
    maxeval=None,
    maxiter_cap=None,
    **kw,
) -> list[VMLMBResult]:
    """B independent minimizations in lockstep, one per lane of ``x0``
    (B, ...): lane b's result is :func:`minimize_vmlmb` from ``x0[b]``.

    Each lane runs :func:`vmlmb_steps` with its own iterate, line search,
    L-BFGS memory and stopping. Every step stacks the trial points of the
    lanes still running and makes ONE call ``fun(x, lanes) -> (f (n,),
    g (n, ...))`` for those lanes (``lanes``: their indices, ascending); a
    finished lane is no longer evaluated. ``maxeval`` and ``maxiter_cap`` are
    one value for every lane or a sequence of B; ``kw`` are the other
    options of :func:`vmlmb_steps`, shared by all lanes.
    """
    nb = x0.shape[0]
    evals, caps = _per_lane(maxeval, nb), _per_lane(maxiter_cap, nb)
    steps = [vmlmb_steps(x0[b], maxeval=evals[b], maxiter_cap=caps[b], **kw) for b in range(nb)]
    requests = {b: next(gen) for b, gen in enumerate(steps)}
    results: list = [None] * nb
    while requests:
        lanes = tuple(requests)
        f, g = fun(torch.stack([requests[b] for b in lanes]), lanes)
        f = f.detach().cpu()  # one device sync for every lane's cost
        for i, b in enumerate(lanes):
            try:
                requests[b] = steps[b].send((f[i], g[i]))
            except StopIteration as stop:
                results[b] = stop.value
                del requests[b]
    return results


def _per_lane(value, nb: int) -> list:
    if value is None or np.ndim(value) == 0:
        return [value] * nb
    if len(value) != nb:
        raise ValueError(f"{len(value)} per-lane values for {nb} lanes")
    return [int(v) for v in value]


def vmlmb_steps(
    x0: Any,
    *,
    lower=None,
    upper=None,
    mem: int = 5,
    maxiter: int = 20,
    maxeval: int | None = None,
    gatol: float = 0.0,
    grtol: float = 1e-3,
    ls_ftol: float = 0.05,
    ls_gtol: float = 0.1,
    ls_xtol: float = 1e-17,
    ls_max_evals: int = 20,
    maxiter_cap: int | None = None,
):
    """VMLMB from ``x0`` as a generator: it yields each point to evaluate,
    takes ``(f, g)`` back by ``send`` and returns the :class:`VMLMBResult`.
    Whoever drives it decides how the objective runs (one call per point, or
    one call for a batch of lanes).

    ``maxeval`` defaults to ``2 * maxiter`` (``PSF_Estimation.java:270-273``).
    ``maxiter`` sizes the histories; ``maxiter_cap`` (<= maxiter, default
    ``maxiter``) bounds the iterations, for a caller continuing a budget. A
    cap <= 0 or ``maxeval <= 1`` returns after the initial evaluation with
    status CONVERGED. ``lower``/``upper``: None, a scalar for every element,
    or (a dict iterate) a dict of per-variable scalars or arrays.
    """
    if maxeval is None:
        maxeval = 2 * maxiter
    cap = maxiter if maxiter_cap is None else int(maxiter_cap)
    maxeval = int(maxeval)
    lo_b, hi_b = _leaf_bounds(lower, x0), _leaf_bounds(upper, x0)
    bounded = lo_b is not None or hi_b is not None

    def leafwise(fn, x, *rest):
        # fn(key, leaf, *rest leaves): the leaf's own bounds come by key.
        if isinstance(x, dict):
            return like((x, *rest), {k: fn(k, x[k], *(r[k] for r in rest)) for k in sorted(x)})
        return fn(None, x, *rest)

    def clamp(key, xi):
        lo, hi = _bound_of(lo_b, key), _bound_of(hi_b, key)
        if lo is not None:  # jnp.clip: min(max(x, lo), hi)
            xi = torch.clamp_min(xi, lo) if isinstance(lo, float) else torch.maximum(xi, lo)
        if hi is not None:
            xi = torch.clamp_max(xi, hi) if isinstance(hi, float) else torch.minimum(xi, hi)
        return xi

    def project(x):
        return leafwise(clamp, x) if bounded else x

    def blocked_mask(x, v, sign):
        # (x <= lo & sign*v > 0) | (x >= hi & sign*v < 0): active bounds.
        def one(key, xi, vi):
            lo, hi = _bound_of(lo_b, key), _bound_of(hi_b, key)
            m = torch.zeros_like(xi, dtype=torch.bool)
            if lo is not None:
                m = m | ((xi <= lo) & (sign * vi > 0))
            if hi is not None:
                m = m | ((xi >= hi) & (sign * vi < 0))
            return m

        return leafwise(one, x, v)

    def zero_where(mask, v):
        return twhere(mask, tmap(torch.zeros_like, v), v)

    def projected_gradient(x, g):
        return zero_where(blocked_mask(x, g, 1), g) if bounded else g

    x0 = project(x0)
    f0, g0 = yield x0
    dt = _host(f0).dtype.type
    f0 = dt(_host(f0))
    eps, tiny = dt(np.finfo(dt).eps), dt(np.finfo(dt).tiny)
    pg0norm = _host(tnorm(projected_gradient(x0, g0)))
    gstop = max(dt(gatol), dt(grtol) * pg0norm)

    s_mem: list = [None] * mem
    y_mem: list = [None] * mem
    rho = [0.0] * mem  # host floats, rounded to the objective's dtype
    gamma = 1.0
    head = 0
    alpha_prev = dt(1.0)

    hist_f = np.full((maxiter + 1,), np.nan, dt)
    hist_pg = np.full((maxiter + 1,), np.nan, dt)
    hist_f[0], hist_pg[0] = f0, pg0norm

    x, f, g = x0, f0, g0
    best_x, best_f = x0, f0
    iters, evals = 0, 1
    status = VMLMBStatus.CONVERGED
    done = (pg0norm <= gstop) or (cap <= 0) or (maxeval <= 1)

    while not done:
        # ---- search direction: two-loop recursion, oldest slot last --------
        q, alphas = g, {}
        for j in range(mem):
            slot = (head - 1 - j) % mem
            if rho[slot] != 0.0:
                a = rho[slot] * tdot(s_mem[slot], q)
                q = taxpy(-a, y_mem[slot], q)
                alphas[slot] = a
        q = tscale(gamma, q)
        for j in range(mem):
            slot = (head + j) % mem
            if rho[slot] != 0.0:
                b = rho[slot] * tdot(y_mem[slot], q)
                q = taxpy(alphas[slot] - b, s_mem[slot], q)
        d = tscale(-1.0, q)

        if bounded:
            # Zero components that push against an active bound, then fall
            # back to projected steepest descent if the metric is useless.
            d = zero_where(blocked_mask(x, d, -1), d)
            dg = dt(_host(tdot(d, g)))
            if dg >= 0.0:
                pg = projected_gradient(x, g)
                d = tscale(-1.0, pg)
                dg = -dt(_host(tdot(pg, pg)))
        else:
            dg = dt(_host(tdot(d, g)))
            if dg >= 0.0:
                d = tscale(-1.0, g)
                dg = -dt(_host(tdot(g, g)))
        no_descent = dg >= 0.0  # only if the gradient itself vanished

        # First step: 1/||d|| before any curvature pair, then 1 (bounded:
        # twice the previous accepted step, capped at 1).
        if any(r != 0.0 for r in rho):
            step0 = min(dt(1.0), dt(2.0) * alpha_prev) if bounded else dt(1.0)
        else:
            step0 = dt(1.0) / max(dt(_host(tnorm(d))), tiny)

        # ---- line search on what is left of the global eval budget ---------
        ls_budget = min(ls_max_evals, maxeval - evals)
        if bounded:
            x_new, f_new, g_new, ls_evals, ls_ok, ls_best_a, ls_best_f, ls_alpha = yield from _armijo_projected(
                project, x, f, g, d, step0, ls_ftol, ls_budget
            )
            best_trial = lambda: project(taxpy(ls_best_a, d, x))  # noqa: E731
            if ls_ok:
                alpha_prev = ls_alpha
        else:
            def phi(alpha):
                ft, gt = yield taxpy(float(alpha), d, x)
                return dt(_host(ft)), dt(_host(tdot(gt, d))), gt

            res = yield from more_thuente_steps(phi, step0, f, dg, g, ftol=ls_ftol, gtol=ls_gtol,
                                                xtol=ls_xtol, max_evals=ls_budget)
            x_new = taxpy(float(res.step), d, x)
            f_new, g_new, ls_evals = res.f, res.aux, res.evals
            ls_ok = res.status < 2
            ls_best_f = res.best_f
            best_trial = lambda: taxpy(float(res.best_step), d, x)  # noqa: E731

        # ---- curvature update ----------------------------------------------
        s_vec = tsub(x_new, x)
        y_vec = tsub(g_new, g)
        sy = dt(_host(tdot(s_vec, y_vec)))
        if sy > eps * dt(_host(tnorm(s_vec))) * dt(_host(tnorm(y_vec))):
            s_mem[head], y_mem[head] = s_vec, y_vec
            rho[head] = float(dt(1.0) / sy)
            gamma = float(sy / max(dt(_host(tdot(y_vec, y_vec))), tiny))
            head = (head + 1) % mem

        # ---- bookkeeping ---------------------------------------------------
        iters += 1
        evals += ls_evals
        if ls_best_f < best_f:  # best tracked per evaluation
            best_f, best_x = ls_best_f, best_trial()

        pgnorm = dt(_host(tnorm(projected_gradient(x_new, g_new))))
        hist_f[iters], hist_pg[iters] = f_new, pgnorm
        x, f, g = x_new, f_new, g_new

        converged = pgnorm <= gstop
        done = converged or iters >= cap or evals >= maxeval or (not ls_ok) or no_descent
        if done:
            # MAX_EVAL outranks LINESEARCH_FAIL: a search truncated by the
            # global budget reports budget exhaustion, not failure.
            if converged:
                status = VMLMBStatus.CONVERGED
            elif no_descent:
                status = VMLMBStatus.NO_DESCENT
            elif evals >= maxeval:
                status = VMLMBStatus.MAX_EVAL
            elif not ls_ok:
                status = VMLMBStatus.LINESEARCH_FAIL
            else:
                status = VMLMBStatus.MAX_ITER

    return VMLMBResult(best_x, best_f, g, iters, evals, status, hist_f, hist_pg)


def _armijo_projected(project, x, f, g, d, step0, ftol, max_evals):
    """Backtracking Armijo search along the projected path x(a) = P[x + a*d]
    with the path-aware test ``f(x(a)) <= f + ftol * <g, x(a) - x>``
    (``vmlmb.py:350-407``); a generator that yields each trial point."""
    dt = type(f)

    def trial(alpha):
        xt = project(taxpy(float(alpha), d, x))
        ft, gt = yield xt
        return xt, dt(_host(ft)), gt

    alpha = dt(step0)
    xt, ft, gt = yield from trial(alpha)
    evals, ok = 1, False
    best_alpha, best_f = alpha, ft
    while True:
        dec = dt(_host(tdot(g, tsub(xt, x))))
        # dec >= 0 when the projection clips interior coordinates past their
        # bound at this step: a reason to backtrack, not to stop.
        ok = (ft <= f + dt(ftol) * dec) and (dec < 0)
        if ok or evals >= max_evals:
            return xt, ft, gt, evals, ok, best_alpha, best_f, alpha
        alpha = alpha * dt(0.5)
        xt, ft, gt = yield from trial(alpha)
        evals += 1
        if ft < best_f:
            best_alpha, best_f = alpha, ft
