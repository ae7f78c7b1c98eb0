"""More-Thuente line search satisfying the strong Wolfe conditions.

Port of ``microtipi_tpu/optim/linesearch.py`` (MINPACK ``dcsrch``/``dcstep``,
More & Thuente 1994, as TiPi's ``MoreThuenteLineSearch``; the reference uses
``(sftol, sgtol, sxtol) = (0.05, 0.1, 1e-17)``,
``microscopy/PSF_Estimation.java:186``). The JAX version is one
``lax.while_loop`` selecting among ``jnp.where`` branches; here it is a host
loop that takes the same branches. Scalars are NumPy scalars of the
objective's dtype, so float32 searches round as the JAX ones do.

The search is a generator, :func:`more_thuente_steps`, and so is its
``phi(alpha)``: it yields the point to evaluate and returns ``(f, df, aux)``,
``f`` and the directional derivative ``df`` as NumPy scalars, ``aux``
anything to carry (the full gradient). Whoever drives the generator runs the
objective (``optim/vmlmb.py``: one call per point, or one call for every
lane of a batch in lockstep); :func:`drive` runs it with a plain function.

Status codes: 0 = converged (strong Wolfe), 1 = xtol/interval warning
(best point returned), 2 = evaluation budget exhausted.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np

__all__ = ["more_thuente_steps", "LineSearchResult", "drive"]

_XTRAPL = 1.1
_XTRAPU = 4.0


def _safe_div(p, q):
    return p / q if q != 0 else p * 0


def _dcstep(stx, fx, dx, sty, fy, dy, stp, fp, dp, brackt, stpmin, stpmax):
    """One trial-step update of MINPACK dcstep (``linesearch.py:36-122``):
    the case the JAX code selects, computed alone."""
    sgnd = dp * np.sign(dx)

    def gamma(theta, da, db, negate):
        s = max(abs(theta), max(abs(da), abs(db)))
        g = s * np.sqrt(max(_safe_div(theta, s) ** 2 - _safe_div(da, s) * _safe_div(db, s), 0.0))
        return -g if negate else g

    case1 = fp > fx
    case2 = (not case1) and (sgnd < 0.0)
    case3 = (not case1) and (not case2) and (abs(dp) < abs(dx))
    if case1:  # higher function value: the minimum is bracketed
        theta = 3.0 * _safe_div(fx - fp, stp - stx) + dx + dp
        g = gamma(theta, dx, dp, stp < stx)
        p = (g - dx) + theta
        q = ((g - dx) + g) + dp
        stpc = stx + _safe_div(p, q) * (stp - stx)
        stpq = stx + _safe_div(dx, _safe_div(fx - fp, stp - stx) + dx) / 2.0 * (stp - stx)
        stpf = stpc if abs(stpc - stx) < abs(stpq - stx) else stpc + (stpq - stpc) / 2.0
    elif case2:  # lower value, derivatives of opposite sign
        theta = 3.0 * _safe_div(fx - fp, stp - stx) + dx + dp
        g = gamma(theta, dx, dp, stp > stx)
        p = (g - dp) + theta
        q = ((g - dp) + g) + dx
        stpc = stp + _safe_div(p, q) * (stx - stp)
        stpq = stp + _safe_div(dp, dp - dx) * (stx - stp)
        stpf = stpc if abs(stpc - stp) > abs(stpq - stp) else stpq
    elif case3:  # lower value, same sign, decreasing derivative magnitude
        theta = 3.0 * _safe_div(fx - fp, stp - stx) + dx + dp
        g = gamma(theta, dx, dp, stp > stx)
        p = (g - dp) + theta
        q = (g + (dx - dp)) + g
        r = _safe_div(p, q)
        if r < 0.0 and g != 0.0:
            stpc = stp + r * (stx - stp)
        else:
            stpc = stpmax if stp > stx else stpmin
        stpq = stp + _safe_div(dp, dp - dx) * (stx - stp)
        if brackt:
            stpf = stpc if abs(stpc - stp) < abs(stpq - stp) else stpq
            bound = stp + 0.66 * (sty - stp)
            stpf = min(bound, stpf) if stp > stx else max(bound, stpf)
        else:
            stpf = stpc if abs(stpc - stp) > abs(stpq - stp) else stpq
            stpf = min(max(stpf, stpmin), stpmax)
    else:  # lower value, same sign, non-decreasing magnitude
        if brackt:
            theta = 3.0 * _safe_div(fp - fy, sty - stp) + dy + dp
            g = gamma(theta, dy, dp, stp > sty)
            p = (g - dp) + theta
            q = ((g - dp) + g) + dy
            stpf = stp + _safe_div(p, q) * (sty - stp)
        else:
            stpf = stpmax if stp > stx else stpmin

    # Uniform interval update.
    if case1:
        sty, fy, dy = stp, fp, dp
    elif sgnd < 0.0:
        sty, fy, dy = stx, fx, dx
    if not case1:
        stx, fx, dx = stp, fp, dp
    return stx, fx, dx, sty, fy, dy, stpf, brackt or case1 or case2


class LineSearchResult(NamedTuple):
    step: Any
    f: Any
    df: Any
    aux: Any
    evals: int
    status: int  # 0 converged, 1 warning (best point), 2 eval budget
    # Best trial over every evaluation, Wolfe-accepted or not
    # (PSF_Estimation.java:208-216).
    best_step: Any
    best_f: Any


def drive(gen, fun: Callable):
    """Run a generator that yields evaluation requests: send back
    ``fun(request)`` for each, and return what the generator returns."""
    try:
        request = next(gen)
        while True:
            request = gen.send(fun(request))
    except StopIteration as stop:
        return stop.value


def more_thuente_steps(
    phi,
    step0,
    f0,
    df0,
    aux0: Any,
    ftol: float = 0.05,
    gtol: float = 0.1,
    xtol: float = 1e-17,
    step_min: float = 1e-20,
    step_max: float = 1e20,
    max_evals: int = 20,
):
    """Find a step satisfying ``f(a) <= f0 + ftol*a*df0`` and
    ``|f'(a)| <= gtol*|df0|`` along a descent direction (``df0 < 0``);
    ``linesearch.py:141-257`` step for step. ``phi(alpha)`` is a generator
    function returning ``(f, df, aux)``; every request it yields passes
    through, and the search returns a :class:`LineSearchResult`."""
    dt = np.asarray(f0).dtype.type
    stp = dt(step0)
    stpmin, stpmax = dt(step_min), dt(step_max)
    gtest = dt(ftol) * df0
    width = stpmax - stpmin
    width1 = dt(2.0) * width

    f, df, aux = yield from phi(stp)
    stx, fx, dx = dt(0.0), f0, df0
    sty, fy, dy = dt(0.0), f0, df0
    brackt, stage1 = False, True
    stmin, stmax = dt(0.0), stp + dt(_XTRAPU) * stp
    evals = 1
    best_step, best_f = stp, f

    while True:
        ftest = f0 + stp * gtest
        stage1 = stage1 and not ((f <= ftest) and (df >= 0.0))
        converged = (f <= ftest) and (abs(df) <= dt(gtol) * (-df0))
        warn = (
            (brackt and ((stp <= stmin) or (stp >= stmax)))
            or (brackt and (stmax - stmin <= dt(xtol) * stmax))
            or ((stp == stpmax) and (f <= ftest) and (df <= gtest))
            or ((stp == stpmin) and ((f > ftest) or (df >= gtest)))
        )
        if converged or warn or evals >= max_evals:
            status = 0 if converged else (1 if warn else 2)
            return LineSearchResult(stp, f, df, aux, evals, status, best_step, best_f)

        # Modified-function trick while in stage 1 above the ftest line.
        use_mod = stage1 and (f <= fx) and (f > ftest)
        if use_mod:
            fm, fxm, fym = f - stp * gtest, fx - stx * gtest, fy - sty * gtest
            dm, dxm, dym = df - gtest, dx - gtest, dy - gtest
        else:
            fm, fxm, fym, dm, dxm, dym = f, fx, fy, df, dx, dy

        stx, fx, dx, sty, fy, dy, stp_n, brackt = _dcstep(
            stx, fxm, dxm, sty, fym, dym, stp, fm, dm, brackt, stmin, stmax
        )
        if use_mod:
            fx, fy = fx + stx * gtest, fy + sty * gtest
            dx, dy = dx + gtest, dy + gtest

        # Force the interval width to shrink.
        if brackt and abs(sty - stx) >= dt(0.66) * width1:
            stp_n = stx + dt(0.5) * (sty - stx)
        if brackt:
            width1, width = width, abs(sty - stx)
            stmin, stmax = min(stx, sty), max(stx, sty)
        else:
            stmin = stp_n + dt(_XTRAPL) * (stp_n - stx)
            stmax = stp_n + dt(_XTRAPU) * (stp_n - stx)
        stp_n = min(max(stp_n, stpmin), stpmax)

        # If no further progress is possible, evaluate at the best point.
        if brackt and ((stp_n <= stmin) or (stp_n >= stmax) or (stmax - stmin <= dt(xtol) * stmax)):
            stp_n = stx

        stp = dt(stp_n)
        f, df, aux = yield from phi(stp)
        evals += 1
        if f < best_f:
            best_step, best_f = stp, f
