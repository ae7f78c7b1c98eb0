"""Alternative object-step engines: ADMM and FISTA.

Port of ``microtipi_tpu/jobs/admm.py`` (:1-561). Both minimize the objective
of ``jobs/deconv.make_objective`` exactly, so ``f_history`` is comparable
across engines:

- :func:`admm_deconvolve`: ADMM with variable splitting on the spatial
  gradient and the positivity bound. The x-update is a closed-form circulant
  solve, one rfftn/irfftn pair an iteration:

      x = F^-1[ (conj(H^) d^ rho0 + rhs^) / (rho0 |H^|^2 + rho1 sum|D^|^2 + rho2) ]

  the z-update is a pointwise Newton prox of the hyperbolic potential and the
  u-updates are axpys. The splitting uses circular differences, so D
  diagonalizes with H in the Fourier basis, while the penalty keeps the
  solver's replicate boundary: trailing-face components are masked out of the
  gradient magnitude inside the prox and pass through it unchanged.
- :func:`fista_deconvolve`: monotone FISTA with adaptive restart; smooth part
  = (weighted) Gaussian data term + mu*TV_eps, prox part = the positivity
  projection, step 1/L with the exact circulant Lipschitz bound.

The JAX module runs its iteration as one ``lax.scan`` (or a bounded
``lax.while_loop`` under Boyd stopping) inside ``jit``, where XLA fuses the
split update. Here the loop is a Python loop and the two fused pieces are the
CUDA kernels of ``ops/kernels/admm_split.py``: ``admm_rhs`` and
``admm_split_update``, one launch each an iteration, with the FFT pair and a
few spectrum operations between them (the JAX module's ``_circ_diffs``,
``_circ_diffs_adjoint`` and ``_hyperbolic_prox`` live there too, as the
kernels' plain building blocks). The weighted/Poisson data split (its
pointwise prox and dual update between the FFTs) and the residual norms of
``adaptive_rho`` and of the Boyd test stay PyTorch operators. The loop fetches
no scalar to the host: ``f_history`` is collected on the device and copied once
at the end, and a Boyd check costs one host sync (two when the primal test
passes), every ``admm_check_every`` iterations.

The engine is written once, over a batch: a 4D input (B, Nz, Ny, Nx) is B
lanes with their own ``rho``s, norms, ``f`` and stopping (FFTs over the last
three axes, the PSF shared or one per lane), and a 3D input is B = 1. Under
Boyd stopping a lane that has converged is taken out of the batch while the
rest run on, so each lane gives what its own solve gives.

The joint solvers' engines (:564-1500) share one engine, :func:`_admm_joint`,
over a (T, C) + volume block: :func:`admm_deconvolve_timeseries` (C = 1),
:func:`admm_deconvolve_multichannel` (T = 1) and
:func:`admm_deconvolve_timeseries_multichannel`. It reuses the kernels' lanes,
the block's T * C volumes, but not the lane semantics above: the block is one
problem, with one f, one rho0 and one Boyd test. Its temporal split, the joint
TV's prox, mixing and the data proxes are PyTorch operators.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from microtipi_tpu_torch.jobs.deconv import (
    DeconvolutionConfig,
    DeconvolutionResult,
    _data_cost,
    make_objective,
    objective_value,
)
from microtipi_tpu_torch.ops import convolution as conv
from microtipi_tpu_torch.ops.convolution import select_lanes
from microtipi_tpu_torch.jobs.multichannel import make_tsmc_objective
from microtipi_tpu_torch.jobs.timeseries import as_channel_block
from microtipi_tpu_torch.ops.kernels.admm_split import (
    admm_rhs,
    admm_split_update,
    circ_diffs as _circ_diffs,
    circ_diffs_adjoint as _circ_diffs_adjoint,
    hyperbolic_prox,
    per_lane as _per_lane,
    split_apply,
    split_magnitude,
)
from microtipi_tpu_torch.utils.arrays import pad_fft_kernel
from microtipi_tpu_torch.utils.profiling import span

__all__ = ["admm_deconvolve", "admm_deconvolve_multichannel", "admm_deconvolve_timeseries",
           "admm_deconvolve_timeseries_multichannel", "fista_deconvolve"]


def _check_config(config: DeconvolutionConfig, engine: str) -> None:
    if engine == "fista" and config.data_term != "gaussian":
        raise ValueError("fista engine supports the Gaussian data term only")
    if config.sparsity > 0 or config.hessian > 0:
        raise ValueError(f"{engine} engine supports the mu*TV prior only (sparsity/"
                         "hessian priors: use the VMLMB engine)")
    if config.var_shape is not None:
        raise ValueError(f"{engine} engine does not support padded-variable mode "
                         "(config.var_shape); use the VMLMB engine")


def _grad_sq_spectrum(shape, scales, dtype, device=None) -> torch.Tensor:
    """``sum_a |D^_a|^2 / scale_a^2`` on the rfftn grid: ``|e^{-2 pi i k} - 1|^2
    = 4 sin^2(pi k / N)`` for the circular forward difference."""
    nz, ny, nx = shape
    sz = (1.0, 1.0, 1.0) if scales is None else tuple(float(s) for s in scales)
    kz = torch.fft.fftfreq(nz, dtype=dtype, device=device)
    ky = torch.fft.fftfreq(ny, dtype=dtype, device=device)
    kx = torch.fft.rfftfreq(nx, dtype=dtype, device=device)
    return (
        (4.0 / sz[0] ** 2) * torch.sin(math.pi * kz)[:, None, None] ** 2
        + (4.0 / sz[1] ** 2) * torch.sin(math.pi * ky)[None, :, None] ** 2
        + (4.0 / sz[2] ** 2) * torch.sin(math.pi * kx)[None, None, :] ** 2
    )


def _stack_norm(terms) -> torch.Tensor:
    """L2 norm per lane (B,) of a stacked list of tensors (B, ...)."""
    return torch.sqrt(sum((t * t).flatten(1).sum(1) for t in terms))


def _boyd_criterion(r_terms, z_terms, dual_fn, p_el, n_el, abstol, reltol) -> torch.Tensor:
    """Boyd et al. 2011 section 3.3 stopping pair for the stacked-splits form
    ``A x - z = 0`` (A the stacked split operators, y = rho*u the unscaled
    duals), per lane:

        ||r|| <= sqrt(p)*abstol + reltol*||z||       (primal)
        ||s|| <= sqrt(n)*abstol + reltol*||A^T y||   (dual)

    with r the stacked primal residuals, s = sum_i rho_i A_i^T (z_i^+ - z_i)
    the dual residual in x-space, p and n the stacked-constraint and variable
    element counts. The relative primal scale uses ``||z||`` alone instead of
    ``max(||Ax||, ||z||)``: strictly conservative, and the stop point is the
    same since Ax = z at convergence.

    ``dual_fn() -> (s_vec, aty_vec)`` is evaluated only when some lane's primal
    test passes (one host sync decides): far from convergence a check pays the
    elementwise primal norms only and skips the dual residual's H^T
    applications (FFTs on the data-split paths). Returns (B,) booleans on the
    device."""
    rpri = _stack_norm(r_terms)
    prim_ok = rpri <= math.sqrt(p_el) * abstol + reltol * _stack_norm(z_terms)
    if not bool(prim_ok.any()):
        return prim_ok
    s_vec, aty_vec = dual_fn()
    return prim_ok & (_stack_norm([s_vec]) <= math.sqrt(n_el) * abstol + reltol * _stack_norm([aty_vec]))


def _admm_tolerances(config: DeconvolutionConfig):
    """(abstol, reltol, check_every, use_tol) from the config fields."""
    abstol = float(config.admm_abstol)
    reltol = float(config.admm_reltol)
    if abstol < 0 or reltol < 0:
        raise ValueError("admm_abstol/admm_reltol must be >= 0")
    check_every = max(int(config.admm_check_every), 1)
    return abstol, reltol, check_every, (abstol > 0.0 or reltol > 0.0)


def _scale_spectrum_(z_hat: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """``z_hat *= real`` for a complex spectrum and a real factor, as one real
    multiplication in place (no promotion of ``real`` to complex)."""
    torch.view_as_real(z_hat).mul_(real.unsqueeze(-1))
    return z_hat


def _objective_value(cost, config: DeconvolutionConfig):
    """``objective_value(cost, config)``, each value in an ``admm.objective`` span."""
    value = objective_value(cost, config)

    def objective(x):
        with span("admm.objective"):
            return value(x)

    return objective


def admm_deconvolve(
    data: torch.Tensor,
    psf: torch.Tensor,
    weights: torch.Tensor | None = None,
    x0: torch.Tensor | None = None,
    config: DeconvolutionConfig = DeconvolutionConfig(),
    *,
    rho0: float | None = None,
    rho1: float | None = None,
    rho2: float | None = None,
    adaptive_rho: bool = False,
    over_relax: float | None = None,
    track_objective: bool = True,
) -> DeconvolutionResult:
    """ADMM object step (Gaussian/weighted/Poisson + mu*TV + positivity),
    ``admm.py:185-479``.

    Uniform Gaussian (2 splits): ``min_x 0.5||Hx-d||^2 + mu*phi(M z1) +
    i_{>=0}(z2)`` s.t. ``z1 = Dx, z2 = x``, with D the circular difference
    stack and M the replicate-boundary mask. x-update: ``(H^T H + rho1 D^T D +
    rho2 I) x = H^T d + rho1 D^T(z1-u1) + rho2 (z2-u2)``, circulant, one FFT
    pair. Per-voxel weights or the Poisson term add a data split ``z0 = Hx``
    whose prox is pointwise (weighted Gaussian: ``(w d + rho0 v)/(w + rho0)``;
    Poisson, m = z0 + b: the positive root of ``rho0 z^2 + z (1 + rho0 (b - v))
    + (b - d - rho0 v b) = 0``); the x-update then takes 4 FFTs.

    ``over_relax``: Boyd 2011 section 3.4.3, each split's ``Ax`` replaced by
    ``alpha Ax + (1-alpha) z_old`` in the prox argument and the dual update.
    None resolves to 1.8, or 1.0 when ``adaptive_rho`` is live. ``rho1``/``rho2``
    default to mu/epsilon; ``rho0`` to 1, the mean weight, or (Poisson)
    ``1/(mean(d) + b)`` per lane. ``adaptive_rho`` turns on per-split residual
    balancing (section 3.4.1: double or halve a rho when its primal residual
    outweighs its dual residual 10x or vice versa, rescaling the scaled dual).

    Runs ``config.max_iter`` iterations, or, when ``config.admm_abstol`` or
    ``admm_reltol`` is set, up to ``max_iter`` with the Boyd section 3.3
    residual test every ``admm_check_every`` iterations (``status`` 0 =
    converged, 1 = budget exhausted; ``iterations`` the actual count;
    ``f_history`` NaN past it). ``track_objective`` records the solver
    objective of every iterate in ``f_history`` (2 extra FFTs and one TV
    launch an iteration); off, only slot 0 and the final ``f`` are computed.

    ``data`` is one volume or a batch (B, Nz, Ny, Nx) (then ``weights`` and
    ``x0`` are batched too, ``psf`` is shared or one per lane, and every field
    of the result has a leading batch axis). Runs on the device of its
    tensors; on a CUDA card in float32, through the CUDA kernels.

    While a ``torch.profiler`` session records, the call is an ``admm.solve``
    span holding ``admm.setup``, an ``admm.objective`` a value and, on the
    data-split paths, two ``admm.data_split`` an iteration
    (``utils/profiling.span``).
    """
    with span("admm.solve"):
        with span("admm.setup"):
            _check_config(config, "admm")
            abstol, reltol, check_every, use_tol = _admm_tolerances(config)
            if data.ndim not in (3, 4):
                raise ValueError(f"admm_deconvolve takes a 3D volume or a 4D batch, got shape {tuple(data.shape)}")
            batched = data.ndim == 4
            if not batched:
                data, weights, x0 = (None if t is None else t[None] for t in (data, weights, x0))
            if over_relax is None:
                # Over-relaxation theory assumes a fixed rho; with residual balancing
                # live the combination measured slightly worse, so the default backs off.
                over_relax = 1.0 if adaptive_rho else 1.8
            al = float(over_relax)
            if weights is not None:
                # Zero weight excludes the voxel whatever its value: 0 * NaN would
                # poison the split (as in WeightedConvolutionCost.build).
                data = torch.where(weights > 0, data, torch.zeros_like(data))
            nb, shape, dtype, dev = data.shape[0], tuple(data.shape[1:]), data.dtype, data.device
            mu, eps, bg, scales = float(config.mu), float(config.epsilon), float(config.background), config.scales
            poisson = config.data_term == "poisson"
            data_split = poisson or weights is not None
            r1 = float(rho1) if rho1 is not None else max(mu / max(eps, 1e-30), 1e-6)
            r2 = float(rho2) if rho2 is not None else r1
            n = int(config.max_iter)

            cost = _data_cost(psf, data, weights, config, accurate=True)  # float32 tracking needs the residual form
            objective = _objective_value(cost, config)
            h_hat = conv._rfftn(pad_fft_kernel(psf, shape))
            s2 = _grad_sq_spectrum(shape, scales, dtype, dev)

            x = x0 if x0 is not None else (torch.clamp_min(data, 0.0) if config.positivity else data)
            x = x.to(dtype).contiguous()
            hist = torch.full((nb, n + 1), float("nan"), dtype=dtype, device=dev)
            hist[:, 0] = objective(x)

            # Per-lane state: every tensor has the live lanes on its leading axis, so
            # taking a converged lane out is one index along it.
            st = {
                "lane": torch.arange(nb, device=dev),
                "x": x, "z1": _circ_diffs(x, scales), "z2": x.clone(), "u2": torch.zeros_like(x),
                "rho1": torch.full((nb,), r1, dtype=dtype, device=dev),
                "rho2": torch.full((nb,), r2, dtype=dtype, device=dev),
            }
            st["u1"] = torch.zeros_like(st["z1"])
            kernel_spectra = {"h_hat": h_hat, "h2": conv._abs2(h_hat)}
            if h_hat.ndim == 4:  # one PSF a lane: the spectra are per-lane state too
                st.update(kernel_spectra)
            if data_split:
                if rho0 is not None:
                    r0 = torch.full((nb,), float(rho0), dtype=dtype, device=dev)
                elif poisson:  # Poisson curvature at the data scale: d/m^2 ~ 1/mean(m)
                    r0 = 1.0 / torch.clamp_min(data.mean(dim=(1, 2, 3)) + bg, 1e-12)
                else:
                    r0 = weights.mean(dim=(1, 2, 3))
                st.update(r0=r0, data=data, z0=conv._irfftn(h_hat * conv._rfftn(x), shape), u0=torch.zeros_like(x))
                if not poisson:
                    st.update(weights=weights, wd=weights * data)
            else:
                st["htd_hat"] = torch.conj(h_hat) * conv._rfftn(data)

            def spectrum(name):
                return st.get(name, kernel_spectra[name])

            def refresh_rho():
                """What depends on the rhos: the x-update's denominator and the prox
                threshold. Once for fixed rhos, every iteration under adaptive_rho."""
                h2 = spectrum("h2")
                den = _per_lane(st["rho1"]) * s2 + _per_lane(st["rho2"])
                st["inv_den"] = 1.0 / (den + (_per_lane(st["r0"]) * h2 if data_split else h2))
                st["lam"] = mu / st["rho1"]

            def data_prox(v):
                """argmin_z g(z) + rho0/2 (z - v)^2 pointwise for the data term."""
                rr0 = _per_lane(st["r0"])
                if poisson:  # rho z^2 + z (1 + rho (b - v)) + (b - d - rho v b) = 0, the + root
                    b_coef = 1.0 + rr0 * (bg - v)
                    c_coef = bg - st["data"] - rr0 * v * bg
                    disc = torch.clamp_min(b_coef * b_coef - 4.0 * rr0 * c_coef, 0.0)
                    return (-b_coef + torch.sqrt(disc)) / (2.0 * rr0)
                return (st["wd"] + rr0 * v) / (st["weights"] + rr0)

            def step():
                """One ADMM iteration on the live lanes; returns ``hx`` (data-split
                paths, for the Boyd test)."""
                hh = spectrum("h_hat")
                rhs = admm_rhs(st["z1"], st["u1"], st["z2"], st["u2"], st["rho1"], st["rho2"], scales)
                x_hat = conv._rfftn(rhs)
                if data_split:
                    with span("admm.data_split"):
                        x_hat += _scale_spectrum_(torch.conj(hh) * conv._rfftn(st["z0"] - st["u0"]),
                                                  _per_lane(st["r0"]))
                else:
                    x_hat += st["htd_hat"]
                _scale_spectrum_(x_hat, st["inv_den"])
                st["x"] = conv._irfftn(x_hat, shape).contiguous()
                hx = None
                if data_split:
                    with span("admm.data_split"):
                        hx = conv._irfftn(hh * x_hat, shape)
                        hxr = hx if al == 1.0 else al * hx + (1.0 - al) * st["z0"]
                        z0 = data_prox(hxr + st["u0"])
                        st["u0"] = st["u0"] + hxr - z0
                        st["z0"] = z0
                admm_split_update(st["x"], st["z1"], st["u1"], st["z2"], st["u2"], st["lam"], eps, al,
                                  config.positivity, scales)
                return hx

            def balance_rho(z1_old, z2_old):
                """Per-split residual balancing (Boyd 2011 section 3.4.1), scaled-dual
                form: growing rho shrinks u by the same factor. rho0 stays fixed (its
                dual residual would cost an extra FFT pair)."""
                dx = _circ_diffs(st["x"], scales)
                for rho, u, rp, sd in (
                    ("rho1", "u1", _stack_norm([dx - st["z1"]]),
                     _stack_norm([_circ_diffs_adjoint(st["z1"] - z1_old, scales)])),
                    ("rho2", "u2", _stack_norm([st["x"] - st["z2"]]), _stack_norm([st["z2"] - z2_old])),
                ):
                    sd = st[rho] * sd
                    fac = torch.where(rp > 10.0 * sd, 2.0, torch.where(sd > 10.0 * rp, 0.5, 1.0)).to(dtype)
                    st[rho] = st[rho] * fac
                    st[u] /= fac.reshape((-1,) + (1,) * (st[u].ndim - 1))
                refresh_rho()

            def converged(z_old, hx) -> torch.Tensor:
                """The Boyd test on the live lanes. The splits are z0 = Hx (data
                paths), z1 = Dx, z2 = x, so the norms are elementwise except the two
                H^T applications of the dual residual on the data-split paths."""
                dx = _circ_diffs(st["x"], scales)
                r_terms, z_terms = [dx - st["z1"], st["x"] - st["z2"]], [st["z1"], st["z2"]]
                if data_split:
                    r_terms.append(hx - st["z0"])
                    z_terms.append(st["z0"])
                rr1, rr2 = _per_lane(st["rho1"]), _per_lane(st["rho2"])

                def conv_t(v):
                    return conv._irfftn(torch.conj(spectrum("h_hat")) * conv._rfftn(v), shape)

                def dual_fn():
                    s_vec = rr1 * _circ_diffs_adjoint(st["z1"] - z_old["z1"], scales) + rr2 * (st["z2"] - z_old["z2"])
                    aty = rr1 * _circ_diffs_adjoint(st["u1"], scales) + rr2 * st["u2"]
                    if data_split:
                        rr0 = _per_lane(st["r0"])
                        s_vec = s_vec + rr0 * conv_t(st["z0"] - z_old["z0"])
                        aty = aty + rr0 * conv_t(st["u0"])
                    return s_vec, aty

                n_el = float(np.prod(shape))
                return _boyd_criterion(r_terms, z_terms, dual_fn, n_el * (4.0 + data_split), n_el, abstol, reltol)

            refresh_rho()
            out = torch.empty_like(x)
            iterations = np.full((nb,), n, np.int64)
            status = np.full((nb,), 1 if use_tol else 0, np.int64)
            splits = ("z0", "z1", "z2") if data_split else ("z1", "z2")

            def result() -> torch.Tensor:
                """The live lanes' answer: z2 is feasible (>= 0) by construction."""
                return st["z2"] if config.positivity else st["x"]

        for i in range(1, n + 1):
            check = use_tol and i % check_every == 0
            z_old = {k: st[k].clone() for k in splits} if check else None
            if adaptive_rho:
                z1_old, z2_old = (z_old["z1"], z_old["z2"]) if check else (st["z1"].clone(), st["z2"].clone())
            hx = step()
            if adaptive_rho:
                balance_rho(z1_old, z2_old)
            if track_objective:
                hist[st["lane"], i] = objective(st["z2"])
            if not check:
                continue
            done = converged(z_old, hx)
            stop = st["lane"][done].tolist()  # the check's host sync
            if not stop:
                continue
            out[stop] = result()[done]
            iterations[stop] = i
            status[stop] = 0
            keep = (~done).nonzero().squeeze(1)
            st = {k: v[keep] for k, v in st.items()}
            if keep.numel() == 0:
                break
            objective = _objective_value(select_lanes(cost, st["lane"]), config)
        out[st["lane"]] = result()

        f = _objective_value(cost, config)(out).cpu().numpy()
        f_history = hist.cpu().numpy()
        if not batched:
            return DeconvolutionResult(out[0], f[0], int(iterations[0]), int(iterations[0]), int(status[0]),
                                       f_history[0], np.full_like(f_history[0], np.nan))
        return DeconvolutionResult(out, f, iterations, iterations.copy(), status, f_history,
                                   np.full_like(f_history, np.nan))


def fista_deconvolve(
    data: torch.Tensor,
    psf: torch.Tensor,
    weights: torch.Tensor | None = None,
    x0: torch.Tensor | None = None,
    config: DeconvolutionConfig = DeconvolutionConfig(),
    *,
    track_objective: bool = True,
) -> DeconvolutionResult:
    """Monotone FISTA with adaptive restart on the solver objective
    (``admm.py:482-561``), one 3D volume.

    Smooth part f = (weighted) Gaussian data term + mu*TV_eps; nonsmooth part
    = positivity indicator, prox = clamp. Step 1/L with the circulant
    Lipschitz bound ``L = max(w) * max|H^|^2 + mu * (sum_a 4/scale_a^2) /
    eps``. If the candidate increases f, the momentum restarts from the
    previous iterate (O'Donoghue and Candes 2015). The accept/restart choice
    is taken on the device, so the loop fetches no scalar to the host.
    """
    _check_config(config, "fista")
    if data.ndim != 3:
        raise ValueError(f"fista_deconvolve takes one 3D volume, got shape {tuple(data.shape)}")
    dtype, n = data.dtype, int(config.max_iter)
    mu, eps, scales = float(config.mu), float(config.epsilon), config.scales
    h_hat = conv._rfftn(pad_fft_kernel(psf, tuple(data.shape)))
    wmax = 1.0 if weights is None else weights.max()
    sz = (1.0, 1.0, 1.0) if scales is None else tuple(float(s) for s in scales)
    lip = wmax * conv._abs2(h_hat).max() + mu * sum(4.0 / s**2 for s in sz) / max(eps, 1e-30)

    # The monotone test compares f values: the residual form's float32 value
    # error is eps*f, not the quadratic form's eps*sum|x*Ax|.
    fg = make_objective(psf, data, weights, config, accurate=True)
    value = objective_value(_data_cost(psf, data, weights, config, accurate=True), config)

    x = x0 if x0 is not None else (torch.clamp_min(data, 0.0) if config.positivity else data)
    x = y = x.to(dtype)
    f_prev = value(x)
    t = torch.ones((), dtype=dtype, device=data.device)
    hist = torch.full((n + 1,), float("nan"), dtype=dtype, device=data.device)
    hist[0] = f_prev
    for i in range(1, n + 1):
        _, g_y = fg(y)
        x_new = y - g_y / lip
        if config.positivity:
            x_new = torch.clamp_min(x_new, 0.0)
        f_new = value(x_new)
        accept = f_new <= f_prev  # monotone safeguard: reject an increasing step, restart the momentum
        x_next = torch.where(accept, x_new, x)
        f_prev = torch.where(accept, f_new, f_prev)
        t_new = torch.where(accept, 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t)), torch.ones_like(t))
        beta = torch.where(accept, (t - 1.0) / t_new, torch.zeros_like(t))
        y = x_next + beta * (x_next - x)
        x, t = x_next, t_new
        if track_objective:
            hist[i] = f_prev
    if not track_objective:
        hist[0] = f_prev
    f_history = hist.cpu().numpy()
    return DeconvolutionResult(x, f_prev.cpu().numpy()[()], n, 2 * n, 0, f_history, np.full_like(f_history, np.nan))


_TZYX = (0, 2, 3, 4)  # the 4D transform of a (T, C, Nz, Ny, Nx) block: t and the volume, channels batched


def _rho0(rho0, config: DeconvolutionConfig, intensity, weights):
    """The data split's ``rho0`` of the joint and finer-grid engines: as
    given, else (Poisson) ``1 / (intensity + b)``, the curvature at the data
    scale, the mean weight, or 1."""
    if rho0 is not None:
        return float(rho0)
    if config.data_term == "poisson":
        return 1.0 / torch.clamp_min(intensity + float(config.background), 1e-12)
    return 1.0 if weights is None else weights.mean()


def _admm_joint(data, psfs, weights, x0, config: DeconvolutionConfig, *, mu_t, epsilon_t, bleach, coupling, mixing,
                rho0, rho1, rho1t, rho2, over_relax, track_objective) -> DeconvolutionResult:
    """The ADMM engine of the joint solves on a (T, C) + volume block
    (``admm.py:564-863``, ``:866-1186``, ``:1189-1500``), minimizing
    ``make_tsmc_objective`` (the time series is its C = 1 case, the
    multichannel solve its T = 1 case): the data term's split and prox, then
    :func:`_admm_loop`. With weights, Poisson, bleach or mixing the data
    split ``z0 = H x`` (per frame and dye) absorbs them in its pointwise prox;
    mixing's applies T precomputed (K, K) inverses ``(G_t M^T M G_t + rho0
    I)^-1`` by a channel einsum. The uniform Gaussian term takes no split."""
    _check_config(config, "admm")
    objective_grad, aux = make_tsmc_objective(psfs, data, weights, config, mu_t=mu_t, epsilon_t=epsilon_t,
                                              bleach=bleach, coupling=coupling, mixing=mixing, accurate=True)

    def objective(x):
        with torch.no_grad():
            return objective_grad(x)

    data, weights, k_hat, m, g5 = aux["data"], aux["weights"], aux["k_hat"], aux["m"], aux["g5"]
    nt, nk, dtype, dev = aux["nt"], aux["nk"], data.dtype, data.device
    bg, poisson = float(config.background), config.data_term == "poisson"
    r0 = _rho0(rho0, config, data.mean(), weights)
    data_prox = None
    if m is not None:  # T (K, K) prox inverses and the constant G_t M^T d_t
        gk = torch.ones((nt, nk), dtype=dtype, device=dev) if g5 is None else g5[..., 0, 0, 0]
        eye = torch.eye(nk, dtype=dtype, device=dev)
        prox_inv = torch.linalg.inv(gk[:, :, None] * (m.T @ m)[None] * gk[:, None, :] + r0 * eye[None])
        mtd = torch.einsum("tk,ck,tczyx->tkzyx", gk, m, data)

        def data_prox(v):
            return torch.einsum("tkj,tjzyx->tkzyx", prox_inv, mtd + r0 * v)
    elif poisson:
        def data_prox(v):  # rho z^2 + z (1 + rho (b - v)) + (b - d - rho v b) = 0, the + root
            b_coef = 1.0 + r0 * (bg - v)
            c_coef = bg - data - r0 * v * bg
            disc = torch.clamp_min(b_coef * b_coef - 4.0 * r0 * c_coef, 0.0)
            return (-b_coef + torch.sqrt(disc)) / (2.0 * r0)
    elif weights is not None or g5 is not None:
        g = 1.0 if g5 is None else g5
        w = 1.0 if weights is None else weights
        wgd, wgg = w * g * data, w * g * g

        def data_prox(v):
            return (wgd + r0 * v) / (wgg + r0)

    if x0 is None:
        x0 = data if m is None else torch.einsum("kc,tczyx->tkzyx", torch.linalg.pinv(m), data)
        if config.positivity:
            x0 = torch.clamp_min(x0, 0.0)
    return _admm_loop(objective, k_hat, x0.to(dtype).contiguous(), config, data_prox=data_prox, r0=r0, data=data,
                      coupling=coupling, mu_t=mu_t, epsilon_t=epsilon_t, rho1=rho1, rho1t=rho1t, rho2=rho2,
                      over_relax=over_relax, track_objective=track_objective)


def _admm_loop(objective, k_hat, x, config: DeconvolutionConfig, *, data_prox, r0, data, coupling, mu_t, epsilon_t,
               rho1, rho1t, rho2, over_relax, track_objective) -> DeconvolutionResult:
    """The ADMM iterations of the joint and finer-grid engines on a (T, K) +
    volume block ``x``, minimizing ``objective`` (no autograd) with the
    spectra ``k_hat`` (K,) + spectrum shared over t.

    Splits: ``z0 = H x`` when ``data_prox`` is given (``v -> argmin_z g(z) +
    rho0/2 ||z - v||^2`` of the data term at ``r0``; without it the uniform
    Gaussian x-update carries ``H^T data``), ``z1 = D_s x`` (spatial circular
    differences), ``zt = D_t x`` (temporal, when ``mu_t > 0``), ``z2 = x``.
    The spectra are t-constant and D_t is circulant along t, so the x-update
    is one 4D rfftn/irfftn pair over (t, z, y, x), channels batched, with
    denominator ``rho0 |H_k|^2 + rho1 sum|D_s|^2 + rho1t |D_t|^2 + rho2``.
    The trailing face of each frame and the trailing frame are unpenalized
    (identity-prox) components. With ``coupling="separate"`` the spatial
    split update runs in the ``admm_split_update`` kernel over the T * K
    lanes; ``"joint"`` takes one magnitude across a voxel's channels and axes
    (PyTorch operators); the right-hand side is ``admm_rhs`` over the lanes
    either way.

    The block is one problem: one scalar f, and the Boyd test's norms over
    the whole block, which stops as one. The loop syncs with the host only
    at a Boyd check."""
    abstol, reltol, check_every, use_tol = _admm_tolerances(config)
    nt, nk, vol = x.shape[0], x.shape[1], tuple(x.shape[2:])
    shape, nb, dtype, dev = tuple(x.shape), nt * nk, x.dtype, x.device
    mu, eps, scales = float(config.mu), float(config.epsilon), config.scales
    eps_t, mu_t = float(config.epsilon if epsilon_t is None else epsilon_t), float(mu_t)
    temporal, data_split, al = mu_t > 0, data_prox is not None, float(over_relax)
    r1 = float(rho1) if rho1 is not None else max(mu / max(eps, 1e-30), 1e-6)
    r1t = float(rho1t) if rho1t is not None else max(mu_t / max(eps_t, 1e-30), 1e-6)
    r2 = float(rho2) if rho2 is not None else r1
    if not data_split:
        r0 = 1.0

    def fft4(t):
        return torch.fft.rfftn(t, dim=_TZYX)

    def ifft4(t_hat):
        return torch.fft.irfftn(t_hat, s=(nt, *vol), dim=_TZYX)

    kc_hat = k_hat[None]  # (1, K, spectrum): broadcast over the t frequencies
    fdtype = k_hat.real.dtype
    den = r0 * conv._abs2(kc_hat) + r1 * _grad_sq_spectrum(vol, scales, fdtype, dev) + r2
    if temporal:
        st2 = 4.0 * torch.sin(math.pi * torch.fft.fftfreq(nt, dtype=fdtype, device=dev)) ** 2
        den = den + r1t * st2.reshape(-1, 1, 1, 1, 1)
    tiny = torch.finfo(dtype).tiny
    tmask = torch.ones((nt, 1, 1, 1, 1), dtype=dtype, device=dev)
    tmask[-1] = 0.0

    n = int(config.max_iter)
    hist = torch.full((n + 1,), float("nan"), dtype=dtype, device=dev)
    hist[0] = objective(x)

    def lanes(t):
        """A (T, K) + vol block as the kernels' (T * K) lanes: a view."""
        return t.view(nb, *vol)

    # z1 and u1 are the kernels' stacks (T * K, 3) + vol; every other state (T, K) + vol.
    st = {"x": x, "z1": _circ_diffs(lanes(x), scales), "z2": x.clone(), "u2": torch.zeros_like(x)}
    st["u1"] = torch.zeros_like(st["z1"])
    rho1_l, rho2_l, lam = (torch.full((nb,), r, dtype=dtype, device=dev) for r in (r1, r2, mu / r1))
    if temporal:
        st["zt"] = torch.roll(x, -1, 0) - x
        st["ut"] = torch.zeros_like(x)
    if data_split:
        st["z0"] = conv._irfftn(k_hat * conv._rfftn(x), vol)
        st["u0"] = torch.zeros_like(x)
    else:
        htd_hat = torch.conj(kc_hat) * fft4(data)

    def t_adjoint(g):
        return torch.roll(g, 1, 0) - g

    def step():
        """One iteration; returns ``(hx, dt)`` for the Boyd test (None where
        that split is absent)."""
        rhs = admm_rhs(st["z1"], st["u1"], lanes(st["z2"]), lanes(st["u2"]), rho1_l, rho2_l, scales).view(shape)
        if temporal:
            rhs = rhs + r1t * t_adjoint(st["zt"] - st["ut"])
        if data_split:
            x_hat = (r0 * torch.conj(kc_hat) * fft4(st["z0"] - st["u0"]) + fft4(rhs)) / den
        else:
            x_hat = (fft4(rhs) + htd_hat) / den
        st["x"] = ifft4(x_hat).contiguous()
        hx = dt = None
        if data_split:
            hx = ifft4(kc_hat * x_hat)
            hxr = hx if al == 1.0 else al * hx + (1.0 - al) * st["z0"]
            z0 = data_prox(hxr + st["u0"])
            st["u0"] = st["u0"] + hxr - z0
            st["z0"] = z0
        xl, z2l, u2l = lanes(st["x"]), lanes(st["z2"]), lanes(st["u2"])
        if coupling == "joint":
            dxr, v, vmag = split_magnitude(xl, st["z1"], st["u1"], al, scales, group=nk)
            scale = (hyperbolic_prox(vmag, mu / r1, eps) / vmag).repeat_interleave(nk, 0)
            split_apply(xl, st["z1"], st["u1"], z2l, u2l, dxr, v, scale, al, config.positivity)
        else:
            admm_split_update(xl, st["z1"], st["u1"], z2l, u2l, lam, eps, al, config.positivity, scales)
        if temporal:
            dt = torch.roll(st["x"], -1, 0) - st["x"]
            dtr = dt if al == 1.0 else al * dt + (1.0 - al) * st["zt"]
            vt = dtr + st["ut"]
            s_t = hyperbolic_prox(torch.sqrt(tmask * vt * vt + tiny), mu_t / r1t, eps_t)
            zt = torch.where(tmask > 0, s_t * torch.sign(vt), vt)
            st["ut"] = st["ut"] + dtr - zt
            st["zt"] = zt
        return hx, dt

    def converged(old, hx, dt) -> bool:
        """The Boyd test over the whole block (``admm.py:1431-1470``)."""
        r_terms = [_circ_diffs(lanes(st["x"]), scales) - st["z1"], st["x"] - st["z2"]]
        z_terms = [st["z1"], st["z2"]]
        if temporal:
            r_terms.append(dt - st["zt"])
            z_terms.append(st["zt"])
        if data_split:
            r_terms.append(hx - st["z0"])
            z_terms.append(st["z0"])

        def conv_t(v):
            return conv._irfftn(torch.conj(k_hat) * conv._rfftn(v), vol)

        def dual_fn():
            s_vec = r1 * _circ_diffs_adjoint(st["z1"] - old["z1"], scales).view(shape) + r2 * (st["z2"] - old["z2"])
            aty = r1 * _circ_diffs_adjoint(st["u1"], scales).view(shape) + r2 * st["u2"]
            if temporal:
                s_vec = s_vec + r1t * t_adjoint(st["zt"] - old["zt"])
                aty = aty + r1t * t_adjoint(st["ut"])
            if data_split:
                s_vec = s_vec + r0 * conv_t(st["z0"] - old["z0"])
                aty = aty + r0 * conv_t(st["u0"])
            return s_vec.reshape(1, -1), aty.reshape(1, -1)

        n_el = float(x.numel())
        p_el = n_el * (4.0 + data_split + temporal)
        flat = [t.reshape(1, -1) for t in r_terms], [t.reshape(1, -1) for t in z_terms]
        return bool(_boyd_criterion(*flat, dual_fn, p_el, n_el, abstol, reltol)[0])

    iterations, status = n, 1 if use_tol else 0
    for i in range(1, n + 1):
        check = use_tol and i % check_every == 0
        old = None
        if check:  # z1 and z2 change in place; z0 and zt are replaced
            old = {"z1": st["z1"].clone(), "z2": st["z2"].clone(), "z0": st.get("z0"), "zt": st.get("zt")}
        hx, dt = step()
        if track_objective:
            hist[i] = objective(st["z2"])
        if check and converged(old, hx, dt):
            iterations, status = i, 0
            break
    out = st["z2"] if config.positivity else st["x"]
    f_history = hist.cpu().numpy()
    return DeconvolutionResult(out, objective(out).cpu().numpy()[()], iterations, iterations, status, f_history,
                               np.full_like(f_history, np.nan))


def admm_deconvolve_timeseries(
    data: torch.Tensor,
    psf: torch.Tensor,
    weights: torch.Tensor | None = None,
    x0: torch.Tensor | None = None,
    config: DeconvolutionConfig = DeconvolutionConfig(),
    *,
    mu_t: float = 0.0,
    epsilon_t: float | None = None,
    bleach=None,
    rho0: float | None = None,
    rho1: float | None = None,
    rho1t: float | None = None,
    rho2: float | None = None,
    over_relax: float = 1.8,
    track_objective: bool = True,
) -> DeconvolutionResult:
    """ADMM engine of the joint 4D time-series solve (``admm.py:564-863``),
    the objective of ``jobs.timeseries.deconvolve_timeseries``: the one-channel
    case of :func:`_admm_joint`. The T frames' spatial split update and
    right-hand side are the two ADMM kernels over T lanes; the temporal split
    (``rho1t``, default ``mu_t / epsilon_t``) is PyTorch operators. ``bleach``
    gains live in the data prox, ``z = (w g d + rho0 v) / (w g^2 + rho0)``;
    Poisson with bleach is not wired (use VMLMB). ``x`` is (T,)+vol."""
    if config.data_term == "poisson" and bleach is not None:
        raise ValueError("admm timeseries: poisson+bleach is not wired; use deconvolve_timeseries (VMLMB)")
    data5, weights5, bleach5 = as_channel_block(data, weights, bleach)
    res = _admm_joint(data5, psf, weights5, None if x0 is None else x0[:, None], config, mu_t=mu_t,
                      epsilon_t=epsilon_t, bleach=bleach5, coupling="separate", mixing=None, rho0=rho0, rho1=rho1,
                      rho1t=rho1t, rho2=rho2, over_relax=over_relax, track_objective=track_objective)
    return res._replace(x=res.x[:, 0])


def admm_deconvolve_multichannel(
    data: torch.Tensor,
    psfs: torch.Tensor,
    weights: torch.Tensor | None = None,
    x0: torch.Tensor | None = None,
    config: DeconvolutionConfig = DeconvolutionConfig(),
    *,
    coupling: str = "joint",
    mixing=None,
    rho0: float | None = None,
    rho1: float | None = None,
    rho2: float | None = None,
    over_relax: float = 1.8,
    track_objective: bool = True,
) -> DeconvolutionResult:
    """ADMM engine of the joint multichannel solve (``admm.py:866-1186``), the
    objective of ``jobs.multichannel.deconvolve_multichannel``: the T = 1 case
    of :func:`_admm_joint`. The x-update is per-channel circulant solves
    batched over C; the color-TV prox takes one magnitude across channels and
    axes a voxel (``"separate"``: the split-update kernel over the C lanes).
    ``mixing`` (C, K), uniform Gaussian only, makes the data prox the
    constant K x K system ``(M^T M + rho0 I) z = M^T d + rho0 v``. ``x`` is
    (C or K,)+vol."""
    if data.ndim != 4:
        raise ValueError(f"expected a (C, Nz, Ny, Nx) stack, got {tuple(data.shape)}")
    if config.data_term == "poisson" and weights is not None:
        raise ValueError("data_term='poisson' does not compose with weights")
    if mixing is not None and (config.data_term == "poisson" or weights is not None):
        raise ValueError("admm multichannel: mixing composes with the uniform Gaussian data term only "
                         "(weighted/poisson unmixing: use deconvolve_multichannel)")
    if weights is not None and weights.ndim == 4:
        weights = weights[None]
    res = _admm_joint(data[None], psfs, weights, None if x0 is None else x0[None], config, mu_t=0.0, epsilon_t=None,
                      bleach=None, coupling=coupling, mixing=mixing, rho0=rho0, rho1=rho1, rho1t=None, rho2=rho2,
                      over_relax=over_relax, track_objective=track_objective)
    return res._replace(x=res.x[0])


def admm_deconvolve_timeseries_multichannel(
    data: torch.Tensor,
    psfs: torch.Tensor,
    weights: torch.Tensor | None = None,
    x0: torch.Tensor | None = None,
    config: DeconvolutionConfig = DeconvolutionConfig(),
    *,
    mu_t: float = 0.0,
    epsilon_t: float | None = None,
    bleach=None,
    coupling: str = "joint",
    mixing=None,
    rho0: float | None = None,
    rho1: float | None = None,
    rho1t: float | None = None,
    rho2: float | None = None,
    over_relax: float = 1.8,
    track_objective: bool = True,
) -> DeconvolutionResult:
    """ADMM engine of the full (T, C) 5D acquisition (``admm.py:1189-1500``),
    the objective of ``jobs.multichannel.deconvolve_timeseries_multichannel``:
    :func:`_admm_joint`. Not wired (use VMLMB): weighted or Poisson data
    through ``mixing``, Poisson with bleach."""
    poisson = config.data_term == "poisson"
    if mixing is not None and (poisson or weights is not None):
        raise ValueError("admm 5D: mixing composes with the uniform Gaussian data term only (weighted/poisson "
                         "unmixing: use deconvolve_timeseries_multichannel)")
    if poisson and bleach is not None:
        raise ValueError("admm 5D: poisson+bleach is not wired; use deconvolve_timeseries_multichannel (VMLMB)")
    return _admm_joint(data, psfs, weights, x0, config, mu_t=mu_t, epsilon_t=epsilon_t, bleach=bleach,
                       coupling=coupling, mixing=mixing, rho0=rho0, rho1=rho1, rho1t=rho1t, rho2=rho2,
                       over_relax=over_relax, track_objective=track_objective)
