"""Object-update solver: edge-preserving regularised deconvolution.

Port of ``microtipi_tpu/jobs/deconv.py`` (the TiPi ``DeconvolutionJob``
capability the reference drives at ``microUtils/BlindDeconvJob.java:103-108``):
minimize over the object x

    f(x) = 0.5 * sum w * ((psf (*) x) - d)^2  +  mu * TV_eps(x)
           + sparsity * L1_eps(x) + hessian * Hess_eps(x),       x >= 0

with VMLMB. The TV term goes through the fused wrapper
(``ops/kernels/hyperbolic_tv.py``): the CUDA kernel for a CUDA tensor (float32,
3D; anything else raises), its plain version for a CPU tensor. The
sparse-deconvolution priors (``sparsity``, ``hessian``) are plain PyTorch
(``ops/regularization.py``) on every device.

``data_term="poisson"`` swaps the Gaussian term for the generalized
Kullback-Leibler deviance of ``d ~ Poisson(psf (*) x + background)``.
``var_shape`` puts the object on a padded grid (>= the data's shape): the
model is cropped to the centred data window, which suppresses the periodic
wraparound of the FFT convolution.

A batch of volumes (B, Nz, Ny, Nx) has its own objective,
:func:`make_batched_objective`: per-lane costs from one batched FFT pair and
one batched TV launch, the priors and the padded grid per lane, for the
lockstep solver of ``jobs/batch.py``. The ADMM and FISTA engines
(``jobs/admm.py``) read the same objective, values only, through
:func:`objective_value`. :func:`regularization_cost` is the whole prior in
plain PyTorch, for the Laplace uncertainty (``jobs/uncertainty.py``), which
differentiates twice.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from microtipi_tpu_torch.jobs.wiener import wiener
from microtipi_tpu_torch.ops.convolution import (
    PoissonConvCost,
    QuadraticConvCost,
    UniformConvCost,
    WeightedConvolutionCost,
    select_lanes,
)
from microtipi_tpu_torch.ops.kernels.hyperbolic_tv import hyperbolic_tv_batched_value, hyperbolic_tv_value
from microtipi_tpu_torch.ops.regularization import hessian_terms, hyperbolic_tv, smoothed_l1_terms
from microtipi_tpu_torch.optim.treeutil import value_and_grad
from microtipi_tpu_torch.optim.vmlmb import (
    VMLMBResult,
    VMLMBStatus,
    minimize_vmlmb,
    minimize_vmlmb_batched,
)
from microtipi_tpu_torch.utils.arrays import pad_fft_kernel, pad_to_shape

__all__ = [
    "DeconvolutionConfig",
    "DeconvolutionResult",
    "deconvolve",
    "has_regularizer",
    "lane_objective",
    "make_batched_objective",
    "make_objective",
    "make_regularizer",
    "objective_value",
    "regularization_cost",
    "stall_gate",
    "var_shape_of",
]


@dataclasses.dataclass(frozen=True)
class DeconvolutionConfig:
    """Knobs of the object step, the slice's fields of the JAX config
    (``jobs/deconv.py:45-134``): VMLMB memory 5 (``PSF_Estimation.java:188``),
    ``maxeval = 2*maxiter`` (``:272``), ``mu``/``epsilon`` weigh the
    hyperbolic TV, ``scales`` are per-axis voxel sizes. ``sparsity`` weighs a
    smoothed L1 on intensity and ``hessian`` a hyperbolic penalty on the
    second-difference Hessian (0 = off); both smooth at ``epsilon``, the L1 at
    ``sparsity_epsilon`` when it is given. ``var_shape`` is the padded object
    grid (>= the data's shape). The JAX ``fused_tv`` switch is gone: the TV
    wrapper chooses by the tensor's device."""

    mu: float = 0.01
    epsilon: float = 0.01
    scales: tuple[float, ...] | None = None
    sparsity: float = 0.0
    hessian: float = 0.0
    sparsity_epsilon: float | None = None
    positivity: bool = True
    data_term: str = "gaussian"
    background: float = 0.0
    max_iter: int = 50
    max_eval: int | None = None
    gatol: float = 0.0
    grtol: float = 1e-3
    mem: int = 5
    var_shape: tuple[int, ...] | None = None
    admm_abstol: float = 0.0
    admm_reltol: float = 0.0
    admm_check_every: int = 20


class DeconvolutionResult(NamedTuple):
    """One solve's result; from a batched solve, every field has a leading
    batch axis (``f``, ``iterations``, ``evaluations``, ``status`` are then
    NumPy arrays of B)."""

    x: torch.Tensor
    f: np.floating
    iterations: int
    evaluations: int
    status: int
    f_history: np.ndarray
    pg_history: np.ndarray


def _stacked(results) -> DeconvolutionResult:
    """Per-lane VMLMB results as one ``DeconvolutionResult`` with a leading
    batch axis on every field."""
    return DeconvolutionResult(
        torch.stack([r.x for r in results]),
        np.array([r.f for r in results]),
        np.array([r.iterations for r in results]),
        np.array([r.evaluations for r in results]),
        np.array([r.status for r in results]),
        np.stack([r.f_history for r in results]),
        np.stack([r.pg_history for r in results]),
    )


def has_regularizer(config: DeconvolutionConfig) -> bool:
    """True when any regularization weight is active (``deconv.py:195-197``)."""
    return config.mu > 0 or config.sparsity > 0 or config.hessian > 0


def _extra_priors(x, config: DeconvolutionConfig, axes=None, lanes: bool = False):
    """sparsity * L1 + hessian * Hess (``deconv.py:200-213``), summed over
    the whole of ``x``, or per lane (B,) of a batch with ``lanes``."""
    def total(terms):
        return terms.sum(dim=(-3, -2, -1)) if lanes else terms.sum()

    out = x.new_zeros(x.shape[:1] if lanes else ())
    if config.sparsity > 0:
        eps_s = config.epsilon if config.sparsity_epsilon is None else config.sparsity_epsilon
        out = out + config.sparsity * total(smoothed_l1_terms(x, eps_s))
    if config.hessian > 0:
        out = out + config.hessian * total(hessian_terms(x, config.epsilon, config.scales, axes))
    return out


def regularization_cost(x, config: DeconvolutionConfig, axes=None):
    """mu*TV + sparsity*L1 + hessian*Hess in plain PyTorch, no kernel
    (``deconv.py:216-226``): twice differentiable, as the Laplace uncertainty
    needs. ``axes`` restricts the differences (``(-3, -2, -1)`` for a batch);
    the sum runs over the whole of ``x``."""
    total = x.new_zeros(())
    if config.mu > 0:
        total = total + config.mu * hyperbolic_tv(x, config.epsilon, config.scales, axes=axes)
    return total + _extra_priors(x, config, axes=axes)


def make_regularizer(config: DeconvolutionConfig):
    """``x -> mu * TV_eps(x) + the priors`` (``jobs/deconv.py:170-192``): the
    TV through the fused TV wrapper, per lane (B,) for a 4D batch, whose
    priors difference along its last three axes only."""

    def reg(x):
        lanes = x.ndim == 4
        total = x.new_zeros(x.shape[:1] if lanes else ())
        if config.mu > 0:
            tv = hyperbolic_tv_batched_value if lanes else hyperbolic_tv_value
            total = total + config.mu * tv(x, config.epsilon, config.scales)
        return total + _extra_priors(x, config, axes=(-3, -2, -1) if lanes else None, lanes=lanes)

    return reg


def var_shape_of(config: DeconvolutionConfig, data) -> tuple[int, ...]:
    """The object grid: ``config.var_shape``, else one volume's shape."""
    return tuple(config.var_shape) if config.var_shape is not None else tuple(data.shape[-3:])


def _data_cost(psf, data, weights, config: DeconvolutionConfig, accurate: bool):
    """The data term (``jobs/deconv.py:253-288``): the Poisson deviance, or
    the Gaussian term, where uniform weights on the unpadded grid take the
    2-FFT quadratic form (``accurate=True``: the 3-FFT residual form) and
    anything else the weighted cost on ``var_shape``, cropped to the data
    window. A batch (B, Nz, Ny, Nx) takes a shared 3D PSF or one per lane."""
    shape, var_shape = tuple(data.shape[-3:]), var_shape_of(config, data)
    kernel = pad_fft_kernel(psf, var_shape)
    if config.data_term == "poisson":
        if weights is not None:
            raise ValueError("data_term='poisson' models the noise itself; per-voxel "
                             "Gaussian weights do not compose with it")
        return PoissonConvCost.build(kernel, data, config.background, var_shape)
    if config.data_term != "gaussian":
        raise ValueError(f"unknown data_term {config.data_term!r}")
    if weights is None and var_shape == shape:
        return (UniformConvCost if accurate else QuadraticConvCost).build(kernel, data)
    return WeightedConvolutionCost.build(kernel, data, weights, var_shape)


def _objective(cost, config: DeconvolutionConfig):
    reg = make_regularizer(config)

    def objective(x):
        f = cost.cost(x)
        if has_regularizer(config):
            f = f + reg(x)
        return f

    return value_and_grad(objective)


def objective_value(cost, config: DeconvolutionConfig):
    """``x -> f`` of the same objective without its gradient, for the engines
    that only track values (``jobs/admm.py``): no autograd graph, and the
    residual-form cost skips its gradient's FFT. Per lane (B,) for a batch."""
    reg = make_regularizer(config)

    def value(x):
        with torch.no_grad():
            f = cost.value(x)
            if has_regularizer(config):
                f = f + reg(x)
        return f

    return value


def make_objective(psf, data, weights, config: DeconvolutionConfig, accurate: bool = False):
    """The ``x -> (f, grad f)`` closure of the object step
    (``jobs/deconv.py:229-298``); the kernel spectrum is computed once per
    call."""
    return _objective(_data_cost(psf, data, weights, config, accurate), config)


def make_batched_objective(psf, data, weights, config: DeconvolutionConfig, accurate: bool = False):
    """The object step of a batch ``data`` (B, Nz, Ny, Nx) as the lockstep
    solver calls it: ``(x, lanes) -> (f (n,), g (n, *var_shape))`` for the
    lanes ``lanes`` stacked in ``x``. ``psf`` is shared (3D) or per lane
    (4D), ``weights`` None or per lane. One call is one batched FFT pair (or
    three FFTs) and one batched TV launch; each lane's gradient is the
    gradient of its own cost, priors included. The kernel spectra are
    computed once, for every lane; a call on fewer lanes indexes them
    (``select_lanes``)."""
    if data.ndim != 4:
        raise ValueError(f"a batch of volumes is 4D, got shape {tuple(data.shape)}")
    return lane_objective(_data_cost(psf, data, weights, config, accurate), data.shape[0],
                          lambda cost, lanes: _objective(cost, config))


def lane_objective(full, nb: int, build):
    """``(x, lanes) -> build(cost, lanes)(x)`` with ``cost`` the per-lane
    data term ``full`` of ``nb`` lanes restricted to ``lanes``; the closure
    is rebuilt only when the live lanes change (when one finishes)."""
    every = tuple(range(nb))
    cache: dict = {}

    def fun(x, lanes):
        lanes = tuple(lanes)
        if lanes not in cache:
            cache.clear()
            cost = full if lanes == every else select_lanes(full, torch.as_tensor(lanes, device=x.device))
            cache[lanes] = build(cost, lanes)
        return cache[lanes](x)

    return fun


def _stalled(res: VMLMBResult, maxiter: int, maxeval: int) -> bool:
    return (
        res.status == VMLMBStatus.LINESEARCH_FAIL
        and res.iterations < maxiter
        and res.evaluations < maxeval
    )


def _budget(config: DeconvolutionConfig) -> tuple[int, int]:
    maxiter = int(config.max_iter)
    return maxiter, int(config.max_eval) if config.max_eval is not None else 2 * maxiter


def _splice(res: VMLMBResult, res_b: VMLMBResult, maxiter: int) -> VMLMBResult:
    """``res`` continued by ``res_b``: the histories spliced after the
    stall, clipped at ``maxiter``."""
    hist_f, hist_pg = res.f_history.copy(), res.pg_history.copy()
    n = maxiter - res.iterations  # slots left after the stall
    hist_f[res.iterations + 1:] = res_b.f_history[1:1 + n]
    hist_pg[res.iterations + 1:] = res_b.pg_history[1:1 + n]
    return VMLMBResult(
        x=res_b.x, f=res_b.f, g=res_b.g,
        iterations=res.iterations + res_b.iterations,
        evaluations=res.evaluations + res_b.evaluations,
        status=res_b.status, f_history=hist_f, pg_history=hist_pg,
    )


def _vmlmb_options(config: DeconvolutionConfig) -> dict:
    return dict(lower=0.0 if config.positivity else None, mem=config.mem, maxiter=config.max_iter,
                gatol=config.gatol, grtol=config.grtol)


def stall_gate(config: DeconvolutionConfig, data, weights) -> bool:
    """Exactly the gate under which the objective took the quadratic form
    AND its eps*c value floor can stall a float32 search
    (``deconv.py:415-419``)."""
    return (config.data_term == "gaussian" and weights is None and data.dtype == torch.float32
            and var_shape_of(config, data) == tuple(data.shape[-3:]))


def _f32_stall_continue(res: VMLMBResult, psf, data, config: DeconvolutionConfig) -> VMLMBResult:
    """Continue a LINESEARCH_FAIL-terminated float32 quadratic-path solve on
    the cancellation-free residual objective (``jobs/deconv.py:301-370``).

    The quadratic identity ``0.5<x,Ax> - <x,b> + c`` resolves cost
    differences only to ``eps*c``, which stalls float32 line searches near
    the optimum; the remaining iteration and evaluation budget restarts on
    ``UniformConvCost``, whose resolution is ``eps*f``. The histories are
    spliced after the stall, clipped at ``max_iter``.
    """
    maxiter, maxeval = _budget(config)
    if not _stalled(res, maxiter, maxeval):
        return res
    res_b = minimize_vmlmb(
        make_objective(psf, data, None, config, accurate=True), res.x, **_vmlmb_options(config),
        maxiter_cap=maxiter - res.iterations, maxeval=maxeval - res.evaluations,
    )
    return _splice(res, res_b, maxiter)


def _f32_stall_continue_batched(results: list, psf, data, config: DeconvolutionConfig) -> list:
    """:func:`_f32_stall_continue` for the lanes of a batched solve: the
    JAX package's per-lane ``lax.cond`` becomes a second lockstep solve over
    the lanes that stalled, each with its own iteration and evaluation budget
    left."""
    maxiter, maxeval = _budget(config)
    stalled = [b for b, r in enumerate(results) if _stalled(r, maxiter, maxeval)]
    if not stalled:
        return results
    idx = torch.as_tensor(stalled, device=data.device)
    fun = make_batched_objective(psf[idx] if psf.ndim == 4 else psf, data[idx], None, config, accurate=True)
    cont = minimize_vmlmb_batched(
        fun, torch.stack([results[b].x for b in stalled]), **_vmlmb_options(config),
        maxiter_cap=[maxiter - results[b].iterations for b in stalled],
        maxeval=[maxeval - results[b].evaluations for b in stalled],
    )
    results = list(results)
    for b, res_b in zip(stalled, cont):
        results[b] = _splice(results[b], res_b, maxiter)
    return results


def deconvolve(
    data: torch.Tensor,
    psf: torch.Tensor,
    weights: torch.Tensor | None = None,
    x0: torch.Tensor | None = None,
    config: DeconvolutionConfig = DeconvolutionConfig(),
    init: str = "data",
) -> DeconvolutionResult:
    """Solve the object sub-problem (``jobs/deconv.py:373-426``).

    ``init`` picks the warm start when ``x0`` is None: ``"data"`` or
    ``"wiener"``, centred on the ``var_shape`` grid. Float32 uniform-Gaussian
    solves on the unpadded grid that stall on the quadratic form's value
    resolution continue on the residual form (:func:`_f32_stall_continue`).
    """
    if x0 is None:
        if init == "wiener":
            x0 = wiener(data, psf)
        elif init == "data":
            x0 = data
        else:
            raise ValueError(f"unknown init {init!r}")
        x0 = pad_to_shape(x0, var_shape_of(config, data))
        if config.positivity:
            x0 = torch.clamp_min(x0, 0.0)
    fun = make_objective(psf, data, weights, config)
    res = minimize_vmlmb(fun, x0, **_vmlmb_options(config), maxeval=config.max_eval)
    if stall_gate(config, data, weights):
        res = _f32_stall_continue(res, psf, data, config)
    return DeconvolutionResult(
        res.x, res.f, res.iterations, res.evaluations, res.status, res.f_history, res.pg_history
    )
