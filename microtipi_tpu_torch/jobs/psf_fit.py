"""PSF-parameter sub-problem: fit parameter families to data given the object.

Port of the slice's part of ``microtipi_tpu/jobs/psf_fit.py`` (reference:
``microscopy/PSF_Estimation.java``). Convolution commutes, so the *object*
is the convolution kernel and the synthesized PSF is the variable of the data
term (``PSF_Estimation.java:147-157``); autograd through ``compute_psf`` is
the reference's Jacobian application (``:202-217``), and VMLMB's best-x
tracking its best-parameters restore (``:208-216,254``). Defaults mirror the
reference: ``grtol = 1e-3`` (``:55``), ``gatol = 0`` (``:54``), ``maxeval =
2*maxiter`` (``:272``), memory 5 and More-Thuente (``:186-188``), no bounds.

Every family of ``models/`` fits, the extension families (DEPTH, SHEET,
STED, CAVITY) included; ``precondition`` scales the coefficients of a family
whose components live on different physical scales (the Gibson-Lanni DEPTH
family's ``ns/lambda`` ~ 1e6 1/m and ``d`` ~ 1e-6 m).

Not ported yet: bead fits, field calibration, the calibration prior,
auxiliary terms and the windowed fit (ROADMAP.md queue 1, item 15).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from microtipi_tpu_torch.models.microscope import family_name
from microtipi_tpu_torch.ops.convolution import (
    QuadraticConvCost,
    UniformConvCost,
    WeightedConvolutionCost,
)
from microtipi_tpu_torch.optim.treeutil import value_and_grad
from microtipi_tpu_torch.optim.vmlmb import minimize_vmlmb
from microtipi_tpu_torch.utils.arrays import pad_to_shape

__all__ = ["PsfFitConfig", "PsfFitResult", "fit_psf", "fit_psf_joint", "joint_variable"]


@dataclasses.dataclass(frozen=True)
class PsfFitConfig:
    max_iter: int = 20  # PSF_Estimation.java:59
    max_eval: int | None = None  # defaults to 2*max_iter (:272)
    gatol: float = 0.0  # :54
    grtol: float = 1e-3  # :55
    mem: int = 5  # :188
    fit_window: tuple[int, int, int] | None = None

    def __post_init__(self):
        if self.fit_window is not None:
            raise NotImplementedError(
                "the windowed PSF fit (fit_window) is not ported yet "
                "(ROADMAP.md queue 1, item 15: the rest of jobs/psf_fit.py)")


class PsfFitResult(NamedTuple):
    params: object  # full params with the fitted families replaced
    f: np.floating
    iterations: int
    evaluations: int
    status: int
    f_history: np.ndarray


def _fit_data_term(obj, data, weights):
    """Object-as-kernel data term (``psf_fit.py:101-123``): float64 takes the
    2-FFT quadratic form; float32 the 3-FFT residual form, because the
    quadratic identity cancels near convergence (resolution eps*c) and stalls
    float32 fits."""
    if weights is None:
        if data.dtype == torch.float64:
            return QuadraticConvCost.build(obj, data)
        return UniformConvCost.build(obj, data)
    return WeightedConvolutionCost.build(obj, data, weights)


def _with_slice(full: torch.Tensor, start: int, v: torch.Tensor) -> torch.Tensor:
    """``full`` with ``full[start:start+len(v)] = v``, differentiable in ``v``."""
    return torch.cat([full[:start], v, full[start + v.shape[0]:]])


def fit_psf(
    model,
    params,
    flag: int,
    data: torch.Tensor,
    obj: torch.Tensor,
    weights: torch.Tensor | None = None,
    config: PsfFitConfig = PsfFitConfig(),
    active: int | None = None,
    freeze_head: int = 0,
    precondition: bool = False,
) -> PsfFitResult:
    """Fit the family selected by ``flag`` (``psf_fit.py:502-615``):
    ``active`` fits only its first coefficients, ``freeze_head`` freezes the
    first k of those. ``precondition`` rescales each coefficient by its
    initial gradient's magnitude (one extra gradient evaluation): without it
    the first step of a DEPTH or SHEET fit is orders of magnitude too long
    (metres of depth) and the search stalls."""
    family = family_name(flag)
    full0 = getattr(params, family).detach()
    if full0.shape[0] == 0:
        raise ValueError(f"family {family!r} has no coefficients to fit")
    if active is None or active >= full0.shape[0]:
        active = full0.shape[0]
    if not 0 <= freeze_head < active:
        raise ValueError(f"freeze_head={freeze_head} must be in [0, active={active})")
    x0 = full0[freeze_head:active]
    if weights is not None and weights.shape != data.shape:
        weights = pad_to_shape(weights, tuple(data.shape))
    cost = _fit_data_term(obj, data, weights)

    def objective(v):
        return cost.cost(model.compute_psf(params._replace(**{family: _with_slice(full0, freeze_head, v)})))

    scale = 1.0
    if precondition:
        _, g0 = value_and_grad(objective)(x0)
        tiny = torch.finfo(g0.dtype).tiny
        scale = 1.0 / torch.maximum(g0.abs(), torch.clamp_min(1e-12 * g0.abs().max(), tiny))
    res = minimize_vmlmb(
        value_and_grad(lambda u: objective(u * scale)), x0 / scale,
        mem=config.mem, maxiter=config.max_iter, maxeval=config.max_eval,
        gatol=config.gatol, grtol=config.grtol,
    )
    return PsfFitResult(
        params._replace(**{family: _with_slice(full0, freeze_head, res.x * scale)}),
        res.f, res.iterations, res.evaluations, res.status, res.f_history,
    )


def joint_variable(params, names: tuple[str, ...], phase_freeze_head: int = 0, *, grads: dict):
    """(x0, rebuild) for a multi-family fit with gradient-balanced scaling
    (``psf_fit.py:736-796``): each family's scaled initial gradient gets unit
    inf-norm, so no family dominates the shared L-BFGS metric (defocus lives
    in 1/m, with gradients orders of magnitude above the Zernike ones). The
    first ``phase_freeze_head`` phase coefficients are frozen."""
    gmax = {n: torch.max(torch.abs(grads[n])) for n in names}
    global_max = gmax[names[0]]
    for n in names[1:]:
        global_max = torch.maximum(global_max, gmax[n])
    tiny = torch.finfo(global_max.dtype).tiny
    floor = torch.clamp_min(1e-12 * global_max, tiny)
    scales = {n: 1.0 / torch.maximum(gmax[n], floor) for n in names}
    k = phase_freeze_head

    def var_of(n):
        full = getattr(params, n).detach() / scales[n]
        return full[k:] if (n == "phase" and k > 0) else full

    def rebuild(v):
        out = {}
        for n in names:
            if n == "phase" and k > 0:
                out[n] = _with_slice(getattr(params, n).detach(), k, v[n] * scales[n])
            else:
                out[n] = v[n] * scales[n]
        return params._replace(**out)

    return {n: var_of(n) for n in names}, rebuild


def fit_psf_joint(
    model,
    params,
    flags: tuple[int, ...],
    data: torch.Tensor,
    obj: torch.Tensor,
    weights: torch.Tensor | None = None,
    config: PsfFitConfig = PsfFitConfig(),
    phase_freeze_head: int = 0,
) -> PsfFitResult:
    """Fit several families simultaneously in one VMLMB run
    (``psf_fit.py:799-868``); the variable is a dict of the selected
    families, scaled by :func:`joint_variable`."""
    names = tuple(family_name(f) for f in flags)
    for n in names:
        if getattr(params, n).shape[0] == 0:
            raise ValueError(f"family {n!r} has no coefficients to fit")
    if weights is not None and weights.shape != data.shape:
        weights = pad_to_shape(weights, tuple(data.shape))
    cost = _fit_data_term(obj, data, weights)

    # One extra evaluation seeds the gradient-balanced scaling.
    _, g0 = value_and_grad(lambda sub: cost.cost(model.compute_psf(params._replace(**sub))))(
        {n: getattr(params, n) for n in names}
    )
    x0, rebuild = joint_variable(params, names, phase_freeze_head, grads=g0)

    res = minimize_vmlmb(
        value_and_grad(lambda v: cost.cost(model.compute_psf(rebuild(v)))), x0,
        mem=config.mem, maxiter=config.max_iter, maxeval=config.max_eval,
        gatol=config.gatol, grtol=config.grtol,
    )
    params_fit = rebuild(res.x)
    return PsfFitResult(
        params_fit._replace(**{n: getattr(params_fit, n).detach() for n in names}),
        res.f, res.iterations, res.evaluations, res.status, res.f_history,
    )
