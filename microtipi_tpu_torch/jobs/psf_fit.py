"""PSF-parameter sub-problem: fit parameter families to data given the object,
and calibrate them from bead stacks.

Port of ``microtipi_tpu/jobs/psf_fit.py`` (reference:
``microscopy/PSF_Estimation.java``). Convolution commutes, so the *object*
is the convolution kernel and the synthesized PSF is the variable of the data
term (``PSF_Estimation.java:147-157``); autograd through ``compute_psf`` is
the reference's Jacobian application (``:202-217``), and VMLMB's best-x
tracking its best-parameters restore (``:208-216,254``). Defaults mirror the
reference: ``grtol = 1e-3`` (``:55``), ``gatol = 0`` (``:54``), ``maxeval =
2*maxiter`` (``:272``), memory 5 and More-Thuente (``:186-188``), no bounds.

Every family of ``models/`` fits, the extension families (DEPTH, SHEET,
STED, CAVITY) included; DEPTH and SHEET mix physical scales (the
Gibson-Lanni ``ns/lambda`` ~ 1e6 1/m next to ``d`` ~ 1e-6 m), so their
coefficients are scaled one by one by their initial gradients.

Calibration: a bead slide is detected (:func:`detect_beads`), averaged
(:func:`average_beads`) or fitted bead by bead (:func:`calibrate_field`);
:func:`fit_psf_beads` fits a bead stack through the profiled
amplitude-and-background objective of :func:`bead_anchor_term`, which also
anchors the blind loop; :func:`fit_uncertainty` and
:func:`bead_fit_uncertainty` give Gauss-Newton error bars, their Jacobians
by forward-mode autodiff (``torch.func.jacfwd``) through the synthesis. The
JAX package runs detection and averaging as host NumPy (eager dispatch cost
minutes on its TPU runtime, which has no float64); here they run on the
tensor's device in float64, and only the greedy loop's peak values come to
the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from microtipi_tpu_torch.models.microscope import family_name
from microtipi_tpu_torch.ops.convolution import (
    QuadraticConvCost,
    UniformConvCost,
    WeightedConvolutionCost,
    convolve,
    convolve_spectrum,
)
from microtipi_tpu_torch.optim.treeutil import value_and_grad
from microtipi_tpu_torch.optim.vmlmb import minimize_vmlmb
from microtipi_tpu_torch.utils.arrays import median, pad_to_shape

__all__ = [
    "FitUncertainty",
    "PsfFitConfig",
    "PsfFitResult",
    "average_beads",
    "bead_anchor_term",
    "bead_fit_uncertainty",
    "calibrate_field",
    "center_bead_stack",
    "detect_beads",
    "empirical_psf",
    "fit_families_with_cost",
    "fit_psf",
    "fit_psf_beads",
    "fit_psf_joint",
    "fit_uncertainty",
    "joint_variable",
    "model_at",
]

# Families whose components live on different physical scales: scaled
# coefficient by coefficient, not by one norm a family (psf_fit.py:752-762).
_HETEROGENEOUS = ("depth", "sheet")


@dataclasses.dataclass(frozen=True)
class PsfFitConfig:
    max_iter: int = 20  # PSF_Estimation.java:59
    max_eval: int | None = None  # defaults to 2*max_iter (:272)
    gatol: float = 0.0  # :54
    grtol: float = 1e-3  # :55
    mem: int = 5  # :188
    #: Fit on a centred crop of this shape instead of the whole volume (the
    #: blind loop's fits; lateral sides equal, as the pupil models need):
    #: cropped data, cropped object as kernel, a model at the window's shape
    #: (``psf_fit.py:65-78``). None fits the whole volume.
    fit_window: tuple[int, int, int] | None = None


class PsfFitResult(NamedTuple):
    params: object  # full params with the fitted families replaced
    f: np.floating
    iterations: int
    evaluations: int
    status: int
    f_history: np.ndarray


def model_at(model, shape):
    """``model``'s class and optics on another grid ``shape``, on its device
    (the JAX package's ``dataclasses.replace(model, shape=shape)``)."""
    shape = tuple(int(s) for s in shape)
    if tuple(model.shape) == shape:
        return model
    return type(model)(dataclasses.replace(model.config, shape=shape), model.device)


def _on_device(data) -> torch.Tensor:
    """``data`` as a tensor: a tensor stays on its device, anything else goes
    to the card."""
    if isinstance(data, torch.Tensor):
        return data
    if not torch.cuda.is_available():
        raise RuntimeError("the bead functions run on the CUDA card by default and none is available; "
                           "pass a CPU tensor to run them on the CPU")
    return torch.as_tensor(np.asarray(data), device="cuda")


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


def _unravel(flat: torch.Tensor, shape) -> list[torch.Tensor]:
    """The (0-dim) indices of the flat index ``flat`` in ``shape``, on its device."""
    out = []
    for n in reversed(shape):
        out.append(flat % n)
        flat = flat // n
    return out[::-1]


def _frac(fm, f0, fp, guard: float):
    """The parabola's vertex offset through three samples, within +-0.5."""
    den = fm - 2.0 * f0 + fp
    s = torch.where(den.abs() > guard, 0.5 * (fm - fp) / den, torch.zeros_like(den))
    return torch.clamp(s, -0.5, 0.5)


def _fourier_shift(d: torch.Tensor, t, sign: float) -> torch.Tensor:
    """``d`` shifted by ``sign * t`` voxels per axis (``t`` three scalars or a
    (3,) tensor) through a Fourier phase ramp: ``sign = -1`` moves voxel
    ``t`` to the origin."""
    kw = dict(dtype=d.dtype, device=d.device)
    nz, ny, nx = d.shape
    fz = torch.as_tensor(np.fft.fftfreq(nz), **kw)[:, None, None]
    fy = torch.as_tensor(np.fft.fftfreq(ny), **kw)[None, :, None]
    fx = torch.as_tensor(np.fft.rfftfreq(nx), **kw)[None, None, :]
    phase = fz * t[0] + fy * t[1] + fx * t[2]
    cdtype = torch.complex128 if d.dtype == torch.float64 else torch.complex64
    ramp = torch.exp((sign * 2j * math.pi) * phase.to(cdtype))
    return torch.fft.irfftn(torch.fft.rfftn(d) * ramp, s=tuple(d.shape)).to(d.dtype)


def center_bead_stack(data: torch.Tensor, subvoxel: bool = True) -> torch.Tensor:
    """Background-subtract a bead stack and move the bead to the corner
    origin (``psf_fit.py:126-172``): the median is the background, the bead
    the intensity peak, refined laterally by a parabola (``subvoxel``; the
    axial position stays integer: a fractional z shift is gauge-degenerate
    with the defocus/Z4 mode), and the stack is Fourier-shifted so that the
    bead sits at index (0, 0, 0). No host sync."""
    d = data - median(data)
    shape = tuple(d.shape)
    iz, iy, ix = _unravel(torch.argmax(d), shape)
    pz, py, px = (i.to(d.dtype) for i in (iz, iy, ix))
    if subvoxel:
        _, ny, nx = shape
        f0 = d[iz, iy, ix]
        py = py + _frac(d[iz, (iy - 1) % ny, ix], f0, d[iz, (iy + 1) % ny, ix], 1e-30)
        px = px + _frac(d[iz, iy, (ix - 1) % nx], f0, d[iz, iy, (ix + 1) % nx], 1e-30)
    return _fourier_shift(d, (pz, py, px), 1.0)


def detect_beads(data, n_beads: int = 8, patch: tuple[int, int, int] | None = None,
                 min_separation: int | None = None, rel_threshold: float = 0.3):
    """Detect up to ``n_beads`` beads and cut patches around them
    (``psf_fit.py:175-236``): median background subtraction in float64,
    greedy peaks with lateral non-max suppression (``min_separation``,
    default the lateral patch size), stopping below ``rel_threshold`` of the
    brightest; peaks whose lateral tails would clip are skipped, z is
    clamped. ``patch`` defaults to the stack's depth by 32 x 32 (square: the
    patch often becomes a model grid).

    Returns ``(patches, positions)``: float64 background-free patches on the
    data's device and the peaks ``(z, y, x)``, brightest first. Runs on the
    tensor's device (a NumPy array goes to the card); each peak's index and
    value come to the host.
    """
    data = _on_device(data)
    d = data.to(torch.float64)
    d = d - median(d)
    nz, ny, nx = d.shape
    if patch is None:
        m = min(32, ny, nx)
        patch = (nz, m, m)
    pz, py, px = patch
    if min_separation is None:
        min_separation = max(py, px)

    work = d.clone()
    peaks = []
    first = None
    s = min_separation
    for _ in range(int(n_beads)):
        flat = torch.argmax(work)
        i, val = torch.stack((flat.to(torch.float64), work.reshape(-1)[flat])).tolist()
        if first is None:
            first = val
        if val <= 0 or val < rel_threshold * first:
            break
        z0, y0, x0 = np.unravel_index(int(i), (nz, ny, nx))
        peaks.append((int(z0), int(y0), int(x0)))
        work[:, max(0, y0 - s):y0 + s + 1, max(0, x0 - s):x0 + s + 1] = -math.inf

    patches, positions = [], []
    cy, cx, cz = py // 2, px // 2, pz // 2
    for z0, y0, x0 in peaks:
        if not (cy <= y0 <= ny - (py - cy) and cx <= x0 <= nx - (px - cx)):
            continue  # lateral tails would clip
        zlo = min(max(z0 - cz, 0), nz - pz)  # clamp z: a stack often holds one z range
        patches.append(d[zlo:zlo + pz, y0 - cy:y0 + (py - cy), x0 - cx:x0 + (px - cx)])
        positions.append((z0, y0, x0))
    if not patches:
        raise ValueError("no usable bead found (all candidates clip the patch edges)")
    return patches, positions


def _xcorr_shift(ref_hat: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The (z, y, x) shift aligning ``p`` to the reference by plain
    (matched-filter) cross-correlation: integer argmax plus a parabola on
    each axis (``psf_fit.py:335-353``), a (3,) tensor on the device."""
    shape = tuple(p.shape)
    c = torch.fft.irfftn(ref_hat * torch.conj(torch.fft.rfftn(p)), s=shape)
    idx = _unravel(torch.argmax(c), shape)
    f0 = c[tuple(idx)]
    out = []
    for ax, n in enumerate(shape):
        def at(j):
            take = list(idx)
            take[ax] = j % n
            return c[tuple(take)]

        i = idx[ax]
        out.append(torch.where(i <= n // 2, i, i - n).to(c.dtype) + _frac(at(i - 1), f0, at(i + 1), 1e-300))
    return torch.stack(out)


def average_beads(data, n_beads: int = 8, patch: tuple[int, int, int] | None = None,
                  min_separation: int | None = None, rel_threshold: float = 0.3):
    """Average up to ``n_beads`` detected beads into one high-SNR bead patch
    (``psf_fit.py:282-367``): each patch is registered against the brightest
    by plain cross-correlation (subvoxel laterally, the axial shift rounded
    to an integer: the axial gauge belongs to the pupil fit), scaled by its
    matched-filter amplitude against it, and the patches with a positive
    amplitude are averaged, in float64 on the data's device.

    Returns ``(patch, n_used)``, the patch in the data's dtype, centred
    layout: feed it to :func:`fit_psf_beads` or ``blind_deconvolve(...,
    bead_data=...)`` with a model at the patch shape. The count is the one
    host read after detection.
    """
    data = _on_device(data)
    patches, _ = detect_beads(data, n_beads=n_beads, patch=patch, min_separation=min_separation,
                              rel_threshold=rel_threshold)
    ref = patches[0]  # brightest
    ref_hat = torch.fft.rfftn(ref)
    rr = torch.sum(ref * ref)
    acc, used = ref.clone(), torch.ones((), dtype=torch.int64, device=ref.device)
    for p in patches[1:]:
        t = _xcorr_shift(ref_hat, p)
        t = torch.cat((torch.round(t[:1]), t[1:]))  # the axial gauge stays integer
        aligned = _fourier_shift(p, t, -1.0)
        amp = torch.sum(aligned * ref) / rr
        keep = amp > 0
        acc = acc + torch.where(keep, aligned / amp, torch.zeros_like(aligned))
        used = used + keep
    n = int(used)
    return (acc / n).to(data.dtype), n


def empirical_psf(data, *, n_beads: int = 1, patch: tuple[int, int, int] | None = None,
                  subvoxel: bool = True) -> torch.Tensor:
    """A measured bead stack as a corner-origin, unit-sum empirical PSF
    (``psf_fit.py:239-279``): ``n_beads > 1`` averages detected beads first
    (:func:`average_beads`), then :func:`center_bead_stack`, negatives clamped
    to 0 (the faint tails are kept: they carry the OTF support), unit sum."""
    data = _on_device(data)
    if n_beads > 1:
        data, _ = average_beads(data, n_beads=n_beads, patch=patch)
    c = torch.clamp_min(center_bead_stack(data, subvoxel=subvoxel), 0.0)
    return c / torch.clamp_min(torch.sum(c), torch.finfo(c.dtype).tiny)


def _profiled(h, d0, s1d, n: float):
    """The amplitude and background ``(amp, c)`` minimizing
    ``0.5||amp*h + c - d0||^2`` over each volume of ``h`` (its last three
    axes), from the 2x2 normal equations (``psf_fit.py:459-468``)."""
    dims = (-3, -2, -1)
    shh = torch.sum(h * h, dim=dims)
    sh1 = torch.sum(h, dim=dims)
    shd = torch.sum(h * d0, dim=dims)
    det = torch.clamp_min(shh * n - sh1 * sh1, torch.finfo(h.dtype).tiny)
    return (n * shd - sh1 * s1d) / det, (shh * s1d - sh1 * shd) / det


def _profiled_residual(h, d0, s1d, n: float) -> torch.Tensor:
    """``0.5||amp*h + c - d0||^2`` at the profiled ``(amp, c)``, in the
    residual form; per volume for a stack (K, ...)."""
    amp, c = _profiled(h, d0, s1d, n)
    if h.ndim == 4:
        amp, c = amp[:, None, None, None], c[:, None, None, None]
    r = amp * h + c - d0
    return 0.5 * torch.sum(r * r, dim=(-3, -2, -1))


def bead_anchor_term(model, bead_data: torch.Tensor, subvoxel: bool = True):
    """A bead-stack data term ``term(params) -> cost`` for anchored fits
    (``psf_fit.py:417-472``): a sub-resolution bead is a delta object, so the
    model is ``amp * h(params) + c`` with the amplitude and background
    profiled out. The value is the residual sum of squares, not the
    normal-equations shortcut ``0.5(||d||^2 - amp<h,d> - c<1,d>)``, whose
    cancellation stalls float32 line searches. ``model`` carries the bead
    stack's grid (:func:`model_at`); the stack is centred once here."""
    if tuple(bead_data.shape) != tuple(model.shape):
        raise ValueError(f"bead model shape {tuple(model.shape)} != bead stack shape {tuple(bead_data.shape)}; "
                         "build it with psf_fit.model_at(sample_model, bead_data.shape)")
    d0 = center_bead_stack(bead_data, subvoxel=subvoxel)
    s1d, n = torch.sum(d0), float(d0.numel())

    def term(params):
        return _profiled_residual(model.compute_psf(params), d0, s1d, n)

    return term


def _combine_aux_terms(param_of, aux_terms):
    """``v -> sum_w w * term(param_of(v))`` over ``aux_terms`` (``(term, w)``
    pairs) in natural intensity units (``psf_fit.py:475-499``): a data term
    keeps its own weight (normalizing it by its start value was measured to
    blow a low-SNR bead's noise floor up into a dominant pull)."""

    def extra(v):
        p = param_of(v)
        out = 0.0
        for term, w in aux_terms:
            out = out + w * term(p)
        return out

    return extra


def _run_vmlmb(objective, x0, config: PsfFitConfig):
    return minimize_vmlmb(value_and_grad(objective), x0, mem=config.mem, maxiter=config.max_iter,
                          maxeval=config.max_eval, gatol=config.gatol, grtol=config.grtol)


def _fit_single(cost, params, family: str, config: PsfFitConfig, active=None, freeze_head: int = 0,
                precondition: bool = False, anchor=None, prior_weight: float = 0.0, aux_terms=()):
    """One family's fit of ``cost(params)`` (``psf_fit.py:540-615,643-705``):
    its coefficients ``[freeze_head:active]`` move; the calibration prior
    ``prior_weight * f0 * ||v - anchor||^2`` (``f0`` the data cost at the
    start, so the weight is scale-invariant) and the auxiliary terms join the
    objective; ``precondition`` scales each coefficient by its initial
    gradient."""
    full0 = getattr(params, family).detach()
    if full0.shape[0] == 0:
        raise ValueError(f"family {family!r} has no coefficients to fit")
    if active is None or active >= full0.shape[0]:
        active = full0.shape[0]
    if not 0 <= freeze_head < active:
        raise ValueError(f"freeze_head={freeze_head} must be in [0, active={active})")
    x0 = full0[freeze_head:active]

    def param_of(v):
        return params._replace(**{family: _with_slice(full0, freeze_head, v)})

    def data_objective(v):
        return cost(param_of(v))

    extra = []
    if prior_weight > 0:
        anchor_v = (full0 if anchor is None else anchor.detach())[freeze_head:active]
        with torch.no_grad():
            f0 = data_objective(x0)
        extra.append(lambda v: prior_weight * f0 * torch.sum((v - anchor_v) ** 2))
    if aux_terms:
        extra.append(_combine_aux_terms(param_of, aux_terms))

    def objective(v):
        out = data_objective(v)
        for e in extra:
            out = out + e(v)
        return out

    scale = 1.0
    if precondition:
        _, g0 = value_and_grad(objective)(x0)
        tiny = torch.finfo(g0.dtype).tiny
        scale = 1.0 / torch.maximum(g0.abs(), torch.clamp_min(1e-12 * g0.abs().max(), tiny))
    res = _run_vmlmb(lambda u: objective(u * scale), x0 / scale, config)
    return PsfFitResult(param_of(res.x * scale), res.f, res.iterations, res.evaluations, res.status, res.f_history)


def _fit_joint(cost, params, names: tuple[str, ...], config: PsfFitConfig, phase_freeze_head: int = 0,
               phase_anchor=None, phase_prior_weight: float = 0.0, aux_terms=()):
    """Several families in one VMLMB run over the gradient-balanced
    :func:`joint_variable` (``psf_fit.py:707-733,829-868``); one extra
    evaluation seeds the scaling and the prior's ``f0``."""
    for n in names:
        if getattr(params, n).shape[0] == 0:
            raise ValueError(f"family {n!r} has no coefficients to fit")
    f0, g0 = value_and_grad(lambda sub: cost(params._replace(**sub)))({n: getattr(params, n) for n in names})
    x0, rebuild = joint_variable(params, names, phase_freeze_head, grads=g0)
    use_prior = phase_prior_weight > 0 and "phase" in names
    if use_prior:
        phase_anchor = (params.phase if phase_anchor is None else phase_anchor).detach()
    extra = _combine_aux_terms(rebuild, aux_terms) if aux_terms else None

    def objective(v):
        p = rebuild(v)
        f = cost(p)
        if use_prior:
            f = f + phase_prior_weight * f0 * torch.sum((p.phase - phase_anchor) ** 2)
        if extra is not None:
            f = f + extra(v)
        return f

    res = _run_vmlmb(objective, x0, config)
    return PsfFitResult(rebuild(res.x), res.f, res.iterations, res.evaluations, res.status, res.f_history)


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
    anchor: torch.Tensor | None = None,
    prior_weight: float = 0.0,
    aux_terms: tuple = (),
) -> PsfFitResult:
    """Fit the family selected by ``flag`` (``psf_fit.py:502-615``):
    ``active`` fits only its first coefficients, ``freeze_head`` freezes the
    first k of those. ``precondition`` rescales each coefficient by its
    initial gradient's magnitude (one extra gradient evaluation): without it
    the first step of a DEPTH or SHEET fit is orders of magnitude too long
    (metres of depth) and the search stalls. ``prior_weight`` adds the
    calibration prior toward ``anchor`` (default the start), ``aux_terms``
    the ``(term, weight)`` pairs of :func:`bead_anchor_term`."""
    if weights is not None and weights.shape != data.shape:
        weights = pad_to_shape(weights, tuple(data.shape))
    data_cost = _fit_data_term(obj, data, weights)
    return _fit_single(lambda p: data_cost.cost(model.compute_psf(p)), params, family_name(flag), config,
                       active, freeze_head, precondition, anchor, prior_weight, aux_terms)


def fit_families_with_cost(
    cost,
    params,
    names: tuple[str, ...],
    config: PsfFitConfig,
    phase_active: int | None = None,
    phase_freeze_head: int = 0,
    phase_anchor: torch.Tensor | None = None,
    phase_prior_weight: float = 0.0,
    aux_terms: tuple = (),
) -> PsfFitResult:
    """The fit scaffolding over an abstract ``cost(params)``
    (``psf_fit.py:618-733``), shared by the depth-varying fits: one name fits
    that family alone (``phase_active``, ``phase_freeze_head`` and the
    calibration prior apply to PHASE; DEPTH and SHEET are preconditioned),
    several fit jointly over :func:`joint_variable`."""
    for n in names:
        if getattr(params, n).shape[0] == 0:
            raise ValueError(f"family {n!r} has no coefficients to fit")
    if len(names) > 1:
        return _fit_joint(cost, params, names, config, phase_freeze_head, phase_anchor, phase_prior_weight,
                          aux_terms)
    family = names[0]
    phase = family == "phase"
    return _fit_single(cost, params, family, config, active=phase_active if phase else None,
                       freeze_head=phase_freeze_head if phase else 0, precondition=family in _HETEROGENEOUS,
                       anchor=phase_anchor, prior_weight=phase_prior_weight if phase else 0.0,
                       aux_terms=aux_terms)


def joint_variable(params, names: tuple[str, ...], phase_freeze_head: int = 0, *, grads: dict):
    """(x0, rebuild) for a multi-family fit with gradient-balanced scaling
    (``psf_fit.py:736-796``): each family's scaled initial gradient gets unit
    inf-norm, so no family dominates the shared L-BFGS metric (defocus lives
    in 1/m, with gradients orders of magnitude above the Zernike ones); the
    DEPTH and SHEET families are scaled coefficient by coefficient. The
    first ``phase_freeze_head`` phase coefficients are frozen."""
    gmax = {n: torch.max(torch.abs(grads[n])) for n in names}
    global_max = gmax[names[0]]
    for n in names[1:]:
        global_max = torch.maximum(global_max, gmax[n])
    tiny = torch.finfo(global_max.dtype).tiny
    floor = torch.clamp_min(1e-12 * global_max, tiny)
    scales = {n: 1.0 / torch.maximum(torch.abs(grads[n]) if n in _HETEROGENEOUS else gmax[n], floor) for n in names}
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
    phase_anchor: torch.Tensor | None = None,
    phase_prior_weight: float = 0.0,
    aux_terms: tuple = (),
) -> PsfFitResult:
    """Fit several families simultaneously in one VMLMB run
    (``psf_fit.py:799-868``); the variable is a dict of the selected
    families, scaled by :func:`joint_variable`. ``phase_prior_weight`` adds
    ``w * f0 * ||phase - phase_anchor||^2`` (``f0`` the data cost at the
    start; the anchor defaults to the start's phase), ``aux_terms`` the bead
    anchors."""
    if weights is not None and weights.shape != data.shape:
        weights = pad_to_shape(weights, tuple(data.shape))
    data_cost = _fit_data_term(obj, data, weights)
    return _fit_joint(lambda p: data_cost.cost(model.compute_psf(p)), params, tuple(family_name(f) for f in flags),
                      config, phase_freeze_head, phase_anchor, phase_prior_weight, aux_terms)


def fit_psf_beads(
    model,
    data: torch.Tensor,
    families: tuple[int, ...] = (0, 1),  # (DEFOCUS, PHASE)
    params0=None,
    config: PsfFitConfig = PsfFitConfig(),
    phase_freeze_head: int = 0,
    subvoxel: bool = True,
):
    """Calibrate PSF parameters from a bead stack (``psf_fit.py:871-960``):
    a sub-resolution bead is a delta object, so the stack is the shifted,
    scaled PSF. The stack is normalized to unit peak (the profiled objective
    is scale-equivariant, and at camera scales the float32 line search stalls
    at its first iterate), centred with subvoxel lateral refinement, and the
    families are fitted jointly on :func:`bead_anchor_term`, whose amplitude
    and background are optimal for every geometry. ``model`` carries the
    stack's grid. Returns ``(PsfFitResult, amplitude)``, the amplitude the
    matched filter's at the solution in the stack's own units. (The JAX
    ``rounds`` argument, unused there, is not carried.)"""
    if params0 is None:
        params0 = model.init_params()
    names = tuple(family_name(f) for f in families)
    peak = torch.clamp_min(torch.max(torch.abs(data)), torch.finfo(data.dtype).tiny)
    term = bead_anchor_term(model, data / peak, subvoxel=subvoxel)
    fit = _fit_joint(term, params0, names, config, phase_freeze_head)
    with torch.no_grad():
        d0 = center_bead_stack(data, subvoxel=subvoxel)
        h = model.compute_psf(fit.params)
        amp = torch.sum(h * d0) / torch.sum(h * h)
    return fit, amp


def calibrate_field(
    model,
    data,
    families: tuple[int, ...] = (0, 1),  # (DEFOCUS, PHASE)
    n_beads: int = 8,
    min_separation: int | None = None,
    rel_threshold: float = 0.3,
    config: PsfFitConfig = PsfFitConfig(),
    phase_freeze_head: int = 0,
    subvoxel: bool = True,
):
    """Field-varying calibration, one :func:`fit_psf_beads` a detected bead
    (``psf_fit.py:370-414``). ``model`` carries the patch grid (the stack's
    depth by a square lateral patch). Returns ``(anchors, fits)``: anchors
    ``[((y, x), params), ...]`` for ``jobs.tiled.field_psf`` and the
    per-bead :class:`PsfFitResult` list."""
    patches, positions = detect_beads(data, n_beads=n_beads, patch=tuple(model.shape),
                                      min_separation=min_separation, rel_threshold=rel_threshold)
    anchors, fits = [], []
    for (_, y0, x0), p in zip(positions, patches):
        res, _ = fit_psf_beads(model, p.to(model.dtype), families=families, config=config,
                               phase_freeze_head=phase_freeze_head, subvoxel=subvoxel)
        anchors.append(((float(y0), float(x0)), res.params))
        fits.append(res)
    return anchors, fits


# ---------------------------------------------------------------------------
# Fit uncertainty (Laplace / Gauss-Newton error bars)
# ---------------------------------------------------------------------------


class FitUncertainty(NamedTuple):
    """Per-coefficient 1-sigma error bars of a PSF fit (``psf_fit.py:968-983``):
    ``std`` a tensor (:func:`fit_uncertainty`) or a ``{family: tensor}`` dict
    with ``"amp"`` and ``"background"`` (:func:`bead_fit_uncertainty`);
    ``cov`` the full covariance in the same order; ``sigma`` the noise
    standard deviation used (the residual's when not given, 1 under
    inverse-variance weights)."""

    std: object
    cov: torch.Tensor
    sigma: torch.Tensor


def _jacobian(predict, x: torch.Tensor) -> torch.Tensor:
    """The flattened Jacobian (voxels, k) of ``predict`` at ``x`` by forward
    mode, one column a coefficient (``jax.jacfwd``): the reverse-mode one
    would take a pass a voxel."""
    return torch.func.jacfwd(predict)(x).reshape(-1, x.shape[0])


def _gn_covariance(jac_flat, weights_flat, k_model: int, sigma, resid, dtype):
    """``cov = sigma^2 (J^T W J)^{-1}`` from a flattened Jacobian, in the
    data's dtype (``psf_fit.py:986-1009``); ``sigma`` absent is the residual
    estimate ``sqrt(||r||^2 / (n - k))``."""
    jw = jac_flat if weights_flat is None else jac_flat * weights_flat[:, None]
    gn = jac_flat.T @ jw
    gn = 0.5 * (gn + gn.T)
    kw = dict(dtype=dtype, device=gn.device)
    if weights_flat is not None:
        sigma_out, scale2 = torch.tensor(1.0, **kw), 1.0  # the weights are inverse variances
    else:
        if sigma is None:
            sigma_out = torch.sqrt(torch.sum(resid * resid) / max(resid.shape[0] - k_model, 1))
        else:
            sigma_out = torch.tensor(sigma, **kw)
        scale2 = sigma_out * sigma_out
    cov = scale2 * torch.linalg.solve(gn, torch.eye(gn.shape[0], dtype=gn.dtype, device=gn.device))
    return cov, sigma_out


def fit_uncertainty(
    model,
    params,
    flag: int,
    data: torch.Tensor,
    obj: torch.Tensor,
    weights: torch.Tensor | None = None,
    sigma: float | None = None,
) -> FitUncertainty:
    """Error bars of a :func:`fit_psf` solution, at the fitted ``params``
    (``psf_fit.py:1012-1060``): the Laplace approximation with the
    Gauss-Newton Hessian of ``0.5 sum w (obj (*) h(x) - d)^2``, ``J`` by
    forward mode through the synthesis and the plain convolution. Memory is
    ``k`` volumes for the Jacobian."""
    family = family_name(flag)
    x = getattr(params, family).detach()
    if x.shape[0] == 0:
        raise ValueError(f"family {family!r} has no coefficients")
    if weights is not None and weights.shape != data.shape:
        weights = pad_to_shape(weights, tuple(data.shape))
    obj_hat = convolve_spectrum(obj)

    def predict(v):
        return convolve(model.compute_psf(params._replace(**{family: v})), obj_hat, tuple(data.shape))

    jac = _jacobian(predict, x)
    with torch.no_grad():
        resid = (predict(x) - data).reshape(-1)
    cov, sigma_out = _gn_covariance(jac, None if weights is None else weights.reshape(-1), x.shape[0], sigma, resid,
                                    data.dtype)
    return FitUncertainty(torch.sqrt(torch.diagonal(cov)), cov, sigma_out)


def _split_std(std_all: torch.Tensor, names, sizes, tail) -> dict:
    """``{name: slice}`` of a concatenated std vector: the families, then
    the ``tail`` entries ``(key, length)`` (length None: a scalar)."""
    std, off = {}, 0
    for nm, sz in list(zip(names, sizes)) + list(tail):
        std[nm] = std_all[off] if sz is None else std_all[off:off + sz]
        off += 1 if sz is None else sz
    return std


def bead_fit_uncertainty(
    model,
    params,
    families: tuple[int, ...],
    bead_data: torch.Tensor,
    subvoxel: bool = True,
    sigma: float | None = None,
) -> FitUncertainty:
    """Error bars of a :func:`fit_psf_beads` solution (``psf_fit.py:1063-1119``):
    the recipe of :func:`fit_uncertainty` on the bead model ``amp * h(x) +
    c``, the profiled amplitude and background included as columns and
    marginalized. ``std`` is ``{family: tensor}`` plus scalar ``"amp"`` and
    ``"background"``; ``cov`` is over ``[families..., amp, c]``."""
    names = tuple(family_name(f) for f in families)
    d0 = center_bead_stack(bead_data, subvoxel=subvoxel)
    with torch.no_grad():
        amp, c = _profiled(model.compute_psf(params), d0, torch.sum(d0), float(d0.numel()))
    sizes = [int(getattr(params, nm).shape[0]) for nm in names]
    x0 = torch.cat([getattr(params, nm).detach() for nm in names] + [amp[None], c[None]])

    def predict(v):
        sub, off = {}, 0
        for nm, sz in zip(names, sizes):
            sub[nm] = v[off:off + sz]
            off += sz
        return v[off] * model.compute_psf(params._replace(**sub)) + v[off + 1]

    jac = _jacobian(predict, x0)
    with torch.no_grad():
        resid = (predict(x0) - d0).reshape(-1)
    cov, sigma_out = _gn_covariance(jac, None, x0.shape[0], sigma, resid, d0.dtype)
    std = _split_std(torch.sqrt(torch.diagonal(cov)), names, sizes, (("amp", None), ("background", None)))
    return FitUncertainty(std, cov, sigma_out)
