"""Out-of-core blind deconvolution: tile-streamed PSF-fit statistics.

Port of ``microtipi_tpu/jobs/tiled_blind.py``. ``jobs/tiled.py`` solves the
object step of a volume larger than one solve tile by tile; the blind loop's
PSF fit (``BlindDeconvJob.java:97-138``) evaluates the object-as-kernel data
term ``0.5 ||obj (*) h(theta) - d||^2`` (``PSF_Estimation.java:147-150``) over
the whole volume, which does not fit on the card at light-sheet scale.

With uniform weights that data term is a quadratic in the PSF ``h``, and
when ``h`` has compact support ``psf_shape`` (the assumption the tiled object
step makes already) it reduces exactly to small-grid sufficient statistics::

    f(h) = 0.5 <h, A h> - <b, h> + c
    A h  = (R_obj (*) h)        restricted to the support
    R_obj[l] = sum_i obj[i] obj[i+l]   (circular autocorrelation, lags |l| < h)
    b[s]     = sum_i d[i]  obj[i-s]    (circular correlation, |s| <= h/2)
    c        = 0.5 sum_i d[i]^2

``R_obj``, ``b`` and ``c`` come from one streamed pass over the volume
(:func:`streamed_fit_stats`): core blocks with a halo of ``psf_shape``,
gathered on the host by a thread a block (plain sub-box copies, split where
a block wraps across the volume's edge), correlated on the card in batches by FFT in
the volume's dtype, each batch summed there and accumulated in float64.
After that every fit evaluation costs FFTs at the (2*psf_shape) grid. The
fit runs in float64 on the card (:func:`fit_psf_streamed`): the quadratic
identity resolves cost differences only to ``eps*c``, and ``c`` sums the
whole volume, so a float32 fit would stall. The JAX package runs that fit on
the host CPU because its TPU has no float64; the H100 has it, and the fit
stays on the device of its model.

Exactness: the streamed objective equals the dense circulant objective with
the support-limited PSF ``pad_fft_kernel(model(psf_shape).compute_psf(theta),
volume_shape)``, the truncation the tiled object step makes. It needs
``2*psf_shape <= volume_shape`` per axis.

:func:`blind_deconvolve_tiled` alternates ``jobs/tiled.tiled_deconvolve``
with this fit (host-driven rounds; the last round never refits,
``BlindDeconvJob.java:116``).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
import os
from typing import NamedTuple

import numpy as np
import torch

from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig, fit_families_with_cost
from microtipi_tpu_torch.jobs.tiled import tiled_deconvolve
from microtipi_tpu_torch.models.microscope import family_name
from microtipi_tpu_torch.utils.arrays import pad_fft_kernel

__all__ = ["FitStats", "blind_deconvolve_tiled", "fit_psf_streamed", "make_streamed_fit_cost",
           "streamed_fit_stats"]


class FitStats(NamedTuple):
    """Sufficient statistics of the uniform-weight PSF-fit data term
    (``tiled_blind.py:60-77``): ``rho`` the circular object autocorrelation
    at lags |l| < h on the (2h) grid ``g_shape`` (lag l at index l mod 2h),
    ``b`` the data-object correlation at the kernel's displacements, both
    float64 tensors on the device that computed them; ``c = 0.5 sum d^2``."""

    rho: torch.Tensor
    b: torch.Tensor
    c: float
    g_shape: tuple[int, int, int]
    psf_shape: tuple[int, int, int]
    volume_shape: tuple[int, int, int]


def _block_starts(n: int, c: int) -> list[int]:
    """Starts of size-``c`` core blocks covering [0, n): stride c, the last
    block flush-shifted (``tiled_blind.py:80-88``)."""
    if c >= n:
        return [0]
    starts = list(range(0, n - c + 1, c))
    if starts[-1] + c < n:
        starts.append(n - c)
    return starts


def _segments(lo: int, size: int, n: int) -> list[tuple[int, int, int]]:
    """``[lo, lo + size)`` taken modulo ``n`` as (source start, destination
    start, length) runs: one inside the axis, two or more where it wraps."""
    runs, d = [], 0
    while d < size:
        s = (lo + d) % n
        length = min(size - d, n - s)
        runs.append((s, d, length))
        d += length
    return runs


def _wrapped_block(vol: np.ndarray, lo, size, out: np.ndarray | None = None) -> np.ndarray:
    """``vol`` at ``[lo, lo + size)`` per axis, indices taken modulo the
    volume, copied into ``out`` (allocated when None) as plain sub-box slices:
    one inside the volume, one a side more along each axis the box crosses."""
    if out is None:
        out = np.empty(tuple(size), vol.dtype)
    for (sz, dz, lz), (sy, dy, ly), (sx, dx, lx) in itertools.product(
            *(_segments(l, s, n) for l, s, n in zip(lo, size, vol.shape))):
        out[dz:dz + lz, dy:dy + ly, dx:dx + lx] = vol[sz:sz + lz, sy:sy + ly, sx:sx + lx]
    return out


def _gather_blocks(obj: np.ndarray, data: np.ndarray, chunk, core, h, masks):
    """The host's part of a batch (``tiled_blind.py:160-180``): the core
    blocks of ``obj`` and ``data`` with each flush-shifted block's leading
    overlap zeroed (every voxel counted once), and the object's blocks
    extended by ``h`` on each side, wrapped. Three stacked NumPy arrays, one
    thread a block (NumPy's copies release the GIL)."""
    ext = tuple(cv + 2 * hv for cv, hv in zip(core, h))
    cos = np.empty((len(chunk),) + tuple(core), obj.dtype)
    cds = np.empty((len(chunk),) + tuple(core), data.dtype)
    exs = np.empty((len(chunk),) + ext, obj.dtype)

    def gather(i):
        s = chunk[i]
        sl = tuple(slice(sv, sv + cv) for sv, cv in zip(s, core))
        cos[i], cds[i] = obj[sl], data[sl]
        for ax in range(3):
            m = masks[ax][s[ax]]
            if m:
                idx = (i,) + tuple(slice(0, m) if j == ax else slice(None) for j in range(3))
                cos[idx] = 0
                cds[idx] = 0
        _wrapped_block(obj, [sv - hv for sv, hv in zip(s, h)], ext, exs[i])

    with concurrent.futures.ThreadPoolExecutor(min(len(chunk), os.cpu_count() or 1)) as pool:
        list(pool.map(gather, range(len(chunk))))
    return cos, cds, exs


def _block_stats(core_obj: torch.Tensor, core_data: torch.Tensor, ext_obj: torch.Tensor, h, core, ext):
    """The card's part of a batch (``tiled_blind.py:140-156``): each core
    embedded at offset h in the extended grid, its circular correlations with
    the extended object block, summed over the batch; and 0.5 sum d^2."""
    dims = (1, 2, 3)
    box = (slice(None),) + tuple(slice(hv, hv + cv) for hv, cv in zip(h, core))
    f_ext = torch.fft.rfftn(ext_obj, dim=dims)

    def corr(block):
        padded = torch.zeros((block.shape[0],) + tuple(ext), dtype=block.dtype, device=block.device)
        padded[box] = block
        return torch.fft.irfftn(torch.conj(torch.fft.rfftn(padded, dim=dims)) * f_ext, s=ext, dim=dims).sum(0)

    return corr(core_obj), corr(core_data), 0.5 * torch.sum(core_data * core_data)


def streamed_fit_stats(
    obj,
    data,
    psf_shape: tuple[int, int, int],
    tile: tuple[int, int, int] | None = None,
    max_batch: int = 8,
    device: torch.device | str = "cuda",
) -> FitStats:
    """One streamed pass over (obj, data) -> :class:`FitStats`
    (``tiled_blind.py:91-209``).

    ``obj``/``data``: NumPy volumes on the host, never on the card whole.
    ``tile``: the core block streamed a lane (default min(volume, 128) per
    axis); each lane correlates at ``tile + 2*psf_shape`` on ``device`` (the
    card unless the caller names another) in the volumes' dtype; the batch
    sums stay there and accumulate in float64.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("streamed_fit_stats runs on the CUDA card by default and none is available; "
                           "pass device='cpu' to run it on the CPU")
    obj, data = np.asarray(obj), np.asarray(data)
    if obj.shape != data.shape:
        raise ValueError(f"obj {obj.shape} != data {data.shape}")
    shape = data.shape
    h = tuple(int(v) for v in psf_shape)
    if any(2 * hv > n for hv, n in zip(h, shape)):
        raise ValueError(f"streamed fit needs 2*psf_shape <= volume shape per axis (psf {h}, volume {shape}): "
                         "the support-limited quadratic wraps otherwise; shrink psf_shape")
    if tile is None:
        tile = tuple(min(n, 128) for n in shape)
    core = tuple(min(int(t), n) for t, n in zip(tile, shape))
    ext = tuple(c + 2 * hv for c, hv in zip(core, h))
    axes_starts = [_block_starts(n, c) for n, c in zip(shape, core)]
    blocks = [(sz, sy, sx) for sz in axes_starts[0] for sy in axes_starts[1] for sx in axes_starts[2]]
    # A flush-shifted last block overlaps the previous core by (prev_end - start).
    masks = [{s: (0 if i == 0 else max(0, starts[i - 1] + c - s)) for i, s in enumerate(starts)}
             for starts, c in zip(axes_starts, core)]

    r_acc = torch.zeros(ext, dtype=torch.float64, device=device)
    b_acc = torch.zeros(ext, dtype=torch.float64, device=device)
    c_acc = torch.zeros((), dtype=torch.float64, device=device)
    for i0 in range(0, len(blocks), max_batch):
        cos, cds, exs = _gather_blocks(obj, data, blocks[i0:i0 + max_batch], core, h, masks)
        r, bb, cc = _block_stats(*(torch.as_tensor(a).to(device) for a in (cos, cds, exs)), h, core, ext)
        r_acc += r.double()
        b_acc += bb.double()
        c_acc += cc.double()

    # Lags and displacements from the extended-grid correlations onto (2h).
    g_shape = tuple(2 * hv for hv in h)

    def grid(per_axis, n_of):
        idx = [torch.as_tensor(v % n, device=device) for v, n in zip(per_axis, n_of)]
        return idx[0][:, None, None], idx[1][None, :, None], idx[2][None, None, :]

    lags = [np.r_[0:hv, -hv + 1:0] for hv in h]  # R[l] = r_acc[l mod ext]
    rho = torch.zeros(g_shape, dtype=torch.float64, device=device)
    rho[grid(lags, g_shape)] = r_acc[grid(lags, ext)]
    disp = [np.r_[0:hv - hv // 2, -(hv // 2):0] for hv in h]  # b[s] = b_acc[(-s) mod ext]
    bg = torch.zeros(g_shape, dtype=torch.float64, device=device)
    bg[grid(disp, g_shape)] = b_acc[grid([-d for d in disp], ext)]
    return FitStats(rho, bg, float(c_acc), g_shape, h, tuple(shape))


def make_streamed_fit_cost(stats: FitStats, model):
    """``cost(params)`` over the streamed statistics, for
    ``psf_fit.fit_families_with_cost`` (``tiled_blind.py:212-228``):
    ``0.5 <h, A h> - <b, h> + c`` with ``h`` the model's PSF at
    ``stats.psf_shape`` embedded in the (2h) grid, in float64 (the model
    should be float64; :func:`fit_psf_streamed`'s caller builds it so)."""
    g_shape = stats.g_shape
    rho_hat = torch.fft.rfftn(stats.rho)

    def cost(params):
        hg = pad_fft_kernel(model.compute_psf(params), g_shape).to(stats.rho.dtype)
        ah = torch.fft.irfftn(rho_hat * torch.fft.rfftn(hg), s=g_shape)
        return 0.5 * torch.sum(hg * ah) - torch.sum(stats.b * hg) + stats.c

    return cost


def fit_psf_streamed(
    model,
    params,
    families,
    stats: FitStats,
    config: PsfFitConfig = PsfFitConfig(),
    joint: bool = True,
    **fit_kw,
):
    """Fit PSF parameters against streamed statistics in float64
    (``tiled_blind.py:231-268``) on the model's device: ``model`` is at
    ``stats.psf_shape`` with float64 buffers (the caller builds it;
    :func:`blind_deconvolve_tiled` does). ``families`` (DEFOCUS/PHASE/...)
    fit jointly (default) or one after another; ``fit_kw`` go to
    ``fit_families_with_cost``. Returns ``(params, f, iterations)`` with the
    params float64 tensors on the model's device."""
    names = tuple(family_name(f) for f in families)
    cost = make_streamed_fit_cost(stats, model)
    p = _cast(params, torch.float64, model.device)
    if joint or len(names) == 1:
        res = fit_families_with_cost(cost, p, names, config, **fit_kw)
    else:
        for n in names:
            res = fit_families_with_cost(cost, p, (n,), config, **fit_kw)
            p = res.params
    return _cast(res.params, torch.float64, model.device), float(res.f), int(res.iterations)


def _cast(params, dtype, device):
    """``params`` as detached tensors of ``dtype`` on ``device``."""
    return params._replace(**{n: torch.as_tensor(getattr(params, n), dtype=dtype, device=device).detach()
                              for n in params._fields})


def blind_deconvolve_tiled(
    data,
    model,
    config,
    params0=None,
    tile: tuple[int, int, int] | None = None,
    overlap: tuple[int, int, int] | int = 16,
    max_batch: int = 4,
    stats_tile: tuple[int, int, int] | None = None,
    log=None,
):
    """Blind deconvolution of a volume larger than one solve, host-driven
    rounds (``tiled_blind.py:271-358``).

    ``data``: a NumPy volume on the host. ``model``: a PSF model at
    ``psf_shape`` (its grid is the PSF support; laterally square, and
    ``2*psf_shape <= data.shape`` per axis); everything runs on its device.
    ``config``: a ``jobs.blind.BlindDeconvConfig``: loops, families and
    budgets (each fit ``max_eval = 2 * budget``, joint or family by family),
    ``mu_schedule``, ``joint_fit``, ``phase_freeze_head`` and
    ``deconv_engine`` ("vmlmb" or "admm" a tile); the last round never
    refits. Uniform weights only: the sufficient-statistics reduction needs
    them.

    Each round: the tiled object step from scratch (``jobs.tiled.
    tiled_deconvolve``, the PSF synthesized at ``psf_shape``), one streamed
    statistics pass, one float64 fit. Returns ``(obj, params, psf,
    deconv_f, fit_f)``: ``obj`` a NumPy volume, ``params`` the fitted params
    (float64 tensors), ``psf`` the final PSF at the model's dtype,
    ``deconv_f`` NaN a round (per-tile costs do not sum to the global one)
    and ``fit_f`` the fit's cost a round (NaN for the last).
    """
    data = np.asarray(data)
    psf_shape = tuple(model.shape)
    device = model.device
    params = model.init_params() if params0 is None else params0
    model64 = type(model)(dataclasses.replace(model.config, dtype=torch.float64), device)
    method = "admm" if config.deconv_engine == "admm" else "vmlmb"
    n_rounds = int(config.loops)
    deconv_f, fit_f = [], []
    obj = None
    for i in range(n_rounds):
        cfg: DeconvolutionConfig = config.deconv
        if config.mu_schedule is not None:
            cfg = dataclasses.replace(cfg, mu=float(config.mu_schedule[i]))
        with torch.no_grad():
            psf = model.compute_psf(_cast(params, model.dtype, device))
        obj = tiled_deconvolve(data, psf, tile=tile, overlap=overlap, config=cfg, method=method,
                               max_batch=max_batch, device=device)
        deconv_f.append(np.nan)
        if log:
            log(f"round {i + 1}/{n_rounds}: object step done (mu={cfg.mu:.4g}, engine={method})")
        if i >= n_rounds - 1 and config.skip_last_fit:
            fit_f.append(np.nan)
            break
        stats = streamed_fit_stats(obj, data, psf_shape, tile=stats_tile, device=device)
        budgets = tuple(int(b) for b in config.psf_max_iter)
        if config.joint_fit:
            fcfg = dataclasses.replace(config.fit, max_iter=max(budgets), max_eval=2 * max(budgets))
            params, f, _ = fit_psf_streamed(model64, params, tuple(config.families), stats, fcfg, joint=True,
                                            phase_freeze_head=config.phase_freeze_head)
        else:
            f = np.nan
            for fam, budget in zip(config.families, budgets):
                if budget <= 0:
                    continue
                fcfg = dataclasses.replace(config.fit, max_iter=budget, max_eval=2 * budget)
                params, f, _ = fit_psf_streamed(model64, params, (fam,), stats, fcfg,
                                                phase_freeze_head=config.phase_freeze_head)
        fit_f.append(f)
        if log:
            log(f"round {i + 1}/{n_rounds}: fit f={f:.6g}")
    with torch.no_grad():
        psf = model.compute_psf(_cast(params, model.dtype, device))
    return obj, params, psf, np.asarray(deconv_f), np.asarray(fit_f)
