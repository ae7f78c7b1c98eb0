"""Richardson-Lucy deconvolution (multiplicative Poisson MLE updates).

Port of ``microtipi_tpu/jobs/richardson_lucy.py``:

    x_{k+1} = x_k / (H^T 1) * H^T( d / (H x_k + bg) )

with H the circulant PSF convolution (so ``H^T 1 = sum(psf)`` is a scalar)
and ``bg`` a constant background; two FFT pairs an iteration. Optional TV
regularization (RL-TV, Dey et al. 2006) adds ``mu`` times the hyperbolic-TV
gradient to the denominator; that gradient comes from the fused TV wrapper
(``ops/kernels/hyperbolic_tv.py``), the CUDA kernel on the card, one launch
an iteration, used directly without autograd. Optional Biggs-Andrews
extrapolation (``accelerate=True``), the Wiener-Butterworth backprojector of
Guo et al. 2020 and the discrepancy stops are those of the JAX module.

A 4D ``data`` (B, Nz, Ny, Nx) is a batch of lanes, the port's counterpart of
``jax.vmap`` over :func:`richardson_lucy`: each lane has its own flux, support
threshold, discrepancy target and stop, every iteration is one batched FFT
pair per direction and one batched TV launch, and a lane that stops is frozen
at its own iterate while the others go on. ``jobs/tiled.py`` solves its tiles
so. Everything runs on the device of its tensors.

Multi-view fusion (:func:`multiview_richardson_lucy`) is the joint Poisson
MLE over K registered views with per-view PSFs, the K views batched through
the FFTs.
"""

from __future__ import annotations

import numpy as np
import torch

from microtipi_tpu_torch.jobs.autotune import estimate_noise_sigma
from microtipi_tpu_torch.ops.kernels.hyperbolic_tv import hyperbolic_tv_batched_fused, hyperbolic_tv_fused

__all__ = ["multiview_richardson_lucy", "richardson_lucy", "wb_backprojector"]

_STOPS = ("fixed", "gaussian", "poisson")


def wb_backprojector(k_hat: torch.Tensor, shape, beta: float = 0.1, order: int = 10,
                     cutoff_rel: float = 1e-2) -> torch.Tensor:
    """Wiener-Butterworth backprojector spectrum (Guo et al., Nat. Biotech
    2020; ``richardson_lucy.py:48-93``) of one volume's rfftn-layout OTF
    ``k_hat``:

        B(k) = conj(OTF) / (|OTF|^2 + beta^2) / sqrt(1 + rho(k)^(2*order))

    with ``rho`` the frequency radius over the OTF's per-axis support
    cutoffs (the largest |f_axis| where ``|OTF| > cutoff_rel * |OTF(0)|``),
    normalized so ``B(0) = 1``."""
    otf = k_hat
    mag2 = (otf * otf.conj()).real
    dc = torch.sqrt(mag2.reshape(-1)[0])
    support = mag2 > (cutoff_rel * dc) ** 2
    freqs = [np.fft.fftfreq(n) for n in shape[:-1]] + [np.fft.rfftfreq(shape[-1])]
    tiny = torch.tensor(np.finfo(np.float32).tiny, dtype=mag2.dtype, device=mag2.device)
    rho2 = 0.0
    for ax, f in enumerate(freqs):
        fa = torch.as_tensor(np.abs(f), dtype=mag2.dtype, device=mag2.device).reshape(
            [-1 if i == ax else 1 for i in range(len(shape))])
        kc = torch.max(torch.where(support, fa, torch.zeros((), dtype=mag2.dtype, device=mag2.device)))
        rho2 = rho2 + (fa / torch.maximum(kc, tiny)) ** 2
    wiener = otf.conj() / (mag2 + float(beta) ** 2)
    butter = 1.0 / torch.sqrt(1.0 + rho2 ** order)
    b_hat = wiener * butter
    b0 = b_hat.reshape(-1)[0].real
    return b_hat / torch.maximum(b0, tiny)


def _fft_pair(ndim: int):
    """rfftn / irfftn over the last ``ndim`` axes."""
    dims = tuple(range(-ndim, 0))
    return (lambda t: torch.fft.rfftn(t, dim=dims)), (lambda t, s: torch.fft.irfftn(t, s=s, dim=dims))


def richardson_lucy(
    data: torch.Tensor,
    psf: torch.Tensor,
    iterations: int = 50,
    background: float = 0.0,
    mu: float = 0.0,
    epsilon: float = 1e-2,
    x0: torch.Tensor | None = None,
    accelerate: bool = False,
    backprojector: str = "matched",
    wb_beta: float = 0.1,
    stop: str = "fixed",
    stop_sigma=None,
    stop_tau: float = 1.0,
    return_iterations: bool = False,
):
    """RL (optionally RL-TV / Biggs-Andrews accelerated) estimate
    (``richardson_lucy.py:96-172``); ``psf`` corner-origin at the data's
    shape, or for a batch ``data`` (B, Nz, Ny, Nx) one shared volume PSF or
    one per lane.

    ``backprojector="wiener-butterworth"`` swaps the matched filter for
    :func:`wb_backprojector` (floor ``wb_beta``). ``stop``: ``"fixed"`` runs
    ``iterations``; ``"gaussian"`` stops once ``sum (Hx+bg-d)^2 <= stop_tau
    * N * sigma^2`` with sigma ``stop_sigma`` (one, or one per lane) or the
    blind estimate of :func:`jobs.autotune.estimate_noise_sigma`;
    ``"poisson"`` once ``2*sum(d*log(d/(Hx+bg)) + (Hx+bg) - d) <= stop_tau *
    N``. The residual is that of the model each update computes, so the
    crossing shows one update late; ``iterations`` stays the cap.
    ``return_iterations=True`` returns ``(x, k)`` with ``k`` the updates
    applied (an int, or a NumPy array of one per lane)."""
    lanes = data.ndim == 4
    if psf.shape != data.shape and not (lanes and psf.shape == data.shape[1:]):
        raise ValueError("richardson_lucy requires psf shape == data shape (or one volume's shape for a batch)")
    if stop not in _STOPS:
        raise ValueError(f"unknown stop {stop!r}")
    shape = tuple(data.shape[1:] if lanes else data.shape)
    rfftn, irfftn = _fft_pair(len(shape))
    k_hat = rfftn(psf)
    if backprojector == "wiener-butterworth":
        if k_hat.ndim > len(shape):
            k_hat_conj = torch.stack([wb_backprojector(k, shape, beta=wb_beta) for k in k_hat])
        else:
            k_hat_conj = wb_backprojector(k_hat, shape, beta=wb_beta)
        flux = torch.ones((), dtype=data.dtype, device=data.device)  # B(0) = 1 by construction
    elif backprojector == "matched":
        k_hat_conj = k_hat.conj()
        flux = psf.sum(dim=tuple(range(-len(shape), 0)))
    else:
        raise ValueError(f"unknown backprojector {backprojector!r}")

    def forward(y):
        return irfftn(k_hat * rfftn(y), shape)

    def backward(r):
        return irfftn(k_hat_conj * rfftn(r), shape)

    return _rl_engine(data, forward, backward, flux, iterations, background, mu, epsilon, x0, accelerate, stop,
                      stop_sigma, stop_tau, return_iterations, lanes=lanes)


def _rl_engine(data, forward, backward, flux, iterations, background, mu, epsilon, x0, accelerate, stop,
               stop_sigma, stop_tau, return_iterations, lanes: bool = False):
    """The RL fixed-point loop over an abstract linear operator
    (``richardson_lucy.py:175-287``): ``forward(y) = H y``, ``backward(r) =
    B r``, ``flux = B^T H 1`` (a scalar, one per lane, or a (Nz, 1, 1) z
    profile for the depth-varying operator of ``jobs/depthvar.py``). With ``lanes``
    the leading axis of ``data`` is a batch and every scalar of the loop is
    one per lane (``flux`` too, or one shared)."""
    if stop not in _STOPS:
        raise ValueError(f"unknown stop {stop!r}")
    dims = tuple(range(1, data.ndim)) if lanes else tuple(range(data.ndim))
    dtype, dev = data.dtype, data.device
    n = int(np.prod([data.shape[a] for a in dims]))

    def lane_sum(t):
        return t.sum(dim=dims)

    def per_voxel(t):
        """A per-lane scalar broadcast against the lanes' volumes."""
        return t.reshape(t.shape + (1,) * len(dims)) if t.ndim else t

    d = torch.clamp_min(data, 0.0)
    x = torch.clamp_min(data if x0 is None else x0, 1e-12)
    bg = float(background)
    tiny = torch.finfo(dtype).tiny
    # Data-scaled support threshold (``richardson_lucy.py:191-196``): FFT
    # roundoff leaves slightly negative model values on empty regions, and
    # flooring those at the dtype's tiny makes d/model explode in float32.
    eps = per_voxel(torch.clamp_min(1e-6 * (d.mean(dim=dims) + bg), tiny))
    flux = torch.as_tensor(flux, dtype=dtype, device=dev)
    if flux.ndim <= 1:  # one, or one a lane; a depth-varying H^T 1 is a z profile already
        flux = per_voxel(flux)

    if stop == "gaussian":
        if stop_sigma is None:
            sig = torch.stack([estimate_noise_sigma(v) for v in data]) if lanes else estimate_noise_sigma(data)
            sig = sig.to(dtype)
        else:
            sig = torch.as_tensor(stop_sigma, dtype=dtype, device=dev)
        target = torch.tensor(stop_tau * n, dtype=dtype, device=dev) * sig * sig
    elif stop == "poisson":
        target = torch.tensor(stop_tau * n, dtype=dtype, device=dev)
    else:
        target = None
    if target is not None and lanes:
        target = target.expand(data.shape[:1])

    def discrepancy(model):
        if stop == "gaussian":
            r = model - data
            return lane_sum(r * r)
        return 2.0 * lane_sum(torch.special.xlogy(d, d / torch.clamp_min(model, tiny)) + model - d)

    def update(y):
        model = forward(y) + bg
        ratio = torch.where(model > eps, d / torch.maximum(model, eps), torch.zeros((), dtype=dtype, device=dev))
        back = backward(ratio)
        denom = flux
        if mu > 0:
            _, tv_grad = (hyperbolic_tv_batched_fused if lanes else hyperbolic_tv_fused)(y, epsilon)
            denom = torch.maximum(flux + mu * tv_grad, 0.1 * flux)
        x_new = torch.clamp_min(y * back / denom, 0.0)
        return x_new, (discrepancy(model) if target is not None else None)

    def accelerated(state):
        """One Biggs-Andrews step from (x, x_prev, g1, g2, k): alpha_k =
        <g_{k-1}, g_{k-2}> / <g_{k-2}, g_{k-2}>, zero for the first two
        iterations, with g_k = x_{k+1} - y_k the raw fixed-point step."""
        x, x_prev, g1, g2, k = state
        num, den = lane_sum(g1 * g2), lane_sum(g2 * g2)
        alpha = torch.where((k >= 2) & (den > 0), torch.clamp(num / torch.clamp_min(den, tiny), 0.0, 0.999),
                            torch.zeros((), dtype=dtype, device=dev))
        y = torch.clamp_min(x + per_voxel(alpha) * (x - x_prev), 0.0)
        x_new, disc = update(y)
        return (x_new, x, x_new - y, g1, k + 1), disc

    def plain(state):
        x, k = state
        x_new, disc = update(x)
        return (x_new, k + 1), disc

    k0 = torch.zeros(data.shape[:1] if lanes else (), dtype=torch.int64, device=dev)
    state = (x, x, torch.zeros_like(x), torch.zeros_like(x), k0) if accelerate else (x, k0)
    step = accelerated if accelerate else plain
    if target is None:
        for _ in range(iterations):
            state, _ = step(state)
    else:
        # The JAX while_loop, per lane: a lane runs while it is under the cap
        # and its last discrepancy is above its target; one that stops keeps
        # its whole state. One host read an iteration.
        disc = torch.full_like(target, float("inf"))
        while True:
            active = (state[-1] < iterations) & (disc > target)
            if not bool(active.any()):
                break
            new, disc_new = step(state)
            state = tuple(torch.where(per_voxel(active) if s.ndim > active.ndim else active, a, s)
                          for a, s in zip(new, state))
            disc = torch.where(active, disc_new, disc)
    x_fin, k_fin = state[0], state[-1]
    if not return_iterations:
        return x_fin
    return x_fin, (k_fin.cpu().numpy() if lanes else int(k_fin))


def multiview_richardson_lucy(
    views: torch.Tensor,
    psfs: torch.Tensor,
    iterations: int = 50,
    background: float = 0.0,
    x0: torch.Tensor | None = None,
    backprojector: str = "matched",
    wb_beta: float = 0.1,
) -> torch.Tensor:
    """Joint-MLE RL fusion of K registered views, shapes ``(K,) + vol``
    (``richardson_lucy.py:290-349``): each view ``d_v`` observes the same
    object through its own corner-origin PSF, and

        x_{k+1} = x_k / (sum_v H_v^T 1) * sum_v H_v^T( d_v / (H_v x_k + bg) ).

    K = 1 reduces to :func:`richardson_lucy`. No discrepancy stop, as in the
    JAX module."""
    if views.shape != psfs.shape or views.ndim < 2:
        raise ValueError("views and psfs must share a (K,)+volume shape")
    vol = tuple(views.shape[1:])
    rfftn, irfftn = _fft_pair(len(vol))
    k_hat = rfftn(psfs)
    if backprojector == "wiener-butterworth":
        # per-view backprojectors; the fused denominator is sum_v B_v(0) = K
        k_hat_conj = torch.stack([wb_backprojector(k, vol, beta=wb_beta) for k in k_hat])
        flux = float(views.shape[0])
    elif backprojector == "matched":
        k_hat_conj = k_hat.conj()
        flux = psfs.sum()
    else:
        raise ValueError(f"unknown backprojector {backprojector!r}")
    d = torch.clamp_min(views, 0.0)
    # Mean-of-views start floored at a fraction of the mean intensity
    # (``richardson_lucy.py:329-335``): no absorbing zeros, bounded first
    # ratios in float32 on sparse scenes.
    x = torch.maximum(d.mean(dim=0), 1e-3 * d.mean() + 1e-12) if x0 is None else torch.clamp_min(x0, 1e-12)
    bg = float(background)
    eps = torch.clamp_min(1e-6 * (d.mean() + bg), torch.finfo(views.dtype).tiny)
    zero = torch.zeros((), dtype=views.dtype, device=views.device)
    for _ in range(iterations):
        model = irfftn(k_hat * rfftn(x)[None], vol) + bg
        ratio = torch.where(model > eps, d / torch.maximum(model, eps), zero)
        back = irfftn(k_hat_conj * rfftn(ratio), vol).sum(dim=0)
        x = torch.clamp_min(x * back / flux, 0.0)
    return x
