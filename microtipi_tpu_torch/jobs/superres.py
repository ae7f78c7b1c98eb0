"""Finer-grid ("super-resolution") deconvolution: solve below the camera pixel.

Port of ``microtipi_tpu/jobs/superres.py``. The forward model puts the object
on an f-times finer lattice than the camera's,

    d  =  Bin_f( h_fine (*) x_fine ) + noise,

where ``Bin_f`` sums each camera pixel's f_z x f_y x f_x block of fine voxels
and ``h_fine`` is the PSF at the fine pitch (a pupil model synthesizes it at
``dxy / f``). Where the camera undersamples the optics the fine grid recovers
frequencies the coarse grid aliases; at adequate sampling it still places
point sources at their sub-pixel positions.

Everything is the ordinary circulant solve at the fine size plus a
reshape-sum and its broadcast adjoint. The TV goes through
``jobs.deconv.make_regularizer``, so the fused TV kernel runs on the fine
grid (a larger share of each evaluation than on the camera's). The ADMM
engine splits ``z0 = h_fine (*) x`` on the fine grid, whose binned data term
has a per-block closed-form prox, and runs the two ADMM kernels with B = 1.
"""

from __future__ import annotations

import math

import torch

from microtipi_tpu_torch.jobs.admm import _admm_loop, _check_config, _rho0
from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, DeconvolutionResult, has_regularizer, make_regularizer
from microtipi_tpu_torch.jobs.multichannel import _vmlmb_result
from microtipi_tpu_torch.ops import convolution as conv
from microtipi_tpu_torch.utils.arrays import pad_fft_kernel

__all__ = ["admm_deconvolve_superres", "bin_volume", "deconvolve_superres", "make_superres_objective", "upsample_psf",
           "upsample_volume"]


def upsample_psf(psf: torch.Tensor, factor: tuple[int, int, int]) -> torch.Tensor:
    """Band-limited (Fourier zero-pad) upsampling of a measured corner-origin
    PSF to the fine grid (``superres.py:47-97``). Exact when the coarse
    measurement sampled the PSF adequately; an undersampled measurement's
    aliasing cannot be unfolded (synthesize the fine PSF from a fitted model
    instead). Even-size Nyquist bins are halved and duplicated so the result
    is real; sinc-ringing negatives are clamped. The sum is preserved, so
    per-voxel values scale by 1/f^3, as the pupil models' own PSFs do.
    complex128 for float64 input, complex64 otherwise."""
    factor = tuple(int(v) for v in factor)
    n = tuple(psf.shape)
    spec = torch.fft.fftn(psf.to(torch.complex128 if psf.dtype == torch.float64 else torch.complex64))
    even = [ax for ax, (size, f) in enumerate(zip(n, factor)) if f > 1 and size % 2 == 0]
    for ax in even:  # halve the even-size Nyquist bins before the split below
        spec.select(ax, n[ax] // 2).mul_(0.5)
    lows = [(size * f - size + 1) // 2 for size, f in zip(n, factor)]
    big = spec.new_zeros(tuple(size * f for size, f in zip(n, factor)))
    big[tuple(slice(lo, lo + size) for lo, size in zip(lows, n))] = torch.fft.fftshift(spec)
    for ax in even:  # duplicate the (halved) -N/2 bin at +N/2 so the interpolation stays real
        big.select(ax, lows[ax] + n[ax]).copy_(big.select(ax, lows[ax]))
    out = torch.fft.ifftn(torch.fft.ifftshift(big)).real
    return torch.clamp_min(out.to(psf.dtype), 0.0)


def bin_volume(x: torch.Tensor, factor: tuple[int, int, int]) -> torch.Tensor:
    """Sum each f_z x f_y x f_x fine-grid block into its camera pixel."""
    fz, fy, fx = factor
    nz, ny, nx = x.shape
    return x.reshape(nz // fz, fz, ny // fy, fy, nx // fx, fx).sum(dim=(1, 3, 5))


def upsample_volume(d: torch.Tensor, factor: tuple[int, int, int]) -> torch.Tensor:
    """Replicate each camera pixel over its block, divided by the block size,
    so that ``bin_volume(upsample_volume(d)) == d``; times the block size it
    is the adjoint of :func:`bin_volume`."""
    fz, fy, fx = factor
    up = d[:, None, :, None, :, None].expand(d.shape[0], fz, d.shape[1], fy, d.shape[2], fx)
    return (up / (fz * fy * fx)).reshape(d.shape[0] * fz, d.shape[1] * fy, d.shape[2] * fx)


def _check_superres(data, psf_fine, factor, config: DeconvolutionConfig):
    """Shared validation (``superres.py:163-181``); returns (factor, fine_shape)."""
    if data.ndim != 3:
        raise ValueError(f"expected a (Nz, Ny, Nx) volume, got {tuple(data.shape)}")
    if config.var_shape is not None:
        raise ValueError("var_shape is not supported on the superres path; pad the data instead")
    factor = tuple(int(f) for f in factor)
    if min(factor) < 1:
        raise ValueError(f"factor components must be >= 1, got {factor}")
    if factor == (1, 1, 1):
        raise ValueError("factor (1, 1, 1) is the ordinary solve; use deconvolve")
    fine_shape = tuple(f * s for f, s in zip(factor, data.shape))
    if tuple(psf_fine.shape) != fine_shape:
        raise ValueError(f"psf_fine shape {tuple(psf_fine.shape)} != fine grid {fine_shape} "
                         f"(= factor {factor} x data {tuple(data.shape)})")
    return factor, fine_shape


def make_superres_objective(psf_fine, data, weights, config: DeconvolutionConfig, factor):
    """The fine-grid objective ``x -> f`` (``superres.py:184-234``), a 0-dim
    tensor autograd differentiates: the (weighted) Gaussian or Poisson term
    of the binned model, plus mu * TV (the fused kernel) and the priors."""
    factor, fine_shape = _check_superres(data, psf_fine, factor, config)
    k_hat = conv._rfftn(pad_fft_kernel(psf_fine, fine_shape))

    def model(x):
        return bin_volume(conv._irfftn(k_hat * conv._rfftn(x), fine_shape), factor)

    if config.data_term == "poisson":
        if weights is not None:
            raise ValueError("data_term='poisson' does not compose with weights")
        bg, counts = float(config.background), torch.clamp_min(data, 0.0)

        def data_term(x):
            return conv.generalized_kl(model(x) + bg, counts)
    elif config.data_term != "gaussian":
        raise ValueError(f"unknown data_term {config.data_term!r}")
    else:
        if weights is not None:  # zero weight excludes the pixel (0 * NaN would defeat the mask)
            data = torch.where(weights > 0, data, torch.zeros_like(data))

        def data_term(x):
            r = model(x) - data
            return 0.5 * torch.sum(r * r if weights is None else weights * r * r)

    reg = make_regularizer(config)

    def objective(x):
        f = data_term(x)
        if has_regularizer(config):
            f = f + reg(x)
        return f

    return objective


def deconvolve_superres(
    data: torch.Tensor,
    psf_fine: torch.Tensor,
    factor: tuple[int, int, int] = (1, 2, 2),
    weights: torch.Tensor | None = None,
    x0: torch.Tensor | None = None,
    config: DeconvolutionConfig = DeconvolutionConfig(),
) -> DeconvolutionResult:
    """Deconvolve onto a ``factor``-times finer object grid by VMLMB
    (``superres.py:120-160``). ``psf_fine`` is the corner-origin PSF at the
    fine pitch and shape ``factor * data.shape``; ``weights`` live on the
    data grid; ``config.scales`` should be the fine pitches. Without ``x0``
    the solve starts from ``upsample_volume(data)``. Returns the fine-grid
    object, on the device of its tensors."""
    objective = make_superres_objective(psf_fine, data, weights, config, factor)
    return _vmlmb_result(objective, upsample_volume(data, factor) if x0 is None else x0, config)


def admm_deconvolve_superres(
    data: torch.Tensor,
    psf_fine: torch.Tensor,
    factor: tuple[int, int, int] = (1, 2, 2),
    weights: torch.Tensor | None = None,
    x0: torch.Tensor | None = None,
    config: DeconvolutionConfig = DeconvolutionConfig(),
    *,
    rho0: float | None = None,
    rho1: float | None = None,
    rho2: float | None = None,
    over_relax: float = 1.8,
    track_objective: bool = True,
) -> DeconvolutionResult:
    """The ADMM engine of the finer-grid solve (``superres.py:237-454``),
    same objective as :func:`deconvolve_superres`. The split ``z0 = h_fine
    (*) x`` lives on the fine grid, so the x-update is the plain fine-grid
    circulant solve, and ``Bin^T Bin`` is rank one on each block, so the
    data term's prox is per block (Sherman-Morrison):

        z = v - w (sum_block v - d) / (rho0 + w n),   n = fz*fy*fx,

    (Poisson: the binned intensity solves the 3D engine's quadratic-root
    prox at ``rho0 / n``, spread evenly over its block). An iteration is 4
    fine-grid FFTs, the data prox, and the ``admm_rhs`` and
    ``admm_split_update`` kernels with B = 1 on a card. ``config.max_iter``
    iterations, or the Boyd test under ``admm_abstol``/``admm_reltol``; the
    tracked ``f_history`` costs one TV launch an iteration. The loop is the
    joint engines' (``jobs.admm._admm_loop``) on a (1, 1) block of the fine
    grid, with this data prox."""
    _check_config(config, "admm")
    if weights is not None:  # zero weight excludes the camera pixel (0 * NaN would poison the block prox)
        data = torch.where(weights > 0, data, torch.zeros_like(data))
    factor, fine_shape = _check_superres(data, psf_fine, factor, config)
    nblk = math.prod(factor)
    bg, poisson = float(config.background), config.data_term == "poisson"
    r0 = _rho0(rho0, config, data.mean() / nblk, weights)
    objective_grad = make_superres_objective(psf_fine, data, weights, config, factor)

    def objective(x):
        with torch.no_grad():
            return objective_grad(x[0, 0])

    w_d = 1.0 if weights is None else weights

    def data_prox(v):
        """The per-block prox of the binned data term (see the docstring)."""
        s_v = bin_volume(v[0, 0], factor)
        if poisson:
            rr = r0 / nblk
            b_coef = 1.0 + rr * (bg - s_v)
            c_coef = bg - data - rr * s_v * bg
            disc = torch.clamp_min(b_coef * b_coef - 4.0 * rr * c_coef, 0.0)
            corr = ((-b_coef + torch.sqrt(disc)) / (2.0 * rr) - s_v) / nblk
        else:
            corr = -w_d * (s_v - data) / (r0 + w_d * nblk)
        return v + upsample_volume(corr, factor) * nblk

    if x0 is None:
        x0 = upsample_volume(data, factor)
        if config.positivity:
            x0 = torch.clamp_min(x0, 0.0)
    k_hat = conv._rfftn(pad_fft_kernel(psf_fine, fine_shape))
    res = _admm_loop(objective, k_hat[None], x0.to(data.dtype).contiguous()[None, None], config, data_prox=data_prox,
                     r0=r0, data=None, coupling="separate", mu_t=0.0, epsilon_t=None, rho1=rho1, rho1t=None,
                     rho2=rho2, over_relax=over_relax, track_objective=track_objective)
    return res._replace(x=res.x[0, 0])
