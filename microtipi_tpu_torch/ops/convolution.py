"""FFT-domain convolution data terms.

Port of ``microtipi_tpu/ops/convolution.py`` (TiPi's
``WeightedConvolutionCost`` as the reference uses it,
``microscopy/PSF_Estimation.java:147-157,206``):

    f(x) = 0.5 * alpha * sum_i  w_i * ((K (*) x)_i - d_i)^2

(or, for photon-counting data, the Poisson deviance of :class:`PoissonConvCost`)
with circular convolution by a corner-origin kernel ``K`` computed with real
FFTs (``torch.fft``: cuFFT on the card, pocketfft on the CPU). The same
object serves both sub-problems: in the object step the variable is the
object and the kernel the PSF; in the PSF fit the variable is the PSF and the
kernel the object (``PSF_Estimation.java:148,157``).

The two uniform-weight fast paths are ``torch.autograd.Function``s — the
counterparts of the JAX package's ``custom_vjp``s — whose forward yields the
cost and keeps the exact gradient, and whose backward is ``g * grad`` for the
first input only. Autograd carries on from that gradient, e.g. through
``compute_psf`` to the PSF parameters in a fit.

Batches: a 4D tensor is a stack of 3D volumes (lanes). The FFTs transform
the last three axes only, every cost comes back per lane, shape (B,), and the
kernel is shared (3D) or one per lane (4D). The batched object steps
(``jobs/batch.py``, ``jobs/tiled.py``) use this form; on 3D volumes nothing
changes. The JAX package gets the batch from ``jax.vmap``.

The TPU-only exact matmul-DFT switch (``exact``/``auto_exact_fft``,
``ops/exactfft.py``) is not ported: cuFFT is float32-exact (measured by
``chip_smoke.py`` phase 5).

``fft_calls`` counts the transforms the module's helpers take, one a call; a
run sets it to 0 and reads it to count a solve's FFTs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from microtipi_tpu_torch.utils.arrays import crop_to_shape

__all__ = [
    "PoissonConvCost",
    "QuadraticConvCost",
    "UniformConvCost",
    "WeightedConvolutionCost",
    "convolve",
    "convolve_spectrum",
    "generalized_kl",
    "select_lanes",
]


def _vdims(t: torch.Tensor) -> tuple[int, ...]:
    """The volume axes of ``t``: all of a 2D or 3D volume, the last three of
    a 4D batch."""
    return tuple(range(-min(t.ndim, 3), 0))


#: Transforms taken by :func:`_rfftn` and :func:`_irfftn` since the last reset (``fft_calls = 0``): one a
#: call, whatever its batch; autograd's transforms in a backward pass are not counted.
fft_calls = 0


def _rfftn(x: torch.Tensor) -> torch.Tensor:
    global fft_calls
    fft_calls += 1
    return torch.fft.rfftn(x, dim=_vdims(x))


def _irfftn(x_hat: torch.Tensor, shape) -> torch.Tensor:
    global fft_calls
    fft_calls += 1
    shape = tuple(shape)
    return torch.fft.irfftn(x_hat, s=shape, dim=tuple(range(-len(shape), 0)))


def _lane_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over each volume: a 0-dim tensor, or (B,) for a batch, in one
    reduction."""
    return t.sum(dim=_vdims(t))


def _lane_scaled(g: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``g * t`` with one ``g`` per lane: the backward of a per-lane cost."""
    return g.reshape(g.shape + (1,) * (t.ndim - g.ndim)) * t


def convolve_spectrum(kernel: torch.Tensor) -> torch.Tensor:
    """The rfftn spectrum of a corner-origin kernel (of each, for a batch)."""
    return _rfftn(kernel)


def convolve(x: torch.Tensor, kernel_hat: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """Circular convolution of ``x`` with a precomputed kernel spectrum;
    ``s=shape`` (one volume's shape) makes ``irfftn`` round-trip odd last
    axes."""
    return _irfftn(_rfftn(x) * kernel_hat, shape)


def _abs2(z: torch.Tensor) -> torch.Tensor:
    return z.real ** 2 + z.imag ** 2


def select_lanes(cost, idx: torch.Tensor):
    """The same cost over the lanes ``idx`` of a batch: its per-lane fields
    (a (B,) sum or a (B, ...) stack of volumes) are indexed, the shared ones
    (a 3D kernel spectrum) kept. Nothing is recomputed, so a lane's cost is
    the same whichever lanes are evaluated with it. A cost whose fields say
    otherwise (``ops/depthconv.py``) brings its own ``select_lanes``."""
    if hasattr(cost, "select_lanes"):
        return cost.select_lanes(idx)
    return cost._replace(**{
        k: v[idx] for k, v in cost._asdict().items() if isinstance(v, torch.Tensor) and v.ndim in (1, 4)
    })


def _check_kernel(kernel: torch.Tensor, data: torch.Tensor, what: str) -> None:
    """A kernel of the data's shape, or one 3D kernel shared by a batch."""
    if kernel.shape != data.shape and not (data.ndim == 4 and kernel.shape == data.shape[1:]):
        raise ValueError(f"{what} requires kernel shape == data shape (or one volume's shape for "
                         f"a batch), got {tuple(kernel.shape)} and {tuple(data.shape)}")


class WeightedConvolutionCost(NamedTuple):
    """Weighted FFT-convolution data term (``convolution.py:101-170``).

    ``weights`` None means uniform 1 (TiPi ``setWeights(null)``). Zero-weight
    voxels are excluded whatever their data value: a NaN voxel under weight
    0 would otherwise poison the cost through ``0 * NaN``. The gradient is
    plain autograd through the FFTs. ``var_shape`` is one volume's shape; for
    a batch it defaults to the data's trailing three axes.
    """

    kernel_hat: torch.Tensor
    data: torch.Tensor
    weights: torch.Tensor | None
    var_shape: tuple[int, ...]

    @classmethod
    def build(cls, kernel, data, weights=None, var_shape=None) -> "WeightedConvolutionCost":
        if var_shape is None:
            var_shape = tuple(data.shape[-3:])
        if tuple(kernel.shape[-len(var_shape):]) != tuple(var_shape):
            raise ValueError(
                f"kernel shape {tuple(kernel.shape)} != variable shape {tuple(var_shape)}; "
                "use utils.arrays.pad_fft_kernel to embed it"
            )
        if weights is not None and weights.shape != data.shape:
            raise ValueError("weights must match the data shape")
        if weights is not None:
            data = torch.where(weights > 0, data, torch.zeros_like(data))
        return cls(convolve_spectrum(kernel), data, weights, tuple(var_shape))

    def model(self, x: torch.Tensor) -> torch.Tensor:
        """Forward model H x = crop(K (*) x) at the data window."""
        hx = convolve(x, self.kernel_hat, self.var_shape)
        if hx.shape != self.data.shape:
            hx = crop_to_shape(hx, tuple(self.data.shape[-len(self.var_shape):]))
        return hx

    def cost(self, x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
        """0.5 * alpha * sum w * (H x - d)^2 (``PSF_Estimation.java:157,206``),
        per lane for a batch."""
        r = self.model(x) - self.data
        wr2 = r * r if self.weights is None else self.weights * r * r
        return 0.5 * alpha * _lane_sum(wr2)

    value = cost  # the cost alone, under torch.no_grad(): nothing to skip here


def generalized_kl(m: torch.Tensor, d: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Generalized Kullback-Leibler deviance ``sum (m - d) - d*log(m/d)``
    (``convolution.py:74-86``), per lane for a batch.

    The Poisson negative log-likelihood of ``d`` under mean ``m``, up to the
    x-independent constant; >= 0 with equality at m == d. ``d == 0`` voxels
    contribute exactly ``m``; the log is guarded at the dtype's smallest
    normal. ``mask`` (0/1) excludes voxels entirely.
    """
    tiny = torch.finfo(m.dtype).tiny
    m = torch.clamp_min(m, tiny)
    log_ratio = torch.log(m) - torch.log(torch.clamp_min(d, tiny))
    term = (m - d) - torch.where(d > 0, d * log_ratio, torch.zeros_like(d))
    return _lane_sum(term if mask is None else mask * term)


class PoissonConvCost(NamedTuple):
    """Poisson-likelihood data term (``convolution.py:173-227``): the
    generalized KL deviance of ``d ~ Poisson(H x + b)``,

        f(x) = sum_i  (m_i - d_i) - d_i * log(m_i / d_i),   m = H x + b.

    ``background`` b > 0 is recommended under the positivity bound (at b = 0
    a voxel with m -> 0 and d > 0 is an infinite barrier). The gradient is
    plain autograd through the FFTs.
    """

    kernel_hat: torch.Tensor
    data: torch.Tensor
    background: float
    var_shape: tuple[int, ...]

    @classmethod
    def build(cls, kernel, data, background: float = 0.0, var_shape=None) -> "PoissonConvCost":
        if var_shape is None:
            var_shape = tuple(data.shape[-3:])
        if tuple(kernel.shape[-len(var_shape):]) != tuple(var_shape):
            raise ValueError(
                f"kernel shape {tuple(kernel.shape)} != variable shape {tuple(var_shape)}; "
                "use utils.arrays.pad_fft_kernel to embed it"
            )
        if background < 0:
            raise ValueError("background must be >= 0")
        return cls(convolve_spectrum(kernel), data, float(background), tuple(var_shape))

    def model(self, x: torch.Tensor) -> torch.Tensor:
        hx = convolve(x, self.kernel_hat, self.var_shape)
        if hx.shape != self.data.shape:
            hx = crop_to_shape(hx, tuple(self.data.shape[-len(self.var_shape):]))
        return hx

    def cost(self, x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
        return alpha * generalized_kl(self.model(x) + self.background, self.data)

    value = cost


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> per volume (B,) or of one volume: the product summed by
    :func:`_lane_sum`, so a volume and a lane reduce alike."""
    return _lane_sum(a * b)


class _QuadraticCost(torch.autograd.Function):
    """0.5<x, A x> - <x, b> + c from one rfftn/irfftn pair; the gradient
    ``A x - b`` is the forward's by-product (``convolution.py:283-304``)."""

    @staticmethod
    def forward(ctx, x, kernel_sq, b, c, shape):
        ax = _irfftn(kernel_sq * _rfftn(x), shape)
        f = 0.5 * _dot(x, ax) - _dot(x, b) + c
        ctx.save_for_backward(ax - b)
        return f

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return _lane_scaled(g, grad), None, None, None, None


class QuadraticConvCost(NamedTuple):
    """Uniform-weight data term with the 2-FFT fused cost and gradient
    (``convolution.py:244-280``); variable grid == data grid only."""

    kernel_sq: torch.Tensor  # |K_hat|^2, rfftn layout
    b: torch.Tensor  # H^T d
    c: torch.Tensor  # 0.5 * sum(d^2), per lane for a batch
    shape: tuple[int, ...]  # one volume's

    @classmethod
    def build(cls, kernel, data) -> "QuadraticConvCost":
        _check_kernel(kernel, data, "quadratic fast path")
        shape = tuple(data.shape[-3:])
        k_hat = _rfftn(kernel)
        b = _irfftn(torch.conj(k_hat) * _rfftn(data), shape)
        return cls(_abs2(k_hat), b, 0.5 * _lane_sum(data * data), shape)

    def cost(self, x: torch.Tensor) -> torch.Tensor:
        return _QuadraticCost.apply(x, self.kernel_sq, self.b, self.c, self.shape)

    value = cost


def _residual_cost(x_hat, kernel_hat, data, shape) -> torch.Tensor:
    """0.5||K(*)x - d||^2 from the spectrum of x, per lane for a batch."""
    r = _irfftn(kernel_hat * x_hat, shape) - data
    return 0.5 * _lane_sum(r * r)


class _UniformCost(torch.autograd.Function):
    """0.5||K(*)x - d||^2 from the residual (no cancellation), gradient
    ``irfftn(|K|^2 X) - b`` from the same forward spectrum
    (``convolution.py:344-364``)."""

    @staticmethod
    def forward(ctx, x, kernel_hat, kernel_sq, b, data, shape):
        x_hat = _rfftn(x)
        ctx.save_for_backward(_irfftn(kernel_sq * x_hat, shape) - b)
        return _residual_cost(x_hat, kernel_hat, data, shape)

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return _lane_scaled(g, grad), None, None, None, None, None


class UniformConvCost(NamedTuple):
    """Residual-accurate uniform-weight data term, 3 FFTs per evaluation
    (``convolution.py:318-341``)."""

    kernel_hat: torch.Tensor
    kernel_sq: torch.Tensor
    b: torch.Tensor
    data: torch.Tensor
    shape: tuple[int, ...]

    @classmethod
    def build(cls, kernel, data) -> "UniformConvCost":
        _check_kernel(kernel, data, "uniform fast path")
        shape = tuple(data.shape[-3:])
        k_hat = _rfftn(kernel)
        b = _irfftn(torch.conj(k_hat) * _rfftn(data), shape)
        return cls(k_hat, _abs2(k_hat), b, data, shape)

    def cost(self, x: torch.Tensor) -> torch.Tensor:
        return _UniformCost.apply(x, self.kernel_hat, self.kernel_sq, self.b, self.data, self.shape)

    def value(self, x: torch.Tensor) -> torch.Tensor:
        """The cost alone from 2 FFTs, without the gradient that
        :meth:`cost` prepares (the primal of ``_uniform_cost``,
        ``convolution.py:344-348``)."""
        return _residual_cost(_rfftn(x), self.kernel_hat, self.data, self.shape)
