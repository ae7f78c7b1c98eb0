"""Joint time-series deconvolution with a temporal prior (4D solve).

Port of ``microtipi_tpu/jobs/timeseries.py``. Live-cell frames are strongly
correlated, so a joint solve over the (T, Nz, Ny, Nx) block with an
edge-preserving prior along t lets every frame borrow photons from its
neighbours without smearing events (appearance, division, fusion survive as
steps while uncorrelated noise averages down):

    f(x) = sum_t [ 0.5 ||g_t H x_t - d_t||^2_w  +  mu * TV_eps(x_t) ]
           + mu_t * TV_eps_t(x; along t only),      x >= 0

One VMLMB run over the whole 4D tensor with one scalar f. The spatial TV of
the frames is one launch of the batched TV kernel over the T lanes, summed;
the temporal TV and the priors are PyTorch operators. The objective is the
C = 1 case of ``jobs.multichannel.make_tsmc_objective`` (the JAX package
pins that the two agree): the same per-frame data term with its quadratic
fast path, residual form, weighted form and Poisson deviance, and the same
priors.
"""

from __future__ import annotations

import torch

from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig, DeconvolutionResult
from microtipi_tpu_torch.jobs.multichannel import _vmlmb_result, make_tsmc_objective
from microtipi_tpu_torch.optim.treeutil import value_and_grad

__all__ = ["deconvolve_timeseries", "make_timeseries_objective"]


def as_channel_block(data: torch.Tensor, weights, bleach):
    """A (T, Nz, Ny, Nx) series and its per-frame weights and gains as the
    one-channel (T, 1, Nz, Ny, Nx) block of the joint 5D solvers. ``weights``
    may be (T,)+vol or one volume, ``bleach`` (T,) gains."""
    if data.ndim != 4:
        raise ValueError(f"expected a (T, Nz, Ny, Nx) stack, got {tuple(data.shape)}")
    if weights is not None and weights.ndim == 4:
        weights = weights[:, None]
    if bleach is not None:
        bleach = torch.as_tensor(bleach, dtype=data.dtype, device=data.device)
        if tuple(bleach.shape) != (data.shape[0],):
            raise ValueError(f"bleach must be per-frame gains of shape ({data.shape[0]},), got {tuple(bleach.shape)}")
        bleach = bleach[:, None]
    return data[:, None], weights, bleach


def _objective(psf, data, weights, config: DeconvolutionConfig, mu_t, epsilon_t, bleach, accurate):
    if config.var_shape is not None:
        raise ValueError("var_shape is not supported for the joint 4D solve; pad the input data instead")
    data5, weights5, bleach5 = as_channel_block(data, weights, bleach)
    objective, _ = make_tsmc_objective(psf, data5, weights5, config, mu_t=mu_t, epsilon_t=epsilon_t, bleach=bleach5,
                                       coupling="separate", accurate=accurate)
    return lambda x: objective(x[:, None])


def make_timeseries_objective(
    psf: torch.Tensor,
    data: torch.Tensor,
    weights: torch.Tensor | None,
    config: DeconvolutionConfig,
    *,
    mu_t: float = 0.0,
    epsilon_t: float | None = None,
    bleach=None,
    accurate: bool = False,
):
    """The ``x -> (f, grad f)`` closure of the joint 4D objective
    (``timeseries.py:130-229``); ``accurate`` takes the residual form of the
    uniform data term (cancellation-free float32 values)."""
    return value_and_grad(_objective(psf, data, weights, config, mu_t, epsilon_t, bleach, accurate))


def deconvolve_timeseries(
    data: torch.Tensor,
    psf: torch.Tensor,
    weights: torch.Tensor | None = None,
    x0: torch.Tensor | None = None,
    config: DeconvolutionConfig = DeconvolutionConfig(),
    *,
    mu_t: float = 0.0,
    epsilon_t: float | None = None,
    bleach=None,
) -> DeconvolutionResult:
    """Jointly deconvolve a (T,) + volume stack sharing one PSF
    (``timeseries.py:77-127``). ``mu_t`` weighs the temporal hyperbolic TV
    (0: decoupled frames, the batched solve's objective); ``epsilon_t`` is
    its edge threshold in intensity units (None: ``config.epsilon``).
    ``weights`` may be (T,)+vol or one volume; ``bleach`` are per-frame
    photobleaching gains (T,) in the model, ``g_t (H x_t)``, so the frames
    share one intensity scale. One VMLMB run with one joint cost; ``x`` is
    (T,)+vol, on the device of its tensors."""
    objective = _objective(psf, data, weights, config, mu_t, epsilon_t, bleach, False)
    return _vmlmb_result(objective, data if x0 is None else x0, config)
