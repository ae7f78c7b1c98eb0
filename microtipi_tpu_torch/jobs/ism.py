"""ISM / Airyscan reconstruction: pixel reassignment and the joint multi-element MLE.

Port of ``microtipi_tpu/jobs/ism.py``, on the port's ``models/ism.ISMModel``:

- :func:`ism_reassign`: classical pixel reassignment (Sheppard 1988; Mueller
  and Enderlein 2010), element image k shifted back by ``reassign_factor *
  d_k`` and summed, one batched rFFT pair; the result's PSF is
  ``ISMModel.compute_psf``, ready for every solver of the port;
- :func:`ism_richardson_lucy`: the joint Poisson MLE over the K raw element
  images through their own PSFs, ``jobs.richardson_lucy.
  multiview_richardson_lucy`` with one view an element;
- :func:`ism_element_gains`: the elements' relative gains from their totals.

Data are ``(K,) + (Nz, Ny, Nx)`` in the element order of
``ISMConfig.offsets()`` (centre-out hex), on the model's device.
"""

from __future__ import annotations

import torch

from microtipi_tpu_torch.jobs.richardson_lucy import multiview_richardson_lucy
from microtipi_tpu_torch.utils.arrays import median

__all__ = ["ism_element_gains", "ism_reassign", "ism_richardson_lucy"]


def _elements(model, data) -> torch.Tensor:
    return torch.as_tensor(data, dtype=model.dtype, device=model.device)


def _check(model, d: torch.Tensor) -> None:
    k = model.config.n_elements
    if d.ndim != 4 or d.shape[0] != k or tuple(d.shape[1:]) != tuple(model.shape):
        raise ValueError(f"data must be ({k},) + {tuple(model.shape)} (centre-out element order, "
                         f"ISMConfig.offsets()), got {tuple(d.shape)}")


def ism_element_gains(model, params, data, background="none") -> torch.Tensor:
    """Relative detector-element gains ``(K,)``, mean 1 (``ism.py:35-78``):
    every element images the same object through a flux-preserving
    convolution, so element k's share of the light is ``F_k = sum h_k`` and
    ``g_k ~ sum(data_k) / F_k``. ``background``: "none" (dark-subtracted
    data), a scalar or ``(K,)`` dark levels (subtracted), or "median" (each
    element's median, for sparse scenes only)."""
    d = _elements(model, data)
    k = d.shape[0]
    if isinstance(background, str):
        if background == "median":
            d = d - median(d.reshape(k, -1), dim=1)[:, None, None, None]
        elif background != "none":
            raise ValueError(f"unknown background mode {background!r}")
    else:
        b = torch.broadcast_to(torch.as_tensor(background, dtype=model.dtype, device=model.device), (k,))
        d = d - b[:, None, None, None]
    totals = torch.sum(d, dim=(1, 2, 3))
    with torch.no_grad():
        share = torch.sum(model.compute_psfs(params), dim=(1, 2, 3))
    g = totals / torch.clamp_min(share, torch.finfo(d.dtype).tiny)
    return g / torch.mean(g)


def ism_reassign(model, data, factor: float | None = None, gains=None) -> torch.Tensor:
    """The ISM image (``ism.py:81-116``): element k shifted by ``-factor *
    d_k`` (default ``reassign_factor``) by an rfft2 phase ramp, then summed.
    ``gains`` (:func:`ism_element_gains`) divide each image first; an element
    whose gain is at most 1e-3 (dead) is left out rather than divided."""
    if factor is None:
        factor = model.config.reassign_factor
    d = _elements(model, data)
    if gains is not None:
        gc = torch.as_tensor(gains, dtype=model.dtype, device=model.device)[:, None, None, None]
        live = gc > 1e-3
        d = torch.where(live, d / torch.where(live, gc, torch.ones_like(gc)), torch.zeros_like(d))
    _check(model, d)
    _, ny, nx = model.shape
    ramps = torch.as_tensor(model.config.shift_ramps(-factor), dtype=model.cdtype, device=model.device)[:, None]
    out = torch.fft.irfft2(torch.fft.rfft2(d) * ramps, s=(ny, nx))
    return torch.sum(out, dim=0)


def ism_richardson_lucy(
    model,
    params,
    data,
    iterations: int = 50,
    background: float = 0.0,
    x0: torch.Tensor | None = None,
    backprojector: str = "matched",
    wb_beta: float = 0.1,
    gains=None,
) -> torch.Tensor:
    """Joint Poisson-MLE Richardson-Lucy over the K raw element images
    (``ism.py:119-144``): the element PSFs at ``params``, scaled by
    ``gains`` when given, as the views of ``multiview_richardson_lucy``,
    whose options pass through."""
    d = _elements(model, data)
    _check(model, d)
    with torch.no_grad():
        psfs = model.compute_psfs(params)
    if gains is not None:
        psfs = psfs * torch.as_tensor(gains, dtype=model.dtype, device=model.device)[:, None, None, None]
    return multiview_richardson_lucy(d, psfs, iterations=iterations, background=background, x0=x0,
                                     backprojector=backprojector, wb_beta=wb_beta)
