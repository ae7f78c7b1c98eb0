"""Carry PSF parameters and configurations between the packages.

The JAX package's params tuples and model configs cross over as NumPy arrays
and plain fields, so both packages compute from the same state without this
module importing jax: anything with ``defocus``/``phase``/``modulus``
attributes (and whichever of ``depth``, ``sheet``, ``sted`` and ``cavity`` it
has) that ``np.asarray`` accepts converts to the port's params tuple of those
fields, and :func:`anchors_to_torch` carries a field calibration's anchors
across. :func:`family_config_from_fields` maps a JAX family config to the
port's config of the same class name. The solver configurations
(``DeconvolutionConfig``, ``PsfFitConfig``, ``BlindDeconvConfig``) and the
``InverseVarianceWeights`` model cross over field by field, by name: the port
keeps its own classes, and a field the port does not have is left behind.
The streamed fit statistics of the out-of-core blind loop
(:func:`fit_stats_to_torch`) and a retrieved pupil
(:func:`pupil_result_to_torch`) cross over from their NumPy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from microtipi_tpu_torch.jobs.blind import BlindDeconvConfig
from microtipi_tpu_torch.jobs.deconv import DeconvolutionConfig
from microtipi_tpu_torch.jobs.phase_retrieval import PupilRetrievalResult
from microtipi_tpu_torch.jobs.psf_fit import PsfFitConfig
from microtipi_tpu_torch.jobs.tiled_blind import FitStats
from microtipi_tpu_torch.models import MODELS
from microtipi_tpu_torch.models.fourpi import FourPiParams
from microtipi_tpu_torch.models.gibson_lanni import GibsonLanniParams
from microtipi_tpu_torch.models.lightsheet import LightSheetParams
from microtipi_tpu_torch.models.sted import STEDParams
from microtipi_tpu_torch.models.widefield import WideFieldConfig, WideFieldParams
from microtipi_tpu_torch.weights.updaters import InverseVarianceWeights

__all__ = ["anchors_to_torch", "blind_config_from_fields", "config_fields", "config_from_fields",
           "deconv_config_from_fields", "family_config_from_fields", "fit_stats_to_torch", "params_to_numpy",
           "params_to_torch", "pupil_result_to_torch", "weights_from_fields"]

_CONFIG_FIELDS = ("shape", "na", "wavelength", "ni", "dxy", "dz", "n_phase", "n_modulus", "radial")
_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


# Each params tuple of the port, by its extension family (None: wide-field).
_PARAMS = {None: WideFieldParams, "depth": GibsonLanniParams, "sheet": LightSheetParams, "sted": STEDParams,
           "cavity": FourPiParams}


def _params_class(params):
    """The port's params tuple with the fields that ``params`` has."""
    extra = [name for name in _PARAMS if name is not None and hasattr(params, name)]
    if len(extra) > 1:
        raise ValueError(f"params carry more than one extension family: {extra}")
    return _PARAMS[extra[0] if extra else None]


def params_to_torch(params, device=None, dtype: torch.dtype = torch.float64):
    """The port's params from any object with ``defocus``/``phase``/
    ``modulus`` and at most one of ``depth``/``sheet``/``sted``/``cavity``."""
    cls = _params_class(params)
    return cls(*(torch.as_tensor(np.array(getattr(params, name)), dtype=dtype, device=device)
                 for name in cls._fields))


def anchors_to_torch(anchors, device=None, dtype: torch.dtype = torch.float64) -> list:
    """A field calibration ``[((y, x), params), ...]`` (the JAX
    ``calibrate_field``'s anchors) with the port's params, for
    ``jobs.tiled.field_psf``; a fit's params alone go through
    :func:`params_to_torch`."""
    return [((float(pos[0]), float(pos[1])), params_to_torch(p, device, dtype)) for pos, p in anchors]


def params_to_numpy(params) -> dict[str, np.ndarray]:
    """Every family of ``params`` as NumPy arrays, by name; the JAX params
    tuple of the same fields takes them back (``GibsonLanniParams(**result)``)."""
    def arr(v):
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    return {name: arr(getattr(params, name)) for name in _params_class(params)._fields}


def config_from_fields(cfg, dtype: torch.dtype | None = None) -> WideFieldConfig:
    """The port's config from a config with the JAX ``WideFieldConfig``'s
    fields; ``dtype`` None maps the source's float dtype."""
    fields = {name: getattr(cfg, name) for name in _CONFIG_FIELDS}
    fields["shape"] = tuple(int(s) for s in fields["shape"])
    if dtype is None:
        dtype = _TORCH_DTYPES[np.dtype(getattr(cfg, "dtype", np.float32))]
    return WideFieldConfig(**fields, dtype=dtype)


def config_fields(cfg: WideFieldConfig) -> dict:
    """The port config's fields with a NumPy dtype, e.g. for
    ``microtipi_tpu.models.widefield.WideFieldConfig(**config_fields(cfg))``."""
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    out["dtype"] = np.float64 if cfg.dtype == torch.float64 else np.float32
    return out


def family_config_from_fields(cfg, dtype: torch.dtype | None = None):
    """The port's config of the class named like ``cfg``'s (a JAX
    ``GibsonLanniConfig`` gives the port's ``GibsonLanniConfig``), from its
    fields; ``dtype`` None maps the source's float dtype."""
    classes = {cls.__name__: cls for cls in MODELS}
    name = type(cfg).__name__
    if name not in classes:
        raise ValueError(f"no port of the config class {name!r}")
    if dtype is None:
        dtype = _TORCH_DTYPES[np.dtype(getattr(cfg, "dtype", np.float32))]
    cls = classes[name]
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cls) if f.name != "dtype"}
    fields["shape"] = tuple(int(s) for s in fields["shape"])
    return cls(**fields, dtype=dtype)


def _from_fields(cls, src, **overrides):
    """``cls(...)`` from the attributes of ``src`` named like ``cls``'s fields."""
    fields = {f.name: getattr(src, f.name) for f in dataclasses.fields(cls) if hasattr(src, f.name)}
    fields.update(overrides)
    return cls(**fields)


def deconv_config_from_fields(cfg) -> DeconvolutionConfig:
    """The port's object-step config from one with the JAX
    ``DeconvolutionConfig``'s fields (the TPU-only switches stay behind)."""
    return _from_fields(DeconvolutionConfig, cfg)


def blind_config_from_fields(cfg) -> BlindDeconvConfig:
    """The port's blind-loop config from one with the JAX
    ``BlindDeconvConfig``'s fields, its ``deconv`` and ``fit`` included."""
    return _from_fields(BlindDeconvConfig, cfg, deconv=deconv_config_from_fields(cfg.deconv),
                        fit=_from_fields(PsfFitConfig, cfg.fit))


def weights_from_fields(model) -> InverseVarianceWeights:
    """The port's weight model from one with ``gain``/``readout_variance``/
    ``saturation`` (the JAX ``InverseVarianceWeights``)."""
    return _from_fields(InverseVarianceWeights, model)


def fit_stats_to_torch(stats, device=None) -> FitStats:
    """The port's ``jobs.tiled_blind.FitStats`` from one with ``rho``/``b``
    arrays, ``c`` and the three shapes (the JAX ``FitStats``), float64."""
    def arr(a):
        return torch.as_tensor(np.array(a), dtype=torch.float64, device=device)

    return FitStats(arr(stats.rho), arr(stats.b), float(stats.c), tuple(stats.g_shape), tuple(stats.psf_shape),
                    tuple(stats.volume_shape))


def pupil_result_to_torch(result, device=None, dtype: torch.dtype = torch.float64) -> PupilRetrievalResult:
    """The port's ``jobs.phase_retrieval.PupilRetrievalResult`` from one with
    the same fields (the JAX one): maps and PSF as tensors, the counts as
    ints."""
    def arr(a):
        return None if a is None else torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return PupilRetrievalResult(arr(result.phi), arr(result.rho), arr(result.mask), arr(result.psf),
                                np.asarray(result.f)[()], int(result.iterations), int(result.evaluations),
                                int(result.status))
