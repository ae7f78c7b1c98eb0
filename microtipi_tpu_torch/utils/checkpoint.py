"""Step-level checkpoint/resume for long blind-deconvolution runs.

The reference has no persistence at all — its closest affordance is the
in-memory restore-best-x (``PSF_Estimation.java:208-216,254``) (SURVEY.md
section 5-d). Here every outer round's state (object estimate + PSF
parameters + round counter) can be serialized, so a preempted multi-hour run
resumes instead of restarting.

Port of ``microtipi_tpu/utils/checkpoint.py``: a plain ``.npz`` with the same
keys (``obj``, ``params.defocus|phase|modulus``, ``round_index``,
``extra.*``), so a checkpoint written by either package loads in the other
(``tests/test_torch_utils.py``). Tensors are saved from wherever they lie;
:func:`load_state` puts them on the card unless the caller names a device.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from microtipi_tpu_torch.models.widefield import WideFieldParams

__all__ = ["save_state", "load_state"]


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def save_state(path: str, obj: Any, params: WideFieldParams, round_index: int, **extra) -> None:
    """Atomically write a blind-deconv checkpoint (object, params, round)."""
    payload = {
        "obj": _numpy(obj),
        "params.defocus": _numpy(params.defocus),
        "params.phase": _numpy(params.phase),
        "params.modulus": _numpy(params.modulus),
        "round_index": np.asarray(round_index),
    }
    for k, v in extra.items():
        payload[f"extra.{k}"] = _numpy(v)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_state(path: str, device: torch.device | str | None = None):
    """Returns ``(obj, params, round_index, extra_dict)``: the object and the
    params as tensors on ``device`` (None: the card), ``extra`` as NumPy."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("load_state puts the state on the CUDA card by default and none is available; "
                               "pass device='cpu' to load it on the CPU")
        device = torch.device("cuda")
    with np.load(path) as z:
        obj = torch.as_tensor(z["obj"], device=device)
        params = WideFieldParams(*(torch.as_tensor(z[f"params.{name}"], device=device)
                                   for name in WideFieldParams._fields))
        round_index = int(z["round_index"])
        extra = {k[len("extra."):]: z[k] for k in z.files if k.startswith("extra.")}
    return obj, params, round_index, extra
