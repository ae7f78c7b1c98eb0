"""How ``correct`` is decided: each answer the window kept is judged by its
entry's checker (``entries/<entry>.py``) against the plain reference in
float64, which gives numbers, each a relative gap; the cell holds some of
them under the limits of ``limits/<cell>.json``. Numbers the limits do not
name (such as the restoration error to the scene's truth) are recorded
beside them and held to no limit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["finite", "gap", "judge", "rel"]


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """``||a - b|| / ||b||`` in float64."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def gap(a: float, b: float) -> float:
    """``|a - b| / |b|``; infinite where ``a`` is not finite."""
    return abs(float(a) - float(b)) / abs(float(b)) if np.isfinite(a) else math.inf


def finite(ans) -> bool:
    """Whether an answer's object and reported objective are all finite."""
    return bool(torch.isfinite(ans.x).all()) and bool(np.all(np.isfinite(ans.f)))


def judge(readings: list[dict], limits: dict) -> tuple[bool, dict]:
    """``(correct, checks)``: each limited number's worst reading over the
    answers beside its limit (None where it is not finite). Correct when
    every one is finite and within its limit, and there was an answer to
    judge."""
    checks, ok = {}, bool(readings)
    if any("finite" in r for r in readings):
        checks["finite"] = {"value": None, "limit": 0.0}
        ok = False
    for name, spec in limits.items():
        vals = [r[name] for r in readings if name in r]
        value = max(vals) if vals else math.inf
        is_finite = bool(np.isfinite(value))
        checks[name] = {"value": value if is_finite else None, "limit": spec["limit"]}
        ok = ok and is_finite and value <= spec["limit"]
    return ok, checks
