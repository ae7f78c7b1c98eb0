"""The arithmetic a reference computation runs in.

``float64`` and ``float32`` are the dtypes themselves. ``bfloat16`` is the
control's precision: tensors are stored in float32 and rounded to bfloat16
after every operation that makes one, as a program that keeps its volumes
in bfloat16 and accumulates in float32 would compute (PyTorch has no
bfloat16 FFT). Complex tensors round their real and imaginary parts.
"""

from __future__ import annotations

import torch

__all__ = ["Precision"]


class Precision:
    def __init__(self, name: str):
        if name not in ("float64", "float32", "bfloat16"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "float64" else torch.float32
        self.cdtype = torch.complex128 if name == "float64" else torch.complex64

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` rounded to this precision (identity unless bfloat16)."""
        if self.name != "bfloat16":
            return t
        if t.is_complex():
            return torch.complex(self(t.real), self(t.imag))
        return t.to(torch.bfloat16).to(torch.float32)

    def __repr__(self) -> str:
        return f"Precision({self.name!r})"
