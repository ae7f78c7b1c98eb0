"""The bytes each kernel layer must move, and the card's peaks.

Counted from the shapes, per call: every input read once and every output
written once, whatever the implementation reads again. This is the work the
layer must do, so that a later fusion or rewrite of the kernel cannot make
the count stale. A float32 voxel is 4 bytes.

- Hyperbolic TV, cost and gradient of one volume: read x, write the
  gradient: 8 B a voxel (``PERF.md``'s kernel table).
- ADMM split update (``jobs/admm.py``'s z1, u1, z2, u2 update from x): read
  x, u1 (3 components) and u2, write z1 (3), u1 (3), z2 and u2: 13 volumes
  at over-relaxation alpha = 1; over-relaxed it also reads z1 (3) and z2,
  which enter the relaxation: 17 volumes.
- ADMM right-hand side: read z1 (3), u1 (3), z2, u2, write rhs: 9 volumes.

Peaks: NVIDIA H100 SXM 80GB HBM3, 3.35 TB/s device memory (NVIDIA's data
sheet), at the full 700 W.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "admm_rhs_bytes", "admm_split_bytes", "bound_seconds", "tv_bytes"]

HBM_BYTES_PER_S = 3.35e12
F32 = 4


def tv_bytes(voxels: int) -> int:
    """One TV cost-and-gradient call over ``voxels`` voxels."""
    return 2 * F32 * int(voxels)


def admm_split_bytes(voxels: int, alpha: float) -> int:
    """One ADMM split update over ``voxels`` voxels at over-relaxation ``alpha``."""
    return (17 if alpha != 1.0 else 13) * F32 * int(voxels)


def admm_rhs_bytes(voxels: int) -> int:
    """One ADMM right-hand side over ``voxels`` voxels."""
    return 9 * F32 * int(voxels)


def bound_seconds(nbytes: float) -> float:
    """The least time the card's memory could move ``nbytes`` in."""
    return float(nbytes) / HBM_BYTES_PER_S
