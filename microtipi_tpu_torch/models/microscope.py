"""Parameter-family tags of the PSF models.

Port of the tags in ``microtipi_tpu/models/microscope.py:29-49`` — the
DEFOCUS/PHASE/MODULUS indices of the reference
(``epifluorescence/WideFieldModel.java:113-123``) plus the JAX package's
extension families. The port's wide-field model carries the three reference
families only; DEPTH, SHEET, STED and CAVITY belong to models that ROADMAP.md
queue 1 item 13 ports.
"""

from __future__ import annotations

__all__ = [
    "DEFOCUS", "PHASE", "MODULUS", "DEPTH", "SHEET", "STED", "CAVITY",
    "PARAMETER_FLAGS", "FAMILY_NAMES",
]

DEFOCUS = 0
PHASE = 1
MODULUS = 2
DEPTH = 3
SHEET = 4
STED = 5
CAVITY = 6
PARAMETER_FLAGS = (DEFOCUS, PHASE, MODULUS)
FAMILY_NAMES = {
    DEFOCUS: "defocus",
    PHASE: "phase",
    MODULUS: "modulus",
    DEPTH: "depth",
    SHEET: "sheet",
    STED: "sted",
    CAVITY: "cavity",
}


def family_name(flag: int) -> str:
    """Field name of a family the port's wide-field model carries; the
    extension families raise until their models are ported."""
    if flag not in PARAMETER_FLAGS:
        raise NotImplementedError(
            f"family {FAMILY_NAMES.get(flag, flag)!r} is not ported yet "
            "(ROADMAP.md queue 1, item 13: the other PSF families)"
        )
    return FAMILY_NAMES[flag]
