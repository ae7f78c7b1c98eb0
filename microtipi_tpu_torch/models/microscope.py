"""Parameter-family tags of the PSF models.

Port of the tags in ``microtipi_tpu/models/microscope.py:29-49`` — the
DEFOCUS/PHASE/MODULUS indices of the reference
(``epifluorescence/WideFieldModel.java:113-123``) plus the JAX package's
extension families: DEPTH (Gibson-Lanni, ``models/gibson_lanni.py``), SHEET
(light sheet, ``models/lightsheet.py``), STED (``models/sted.py``) and
CAVITY (4Pi, ``models/fourpi.py``). A family is a field of the params tuple.
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
    """Field name of the family ``flag`` selects."""
    if flag not in FAMILY_NAMES:
        raise ValueError(f"unknown parameter family {flag!r}")
    return FAMILY_NAMES[flag]
