"""CLI package: ``python -m microtipi_tpu_torch`` (see ``parser.main``).

Port of ``microtipi_tpu/cli``, one module per concern as there:

- ``shared``   command-agnostic plumbing: arg groups, IO, model builders
- ``basic``    doctor / info / psf
- ``deconv``   the non-blind solve (+ ``deconv_modes`` for the variants)
- ``blind``    the alternating blind loop and its variants
- ``fitpsf``   bead / depth-ladder / phase-diversity calibration
- ``tools``    simulate, register, deskew, fsc, fuse, ism, sim, watch
- ``parser``   the argparse tree and ``main()``

``main(argv=None, *, device=None)`` runs a command on the CUDA card, or on
``device`` when the caller names one (``device="cpu"``).
"""

from microtipi_tpu_torch.cli.parser import main

__all__ = ["main"]
