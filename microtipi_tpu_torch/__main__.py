"""Command-line interface: ``python -m microtipi_tpu_torch <command>``.

Port of ``microtipi_tpu/__main__.py``, the entry shim of the ``cli``
package: ``info``, ``psf``, ``fitpsf``, ``deconv``, ``blind``, ``simulate``,
``register``, ``deskew``, ``fsc``, ``fuse``, ``ism``, ``sim``, ``watch`` and
``doctor``, run on the CUDA card. From Python, ``main(argv, device="cpu")``
runs one on the CPU.
"""

from microtipi_tpu_torch.cli import main
from microtipi_tpu_torch.cli.shared import (  # noqa: F401  (the JAX shim's re-exports)
    _build_preprocess,
    _deconv_config,
)

if __name__ == "__main__":
    main()
