"""Port of ``microtipi_tpu.optim``."""
