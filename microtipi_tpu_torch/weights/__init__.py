"""Port of ``microtipi_tpu.weights``."""
