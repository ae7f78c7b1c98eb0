"""Port of ``microtipi_tpu.utils``."""
