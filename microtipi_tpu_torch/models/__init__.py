"""Port of ``microtipi_tpu.models``."""
