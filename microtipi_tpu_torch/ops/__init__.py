"""Port of ``microtipi_tpu.ops``."""
