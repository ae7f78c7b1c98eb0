"""Port of ``microtipi_tpu.jobs``."""
