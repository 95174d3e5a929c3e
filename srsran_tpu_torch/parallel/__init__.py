"""Multi-cell slot programs (port of srsran_tpu/parallel)."""
