"""The benchmark of maniskill_tpu_torch: one command runs one cell once (see README.md)."""
