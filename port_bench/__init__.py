"""The benchmark of adapt_tpu_torch (see README.md)."""
