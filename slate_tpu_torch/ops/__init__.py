"""Level-3 BLAS."""
