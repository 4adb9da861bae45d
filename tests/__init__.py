"""GALA-TPU test suite (a package, so `tests.*` imports resolve here)."""
