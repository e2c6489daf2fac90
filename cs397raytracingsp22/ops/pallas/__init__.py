"""Pallas kernels (Triton route) for the hot intersection paths."""
