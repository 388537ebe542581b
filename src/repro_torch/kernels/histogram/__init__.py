"""Segment histogram kernel (per-chare load measurement)."""
from repro_torch.kernels.histogram.ops import histogram  # noqa: F401
