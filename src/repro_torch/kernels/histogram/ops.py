"""Wrapper for the histogram kernel (``csrc/histogram.cu``): CPU tensors
take the plain version (:mod:`.ref`), CUDA tensors the kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels import INT, PTR, CudaKernel, check_cuda
from repro_torch.kernels.histogram.ref import histogram_ref

KERNEL = CudaKernel("histogram", "histogram.cu", {
    "histogram_launch": [PTR] * 4 + [INT, INT],
})

TILE = 16384          # items per block (csrc/histogram.cu)
MAX_C = 12288         # per-block shared-memory histogram: 48 KB of f32


def histogram(ids: torch.Tensor, weights: torch.Tensor, *, C: int):
    """(C,) f32 per-bin weight sums; ids outside [0, C) are ignored."""
    if ids.device.type == "cpu":
        return histogram_ref(ids, weights, C=C)
    if not 1 <= C <= MAX_C:
        raise ValueError(f"histogram kernel takes 1 <= C <= {MAX_C}, got {C}")
    ids = ids.to(torch.int32).contiguous()
    w = weights.to(torch.float32).contiguous()
    check_cuda(ids, w)
    if w.shape != ids.shape:
        raise ValueError("ids and weights must have the same shape")
    n = ids.shape[0]
    out = torch.zeros(C, dtype=torch.float32, device=ids.device)
    if n == 0:
        return out
    partial = torch.empty(-(-n // TILE) * C, dtype=torch.float32,
                          device=ids.device)
    KERNEL.launch("histogram_launch", ids.data_ptr(), w.data_ptr(),
                  partial.data_ptr(), out.data_ptr(), n, C)
    return out
