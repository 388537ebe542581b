"""Plain PyTorch oracle for the segment histogram: ``out[c] = Σ w_i·[ids_i
= c]``, ids outside [0, C) ignored.  On the CPU ``index_add_`` adds in
index order (as XLA's CPU ``segment_sum`` does)."""
from __future__ import annotations

import torch


def histogram_ref(ids: torch.Tensor, weights: torch.Tensor, *, C: int):
    valid = (ids >= 0) & (ids < C)
    idx = torch.where(valid, ids, C).long()        # invalid → dropped bin C
    out = torch.zeros(C + 1, dtype=torch.float32, device=ids.device)
    out.index_add_(0, idx, weights.to(torch.float32))
    return out[:C]
