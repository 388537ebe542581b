"""Wrapper for the counting-scatter kernel (``csrc/migrate.cu``).

:func:`scatter_dest` / :func:`bucket_ranks` are the sort-free primitives
behind ``runtime.migrate``'s manifest build.  CPU tensors take the plain
version (:mod:`.ref`), CUDA tensors the kernel; both reproduce the
stable-argsort bucketed layout exactly (ties keep previous position).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import INT, PTR, CudaKernel, check_cuda
from repro_torch.kernels.migrate.ref import bucket_ranks_ref, scatter_dest_ref

KERNEL = CudaKernel("scatter_dest", "migrate.cu", {
    "scatter_dest_launch": [PTR] * 5 + [INT, INT],
})

TILE = 4096          # items per block (csrc/migrate.cu)
MAX_C = 1024         # the kernel's shared-memory bucket tables: 9·C ints

# The counting scatter beats a stable sort up to about this many buckets
# (measured for the JAX package on CPU); kept so ``method="auto"`` resolves
# as there.  It is below MAX_C, so every C that resolves to the scatter
# is one the kernel takes.
SORT_CROSSOVER_C = 64


def preferred_method(n: int, C: int) -> str:
    """``"scatter"`` or ``"sort"`` — what ``method="auto"`` resolves to."""
    del n
    return "scatter" if C <= SORT_CROSSOVER_C else "sort"


def _scatter_dest_cuda(ids: torch.Tensor, C: int):
    if not 1 <= C <= MAX_C:
        raise ValueError(f"scatter kernel takes 1 <= C <= {MAX_C}, got {C}")
    ids = ids.to(torch.int32).contiguous()
    check_cuda(ids)
    n = ids.shape[0]
    dest = torch.empty(n, dtype=torch.int32, device=ids.device)
    counts = torch.zeros(C, dtype=torch.int32, device=ids.device)
    if n == 0:
        return dest, counts
    nb = -(-n // TILE)
    blk = torch.empty(nb * C, dtype=torch.int32, device=ids.device)
    base = torch.empty(nb * C, dtype=torch.int32, device=ids.device)
    KERNEL.launch("scatter_dest_launch", ids.data_ptr(), dest.data_ptr(),
                  counts.data_ptr(), blk.data_ptr(), base.data_ptr(), n, C)
    return dest, counts


def scatter_dest(ids: torch.Tensor, *, C: int):
    """Sort-free bucketed destinations: ``(dest, counts, offsets)``.

    ``dest[i] = offsets[ids[i]] + stable-rank-within-bucket`` (the inverse
    of a stable argsort's permutation); padding ids (outside [0, C)) get
    the sentinel ``n``; ``offsets`` is the (C+1,) exclusive scan of
    ``counts``."""
    if ids.device.type == "cpu":
        dest, counts = scatter_dest_ref(ids, C=C)
    else:
        dest, counts = _scatter_dest_cuda(ids, C)
    offsets = torch.cat([counts.new_zeros(1),
                         torch.cumsum(counts, 0, dtype=torch.int32)])
    return dest, counts, offsets


def bucket_ranks(ids: torch.Tensor, *, C: int):
    """Stable within-bucket ranks ``(rank, counts)``; padding rank -1."""
    if ids.device.type == "cpu":
        return bucket_ranks_ref(ids, C=C)
    ids = ids.to(torch.int32)
    dest, counts, offsets = scatter_dest(ids, C=C)
    base = offsets[ids.clamp(0, C - 1).long()]
    valid = (ids >= 0) & (ids < C)
    return torch.where(valid, dest - base, -1).to(torch.int32), counts
