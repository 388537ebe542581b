"""Plain PyTorch sort-free counting scatter (the kernel's oracle).

Per-owner counts → exclusive-scan slot offsets → stable within-owner rank
from a blocked prefix over the one-hot matrix, so

    dest[i] = offsets[owner[i]] + rank_within_owner[i]

and ties keep previous-position order: ``dest`` is the inverse of a stable
argsort by owner.  Items are processed in (block, C) one-hot tiles of about
:data:`BLOCK_ELEMS` elements, carrying the running per-owner count; all
arithmetic is exact int32.  Ids outside [0, C) are padding: rank -1 and
dest ``n``.  Counterpart of ``repro.kernels.migrate.ref``.
"""
from __future__ import annotations

import torch

BLOCK_ELEMS = 1 << 22


def _block_n(n: int, C: int) -> int:
    """Rows per one-hot tile: fill BLOCK_ELEMS, at least 128 rows."""
    return max(128, min(max(n, 1), BLOCK_ELEMS // max(C, 1)))


def bucket_ranks_ref(ids: torch.Tensor, *, C: int):
    """``(rank, counts)``: ``rank[i]`` is the number of earlier items with
    the same id (-1 for padding), ``counts`` the (C,) per-id totals."""
    ids = ids.to(torch.int32)
    n = ids.shape[0]
    bn = _block_n(n, C)
    cols = torch.arange(C, dtype=torch.int32, device=ids.device)
    acc = torch.zeros(C, dtype=torch.int32, device=ids.device)
    ranks = []
    for s in range(0, n, bn):
        onehot = (ids[s:s + bn, None] == cols[None, :]).to(torch.int32)
        incl = torch.cumsum(onehot, dim=0, dtype=torch.int32)
        # invalid ids hit no column: both sums are 0, rank -1
        rank = ((incl * onehot).sum(dim=1) - 1
                + (onehot * acc[None, :]).sum(dim=1))
        acc = acc + incl[-1]
        ranks.append(rank.to(torch.int32))
    rank = (torch.cat(ranks) if ranks
            else torch.zeros(0, dtype=torch.int32, device=ids.device))
    return rank, acc


def bucket_counts_ref(ids: torch.Tensor, *, C: int) -> torch.Tensor:
    """(C,) per-id counts of the ids in [0, C) (padding is not counted)."""
    ids = ids.to(torch.int32)
    valid = (ids >= 0) & (ids < C)
    return torch.zeros(C, dtype=torch.int32, device=ids.device).index_add_(
        0, ids[valid].long(), torch.ones_like(ids[valid]))


def scatter_dest_ref(ids: torch.Tensor, *, C: int):
    """``(dest, counts)``: ``dest[i] = offsets[ids[i]] + rank[i]``;
    padding items get the sentinel ``n``."""
    ids = ids.to(torch.int32)
    n = ids.shape[0]
    rank, counts = bucket_ranks_ref(ids, C=C)
    offsets = torch.cat([counts.new_zeros(1),
                         torch.cumsum(counts, 0, dtype=torch.int32)])
    base = offsets[ids.clamp(0, C - 1).long()]
    return torch.where(rank >= 0, base + rank, n).to(torch.int32), counts
