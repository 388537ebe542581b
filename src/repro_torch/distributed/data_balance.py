"""Data-parallel rank balancing for variable-length batches (counterpart
of ``repro.distributed.data_balance``; NumPy only, the port's own copy).

Sequences of different lengths make per-rank step work uneven (attention
is O(len²), the FFN O(len)).  ``pack_balanced`` is the per-batch greedy
packer (length-squared cost, LPT) inside one global batch;
``balance_shards`` in :mod:`repro_torch.train.data` is the cross-step
diffusion rebalancer this module re-exports.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.train.data import (balance_shards, rebalance_global,
                                    shard_problem)


def seq_cost(lengths: np.ndarray, *, attn_weight: float = 1.0,
             ffn_weight: float = 1.0, seq_ref: int = 4096) -> np.ndarray:
    """Per-sequence step cost model: ffn·len + attn·len²/seq_ref."""
    ln = np.asarray(lengths, np.float64)
    return ffn_weight * ln + attn_weight * ln * ln / seq_ref


def pack_balanced(lengths: np.ndarray, num_ranks: int) -> np.ndarray:
    """LPT assignment of sequences → DP ranks for one batch: the (N,) rank
    of each sequence."""
    cost = seq_cost(lengths)
    order = np.argsort(-cost)
    load = np.zeros(num_ranks)
    out = np.zeros(len(lengths), np.int32)
    for i in order:
        r = int(np.argmin(load))
        out[i] = r
        load[r] += cost[i]
    return out


def pack_stats(lengths: np.ndarray, assignment: np.ndarray,
               num_ranks: int) -> Dict[str, float]:
    cost = seq_cost(lengths)
    load = np.bincount(assignment, weights=cost, minlength=num_ranks)
    return dict(max_avg=float(load.max() / (load.mean() + 1e-30)),
                max=float(load.max()), avg=float(load.mean()))


__all__ = ["balance_shards", "rebalance_global", "shard_problem",
           "seq_cost", "pack_balanced", "pack_stats"]
