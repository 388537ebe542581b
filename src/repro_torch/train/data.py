"""Data pipeline: a deterministic synthetic corpus and diffusion-balanced
shard assignment (counterpart of ``repro.train.data``).

Variable-length documents are persistent objects: a document shard stays
on its data-parallel rank across epochs, consecutive shards exchange
boundary documents (the comm edges, a ring), and per-shard token counts
are the loads.  When length skew drifts the per-rank work apart,
:func:`balance_shards` runs the paper's three-stage balancer
(``core.api.diffusion_lb`` on ``device``: K1, K3 and K4 on a card) on the
shard → rank assignment instead of reshuffling everything; the
GreedyLB-style global remap baseline is :func:`rebalance_global`.

Token streams come from NumPy exactly as in the JAX package, so both
packages' batches are equal array for array.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import api as core_api
from repro_torch.core import comm_graph


@dataclasses.dataclass
class DataConfig:
    vocab_size: int = 32_000
    seq_len: int = 1024
    global_batch: int = 8
    num_shards: int = 64            # document shards (objects)
    seed: int = 0
    len_alpha: float = 2.5          # Pareto tail for document lengths


class SyntheticCorpus:
    """Deterministic infinite token stream, shardable by (shard, index):
    any rank can regenerate any shard, so the data state is just (epoch,
    per-shard cursor)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # per-shard document lengths: heavy-tailed, so the loads are skewed
        self.doc_lens = [
            np.maximum(
                16,
                (rng.pareto(cfg.len_alpha, size=256) * cfg.seq_len / 4)
            ).astype(np.int64)
            for _ in range(cfg.num_shards)
        ]

    def shard_tokens(self, shard: int, epoch: int) -> np.ndarray:
        """Total token count of a shard (its load)."""
        return self.doc_lens[shard].sum()

    def sample_batch(self, shard: int, cursor: int, n_seqs: int,
                     epoch: int = 0) -> Tuple[np.ndarray, int]:
        """(n_seqs, seq_len) token block and the new cursor."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + shard * 7919 + epoch) % (2**31))
        out = rng.integers(1, cfg.vocab_size, size=(n_seqs, cfg.seq_len),
                           dtype=np.int32)
        return out, cursor + n_seqs


def shard_problem(token_counts: np.ndarray, assignment: np.ndarray,
                  num_ranks: int, *, device="cuda") -> comm_graph.LBProblem:
    """LBProblem over data shards on ``device``: a ring comm graph between
    consecutive shards (documents straddle shard boundaries on disk)."""
    n = token_counts.shape[0]
    nxt = (np.arange(n) + 1) % n
    edges = np.stack([np.arange(n), nxt], axis=1)
    ebytes = np.full(n, float(np.mean(token_counts)) * 0.01 + 1.0,
                     np.float32)
    return comm_graph.make_problem(
        loads=token_counts.astype(np.float32), assignment=assignment,
        edges=edges, edge_bytes=ebytes, num_nodes=num_ranks,
        coords=np.arange(n, dtype=np.float32)[:, None], device=device)


def balance_shards(token_counts, assignment, num_ranks, *, k: int = 2,
                   variant: str = "comm", device="cuda"
                   ) -> Tuple[np.ndarray, Dict]:
    """Diffusion-rebalance the shard → rank map (the paper's technique)."""
    prob = shard_problem(np.asarray(token_counts), np.asarray(assignment),
                         num_ranks, device=device)
    plan = core_api.diffusion_lb(prob, k=min(k, num_ranks - 1),
                                 variant=variant, device=device)
    return plan.assignment.astype(np.int32), plan.info


def rebalance_global(token_counts, num_ranks) -> np.ndarray:
    """GreedyLB-style global remap baseline (max migration)."""
    order = np.argsort(-np.asarray(token_counts))
    loads = np.zeros(num_ranks)
    out = np.zeros(len(token_counts), np.int32)
    for s in order:
        r = int(np.argmin(loads))
        out[s] = r
        loads[r] += token_counts[s]
    return out


@dataclasses.dataclass
class PipelineState:
    epoch: int
    cursor: np.ndarray            # (num_shards,) per-shard position
    assignment: np.ndarray        # (num_shards,) shard → DP rank

    def to_dict(self):
        return dict(epoch=self.epoch, cursor=self.cursor,
                    assignment=self.assignment)

    @staticmethod
    def from_dict(d):
        return PipelineState(int(d["epoch"]), np.asarray(d["cursor"]),
                             np.asarray(d["assignment"]))


class DataPipeline:
    """Host-side batch producer: :meth:`next_batch` returns a global batch
    (tokens, labels, positions) as NumPy arrays; :meth:`maybe_rebalance`
    plans on ``device``."""

    def __init__(self, cfg: DataConfig, num_ranks: int,
                 state: Optional[PipelineState] = None, *, device="cuda"):
        self.cfg = cfg
        self.corpus = SyntheticCorpus(cfg)
        self.num_ranks = num_ranks
        self.device = device
        if state is None:
            state = PipelineState(
                epoch=0,
                cursor=np.zeros(cfg.num_shards, np.int64),
                assignment=(np.arange(cfg.num_shards) * num_ranks
                            // cfg.num_shards).astype(np.int32),
            )
        self.state = state

    def _counts(self) -> np.ndarray:
        return np.array([self.corpus.shard_tokens(s, self.state.epoch)
                         for s in range(self.cfg.num_shards)])

    def rank_loads(self) -> np.ndarray:
        return np.bincount(self.state.assignment,
                           weights=self._counts().astype(np.float64),
                           minlength=self.num_ranks)

    def maybe_rebalance(self, *, threshold: float = 1.1) -> Optional[Dict]:
        loads = self.rank_loads()
        if loads.max() / (loads.mean() + 1e-30) < threshold:
            return None
        new_assign, info = balance_shards(
            self._counts(), self.state.assignment, self.num_ranks,
            device=self.device)
        info["moved_shards"] = int(
            (new_assign != self.state.assignment).sum())
        self.state.assignment = new_assign
        return info

    def next_batch(self, rng_epoch: int = 0) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        per_rank = cfg.global_batch // self.num_ranks
        toks = []
        for r in range(self.num_ranks):
            shards = np.nonzero(self.state.assignment == r)[0]
            s = int(shards[self.state.epoch % len(shards)]) if len(shards) \
                else int(r % cfg.num_shards)
            block, cur = self.corpus.sample_batch(
                s, int(self.state.cursor[s]), per_rank, self.state.epoch)
            self.state.cursor[s] = cur
            toks.append(block)
        tokens = np.concatenate(toks, axis=0)
        labels = np.concatenate(
            [tokens[:, 1:], np.full((tokens.shape[0], 1), -1, np.int32)],
            axis=1)
        positions = np.broadcast_to(
            np.arange(cfg.seq_len, dtype=np.int32)[None], tokens.shape)
        self.state.epoch += 1
        return dict(tokens=tokens, labels=labels,
                    positions=np.ascontiguousarray(positions))
