"""Stage 1 — distributed K-neighbor selection (paper §III.A).

The paper's asynchronous handshake realized as synchronous vectorized
rounds over dense (P, P) state (counterpart of
``repro.core.neighbor_selection``; see its docstring for the protocol):

  1. every node missing ``l`` neighbors requests its top ceil(l/2) untried
     candidates by preference;
  2. targets grant up to their remaining budget, preferring high-preference
     requesters;
  3. requesters confirm grants up to their remaining budget; only acked
     pairs become edges.

Rounds run as a host loop that reads one device flag per round.  Every
top-k selection is a stable descending sort, so ties go to the lowest
index exactly as ``lax.top_k`` breaks them (``torch.topk`` documents no
tie order).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEG = -1e30


class NeighborResult(NamedTuple):
    nbr_idx: torch.Tensor     # (P, K) neighbor node ids, -1 padded
    nbr_mask: torch.Tensor    # (P, K) bool
    degree: torch.Tensor      # (P,) i32 confirmed neighbor count
    rounds: torch.Tensor      # scalar i32 — protocol rounds executed


def _top(score: torch.Tensor, kk: int):
    """Row-wise (values, indices) of the ``kk`` largest entries, ties to
    the lowest index."""
    vals, idx = torch.sort(score, dim=1, descending=True, stable=True)
    return vals[:, :kk], idx[:, :kk]


def _topk_mask(score: torch.Tensor, k: torch.Tensor, k_max: int):
    """Row-wise bool mask of the ``k(row)`` highest-scoring valid entries
    (invalid entries already hold NEG); ``k`` is (P,), at most ``k_max``."""
    P = score.shape[0]
    kk = min(int(k_max), P)
    vals, idx = _top(score, kk)
    ar = torch.arange(kk, device=score.device)
    take = (vals > NEG / 2) & (ar[None, :] < k[:, None])
    return torch.zeros_like(score, dtype=torch.bool).scatter_(1, idx, take)


def select_neighbors(preference: torch.Tensor, *, k: int,
                     max_rounds: int = 64) -> NeighborResult:
    """Run the handshake protocol.

    ``preference`` is (P, P): entry [i, j] is how much node i wants node j
    as a neighbor.  Non-candidates must be <= 0; the diagonal is ignored.
    ``k`` is the desired degree K, ``max_rounds`` the round bound."""
    P = preference.shape[0]
    dev = preference.device
    eye = torch.eye(P, dtype=torch.bool, device=dev)
    candidate = (preference > 0) & ~eye
    pref = torch.where(candidate, preference, NEG)
    max_possible = torch.clamp(candidate.sum(dim=1), max=k)

    edges = torch.zeros((P, P), dtype=torch.bool, device=dev)
    tried = torch.zeros_like(edges)
    rounds = 0
    stall = 0
    while (rounds < max_rounds and stall < 4
           and bool((edges.sum(dim=1) < max_possible).any())):
        deg = edges.sum(dim=1)
        need = torch.clamp(k - deg, min=0)
        # 1. requests: top ceil(need/2) untried, unconfirmed candidates
        n_req = torch.where(need > 0, (need + 1) // 2, 0)
        req = _topk_mask(torch.where(tried | edges, NEG, pref), n_req, k)
        # 1b. mutual requests pair directly
        mutual = req & req.T
        mut_take = _topk_mask(torch.where(mutual, pref, NEG), need, k)
        new_edges = edges | (mut_take & mut_take.T)
        deg = new_edges.sum(dim=1)
        req = req & ~mutual
        # 2. grants: target j takes top (K - deg_j) incoming requests
        inc_score = torch.where(req.T, pref, NEG)            # [j, i] view
        grant_t = _topk_mask(inc_score, torch.clamp(k - deg, min=0), k)
        grant = grant_t.T
        granted_out = grant_t.sum(dim=1)
        # 3. acks: requester i confirms top (K - deg_i - granted_i) grants
        ack_budget = torch.clamp(k - deg - granted_out, min=0)
        ack = _topk_mask(torch.where(grant, pref, NEG), ack_budget, k)
        new_edges = new_edges | ack | ack.T
        # an under-degree node with no untried candidate left retries
        tried = tried | req
        untried_left = (torch.where(tried | new_edges, NEG, pref)
                        > NEG / 2).sum(dim=1)
        exhausted = (untried_left == 0) & (new_edges.sum(dim=1)
                                           < max_possible)
        tried = torch.where(exhausted[:, None], False, tried)
        progressed = bool(new_edges.sum() > edges.sum())
        stall = 0 if progressed else stall + 1
        edges = new_edges
        rounds += 1

    deg = edges.sum(dim=1)
    # padded (P, K) neighbor table, highest preference first
    _, order = _top(torch.where(edges, pref, NEG), min(k, P))
    taken = torch.gather(edges, 1, order)
    nbr_idx = torch.where(taken, order, -1).to(torch.int32)
    return NeighborResult(nbr_idx, taken, deg.to(torch.int32),
                          torch.tensor(rounds, dtype=torch.int32,
                                       device=dev))


def comm_preference(node_comm: torch.Tensor) -> torch.Tensor:
    """Preference for the communication variant: decreasing comm volume,
    with zero-comm nodes kept as last-resort candidates (tiny floor)."""
    P = node_comm.shape[0]
    eps = 1e-6 * (1.0 + node_comm.max())
    eye = torch.eye(P, dtype=torch.bool, device=node_comm.device)
    return torch.where(eye, 0.0, node_comm + eps)


def coordinate_preference(centroids: torch.Tensor) -> torch.Tensor:
    """Preference for the coordinate variant (§IV): inverse centroid
    distance (every node scores all others — O(P²), as in the paper)."""
    d2 = ((centroids[:, None, :] - centroids[None, :, :]) ** 2).sum(dim=-1)
    return 1.0 / (d2 + 1e-9)
