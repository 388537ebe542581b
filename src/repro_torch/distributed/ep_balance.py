"""MoE expert placement via communication-aware diffusion (counterpart of
``repro.distributed.ep_balance``).

Experts are the canonical persistently interacting objects of an LM
system: top-k routing keeps co-activating the same expert groups, expert
loads (tokens per expert) drift slowly, and moving an expert between EP
ranks costs real weight traffic.  The paper's three-stage balancer runs on
the expert→rank placement:

  * objects   = experts;  object load = EMA tokens routed per expert;
  * comm edge (i, j) = co-activation count: tokens selecting experts i and
    j together under top-k (colocating them lets one dispatched token copy
    serve both);
  * nodes     = EP ranks;
  * migration = expert weight transfer.

The output is a placement whose every rank holds exactly E/R experts:
:func:`repair_capacity` enforces the rigid slot count after the planner,
as a tensor function on the placement's device (the device-resident
replay of ``train.ep_runtime`` runs it inside its step loop).  Statistics
(:class:`ExpertStats`) are NumPy float64, as in the JAX package;
:func:`greedy_placement` is the load-only baseline.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import comm_graph, engine, metrics


@dataclasses.dataclass
class ExpertStats:
    """EMA routing statistics collected from the router over train steps."""

    num_experts: int
    ema: float = 0.9
    tokens: Optional[np.ndarray] = None        # (E,) EMA tokens per expert
    coact: Optional[np.ndarray] = None         # (E, E) EMA co-activations

    def __post_init__(self):
        E = self.num_experts
        if self.tokens is None:
            self.tokens = np.zeros(E)
        if self.coact is None:
            self.coact = np.zeros((E, E))

    def update(self, expert_ids: np.ndarray) -> None:
        """EMA update from one step's (T, k) routed expert ids: with ``C``
        the (T, E) per-token selection counts, the co-activation is
        ``CᵀC − diag(counts)`` (:func:`pair_stats_np`)."""
        counts, co = pair_stats_np(expert_ids, self.num_experts)
        self.tokens = self.ema * self.tokens + (1 - self.ema) * counts
        self.coact = self.ema * self.coact + (1 - self.ema) * co

    def update_from_counts(self, counts, coact) -> None:
        """EMA update from precomputed statistics (the router's
        ``models.moe.pair_stats`` sums)."""
        self.tokens = (self.ema * self.tokens
                       + (1 - self.ema) * np.asarray(counts, np.float64))
        self.coact = (self.ema * self.coact
                      + (1 - self.ema) * np.asarray(coact, np.float64))

    def imbalance(self, placement: np.ndarray, num_ranks: int) -> float:
        rank_load = np.bincount(placement, weights=self.tokens,
                                minlength=num_ranks)
        return float(rank_load.max() / (rank_load.mean() + 1e-30))


def pair_stats_np(expert_ids, num_experts: int):
    """(counts (E,), coact (E, E)) from (T, k) routed ids — the host twin
    of ``models.moe.pair_stats`` (same identity, NumPy)."""
    E = int(num_experts)
    ids = np.asarray(expert_ids)
    T = ids.shape[0]
    counts = np.bincount(ids.reshape(-1), minlength=E).astype(np.float64)
    C = np.zeros((T, E))
    np.add.at(C, (np.repeat(np.arange(T), ids.shape[1]), ids.reshape(-1)),
              1.0)
    co = C.T @ C - np.diag(counts)
    return counts, co


def pair_stats_loop(expert_ids, num_experts: int):
    """The O(k²) pair loop, the property-test oracle of
    :func:`pair_stats_np`."""
    E = int(num_experts)
    ids = np.asarray(expert_ids)
    counts = np.bincount(ids.reshape(-1), minlength=E).astype(np.float64)
    co = np.zeros((E, E))
    k = ids.shape[1]
    for a in range(k):
        for b in range(a + 1, k):
            np.add.at(co, (ids[:, a], ids[:, b]), 1.0)
    return counts, co + co.T


def build_problem(stats: ExpertStats, placement: np.ndarray,
                  num_ranks: int, *, device="cuda") -> comm_graph.LBProblem:
    """The expert problem on ``device``: the positive co-activation pairs
    as edges (a ring at 1e-3 before any co-activation accumulates)."""
    E = stats.num_experts
    iu, ju = np.triu_indices(E, k=1)
    w = stats.coact[iu, ju]
    keep = w > 0
    edges = np.stack([iu[keep], ju[keep]], axis=1)
    if edges.size == 0:                        # no co-activation yet: ring
        edges = np.stack([np.arange(E), (np.arange(E) + 1) % E], axis=1)
        w = np.full(E, 1e-3)
        keep = slice(None)
    return comm_graph.make_problem(
        loads=np.maximum(stats.tokens, 1e-3),
        assignment=np.asarray(placement, np.int32),
        edges=edges,
        edge_bytes=np.asarray(w[keep], np.float32),
        num_nodes=num_ranks, device=device)


def repair_capacity(assignment, loads, *, num_ranks: int,
                    cap: int) -> torch.Tensor:
    """Exactly ``cap`` experts per rank, on the assignment's device.

    Each over-full rank evicts its lightest excess experts; the evicted
    experts, ordered by ascending load (ties by index: a stable sort),
    fill the under-full ranks in rank order.  Fixed-shape integer work
    (one-hot cumulative sums over (E, R)) apart from the two stable sorts
    of f32 loads, so the result is the same on every device and equals
    the JAX package's."""
    a = torch.as_tensor(assignment).to(torch.int32)
    dev = a.device
    loads = torch.as_tensor(loads, device=dev).to(torch.float32)
    E = int(a.shape[0])
    R = int(num_ranks)
    counts = comm_graph.segment_count(a, R)
    # within-rank position in ascending-load order (stable)
    ordl = torch.sort(loads, stable=True).indices
    onehot = F.one_hot(a[ordl].long(), R).to(torch.int32)      # (E, R)
    pos_s = (torch.cumsum(onehot, 0, dtype=torch.int32) * onehot).sum(1) - 1
    pos = torch.empty(E, dtype=torch.int32, device=dev)
    pos[ordl] = pos_s.to(torch.int32)
    excess = torch.clamp(counts - cap, min=0)
    evict = pos < excess[a.long()]                       # lightest first
    # destinations: the j-th evicted expert (ascending load, stable) takes
    # the j-th open slot in cumulative-deficit order
    deficit = torch.clamp(cap - counts, min=0).to(torch.int64)
    cd = torch.cumsum(deficit, 0)
    key = torch.where(evict, loads, float("inf"))
    orde = torch.sort(key, stable=True).indices
    slot = torch.empty(E, dtype=torch.int64, device=dev)
    slot[orde] = torch.arange(E, device=dev)
    dst = torch.searchsorted(cd, slot, right=True)
    return torch.where(evict, torch.clamp(dst, 0, R - 1).to(torch.int32), a)


#: strategy-name aliases: ``greedy`` means the capacity-capped greedy
#: (``ep-greedy``; plain ``greedy`` has no slot budget and would leave the
#: capacity repair to do all the work)
_ALIASES = {"greedy": "ep-greedy"}


def plan_placement(
    stats: ExpertStats,
    placement: np.ndarray,
    num_ranks: int,
    *,
    k: int = 4,
    strategy: str = "diff-comm",
    device="cuda",
) -> Tuple[np.ndarray, Dict]:
    """New expert→rank placement (exactly E/R per rank) and plan info.

    Plans through the Strategy registry (``core.engine``) on ``device``,
    then :func:`repair_capacity`; ``strategy`` takes any registered name
    plus the ``"greedy"`` alias."""
    E = stats.num_experts
    assert E % num_ranks == 0
    cap = E // num_ranks
    prob = build_problem(stats, placement, num_ranks, device=device)
    strat = engine.get_strategy(_ALIASES.get(strategy, strategy))
    kw: Dict = {}
    if strat.variant is not None:
        kw = dict(k=min(k, num_ranks - 1), tol=0.05)
    plan = strat.run(prob, **kw)
    info = dict(plan.info)
    new = repair_capacity(
        torch.as_tensor(np.asarray(plan.assignment), device=prob.device),
        torch.as_tensor(np.asarray(stats.tokens, np.float32),
                        device=prob.device),
        num_ranks=num_ranks, cap=cap)
    info.update(metrics.evaluate(prob, new))
    new = new.cpu().numpy()
    info["moved_experts"] = int((new != placement).sum())
    return new.astype(np.int32), info


def greedy_placement(stats: ExpertStats, num_ranks: int) -> np.ndarray:
    """Load-only greedy (ignores co-activation) — the comparison baseline."""
    E = stats.num_experts
    cap = E // num_ranks
    order = np.argsort(-stats.tokens)
    rank_load = np.zeros(num_ranks)
    rank_cnt = np.zeros(num_ranks, np.int64)
    out = np.zeros(E, np.int32)
    for e in order:
        open_ = np.nonzero(rank_cnt < cap)[0]
        r = open_[np.argmin(rank_load[open_])]
        out[e] = r
        rank_load[r] += stats.tokens[e]
        rank_cnt[r] += 1
    return out


# ----------------------------------------------------------- permutation --


def placement_to_perm(placement: np.ndarray, num_ranks: int) -> np.ndarray:
    """(E,) physical-slot → logical-expert permutation: slot ``r·cap + i``
    (the i-th expert slice of EP rank r) receives ``perm[r·cap + i]``."""
    E = len(placement)
    cap = E // num_ranks
    perm = np.zeros(E, np.int64)
    for r in range(num_ranks):
        mine = np.sort(np.nonzero(placement == r)[0])
        assert len(mine) == cap, "placement must be capacity-exact"
        perm[r * cap:(r + 1) * cap] = mine
    return perm


def apply_perm_to_params(moe_params: Dict, perm) -> Dict:
    """Gather stacked expert weights into the new physical layout and
    permute the router's output columns the same way, so routing to
    physical slot s picks logical expert ``perm[s]``."""
    out = dict(moe_params)
    for key in ("wi", "wg", "wo"):
        v = moe_params[key]
        out[key] = v.index_select(0, torch.as_tensor(
            np.asarray(perm), dtype=torch.int64, device=v.device))
    r = moe_params["router"]
    out["router"] = r.index_select(1, torch.as_tensor(
        np.asarray(perm), dtype=torch.int64, device=r.device))
    return out


def migration_bytes(perm_old: np.ndarray, perm_new: np.ndarray,
                    bytes_per_expert: float, num_ranks: int) -> float:
    """Weight bytes that cross rank boundaries realizing the new layout."""
    E = len(perm_old)
    cap = E // num_ranks
    rank_of_slot = np.arange(E) // cap
    old_rank = np.zeros(E, np.int64)
    new_rank = np.zeros(E, np.int64)
    old_rank[np.asarray(perm_old)] = rank_of_slot
    new_rank[np.asarray(perm_new)] = rank_of_slot
    return float((old_rank != new_rank).sum() * bytes_per_expert)
