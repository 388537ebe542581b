"""Stage 3 — object selection (paper §III.C), counterpart of
``repro.core.object_selection``.

Realizes the stage-2 virtual flows with actual objects: per destination
neighbor, objects leave in decreasing order of the bytes they exchange
with it (communication variant) or increasing distance to its centroid
(coordinate variant §IV); peers' patterns are recomputed between phases;
an object migrates at most once per round.

One phase per neighbor slot: every node works on its largest-remaining-
budget neighbor; the per-node "sort by metric, take while under budget" is
a global two-key stable sort (``jnp.lexsort``'s order) + segmented prefix
sum.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import comm_graph
from repro_torch.core.comm_graph import cumsum, segment_sum

NEG = -1e30


class SelectionResult(NamedTuple):
    assignment: torch.Tensor  # (N,) new object→node map
    moved: torch.Tensor       # (N,) bool
    realized: torch.Tensor    # (P, K) load actually shipped per slot
    residual: torch.Tensor    # (P, K) unrealized flow (wanted - shipped)


def _lexsort(secondary: torch.Tensor, primary: torch.Tensor):
    """``jnp.lexsort((secondary, primary))``: by primary, ties by secondary,
    remaining ties by index — two stable sorts."""
    o = torch.sort(secondary, stable=True).indices
    return o[torch.sort(primary[o], stable=True).indices]


def _segmented_take_while(node, score, loads, eligible, budget):
    """Per node: order eligible objects by score desc, take while the
    running load stays under budget (an object is taken iff taking it
    lands closer to the budget than stopping)."""
    P = budget.shape[0]
    eff_score = torch.where(eligible, score, NEG)
    order = _lexsort(-eff_score, node)
    node_s = node[order].long()
    load_s = torch.where(eligible, loads, 0.0)[order]
    csum = cumsum(load_s)
    seg_tot = segment_sum(load_s, node_s, P)
    before = torch.cat([seg_tot.new_zeros(1), cumsum(seg_tot)[:-1]])
    within = csum - before[node_s]                 # inclusive in-node csum
    take_s = (within - 0.5 * load_s) <= budget[node_s]
    take_s = take_s & eligible[order] & (load_s > 0)
    take = torch.zeros_like(take_s)
    take[order] = take_s
    return take


def select_objects(problem: comm_graph.LBProblem, nbr_idx: torch.Tensor,
                   nbr_mask: torch.Tensor, flows: torch.Tensor, *,
                   metric: str = "comm") -> SelectionResult:
    """Pick objects realizing ``flows`` (stage-2 output, (P, K) net loads)."""
    if metric not in ("comm", "coord"):
        raise ValueError(f"unknown metric {metric!r}")
    if metric == "coord" and problem.coords is None:
        raise ValueError("coordinate variant needs coords")
    N = problem.num_objects
    P, K = nbr_idx.shape
    dev = problem.device
    loads = problem.loads
    assignment = problem.assignment.long()
    moved = torch.zeros(N, dtype=torch.bool, device=dev)
    send = torch.where(nbr_mask, torch.clamp(flows, min=0.0), 0.0)
    realized = torch.zeros_like(send)
    node_ids = torch.arange(P, device=dev)

    valid_e = problem.edges_src >= 0
    e_src = torch.where(valid_e, problem.edges_src, 0).long()
    e_dst = torch.where(valid_e, problem.edges_dst, 0).long()
    e_w = torch.where(valid_e, problem.edges_bytes, 0.0)

    for _ in range(K):
        # phase slot: each node's largest remaining budget (first on ties)
        slot = torch.argmax(send, dim=1)
        budget = send[node_ids, slot]
        target = torch.where(budget > 0, nbr_idx[node_ids, slot], -1).long()

        if metric == "comm":
            # bytes each object exchanges with its node's phase target,
            # on the phase's current assignment
            tgt_obj = target[assignment]

            def dir_score(a, b):
                hit = (assignment[b] == tgt_obj[a]) & (tgt_obj[a] >= 0)
                return segment_sum(torch.where(hit, e_w, 0.0), a, N)

            score = dir_score(e_src, e_dst) + dir_score(e_dst, e_src)
        else:
            cent = centroids(problem.coords, assignment, P)
            tgt = torch.where(target >= 0, target, 0)[assignment]
            score = -((problem.coords - cent[tgt]) ** 2).sum(dim=-1)

        eligible = ~moved & (target[assignment] >= 0)
        take = _segmented_take_while(assignment, score, loads, eligible,
                                     budget)
        shipped = segment_sum(torch.where(take, loads, 0.0), assignment, P)
        new_owner = torch.where(target >= 0, target, 0)[assignment]
        assignment = torch.where(take, new_owner, assignment)
        moved = moved | take
        realized[node_ids, slot] = realized[node_ids, slot] + shipped
        send[node_ids, slot] = 0.0               # slot done (shipped or not)

    residual = torch.where(nbr_mask, torch.clamp(flows, min=0.0), 0.0) \
        - realized
    return SelectionResult(assignment.to(torch.int32), moved, realized,
                           residual)


def centroids(coords: torch.Tensor, assignment: torch.Tensor, P: int):
    """(P, D) unweighted mean position of each node's objects (§IV)."""
    s = torch.stack([segment_sum(coords[:, d], assignment, P)
                     for d in range(coords.shape[1])], dim=1)
    c = segment_sum(torch.ones(coords.shape[0], dtype=coords.dtype,
                               device=coords.device), assignment, P)
    return s / torch.clamp(c, min=1.0)[:, None]
