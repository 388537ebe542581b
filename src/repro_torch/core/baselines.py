"""Comparison strategies from the paper's evaluation (§II, §V.C),
counterpart of ``repro.core.baselines``:

  * ``greedy_refine`` — Charm++'s GreedyRefine: keep placement unless a node
    is overloaded; shed heaviest objects to the least-loaded nodes.  Best
    max/avg, worst communication locality (paper Table II).
  * ``greedy``        — Charm++'s GreedyLB: global re-map, sorted objects to
    least-loaded PE; ~100% migrations.
  * ``greedy_capped`` — GreedyLB under a per-node object-count budget.
  * ``metis_like``    — from-scratch multilevel k-way partition of the object
    comm graph (heavy-edge matching → greedy graph growing → boundary FM).
    Good locality, near-total migration, like METIS in the paper.
  * ``parmetis_like`` — adaptive *re*-partition: boundary FM refinement from
    the current assignment with a migration-cost term (the ParMETIS
    ``itr``-style tradeoff knob).

All are centralized host planners in NumPy, as they are in Charm++ and in
the JAX package: the problem is read from its device once a plan
(:func:`_np`, in the dtypes the JAX package reads it in, edges in the
problem's order), and the caller (``core.engine``'s host strategies) puts
the assignment back on the device.  The algorithms are the JAX package's,
line for line, so equal inputs give equal assignments (heap ties and
``metis_like``'s seeded RNG included).
"""
from __future__ import annotations

import heapq
from typing import Dict, Tuple

import numpy as np

from repro_torch.core import comm_graph


def _np(problem: comm_graph.LBProblem):
    """``(loads f64, assignment i64, src i64, dst i64, bytes f64)`` on the
    host, padded edges (``src < 0``) dropped."""
    loads = problem.loads.cpu().numpy().astype(np.float64)
    a = problem.assignment.cpu().numpy().astype(np.int64)
    src = problem.edges_src.cpu().numpy().astype(np.int64)
    dst = problem.edges_dst.cpu().numpy().astype(np.int64)
    w = problem.edges_bytes.cpu().numpy().astype(np.float64)
    valid = src >= 0
    return loads, a, src[valid], dst[valid], w[valid]


# ---------------------------------------------------------------- greedy ----


def greedy(problem: comm_graph.LBProblem) -> np.ndarray:
    loads, a, *_ = _np(problem)
    P = problem.num_nodes
    new = np.empty_like(a)
    heap = [(0.0, p) for p in range(P)]
    heapq.heapify(heap)
    for o in np.argsort(-loads):
        l, p = heapq.heappop(heap)
        new[o] = p
        heapq.heappush(heap, (l + loads[o], p))
    return new


def greedy_capped(problem: comm_graph.LBProblem,
                  cap: int = 0) -> np.ndarray:
    """GreedyLB under a rigid per-node object-count budget.

    Sorted objects go to the least-loaded node that still has slots —
    the indivisible-slot regime (MoE experts: exactly E/R experts fit a
    rank's weight buffers).  ``cap <= 0`` derives the tightest uniform
    budget ``ceil(N / P)``; like :func:`greedy` it ignores the current
    assignment and the comm graph entirely."""
    loads, a, *_ = _np(problem)
    P = problem.num_nodes
    N = len(loads)
    if cap <= 0:
        cap = -(-N // P)
    new = np.empty_like(a)
    node_load = np.zeros(P)
    node_cnt = np.zeros(P, np.int64)
    for o in np.argsort(-loads):
        open_ = np.nonzero(node_cnt < cap)[0]
        p = open_[np.argmin(node_load[open_])]
        new[o] = p
        node_load[p] += loads[o]
        node_cnt[p] += 1
    return new


def greedy_refine(
    problem: comm_graph.LBProblem, threshold: float = 1.003
) -> np.ndarray:
    """Shed load from nodes above ``threshold * avg`` to the least loaded."""
    loads, a, *_ = _np(problem)
    P = problem.num_nodes
    node_load = np.bincount(a, weights=loads, minlength=P).astype(np.float64)
    avg = node_load.mean()
    heap = [(node_load[p], p) for p in range(P)]
    heapq.heapify(heap)
    new = a.copy()
    objs_by_node = [list(np.nonzero(a == p)[0][np.argsort(loads[a == p])])
                    for p in range(P)]  # ascending; pop() = heaviest
    for p in np.argsort(-node_load):
        while node_load[p] > threshold * avg and objs_by_node[p]:
            o = objs_by_node[p].pop()
            # least-loaded target (lazy heap — skip stale entries)
            while True:
                l, q = heapq.heappop(heap)
                if abs(l - node_load[q]) < 1e-9:
                    break
            if q == p or node_load[q] + loads[o] > node_load[p]:
                heapq.heappush(heap, (node_load[q], q))
                break
            new[o] = q
            node_load[p] -= loads[o]
            node_load[q] += loads[o]
            heapq.heappush(heap, (node_load[q], q))
    return new


# ------------------------------------------------------------ partitioning --


def _csr(n: int, src, dst, w) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Symmetric CSR adjacency from an edge list (duplicates summed)."""
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    ww = np.concatenate([w, w])
    keep = s != d
    s, d, ww = s[keep], d[keep], ww[keep]
    order = np.lexsort((d, s))
    s, d, ww = s[order], d[order], ww[order]
    # merge duplicate (s, d)
    if s.size:
        uniq = np.ones(s.size, bool)
        uniq[1:] = (s[1:] != s[:-1]) | (d[1:] != d[:-1])
        idx = np.cumsum(uniq) - 1
        ms, md = s[uniq], d[uniq]
        mw = np.zeros(uniq.sum())
        np.add.at(mw, idx, ww)
        s, d, ww = ms, md, mw
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, s + 1, 1)
    indptr = np.cumsum(indptr)
    return indptr, d, ww


def _heavy_edge_matching(n, indptr, adj, w, vw):
    """Returns coarse ids (n,) — pairs matched by heaviest incident edge."""
    match = np.full(n, -1, np.int64)
    order = np.argsort(-vw)  # heavy vertices first
    for u in order:
        if match[u] >= 0:
            continue
        best, bw = -1, -1.0
        for e in range(indptr[u], indptr[u + 1]):
            v = adj[e]
            if match[v] < 0 and v != u and w[e] > bw:
                best, bw = v, w[e]
        if best >= 0:
            match[u], match[best] = best, u
        else:
            match[u] = u
    coarse = np.full(n, -1, np.int64)
    nxt = 0
    for u in range(n):
        if coarse[u] < 0:
            coarse[u] = coarse[match[u]] = nxt
            nxt += 1
    return coarse, nxt


def _contract(coarse, nc, indptr, adj, w, vw):
    n = vw.shape[0]
    cvw = np.zeros(nc)
    np.add.at(cvw, coarse, vw)
    src = np.repeat(np.arange(n), np.diff(indptr))
    cs, cd = coarse[src], coarse[adj]
    keep = cs != cd
    ip, a2, w2 = _csr(nc, cs[keep], cd[keep], w[keep] / 2.0)  # /2: symmetric dup
    return ip, a2, w2, cvw


def _grow_initial(nc, indptr, adj, w, vw, P, rng):
    """Recursive bisection (pmetis-style) on the coarse graph.

    Each bisection BFS-grows one side to the target weight fraction from a
    peripheral seed, then runs a 2-way boundary FM on the subgraph.  Far
    better k-way quality than one-shot graph growing when P is large
    relative to the coarse graph.
    """
    from collections import deque

    part = np.full(nc, -1, np.int64)

    def bfs_grow(verts, target_w):
        """Grow a region of ~target_w weight inside vertex set `verts`.

        Greedy graph growing (GGGP): from a pseudo-peripheral seed, extend
        by the frontier vertex with the highest connection weight into the
        region — keeps the growth front compact (low surface), unlike plain
        BFS which grows stringy onion shells.
        """
        inset = np.zeros(nc, bool)
        inset[verts] = True
        # peripheral seed: BFS from an arbitrary vertex, take the last reached
        start = verts[0]
        q, seen = deque([start]), {start}
        last = start
        while q:
            u = q.popleft()
            last = u
            for e in range(indptr[u], indptr[u + 1]):
                v = adj[e]
                if inset[v] and v not in seen:
                    seen.add(v)
                    q.append(v)
        side = np.zeros(nc, bool)
        gain = {}          # frontier vertex -> connection weight into region
        heap = [(-1.0, last)]
        gain[last] = 1.0
        acc = 0.0
        while heap and acc < target_w:
            g, u = heapq.heappop(heap)
            if side[u] or gain.get(u, None) != -g:
                continue   # stale heap entry
            side[u] = True
            acc += vw[u]
            for e in range(indptr[u], indptr[u + 1]):
                v = adj[e]
                if inset[v] and not side[v]:
                    gv = gain.get(v, 0.0) + w[e]
                    gain[v] = gv
                    heapq.heappush(heap, (-gv, v))
        # disconnected remainder: top up from any unreached in-set vertices
        if acc < target_w:
            for u in verts:
                if acc >= target_w:
                    break
                if not side[u]:
                    side[u] = True
                    acc += vw[u]
        return side

    def fm2(verts, side, n0_frac, passes=6):
        """2-way boundary FM on the subgraph induced by `verts`."""
        inset = np.zeros(nc, bool)
        inset[verts] = True
        tot = vw[verts].sum()
        cap0, cap1 = tot * n0_frac * 1.05, tot * (1 - n0_frac) * 1.05
        w0 = vw[verts][side[verts]].sum()
        for _ in range(passes):
            moved = False
            for u in verts:
                ext = int_ = 0.0
                for e in range(indptr[u], indptr[u + 1]):
                    v = adj[e]
                    if not inset[v]:
                        continue
                    if side[v] == side[u]:
                        int_ += w[e]
                    else:
                        ext += w[e]
                gain = ext - int_
                if gain <= 1e-12:
                    continue
                if side[u]:   # moving 0→1... side[u] True means in side-0 set
                    if w0 - vw[u] >= tot * n0_frac * 0.95:
                        side[u] = False
                        w0 -= vw[u]
                        moved = True
                else:
                    if w0 + vw[u] <= cap0:
                        side[u] = True
                        w0 += vw[u]
                        moved = True
            if not moved:
                break
        return side

    def bisect(verts, p0, p1):
        if p1 - p0 == 1 or verts.size == 0:
            part[verts] = p0
            return
        nl = (p1 - p0) // 2
        frac = nl / (p1 - p0)
        side = bfs_grow(verts, vw[verts].sum() * frac)
        side = fm2(verts, side, frac)
        left = verts[side[verts]]
        right = verts[~side[verts]]
        if left.size == 0 or right.size == 0:  # degenerate: split by weight
            order = verts[np.argsort(-vw[verts])]
            cw = np.cumsum(vw[order])
            cut = int(np.searchsorted(cw, cw[-1] * frac)) + 1
            left, right = order[:cut], order[cut:]
        bisect(left, p0, p0 + nl)
        bisect(right, p0 + nl, p1)

    bisect(np.arange(nc, dtype=np.int64), 0, P)
    return part


def _fm_refine(part, indptr, adj, w, vw, P, *, passes=8, imbalance=1.03,
               migration_penalty=0.0, original=None):
    """Boundary FM refinement.  gain = cut reduction − migration penalty."""
    node_load = np.zeros(P)
    np.add.at(node_load, part, vw)
    avg = node_load.mean()
    cap = avg * imbalance
    n = vw.shape[0]
    for _ in range(passes):
        improved = False
        # external weight of each vertex toward each adjacent part
        for u in range(n):
            pu = part[u]
            conn: Dict[int, float] = {}
            for e in range(indptr[u], indptr[u + 1]):
                conn[part[adj[e]]] = conn.get(part[adj[e]], 0.0) + w[e]
            internal = conn.get(pu, 0.0)
            best_gain, best_p = 0.0, -1
            for q, wq in conn.items():
                if q == pu:
                    continue
                gain = wq - internal
                if migration_penalty and original is not None:
                    if original[u] == pu:
                        gain -= migration_penalty
                    elif original[u] == q:
                        gain += migration_penalty
                # balance: allow if destination stays under cap, or if the
                # move strictly reduces the maximum of the two loads.
                ok = (node_load[q] + vw[u] <= cap) or (
                    node_load[q] + vw[u] < node_load[pu]
                )
                if ok and gain > best_gain + 1e-12:
                    best_gain, best_p = gain, q
            # Also move for pure balance when grossly overloaded.
            if best_p < 0 and node_load[pu] > cap and conn:
                cands = [q for q in conn if q != pu and
                         node_load[q] + vw[u] < node_load[pu]]
                if cands:
                    best_p = min(cands, key=lambda q: node_load[q])
            if best_p >= 0:
                node_load[pu] -= vw[u]
                node_load[best_p] += vw[u]
                part[u] = best_p
                improved = True
        if not improved:
            break
    return part


def _rcb(coords: np.ndarray, weights: np.ndarray, P: int) -> np.ndarray:
    """Recursive weighted coordinate bisection (geometric seeding)."""
    n = coords.shape[0]
    part = np.zeros(n, np.int64)

    def rec(idx, p0, p1):
        if p1 - p0 <= 1 or idx.size == 0:
            part[idx] = p0
            return
        nl = (p1 - p0) // 2
        axis = int(np.argmax(coords[idx].max(0) - coords[idx].min(0)))
        order = idx[np.argsort(coords[idx, axis], kind="stable")]
        cw = np.cumsum(weights[order])
        target = cw[-1] * nl / (p1 - p0)
        cut = int(np.searchsorted(cw, target)) + 1
        cut = min(max(cut, 1), idx.size - 1)
        rec(order[:cut], p0, p0 + nl)
        rec(order[cut:], p0 + nl, p1)

    rec(np.arange(n), 0, P)
    return part


def metis_like(problem: comm_graph.LBProblem, *, coarsen_to: int = 256,
               seed: int = 0, use_coords: bool = False) -> np.ndarray:
    """k-way partition from scratch (ignores current placement).

    Default is the pure graph path (multilevel heavy-edge matching → greedy
    graph growing → FM): real METIS sees only the graph, so part labels are
    arbitrary relative to the current placement — that is exactly why the
    paper measures ~87-99% migrations for it (Table II).  ``use_coords``
    switches to geometric seeding (RCB) + FM polish, which incidentally
    aligns labels with a tiled initial mapping (useful as an extra baseline,
    not as the METIS stand-in).
    """
    loads, a, src, dst, w = _np(problem)
    P = problem.num_nodes
    n = loads.shape[0]
    rng = np.random.default_rng(seed)

    if use_coords and problem.coords is not None:
        coords = problem.coords.cpu().numpy().astype(np.float64)
        part = _rcb(coords, loads, P)
        indptr, adj, ew = _csr(n, src, dst, w)
        return _fm_refine(part, indptr, adj, ew, loads, P, passes=4)

    levels = []
    indptr, adj, ew = _csr(n, src, dst, w)
    vw = loads.copy()
    cur_n = n
    # Coarsen only when the graph is genuinely large; recursive bisection on
    # ≤ ~8k vertices is fast in full resolution and much higher quality.
    while cur_n > max(coarsen_to, 16 * P, 8192) and len(levels) < 12:
        coarse, nc = _heavy_edge_matching(cur_n, indptr, adj, ew, vw)
        if nc >= cur_n:  # no progress
            break
        levels.append(coarse)
        indptr, adj, ew, vw = _contract(coarse, nc, indptr, adj, ew, vw)
        cur_n = nc
    part = _grow_initial(cur_n, indptr, adj, ew, vw, P, rng)
    part = _fm_refine(part, indptr, adj, ew, vw, P)
    # Uncoarsen with refinement at each level: rebuild the intermediate
    # graphs for projection
    ip2, a2, w2 = _csr(n, src, dst, w)
    gi, ga, gw, gv = ip2, a2, w2, loads.copy()
    inter = [(gi, ga, gw, gv)]
    for coarse in levels:
        gi, ga, gw, gv = _contract(coarse, coarse.max() + 1, gi, ga, gw, gv)
        inter.append((gi, ga, gw, gv))
    for lvl in range(len(levels) - 1, -1, -1):
        part = part[levels[lvl]]
        gi, ga, gw, gv = inter[lvl]
        part = _fm_refine(part, gi, ga, gw, gv, P, passes=4)
    return part.astype(np.int64)


def parmetis_like(problem: comm_graph.LBProblem, *, itr: float = 1000.0,
                  passes: int = 8, imbalance: float = 1.05) -> np.ndarray:
    """Adaptive repartitioning from the current assignment.

    ``itr`` maps to ParMETIS's inter-processor-redistribution cost knob:
    higher ⇒ migrations are more expensive ⇒ fewer moves.  The paper notes
    (§V.C) this tradeoff is hard to tune; we expose it directly.
    """
    loads, a, src, dst, w = _np(problem)
    P = problem.num_nodes
    indptr, adj, ew = _csr(loads.shape[0], src, dst, w)
    scale = (ew.sum() / max(len(ew), 1)) * itr / 1000.0
    part = _fm_refine(a.copy(), indptr, adj, ew, loads, P, passes=passes,
                      imbalance=imbalance, migration_penalty=scale,
                      original=a)
    return part
