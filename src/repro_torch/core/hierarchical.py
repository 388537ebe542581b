"""Within-node (across-thread) refinement, paper §III.D (counterpart of
``repro.core.hierarchical``).

After the inter-node stages commit an object→node assignment, each node's
objects are spread over its ``T`` threads by load alone, with exact LPT
(longest processing time first).

:func:`lpt_threads` runs on the problem's device.  The sequential rule
("the next-heaviest object goes to the least-loaded thread") is taken
rank by rank: objects are sorted once by ``(node asc, load desc, index
asc)``, giving each a rank within its node, and one loop step assigns
every node's rank-``r`` object at once (a (P, T) ``argmin``).  The loop
runs to the largest per-node object count, read once from the device.

:func:`within_node_lpt` is the JAX package's NumPy oracle.  Both break
ties alike (a stable descending-load order, so the index breaks load ties,
and ``argmin`` taking the lowest thread index) and add each thread's loads
in float32 in rank order, so they agree bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.comm_graph import (ordered_sum, segment_count,
                                         segment_sum)


def lpt_threads(loads: torch.Tensor, assignment: torch.Tensor, *,
                num_nodes: int, threads_per_node: int) -> torch.Tensor:
    """(N,) int32 thread in ``[0, T)`` of each object: exact per-node LPT.

    The global PE of an object is ``assignment * T + thread``
    (:func:`flatten_hierarchy`).  One host read (the loop depth); the
    loop itself issues a fixed handful of launches a rank."""
    P, T = int(num_nodes), int(threads_per_node)
    loads = loads.to(torch.float32)
    assignment = assignment.to(torch.int32)
    dev = loads.device
    N = int(loads.shape[0])
    # (node asc, load desc, index asc): two stable sorts, the secondary
    # key first (jnp.lexsort is stable; torch.topk documents no tie order)
    by_load = torch.sort(-loads, stable=True).indices
    order = by_load[torch.sort(assignment[by_load], stable=True).indices]
    counts = segment_count(assignment, P)
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    depth = int(counts.max()) if P else 0       # the one host read
    acc = torch.zeros((P, T), dtype=torch.float32, device=dev)
    thread = torch.zeros(N + 1, dtype=torch.int32, device=dev)  # N: dropped
    rows = torch.arange(P, device=dev)
    for r in range(depth):
        pos = torch.clamp(starts + r, 0, max(N - 1, 0)).long()
        obj = order[pos]                                        # (P,)
        valid = counts > r
        t = torch.argmin(acc, dim=1)                            # lowest index
        acc[rows, t] = acc[rows, t] + torch.where(valid, loads[obj], 0.0)
        thread[torch.where(valid, obj, N)] = t.to(torch.int32)
    return thread[:N]


def thread_loads(loads: torch.Tensor, assignment: torch.Tensor,
                 thread: torch.Tensor, *, num_nodes: int,
                 threads_per_node: int) -> torch.Tensor:
    """(P*T,) total load per global PE, added in index order
    (``comm_graph.segment_sum``: K4's ordered form on a card)."""
    pe = assignment.to(torch.int32) * int(threads_per_node) \
        + thread.to(torch.int32)
    return segment_sum(loads.to(torch.float32), pe,
                       int(num_nodes) * int(threads_per_node))


def thread_max_avg(loads: torch.Tensor, assignment: torch.Tensor, *,
                   num_nodes: int, threads_per_node: int) -> torch.Tensor:
    """0-d f32 max/avg PE load under the two-level LPT placement (the
    mean's sum in the JAX package's CPU order)."""
    thr = lpt_threads(loads, assignment, num_nodes=num_nodes,
                      threads_per_node=threads_per_node)
    tl = thread_loads(loads, assignment, thr, num_nodes=num_nodes,
                      threads_per_node=threads_per_node)
    return tl.max() / (ordered_sum(tl) / tl.shape[0] + 1e-30)


def within_node_lpt(loads, assignment, num_nodes: int,
                    threads_per_node: int) -> np.ndarray:
    """Host NumPy LPT oracle: the same ties and float32 accumulation order
    as :func:`lpt_threads`."""
    loads = np.asarray(loads, np.float32)
    assignment = np.asarray(assignment)
    thread = np.zeros(assignment.shape[0], np.int32)
    for node in range(num_nodes):
        idx = np.nonzero(assignment == node)[0]
        if idx.size == 0:
            continue
        order = idx[np.argsort(-loads[idx], kind="stable")]
        tl = np.zeros(threads_per_node, np.float32)
        for o in order:
            t = int(np.argmin(tl))
            tl[t] += loads[o]
            thread[o] = t
    return thread


def flatten_hierarchy(assignment, thread, threads_per_node: int):
    """Object→global-PE map from (node, thread), for NumPy arrays or
    tensors."""
    return assignment * threads_per_node + thread
