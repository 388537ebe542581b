"""Device-resident payload migration: the *apply* half of a rebalance
(counterpart of the single-device half of ``repro.runtime.migrate``).

:func:`build_manifest` turns an old→new owner pair into a ``Manifest``;
:func:`apply_manifest` executes it as a bucketed gather that puts each
node's items in one contiguous slot region (stable: by new owner, ties by
previous position).  ``method`` picks how the permutation is built:
``"sort"`` (stable argsort), ``"scatter"`` (the sort-free counting scatter
of ``kernels.migrate``) or ``"auto"`` (``kernels.migrate.preferred_method``).
Every method gives the identical ``order``.

:func:`spill_owner` clamps a plan's per-node inflow to a slot budget by
deferring moves (:func:`spill_admissions` solves for the admitted flow).
The ring and sharded exchanges belong to a later slice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core.comm_graph import ordered_sum, segment_count
from repro_torch.kernels import migrate as mig_ops


class Manifest(NamedTuple):
    """Executable exchange plan for one old→new ownership pair.

    ``order`` is the bucketed gather permutation; ``dest`` its inverse
    (filled by the scatter build only); ``offsets[p]:offsets[p+1]`` is
    node ``p``'s slot region; ``send_counts[s, d]`` counts items moving
    from node ``s`` to node ``d``."""

    order: torch.Tensor        # (n,) i32 gather permutation
    offsets: torch.Tensor      # (P+1,) i32 slot-region boundaries
    send_counts: torch.Tensor  # (P, P) i32 per-node send/recv matrix
    moved: torch.Tensor        # (n,) bool — item changed owner
    dest: Optional[torch.Tensor] = None

    @property
    def moved_count(self) -> torch.Tensor:
        """i32 0-d tensor — items actually exchanged."""
        return self.moved.sum().to(torch.int32)

    def moved_bytes(self, bytes_per_item) -> torch.Tensor:
        """f32 0-d tensor — executed exchange volume (uniform item size)."""
        return self.moved_count.to(torch.float32) * bytes_per_item

    def moved_sum(self, weights, where=None) -> torch.Tensor:
        """f32 0-d tensor — executed exchange volume with per-item sizes
        ``weights`` (n,), optionally restricted to the live mask
        ``where`` (free fleet slots move for free).  It adds in the JAX
        package's CPU order on every device (``comm_graph.ordered_sum``):
        the volume feeds the predictive trigger's gate."""
        w = torch.where(self.moved, torch.as_tensor(
            weights, dtype=torch.float32, device=self.moved.device), 0.0)
        if where is not None:
            w = torch.where(torch.as_tensor(where, device=w.device).bool(),
                            w, 0.0)
        return ordered_sum(w)


def resolve_method(method: str, *, n: int, num_nodes: int,
                   device=None) -> str:
    """``"auto"`` → :func:`kernels.migrate.preferred_method` (for
    ``device``; the CPU rule where it is None); explicit ``"sort"`` /
    ``"scatter"`` pass through."""
    if method == "auto":
        return mig_ops.preferred_method(int(n), int(num_nodes), device)
    if method not in ("sort", "scatter"):
        raise ValueError(f"unknown manifest method {method!r}")
    return method


def build_manifest(owner_old, owner_new, num_nodes: int,
                   method: str = "auto") -> Manifest:
    """Manifest for relocating items between node slot regions;
    ``owner_old``/``owner_new`` are (n,) per-item node ids."""
    owner_old = owner_old.to(torch.int32)
    owner_new = owner_new.to(torch.int32)
    n = int(owner_new.shape[0])
    P = int(num_nodes)
    if resolve_method(method, n=n, num_nodes=P,
                      device=owner_new.device) == "scatter":
        dest, counts, offsets = mig_ops.scatter_dest(owner_new, C=P)
        # dest is a permutation here (every owner id is valid)
        order = torch.empty(n, dtype=torch.int32, device=owner_new.device)
        order[dest.long()] = torch.arange(n, dtype=torch.int32,
                                          device=owner_new.device)
    else:
        dest = None
        order = torch.argsort(owner_new, stable=True).to(torch.int32)
        counts = segment_count(owner_new, P)
        offsets = torch.cat([counts.new_zeros(1),
                             torch.cumsum(counts, 0, dtype=torch.int32)])
    send = segment_count(owner_old * P + owner_new, P * P).reshape(P, P)
    return Manifest(order=order, offsets=offsets, send_counts=send,
                    moved=owner_old != owner_new, dest=dest)


def apply_manifest(manifest: Manifest, *arrays) -> Tuple[torch.Tensor, ...]:
    """Gather every payload array into the manifest's bucketed layout."""
    idx = manifest.order.long()
    return tuple(a[idx] for a in arrays)


def build_and_apply(owner_old, owner_new, arrays: Sequence, *,
                    num_nodes: int, method: str = "auto"):
    """Build + apply: ``(relocated_arrays, manifest)``."""
    man = build_manifest(owner_old, owner_new, num_nodes, method=method)
    return apply_manifest(man, *arrays), man


migrate = build_and_apply   # the eager entry: PyTorch runs eagerly anyway


def inverse_permutation(order) -> torch.Tensor:
    """Scatter permutation undoing :func:`apply_manifest`'s gather."""
    order = order.long()
    inv = torch.empty_like(order, dtype=torch.int32)
    inv[order] = torch.arange(order.shape[0], dtype=torch.int32,
                              device=order.device)
    return inv


# ------------------------------------------------- spill (degradation) --


def spill_admissions(flow, occupancy, capacity) -> torch.Tensor:
    """Feasible admitted-flow matrix under a per-group slot budget.

    ``flow`` is the (G, G) i32 wanted move-count matrix (its diagonal,
    items staying put, is ignored), ``occupancy`` the (G,) current item
    count per group, ``capacity`` the budget (a scalar or (G,)).  Returns
    ``A`` with ``0 <= A <= off-diag(flow)`` such that every post-exchange
    count ``occupancy - A.sum(1) + A.sum(0)`` is within ``capacity``,
    cutting each round as little as possible and from the highest source
    index first (a fixed rule, so runs repeat).  Integer work: exact."""
    flow = torch.as_tensor(flow).to(torch.int32)
    dev = flow.device
    G = flow.shape[0]
    occupancy = torch.as_tensor(occupancy, device=dev).to(torch.int32)
    capacity = torch.as_tensor(capacity, device=dev).to(torch.int32)
    eye = torch.eye(G, dtype=torch.bool, device=dev)
    A = torch.where(eye, 0, flow)

    def post(A):
        return occupancy - A.sum(1) + A.sum(0)

    while bool(((post(A) > capacity).any() & (A.sum() > 0))):
        over = torch.clamp(post(A) - capacity, min=0)            # (G,)
        # per column: the flow arriving from rows below each source
        below = torch.flip(torch.cumsum(torch.flip(A, [0]), 0), [0]) - A
        cut = torch.minimum(torch.clamp(over[None, :] - below, min=0), A)
        A = (A - cut).to(torch.int32)
    return A


def spill_owner(owner_old, owner_new, *, num_nodes: int, capacity):
    """Clamp a plan's per-node inflow to ``capacity`` by deferring moves.

    Items whose admission would push their destination over the budget
    keep their old owner and retry at the next rebalance; within each
    (src, dst) flow the first items in slab order are admitted.  Returns
    ``(owner_eff, deferred)``.  The within-flow ranks go through the
    counting scatter over C = num_nodes² pair buckets (on a card up to
    ``kernels.migrate.ops.MAX_C``, radix digits above the shared form)."""
    P = int(num_nodes)
    oo = torch.as_tensor(owner_old).to(torch.int32)
    on = torch.as_tensor(owner_new).to(torch.int32)
    move = on != oo
    pair = oo * P + on
    F = segment_count(torch.where(move, pair, P * P), P * P).reshape(P, P)
    occ = segment_count(oo, P)
    A = spill_admissions(F, occ, capacity)
    # stable within-flow rank: admitted = the first A[src, dst] movers of
    # each flow in slab order (non-movers rank against the padding id)
    rank, _ = mig_ops.bucket_ranks(torch.where(move, pair, P * P), C=P * P)
    quota = A.reshape(-1)[pair.clamp(0, P * P - 1).long()]
    admitted = move & (rank < quota)
    deferred = move & ~admitted
    return torch.where(deferred, oo, on), deferred
