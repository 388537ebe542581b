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
The mesh-sharded exchange (:func:`migrate_sharded`, its per-shard body
:func:`ring_exchange`) runs on a ``distributed.mesh.ShardMesh``: the D
shards are the leading axis of (D, m) slabs on one device.  Each shard
owns a contiguous node range; the blocks rotate D-1 ring hops and every
shard scatters the items it owns into its (capacity,) slab as they pass,
at positions from the all-gathered (D, P) count matrix and the stable
within-bucket rank of ``kernels.migrate.bucket_ranks`` (K3 on a card),
so the concatenated per-shard valid prefixes are the single-device
bucketed layout bit for bit.  ``mode="spill"`` clamps each shard's
inflow to the slab instead (the :func:`spill_admissions` fixed point).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.comm_graph import ordered_sum, segment_count
from repro_torch.kernels import migrate as mig_ops


class CapacityOverflowError(ValueError):
    """A migration would exceed a per-shard or per-node slot budget.

    Raised by the eager entries: :func:`migrate_sharded` in its default
    ``on_overflow="strict"`` mode, and :func:`migrate` given a
    ``capacity``.  Fields: ``capacity``, ``counts`` (inflow per unit),
    ``offending`` (unit ids over budget), ``unit`` (``"shard"`` or
    ``"node"``)."""

    def __init__(self, *, capacity: int, counts, unit: str = "shard"):
        self.capacity = int(capacity)
        self.counts = [int(c) for c in np.asarray(counts).ravel()]
        self.unit = str(unit)
        self.offending = [i for i, c in enumerate(self.counts)
                          if c > self.capacity]
        super().__init__(
            f"per-{self.unit} capacity={self.capacity} overflowed: inflow "
            f"counts per {self.unit} {self.counts} exceed the budget at "
            f"{self.unit} ids {self.offending}; the exchange would have "
            "dropped payload — raise capacity (n is always safe) or use "
            "on_overflow='spill'")


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


def migrate(owner_old, owner_new, arrays: Sequence, *, num_nodes: int,
            method: str = "auto", capacity: Optional[int] = None):
    """Eager single-device migration: ``(relocated_arrays, manifest)``.
    ``capacity``, if given, bounds every node's slot count after the
    exchange; exceeding it raises :class:`CapacityOverflowError` (unit
    ``"node"``) with the per-node counts."""
    out, man = build_and_apply(owner_old, owner_new, arrays,
                               num_nodes=num_nodes, method=method)
    if capacity is not None:
        counts = man.offsets.diff().cpu().numpy()
        if (counts > int(capacity)).any():
            raise CapacityOverflowError(capacity=capacity, counts=counts,
                                        unit="node")
    return out, man


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


# ----------------------------------------------------- sharded exchange --


def _excl_rows(a: torch.Tensor) -> torch.Tensor:
    """(G+1, ...) exclusive prefix sums of an integer (G, ...) tensor
    along its first axis (row g: the sum of rows before g)."""
    return torch.cat([torch.zeros_like(a[:1]), torch.cumsum(a, 0).to(
        a.dtype)])


def _new_slabs(D: int, capacity: int, like: torch.Tensor) -> torch.Tensor:
    """(D, capacity + 1, ...) zero slabs like the (D, m, ...) ``like``; slot ``capacity`` is the trash
    slot that takes every write the exchange does not keep (the
    counterpart of a ``mode="drop"`` scatter at ``pos = capacity``)."""
    return torch.zeros((D, capacity + 1) + tuple(like.shape[2:]),
                       dtype=like.dtype, device=like.device)


def _scatter_slabs(out: torch.Tensor, pos: torch.Tensor,
                   vals: torch.Tensor) -> None:
    """``out[d, pos[d, i]] = vals[d, i]`` for every shard d in one
    indexed write; ``pos`` must lie in ``[0, capacity]`` (the trash slot
    takes the writes that several items may make)."""
    D, width = out.shape[0], out.shape[1]
    lin = (torch.arange(D, device=pos.device)[:, None] * width
           + pos.long()).reshape(-1)
    out.view(D * width, -1)[lin] = vals.reshape(lin.shape[0], -1)


def ring_exchange(owner_loc, arr_loc: Tuple, *, num_nodes: int, mesh,
                  capacity: int, count_loc=None, mode: str = "strict"):
    """Per-shard ring all-to-all on a ``ShardMesh`` (counterpart of
    ``repro.runtime.migrate.ring_exchange``, which runs under
    ``shard_map``).

    ``owner_loc`` is the (D, m) slab of new owner ids, ``arr_loc`` the
    (D, m, ...) payload slabs.  Shard ``d`` owns nodes
    ``[d*rpd, (d+1)*rpd)``.  The blocks rotate D-1 ring hops; at hop
    ``s`` shard ``me`` sees the block of shard ``(me+s) % D`` and
    scatters the items it owns into its (capacity,) output at the global
    bucket position: the base of the item's node within the shard, the
    items of earlier source shards in that bucket (from the all-gathered
    (D, P) counts), and the stable within-bucket rank from
    ``kernels.migrate.bucket_ranks`` — one call a hop over all D blocks
    (C = ``num_nodes``; the buckets a shard accepts belong to it alone,
    so the ranks are per shard).

    ``count_loc`` ((D,) i32, optional) marks only each shard's first
    ``count_loc[d]`` slots live.  ``mode="strict"`` assumes the plan fits
    (the caller checks the returned counts; positions past ``capacity``
    go to the trash slot); ``mode="spill"`` clamps each shard's inflow to
    ``capacity`` (:func:`_ring_exchange_spill`).

    Returns ``(out_owner (D, capacity), outs, count_me (D,))`` — plus
    ``deferred`` (0-d i32) in spill mode."""
    if mode not in ("strict", "spill"):
        raise ValueError(f"unknown ring_exchange mode {mode!r}")
    D = mesh.num_shards
    P = int(num_nodes)
    rpd = P // D
    capacity = int(capacity)
    owner_loc = owner_loc.to(torch.int32)
    dev = owner_loc.device
    m = owner_loc.shape[1]
    me = torch.arange(D, device=dev)[:, None]
    slots = torch.arange(m, device=dev)[None, :]
    live = (torch.ones_like(owner_loc, dtype=torch.bool) if count_loc is None
            else slots < count_loc.to(dev)[:, None])
    # padding slots carry stale owner ids: bucket P counts nowhere
    owner_loc = torch.where(live, owner_loc, P)
    counts = segment_count(
        torch.where(live, me * P + owner_loc, D * P).reshape(-1),
        D * P).reshape(D, P)     # all-gathered (D, P)
    if mode == "spill":
        return _ring_exchange_spill(
            owner_loc, arr_loc, live=live, counts=counts, num_nodes=P,
            mesh=mesh, capacity=capacity)
    bucket = counts.sum(0)                          # (P,) global sizes
    my_sizes = bucket.reshape(D, rpd)
    my_base = _excl_rows(my_sizes.T).T[:, :rpd]     # (D, rpd)
    before_src = _excl_rows(counts)                 # (D+1, P)
    out_owner = _new_slabs(D, capacity, owner_loc)
    outs = [_new_slabs(D, capacity, a) for a in arr_loc]
    buf = (owner_loc,) + tuple(arr_loc)
    for s in range(D):
        src = (me + s) % D                          # (D, 1)
        pe = buf[0]
        accept = torch.div(pe, rpd, rounding_mode="floor") == me
        rank, _ = mig_ops.bucket_ranks(
            torch.where(accept, pe, P).reshape(-1), C=P)
        rank = rank.reshape(D, m)
        before = before_src[src[:, 0]]              # (D, P)
        r = (pe - me * rpd).clamp(0, rpd - 1).long()
        pos = (my_base.gather(1, r) + before.gather(
            1, pe.clamp(0, P - 1).long()) + rank)
        pos = torch.where(accept & (pos < capacity), pos, capacity)
        _scatter_slabs(out_owner, pos, pe)
        for o, v in zip(outs, buf[1:]):
            _scatter_slabs(o, pos, v)
        if s + 1 < D:
            buf = tuple(mesh.ring_shift(b) for b in buf)
    count_me = my_sizes.sum(1).to(torch.int32)
    return (out_owner[:, :capacity], tuple(o[:, :capacity] for o in outs),
            count_me)


def _ring_exchange_spill(owner_loc, arr_loc, *, live, counts,
                         num_nodes: int, mesh, capacity: int):
    """Spill-mode ring body (see :func:`ring_exchange`).

    Admission is decided on the source shard from the (D, D) shard-flow
    matrix, travels with the payload around the ring, and the destination
    places admitted items at ``kept prefix + admitted flow from earlier
    sources + within-flow rank``, every position inside the slab by the
    fixed point's feasibility.  The within-flow ranks are one
    ``bucket_ranks`` call over all D slabs (C = D·D: a bucket for each
    (source shard, destination shard) flow)."""
    D = mesh.num_shards
    P = int(num_nodes)
    rpd = P // D
    dev = owner_loc.device
    me = torch.arange(D, device=dev)[:, None]
    flow = counts.reshape(D, D, rpd).sum(-1)        # (D, D) wanted flow
    occ = counts.sum(1)                             # (D,) live counts
    A = spill_admissions(flow, occ, capacity)       # (D, D) admitted
    dshard = torch.clamp(torch.div(owner_loc, rpd, rounding_mode="floor"),
                         max=D)                     # padding -> D
    fid = torch.where(live & (dshard != me), dshard, D)
    rank, _ = mig_ops.bucket_ranks(
        torch.where(fid < D, me * D + fid, D * D).reshape(-1), C=D * D)
    rank = rank.reshape(fid.shape).to(torch.int32)
    quota = A.gather(1, dshard.clamp(0, D - 1).long())
    admitted = (fid < D) & (rank < quota)
    keep = live & ~admitted
    kept_me = keep.sum(1)                           # (D,)
    # kept items (stays and deferred movers, desired owner kept) compact
    # to the slab prefix in slab order
    kpos = torch.where(keep, torch.cumsum(keep.to(torch.int32), 1) - 1,
                       capacity)
    out_owner = _new_slabs(D, capacity, owner_loc)
    outs = [_new_slabs(D, capacity, a) for a in arr_loc]
    _scatter_slabs(out_owner, kpos, owner_loc)
    for o, v in zip(outs, arr_loc):
        _scatter_slabs(o, kpos, v)
    A_before = _excl_rows(A)                        # (D+1, D)
    buf = (owner_loc, admitted.to(torch.int32), rank) + tuple(arr_loc)
    for s in range(1, D):
        buf = tuple(mesh.ring_shift(b) for b in buf)
        src = ((me + s) % D)[:, 0]                  # (D,)
        pe_b, adm_b, rank_b = buf[0], buf[1], buf[2]
        accept = (adm_b == 1) & (torch.clamp(torch.div(
            pe_b, rpd, rounding_mode="floor"), max=D) == me)
        base = kept_me + A_before[src, me[:, 0]]    # (D,)
        pos = torch.where(accept, base[:, None] + rank_b, capacity)
        pos = torch.where(pos < capacity, pos, capacity)
        _scatter_slabs(out_owner, pos, pe_b)
        for o, v in zip(outs, buf[3:]):
            _scatter_slabs(o, pos, v)
    count_me = (kept_me + A.sum(0)).to(torch.int32)
    eye = torch.eye(D, dtype=torch.bool, device=dev)
    deferred = (torch.where(eye, 0, flow).sum() - A.sum()).to(torch.int32)
    return (out_owner[:, :capacity], tuple(o[:, :capacity] for o in outs),
            count_me, deferred)


def planned_capacity(owner_new, *, num_nodes: int, num_shards: int) -> int:
    """The tight per-shard slot budget of a plan: the largest total
    bucket size of the nodes one shard owns (one host read)."""
    counts = np.bincount(torch.as_tensor(owner_new).cpu().numpy(),
                         minlength=num_nodes)
    per_shard = counts.reshape(num_shards, num_nodes // num_shards).sum(1)
    return max(1, int(per_shard.max()))


def migrate_sharded(owner_new, arrays: Sequence, *, num_nodes: int,
                    mesh=None, capacity: Optional[int] = None,
                    on_overflow: str = "strict"):
    """Ring all-to-all payload exchange over a ``ShardMesh``.

    ``owner_new`` / ``arrays`` are the global (n,) buffers, row-sharded
    over the mesh (n and ``num_nodes`` must divide the shard count).
    ``mesh`` defaults to one shard on ``owner_new``'s device.
    ``capacity`` is the per-shard slot budget; ``None`` takes the plan's
    own bound (:func:`planned_capacity`; in spill mode at least the
    current occupancy n/D).  ``on_overflow="strict"`` raises
    :class:`CapacityOverflowError` where a shard's inflow exceeds the
    budget; ``"spill"`` executes the admissible part and returns the
    deferred count as well.

    Returns ``(owner_out, arrays_out, counts)``: (D·capacity,) padded
    buffers (shard d's valid prefix ``[d·capacity, d·capacity +
    counts[d])``) and (D,) counts — plus ``deferred`` (int) in spill
    mode.  In strict mode the concatenated valid prefixes equal
    :func:`apply_manifest`'s layout bit for bit."""
    from repro_torch.distributed.mesh import ShardMesh

    if on_overflow not in ("strict", "spill"):
        raise ValueError(f"unknown on_overflow mode {on_overflow!r}")
    owner_new = torch.as_tensor(owner_new).to(torch.int32)
    if mesh is None:
        mesh = ShardMesh(1, owner_new.device)
    D = mesh.num_shards
    dev = mesh.device
    owner_new = owner_new.to(dev)
    n = int(owner_new.shape[0])
    if n % D or num_nodes % D:
        raise ValueError(
            f"n={n} and num_nodes={num_nodes} must divide the {D}-shard "
            "mesh")
    spill = on_overflow == "spill"
    if capacity is None:
        capacity = planned_capacity(owner_new, num_nodes=num_nodes,
                                    num_shards=D)
        if spill:
            capacity = max(capacity, n // D)
    if spill and int(capacity) < n // D:
        raise ValueError(
            f"spill capacity={int(capacity)} is below the per-shard "
            f"occupancy {n // D}; the current slabs must already fit")
    arrays = tuple(torch.as_tensor(a).to(dev) for a in arrays)
    out = ring_exchange(mesh.shard(owner_new),
                        tuple(mesh.shard(a) for a in arrays),
                        num_nodes=int(num_nodes), mesh=mesh,
                        capacity=int(capacity), mode=on_overflow)
    owner_out = out[0].reshape(-1)
    outs = tuple(o.reshape(-1, *o.shape[2:]) for o in out[1])
    counts = out[2]
    if spill:
        return owner_out, outs, counts, int(out[3])
    if (counts > int(capacity)).any():
        raise CapacityOverflowError(capacity=capacity,
                                    counts=counts.cpu().numpy(),
                                    unit="shard")
    return owner_out, outs, counts
