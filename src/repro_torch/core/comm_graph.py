"""Problem representation for the load balancer.

Per-object loads, optional logical coordinates, a sparse weighted
object-communication graph, and the current object→node assignment, as
fixed-shape tensors on one device.  Counterpart of ``repro.core.comm_graph``.

Float segment sums here feed planning decisions, so they must give the
same bits on every run and on every device: :func:`segment_sum` adds each
segment's items one at a time in index order (on the CPU a stable sort and
``segment_reduce``, on a card K4's ordered form), never a float
``index_add_``, whose CUDA atomics add in a varying order; and
:func:`cumsum` replaces ``torch.cumsum``, whose CUDA scan adds floats in
an order that varies from run to run and whose CPU scan accumulates
float32 in float64: it adds in the order the JAX package's ``jnp.cumsum``
adds in on the CPU, on every device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import resolve_device
from repro_torch.kernels.histogram.ops import histogram_ordered


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = Σ_{i: ids_i = s} values_i`` in a fixed order.

    The same bits on every device: each segment's items are added in
    index order (the order XLA's CPU ``segment_sum`` adds in) — on the CPU
    by a stable sort and ``segment_reduce``, on a card for f32 by K4's
    ordered form (``torch.segment_reduce``'s CUDA reduction adds in
    another order).  Ids outside ``[0, num_segments)`` are dropped, as
    ``jax.ops.segment_sum`` drops them."""
    S = int(num_segments)
    if values.is_cuda and values.dtype == torch.float32:
        return histogram_ordered(segment_ids, values, C=S)
    ids = segment_ids.to(torch.int64)
    ids = torch.where((ids >= 0) & (ids < S), ids, S)       # drop bucket S
    order = torch.sort(ids, stable=True).indices
    sorted_ids = ids[order]
    bounds = torch.searchsorted(
        sorted_ids, torch.arange(S + 2, device=ids.device))
    lengths = bounds.diff()
    out = torch.segment_reduce(values[order], "sum", lengths=lengths,
                               unsafe=True)
    return out[:S].to(values.dtype)


#: XLA's CPU cumsum is a reduce-window that XLA rewrites into a scan of
#: 16-element blocks (sequential within a block, the block totals scanned
#: the same way, recursively); :func:`cumsum` reproduces that order
SCAN_BLOCK = 16


def _sequential_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along dim 1 of a (rows, B) tensor, each row
    added left to right."""
    cols = [x[:, 0]]
    for k in range(1, x.shape[1]):
        cols.append(cols[-1] + x[:, k])
    return torch.stack(cols, dim=1)


def cumsum(values: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D tensor, the same bits on every run
    and every device.

    Integers take ``torch.cumsum`` (exact in any order).  Floats are
    added in the order of the JAX package's ``jnp.cumsum`` on the CPU
    (XLA's blocked scan, :data:`SCAN_BLOCK`): left to right within each
    block of 16, then each block offset by the exclusive prefix of the
    block totals, themselves scanned the same way.  Neither
    ``torch.cumsum`` gives those bits: on the CPU it accumulates float32
    in float64, and on CUDA its scan adds in an order that varies from
    run to run.  Stage 3's take-while compares these sums with a budget,
    so the order decides which objects move."""
    if not values.is_floating_point():
        return torch.cumsum(values, 0)
    n = values.shape[0]
    B = SCAN_BLOCK
    if n <= B:
        return _sequential_rows(values[None, :])[0] if n else values
    rows = -(-n // B)
    x = torch.cat([values, values.new_zeros(rows * B - n)]).reshape(rows, B)
    inner = _sequential_rows(x)
    carry = cumsum(inner[:, -1].contiguous())
    carry = torch.cat([carry.new_zeros(1), carry[:-1]])
    return (inner + carry[:, None]).reshape(-1)[:n]


def segment_count(segment_ids: torch.Tensor, num_segments: int,
                  dtype=torch.int32) -> torch.Tensor:
    """Integer item count per segment (integer adds: exact in any order);
    ids outside ``[0, num_segments)`` are dropped."""
    S = int(num_segments)
    ids = segment_ids.to(torch.int64)
    ids = torch.where((ids >= 0) & (ids < S), ids, S)
    out = torch.zeros(S + 1, dtype=dtype, device=ids.device)
    out.index_add_(0, ids, torch.ones_like(ids, dtype=dtype))
    return out[:S]


def prefix_group_edges(group, loads, active=None, *,
                       ring_eps: float = 1e-3):
    """Prefix-sharing comm edges for a session fleet, on its device.

    ``group`` is (S,) i32 — per-object group ids in ``[0, S)``, ``-1`` for
    ungrouped slots; ``active`` an optional (S,) bool live mask (``None``:
    every slot live); ``loads`` (S,) f32, already floored by the caller.
    Returns ``(edges_src, edges_dst, edges_bytes)`` of shape ``(2*S,)``:

      * star edges — each live grouped slot to its group's leader (the
        lowest live grouped slot index of the group, a segment min),
        weighted ``min(load_member, load_leader)``;
      * ring edges — live slot ``i`` to ``i+1 (mod S)`` at ``ring_eps``
        when both are live, so singleton groups still give a connected
        graph.

    Unused entries are ``(-1, -1, 0.0)``.  Integer outputs are exact."""
    dev = loads.device
    group = group.to(torch.int32)
    loads = loads.to(torch.float32)
    S = int(group.shape[0])
    idx = torch.arange(S, dtype=torch.int32, device=dev)
    live = (torch.ones(S, dtype=torch.bool, device=dev) if active is None
            else active.to(torch.bool))
    grouped = live & (group >= 0)
    # leader election: lowest live grouped slot index per group id (other
    # slots go to the out-of-range bucket S); integer min, exact
    seg = torch.where(grouped, group, S).long()
    leader_of_group = torch.full((S + 1,), S, dtype=torch.int32, device=dev)
    leader_of_group.scatter_reduce_(0, seg, torch.where(grouped, idx, S),
                                    "amin")
    leader = torch.where(grouped,
                         leader_of_group[group.clamp(0, S - 1).long()], -1)
    is_member = grouped & (leader != idx)     # leaders carry no self-edge
    star_src = torch.where(is_member, idx, -1)
    star_dst = torch.where(is_member, leader, -1)
    star_w = torch.where(
        is_member,
        torch.minimum(loads, loads[leader.clamp(0, S - 1).long()]), 0.0)
    ring_on = live & torch.roll(live, -1)
    ring_src = torch.where(ring_on, idx, -1)
    ring_dst = torch.where(ring_on, (idx + 1) % S, -1)
    ring_w = torch.where(ring_on, torch.tensor(ring_eps, dtype=torch.float32,
                                               device=dev), 0.0)
    return (torch.cat([star_src, ring_src]).to(torch.int32),
            torch.cat([star_dst, ring_dst]).to(torch.int32),
            torch.cat([star_w, ring_w]))


@dataclasses.dataclass(frozen=True)
class LBProblem:
    """A load-balancing problem instance.

    Attributes:
      loads:       (N,) f32 — per-object computational load.
      assignment:  (N,) i32 — current object→node map, values in [0, P).
      edges_src:   (E,) i32 — object comm graph, directed half (symmetrized
                   on use).  Padded entries use src == dst == -1, bytes == 0.
      edges_dst:   (E,) i32
      edges_bytes: (E,) f32 — bytes exchanged per LB period on this edge.
      num_nodes:   int P.
      coords:      (N, D) f32 or None — logical positions (coordinate variant).
    """

    loads: torch.Tensor
    assignment: torch.Tensor
    edges_src: torch.Tensor
    edges_dst: torch.Tensor
    edges_bytes: torch.Tensor
    num_nodes: int
    coords: Optional[torch.Tensor] = None

    @property
    def num_objects(self) -> int:
        return int(self.loads.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edges_src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.loads.device

    def with_assignment(self, assignment: torch.Tensor) -> "LBProblem":
        return dataclasses.replace(self, assignment=assignment)

    def to(self, device) -> "LBProblem":
        dev = resolve_device(device)
        return LBProblem(
            loads=self.loads.to(dev), assignment=self.assignment.to(dev),
            edges_src=self.edges_src.to(dev),
            edges_dst=self.edges_dst.to(dev),
            edges_bytes=self.edges_bytes.to(dev), num_nodes=self.num_nodes,
            coords=None if self.coords is None else self.coords.to(dev))

    def validate(self) -> None:
        """Host-side sanity checks (tests / debugging)."""
        a = self.assignment.cpu().numpy()
        if a.ndim != 1 or a.shape[0] != self.num_objects:
            raise ValueError("assignment must be (N,)")
        if (a < 0).any() or (a >= self.num_nodes).any():
            raise ValueError("bad assignment")
        s = self.edges_src.cpu().numpy()
        d = self.edges_dst.cpu().numpy()
        pad = s < 0
        if (s[~pad] >= self.num_objects).any() or \
                (d[~pad] >= self.num_objects).any():
            raise ValueError("edge endpoint out of range")
        if (self.edges_bytes.cpu().numpy()[pad] != 0).any():
            raise ValueError("padded edges must carry zero bytes")


def node_loads(problem: LBProblem) -> torch.Tensor:
    """(P,) total load per node."""
    return segment_sum(problem.loads, problem.assignment, problem.num_nodes)


def node_comm_matrix(problem: LBProblem) -> torch.Tensor:
    """(P, P) symmetric inter-node communication volume in bytes.

    The diagonal holds *intra-node* bytes (used by the external/internal
    metric)."""
    P = problem.num_nodes
    valid = problem.edges_src >= 0
    a = problem.assignment.to(torch.int64)
    src_n = torch.where(valid, a[problem.edges_src.clamp(min=0).long()], 0)
    dst_n = torch.where(valid, a[problem.edges_dst.clamp(min=0).long()], 0)
    w = torch.where(valid, problem.edges_bytes, 0.0)
    m = segment_sum(w, src_n * P + dst_n, P * P).reshape(P, P)
    return m + m.T  # symmetrize; diagonal counts both directions of intra


def make_problem(loads, assignment, edges, edge_bytes, num_nodes: int,
                 coords=None, *, device="cuda") -> LBProblem:
    """Convenience constructor from host arrays (``edges`` is (E, 2))."""
    dev = resolve_device(device)
    edges = np.asarray(edges, dtype=np.int32).reshape(-1, 2)

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    return LBProblem(
        loads=t(loads, torch.float32),
        assignment=t(assignment, torch.int32),
        edges_src=t(edges[:, 0], torch.int32),
        edges_dst=t(edges[:, 1], torch.int32),
        edges_bytes=t(edge_bytes, torch.float32),
        num_nodes=int(num_nodes),
        coords=None if coords is None else t(coords, torch.float32),
    )


def common_shape(problems) -> tuple:
    """``(num_nodes, num_objects)`` shared by every problem of a batch;
    ``ValueError`` if there is none (or no problem)."""
    if not problems:
        raise ValueError("a batch needs at least one problem")
    P, N = problems[0].num_nodes, problems[0].num_objects
    for p in problems:
        if p.num_nodes != P or p.num_objects != N:
            raise ValueError(
                "a batch needs a common (num_nodes, num_objects) shape; "
                f"got ({p.num_nodes}, {p.num_objects}) vs ({P}, {N})")
    return P, N


def stack_problems(problems) -> LBProblem:
    """Stack B same-shaped problems into one batched ``LBProblem``.

    Every tensor gains a leading batch axis — the input of
    ``engine.LBEngine.plan_batch_fn``.  Requirements: identical
    ``num_nodes`` and object count; edge lists may differ in length and
    are padded to the longest with the standard (-1, -1, 0.0) padding
    (every consumer masks on ``edges_src >= 0``).  ``coords`` are kept
    only when every problem has them (the comm variant never reads them).
    The batch lives on the first problem's device."""
    problems = list(problems)
    P, _ = common_shape(problems)
    E = max(p.num_edges for p in problems)
    dev = problems[0].device

    def stack(field, dtype, fill=None):
        rows = []
        for p in problems:
            a = getattr(p, field).to(device=dev, dtype=dtype)
            if fill is not None and a.shape[0] < E:
                a = torch.cat([a, a.new_full((E - a.shape[0],), fill)])
            rows.append(a)
        return torch.stack(rows)

    keep_coords = all(p.coords is not None for p in problems)
    return LBProblem(
        loads=stack("loads", torch.float32),
        assignment=stack("assignment", torch.int32),
        edges_src=stack("edges_src", torch.int32, -1),
        edges_dst=stack("edges_dst", torch.int32, -1),
        edges_bytes=stack("edges_bytes", torch.float32, 0.0),
        num_nodes=P,
        coords=stack("coords", torch.float32) if keep_coords else None)


def lane(problems: LBProblem, b: int) -> LBProblem:
    """Problem ``b`` of a stacked batch (its edges keep the padding)."""
    return LBProblem(
        loads=problems.loads[b], assignment=problems.assignment[b],
        edges_src=problems.edges_src[b], edges_dst=problems.edges_dst[b],
        edges_bytes=problems.edges_bytes[b], num_nodes=problems.num_nodes,
        coords=None if problems.coords is None else problems.coords[b])
