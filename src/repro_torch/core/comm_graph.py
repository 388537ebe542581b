"""Problem representation for the load balancer.

Per-object loads, optional logical coordinates, a sparse weighted
object-communication graph, and the current object→node assignment, as
fixed-shape tensors on one device.  Counterpart of ``repro.core.comm_graph``.

Float segment sums here feed planning decisions, so they must give the
same bits on every run: :func:`segment_sum` is a sort-based reduction
(stable sort by segment, then one sequential sum per segment), never a
float ``index_add_``, whose CUDA atomics add in a varying order; and
:func:`cumsum` replaces ``torch.cumsum``, whose CUDA scan adds floats in
an order that varies from run to run.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import resolve_device


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = Σ_{i: ids_i = s} values_i`` in a fixed order.

    Deterministic on every device: items are stably sorted by segment and
    each segment is summed in index order (the order XLA's CPU
    ``segment_sum`` adds in).  Ids outside ``[0, num_segments)`` are
    dropped, as ``jax.ops.segment_sum`` drops them."""
    S = int(num_segments)
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


def cumsum(values: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along dim 0, the same bits on every run.

    On the CPU ``torch.cumsum`` adds in index order (as XLA's CPU cumsum
    does).  On CUDA ``torch.cumsum`` is a decoupled look-back scan whose
    float additions vary with timing, so a float tensor there takes a
    Hillis–Steele scan instead: log2(n) rounds of shifted adds, each
    element's partial sums combined in one fixed order."""
    if values.device.type == "cpu" or not values.is_floating_point():
        return torch.cumsum(values, 0)
    out = values
    k = 1
    while k < out.shape[0]:
        out = torch.cat([out[:k], out[k:] + out[:-k]])
        k *= 2
    return out


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
