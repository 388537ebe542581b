"""Device-resident payload migration: the *apply* half of a rebalance
(counterpart of the single-device half of ``repro.runtime.migrate``).

:func:`build_manifest` turns an old→new owner pair into a ``Manifest``;
:func:`apply_manifest` executes it as a bucketed gather that puts each
node's items in one contiguous slot region (stable: by new owner, ties by
previous position).  ``method`` picks how the permutation is built:
``"sort"`` (stable argsort), ``"scatter"`` (the sort-free counting scatter
of ``kernels.migrate``) or ``"auto"`` (``kernels.migrate.preferred_method``).
Every method gives the identical ``order``.

The ring and sharded exchanges and the spill mode belong to a later slice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core.comm_graph import segment_count
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


def resolve_method(method: str, *, n: int, num_nodes: int) -> str:
    """``"auto"`` → :func:`kernels.migrate.preferred_method`; explicit
    ``"sort"`` / ``"scatter"`` pass through."""
    if method == "auto":
        return mig_ops.preferred_method(int(n), int(num_nodes))
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
    if resolve_method(method, n=n, num_nodes=P) == "scatter":
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
