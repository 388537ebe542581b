"""A 1-D mesh of D shards held by one process on one device.

The JAX package runs its sharded planner and replays under ``shard_map``
over a 1-D ``"lb"`` device mesh (virtual CPU devices in its tests).  Here
the D shards live in one process as the **leading axis** of every
per-shard tensor: shard ``d``'s block of a row-sharded (n,) vector is row
``d`` of a (D, n/D) tensor, and a value every shard holds alike
("replicated") is one tensor without that axis.  A per-shard body then
runs once over all D rows, as ``jax.vmap`` would run it, and the
collectives become tensor operations:

  * :meth:`ShardMesh.ring_shift` — ``ppermute`` over ``[(d, (d-1) % D)]``:
    afterwards shard ``me`` holds the block shard ``me+1`` held
    (``torch.roll(buf, -1, 0)``), an exact copy;
  * :meth:`ShardMesh.psum` — the sum of the D partials (exact for integer
    partials; for float partials it reassociates the additions, as a
    ``psum`` does);
  * :meth:`ShardMesh.all_gather` — the D blocks concatenated in shard
    order (``tiled=True``), an exact copy.

:func:`resolve_mesh` derives a mesh from a ``mesh`` / ``num_shards`` spec
with the JAX package's rules (``replay_shard._resolve_mesh``): not both;
every extent must divide D; ``num_shards=None`` resolves to the number of
real devices dividing the extents, which is 1 — one card, or the CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import resolve_device

class ShardMesh:
    """D shards as the leading axis of tensors on one ``device``."""

    def __init__(self, num_shards: int, device="cuda"):
        D = int(num_shards)
        if D < 1:
            raise ValueError(f"num_shards={num_shards} must be >= 1")
        self.num_shards = D
        self.device = resolve_device(device)

    def __repr__(self) -> str:
        return f"ShardMesh(num_shards={self.num_shards}, device={self.device})"

    def __eq__(self, other) -> bool:
        return (isinstance(other, ShardMesh)
                and other.num_shards == self.num_shards
                and other.device == self.device)

    def __hash__(self) -> int:
        return hash((self.num_shards, str(self.device)))

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """Row-shard a global (n, ...) tensor: (D, n/D, ...)."""
        D = self.num_shards
        if x.shape[0] % D:
            raise ValueError(f"extent {x.shape[0]} does not divide over "
                             f"{D} shards")
        return x.reshape(D, x.shape[0] // D, *x.shape[1:])

    def ring_shift(self, buf: torch.Tensor) -> torch.Tensor:
        """One ring hop: shard ``me`` receives shard ``me+1``'s block."""
        return torch.roll(buf, -1, 0)

    def psum(self, partial: torch.Tensor) -> torch.Tensor:
        """Sum of the D per-shard partials (leading axis), replicated."""
        return partial.sum(0)

    def all_gather(self, block: torch.Tensor) -> torch.Tensor:
        """The D blocks of a (D, m, ...) tensor in shard order, (D·m, ...)."""
        return block.reshape(-1, *block.shape[2:])


def num_devices(device) -> int:
    """Real devices one process of the port drives: one (a card or the
    CPU).  The counterpart of ``len(jax.devices())`` on one device."""
    resolve_device(device)
    return 1


def resolve_mesh(mesh: Optional[ShardMesh], num_shards: Optional[int],
                 must_divide: Tuple[int, ...], device="cuda") -> ShardMesh:
    """A mesh whose shard count divides every extent in ``must_divide``.

    ``mesh`` is taken as given (checked); ``num_shards`` builds one on
    ``device``; neither resolves to the largest count up to the number of
    real devices that divides the extents (one on one device)."""
    if mesh is not None:
        if num_shards is not None:
            raise ValueError("pass either mesh or num_shards, not both")
        if not isinstance(mesh, ShardMesh):
            raise TypeError("mesh must be a distributed.mesh.ShardMesh")
        D = mesh.num_shards
        bad = [m for m in must_divide if m % D]
        if bad:
            raise ValueError(
                f"extents {bad} do not divide over the {D}-shard mesh")
        return mesh
    if num_shards is not None:
        D = int(num_shards)
        if D < 1:
            raise ValueError(f"num_shards={num_shards} must be >= 1")
        bad = [m for m in must_divide if m % D]
        if bad:
            raise ValueError(
                f"extents {bad} do not divide over num_shards={D}")
    else:
        D = min([num_devices(device)] + [int(m) for m in must_divide])
        while any(m % D for m in must_divide):
            D -= 1
    return ShardMesh(D, device)
