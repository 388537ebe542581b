"""Mesh construction (counterpart of ``repro.launch.mesh``).

The JAX package builds ``jax.make_mesh`` device meshes: 16 × 16 (data,
model) for one pod, 2 × 16 × 16 (pod, data, model) for two.  The port's
mesh is a ``distributed.mesh.ShardMesh``: the shards of every axis as one
leading tensor axis on one device (each an EP rank of ``moe_a2a``).  The
JAX package's partition rules (``distributed/sharding.py``,
``params.pspec_tree``) and its JAX-version shim (``distributed/compat.py``)
have no counterpart: one card holds every shard.
"""
from __future__ import annotations

import math

from repro_torch.distributed.mesh import ShardMesh


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> ShardMesh:
    """256 shards (16 × 16), or 512 (2 × 16 × 16) for two pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    return ShardMesh(math.prod(shape), device)


def make_host_mesh(data: int = 1, model: int = 1,
                   device="cuda") -> ShardMesh:
    """A small mesh for tests and examples: ``data · model`` shards."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh extents must be >= 1, got {data} x {model}")
    return ShardMesh(data * model, device)
