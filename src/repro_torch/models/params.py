"""Parameter declaration (counterpart of ``repro.models.params``).

Architectures declare parameters as ``ParamSpec`` trees (nested dicts and
lists of shape + partition axes + initializer).  :func:`init_params`
materializes one on a device, :func:`init_blocks` one rank's blocks of
it (each leaf drawn row by row, so a block has the bits it has in the
whole leaf), :func:`shape_dtype_tree` gives its shapes and types without
weights and :func:`count_params` counts it without allocating.
``ParamSpec.spec`` is the JAX leaf's ``PartitionSpec`` axes (a layer of
a scanned group without the group's leading replicated axis);
``distributed.sharding`` turns it into a placement on a mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import numpy as np
import torch

from repro_torch.kernels import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    spec: Tuple[Any, ...]       # PartitionSpec axes, one entry a dim
    init: str = "normal"        # normal | zeros | ones
    scale: float = 0.02
    dtype: str = "float32"


def tree_map(fn: Callable[[Any], Any], tree):
    """Apply ``fn`` to every leaf of a tree of dicts and lists (``None``
    stays ``None``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return rebuild(tree, [tree_map(fn, v) for v in tree])
    return None if tree is None else fn(tree)


def rebuild(tree, parts):
    """A list or tuple of ``tree``'s type holding ``parts``, with the
    attributes of a list subclass carried across (a cache over a mesh
    keeps its ``placements``)."""
    if hasattr(tree, "_fields"):                 # a NamedTuple
        return type(tree)(*parts)
    out = type(tree)(parts)
    if hasattr(tree, "__dict__"):
        vars(out).update(vars(tree))
    return out


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def init_params(tree, seed: int = 0, device="cuda"):
    """Materialize weights on ``device``, drawing every ``normal`` leaf in
    tree order from one ``torch.Generator`` seeded with ``seed`` (on that
    device).  The numbers differ from the JAX package's: tests carry
    weights across with ``repro_torch.interop`` instead."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    def make(spec: ParamSpec) -> torch.Tensor:
        dt = getattr(torch, spec.dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=dev)
        if spec.init == "normal":
            w = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                            device=dev)
            return (w * spec.scale).to(dt)
        raise ValueError(spec.init)

    return tree_map(make, tree)


#: seeds between two leaves of :func:`init_blocks` (rows a leaf at most)
LEAF_SEEDS = 1 << 20


def init_block(spec: ParamSpec, seed: int, placement=None, mesh=None,
               device="cuda") -> torch.Tensor:
    """This shard's block under ``placement`` (``distributed.sharding``;
    None: the whole leaf) of a leaf drawn one row (along dim 0) at a
    time, row r from its own generator seeded with ``seed + r`` (on
    ``device``) and narrowed to the block's columns: a rank of a
    ``ProcessMesh`` draws only its block's rows, with the bits they have
    in the whole leaf drawn this way (a ``ShardMesh`` or ``mesh=None``:
    the whole leaf).  ``zeros`` and ``ones`` leaves are made at the
    block's shape."""
    from repro_torch.distributed.sharding import block_slices

    dev = resolve_device(device)
    dt = getattr(torch, spec.dtype)
    idx = (tuple(slice(0, n) for n in spec.shape) if placement is None
           else block_slices(tuple(spec.shape), placement, mesh))
    shape = tuple(s.stop - s.start for s in idx)
    if spec.init in ("zeros", "ones"):
        return getattr(torch, spec.init)(shape, dtype=dt, device=dev)
    if spec.init != "normal":
        raise ValueError(spec.init)
    out = torch.empty(shape, dtype=dt, device=dev)
    for i, r in enumerate(range(idx[0].start, idx[0].stop)):
        gen = torch.Generator(device=dev).manual_seed(int(seed) + r)
        w = torch.randn(spec.shape[1:], generator=gen, dtype=torch.float32,
                        device=dev)
        out[i] = w[idx[1:]] * spec.scale
    return out


def init_blocks(tree, seed: int = 0, placements=None, mesh=None,
                device="cuda"):
    """:func:`init_block` of every leaf of a ``ParamSpec`` tree, leaf j
    (in tree order) from seeds ``seed + j · LEAF_SEEDS + r``: over a
    ``ProcessMesh`` with the tree's placements this rank's blocks,
    otherwise the whole tree, with the same bits in both."""
    from repro_torch.distributed import sharding

    drawn = []

    def draw(spec, place=None):
        if spec.shape[0] > LEAF_SEEDS:
            raise ValueError(f"a leaf of {spec.shape[0]} rows: at most "
                             f"{LEAF_SEEDS}")
        drawn.append(spec)
        return init_block(spec, int(seed) + (len(drawn) - 1) * LEAF_SEEDS,
                          place, mesh, device)

    if placements is None:
        return sharding.tree_map(draw, tree)
    return sharding.tree_map(draw, tree, placements)


def shape_dtype_tree(tree, device="meta"):
    """The parameter tree without its weights (counterpart of
    ``repro.models.params.shape_dtype_tree``): each leaf an uninitialized
    tensor of its spec's shape and type on ``device``.  On ``meta`` (the
    default) nothing is allocated; under
    ``torch._subclasses.fake_tensor.FakeTensorMode`` any device gives
    fake tensors, which is how the dry run (``launch/dryrun.py``) builds
    a model it never allocates."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=getattr(
        torch, s.dtype), device=device), tree)


def count_params(tree) -> int:
    return int(sum(int(np.prod(s.shape)) for s in tree_leaves(tree)))


def tree_to(tree, device):
    """Copy every tensor of a tree to ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev), tree)
