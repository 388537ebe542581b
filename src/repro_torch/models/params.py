"""Parameter declaration (counterpart of ``repro.models.params``).

Architectures declare parameters as ``ParamSpec`` trees (nested dicts and
lists of shape + initializer).  :func:`init_params` materializes one on a
device, :func:`shape_dtype_tree` gives its shapes and types without
weights and :func:`count_params` counts it without allocating.  The JAX
package's sharding trees have no counterpart on one card.
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
    init: str = "normal"        # normal | zeros | ones
    scale: float = 0.02
    dtype: str = "float32"


def tree_map(fn: Callable[[Any], Any], tree):
    """Apply ``fn`` to every leaf of a tree of dicts and lists (``None``
    stays ``None``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


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
