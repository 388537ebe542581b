"""Partition rules (counterpart of ``repro.distributed.sharding``), as pure
functions over a mesh's axis sizes.

One convention (the JAX package's): batch → ``("pod", "data")``; heads,
d_ff, vocabulary and experts → ``"model"``; parameters FSDP over
``"data"`` where the ``ParamSpec`` says so; KV-cache length and
recurrent-state heads → ``"model"``.  The JAX package turns it into
``NamedSharding`` trees for ``jit``; here a **placement** is a
:class:`Placement`, one entry a dim: None (whole), an axis name, or a
tuple of them (the dim split over their product, blocks in row-major
order of the names) — what the JAX rules give as a ``PartitionSpec``.
``mesh`` is anything with ``axes`` ({name: size}, a ``distributed.mesh``
mesh) or such a mapping.

:func:`local_block` cuts a shard's block of a whole tensor and
:func:`gather_tree` puts a tree of blocks back together.  The port's
sharded train step (``train.train_step.make_train_step(mesh=...)``)
places its trees by :func:`train_placements`: the expert stacks over
their EP axes, every other leaf whole (the dense layers' tensor
parallelism and FSDP are the next slice).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.distributed import autodiff
from repro_torch.distributed.mesh import ProcessMesh, ShardMesh
from repro_torch.models.params import ParamSpec

BATCH = ("pod", "data")
PROFILES = ("2d", "dp")


class Placement(tuple):
    """A leaf's placement: one entry a dim (None, an axis name, or a
    tuple of names).  A tuple subclass, so it compares with the tuple of
    a ``PartitionSpec``'s entries, and a leaf of the trees here."""

    def axes(self) -> tuple:
        """The axis names it splits over, in order."""
        out = []
        for a in self:
            if a is not None:
                out += [a] if isinstance(a, str) else list(a)
        return tuple(out)


def _sizes(mesh) -> Dict[str, int]:
    return dict(mesh.axes if hasattr(mesh, "axes") else mesh)


def _is_leaf(x) -> bool:
    return isinstance(x, (Placement, ParamSpec, torch.Tensor)) or x is None


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves (placements, specs, tensors, None) of trees of
    dicts, lists, tuples and NamedTuples of one structure."""
    if _is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    parts = [tree_map(fn, v, *(r[i] for r in rest))
             for i, v in enumerate(tree)]
    if hasattr(tree, "_fields"):                 # a NamedTuple
        return type(tree)(*parts)
    return type(tree)(parts)


def translate(a, profile: str):
    """The JAX package's profile translation: under ``"dp"`` the batch
    axes take every axis and ``"model"`` no tensor parallelism."""
    if profile not in PROFILES:
        raise ValueError(f"unknown sharding profile {profile!r}; one of "
                         f"{PROFILES}")
    if profile == "dp":
        if isinstance(a, (tuple, list)) and "data" in a:
            return ("pod", "data", "model")
        if a == "model":
            return None
    return a


def filter_spec(spec_axes, mesh, shape=None,
                profile: str = "2d") -> Placement:
    """The JAX package's ``_filter``: each entry translated by the
    profile, the axis names the mesh lacks dropped, and (given ``shape``)
    trailing axes dropped until the dim divides over their product."""
    sizes = _sizes(mesh)

    def keep(i, a):
        a = translate(a, profile)
        if a is None:
            return None
        ax = tuple(x for x in (a if isinstance(a, (tuple, list)) else (a,))
                   if x in sizes)
        while ax and shape is not None:
            n = 1
            for x in ax:
                n *= sizes[x]
            if i < len(shape) and shape[i] % n == 0:
                break
            ax = ax[:-1]
        if not ax:
            return None
        return ax if len(ax) > 1 else ax[0]

    return Placement(keep(i, a) for i, a in enumerate(spec_axes))


def batch_axes(mesh, profile: str = "2d") -> tuple:
    """The axes the batch splits over: ``("pod", "data")`` the mesh has,
    under ``"dp"`` every axis."""
    sizes = _sizes(mesh)
    return tuple(a for a in translate(BATCH, profile) if a in sizes)


def param_placements(spec_tree, mesh, profile: str = "2d"):
    """``param_shardings``: each ``ParamSpec`` leaf's placement."""
    return tree_map(lambda s: filter_spec(s.spec, mesh, s.shape, profile),
                    spec_tree)


def opt_placements(pplace, *, master: bool = False):
    """``opt_shardings``: an ``OptState`` of placements — the step
    replicated, the moments (and the master copy) placed as the
    parameters."""
    from repro_torch.train.optimizer import OptState

    return OptState(step=Placement(()), mu=pplace, nu=pplace,
                    master=pplace if master else None)


def data_placements(batch, mesh, profile: str = "2d"):
    """``data_shardings``: each array's leading (global batch) dim over the
    batch axes, filtered by the profile and the dim's extent.  ``batch``
    holds tensors or shapes (tuples of ints), or None."""
    ba = batch_axes(mesh)

    def f(x):
        if x is None:
            return None
        shape = tuple(x.shape) if isinstance(x, torch.Tensor) else tuple(x)
        spec = [None] * len(shape)
        if shape:
            spec[0] = ba if ba else None
        return filter_spec(spec, mesh, shape, profile)

    return {k: f(v) for k, v in batch.items()}


def cache_placements(cache, mesh, profile: str = "2d"):
    """``cache_shardings`` on the port's per-layer caches (lists of dicts
    of tensors): dim 0 (batch) over the batch axes, dim 1 (length or
    heads) over ``"model"``, filtered."""
    ba = batch_axes(mesh)
    model = "model" if "model" in _sizes(mesh) else None

    def leaf(t):
        if t is None:
            return None
        nd = t.dim()
        spec = [None] * nd
        if nd >= 1:
            spec[0] = ba if ba else None
        if nd >= 2:
            spec[1] = model
        return filter_spec(spec, mesh, tuple(t.shape), profile)

    return tree_map(leaf, cache)


def train_placements(tree, mesh, cfg):
    """The placements the port's sharded train step keeps, for a tree of
    ``ParamSpec``s or tensors (the port's per-layer layout): each MoE
    layer's expert stacks (``wi``, ``wg``, ``wo``) split on dim 0 over the
    EP axes ``cfg.ep_axes`` the mesh has, as ``models.moe.moe_a2a`` takes
    them, where E divides over them and the mesh has ``"model"``; every
    other leaf whole."""
    sizes = _sizes(mesh)
    whole = tree_map(lambda s: Placement((None,) * len(s.shape)), tree)
    if cfg.moe is None or "model" not in sizes:
        return whole
    ep_axes = tuple(a for a in cfg.ep_axes if a in sizes)
    ep = 1
    for a in ep_axes:
        ep *= sizes[a]
    if not ep_axes or cfg.moe.num_experts % ep:
        return whole
    entry = ep_axes if len(ep_axes) > 1 else ep_axes[0]
    for layer in whole["layers"]:
        for name in ("wi", "wg", "wo") if "moe" in layer else ():
            p = layer["moe"][name]
            layer["moe"][name] = Placement((entry,) + tuple(p[1:]))
    return whole


def grad_sum_axes(placement: Placement, mesh, profile: str = "2d", *,
                  model: bool = False) -> tuple:
    """The axes over which a leaf's gradient is summed in the sharded step:
    the batch axes it is not split over (each holds other tokens), and
    ``"model"`` too for a leaf used only on this shard's sequence block
    (``model=True``: the router)."""
    sizes = _sizes(mesh)
    split = set(placement.axes())
    axes = set(batch_axes(mesh, profile)) - split
    if model and "model" in sizes and "model" not in split:
        axes.add("model")
    return tuple(a for a in sizes if a in axes)


def local_block(x: torch.Tensor, placement, mesh, shard=None):
    """Shard ``shard``'s block of the whole tensor ``x`` under
    ``placement``.  ``shard=None`` is this process's: a ``ProcessMesh``'s
    rank; a ``ShardMesh`` holds every shard, whose blocks make up ``x``,
    so ``x`` itself."""
    if shard is None:
        if not isinstance(mesh, ProcessMesh):
            return x
        shard = mesh.rank
    sizes = _sizes(mesh)
    coords = ShardMesh(device="cpu", axes=sizes).coords(shard)
    for dim, a in enumerate(placement):
        if a is None:
            continue
        G, i = 1, 0
        for ax in ((a,) if isinstance(a, str) else a):
            G, i = G * sizes[ax], i * sizes[ax] + coords[ax]
        if x.shape[dim] % G:
            raise ValueError(f"dim {dim} of extent {x.shape[dim]} does not "
                             f"divide over {a} ({G} shards)")
        n = x.shape[dim] // G
        x = x.narrow(dim, i * n, n)
    return x


def local_tree(tree, placements, mesh):
    """:func:`local_block` of every leaf: a ``ProcessMesh``'s blocks as
    copies (the whole tensors can go), a ``ShardMesh``'s tree as it is."""
    if not isinstance(mesh, ProcessMesh):
        return tree
    return tree_map(lambda x, p: None if x is None else local_block(
        x, p, mesh).clone(), tree, placements)


def gather_tree(tree, placements, mesh):
    """The whole tree from this process's blocks: every split dim gathered
    over its axes (a ``ShardMesh``'s tree is whole already)."""
    if not isinstance(mesh, ProcessMesh):
        return tree

    def leaf(x, p):
        if x is None:
            return None
        with torch.no_grad():
            for dim, a in enumerate(p):
                if a is not None:
                    x = autodiff.leave(mesh, x, a, dim)
        return x

    return tree_map(leaf, tree, placements)
