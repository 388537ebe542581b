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
places its trees by :func:`train_placements`, the rules' placement of
every leaf, and computes with the blocks as :func:`tp_plan` says: tensor
parallel over ``"model"`` where a block is whole heads, whole ``d_ff``
columns or a whole vocabulary block; elsewhere each block gathered over
its axes just before use (:func:`gathered`: FSDP's gather over the
``"data"`` axes, with a reduce-scatter backward).  The model code reads
the mesh of :func:`use_mesh` (:func:`rank_mesh`).
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Dict, Optional

import numpy as np
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
    return isinstance(x, (Placement, ParamSpec, torch.Tensor,
                          np.ndarray)) or x is None


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves (placements, specs, tensors, arrays, None) of
    trees of dicts, lists, tuples and NamedTuples of one structure."""
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
    of tensors or arrays): dim 0 (batch) over the batch axes, dim 1
    (length or heads) over ``"model"``, filtered."""
    ba = batch_axes(mesh)
    model = "model" if "model" in _sizes(mesh) else None

    def leaf(t):
        if t is None:
            return None
        nd = len(t.shape)
        spec = [None] * nd
        if nd >= 1:
            spec[0] = ba if ba else None
        if nd >= 2:
            spec[1] = model
        return filter_spec(spec, mesh, tuple(t.shape), profile)

    return tree_map(leaf, cache)


def train_placements(tree, mesh, cfg):
    """The placements the port's sharded train step keeps, for a tree of
    ``ParamSpec``s or tensors (the port's per-layer layout of ``cfg``):
    the JAX rules' placement of every leaf (:func:`param_placements` of
    ``transformer.model_specs(cfg)`` under ``cfg.sharding_profile``) —
    heads, ``d_ff``, vocabulary and experts over ``"model"``, the
    ``"data"`` entries FSDP, the expert stacks ``(ep_axes, "data",
    None)`` where EP is over ``"model"`` alone."""
    from repro_torch.models import transformer

    place = param_placements(transformer.model_specs(cfg), mesh,
                             cfg.sharding_profile)

    def check(leaf, p):
        if len(leaf.shape) != len(p):
            raise ValueError(f"a leaf of shape {tuple(leaf.shape)} where "
                             f"{cfg.name}'s tree has {len(p)} dims")
        return p

    return tree_map(check, tree, place)


def _split(spec: ParamSpec, mesh, profile: str) -> Dict[int, tuple]:
    """The dims of a leaf its placement splits: {dim: axis names}."""
    out = {}
    for dim, a in enumerate(filter_spec(spec.spec, mesh, spec.shape,
                                        profile)):
        if a is not None:
            out[dim] = (a,) if isinstance(a, str) else tuple(a)
    return out


def _model_split(spec: ParamSpec, dim: int, mesh, profile: str) -> bool:
    return _split(spec, mesh, profile).get(dim) == ("model",)


def tp_plan(cfg, mesh) -> Dict[str, Dict[str, str]]:
    """How the sharded step computes with each block kind's parts over
    ``mesh``: ``{kind: {part: mode}}`` for every kind ``cfg`` runs (and
    ``"attn"``, MTP's block, where ``cfg.mtp``), plus ``"embed":
    {"vocab": mode}``.  A mode is

      * ``"tp"`` — tensor parallel over ``"model"``: the blocks are whole
        heads (GQA where the KV heads divide over ``"model"``; MLA's heads),
        whole ``d_ff`` columns (an MLP, the shared expert) or a whole
        vocabulary block (embedding, head, CE);
      * ``"repeat"`` — GQA's head-repeat branch, the JAX gate to the
        letter (``repro.models.attention``): ``"model"`` active under the
        profile, KV not dividing over it, H dividing (and the keys' length
        at most 16384, which the caller checks);
      * ``"gather"`` — every block gathered over its axes before use
        (:func:`gathered`) and the compute replicated: a split mid-head
        (smollm-135m's 9 heads over 2), the SSM cells, anything under
        ``"dp"`` (no tensor parallelism) or without a ``"model"`` axis.

    The MoE experts run expert parallel (``models.moe``) under every
    mode; ``"moe"`` kinds give the shared expert's mode as ``"shared"``."""
    return {k: dict(v) for k, v in _tp_plan(
        cfg, tuple(_sizes(mesh).items())).items()}


@functools.lru_cache(maxsize=64)
def _tp_plan(cfg, axes) -> Dict[str, Dict[str, str]]:
    """:func:`tp_plan` of the mesh axes ``axes`` ((name, size) pairs),
    computed once a (config, axes)."""
    from repro_torch.models import attention as attn
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer
    from repro_torch.models.layers import embed_specs, mlp_specs

    p = cfg.sharding_profile
    sizes = dict(axes)
    M = sizes.get("model", 1) if translate("model", p) else 1

    def mode(ok: bool) -> str:
        return "tp" if M > 1 and ok else "gather"

    if cfg.attention == "mla":
        sp = attn.mla_specs(cfg)
        att = mode(cfg.num_heads % M == 0 and all(
            _model_split(sp[k], 1, sizes, p) for k in ("wq_b", "wk_b",
                                                      "wv_b"))
            and _model_split(sp["wo"], 0, sizes, p))
    else:
        sp = attn.gqa_specs(cfg)
        H, KV = cfg.num_heads, cfg.num_kv_heads
        att = mode(KV % M == 0 and all(_model_split(sp[k], 1, sizes, p)
                                       for k in ("wq", "wk", "wv")))
        if M > 1 and KV % M and H % M == 0:
            att = "repeat"

    def mlp_mode(width: int) -> str:
        return mode(_model_split(mlp_specs(cfg.d_model, width)["wi"], 1,
                                 sizes, p))

    plan: Dict[str, Dict[str, str]] = {}
    kinds = list(dict.fromkeys(cfg.all_layers()))
    if cfg.mtp and "attn" not in kinds:
        kinds.append("attn")
    for kind in kinds:
        if kind in transformer.ATTN_KINDS:
            plan[kind] = dict(attn=att)
            if kind.startswith("moe"):
                if cfg.moe.num_shared:
                    plan[kind]["shared"] = mode(_model_split(
                        moe_mod.moe_specs(cfg)["shared_wi"], 1, sizes, p))
            else:
                plan[kind]["mlp"] = mlp_mode(cfg.d_ff_dense or cfg.d_ff)
        elif kind in transformer.HYMBA_KINDS:
            plan[kind] = dict(attn=att, mamba="gather",
                              mlp=mlp_mode(cfg.d_ff))
        else:
            plan[kind] = dict(cell="gather")
            if cfg.d_ff:
                plan[kind]["mlp"] = mlp_mode(cfg.d_ff)
    plan["embed"] = dict(vocab=mode(_model_split(
        embed_specs(cfg.vocab_size, cfg.d_model), 0, sizes, p)))
    return plan


def gathered(w: torch.Tensor, spec: ParamSpec, mesh: ProcessMesh,
             profile: str = "2d", *, keep=(), partial: bool = False
             ) -> torch.Tensor:
    """This rank's block ``w`` of the leaf ``spec`` declares, gathered for
    use over every dim its placement splits (a dim already whole is left
    as it is), but those split over axes in ``keep`` (the dims its
    compute is tensor- or expert-parallel over).

    The gather's backward follows the tokens: over axes whose members
    hold other tokens (the profile's batch axes: FSDP's ``"data"``) the
    members' gradients are added (:func:`autodiff.fsdp_gather`); over the
    others (``"model"`` under ``"2d"``) every member computes the whole
    gradient alike and keeps its block (:func:`autodiff.leave`).  With
    ``partial`` each member computes only a part of the leaf's use (the
    head-repeat branch's keys and values): the gradients are added over
    ``"model"`` too, a leaf whole over it included (:func:`autodiff.tp_in`).
    """
    batch = set(batch_axes(mesh, profile))
    keep = set((keep,) if isinstance(keep, str) else keep)
    summed = False
    for dim, axes in _split(spec, mesh, profile).items():
        if set(axes) <= keep or w.shape[dim] == spec.shape[dim]:
            continue
        if set(axes) & keep:
            raise ValueError(f"dim {dim} splits over {axes}: keep {keep} "
                             "takes some of them")
        a = axes if len(axes) > 1 else axes[0]
        if partial or set(axes) <= batch:
            w = autodiff.fsdp_gather(w, mesh, a, dim)
            summed = summed or "model" in axes
        elif not set(axes) & batch:
            w = autodiff.leave(mesh, w, a, dim)
        else:
            raise ValueError(f"dim {dim} splits over {axes}, some of whose "
                             "members hold other tokens and some not")
    if partial and not summed and "model" in _sizes(mesh):
        w = autodiff.tp_in(w, mesh, "model")
    return w


class _Ambient(threading.local):
    """Each thread's stack of :func:`use_mesh` meshes."""

    def __init__(self):
        self.stack = []


_AMBIENT = _Ambient()


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the ambient mesh of the model code inside the block
    (the MoE layers', ``transformer.loss_fn``'s, and over a
    ``ProcessMesh`` every layer's), as ``jax.sharding.set_mesh`` makes a
    mesh ambient for the JAX package's layers.  Like JAX's config
    context it holds for the calling thread only: two threads may each
    hold their own mesh at once."""
    _AMBIENT.stack.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.stack.pop()


def ambient_mesh():
    """This thread's innermost :func:`use_mesh` mesh, or None."""
    stack = _AMBIENT.stack
    return stack[-1] if stack else None


def rank_mesh() -> Optional[ProcessMesh]:
    """The ambient mesh where it is a ``ProcessMesh`` (the trees are this
    rank's blocks), else None (the trees are whole)."""
    mesh = ambient_mesh()
    return mesh if isinstance(mesh, ProcessMesh) else None


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


def block_slices(shape, placement, mesh, shard=None) -> tuple:
    """Shard ``shard``'s block of a whole tensor of ``shape`` under
    ``placement``, one slice a dim.  ``shard=None`` is this process's: a
    ``ProcessMesh``'s rank; a ``ShardMesh`` holds every shard, whose
    blocks make up the tensor, so the whole of it."""
    whole = tuple(slice(0, n) for n in shape)
    if shard is None:
        if not isinstance(mesh, ProcessMesh):
            return whole
        shard = mesh.rank
    sizes = _sizes(mesh)
    coords = ShardMesh(device="cpu", axes=sizes).coords(shard)
    out = list(whole)
    for dim, a in enumerate(placement):
        if a is None:
            continue
        G, i = 1, 0
        for ax in ((a,) if isinstance(a, str) else a):
            G, i = G * sizes[ax], i * sizes[ax] + coords[ax]
        if shape[dim] % G:
            raise ValueError(f"dim {dim} of extent {shape[dim]} does not "
                             f"divide over {a} ({G} shards)")
        n = shape[dim] // G
        out[dim] = slice(i * n, (i + 1) * n)
    return tuple(out)


def local_block(x: torch.Tensor, placement, mesh, shard=None):
    """Shard ``shard``'s block of the whole tensor ``x`` under
    ``placement`` (a view; see :func:`block_slices`)."""
    for dim, s in enumerate(block_slices(tuple(x.shape), placement, mesh,
                                         shard)):
        if s.stop - s.start != x.shape[dim]:
            x = x.narrow(dim, s.start, s.stop - s.start)
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
