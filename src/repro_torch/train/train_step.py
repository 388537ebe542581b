"""The training step: loss, gradients, clipped AdamW update (counterpart of
``repro.train.train_step``).

``make_train_step`` closes over (cfg, opt_cfg, remat) and returns
``(params, opt_state, batch) -> (params, opt_state, metrics)``.  Eager
PyTorch needs no ``jit``: the step makes the parameters autograd leaves,
takes the loss's gradients with ``torch.autograd.grad`` (every attention
layer's backward is the flash-attention backward kernel on a card) and
returns new parameter and state trees; the inputs are left as they were.

Over a mesh (``mesh=``) the step is the JAX step under ``jit`` with the
partition rules' shardings, as ``tests/test_distributed_small_mesh.py``
builds it.  On a ``ShardMesh`` the process holds every shard, so the
trees are whole and the mesh is the MoE layers' (``sharding.use_mesh``).
On a ``ProcessMesh`` the step takes and returns this rank's trees: the
parameters and the optimizer state (moments, master copy) placed by
``distributed.sharding.train_placements`` — the JAX rules' placement of
every leaf, so no rank holds a whole copy of a leaf the rules split —
and the batch its block over the profile's batch axes
(``data_placements``; the global batch must divide over them).  The
model computes tensor parallel over ``"model"`` where a block is whole
heads, ``d_ff`` columns or a vocabulary block, and gathers every other
block just before use (``sharding.tp_plan``, ``sharding.gathered``): a
``"data"`` (FSDP) gather's backward is a reduce-scatter, which adds the
``"data"`` ranks' gradients.  What is left is summed by gather-and-add
over ``sharding.grad_sum_axes``: the batch axes a leaf is not split over,
as their ranks hold other tokens, and the router's over ``"model"`` too,
as each rank routes its own sequence block.  Loss, metrics and grad norm
are global and the replicated leaves' updates equal on every rank.
Profiles: ``"2d"`` (batch over ``("pod", "data")``, tensor parallel over
``"model"``) and ``"dp"`` (batch over every axis, the ``"model"``
entries whole, the ``"data"`` ones FSDP; a MoE layer regroups its tokens
over ``"model"`` at the boundary, ``models.moe``).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from repro_torch.distributed import sharding
from repro_torch.distributed.mesh import ProcessMesh
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.train import optimizer as opt_mod


def make_loss(cfg: ModelConfig, remat: str = "none",
              collect_router_stats: bool = False) -> Callable:
    def loss(params, batch):
        return transformer.loss_fn(
            params, cfg, batch, remat=remat,
            collect_router_stats=collect_router_stats)
    return loss


def decay_mask(cfg: ModelConfig, params):
    """The JAX step's weight-decay mask on the port's per-layer tree: a
    tensor decays where its JAX counterpart has ndim >= 2.  The JAX
    package stacks the scanned groups' layers (a leading group axis), so
    every tensor of those layers decays there, norms included; prefix,
    suffix and the other tensors follow their own ndim."""
    lo = len(cfg.prefix_layers)
    hi = lo + cfg.num_groups * len(cfg.layer_unit)
    mask = tree_map(lambda p: p.ndim >= 2, params)
    mask["layers"] = [
        tree_map(lambda p, s=int(lo <= i < hi): p.ndim + s >= 2, layer)
        for i, layer in enumerate(params["layers"])]
    return mask


def _grad_sums(cfg: ModelConfig, mesh: ProcessMesh, params, placements):
    """Each leaf's gradient-sum axes, in the order of ``params``' leaves."""
    out = []

    def walk(tree, place, router):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, place[k], router or k == "router")
        elif isinstance(tree, (list, tuple)):
            for v, p in zip(tree, place):
                walk(v, p, router)
        else:
            out.append(sharding.grad_sum_axes(
                place, mesh, cfg.sharding_profile, model=router))

    walk(params, placements, False)
    return out


def make_train_step(cfg: ModelConfig, opt_cfg: opt_mod.OptConfig, *,
                    remat: str = "none",
                    grad_transform: Optional[Callable] = None,
                    collect_router_stats: bool = False,
                    mesh=None) -> Callable:
    """``grad_transform(grads) -> grads`` hooks gradient compression
    (``distributed.grad_compress``) between backward and update.
    ``collect_router_stats`` adds the MoE router's ``router_counts`` (E,)
    and ``router_coact`` (E, E) to the metrics, for the expert-placement
    runtime (``train.ep_runtime``).  ``mesh``: the step over a mesh (see
    the module's docstring)."""
    loss = make_loss(cfg, remat, collect_router_stats)
    ranks = mesh if isinstance(mesh, ProcessMesh) else None

    def step(params, opt_state, batch):
        placements = (None if ranks is None else
                      sharding.train_placements(params, ranks, cfg))
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        ctx = (sharding.use_mesh(mesh) if mesh is not None
               else contextlib.nullcontext())
        with torch.enable_grad(), ctx:
            lval, metrics = loss(live, batch)
            grads = torch.autograd.grad(lval, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if ranks is not None:
            sums = _grad_sums(cfg, ranks, params, placements)
            grads = [g if not axes else ranks.psum(g.unsqueeze(0), axes)
                     .reshape(g.shape) for g, axes in zip(grads, sums)]
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state, opt_metrics = opt_mod.apply(
            opt_cfg, params, grads, opt_state,
            decay_mask=decay_mask(cfg, params), mesh=ranks,
            placements=placements)
        out = dict(loss=lval.detach(),
                   **{k: v.detach() for k, v in metrics.items()},
                   **opt_metrics)
        return params, opt_state, out

    return step


def make_eval_step(cfg: ModelConfig) -> Callable:
    loss = make_loss(cfg)

    def step(params, batch):
        with torch.no_grad():
            lval, metrics = loss(params, batch)
        return dict(loss=lval, **metrics)

    return step
