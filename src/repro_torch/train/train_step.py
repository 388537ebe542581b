"""The training step: loss, gradients, clipped AdamW update (counterpart of
``repro.train.train_step``).

``make_train_step`` closes over (cfg, opt_cfg, remat) and returns
``(params, opt_state, batch) -> (params, opt_state, metrics)``.  Eager
PyTorch needs no ``jit``: the step makes the parameters autograd leaves,
takes the loss's gradients with ``torch.autograd.grad`` (every attention
layer's backward is the flash-attention backward kernel on a card) and
returns new parameter and state trees; the inputs are left as they were.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

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


def make_train_step(cfg: ModelConfig, opt_cfg: opt_mod.OptConfig, *,
                    remat: str = "none",
                    grad_transform: Optional[Callable] = None,
                    collect_router_stats: bool = False) -> Callable:
    """``grad_transform(grads) -> grads`` hooks gradient compression
    (``distributed.grad_compress``) between backward and update.
    ``collect_router_stats`` adds the MoE router's ``router_counts`` (E,)
    and ``router_coact`` (E, E) to the metrics, for the expert-placement
    runtime (``train.ep_runtime``)."""
    loss = make_loss(cfg, remat, collect_router_stats)

    def step(params, opt_state, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        with torch.enable_grad():
            lval, metrics = loss(live, batch)
            grads = torch.autograd.grad(lval, leaves, allow_unused=True)
        it = iter([torch.zeros_like(p) if g is None else g
                   for p, g in zip(leaves, grads)])
        grads = tree_map(lambda _: next(it), params)
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state, opt_metrics = opt_mod.apply(
            opt_cfg, params, grads, opt_state,
            decay_mask=decay_mask(cfg, params))
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
