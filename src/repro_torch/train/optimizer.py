"""AdamW with decoupled weight decay and global-norm clipping (counterpart
of ``repro.train.optimizer``).

Plain functions on parameter trees (nested dicts and lists of tensors),
not ``torch.optim``, so the arithmetic and its order are the JAX
package's: the global norm over the leaves in tree order, then each
leaf's clipped AdamW update, all in f32 whatever the parameters' type.
With ``master_fp32`` the optimizer carries an f32 master copy of
low-precision (bf16) parameters.  The moments mirror the parameters'
placement: over a ``ProcessMesh`` each rank updates its blocks, and the
global norm adds each leaf's squares over the shards it is split over
(:func:`global_norm`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.distributed import sharding
from repro_torch.distributed.mesh import ProcessMesh
from repro_torch.kernels import resolve_device
from repro_torch.models.params import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # True: params are stored in a low-precision type (bf16) and the
    # optimizer carries the f32 master copy
    master_fp32: bool = False


class OptState(NamedTuple):
    step: torch.Tensor       # scalar i32
    mu: Any                  # first moments (tree like params)
    nu: Any                  # second moments
    master: Any = None       # f32 master weights when master_fp32


def init(params, *, master_fp32: bool = False, device="cuda") -> OptState:
    """Zero moments (f32, the parameters' shapes) on ``device``, step 0,
    and with ``master_fp32`` an f32 copy of the parameters."""
    dev = resolve_device(device)

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=dev)

    master = (tree_map(lambda p: p.to(device=dev, dtype=torch.float32,
                                      copy=True), params)
              if master_fp32 else None)
    return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                    tree_map(zeros, params), tree_map(zeros, params), master)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac · lr`` (f32)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    t = (s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(tree, mesh=None, placements=None) -> torch.Tensor:
    """sqrt of the sum over the leaves (tree order) of their f32 squares.

    Over a ``ProcessMesh`` the leaves are this rank's blocks, placed by
    ``placements`` (``distributed.sharding``): each rank's per-leaf sums
    are gathered, a leaf split over some axes adds the sums of the shards
    that hold its blocks (those at coordinate 0 on every other axis) and
    a whole leaf counts once, in a fixed order, so every rank gets the
    same bits."""
    if not isinstance(mesh, ProcessMesh):
        total = None
        for leaf in tree_leaves(tree):
            sq = torch.sum(torch.square(leaf.to(torch.float32)))
            total = sq if total is None else total + sq
        return torch.sqrt(total)
    pairs = []
    sharding.tree_map(lambda g, p: pairs.append((g, p)), tree, placements)
    places = [p for _, p in pairs]
    sq = torch.stack([torch.sum(torch.square(g.to(torch.float32)))
                      for g, _ in pairs])
    every = mesh.all_gather(sq.reshape(1, 1, -1))          # (D, leaves)
    owner = torch.tensor(
        [[all(c == 0 for a, c in mesh.coords(s).items()
              if a not in p.axes()) for p in places]
         for s in range(mesh.num_shards)],
        dtype=torch.float32, device=every.device)
    per_leaf = (every * owner).sum(0)
    total = None
    for s in per_leaf:
        total = s if total is None else total + s
    return torch.sqrt(total)


def apply(cfg: OptConfig, params, grads, state: OptState, *,
          decay_mask=None, mesh=None,
          placements=None) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step.  ``decay_mask`` is a tree of bools like ``params``
    (None: decay every tensor with ndim >= 2, the usual no-decay rule for
    norms and biases).  Over a ``ProcessMesh`` the trees are this rank's
    blocks under ``placements`` and the clip takes the global norm.
    Returns ``(params, state, {grad_norm, lr})``; the inputs are not
    modified."""
    step = state.step + 1
    gnorm = global_norm(grads, mesh, placements)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    sf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                      device=sf.device), sf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                      device=sf.device), sf)
    if decay_mask is None:
        decay_mask = tree_map(lambda p: p.ndim >= 2, params)

    def upd(p, g, m, v, dm, master):
        g = g.to(torch.float32) * scale
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * g * g
        delta = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
        base = master if master is not None else p.to(torch.float32)
        if dm:
            delta = delta + cfg.weight_decay * base
        new_base = base - lr * delta
        return (new_base.to(p.dtype), m_new, v_new,
                new_base if master is not None else None)

    flat_p = tree_leaves(params)
    flat_w = (tree_leaves(state.master) if state.master is not None
              else [None] * len(flat_p))
    outs = [upd(p, g, m, v, d, w) for p, g, m, v, d, w in zip(
        flat_p, tree_leaves(grads), tree_leaves(state.mu),
        tree_leaves(state.nu), tree_leaves(decay_mask), flat_w)]
    new_p = _unflatten(params, [o[0] for o in outs])
    new_m = _unflatten(params, [o[1] for o in outs])
    new_v = _unflatten(params, [o[2] for o in outs])
    new_w = (_unflatten(params, [o[3] for o in outs])
             if state.master is not None else None)
    return new_p, OptState(step, new_m, new_v, new_w), dict(grad_norm=gnorm,
                                                            lr=lr)


def _unflatten(template, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


__all__ = ["OptConfig", "OptState", "init", "schedule", "global_norm",
           "apply"]
