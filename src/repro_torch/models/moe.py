"""Mixture-of-Experts FFN (counterpart of ``repro.models.moe``) on one card.

``moe_dense`` is the JAX package's one-hot dispatch/combine: every expert
is computed for every token and the top-k results are combined with the
router's weights (no token dropping).  The products run as batched
matmuls with the expert axis as the batch (``torch.matmul`` of the (T, D)
tokens against the (E, D, F) stack), so the stacked weights are read in
place: folding them into one (D, E*F) matrix would copy them (22.5 GB at
deepseek-v3's width).

The JAX package's expert-parallel ``a2a`` path exists only over a device
mesh with a "model" axis; without one it computes ``moe_dense``, and so
does :func:`moe_ffn` here for ``impl`` "auto", "a2a" and "dense".  Its
capacity-bucketed body over a ``ShardMesh`` belongs to the training slice
and raises.

``pair_stats`` gives the per-expert token counts and the co-activation
matrix the expert-placement balancer reads; both are small integers held
in f32, exact.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec

IMPLS = ("auto", "dense", "a2a")


class RouterStats(NamedTuple):
    """``counts[e]``: (token, k) selections of expert e; ``coact[i, j]``:
    ordered selections of experts i and j by one token.  (E,) and (E, E)
    f32 tensors of fixed shape."""

    counts: torch.Tensor
    coact: torch.Tensor


def zero_router_stats(num_experts: int, device="cuda") -> RouterStats:
    E = int(num_experts)
    device = resolve_device(device)
    return RouterStats(torch.zeros((E,), dtype=torch.float32, device=device),
                       torch.zeros((E, E), dtype=torch.float32,
                                   device=device))


def pair_stats(ids: torch.Tensor, num_experts: int) -> RouterStats:
    """Counts and co-activations of top-k ids (T, k): with ``c_t`` the
    token's selection counts, ``coact = CᵀC − diag(counts)``."""
    E = int(num_experts)
    sel = F.one_hot(ids.long(), E).to(torch.float32).sum(dim=-2)   # (T, E)
    counts = sel.sum(dim=0)
    return RouterStats(counts=counts, coact=sel.T @ sel - torch.diag(counts))


def moe_specs(cfg: ModelConfig) -> Dict:
    m = cfg.moe
    D, Fe, E = cfg.d_model, m.d_expert, m.num_experts
    p = dict(router=ParamSpec((D, E), scale=0.006),
             wi=ParamSpec((E, D, Fe)), wg=ParamSpec((E, D, Fe)),
             wo=ParamSpec((E, Fe, D)))
    if m.num_shared:
        S = m.num_shared * Fe
        p.update(shared_wi=ParamSpec((D, S)), shared_wg=ParamSpec((D, S)),
                 shared_wo=ParamSpec((S, D)))
    return p


def _top_k(probs: torch.Tensor, k: int):
    """The k largest values a row and their indices, the lowest index
    first among equal values (``lax.top_k``'s order): a stable sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k].to(torch.int32)


def _router(params, cfg: ModelConfig, x2d: torch.Tensor):
    """Top-k routing in f32: ``(weights (T, k) in x's type, ids (T, k)
    i32, aux)``, aux the Switch load-balance loss plus 1e-3 z-loss."""
    m = cfg.moe
    E = m.num_experts
    logits = x2d.to(torch.float32) @ params["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    w, ids = _top_k(probs, m.top_k)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=0)
    ce = torch.zeros(E, dtype=torch.float32, device=x2d.device).index_add_(
        0, ids.reshape(-1).long(),
        torch.ones(ids.numel(), dtype=torch.float32, device=x2d.device))
    ce = ce / ids.numel()
    aux = E * torch.sum(me * ce)
    zloss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return w.to(x2d.dtype), ids, aux + 1e-3 * zloss


def _shared(params, x: torch.Tensor, dt) -> torch.Tensor:
    h = F.silu(x @ params["shared_wg"].to(dt)) * (x @ params["shared_wi"]
                                                  .to(dt))
    return h @ params["shared_wo"].to(dt)


def moe_dense(params, cfg: ModelConfig, x: torch.Tensor,
              collect_stats: bool = False):
    """One-hot dispatch/combine.  x (B, S, D) → ``(y, aux)``, or ``(y,
    aux, RouterStats)`` with ``collect_stats``."""
    m = cfg.moe
    B, S, D = x.shape
    dt = x.dtype
    x2d = x.reshape(B * S, D)
    w, ids, aux = _router(params, cfg, x2d)
    stats = pair_stats(ids, m.num_experts) if collect_stats else None
    # a token's k ids are distinct: one weight an entry, as the one-hot
    # einsum gives it
    comb = torch.zeros((B * S, m.num_experts), dtype=dt,
                       device=x.device).scatter_(1, ids.long(), w)
    hg = torch.matmul(x2d, params["wg"].to(dt))              # (E, T, F)
    hi = torch.matmul(x2d, params["wi"].to(dt))
    ye = torch.matmul(F.silu(hg) * hi, params["wo"].to(dt))  # (E, T, D)
    y = torch.einsum("etd,te->td", ye, comb).reshape(B, S, D)
    if m.num_shared:
        y = y + _shared(params, x, dt)
    if collect_stats:
        return y, aux, stats
    return y, aux


def moe_ffn(params, cfg: ModelConfig, x: torch.Tensor,
            impl: Optional[str] = None, collect_stats: bool = False, *,
            mesh=None):
    """The MoE FFN: ``moe_dense`` for every ``impl`` on one device.  The
    expert-parallel body over a mesh (``mesh`` given with "auto" or
    "a2a") waits for the training slice and raises."""
    impl = impl or cfg.moe.impl
    if impl not in IMPLS:
        raise ValueError(f"unknown MoE impl {impl!r}; one of {IMPLS}")
    if mesh is not None and impl != "dense":
        raise NotImplementedError(
            "the expert-parallel a2a body over a ShardMesh (moe._a2a_local "
            "in the JAX package) is not ported yet: it comes with the "
            "training slice")
    return moe_dense(params, cfg, x, collect_stats)
