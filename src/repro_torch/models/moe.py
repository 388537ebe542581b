"""Mixture-of-Experts FFN (counterpart of ``repro.models.moe``) on one card.

``moe_dense`` is the JAX package's one-hot dispatch/combine: every expert
is computed for every token and the top-k results are combined with the
router's weights (no token dropping).  The products run as batched
matmuls with the expert axis as the batch (``torch.matmul`` of the (T, D)
tokens against the (E, D, F) stack), so the stacked weights are read in
place: folding them into one (D, E*F) matrix would copy them (22.5 GB at
deepseek-v3's width).

The expert-parallel ``a2a`` path (:func:`moe_a2a`) runs over a
``distributed.mesh.ShardMesh`` of D EP shards held as the leading tensor
axis on one device, the counterpart of the JAX package's ``shard_map``
over its "model" axis: each shard routes its own tokens (a D-th of the
sequence), buckets them per expert with a per-(expert, source) capacity
(the in-bucket slot from K3's stable rank, ``kernels.migrate.ops.
bucket_ranks``, on a card), dispatches into an (E, cap, D) buffer whose
dropped slots go to a scratch row, exchanges by a transpose of the shard
axis (the all-to-all), runs the experts batched and combines by the
router's weights.  :func:`moe_ffn` takes it where a mesh is given (or
ambient, :func:`use_mesh`) and ``impl`` is "a2a" or "auto"; otherwise
``moe_dense``.  Its gradient is autograd of these tensor operations, as
the JAX package's is autodiff of its einsums.

``pair_stats`` gives the per-expert token counts and the co-activation
matrix the expert-placement balancer reads; both are small integers held
in f32, exact.
"""
from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import resolve_device
from repro_torch.kernels.migrate import ops as mops
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


# --------------------------------------------------------------- a2a path --

_AMBIENT: list = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``ShardMesh``) the ambient EP mesh of
    :func:`moe_ffn` inside the block, as ``jax.sharding.set_mesh`` makes a
    mesh ambient for the JAX package's MoE layers."""
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def dispatch_slots(flat_e: torch.Tensor, num_experts: int, cap: int):
    """Each (token, k) pair's slot in its (source shard, expert) bucket —
    the number of earlier pairs of the shard that chose the expert, the
    JAX package's one-hot cumsum — and whether it is below the capacity:
    ``(slot, keep)`` for expert ids ``flat_e`` (D, n).  One K3 call on a
    card (bucket ``shard · E + expert``), its stable in-bucket rank."""
    n_sh = flat_e.shape[0]
    E = int(num_experts)
    bucket = flat_e.to(torch.int32) + E * torch.arange(
        n_sh, dtype=torch.int32, device=flat_e.device)[:, None]
    slot, _ = mops.bucket_ranks(bucket.reshape(-1).contiguous(),
                                C=n_sh * E)
    slot = slot.reshape(flat_e.shape)
    return slot, slot < cap


def _a2a_local(x_loc: torch.Tensor, router, wi, wg, wo, *,
               cfg: ModelConfig, collect_stats: bool = False):
    """The EP body over all D shards at once: ``x_loc`` (D, T_loc, D_model)
    holds each shard's local tokens.  Returns ``(y (D, T_loc, D_model),
    aux)`` (aux the mean of the shards' router losses), plus the routing
    statistics summed over the shards with ``collect_stats``."""
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    n_sh, T_loc, Dm = x_loc.shape
    dt = x_loc.dtype
    dev = x_loc.device
    # per-(expert, source) capacity
    cap = max(1, int(m.capacity_factor * k * T_loc) // E)

    logits = x_loc.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                  # (D, T_loc, E)
    w, ids = _top_k(probs.reshape(-1, E), k)
    w, ids = w.reshape(n_sh, T_loc, k), ids.reshape(n_sh, T_loc, k)
    w = (w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)).to(dt)
    me = probs.mean(dim=1)                                 # (D, E)
    ce = F.one_hot(ids.long(), E).sum(dim=(1, 2)).to(torch.float32) / (
        T_loc * k)
    aux = E * torch.sum(me * ce, dim=-1) + 1e-3 * torch.mean(
        torch.logsumexp(logits, dim=-1) ** 2, dim=-1)      # (D,)

    flat_e = ids.reshape(n_sh, T_loc * k)
    slot, keep = dispatch_slots(flat_e, E, cap)
    # dispatch buffer (E, cap, D) a shard; dropped pairs write to a scratch
    # row past the end
    row = flat_e.long() * cap + slot.long()
    buf_idx = torch.where(keep, row, E * cap)
    x_rep = x_loc[:, :, None, :].expand(n_sh, T_loc, k, Dm).reshape(
        n_sh, T_loc * k, Dm)
    disp = torch.zeros((n_sh, E * cap + 1, Dm), dtype=dt, device=dev)
    disp = disp.scatter(1, buf_idx[..., None].expand(-1, -1, Dm),
                        x_rep)[:, :E * cap]
    # the all-to-all: expert e's rows from every source shard, (E, D·cap, Dm)
    recv = disp.reshape(n_sh, E, cap, Dm).transpose(0, 1).reshape(
        E, n_sh * cap, Dm)
    h = F.silu(torch.matmul(recv, wg.to(dt))) * torch.matmul(recv,
                                                              wi.to(dt))
    out = torch.matmul(h, wo.to(dt))                       # (E, D·cap, Dm)
    # the return trip, then each kept pair's result weighted and summed
    back = out.reshape(E, n_sh, cap, Dm).transpose(0, 1).reshape(
        n_sh, E * cap, Dm)
    gathered = back.gather(1, torch.where(keep, row, 0)[..., None].expand(
        -1, -1, Dm))
    gathered = torch.where(keep[..., None], gathered,
                           torch.zeros((), dtype=dt, device=dev))
    y = torch.sum(gathered.reshape(n_sh, T_loc, k, Dm) * w[..., None],
                  dim=2)
    aux = aux.mean()
    if collect_stats:
        return y, aux, pair_stats(ids.reshape(-1, k), E)
    return y, aux


def moe_a2a(params, cfg: ModelConfig, x: torch.Tensor,
            collect_stats: bool = False, *, mesh):
    """Expert-parallel MoE over the D shards of ``mesh``: shard d holds the
    d-th block of the sequence of every row (the JAX package's
    sequence-over-"model" boundary layout); ``moe_dense`` where E or S does
    not divide over D."""
    D = mesh.num_shards
    B, S, Dm = x.shape
    if cfg.moe.num_experts % D or S % D:
        return moe_dense(params, cfg, x, collect_stats)
    x_loc = x.reshape(B, D, S // D, Dm).transpose(0, 1).reshape(
        D, B * (S // D), Dm)
    out = _a2a_local(x_loc, params["router"], params["wi"], params["wg"],
                     params["wo"], cfg=cfg, collect_stats=collect_stats)
    y = out[0].reshape(D, B, S // D, Dm).transpose(0, 1).reshape(B, S, Dm)
    if cfg.moe.num_shared:
        y = y + _shared(params, x, x.dtype)
    return (y,) + tuple(out[1:])


def moe_ffn(params, cfg: ModelConfig, x: torch.Tensor,
            impl: Optional[str] = None, collect_stats: bool = False, *,
            mesh=None):
    """The MoE FFN: :func:`moe_a2a` over ``mesh`` (or the ambient mesh of
    :func:`use_mesh`) for ``impl`` "a2a" or "auto", else ``moe_dense``."""
    impl = impl or cfg.moe.impl
    if impl not in IMPLS:
        raise ValueError(f"unknown MoE impl {impl!r}; one of {IMPLS}")
    if mesh is None and _AMBIENT:
        mesh = _AMBIENT[-1]
    if mesh is not None and impl != "dense":
        return moe_a2a(params, cfg, x, collect_stats, mesh=mesh)
    return moe_dense(params, cfg, x, collect_stats)
