"""Mixture-of-Experts FFN (counterpart of ``repro.models.moe``) on one card.

``moe_dense`` is the JAX package's one-hot dispatch/combine: every expert
is computed for every token and the top-k results are combined with the
router's weights (no token dropping).  The products run as batched
matmuls with the expert axis as the batch (``torch.matmul`` of the (T, D)
tokens against the (E, D, F) stack), so the stacked weights are read in
place: folding them into one (D, E*F) matrix would copy them (22.5 GB at
deepseek-v3's width).

The expert-parallel ``a2a`` path (:func:`moe_a2a`) is the counterpart of
the JAX package's ``shard_map`` over its mesh: the tokens are split by
(block of rows over the batch axes ``("pod", "data")``, block of the
sequence over ``"model"``), one token shard a mesh shard, and the experts
over the EP axes ``cfg.ep_axes`` present in the mesh.  Each shard routes
its own tokens, buckets them per expert with a per-(expert, source)
capacity (the in-bucket slot from K3's stable rank, ``kernels.migrate.
ops.bucket_ranks``, on a card), dispatches into an (E, cap, D) buffer
whose dropped slots go to a scratch row, exchanges it with the members of
its EP group (``distributed.autodiff.all_to_all``), runs its experts
batched, sends the results back and combines them by the router's
weights.  The mesh is a ``distributed.mesh.ShardMesh`` (every shard in
this process, the token shards a leading tensor axis) or a
``ProcessMesh`` (this rank's shard: its rows of the batch, of which it
takes its sequence block and gathers the layer's output back,
``distributed.autodiff.enter``/``leave``; under the ``"dp"`` profile,
whose ranks hold rows of their own over ``"model"`` too, an exchange over
``"model"`` regroups them into the same token shards and back).  There
the expert stacks' ``"data"`` (FSDP) blocks are gathered before the
exchange, and the shared expert runs tensor parallel over ``"model"``
(``sharding.tp_plan``).  :func:`moe_ffn` takes the mesh where one is
given (or ambient, ``sharding.use_mesh``, re-exported here) and ``impl``
is "a2a" or "auto"; otherwise ``moe_dense``.  Its gradient is autograd of
these operations, as the JAX package's is autodiff of its einsums.

``pair_stats`` gives the per-expert token counts and the co-activation
matrix the expert-placement balancer reads; both are small integers held
in f32, exact.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import autodiff, sharding
from repro_torch.distributed.sharding import (  # noqa: F401
    ambient_mesh, use_mesh)
from repro_torch.distributed.mesh import ProcessMesh
from repro_torch.kernels import resolve_device
from repro_torch.kernels.migrate import ops as mops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import BATCH, MODEL, mlp
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
    ep = tuple(cfg.ep_axes)
    # experts stacked on a leading E dim over the EP axes; FSDP over "data"
    # where "data" is not an EP axis
    fsdp = "data" if ep == ("model",) else None
    p = dict(router=ParamSpec((D, E), ((None,), None), scale=0.006),
             wi=ParamSpec((E, D, Fe), (ep, fsdp, None)),
             wg=ParamSpec((E, D, Fe), (ep, fsdp, None)),
             wo=ParamSpec((E, Fe, D), (ep, None, fsdp)))
    if m.num_shared:
        S = m.num_shared * Fe
        p.update(shared_wi=ParamSpec((D, S), ("data", MODEL)),
                 shared_wg=ParamSpec((D, S), ("data", MODEL)),
                 shared_wo=ParamSpec((S, D), (MODEL, "data")))
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


SHARED = ("shared_wi", "shared_wg", "shared_wo")


def _shared(params, cfg: ModelConfig, x: torch.Tensor, dt,
            mesh=None) -> torch.Tensor:
    """The shared expert, a gated MLP on x's rows.  Over a
    ``ProcessMesh`` given this rank's blocks it is tensor parallel over
    ``"model"`` where ``sharding.tp_plan`` says so (its ``d_ff`` columns
    split there), its ``"data"`` blocks gathered before use; weights
    given whole are used whole."""
    w = {k: params[k] for k in SHARED}
    tp = None
    if isinstance(mesh, ProcessMesh):
        specs = moe_specs(cfg)
        kind = next(k for k in cfg.all_layers() if k.startswith("moe"))
        if (sharding.tp_plan(cfg, mesh)[kind]["shared"] == "tp"
                and w["shared_wo"].shape[0] < specs["shared_wo"].shape[0]):
            tp = mesh
        w = {k: sharding.gathered(v, specs[k], mesh, cfg.sharding_profile,
                                  keep=MODEL if tp is not None else ())
             for k, v in w.items()}
    return mlp(dict(wi=w["shared_wi"], wg=w["shared_wg"],
                    wo=w["shared_wo"]), x, dt, mesh=tp)


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
        y = y + _shared(params, cfg, x, dt)
    if collect_stats:
        return y, aux, stats
    return y, aux


# --------------------------------------------------------------- a2a path --


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


class Routing(NamedTuple):
    """The a2a's routing on this process's token shards: ``ids`` (n,
    T_loc, k) i32, and each (token, k) pair's ``slot`` and ``keep`` (n,
    T_loc·k) in its (expert, source shard) bucket."""

    ids: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor


def _a2a_local(x_loc: torch.Tensor, router, wi, wg, wo, *,
               cfg: ModelConfig, mesh, ep_axes: Tuple[str, ...]):
    """The EP body over this process's token shards (every shard of a
    ``ShardMesh``, one of a ``ProcessMesh``): ``x_loc`` (n, T_loc, D_model)
    holds each shard's tokens, ``wi``/``wg``/``wo`` (n, E_loc, ...) each
    shard's block of the experts over ``ep_axes``.  Returns ``(y (n,
    T_loc, D_model), aux (n,) each shard's router loss, Routing)``."""
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    n_sh, T_loc, Dm = x_loc.shape
    ep = mesh.size(ep_axes)
    E_loc = E // ep
    dt = x_loc.dtype
    dev = x_loc.device
    # per-(expert, source) capacity
    cap = max(1, int(m.capacity_factor * k * T_loc) // E)

    logits = x_loc.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                  # (n, T_loc, E)
    w, ids = _top_k(probs.reshape(-1, E), k)
    w, ids = w.reshape(n_sh, T_loc, k), ids.reshape(n_sh, T_loc, k)
    w = (w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)).to(dt)
    me = probs.mean(dim=1)                                 # (n, E)
    ce = F.one_hot(ids.long(), E).sum(dim=(1, 2)).to(torch.float32) / (
        T_loc * k)
    aux = E * torch.sum(me * ce, dim=-1) + 1e-3 * torch.mean(
        torch.logsumexp(logits, dim=-1) ** 2, dim=-1)      # (n,)

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
    # the exchange: block j (experts of EP member j) to member j; this
    # shard's experts' rows from every member, (E_loc, ep·cap, Dm)
    recv = autodiff.all_to_all(mesh, disp.reshape(n_sh, ep, E_loc, cap, Dm),
                               ep_axes)
    recv = recv.permute(0, 2, 1, 3, 4).reshape(n_sh, E_loc, ep * cap, Dm)
    h = F.silu(torch.matmul(recv, wg.to(dt))) * torch.matmul(recv,
                                                              wi.to(dt))
    out = torch.matmul(h, wo.to(dt))                 # (n, E_loc, ep·cap, Dm)
    # the return trip, then each kept pair's result weighted and summed
    back = autodiff.all_to_all(mesh, out.reshape(
        n_sh, E_loc, ep, cap, Dm).permute(0, 2, 1, 3, 4), ep_axes)
    back = back.reshape(n_sh, E * cap, Dm)
    gathered = back.gather(1, torch.where(keep, row, 0)[..., None].expand(
        -1, -1, Dm))
    gathered = torch.where(keep[..., None], gathered,
                           torch.zeros((), dtype=dt, device=dev))
    y = torch.sum(gathered.reshape(n_sh, T_loc, k, Dm) * w[..., None],
                  dim=2)
    return y, aux, Routing(ids, slot, keep)


def ep_plan(cfg: ModelConfig, mesh, seq_len: int):
    """``(ep_axes, ep)`` of the a2a over ``mesh`` — the EP axes
    ``cfg.ep_axes`` the mesh has and their size — or None where the JAX
    package takes ``moe_dense``: no ``"model"`` axis, no EP axis, or E or
    the sequence not dividing over them."""
    if MODEL not in mesh.axes:
        return None
    ep_axes = mesh.group_axes(cfg.ep_axes)
    ep = mesh.size(ep_axes)
    if (not ep_axes or cfg.moe.num_experts % ep
            or seq_len % mesh.axes[MODEL]):
        return None
    return ep_axes, ep


def _expert_blocks(params, cfg: ModelConfig, mesh, ep_axes, ep):
    """Each local shard's block of the expert stacks, (n, E_loc, ...).
    On a ``ProcessMesh`` a stack is this rank's block (E_loc experts) or
    the whole stack, of which the block is cut, its ``"data"`` (FSDP)
    blocks gathered first, as GSPMD gathers them at the JAX layer's
    boundary; on a ``ShardMesh`` the whole stack, cut into every shard's
    block (a view where the EP group is the whole mesh)."""
    E = cfg.moe.num_experts
    E_loc = E // ep
    specs = moe_specs(cfg)
    out = []
    for name in ("wi", "wg", "wo"):
        w = params[name]
        if isinstance(mesh, ProcessMesh):
            w = sharding.gathered(w, specs[name], mesh, cfg.sharding_profile,
                                  keep=ep_axes)
        if w.shape[0] not in (E, E_loc):
            raise ValueError(f"expert stack {name} has {w.shape[0]} "
                             f"experts: neither {E} nor the {E_loc} of an "
                             f"EP block over {ep_axes}")
        blocks = w.reshape(-1, E_loc, *w.shape[1:])
        if isinstance(mesh, ProcessMesh):
            i = mesh.group_rank(ep_axes, mesh.rank) if w.shape[0] == E else 0
            out.append(blocks[i:i + 1])
        elif ep == mesh.num_shards:
            out.append(blocks)
        else:
            idx = [mesh.group_rank(ep_axes, s)
                   for s in range(mesh.num_shards)]
            out.append(blocks[torch.tensor(idx, device=w.device)])
    return out


def a2a_with_routing(params, cfg: ModelConfig, x: torch.Tensor, *, mesh):
    """:func:`moe_a2a` with the routing: ``(y, aux, RouterStats, Routing)``,
    or None where the JAX package takes ``moe_dense`` (:func:`ep_plan`).

    On a ``ShardMesh`` ``x`` (B, S, D) is the whole batch; on a
    ``ProcessMesh`` this rank's rows of it: its block over the profile's
    batch axes (``sharding.batch_axes``), replicated over ``"model"``
    under ``"2d"`` and its own over ``"model"`` too under ``"dp"``.
    Either way the token shards are the JAX layer's (its ``shard_map``
    takes ``P(("pod", "data"), "model", None)`` under both profiles):
    shard (p, d, m) routes the rows of its ``("pod", "data")`` block, its
    ``"model"`` block of the sequence.  ``aux`` is the mean of the token
    shards' router losses in shard order (the JAX package's ``pmean``);
    the statistics are summed over the token shards."""
    plan = ep_plan(cfg, mesh, x.shape[1])
    if plan is None:
        return None
    ep_axes, ep = plan
    B, S, Dm = x.shape
    M = mesh.axes[MODEL]
    k = cfg.moe.top_k
    wi, wg, wo = _expert_blocks(params, cfg, mesh, ep_axes, ep)
    if isinstance(mesh, ProcessMesh):
        rows_own = MODEL in sharding.batch_axes(mesh, cfg.sharding_profile)
        if rows_own:
            # "dp": an exchange over "model" gives each member the rows of
            # its group (its (pod, data) block) in member order, its
            # sequence block; the reverse exchange after
            x_loc = _exchange(mesh, x.reshape(B, M, S // M, Dm)
                              .transpose(0, 1)).reshape(1, -1, Dm)
        else:
            # this rank's sequence block of its rows, then the sequence
            # gathered back: the boundary of the sequence-split region
            x_loc = autodiff.enter(mesh, x, MODEL, dim=1).reshape(1, -1, Dm)
        y, aux, routing = _a2a_local(x_loc, params["router"], wi, wg, wo,
                                     cfg=cfg, mesh=mesh, ep_axes=ep_axes)
        if rows_own:
            y = _exchange(mesh, y.reshape(M, B, S // M, Dm)).transpose(
                0, 1).reshape(B, S, Dm)
        else:
            y = autodiff.leave(mesh, y.reshape(B, S // M, Dm), MODEL, dim=1)
        aux = autodiff.leave(mesh, aux).mean()
        st = pair_stats(routing.ids.reshape(-1, k), cfg.moe.num_experts)
        st = RouterStats(*(mesh.psum(t.unsqueeze(0)) for t in st))
    else:
        nb = mesh.size(BATCH)
        if B % nb:
            raise ValueError(f"batch {B} does not divide over the "
                             f"{nb} shards of {BATCH}")
        x_loc = x.reshape(nb, B // nb, M, S // M, Dm).permute(
            0, 2, 1, 3, 4).reshape(mesh.num_shards, -1, Dm)
        y, aux, routing = _a2a_local(x_loc, params["router"], wi, wg, wo,
                                     cfg=cfg, mesh=mesh, ep_axes=ep_axes)
        y = y.reshape(nb, M, B // nb, S // M, Dm).permute(
            0, 2, 1, 3, 4).reshape(B, S, Dm)
        aux = aux.mean()
        st = pair_stats(routing.ids.reshape(-1, k), cfg.moe.num_experts)
    if cfg.moe.num_shared:
        y = y + _shared(params, cfg, x, x.dtype, mesh)
    return y, aux, st, routing


def _exchange(mesh: ProcessMesh, blocks: torch.Tensor) -> torch.Tensor:
    """(M, ...) → (M, ...): block j to member j of this rank's group over
    ``"model"``; block j of the result from member j (with a gradient)."""
    return autodiff.all_to_all(mesh, blocks.contiguous()[None], MODEL)[0]


def moe_a2a(params, cfg: ModelConfig, x: torch.Tensor,
            collect_stats: bool = False, *, mesh):
    """Expert-parallel MoE over ``mesh`` (see :func:`a2a_with_routing`):
    ``(y, aux)`` or ``(y, aux, RouterStats)``; ``moe_dense`` where the
    JAX package takes it (:func:`ep_plan`; on a ``ShardMesh`` only)."""
    out = a2a_with_routing(params, cfg, x, mesh=mesh)
    if out is None:
        if isinstance(mesh, ProcessMesh):
            raise ValueError(
                f"moe_dense over a ProcessMesh is not ported: E "
                f"{cfg.moe.num_experts} must divide over the EP axes "
                f"{cfg.ep_axes} and the sequence {x.shape[1]} over "
                f"{MODEL!r} of {mesh.axes}")
        return moe_dense(params, cfg, x, collect_stats)
    y, aux, st, _ = out
    return (y, aux, st) if collect_stats else (y, aux)


def moe_ffn(params, cfg: ModelConfig, x: torch.Tensor,
            impl: Optional[str] = None, collect_stats: bool = False, *,
            mesh=None):
    """The MoE FFN: :func:`moe_a2a` over ``mesh`` (or the ambient mesh of
    ``sharding.use_mesh``) for ``impl`` "a2a" or "auto", else ``moe_dense``."""
    impl = impl or cfg.moe.impl
    if impl not in IMPLS:
        raise ValueError(f"unknown MoE impl {impl!r}; one of {IMPLS}")
    if mesh is None:
        mesh = ambient_mesh()
    if mesh is not None and impl != "dense":
        return moe_a2a(params, cfg, x, collect_stats, mesh=mesh)
    return moe_dense(params, cfg, x, collect_stats)
