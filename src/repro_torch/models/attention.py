"""Attention: GQA (full / sliding-window / prefix-LM) and MLA
(DeepSeek's multi-head latent attention, absorbed form), counterpart of
``repro.models.attention``.

Every call, prefill and decode alike, goes through
``kernels.flash_attention.ops.flash_attention``: the hand-written kernel
for CUDA tensors, the plain chunked attention (the JAX package's
``chunked_attention``) for CPU tensors.  KV caches carry an explicit
per-slot position array (``pos``, initialized to ``POS_SENTINEL``), so
full caches and ring-buffer sliding-window caches share one code path.

Over a ``ProcessMesh`` (``tp=``, the mode ``distributed.sharding.tp_plan``
gives) the heads are split over ``"model"``: each rank projects, ropes
and attends over its block of the heads and ``wo`` is row parallel, the
collectives written out (``autodiff.tp_in`` where the replicated input
enters, ``autodiff.row_parallel`` adding the partial outputs).  GQA takes
either the plain split (KV heads dividing over ``"model"``) or the JAX
package's head-repeat branch (they do not, H does): the keys and values
repeated G times on the head axis and each rank's block of them taken, so
each rank attends with G = 1.

With a cache over a ``ProcessMesh`` of ``"model"`` size M > 1 each rank
holds its block of the cache as the JAX rules place it
(``sharding.cache_placements``: dim 1, the slots, over ``"model"``, all
heads): rank i of ``"model"`` holds global slots ``[i T/M, (i+1) T/M)``
(:func:`length_block`).  A prefill attends over the prompt's own keys
(the cache holds nothing before it) and stores them into the slots'
owners: under the plain head split one ``all_to_all`` over ``"model"``
turns (every slot, this rank's KV heads) into (this rank's slots, every
KV head); where the keys are whole on every rank (the head-repeat
branch, gathered layers, MLA's latents) each rank keeps its slots.  A
decode step gathers the new token's query (and key and value) heads
over ``"model"`` — a few KB — writes the keys into the slot's owner,
computes K6's partials over this rank's block for every head
(``flash_partials``, the slots counted globally), and merges the
ranks' partials (``flash_combine``): where the heads are split, one
``all_to_all`` over ``"model"`` sends each rank only its heads' partials
of every member, and its merged heads go on through the row-parallel
``wo``; else the partials are gathered whole.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed import autodiff, sharding
from repro_torch.kernels import resolve_device
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                    flash_combine,
                                                    flash_partials)
from repro_torch.kernels.flash_attention.ref import POS_SENTINEL
from repro_torch.kernels.flash_attention.ref import mask as _mask  # noqa: F401
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (MODEL, apply_rope, rms_norm,
                                       rms_norm_spec)
from repro_torch.models.params import ParamSpec


def gqa_specs(cfg: ModelConfig) -> Dict:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    p = dict(wq=ParamSpec((D, H * hd), ("data", MODEL)),
             wk=ParamSpec((D, KV * hd), ("data", MODEL)),
             wv=ParamSpec((D, KV * hd), ("data", MODEL)),
             wo=ParamSpec((H * hd, D), (MODEL, "data")))
    if cfg.qkv_bias:
        p.update(bq=ParamSpec((H * hd,), (MODEL,), init="zeros"),
                 bk=ParamSpec((KV * hd,), (MODEL,), init="zeros"),
                 bv=ParamSpec((KV * hd,), (MODEL,), init="zeros"))
    return p


def mla_specs(cfg: ModelConfig) -> Dict:
    m = cfg.mla
    D, H = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    return dict(
        wq_a=ParamSpec((D, m.q_lora_rank), ("data", None)),
        q_norm=rms_norm_spec(m.q_lora_rank),
        wq_b=ParamSpec((m.q_lora_rank, H * qk), (None, MODEL)),
        wkv_a=ParamSpec((D, m.kv_lora_rank + m.qk_rope_dim),
                        ("data", None)),
        kv_norm=rms_norm_spec(m.kv_lora_rank),
        wk_b=ParamSpec((m.kv_lora_rank, H * m.qk_nope_dim), (None, MODEL)),
        wv_b=ParamSpec((m.kv_lora_rank, H * m.v_head_dim), (None, MODEL)),
        wo=ParamSpec((H * m.v_head_dim, D), (MODEL, "data")),
    )


def init_gqa_cache(cfg: ModelConfig, batch: int, max_len: int, window: int,
                   dtype, device) -> Dict:
    """``k``/``v`` (batch, T, KV, hd) and ``pos`` (batch, T) i32 with
    T = min(window, max_len) for a window layer (a ring), else max_len."""
    KV, hd = cfg.num_kv_heads, cfg.hd
    T = min(window, max_len) if window else max_len
    return dict(
        k=torch.zeros((batch, T, KV, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, T, KV, hd), dtype=dtype, device=device),
        pos=torch.full((batch, T), POS_SENTINEL, dtype=torch.int32,
                       device=device),
    )


#: the JAX gate of the head-repeat branch: keys no longer than this
REPEAT_MAX_KV = 16384


# ------------------------------------------- a cache split by length --


def cache_mesh(cache: Optional[Dict]):
    """The ambient ``ProcessMesh`` where ``cache`` is this rank's block of
    a cache split by length over ``"model"`` (M > 1), else None."""
    if cache is None:
        return None
    mesh = sharding.rank_mesh()
    if mesh is None or mesh.axes.get(MODEL, 1) == 1:
        return None
    return mesh


def length_block(cache: Dict, mesh) -> Tuple[int, int, int]:
    """``(T_local, offset, T)``: this rank's slots of a cache of T slots
    split over ``"model"`` (its block holds ``[offset, offset +
    T_local)``)."""
    T_loc = cache["pos"].shape[1]
    M = mesh.axes[MODEL]
    return T_loc, mesh.group_rank(MODEL, mesh.rank) * T_loc, T_loc * M


def _store_prompt(cache: Dict, new: Dict, slot: torch.Tensor, mesh,
                  exchange: Tuple[str, ...] = ()) -> None:
    """Write a prompt's entries ``new`` ({name: (B, S, ...)}; ``pos``
    among them) at global slots ``slot`` (B, S) into this rank's block of
    ``cache``, in place: each entry is scattered into a (B, T, ...) row of
    every slot, and this rank's slots of it kept where the prompt wrote.
    The entries in ``exchange`` hold this rank's block of the heads
    (dim 2), the same extent on every rank: one ``all_to_all`` over
    ``"model"`` gives each rank its slots of every member's heads, in
    member order (the whole heads)."""
    T_loc, off, T = length_block(cache, mesh)
    B = slot.shape[0]
    bidx = torch.arange(B, device=slot.device)[:, None]
    slot = slot.long()
    written = torch.zeros((B, T), dtype=torch.bool, device=slot.device)
    written[bidx, slot] = True
    written = written[:, off:off + T_loc]

    def scattered(x):
        buf = x.new_zeros((B, T) + tuple(x.shape[2:]))
        buf[bidx, slot] = x
        return buf

    bufs = {k: scattered(v.to(cache[k].dtype)) for k, v in new.items()}
    if exchange:
        M = mesh.axes[MODEL]
        x = torch.stack([bufs[k] for k in exchange])     # (n, B, T, h, hd)
        n, _, _, h, hd = x.shape
        x = x.reshape(n, B, M, T_loc, h, hd).permute(2, 0, 1, 3, 4, 5)
        got = mesh.all_to_all(x.contiguous()[None], MODEL)[0]
        got = got.permute(1, 2, 3, 0, 4, 5).reshape(n, B, T_loc, M * h, hd)
        for i, k in enumerate(exchange):
            bufs[k] = got[i]
    for k, buf in bufs.items():
        blk = buf if k in exchange else buf[:, off:off + T_loc]
        keep = written.reshape(B, T_loc, *([1] * (blk.dim() - 2)))
        cache[k].copy_(torch.where(keep, blk, cache[k]))


def _store_token(cache: Dict, new: Dict, slot: torch.Tensor, mesh) -> None:
    """Write one token's entries a row (``new``: {name: (B, 1, ...)}) at
    global slots ``slot`` (B, 1) into this rank's block of ``cache`` in
    place: the owner of the slot writes it; the others write back what
    they hold (no host sync)."""
    T_loc, off, _ = length_block(cache, mesh)
    B = slot.shape[0]
    bidx = torch.arange(B, device=slot.device)[:, None]
    loc = slot.long() - off
    own = (loc >= 0) & (loc < T_loc)
    loc = loc.clamp(0, T_loc - 1)
    for k, v in new.items():
        cur = cache[k][bidx, loc]
        keep = own.reshape(B, 1, *([1] * (cur.dim() - 2)))
        cache[k][bidx, loc] = torch.where(keep, v.to(cache[k].dtype), cur)


def _store(cache: Dict, new: Dict, slot: torch.Tensor, mesh,
           exchange: Tuple[str, ...] = ()) -> None:
    if slot.shape[1] == 1 and not exchange:
        _store_token(cache, new, slot, mesh)
    else:
        _store_prompt(cache, new, slot, mesh, exchange)


def _block_attention(q, k, v, q_pos, kv_pos, cache: Dict, mesh, *,
                     window: int, prefix_len: int,
                     own: bool = False) -> torch.Tensor:
    """Attention of the queries ``q`` (B, S, KV, G, hd) (every head) over
    the whole cache, of which ``k``, ``v``, ``kv_pos`` are this rank's
    block: K6's partials over the block, exchanged over ``"model"`` and
    merged rank-major, split-minor.  Every head's result (B, S, KV, G, hd)
    in q's type, the partials gathered whole; with ``own`` (the heads
    split over ``"model"``) this rank's block of the KV·G heads (B, S,
    KV·G/M, 1, hd), one ``all_to_all`` sending member j only block j's
    partials, so each rank merges only its heads."""
    _, off, T = length_block(cache, mesh)
    m, l, o = flash_partials(q, k, v, q_pos, kv_pos, window=window,
                             prefix_len=prefix_len, offset=off, total=T)
    n, B, S, KV, G, hd = o.shape
    parts = torch.cat([m[..., None], l[..., None], o], dim=-1)
    if own:
        M = mesh.axes[MODEL]
        x = parts.reshape(n, B, S, M, KV * G // M, 1, hd + 2).movedim(3, 0)
        parts = autodiff.all_to_all(mesh, x.contiguous()[None], MODEL)[0]
        parts = parts.flatten(0, 1)          # (M n, B, S, H/M, 1, hd + 2)
    else:
        parts = autodiff.leave(mesh, parts.contiguous(), MODEL, 0)
    m, l, o = parts.split([1, 1, hd], dim=-1)
    return flash_combine(m[..., 0].contiguous(), l[..., 0].contiguous(),
                         o.contiguous(), q.dtype)


def gqa_attention(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, *, window: int = 0,
                  prefix_len: int = 0, cache: Optional[Dict] = None,
                  tp: Optional[str] = None, decode: bool = False
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B, S, D), positions (B, S) → (y (B, S, D), cache).

    With a cache, the new keys and values are written at slot
    ``positions mod T`` (window layers) or ``positions`` *in place* — the
    returned cache is the one given — and attention reads the whole
    cache.  A window layer's prefill is defined for prompts up to T:
    longer ones would write several positions into one slot at once.

    ``tp`` (over the ambient ``ProcessMesh``): ``"tp"`` — ``wq``, ``wk``,
    ``wv`` (and biases) are this rank's column blocks of whole heads and
    ``wo`` its row block; ``"repeat"`` — ``wq``/``bq``/``wo`` so, ``wk``/
    ``wv``/``bk``/``bv`` whole (each rank uses its part of them).  None:
    the weights whole.  A cache over the ambient ``ProcessMesh`` is this
    rank's block of slots (:func:`cache_mesh`; the module's head): a
    prefill (``decode`` False) from position 0, or ``decode`` steps
    through K6's partials."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    G = H // KV
    cmesh = cache_mesh(cache)
    mesh = sharding.rank_mesh() if tp else None
    if mesh is not None:
        M = mesh.axes[MODEL]
        x = autodiff.tp_in(x, mesh, MODEL)
        H //= M                       # this rank's query heads,
        if tp == "tp":
            KV //= M                  # and KV heads where they divide
    dt = x.dtype
    q = x @ params["wq"].to(dt)
    k = x @ params["wk"].to(dt)
    v = x @ params["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    q = apply_rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta)
    q = q.reshape(B, S, H, 1, hd) if tp == "repeat" else q.reshape(
        B, S, KV, G, hd)
    k = apply_rope(k.reshape(B, S, KV, hd), positions, cfg.rope_theta)
    v = v.reshape(B, S, KV, hd)

    if cmesh is not None:
        T = length_block(cache, cmesh)[2]
        slot = torch.remainder(positions, T) if window else positions
        if decode:
            out = _gqa_block_decode(q, k, v, positions, slot, cache, cmesh,
                                    tp, window=window, prefix_len=prefix_len)
            if mesh is not None:
                return autodiff.row_parallel(out, params["wo"].to(dt), mesh,
                                             MODEL), cache
            return out @ params["wo"].to(dt), cache
        _store(cache, dict(k=k, v=v, pos=positions.to(torch.int32)), slot,
               cmesh, exchange=("k", "v") if tp == "tp" else ())
        kv_pos = positions
    elif cache is not None:
        T = cache["k"].shape[1]
        slot = (torch.remainder(positions, T) if window
                else positions).long()                        # (B, S)
        bidx = torch.arange(B, device=x.device)[:, None]
        cache["k"][bidx, slot] = k.to(cache["k"].dtype)
        cache["v"][bidx, slot] = v.to(cache["v"].dtype)
        cache["pos"][bidx, slot] = positions.to(torch.int32)
        k, v, kv_pos = cache["k"], cache["v"], cache["pos"]
    else:
        kv_pos = positions

    if tp == "repeat":
        # the JAX branch repeats K and V G times on the head axis and
        # splits every head over "model": this rank's H heads of them
        first = mesh.group_rank(MODEL, mesh.rank) * H
        idx = torch.div(torch.arange(first, first + H, device=x.device), G,
                        rounding_mode="floor")
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    out = flash_attention(q, k, v, positions, kv_pos, window=window,
                          prefix_len=prefix_len).reshape(B, S, H * hd)
    if mesh is not None:
        return autodiff.row_parallel(out, params["wo"].to(dt), mesh,
                                     MODEL), cache
    return out @ params["wo"].to(dt), cache


def _gqa_block_decode(q, k, v, positions, slot, cache: Dict, mesh,
                      tp: Optional[str], *, window: int,
                      prefix_len: int) -> torch.Tensor:
    """A decode step over this rank's block of the cache: the new token's
    heads gathered over ``"model"`` where this rank holds a block of them
    (``tp``), its keys and values written into the slot's owner, every
    head's attention from the ranks' partials; returns this rank's heads
    of it, (B, S, heads · hd)."""
    B, S = positions.shape
    hd = q.shape[-1]
    if tp == "tp":
        k = autodiff.leave(mesh, k, MODEL, 2)
        v = autodiff.leave(mesh, v, MODEL, 2)
    if tp is not None:
        q = autodiff.leave(mesh, q, MODEL, 2)          # every query head
    KV = k.shape[2]
    q = q.reshape(B, S, KV, -1, hd)
    _store(cache, dict(k=k, v=v, pos=positions.to(torch.int32)), slot, mesh)
    out = _block_attention(q, cache["k"], cache["v"], positions,
                           cache["pos"], cache, mesh, window=window,
                           prefix_len=prefix_len, own=tp is not None)
    return out.reshape(B, S, -1)


# ----------------------------------------------------------- MLA forward ----


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device="cuda") -> Dict:
    """The latent cache: ``ckv`` (batch, max_len, kv_lora_rank), ``krope``
    (batch, max_len, qk_rope_dim) and ``pos`` (batch, max_len) i32."""
    m = cfg.mla
    device = resolve_device(device)
    return dict(
        ckv=torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                        device=device),
        krope=torch.zeros((batch, max_len, m.qk_rope_dim), dtype=dtype,
                          device=device),
        pos=torch.full((batch, max_len), POS_SENTINEL, dtype=torch.int32,
                       device=device),
    )


def mla_attention(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, *, window: int = 0,
                  prefix_len: int = 0, cache: Optional[Dict] = None,
                  tp: Optional[str] = None, decode: bool = False
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Multi-head latent attention in the absorbed form: x (B, S, D),
    positions (B, S) → (y (B, S, D), cache).

    Each head's query is absorbed into the latent space (``q_nope ·
    W_kb``), so attention runs against the (kv_lora + rope)-wide latents
    directly: one "kv head" of G = H query heads, keys ``[ckv | k_rope]``,
    values ``[ckv | 0]`` of the same width, the first kv_lora_rank output
    columns kept.  With a cache, the new latents are written at slot
    ``positions`` in place and attention reads the whole cache.

    ``tp="tp"`` (over the ambient ``ProcessMesh``): ``wq_b``, ``wk_b``,
    ``wv_b`` are this rank's column blocks of whole heads and ``wo`` its
    row block; the replicated query latent and the keys' latents enter
    this rank's heads by ``autodiff.tp_in``.  A cache over the ambient
    ``ProcessMesh`` is this rank's block of slots: each rank keeps its
    slots of the (replicated) per-token latents, and a ``decode`` step
    gathers the absorbed queries of every head and merges the ranks'
    partials (the simt form's at MLA's published G = 128, hd = 576)."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    dt = x.dtype
    cmesh = cache_mesh(cache)
    mesh = sharding.rank_mesh() if tp else None
    if mesh is not None:
        H //= mesh.axes[MODEL]
    qa = rms_norm(x @ params["wq_a"].to(dt), params["q_norm"], cfg.norm_eps)
    if mesh is not None:
        qa = autodiff.tp_in(qa, mesh, MODEL)
    q = (qa @ params["wq_b"].to(dt)).reshape(B, S, H,
                                             m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q.split([m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv = x @ params["wkv_a"].to(dt)
    ckv, k_rope = kv.split([m.kv_lora_rank, m.qk_rope_dim], dim=-1)
    ckv = rms_norm(ckv, params["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]

    if cmesh is not None:
        _store(cache, dict(ckv=ckv, krope=k_rope,
                           pos=positions.to(torch.int32)), positions, cmesh)
        if decode:
            ckv_all, krope_all, kv_pos = (cache["ckv"], cache["krope"],
                                          cache["pos"])
        else:                         # a prefill: the prompt's own latents
            ckv_all, krope_all, kv_pos = ckv, k_rope, positions
    elif cache is not None:
        slot = positions.long()
        bidx = torch.arange(B, device=x.device)[:, None]
        cache["ckv"][bidx, slot] = ckv.to(cache["ckv"].dtype)
        cache["krope"][bidx, slot] = k_rope.to(cache["krope"].dtype)
        cache["pos"][bidx, slot] = positions.to(torch.int32)
        ckv_all, krope_all, kv_pos = cache["ckv"], cache["krope"], cache["pos"]
    else:
        ckv_all, krope_all, kv_pos = ckv, k_rope, positions
    if mesh is not None and cmesh is None:
        ckv_all = autodiff.tp_in(ckv_all, mesh, MODEL)
        krope_all = autodiff.tp_in(krope_all, mesh, MODEL)

    # absorb: q_abs[h] = q_nope[h] @ wk_b[h]^T, latent-space queries
    wk_b = params["wk_b"].to(dt).reshape(m.kv_lora_rank, H, m.qk_nope_dim)
    q_abs = torch.einsum("bshn,rhn->bshr", q_nope, wk_b)
    q_full = torch.cat([q_abs, q_rope], dim=-1)[:, :, :, None, :]
    # the kernel scales by the latent width; rescale to the nominal one
    nominal = m.qk_nope_dim + m.qk_rope_dim
    latent = m.kv_lora_rank + m.qk_rope_dim
    q_full = q_full * torch.sqrt(
        torch.tensor(latent, dtype=torch.float32) / nominal).to(dt)
    q_r = q_full.transpose(2, 3)                         # (B, S, 1, H, latent)
    k_full = torch.cat([ckv_all, krope_all], dim=-1)[:, :, None, :]
    v_lat = torch.cat([ckv_all, torch.zeros_like(krope_all)],
                      dim=-1)[:, :, None, :]
    if cmesh is not None and decode:
        if mesh is not None:                             # every head's query
            q_r = autodiff.leave(mesh, q_r, MODEL, 3)
        o = _block_attention(q_r, k_full, v_lat, positions,
                             kv_pos, cache, cmesh, window=window,
                             prefix_len=prefix_len, own=mesh is not None)
        if mesh is not None:                             # (B, S, 1, H, .)
            o = o.transpose(2, 3)
    else:
        o = flash_attention(q_r, k_full, v_lat, positions, kv_pos,
                            window=window, prefix_len=prefix_len)
    o_latent = o[:, :, 0, :, :m.kv_lora_rank]            # (B, S, H, kv_lora)
    wv_b = params["wv_b"].to(dt).reshape(m.kv_lora_rank, H, m.v_head_dim)
    out = torch.einsum("bshr,rhv->bshv", o_latent, wv_b).reshape(
        B, S, H * m.v_head_dim)
    if mesh is not None:
        return autodiff.row_parallel(out, params["wo"].to(dt), mesh,
                                     MODEL), cache
    return out @ params["wo"].to(dt), cache
