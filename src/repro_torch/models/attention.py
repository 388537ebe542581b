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
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed import autodiff, sharding
from repro_torch.kernels import resolve_device
from repro_torch.kernels.flash_attention.ops import flash_attention
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


def gqa_attention(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, *, window: int = 0,
                  prefix_len: int = 0, cache: Optional[Dict] = None,
                  tp: Optional[str] = None
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
    ``wv``/``bk``/``bv`` whole (each rank uses its part of them), the
    cache whole.  None: the weights whole."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    G = H // KV
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

    if cache is not None:
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
                  tp: Optional[str] = None
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
    this rank's heads by ``autodiff.tp_in``."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    dt = x.dtype
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

    if cache is not None:
        slot = positions.long()
        bidx = torch.arange(B, device=x.device)[:, None]
        cache["ckv"][bidx, slot] = ckv.to(cache["ckv"].dtype)
        cache["krope"][bidx, slot] = k_rope.to(cache["krope"].dtype)
        cache["pos"][bidx, slot] = positions.to(torch.int32)
        ckv_all, krope_all, kv_pos = cache["ckv"], cache["krope"], cache["pos"]
    else:
        ckv_all, krope_all, kv_pos = ckv, k_rope, positions
    if mesh is not None:
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
