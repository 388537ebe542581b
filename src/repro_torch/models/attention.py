"""GQA attention (full / sliding-window / prefix-LM), counterpart of the
GQA half of ``repro.models.attention``.

Every call, prefill and decode alike, goes through
``kernels.flash_attention.ops.flash_attention``: the hand-written kernel
for CUDA tensors, the plain chunked attention (the JAX package's
``chunked_attention``) for CPU tensors.  KV caches carry an explicit
per-slot position array (``pos``, initialized to ``POS_SENTINEL``), so
full caches and ring-buffer sliding-window caches share one code path.

Left for a later slice: MLA (``mla_specs`` / ``init_mla_cache`` /
``mla_attention``) and the tensor-parallel head-repeat branch, which
needs a device mesh.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import POS_SENTINEL
from repro_torch.kernels.flash_attention.ref import mask as _mask  # noqa: F401
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope
from repro_torch.models.params import ParamSpec


def gqa_specs(cfg: ModelConfig) -> Dict:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    p = dict(wq=ParamSpec((D, H * hd)), wk=ParamSpec((D, KV * hd)),
             wv=ParamSpec((D, KV * hd)), wo=ParamSpec((H * hd, D)))
    if cfg.qkv_bias:
        p.update(bq=ParamSpec((H * hd,), init="zeros"),
                 bk=ParamSpec((KV * hd,), init="zeros"),
                 bv=ParamSpec((KV * hd,), init="zeros"))
    return p


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


def gqa_attention(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, *, window: int = 0,
                  prefix_len: int = 0, cache: Optional[Dict] = None
                  ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B, S, D), positions (B, S) → (y (B, S, D), cache).

    With a cache, the new keys and values are written at slot
    ``positions mod T`` (window layers) or ``positions`` *in place* — the
    returned cache is the one given — and attention reads the whole
    cache.  A window layer's prefill is defined for prompts up to T:
    longer ones would write several positions into one slot at once."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    G = H // KV
    dt = x.dtype
    q = x @ params["wq"].to(dt)
    k = x @ params["wk"].to(dt)
    v = x @ params["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    q = apply_rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta)
    q = q.reshape(B, S, KV, G, hd)
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

    out = flash_attention(q, k, v, positions, kv_pos, window=window,
                          prefix_len=prefix_len)
    y = out.reshape(B, S, H * hd) @ params["wo"].to(dt)
    return y, cache
