"""The decoder stack (counterpart of ``repro.models.transformer``) for the
block kinds the serving slice runs: ``attn`` (GQA + dense MLP) and
``attn_local`` (sliding-window GQA + dense MLP).

The JAX package scans stacked groups of a repeating ``layer_unit``; here
the parameters and caches are plain per-layer lists in
``cfg.all_layers()`` order (prefix layers, then the unit repeated
``num_groups`` times, then suffix layers), run by a Python loop.
``repro_torch.interop`` maps the JAX package's stacked trees onto them.

Entry points: ``forward`` (hidden states, optionally writing a cache),
``logits_head``, ``prefill`` (last-position logits) and ``decode_step``.
MoE, MLA, hymba and xLSTM blocks, the multi-token-prediction head and
``loss_fn`` belong to later slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (embed_specs, mlp, mlp_specs, rms_norm,
                                       rms_norm_spec)
from repro_torch.models.params import ParamSpec, tree_map

PORTED_KINDS = ("attn", "attn_local")


def _later_slice(what: str):
    return NotImplementedError(
        f"{what} is not ported yet: the PyTorch port runs the attn / "
        "attn_local (GQA) blocks; MoE, MLA, hymba, xLSTM, the MTP head and "
        "training belong to later slices")


def as_dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _check(cfg: ModelConfig, kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise _later_slice(f"block kind {kind!r}")
    if cfg.attention != "gqa":
        raise _later_slice(f"attention {cfg.attention!r}")


# ------------------------------------------------------------------ specs --


def _block_specs(cfg: ModelConfig, kind: str) -> Dict:
    _check(cfg, kind)
    D = cfg.d_model
    return dict(norm1=rms_norm_spec(D), attn=attn.gqa_specs(cfg),
                norm2=rms_norm_spec(D),
                mlp=mlp_specs(D, cfg.d_ff_dense or cfg.d_ff))


def model_specs(cfg: ModelConfig) -> Dict:
    """``{embed, final_norm, layers: [block specs per layer][, lm_head]}``."""
    cfg.validate()
    if cfg.mtp:
        raise _later_slice("the multi-token-prediction head")
    p: Dict = dict(embed=embed_specs(cfg.vocab_size, cfg.d_model),
                   final_norm=rms_norm_spec(cfg.d_model),
                   layers=[_block_specs(cfg, k) for k in cfg.all_layers()])
    if not cfg.tie_embeddings:
        p["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size))
    if cfg.param_dtype != "float32":
        p = tree_map(lambda s: ParamSpec(s.shape, s.init, s.scale,
                                         cfg.param_dtype), p)
    return p


# ------------------------------------------------------------------ cache --


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, device="cuda") -> Dict:
    _check(cfg, kind)
    window = cfg.sliding_window if kind == "attn_local" else 0
    return dict(kv=attn.init_gqa_cache(cfg, batch, max_len, window,
                                       as_dtype(dtype),
                                       resolve_device(device)))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> List[Dict]:
    """One cache dict per layer, in ``cfg.all_layers()`` order."""
    return [init_block_cache(cfg, k, batch, max_len, dtype, device)
            for k in cfg.all_layers()]


# ------------------------------------------------------------------ block --


def apply_block(params: Dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[Dict], *,
                prefix_len: int = 0) -> torch.Tensor:
    """Pre-norm attention + MLP block; the cache, if any, is updated in
    place."""
    _check(cfg, kind)
    window = cfg.sliding_window if kind == "attn_local" else 0
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    a, _ = attn.gqa_attention(
        params["attn"], cfg, h, positions, window=window,
        prefix_len=prefix_len, cache=None if cache is None else cache["kv"])
    x = x + a
    h = rms_norm(x, params["norm2"], cfg.norm_eps)
    return x + mlp(params["mlp"], h, x.dtype)


# ---------------------------------------------------------------- forward --


def _embed_inputs(params, cfg: ModelConfig, batch: Dict) -> torch.Tensor:
    dt = as_dtype(cfg.compute_dtype)
    # gather, then cast: the same values as casting the whole table
    x = params["embed"][batch["tokens"].long()].to(dt)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model),
                             dtype=torch.float32).to(dt)
    return x


def forward(params: Dict, cfg: ModelConfig, batch: Dict, *,
            cache: Optional[List[Dict]] = None
            ) -> Tuple[torch.Tensor, Optional[List[Dict]]]:
    """Run the stack on ``batch = {tokens (B, S), positions (B, S)}``;
    returns ``(hidden (B, S, D), cache)`` (the cache updated in place).
    The modality frontends' precomputed ``embeds`` belong to a later
    slice."""
    x = _embed_inputs(params, cfg, batch)
    positions = batch["positions"]
    prefix_len = cfg.vision_prefix if cfg.prefix_lm else 0
    for i, kind in enumerate(cfg.all_layers()):
        x = apply_block(params["layers"][i], cfg, kind, x, positions,
                        None if cache is None else cache[i],
                        prefix_len=prefix_len)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), cache


def logits_head(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    dt = h.dtype
    w = (params["embed"].to(dt).T if cfg.tie_embeddings
         else params["lm_head"].to(dt))
    return h @ w


def loss_fn(*args, **kwargs):
    raise _later_slice("loss_fn (training)")


# ------------------------------------------------------------ decode step --


def prefill(params, cfg: ModelConfig, batch: Dict, cache: List[Dict]):
    """Full-sequence forward writing the cache; returns last-position
    logits (B, 1, V) and the cache."""
    h, cache = forward(params, cfg, batch, cache=cache)
    return logits_head(params, cfg, h[:, -1:]), cache


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, index: int,
                cache: List[Dict]):
    """One decode step: tokens (B, 1) at position ``index``."""
    B = tokens.shape[0]
    positions = torch.full((B, 1), int(index), dtype=torch.int32,
                           device=tokens.device)
    h, cache = forward(params, cfg, dict(tokens=tokens, positions=positions),
                       cache=cache)
    return logits_head(params, cfg, h), cache
