"""The decoder stack (counterpart of ``repro.models.transformer``) with
every block kind of the JAX package:

  attn        — softmax attention (GQA or MLA per cfg) + dense MLP
  attn_local  — sliding-window attention + dense MLP
  moe         — attention + mixture-of-experts FFN (``moe_local``: windowed)
  hymba       — parallel windowed GQA + mamba heads, ``0.5 (β0 a + β1 m)``,
                + MLP (``hymba_g``: global attention)
  mlstm/slstm — xLSTM cells (an MLP after them only when d_ff != 0)

The JAX package scans stacked groups of a repeating ``layer_unit``; here
the parameters and caches are plain per-layer lists in
``cfg.all_layers()`` order (prefix layers, then the unit repeated
``num_groups`` times, then suffix layers), run by a Python loop.
``repro_torch.interop`` maps the JAX package's stacked trees onto them.

The modality frontends are stubs, as in the JAX package: ``audio_stub``
takes precomputed frame embeddings (``batch["embeds"]``), ``vision_stub``
precomputed patch embeddings put before the text tokens, read
bidirectionally (prefix-LM, ``prefix_len = vision_prefix``).

Entry points: ``forward`` (hidden states, optionally writing a cache and
returning the aux channel), ``logits_head``, ``prefill`` (last-position
logits), ``decode_step`` and ``loss_fn`` (the training loss: the
sequence-chunked next-token CE with its z-loss, the MoE aux term and
DeepSeek's multi-token-prediction term).

Rematerialization (``remat``): "none" keeps every layer's activations
for the backward; "full" runs each layer under ``torch.utils.checkpoint``
(non-reentrant), so the backward recomputes it.  The JAX package's
"dots" is an XLA saving policy (keep the matmul outputs) with no
counterpart in eager PyTorch; it takes the "full" path.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (embed_specs, mlp, mlp_specs, rms_norm,
                                       rms_norm_spec)
from repro_torch.models.params import ParamSpec, tree_map

REMATS = ("none", "full", "dots")
ATTN_KINDS = ("attn", "attn_local", "moe", "moe_local")
HYMBA_KINDS = ("hymba", "hymba_g")
XLSTM_KINDS = ("mlstm", "slstm")


def as_dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


# ------------------------------------------------------------------ specs --


def _block_specs(cfg: ModelConfig, kind: str) -> Dict:
    D = cfg.d_model
    p: Dict = dict(norm1=rms_norm_spec(D))
    if kind in ATTN_KINDS:
        p["attn"] = (attn.mla_specs(cfg) if cfg.attention == "mla"
                     else attn.gqa_specs(cfg))
        p["norm2"] = rms_norm_spec(D)
        if kind.startswith("moe"):
            p["moe"] = moe_mod.moe_specs(cfg)
        else:
            p["mlp"] = mlp_specs(D, cfg.d_ff_dense or cfg.d_ff)
    elif kind in HYMBA_KINDS:
        p["attn"] = attn.gqa_specs(cfg)
        p["mamba"] = ssm.mamba_specs(cfg)
        p["beta"] = ParamSpec((2,), init="ones")
        p["norm2"] = rms_norm_spec(D)
        p["mlp"] = mlp_specs(D, cfg.d_ff)
    elif kind == "mlstm":
        p["cell"] = ssm.mlstm_specs(cfg)
    elif kind == "slstm":
        p["cell"] = ssm.slstm_specs(cfg)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    if cfg.d_ff and kind in XLSTM_KINDS:
        p["norm2"] = rms_norm_spec(D)
        p["mlp"] = mlp_specs(D, cfg.d_ff)
    return p


def model_specs(cfg: ModelConfig) -> Dict:
    """``{embed, final_norm, layers: [block specs per layer][, lm_head]
    [, mtp]}``."""
    cfg.validate()
    p: Dict = dict(embed=embed_specs(cfg.vocab_size, cfg.d_model),
                   final_norm=rms_norm_spec(cfg.d_model),
                   layers=[_block_specs(cfg, k) for k in cfg.all_layers()])
    if not cfg.tie_embeddings:
        p["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size))
    if cfg.mtp:
        p["mtp"] = dict(block=_block_specs(cfg, "attn"),
                        proj=ParamSpec((2 * cfg.d_model, cfg.d_model)),
                        norm=rms_norm_spec(cfg.d_model))
    if cfg.param_dtype != "float32":
        p = tree_map(lambda s: ParamSpec(s.shape, s.init, s.scale,
                                         cfg.param_dtype), p)
    return p


# ------------------------------------------------------------------ cache --


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype, device="cuda") -> Dict:
    """The layer's cache: ``kv`` (attention), ``ssm`` (hymba's mamba
    state) or ``state`` (xLSTM); recurrent states are f32."""
    dev = resolve_device(device)
    dt = as_dtype(dtype)
    window = cfg.sliding_window if kind in ("attn_local", "hymba") else 0
    if kind in ATTN_KINDS:
        if cfg.attention == "mla":
            return dict(kv=attn.init_mla_cache(cfg, batch, max_len, dt, dev))
        return dict(kv=attn.init_gqa_cache(cfg, batch, max_len, window, dt,
                                           dev))
    if kind in HYMBA_KINDS:
        return dict(kv=attn.init_gqa_cache(cfg, batch, max_len, window, dt,
                                           dev),
                    ssm=ssm.mamba_init_state(cfg, batch, device=dev))
    if kind == "mlstm":
        return dict(state=ssm.mlstm_init_state(cfg, batch, device=dev))
    if kind == "slstm":
        return dict(state=ssm.slstm_init_state(cfg, batch, device=dev))
    raise ValueError(f"unknown block kind {kind!r}")


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> List[Dict]:
    """One cache dict per layer, in ``cfg.all_layers()`` order."""
    return [init_block_cache(cfg, k, batch, max_len, dtype, device)
            for k in cfg.all_layers()]


def _store(dst, new) -> None:
    """Write a new recurrent state into the cache's tensors in place."""
    if isinstance(dst, dict):
        for k in dst:
            dst[k].copy_(new[k])
    else:
        dst.copy_(new)


# ------------------------------------------------------------------ block --


def zero_aux(cfg: ModelConfig, collect_router_stats: bool = False,
             device="cuda"):
    """The aux channel's zero: a scalar, or (scalar, RouterStats) when
    routing statistics are collected."""
    if collect_router_stats and cfg.moe is None:
        raise ValueError("collect_router_stats needs a MoE config")
    device = resolve_device(device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    if collect_router_stats:
        return (zero, moe_mod.zero_router_stats(cfg.moe.num_experts, device))
    return zero


def _aux_add(a, b):
    if b is None:                    # a block without a router
        return a
    if isinstance(a, tuple):
        return (a[0] + b[0],
                moe_mod.RouterStats(*(x + y for x, y in zip(a[1], b[1]))))
    return a + b


def apply_block(params: Dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[Dict], *,
                prefix_len: int = 0, decode: bool = False,
                collect_router_stats: bool = False):
    """One block; returns ``(x_out, aux)`` and updates the cache, if any,
    in place.  A MoE block's aux is its router loss, or ``(loss,
    RouterStats)`` with ``collect_router_stats``; other blocks add none
    (``None``: no device work where nothing is routed)."""
    dt = x.dtype
    aux = None
    window = cfg.sliding_window if kind in ("attn_local", "moe_local",
                                            "hymba") else 0

    if kind in ATTN_KINDS:
        h = rms_norm(x, params["norm1"], cfg.norm_eps)
        fn = (attn.mla_attention if cfg.attention == "mla"
              else attn.gqa_attention)
        a, _ = fn(params["attn"], cfg, h, positions, window=window,
                  prefix_len=prefix_len,
                  cache=None if cache is None else cache["kv"])
        x = x + a
        h = rms_norm(x, params["norm2"], cfg.norm_eps)
        if kind.startswith("moe"):
            out = moe_mod.moe_ffn(params["moe"], cfg, h,
                                  collect_stats=collect_router_stats)
            f, aux = out[0], (out[1:] if collect_router_stats else out[1])
        else:
            f = mlp(params["mlp"], h, dt)
        return x + f, aux

    if kind in HYMBA_KINDS:
        h = rms_norm(x, params["norm1"], cfg.norm_eps)
        a, _ = attn.gqa_attention(
            params["attn"], cfg, h, positions, window=window,
            prefix_len=prefix_len,
            cache=None if cache is None else cache["kv"])
        state = None if cache is None else cache["ssm"]
        if decode:
            m, s_new = ssm.mamba_step(params["mamba"], cfg, h, state)
        else:
            m, s_new = ssm.mamba_forward(params["mamba"], cfg, h, state)
        if cache is not None:
            _store(cache["ssm"], s_new)
        beta = params["beta"].to(dt)
        x = x + 0.5 * (beta[0] * a + beta[1] * m)
        h = rms_norm(x, params["norm2"], cfg.norm_eps)
        return x + mlp(params["mlp"], h, dt), aux

    if kind in XLSTM_KINDS:
        h = rms_norm(x, params["norm1"], cfg.norm_eps)
        state = None if cache is None else cache["state"]
        if kind == "mlstm":
            fn = ssm.mlstm_step if decode else ssm.mlstm_forward
        else:
            fn = ssm.slstm_step if decode else ssm.slstm_forward
        y, s_new = fn(params["cell"], cfg, h, state)
        if cache is not None:
            _store(cache["state"], s_new)
        x = x + y
        if cfg.d_ff:
            h = rms_norm(x, params["norm2"], cfg.norm_eps)
            x = x + mlp(params["mlp"], h, dt)
        return x, aux

    raise ValueError(f"unknown block kind {kind!r}")


# ---------------------------------------------------------------- forward --


def _embed_inputs(params, cfg: ModelConfig, batch: Dict) -> torch.Tensor:
    """Precomputed frontend ``embeds`` (if any), then the tokens'
    embeddings, along the sequence; the gemma scale on both."""
    dt = as_dtype(cfg.compute_dtype)
    parts = []
    if batch.get("embeds") is not None:
        parts.append(batch["embeds"].to(dt))
    if batch.get("tokens") is not None:
        # gather, then cast: the same values as casting the whole table
        parts.append(params["embed"][batch["tokens"].long()].to(dt))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model),
                             dtype=torch.float32).to(dt)
    return x


def forward(params: Dict, cfg: ModelConfig, batch: Dict, *,
            cache: Optional[List[Dict]] = None, decode: bool = False,
            collect_router_stats: bool = False, with_aux: bool = False,
            remat: str = "none"):
    """Run the stack on ``batch = {tokens (B, S) and/or embeds (B, S', D),
    positions (B, S)}``; returns ``(hidden (B, S, D), cache)``, the cache
    updated in place, or ``(hidden, cache, aux)`` with ``with_aux`` (aux
    summed over the layers; ``(aux, RouterStats)`` with
    ``collect_router_stats``).  ``decode`` takes the recurrent blocks'
    single-step forms (one token a row).  ``remat`` "full" (or "dots")
    checkpoints each layer where grad is enabled and there is no cache."""
    if remat not in REMATS:
        raise ValueError(f"unknown remat {remat!r}; one of {REMATS}")
    x = _embed_inputs(params, cfg, batch)
    positions = batch["positions"]
    prefix_len = cfg.vision_prefix if cfg.prefix_lm else 0
    aux_total = (zero_aux(cfg, collect_router_stats, x.device)
                 if with_aux or collect_router_stats else None)
    recompute = (remat != "none" and cache is None
                 and torch.is_grad_enabled())
    for i, kind in enumerate(cfg.all_layers()):
        kw = dict(prefix_len=prefix_len, decode=decode,
                  collect_router_stats=collect_router_stats)
        if recompute:
            x, aux = checkpoint(apply_block, params["layers"][i], cfg, kind,
                                x, positions, None, use_reentrant=False,
                                **kw)
        else:
            x, aux = apply_block(params["layers"][i], cfg, kind, x,
                                 positions,
                                 None if cache is None else cache[i], **kw)
        if aux_total is not None:
            aux_total = _aux_add(aux_total, aux)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if with_aux:
        return h, cache, aux_total
    return h, cache


def logits_head(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    dt = h.dtype
    w = (params["embed"].to(dt).T if cfg.tie_embeddings
         else params["lm_head"].to(dt))
    return h @ w


# ------------------------------------------------------------------- loss --


def _ce_terms(logits: torch.Tensor, labels: torch.Tensor, dt):
    """Per-position ``(nll, lse^2, valid)`` of f32 logits (..., V) against
    labels (-1 = masked).  The label logit is read from the logits cast
    to the compute type ``dt``, as the JAX einsum against a ``dt`` one-hot
    reads it."""
    m = logits.amax(dim=-1)
    lse = m + torch.log(torch.sum(torch.exp(logits - m[..., None]), dim=-1))
    label_logit = logits.to(dt).gather(
        -1, labels.clamp(min=0).long()[..., None])[..., 0].to(torch.float32)
    valid = labels >= 0
    zero = torch.zeros((), dtype=torch.float32, device=logits.device)
    return (torch.where(valid, lse - label_logit, zero),
            torch.where(valid, lse * lse, zero), valid)


def _chunk_ce(hx: torch.Tensor, lx: torch.Tensor, w: torch.Tensor):
    """One sequence chunk's summed nll and z terms: logits (B, c, V) in
    f32 from the compute-type product."""
    nll, zl, _ = _ce_terms((hx @ w).to(torch.float32), lx, hx.dtype)
    return nll.sum(), zl.sum()


def loss_fn(params: Dict, cfg: ModelConfig, batch: Dict, *,
            remat: str = "none", seq_chunk: int = 512,
            z_weight: float = 1e-4, collect_router_stats: bool = False
            ) -> Tuple[torch.Tensor, Dict]:
    """Next-token CE; ``batch["labels"]`` is (B, S) with -1 = masked.

    The head runs in sequence chunks of ``seq_chunk``, each under
    ``torch.utils.checkpoint`` (its backward recomputes the chunk's
    logits), so no (B, S, V) tensor is kept.  ``loss = ce + z_weight ·
    mean(lse²)``, plus ``router_aux_weight · aux`` for a MoE config and
    ``0.3 · mtp`` for an MTP config.  Returns ``(loss, metrics)`` with
    ``ce``, ``aux``, ``tokens`` and ``mtp``, and with
    ``collect_router_stats`` the detached ``router_counts`` (E,) and
    ``router_coact`` (E, E)."""
    h, _, aux = forward(params, cfg, batch, with_aux=True, remat=remat,
                        collect_router_stats=collect_router_stats)
    rstats = None
    if collect_router_stats:
        aux, rstats = aux
        rstats = moe_mod.RouterStats(*(t.detach() for t in rstats))
    labels = batch["labels"]
    B, S = labels.shape
    dt = h.dtype
    w = (params["embed"].to(dt).T if cfg.tie_embeddings
         else params["lm_head"].to(dt))
    c = min(seq_chunk, S)
    Sp = -(-S // c) * c
    hp, lp = h, labels
    if Sp != S:
        hp = torch.nn.functional.pad(h, (0, 0, 0, Sp - S))
        lp = torch.nn.functional.pad(labels, (0, Sp - S), value=-1)
    f32 = torch.float32
    tot = torch.zeros((), dtype=f32, device=h.device)
    ztot = torch.zeros((), dtype=f32, device=h.device)
    for i in range(0, Sp, c):
        hx, lx = hp[:, i:i + c], lp[:, i:i + c]
        if torch.is_grad_enabled():
            nll, zl = checkpoint(_chunk_ce, hx, lx, w, use_reentrant=False)
        else:
            nll, zl = _chunk_ce(hx, lx, w)
        tot = tot + nll
        ztot = ztot + zl
    cnt = (labels >= 0).sum().to(torch.int32)
    denom = torch.clamp(cnt, min=1).to(f32)
    ce = tot / denom
    loss = ce + z_weight * ztot / denom
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux
    mtp = torch.zeros((), dtype=f32, device=h.device)
    if cfg.mtp and batch.get("tokens") is not None:
        mtp = _mtp_loss(params, cfg, batch, h[:, :S])
        loss = loss + 0.3 * mtp
    metrics = dict(ce=ce, aux=aux, tokens=cnt, mtp=mtp)
    if rstats is not None:
        metrics["router_counts"] = rstats.counts
        metrics["router_coact"] = rstats.coact
    return loss, metrics


def _mtp_loss(params: Dict, cfg: ModelConfig, batch: Dict,
              h: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3 multi-token prediction: one extra attention block
    predicting t+2 from ``[norm(h_t) ; emb(token_{t+1})]``, sharing the
    embedding and the head; the mean CE over valid positions."""
    dt = h.dtype
    tokens, labels = batch["tokens"], batch["labels"]
    nxt = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    lbl2 = torch.cat([labels[:, 1:], torch.full_like(labels[:, -1:], -1)],
                     dim=1)
    e = params["embed"][nxt.long()].to(dt)
    hm = rms_norm(h, params["mtp"]["norm"], cfg.norm_eps)
    x = torch.cat([hm, e], dim=-1) @ params["mtp"]["proj"].to(dt)
    x, _ = apply_block(params["mtp"]["block"], cfg, "attn", x,
                       batch["positions"], None)
    logits = logits_head(params, cfg, x).to(torch.float32)
    nll, _, valid = _ce_terms(logits, lbl2, dt)
    return nll.sum() / torch.clamp(valid.sum(), min=1).to(torch.float32)


# ------------------------------------------------------------ decode step --


def prefill(params, cfg: ModelConfig, batch: Dict, cache: List[Dict]):
    """Full-sequence forward writing the cache; returns last-position
    logits (B, 1, V) and the cache."""
    h, cache = forward(params, cfg, batch, cache=cache)
    return logits_head(params, cfg, h[:, -1:]), cache


def decode_step(params, cfg: ModelConfig, tokens: Optional[torch.Tensor],
                index: int, cache: List[Dict],
                embeds: Optional[torch.Tensor] = None):
    """One decode step: tokens (B, 1) (or frontend ``embeds`` (B, 1, D))
    at position ``index``."""
    src = tokens if tokens is not None else embeds
    positions = torch.full((src.shape[0], 1), int(index), dtype=torch.int32,
                           device=src.device)
    h, cache = forward(params, cfg, dict(tokens=tokens, embeds=embeds,
                                         positions=positions),
                       cache=cache, decode=True)
    return logits_head(params, cfg, h), cache
