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

Over an ambient ``ProcessMesh`` (``distributed.sharding.use_mesh``, as
the sharded train step sets it) the parameters are this rank's blocks
under the JAX rules, and each layer and the vocabulary compute as
``sharding.tp_plan`` says: tensor parallel over ``"model"`` (heads,
``d_ff`` columns, vocabulary rows; the CE vocabulary parallel) or
gathered before use (``sharding.gathered``; FSDP's ``"data"`` blocks).

Serving over ranks: under an ambient ``ProcessMesh`` the cache paths
(``forward`` with a cache, ``prefill``, ``decode_step``) take the JAX
rules' "2d" profile where the config says "dp" (:func:`serving_config`,
as the JAX forward switches it: the KV cache needs its length split over
``"model"``), so their parameters are placed under it
(:func:`serving_layout`).  The cache is
this rank's blocks (:func:`init_cache` with ``mesh``:
``sharding.cache_placements``, batch over the batch axes, dim 1 — slots
or recurrent-state heads — over ``"model"``); attention reads it as
``models.attention`` says (K6's partials merged over ``"model"`` at
decode), the recurrent cells gather their states for the step and keep
their block after, and the logits come back whole (every row, every
vocabulary block), as the JAX package's ``out_shardings=None`` returns
them.

Rematerialization (``remat``): "none" keeps every layer's activations
for the backward; "full" runs each layer under ``torch.utils.checkpoint``
(non-reentrant), so the backward recomputes it.  The JAX package's
"dots" is an XLA saving policy (keep the matmul outputs) with no
counterpart in eager PyTorch; it takes the "full" path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import autodiff, sharding
from repro_torch.distributed.mesh import ProcessMesh
from repro_torch.kernels import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (MODEL, embed_specs, mlp, mlp_specs,
                                       rms_norm, rms_norm_spec)
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
        p["beta"] = ParamSpec((2,), (None,), init="ones")
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


def _lm_head_spec(cfg: ModelConfig) -> ParamSpec:
    return ParamSpec((cfg.d_model, cfg.vocab_size), ("data", MODEL))


def _mtp_proj_spec(cfg: ModelConfig) -> ParamSpec:
    return ParamSpec((2 * cfg.d_model, cfg.d_model), ("data", None))


def model_specs(cfg: ModelConfig) -> Dict:
    """``{embed, final_norm, layers: [block specs per layer][, lm_head]
    [, mtp]}``."""
    cfg.validate()
    p: Dict = dict(embed=embed_specs(cfg.vocab_size, cfg.d_model),
                   final_norm=rms_norm_spec(cfg.d_model),
                   layers=[_block_specs(cfg, k) for k in cfg.all_layers()])
    if not cfg.tie_embeddings:
        p["lm_head"] = _lm_head_spec(cfg)
    if cfg.mtp:
        p["mtp"] = dict(block=_block_specs(cfg, "attn"),
                        proj=_mtp_proj_spec(cfg),
                        norm=rms_norm_spec(cfg.d_model))
    if cfg.param_dtype != "float32":
        p = tree_map(lambda s: dataclasses.replace(s, dtype=cfg.param_dtype),
                     p)
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
               dtype=torch.bfloat16, device="cuda", mesh=None) -> List[Dict]:
    """One cache dict per layer, in ``cfg.all_layers()`` order.

    Over a ``ProcessMesh`` (``mesh``) only this rank's blocks under
    ``sharding.cache_placements`` (the counterpart of
    ``params.init_block``): ``batch`` is the global batch, each leaf is
    allocated at its block's shape, and no whole cache is made.  Every
    layer's slots must divide over ``"model"`` (each rank a block of
    them)."""
    if mesh is None:
        return [init_block_cache(cfg, k, batch, max_len, dtype, device)
                for k in cfg.all_layers()]
    dev = resolve_device(device)
    whole, place = cache_layout(cfg, batch, max_len, mesh, dtype)
    M = mesh.axes.get(MODEL, 1)
    for layer, p in zip(whole, place):
        if "kv" in layer and M > 1 and p["kv"]["pos"][1] != MODEL:
            raise ValueError(
                f"a cache of {layer['kv']['pos'].shape[1]} slots does not "
                f"divide over the {M} ranks of {MODEL!r}")
    # every leaf is one value throughout: a one-row, one-slot cache's
    one = init_cache(cfg, 1, 1, dtype, "cpu")

    def block(t, p, v):
        shape = tuple(s.stop - s.start
                      for s in sharding.block_slices(t.shape, p, mesh))
        return v.reshape(-1)[:1].to(dev).expand(shape).contiguous()

    return sharding.tree_map(block, whole, place, one)


def cache_layout(cfg: ModelConfig, batch: int, max_len: int, mesh,
                 dtype=torch.bfloat16):
    """``(whole, placements)``: the whole cache on the meta device (no
    storage) and its placements over ``mesh`` under the JAX rules
    (``sharding.cache_placements``, the cache paths' "2d" profile)."""
    whole = init_cache(cfg, batch, max_len, dtype, "meta")
    return whole, sharding.cache_placements(whole, mesh, "2d")


def _store(dst, new) -> None:
    """Write a new recurrent state into the cache's tensors in place."""
    if isinstance(dst, dict):
        for k in dst:
            dst[k].copy_(new[k])
    else:
        dst.copy_(new)


def _state(cache, key: str, cfg: ModelConfig, mesh):
    """The layer's recurrent state for its step: whole (over a
    ``ProcessMesh`` its head blocks gathered, ``ssm.gathered_state``)."""
    if cache is None:
        return None
    if mesh is None:
        return cache[key]
    return ssm.gathered_state(cache[key], mesh, cfg.num_heads)


def _store_state(cache, key: str, new, mesh) -> None:
    """Write the step's new state into the cache in place (over a
    ``ProcessMesh`` this rank's head block of it)."""
    if mesh is not None:
        new = ssm.state_block(new, cache[key], mesh)
    _store(cache[key], new)


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


#: the head-repeat branch's leaves each rank uses a part of
REPEAT_PARTIAL = ("wk", "wv", "bk", "bv")


def _rank_layer(params: Dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                cache: Optional[Dict], mesh: ProcessMesh):
    """One layer's blocks on this rank as its compute uses them, and the
    layer's plan (``sharding.tp_plan``; the head-repeat branch only for
    keys no longer than ``attention.REPEAT_MAX_KV``, as the JAX gate):
    each part's leaves gathered over their axes (``sharding.gathered``)
    but ``"model"`` where the part runs tensor parallel; the MoE part as
    the a2a takes it (``models.moe``)."""
    plan = sharding.tp_plan(cfg, mesh)[kind]
    if plan.get("attn") == "repeat":
        # a cache is this rank's block of slots over "model"
        T_kv = x.shape[1] if cache is None else (
            cache["kv"]["pos"].shape[1] * mesh.axes.get(MODEL, 1))
        if T_kv > attn.REPEAT_MAX_KV:
            plan["attn"] = "gather"
    specs = _block_specs(cfg, kind)
    out = dict(params)
    for part, mode in plan.items():
        if part not in params:          # the shared expert: in "moe"
            continue
        partial = REPEAT_PARTIAL if mode == "repeat" else ()
        keep = (MODEL,) if mode in ("tp", "repeat") else ()
        out[part] = {k: sharding.gathered(
            v, specs[part][k], mesh, cfg.sharding_profile,
            keep=() if k in partial else keep, partial=k in partial)
            for k, v in params[part].items()}
    return out, plan


def apply_block(params: Dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                positions: torch.Tensor, cache: Optional[Dict], *,
                prefix_len: int = 0, decode: bool = False,
                collect_router_stats: bool = False):
    """One block; returns ``(x_out, aux)`` and updates the cache, if any,
    in place.  A MoE block's aux is its router loss, or ``(loss,
    RouterStats)`` with ``collect_router_stats``; other blocks add none
    (``None``: no device work where nothing is routed).

    Under an ambient ``ProcessMesh`` (``sharding.use_mesh``) ``params``
    are this rank's blocks: the block runs as ``sharding.tp_plan`` says
    (:func:`_rank_layer`)."""
    dt = x.dtype
    aux = None
    window = cfg.sliding_window if kind in ("attn_local", "moe_local",
                                            "hymba") else 0
    mesh = sharding.rank_mesh()
    att_tp = mlp_mesh = None
    if mesh is not None:
        params, plan = _rank_layer(params, cfg, kind, x, cache, mesh)
        att_tp = plan.get("attn") if plan.get("attn") != "gather" else None
        mlp_mesh = mesh if plan.get("mlp") == "tp" else None

    if kind in ATTN_KINDS:
        h = rms_norm(x, params["norm1"], cfg.norm_eps)
        fn = (attn.mla_attention if cfg.attention == "mla"
              else attn.gqa_attention)
        a, _ = fn(params["attn"], cfg, h, positions, window=window,
                  prefix_len=prefix_len,
                  cache=None if cache is None else cache["kv"], tp=att_tp,
                  decode=decode)
        x = x + a
        h = rms_norm(x, params["norm2"], cfg.norm_eps)
        if kind.startswith("moe"):
            out = moe_mod.moe_ffn(params["moe"], cfg, h,
                                  collect_stats=collect_router_stats)
            f, aux = out[0], (out[1:] if collect_router_stats else out[1])
        else:
            f = mlp(params["mlp"], h, dt, mlp_mesh)
        return x + f, aux

    if kind in HYMBA_KINDS:
        h = rms_norm(x, params["norm1"], cfg.norm_eps)
        a, _ = attn.gqa_attention(
            params["attn"], cfg, h, positions, window=window,
            prefix_len=prefix_len,
            cache=None if cache is None else cache["kv"], tp=att_tp,
            decode=decode)
        state = _state(cache, "ssm", cfg, mesh)
        if decode:
            m, s_new = ssm.mamba_step(params["mamba"], cfg, h, state)
        else:
            m, s_new = ssm.mamba_forward(params["mamba"], cfg, h, state)
        if cache is not None:
            _store_state(cache, "ssm", s_new, mesh)
        beta = params["beta"].to(dt)
        x = x + 0.5 * (beta[0] * a + beta[1] * m)
        h = rms_norm(x, params["norm2"], cfg.norm_eps)
        return x + mlp(params["mlp"], h, dt, mlp_mesh), aux

    if kind in XLSTM_KINDS:
        h = rms_norm(x, params["norm1"], cfg.norm_eps)
        state = _state(cache, "state", cfg, mesh)
        if kind == "mlstm":
            fn = ssm.mlstm_step if decode else ssm.mlstm_forward
        else:
            fn = ssm.slstm_step if decode else ssm.slstm_forward
        y, s_new = fn(params["cell"], cfg, h, state)
        if cache is not None:
            _store_state(cache, "state", s_new, mesh)
        x = x + y
        if cfg.d_ff:
            h = rms_norm(x, params["norm2"], cfg.norm_eps)
            x = x + mlp(params["mlp"], h, dt, mlp_mesh)
        return x, aux

    raise ValueError(f"unknown block kind {kind!r}")


# ---------------------------------------------------------------- forward --


def _vocab_params(params: Dict, cfg: ModelConfig):
    """``(params, mesh)``: under an ambient ``ProcessMesh`` the embedding
    (and an untied head) with their ``"data"`` blocks gathered, and the
    mesh where the vocabulary runs tensor parallel over ``"model"`` (each
    rank its block of the rows; ``sharding.tp_plan``), else None; whole
    trees as they are."""
    mesh = sharding.rank_mesh()
    if mesh is None:
        return params, None
    tp = sharding.tp_plan(cfg, mesh)["embed"]["vocab"] == "tp"
    keep = (MODEL,) if tp else ()
    out = dict(params)
    out["embed"] = sharding.gathered(
        params["embed"], embed_specs(cfg.vocab_size, cfg.d_model), mesh,
        cfg.sharding_profile, keep=keep)
    if "lm_head" in params:
        out["lm_head"] = sharding.gathered(
            params["lm_head"], _lm_head_spec(cfg), mesh,
            cfg.sharding_profile, keep=keep)
    return out, mesh if tp else None


def _lookup(embed: torch.Tensor, tokens: torch.Tensor, dt,
            mesh: Optional[ProcessMesh] = None) -> torch.Tensor:
    """The tokens' embedding rows, gathered, then cast (the same values as
    casting the whole table).  ``mesh``: ``embed`` is this rank's block
    of the vocabulary over ``"model"``; ids outside it give zeros and
    the blocks' rows are added over ``"model"`` (one of them nonzero:
    exact)."""
    if mesh is None:
        return embed[tokens.long()].to(dt)
    Vl = embed.shape[0]
    loc = tokens.long() - mesh.group_rank(MODEL, mesh.rank) * Vl
    own = (loc >= 0) & (loc < Vl)
    e = embed[loc.clamp(0, Vl - 1)].to(dt)
    e = torch.where(own[..., None], e, torch.zeros((), dtype=dt,
                                                   device=e.device))
    return autodiff.tp_out(e, mesh, MODEL)


def _embed_inputs(params, cfg: ModelConfig, batch: Dict) -> torch.Tensor:
    """Precomputed frontend ``embeds`` (if any), then the tokens'
    embeddings, along the sequence; the gemma scale on both."""
    dt = as_dtype(cfg.compute_dtype)
    params, vmesh = _vocab_params(params, cfg)
    parts = []
    if batch.get("embeds") is not None:
        parts.append(batch["embeds"].to(dt))
    if batch.get("tokens") is not None:
        parts.append(_lookup(params["embed"], batch["tokens"], dt, vmesh))
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
    if decode or cache is not None:
        cfg = serving_config(cfg)
    positions = batch["positions"]
    if cache is not None and not decode and sharding.rank_mesh() is not None:
        _prompt_from_zero(positions)
    x = _embed_inputs(params, cfg, batch)
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


def serving_config(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` as its cache paths run it: the "2d" profile where it says
    "dp" (the JAX forward's switch on ``decode`` or a cache, and the JAX
    dry run's on its prefill and decode cells), else ``cfg`` itself."""
    if cfg.sharding_profile == "dp":
        return dataclasses.replace(cfg, sharding_profile="2d")
    return cfg


def serving_layout(cfg: ModelConfig, mesh):
    """``(cfg, specs, placements)`` of a model served over ``mesh``: the
    config as its cache paths run it (:func:`serving_config`), its
    parameter specs and their placements (``sharding.train_placements``;
    this rank's blocks: ``params.init_blocks(specs, seed, placements,
    mesh)``)."""
    cfg = serving_config(cfg)
    specs = model_specs(cfg)
    return cfg, specs, sharding.train_placements(specs, mesh, cfg)


def _prompt_from_zero(positions: torch.Tensor) -> None:
    """A prefill over ranks stores the prompt's keys and attends over
    them alone: every row must start at position 0 (a cache holding
    nothing the prompt does not overwrite).  Raises otherwise (a traced
    call, whose positions have no values, is not checked)."""
    from torch._subclasses.fake_tensor import is_fake

    if is_fake(positions):
        return
    if int(positions.amin()) != 0:
        raise NotImplementedError(
            "prefill over a ProcessMesh into a non-empty cache: the prompt "
            "must start at position 0 (decode steps extend the cache)")


def _head(params, cfg: ModelConfig, dt) -> torch.Tensor:
    """The head's (D, V) weight in ``dt``: the tied embedding's transpose
    or ``lm_head`` (a rank's vocabulary block of either)."""
    return (params["embed"].to(dt).T if cfg.tie_embeddings
            else params["lm_head"].to(dt))


def logits_head(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """``h @ head`` in h's type.  Under an ambient ``ProcessMesh`` (the
    parameters this rank's blocks, ``h`` its rows) the logits of every
    row and the whole vocabulary, as the JAX package's
    ``out_shardings=None`` returns them: each rank's vocabulary block
    where the head runs tensor parallel, gathered over ``"model"``, then
    the rows gathered over the batch axes."""
    mesh = sharding.rank_mesh()
    if mesh is None:
        return h @ _head(params, cfg, h.dtype)
    params, vmesh = _vocab_params(params, cfg)
    out = h @ _head(params, cfg, h.dtype)
    if vmesh is not None:
        out = autodiff.leave(mesh, out.contiguous(), MODEL, out.dim() - 1)
    axes = sharding.batch_axes(mesh, cfg.sharding_profile)
    if axes and mesh.size(axes) > 1:
        out = autodiff.leave(mesh, out.contiguous(), axes, 0)
    return out


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


def _ce_terms_tp(logits: torch.Tensor, labels: torch.Tensor, dt,
                 mesh: ProcessMesh):
    """:func:`_ce_terms` of the logits' vocabulary split over ``"model"``:
    ``logits`` (..., V/M) is this rank's block.  The row max is the max
    over ``"model"`` of the blocks' (exact), the sum of ``exp`` the
    blocks' sums added in f32 in rank order, and the label logit (read
    in the compute type ``dt``) comes from the rank whose block holds the
    label (the others add zero; a label of -1 is in no block).  Every
    rank gets the same terms."""
    Vl = logits.shape[-1]
    m = mesh.pmax(logits.detach().amax(dim=-1).unsqueeze(0),
                  MODEL).reshape(labels.shape)
    se = autodiff.tp_out(torch.sum(torch.exp(logits - m[..., None]),
                                   dim=-1), mesh, MODEL)
    lse = m + torch.log(se)
    loc = labels.long() - mesh.group_rank(MODEL, mesh.rank) * Vl
    own = (loc >= 0) & (loc < Vl)
    zero = torch.zeros((), dtype=torch.float32, device=logits.device)
    label_logit = logits.to(dt).gather(-1, loc.clamp(0, Vl - 1)[..., None])[
        ..., 0].to(torch.float32)
    label_logit = autodiff.tp_out(torch.where(own, label_logit, zero), mesh,
                                  MODEL)
    valid = labels >= 0
    return (torch.where(valid, lse - label_logit, zero),
            torch.where(valid, lse * lse, zero), valid)


def _logits(h: torch.Tensor, w: torch.Tensor,
            mesh: Optional[ProcessMesh]) -> torch.Tensor:
    """f32 logits from the compute-type product ``h @ w``; ``mesh``: ``w``
    is this rank's vocabulary block (a column-parallel product)."""
    if mesh is not None:
        h = autodiff.tp_in(h, mesh, MODEL)
    return (h @ w).to(torch.float32)


def _chunk_ce(hx: torch.Tensor, lx: torch.Tensor, w: torch.Tensor,
              mesh: Optional[ProcessMesh] = None):
    """One sequence chunk's summed nll and z terms: logits (B, c, V) in
    f32 from the compute-type product (over ``mesh``: this rank's
    vocabulary block of them, :func:`_ce_terms_tp`)."""
    logits = _logits(hx, w, mesh)
    nll, zl, _ = (_ce_terms(logits, lx, hx.dtype) if mesh is None
                  else _ce_terms_tp(logits, lx, hx.dtype, mesh))
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
    ``router_coact`` (E, E).

    Under an ambient ``ProcessMesh`` (``sharding.use_mesh``) ``params``
    are this rank's blocks, ``batch`` is its block and the loss the whole
    batch's: the CE, z and MTP sums are added over the batch axes of
    ``cfg.sharding_profile`` and divided by the global count of valid
    labels (a gathered integer), as the JAX package's ``jit`` over a mesh
    computes them; every rank returns the same loss and metrics.  Where
    the vocabulary is split over ``"model"`` the head and the CE run
    vocabulary parallel (:func:`_ce_terms_tp`): no rank holds a whole
    row of logits."""
    params, vmesh = _vocab_params(params, cfg)
    h, _, aux = forward(params, cfg, batch, with_aux=True, remat=remat,
                        collect_router_stats=collect_router_stats)
    rstats = None
    if collect_router_stats:
        aux, rstats = aux
        rstats = moe_mod.RouterStats(*(t.detach() for t in rstats))
    labels = batch["labels"]
    B, S = labels.shape
    dt = h.dtype
    w = _head(params, cfg, dt)
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
            nll, zl = checkpoint(_chunk_ce, hx, lx, w, vmesh,
                                 use_reentrant=False)
        else:
            nll, zl = _chunk_ce(hx, lx, w, vmesh)
        tot = tot + nll
        ztot = ztot + zl
    cnt = _batch_sum(cfg, (labels >= 0).sum().to(torch.int32))
    tot, ztot = _batch_sum(cfg, tot), _batch_sum(cfg, ztot)
    denom = torch.clamp(cnt, min=1).to(f32)
    ce = tot / denom
    loss = ce + z_weight * ztot / denom
    if cfg.moe is not None:
        loss = loss + cfg.moe.router_aux_weight * aux
    mtp = torch.zeros((), dtype=f32, device=h.device)
    if cfg.mtp and batch.get("tokens") is not None:
        mtp = _mtp_loss(params, cfg, batch, h[:, :S], vmesh)
        loss = loss + 0.3 * mtp
    metrics = dict(ce=ce, aux=aux, tokens=cnt, mtp=mtp)
    if rstats is not None:
        metrics["router_counts"] = rstats.counts
        metrics["router_coact"] = rstats.coact
    return loss, metrics


def _mtp_loss(params: Dict, cfg: ModelConfig, batch: Dict,
              h: torch.Tensor,
              vmesh: Optional[ProcessMesh] = None) -> torch.Tensor:
    """DeepSeek-V3 multi-token prediction: one extra attention block
    predicting t+2 from ``[norm(h_t) ; emb(token_{t+1})]``, sharing the
    embedding and the head; the mean CE over valid positions
    (vocabulary parallel over ``vmesh``, as :func:`loss_fn`)."""
    dt = h.dtype
    tokens, labels = batch["tokens"], batch["labels"]
    nxt = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    lbl2 = torch.cat([labels[:, 1:], torch.full_like(labels[:, -1:], -1)],
                     dim=1)
    e = _lookup(params["embed"], nxt, dt, vmesh)
    hm = rms_norm(h, params["mtp"]["norm"], cfg.norm_eps)
    proj = params["mtp"]["proj"]
    mesh = sharding.rank_mesh()
    if mesh is not None:
        proj = sharding.gathered(proj, _mtp_proj_spec(cfg), mesh,
                                 cfg.sharding_profile)
    x = torch.cat([hm, e], dim=-1) @ proj.to(dt)
    x, _ = apply_block(params["mtp"]["block"], cfg, "attn", x,
                       batch["positions"], None)
    logits = _logits(x, _head(params, cfg, dt), vmesh)
    nll, _, valid = (_ce_terms(logits, lbl2, dt) if vmesh is None
                     else _ce_terms_tp(logits, lbl2, dt, vmesh))
    return _batch_sum(cfg, nll.sum()) / torch.clamp(
        _batch_sum(cfg, valid.sum()), min=1).to(torch.float32)


def _batch_sum(cfg: ModelConfig, t: torch.Tensor) -> torch.Tensor:
    """A scalar summed over the batch axes of the ambient ``ProcessMesh``
    (gathered and added in rank order, the same bits on every rank; its
    gradient reaches this rank's term once), else ``t``."""
    mesh = sharding.rank_mesh()
    if mesh is None:
        return t
    axes = sharding.batch_axes(mesh, cfg.sharding_profile)
    return autodiff.leave(mesh, t.reshape(1), axes).sum(0).to(t.dtype)


# ------------------------------------------------------------ decode step --


def prefill(params, cfg: ModelConfig, batch: Dict, cache: List[Dict]):
    """Full-sequence forward writing the cache; returns last-position
    logits (B, 1, V) and the cache.  Over an ambient ``ProcessMesh``:
    ``params``, ``batch`` and ``cache`` are this rank's blocks (under
    :func:`serving_config`'s profile), the prompt starts at position 0,
    and the logits are every row's (see :func:`logits_head`)."""
    return _serve(params, cfg, batch, cache, decode=False)


def decode_step(params, cfg: ModelConfig, tokens: Optional[torch.Tensor],
                index: int, cache: List[Dict],
                embeds: Optional[torch.Tensor] = None):
    """One decode step: tokens (B, 1) (or frontend ``embeds`` (B, 1, D))
    at position ``index``.  Over an ambient ``ProcessMesh`` as
    :func:`prefill`: ``tokens`` are this rank's rows, the logits every
    row's."""
    src = tokens if tokens is not None else embeds
    positions = torch.full((src.shape[0], 1), int(index), dtype=torch.int32,
                           device=src.device)
    return _serve(params, cfg, dict(tokens=tokens, embeds=embeds,
                                    positions=positions), cache, decode=True)


def _serve(params, cfg: ModelConfig, batch: Dict, cache: List[Dict], *,
           decode: bool):
    """:func:`forward` over the cache and the logits of the last position
    (B, 1, V), the rows laid out under :func:`serving_config`'s profile
    as ``forward`` lays them."""
    cfg = serving_config(cfg)
    h, cache = forward(params, cfg, batch, cache=cache, decode=decode)
    return logits_head(params, cfg, h[:, -1:]), cache
