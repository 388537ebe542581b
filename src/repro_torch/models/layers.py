"""Shared layer primitives: RMS norm, RoPE, the gated MLP and their
parameter specs (counterpart of ``repro.models.layers``).

The JAX package's sharding helpers (``shard``, the profiles,
``translate``) are no-ops without a device mesh and have no counterpart
on one card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamSpec


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Normalize in f32 and cast back to ``x``'s type."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = (x * x).mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * w.to(torch.float32)).to(dt)


def rms_norm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), init="ones")


# ----------------------------------------------------------------- RoPE ----


def rope_freqs(positions: torch.Tensor, dim: int,
               theta: float) -> torch.Tensor:
    """(..., dim/2) f32 angles for the given positions."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                       device=positions.device), exps)
    return positions[..., None].to(torch.float32) * inv


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D) — rotate pairs (split-half convention); cos and
    sin are computed in f32 and cast to ``x``'s type."""
    D = x.shape[-1]
    ang = rope_freqs(positions, D, theta)              # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


# ------------------------------------------------------------------ MLP ----


def mlp_specs(d_model: int, d_ff: int) -> dict:
    return dict(wi=ParamSpec((d_model, d_ff)),
                wg=ParamSpec((d_model, d_ff)),
                wo=ParamSpec((d_ff, d_model)))


def mlp(params: dict, x: torch.Tensor, dtype) -> torch.Tensor:
    """Gated SiLU MLP (llama family)."""
    h = x @ params["wg"].to(dtype)
    u = x @ params["wi"].to(dtype)
    return (F.silu(h) * u) @ params["wo"].to(dtype)


def embed_specs(vocab: int, d_model: int) -> ParamSpec:
    return ParamSpec((vocab, d_model), scale=0.02)
