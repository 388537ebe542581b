"""Shared layer primitives: RMS norm, RoPE, the gated MLP and their
parameter specs (counterpart of ``repro.models.layers``).

The JAX package's sharding helpers (``shard``, the profiles,
``translate``) constrain activations under GSPMD and have no counterpart;
the specs carry the JAX partition axes (``distributed.sharding`` reads
them), and over a ``ProcessMesh`` the MLP runs tensor parallel with its
collectives written out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import autodiff
from repro_torch.models.params import ParamSpec

BATCH = ("pod", "data")
MODEL = "model"


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Normalize in f32 and cast back to ``x``'s type."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = (x * x).mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * w.to(torch.float32)).to(dt)


def rms_norm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), (None,), init="ones")


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
    return dict(wi=ParamSpec((d_model, d_ff), ((None,), MODEL)),
                wg=ParamSpec((d_model, d_ff), ((None,), MODEL)),
                wo=ParamSpec((d_ff, d_model), (MODEL, (None,))))


def mlp(params: dict, x: torch.Tensor, dtype, mesh=None) -> torch.Tensor:
    """Gated SiLU MLP (llama family).  ``mesh``: a ``ProcessMesh`` whose
    ``"model"`` axis splits ``d_ff``: ``wi``/``wg`` are this rank's
    column blocks and ``wo`` its row block, so the product is tensor
    parallel (``x`` enters by ``autodiff.tp_in``, the partial outputs
    are added by ``autodiff.row_parallel``)."""
    if mesh is not None:
        x = autodiff.tp_in(x, mesh, MODEL)
    h = x @ params["wg"].to(dtype)
    u = x @ params["wi"].to(dtype)
    if mesh is None:
        return (F.silu(h) * u) @ params["wo"].to(dtype)
    return autodiff.row_parallel(F.silu(h) * u, params["wo"].to(dtype), mesh,
                                 MODEL)


def embed_specs(vocab: int, d_model: int) -> ParamSpec:
    return ParamSpec((vocab, d_model), (MODEL, "data"), scale=0.02)
