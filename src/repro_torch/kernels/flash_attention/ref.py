"""Plain PyTorch version of the flash-attention kernel: the model's
chunked online-softmax attention (counterpart of
``repro.models.attention.chunked_attention`` and its ``direct_attention``
branch), the CPU path and the kernel's oracle.

Masks derive entirely from positions (``POS_SENTINEL`` marks an unwritten
cache slot), so full caches, ring-buffer sliding-window caches and
prefix-LM reads share one code path.
"""
from __future__ import annotations

import math

import torch

POS_SENTINEL = 2 ** 30
NEG = -1e30


def mask(q_pos, kv_pos, window: int, prefix_len: int) -> torch.Tensor:
    """(..., Sq, Tk) allowed mask from positions (sentinel pos ⇒ masked)."""
    qp = q_pos[..., :, None]
    kp = kv_pos[..., None, :]
    ok = kp <= qp                                   # causal + validity
    if window:
        ok &= (qp - kp) < window
    if prefix_len:
        ok |= (kp < prefix_len) & (kp < POS_SENTINEL // 2)
    return ok


def _scale(hd: int) -> float:
    # 1 / sqrt(f32(hd)) in f32, as the JAX package computes it
    return float(1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32)))


def direct_attention(q, k, v, q_pos, kv_pos, *, window=0, prefix_len=0):
    """Un-chunked attention for short query blocks (decode: Sq <= 8);
    normalizes p before the PV product."""
    f32 = torch.float32
    s = torch.einsum("bqkgh,btkh->bkgqt", q.to(f32), k.to(f32)) \
        * _scale(q.shape[-1])
    allowed = mask(q_pos, kv_pos, window, prefix_len)         # (B, Sq, Tk)
    s = torch.where(allowed[:, None, None], s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pn = (p / torch.clamp(l, min=1e-30)).to(v.dtype)
    o = torch.einsum("bkgqt,btkh->bqkgh", pn.to(f32), v.to(f32))
    return o.to(v.dtype).to(q.dtype)


def _chunk(x, n):
    """(B, S, ...) -> (S//n, B, n, ...) chunk-major."""
    B, S = x.shape[:2]
    return x.reshape(B, S // n, n, *x.shape[2:]).movedim(1, 0)


def chunked_attention(q, k, v, q_pos, kv_pos, *, window: int = 0,
                      prefix_len: int = 0, q_chunk: int = 512,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention: q (B, Sq, KV, G, hd), k/v (B, Tk, KV, hd),
    positions i32; returns (B, Sq, KV, G, hd) in q's type."""
    B, Sq, KV, G, hd = q.shape
    Tk = k.shape[1]
    if Sq <= 8:  # decode path
        return direct_attention(q, k, v, q_pos, kv_pos, window=window,
                                prefix_len=prefix_len)
    f32 = torch.float32
    qc = min(q_chunk, Sq)
    kc = min(kv_chunk, Tk)
    Sp = -(-Sq // qc) * qc
    Tp = -(-Tk // kc) * kc
    if Sp != Sq:
        q = torch.cat([q, q.new_zeros((B, Sp - Sq) + q.shape[2:])], 1)
        q_pos = torch.cat([q_pos, q_pos.new_zeros((B, Sp - Sq))], 1)
    if Tp != Tk:
        k = torch.cat([k, k.new_zeros((B, Tp - Tk) + k.shape[2:])], 1)
        v = torch.cat([v, v.new_zeros((B, Tp - Tk) + v.shape[2:])], 1)
        kv_pos = torch.cat(
            [kv_pos, kv_pos.new_full((B, Tp - Tk), POS_SENTINEL)], 1)
    scale = _scale(hd)
    outs = []
    for qi, qp in zip(_chunk(q, qc), _chunk(q_pos, qc)):
        o = torch.zeros((B, qc, KV, G, hd), dtype=f32, device=q.device)
        m = torch.full((B, KV, G, qc), -math.inf, dtype=f32, device=q.device)
        l = torch.zeros((B, KV, G, qc), dtype=f32, device=q.device)
        for ki, vi, kp in zip(_chunk(k, kc), _chunk(v, kc),
                              _chunk(kv_pos, kc)):
            s = torch.einsum("bqkgh,btkh->bkgqt", qi.to(f32),
                             ki.to(f32)) * scale
            allowed = mask(qp, kp, window, prefix_len)       # (B, qc, kc)
            s = torch.where(allowed[:, None, None], s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqt,btkh->bqkgh",
                              p.to(vi.dtype).to(f32), vi.to(f32))
            o = o * corr.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        l = torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
        outs.append((o / l).to(q.dtype))
    return torch.cat(outs, 1)[:, :Sq]

