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



def attention_bwd_ref(q, k, v, q_pos, kv_pos, do, *, window: int = 0,
                      prefix_len: int = 0):
    """The backward's plain version: ``(dq, dk, dv)``, the autograd of
    :func:`chunked_attention` at these inputs against the cotangent ``do``
    of its output (each in its input's type)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = chunked_attention(*leaves, q_pos, kv_pos, window=window,
                                prefix_len=prefix_len)
        return torch.autograd.grad(out, leaves, do)


# ------------------------------------------------------ the split form --
# The kernel's split form in plain PyTorch: the keys a row visits, each
# key split's (m, l, o) partials, and their merge in split order.  The
# partials and their merge are the CPU path of ``ops.flash_partials`` and
# ``ops.flash_combine`` (attention over a cache split by length over
# ranks); the split attention is what tests hold the kernel's to.

TILE = 32   # keys a kernel tile


def visit_end(q_pos, T: int, G: int, prefix_len: int = 0) -> torch.Tensor:
    """(B, Sq) slots each query row visits: the key tiles below the causal
    bound of its group of ``max(1, min(Sq, 16 // G))`` rows, the largest
    non-sentinel position ``hi`` of the group (raised to ``prefix_len - 1``
    with a prefix) giving ``min((hi + 32) // 32 + 1, ceil(T / 32))``
    tiles, at most T slots."""
    B, Sq = q_pos.shape
    rows = max(1, min(Sq, 16 // G))
    hi = torch.where(q_pos < POS_SENTINEL // 2, q_pos.long(), -1)
    hi = torch.nn.functional.pad(hi, (0, -Sq % rows), value=-1)
    hi = hi.reshape(B, -1, rows).amax(-1)
    if prefix_len:
        hi = torch.clamp(hi, min=prefix_len - 1)
    tiles = torch.clamp((hi + TILE) // TILE + 1, max=-(-T // TILE))
    vis = torch.clamp(tiles * TILE, max=T)
    return vis.repeat_interleave(rows, dim=1)[:, :Sq]


def split_partials(q, k, v, q_pos, kv_pos, *, window: int = 0,
                   prefix_len: int = 0, keys_per_split: int = TILE,
                   offset: int = 0, total=None):
    """Each key split's f32 partials ``(m, l, o)``: m and l (n_split, B,
    Sq, KV, G), o (n_split, B, Sq, KV, G, hd).  A split holding none of a
    row's visited keys gives m = -inf, l = 0, o = 0; p is rounded to v's
    type before the PV product while l sums the unrounded p.

    A block of keys: ``k``, ``v`` and ``kv_pos`` hold the global slots
    ``[offset, offset + T)`` of a cache of ``total`` slots (default T: the
    whole cache), and the visit bound (:func:`visit_end`) counts global
    slots, so the partials of the M blocks of a cache, concatenated in
    block order, are the whole cache's where ``T`` is a multiple of
    ``keys_per_split``.  Each split's scores come from its own keys alone
    (the same products whatever the block)."""
    B, Sq, KV, G, hd = q.shape
    T = k.shape[1]
    total = T if total is None else int(total)
    if not 0 <= offset <= total - T:
        raise ValueError(f"a block of {T} keys at offset {offset} of a "
                         f"cache of {total}")
    f32 = torch.float32
    q32 = q.to(f32)
    slot = offset + torch.arange(T, device=q.device)
    seen = slot < visit_end(q_pos, total, G, prefix_len)[..., None]
    ms, ls, os = [], [], []
    for lo in range(0, T, keys_per_split):
        hi = min(lo + keys_per_split, T)
        sc = torch.einsum("bqkgh,btkh->bqkgt", q32,
                          k[:, lo:hi].to(f32)) * _scale(hd)
        allowed = mask(q_pos, kv_pos[:, lo:hi], window, prefix_len)
        sc = torch.where(allowed[:, :, None, None], sc, NEG)
        sc = torch.where(seen[:, :, None, None, lo:hi], sc, -math.inf)
        m = sc.amax(-1)
        p = torch.where(sc == -math.inf, 0.0, torch.exp(sc - m[..., None]))
        ms.append(m)
        ls.append(p.sum(-1))
        os.append(torch.einsum("bqkgt,btkh->bqkgh", p.to(v.dtype).to(f32),
                               v[:, lo:hi].to(f32)))
    return torch.stack(ms), torch.stack(ls), torch.stack(os)


def combine_partials(m, l, o, dtype) -> torch.Tensor:
    """Merge the splits in split order: weights exp(m_i - M), 0 for
    m_i = -inf; out = O / max(L, 1e-30) in ``dtype``."""
    M = m.amax(0)
    L = torch.zeros_like(M)
    O = torch.zeros_like(o[0])
    for mi, li, oi in zip(m, l, o):
        w = torch.where(mi == -math.inf, 0.0, torch.exp(mi - M))
        L = L + w * li
        O = O + w[..., None] * oi
    return (O / torch.clamp(L, min=1e-30)[..., None]).to(dtype)


def split_attention(q, k, v, q_pos, kv_pos, *, window: int = 0,
                    prefix_len: int = 0,
                    keys_per_split: int = TILE) -> torch.Tensor:
    """The split form: partials of every key split, then their merge."""
    return combine_partials(
        *split_partials(q, k, v, q_pos, kv_pos, window=window,
                        prefix_len=prefix_len,
                        keys_per_split=keys_per_split), q.dtype)
