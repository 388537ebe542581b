"""Wrapper for the flash-attention kernel K6 (``csrc/flash_attention.cu``).

:func:`flash_attention` keeps the JAX layouts: ``q`` (B, Sq, KV, G, hd),
``k``/``v`` (B, T, KV, hd), positions (B, Sq) / (B, T) int32 with
``2^30`` marking an unwritten slot.  CPU tensors take the plain version
(:mod:`.ref`, the model's chunked attention); CUDA tensors launch the
kernel or raise.

The kernel has three forms, one C entry each; :func:`flash_form` picks
one from the shapes and types alone:

* ``"split"`` — ``Sq * G <= 32`` (every decode tick): the key axis is cut
  into splits of :func:`split_keys` keys, one block per (b·kv head,
  split) reads its chunk once for all query heads, and a second kernel
  merges the splits' (m, l, o) partials in split order;
* ``"mma"`` — bf16 q and k/v with ``hd % 16 == 0`` (the served model's
  prefill): (query row, group) pairs packed into the M dimension of bf16
  ``mma.sync`` tensor-core products;
* ``"simt"`` — everything else (f32 or mixed types, ``hd % 16 != 0``,
  and the shapes past the other forms' ``G <= 32``, ``hd <= 288``: MLA's
  latent attention, G = 128 query heads on one latent "kv head" of
  hd = 576): one warp per (query row, group) pair, f32 FMAs.

Each wrapper call counts one launch of the kernel however many CUDA
kernels its form issues; :data:`form_launches` counts the calls by form.
``_launch`` takes the form, key split, M tile and partials kernel as
arguments, so tests and ``benchmarks_torch/flash_forms.py`` reach the
variants the rule does not take.

The backward (``csrc/flash_attention_bwd.cu``, its own library and
launch count, :data:`BWD_KERNEL`) gives dq, dk and dv from q, k, v, the
positions, the forward's output and its cotangent: a dq kernel (which
also writes the rows' softmax max, sum and ``rowsum(do * o)``), then a
dk/dv kernel, no float atomics, two calls equal bit for bit.  It has two
forms, one C entry each; :func:`bwd_form` picks one from the shapes and
types alone, :data:`bwd_form_launches` counts the calls by form:

* ``"mma"`` — bf16 q and k/v, ``hd % 16 == 0``, ``hd <= 128`` (the dk/dv
  accumulators' registers), ``G <= 32`` (the training path): both kernels
  on bf16 ``mma.sync`` tensor-core products in FlashAttention-2's order,
  64 pairs a dq block, 64 keys a dk/dv block;
* ``"simt"`` — everything else (f32 and mixed types, ``hd % 16 != 0``,
  past hd 128 or G 32 up to the simt forward's G 128, hd 576): a warp per
  pair in the dq kernel, a warp per key in the dk/dv kernel, f32 FMAs.

``_launch_bwd`` takes the form as an argument, so tests and
``chip_smoke.py`` reach the simt form at the mma form's shapes.
:func:`flash_attention` runs the forward inside the
:class:`FlashAttention` autograd function when grad is enabled and an
input requires it; on CPU tensors its backward is the autograd of the
plain version (:func:`.ref.attention_bwd_ref`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import INT, PTR, CudaKernel, check_cuda
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     chunked_attention)

KERNEL = CudaKernel("flash_attention", "flash_attention.cu", {
    "flash_attention_launch": [PTR] * 6 + [INT] * 10,
    "flash_attention_split_launch": [PTR] * 9 + [INT] * 14,
    "flash_attention_mma_launch": [PTR] * 9 + [INT] * 11,
})
BWD_KERNEL = CudaKernel("flash_attention_bwd", "flash_attention_bwd.cu", {
    "flash_attention_bwd_launch": [PTR] * 13 + [INT] * 10,
    "flash_attention_bwd_mma_launch": [PTR] * 15 + [INT] * 8,
})

MAX_HD = 576        # the simt form: 18 output columns a lane (csrc)
MAX_G = 128         # the simt form: slices of 16 groups a block past 32
FAST_MAX_HD = 288   # the split and mma forms: 9 columns a lane, registers
FAST_MAX_G = 32     # the split and mma forms
SPLIT_MAX_PAIRS = 32    # Sq · G a split block holds (csrc)
SPLIT_BLOCKS = 132      # blocks a split launch aims at: the H100's SMs
MMA_WARPS = 4           # 16 pairs a warp: 64-pair M tiles
MMA_BLOCKS = 264        # blocks an mma launch aims at: two an SM
FORMS = ("split", "mma", "simt")
BWD_MMA_MAX_HD = 128    # the backward's mma form: dk/dv registers (csrc)
BWD_MMA_MAX_G = 32
BWD_FORMS = ("mma", "simt")
_TYPES = (torch.float32, torch.bfloat16)

form_launches = {f: 0 for f in FORMS}
bwd_form_launches = {f: 0 for f in BWD_FORMS}


def takes_tensor_cores(hd: int, q_dtype, kv_dtype) -> bool:
    """Whether the bf16 tensor-core kernel takes these operands: bf16 q
    and k/v, ``hd % 16 == 0`` (it runs the mma form, and the split form's
    partials; the FMA kernels run the rest)."""
    return q_dtype == kv_dtype == torch.bfloat16 and hd % 16 == 0


def flash_form(B: int, Sq: int, T: int, KV: int, G: int, hd: int,
               q_dtype, kv_dtype) -> str:
    """The kernel form a call of these shapes and types takes: "split"
    for at most 32 (query row, group) pairs, else "mma" where the tensor
    cores take the operands, else "simt"; past ``G <= 32`` or
    ``hd <= 288`` (MLA's latent attention) always "simt"."""
    if G > FAST_MAX_G or hd > FAST_MAX_HD:
        return "simt"
    if Sq * G <= SPLIT_MAX_PAIRS:
        return "split"
    if takes_tensor_cores(hd, q_dtype, kv_dtype):
        return "mma"
    return "simt"


def bwd_form(B: int, Sq: int, T: int, KV: int, G: int, hd: int,
             q_dtype, kv_dtype) -> str:
    """The backward's form for these shapes and types: "mma" where the
    tensor cores take the operands (bf16 q and k/v, ``hd % 16 == 0``) and
    ``hd <= 128``, ``G <= 32``, else "simt"."""
    if (G <= BWD_MMA_MAX_G and hd <= BWD_MMA_MAX_HD
            and takes_tensor_cores(hd, q_dtype, kv_dtype)):
        return "mma"
    return "simt"


def split_keys(B: int, KV: int, T: int) -> int:
    """Keys a split of the split form: whole 32-key tiles, as few as give
    ``B · KV · ceil(T / keys)`` about ``SPLIT_BLOCKS`` blocks."""
    tiles = -(-T // 32)
    splits = max(1, -(-SPLIT_BLOCKS // max(1, B * KV)))
    return 32 * -(-tiles // splits)


def mma_split_keys(B: int, Sq: int, T: int, KV: int, G: int) -> int:
    """Keys a split of the mma form: whole 32-key tiles, as few as give
    the M tiles of ``16 · MMA_WARPS`` pairs times the splits about
    ``MMA_BLOCKS`` blocks (one split where the M tiles alone reach it)."""
    m_tiles = max(1, B * KV * -(-Sq * G // (16 * MMA_WARPS)))
    tiles = -(-T // 32)
    return 32 * -(-tiles // max(1, -(-MMA_BLOCKS // m_tiles)))


def _int32(t: torch.Tensor) -> torch.Tensor:
    return (t if t.dtype == torch.int32 else t.to(torch.int32)).contiguous()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    # the kernels read rows 16 bytes at a time
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _flash_attention_cuda(q, k, v, q_pos, kv_pos, window, prefix_len):
    """The kernel in the form :func:`flash_form` names, with the key split
    and partials kernel the shapes and types give."""
    B, Sq, KV, G, hd = q.shape
    T = k.shape[1]
    form = flash_form(B, Sq, T, KV, G, hd, q.dtype, k.dtype)
    if form == "split":
        return _launch(q, k, v, q_pos, kv_pos, window, prefix_len, "split",
                       split_keys(B, KV, T),
                       tensor_cores=takes_tensor_cores(hd, q.dtype, k.dtype))
    if form == "mma":
        return _launch(q, k, v, q_pos, kv_pos, window, prefix_len, "mma",
                       mma_split_keys(B, Sq, T, KV, G))
    return _launch(q, k, v, q_pos, kv_pos, window, prefix_len, "simt")


def _launch(q, k, v, q_pos, kv_pos, window, prefix_len, form,
            keys_per_split=0, warps=MMA_WARPS, tensor_cores=False):
    """One call of the kernel in ``form`` with these settings: keys a split
    (split and mma forms; T or more is one split), warps a block (2 or 4,
    mma form) and the split form's partials kernel.  The serving path takes
    :func:`_flash_attention_cuda`'s; tests and ``flash_forms.py`` set them
    to reach the variants the rule does not take."""
    B, Sq, KV, G, hd = q.shape
    T = k.shape[1]
    if q.dtype not in _TYPES or k.dtype not in _TYPES or v.dtype != k.dtype:
        raise ValueError(f"flash attention takes f32 or bf16 q and k/v of "
                         f"one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.shape == v.shape == (B, T, KV, hd)
            and q_pos.shape == (B, Sq) and kv_pos.shape == (B, T)):
        raise ValueError("flash attention: inconsistent shapes")
    if not (1 <= G <= MAX_G and 1 <= hd <= MAX_HD and T >= 1):
        raise ValueError(f"flash attention kernel takes 1 <= G <= {MAX_G}, "
                         f"1 <= hd <= {MAX_HD} and T >= 1; got G={G}, "
                         f"hd={hd}, T={T}")
    if form != "simt" and not (G <= FAST_MAX_G and hd <= FAST_MAX_HD):
        raise ValueError(f"the {form} form takes G <= {FAST_MAX_G} and "
                         f"hd <= {FAST_MAX_HD}, got G={G}, hd={hd}")
    if form == "split" and Sq * G > SPLIT_MAX_PAIRS:
        raise ValueError(f"the split form holds Sq * G <= {SPLIT_MAX_PAIRS} "
                         f"pairs, got {Sq * G}")
    if (form == "mma" or tensor_cores) and not takes_tensor_cores(
            hd, q.dtype, k.dtype):
        raise ValueError("the tensor-core kernel takes bf16 q and k/v with "
                         f"hd % 16 == 0, got {q.dtype}, {k.dtype}, hd={hd}")
    if form not in FORMS:
        raise ValueError(f"unknown flash attention form {form!r}")
    if form != "simt" and not (keys_per_split >= T or (
            keys_per_split > 0 and keys_per_split % 32 == 0)):
        raise ValueError(f"keys a split: whole 32-key tiles or T or more, "
                         f"got {keys_per_split}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    qp, kp = _int32(q_pos), _int32(kv_pos)
    check_cuda(q, k, v, qp, kp)
    out = torch.empty_like(q)
    if Sq == 0 or B * KV == 0:
        return out
    ptrs = [t.data_ptr() for t in (q, k, v, qp, kp, out)]
    masks = [B, Sq, T, KV, G, hd, int(window), int(prefix_len)]
    types = [int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16)]
    if form == "simt":
        KERNEL.launch("flash_attention_launch", *ptrs, *masks, *types)
    else:
        n_split = -(-T // keys_per_split)
        parts = [ptrs[-1]] * 3                  # unread by one mma split
        if n_split > 1 or (form == "split" and not tensor_cores):
            # f32 partials (m, l, o) of every (b·kv head, pair, split)
            n = B * KV * Sq * G * n_split
            part = torch.empty(n * (hd + 2), dtype=torch.float32,
                               device=q.device)
            base = part.data_ptr()
            parts = [base, base + 4 * n, base + 8 * n]      # m, l, o
        if form == "split":
            KERNEL.launch("flash_attention_split_launch", *ptrs, *parts,
                          *masks, *types, keys_per_split, n_split,
                          int(hd % 8 == 0), int(tensor_cores))
        else:
            KERNEL.launch("flash_attention_mma_launch", *ptrs, *parts,
                          *masks, keys_per_split, n_split, warps)
    form_launches[form] += 1
    return out


def _forward(q, k, v, q_pos, kv_pos, window, prefix_len):
    if q.device.type == "cpu":
        return chunked_attention(q, k, v, q_pos, kv_pos, window=window,
                                 prefix_len=prefix_len)
    return _flash_attention_cuda(q, k, v, q_pos, kv_pos, window, prefix_len)


def flash_attention_bwd(q, k, v, q_pos, kv_pos, o, do, *, window: int = 0,
                        prefix_len: int = 0):
    """``(dq, dk, dv)`` of :func:`flash_attention` at these inputs, its
    output ``o`` and that output's cotangent ``do``: the backward kernel in
    the form :func:`bwd_form` names for CUDA tensors, the plain version's
    autograd for CPU tensors."""
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, q_pos, kv_pos, do, window=window,
                                 prefix_len=prefix_len)
    B, Sq, KV, G, hd = q.shape
    form = bwd_form(B, Sq, k.shape[1], KV, G, hd, q.dtype, k.dtype)
    return _launch_bwd(q, k, v, q_pos, kv_pos, o, do, window, prefix_len,
                       form)


def _launch_bwd(q, k, v, q_pos, kv_pos, o, do, window, prefix_len, form):
    """One call of the backward kernel in ``form``; the training path takes
    :func:`bwd_form`'s, tests and ``chip_smoke.py`` name the simt form to
    hold the two to each other.  Checks everything before it touches a
    device."""
    B, Sq, KV, G, hd = q.shape
    T = k.shape[1]
    if q.dtype not in _TYPES or k.dtype not in _TYPES or v.dtype != k.dtype:
        raise ValueError(f"flash attention backward takes f32 or bf16 q and "
                         f"k/v of one type, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"o and do must have q's type {q.dtype}, got "
                         f"{o.dtype}, {do.dtype}")
    if not (k.shape == v.shape == (B, T, KV, hd) and o.shape == q.shape
            and do.shape == q.shape and q_pos.shape == (B, Sq)
            and kv_pos.shape == (B, T)):
        raise ValueError("flash attention backward: inconsistent shapes")
    if not (1 <= G <= MAX_G and 1 <= hd <= MAX_HD and T >= 1):
        raise ValueError(f"flash attention backward takes 1 <= G <= {MAX_G}"
                         f", 1 <= hd <= {MAX_HD} and T >= 1; got G={G}, "
                         f"hd={hd}, T={T}")
    if form not in BWD_FORMS:
        raise ValueError(f"unknown flash attention backward form {form!r}")
    if form == "mma" and bwd_form(B, Sq, T, KV, G, hd, q.dtype,
                                  k.dtype) != "mma":
        raise ValueError(f"the backward's mma form takes bf16 q and k/v with "
                         f"hd % 16 == 0, hd <= {BWD_MMA_MAX_HD} and G <= "
                         f"{BWD_MMA_MAX_G}; got {q.dtype}, {k.dtype}, G={G}, "
                         f"hd={hd}")
    q, k, v, o, do = (_aligned(t) for t in (q, k, v, o, do))
    qp, kp = _int32(q_pos), _int32(kv_pos)
    check_cuda(q, k, v, o, do, qp, kp)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if Sq == 0 or B * KV == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    n = B * Sq * KV * G
    # the pairs' m, l and rowsum(do * o) (f32); the mma form adds their
    # visit ends and a record of 4 int32 for each 64-pair tile (16-byte
    # aligned: torch allocates on 256 bytes)
    words = 3 * n if form == "simt" else 4 * n + 4 * B * KV * -(-Sq * G // 64)
    rows = torch.empty(words, dtype=torch.float32, device=q.device)
    base = rows.data_ptr()
    ptrs = [*(t.data_ptr() for t in (q, k, v, qp, kp, o, do, dq, dk, dv)),
            base, base + 4 * n, base + 8 * n]
    shapes = [B, Sq, T, KV, G, hd, int(window), int(prefix_len)]
    if form == "mma":
        BWD_KERNEL.launch("flash_attention_bwd_mma_launch", *ptrs,
                          base + 12 * n, base + 16 * n, *shapes)
    else:
        BWD_KERNEL.launch("flash_attention_bwd_launch", *ptrs, *shapes,
                          int(q.dtype == torch.bfloat16),
                          int(k.dtype == torch.bfloat16))
    bwd_form_launches[form] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K6 forward, its backward kernel behind ``backward`` (the plain
    versions for CPU tensors).  Saves q, k, v, the positions and the
    output; no (Sq, T) tensor is kept."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, window, prefix_len):
        o = _forward(q, k, v, q_pos, kv_pos, window, prefix_len)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, o)
        ctx.masks = (window, prefix_len)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_pos, kv_pos, o = ctx.saved_tensors
        window, prefix_len = ctx.masks
        dq, dk, dv = flash_attention_bwd(q, k, v, q_pos, kv_pos, o,
                                         do.contiguous(), window=window,
                                         prefix_len=prefix_len)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, q_pos, kv_pos, *, window: int = 0,
                    prefix_len: int = 0) -> torch.Tensor:
    """GQA attention with causal / window / prefix masks from positions;
    returns (B, Sq, KV, G, hd) in q's type.  Differentiable in q, k and v
    through :class:`FlashAttention` where grad is enabled."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, q_pos, kv_pos, int(window),
                                    int(prefix_len))
    return _forward(q, k, v, q_pos, kv_pos, window, prefix_len)
