"""Wrapper for the flash-attention kernel K6 (``csrc/flash_attention.cu``).

:func:`flash_attention` keeps the JAX layouts: ``q`` (B, Sq, KV, G, hd),
``k``/``v`` (B, T, KV, hd), positions (B, Sq) / (B, T) int32 with
``2^30`` marking an unwritten slot.  CPU tensors take the plain version
(:mod:`.ref`, the model's chunked attention); CUDA tensors launch the
kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import INT, PTR, CudaKernel, check_cuda
from repro_torch.kernels.flash_attention.ref import chunked_attention

KERNEL = CudaKernel("flash_attention", "flash_attention.cu", {
    "flash_attention_launch": [PTR] * 6 + [INT] * 10,
})

MAX_HD = 288        # output columns a lane holds: 9 × 32 (csrc)
MAX_G = 32          # one warp a query group, at most 32 warps a block
_TYPES = (torch.float32, torch.bfloat16)


def _flash_attention_cuda(q, k, v, q_pos, kv_pos, window, prefix_len):
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
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    qp = q_pos.to(torch.int32).contiguous()
    kp = kv_pos.to(torch.int32).contiguous()
    check_cuda(q, k, v, qp, kp)
    out = torch.empty_like(q)
    if Sq == 0 or B * KV == 0:
        return out
    KERNEL.launch("flash_attention_launch", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), qp.data_ptr(), kp.data_ptr(), out.data_ptr(),
                  B, Sq, T, KV, G, hd, int(window), int(prefix_len),
                  int(q.dtype == torch.bfloat16),
                  int(k.dtype == torch.bfloat16))
    return out


def flash_attention(q, k, v, q_pos, kv_pos, *, window: int = 0,
                    prefix_len: int = 0) -> torch.Tensor:
    """GQA attention with causal / window / prefix masks from positions;
    returns (B, Sq, KV, G, hd) in q's type."""
    if q.device.type == "cpu":
        return chunked_attention(q, k, v, q_pos, kv_pos, window=window,
                                 prefix_len=prefix_len)
    return _flash_attention_cuda(q, k, v, q_pos, kv_pos, window, prefix_len)
