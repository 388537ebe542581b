"""The gradient of the port's flash attention (``kernels.flash_attention.
ops.FlashAttention``) on the CPU against ``jax.grad`` of the JAX package's
``chunked_attention`` under causal, window and prefix-LM masks, in f32:
dq, dk and dv within 1e-5 of each gradient's largest magnitude (both are
autodiff of the same chunked online softmax, summed in other orders).
The kernel's backward is held to the plain version on the card
(``tests/test_torch_cuda_kernels.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as j_attn
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref


def _inputs(B, S, KV, G, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, KV, G, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    do = rng.normal(size=(B, S, KV, G, hd)).astype(np.float32)
    pos = np.ascontiguousarray(
        np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)))
    return q, k, v, do, pos


@pytest.mark.parametrize("S,KV,G,hd,window,prefix,q_chunk", [
    (24, 2, 3, 16, 0, 0, 512),          # causal
    (40, 1, 4, 8, 7, 0, 512),           # sliding window
    (30, 2, 2, 8, 0, 11, 512),          # prefix-LM
    (48, 1, 3, 8, 0, 0, 16),            # several query chunks
])
def test_flash_grad_matches_jax(S, KV, G, hd, window, prefix, q_chunk):
    q, k, v, do, pos = _inputs(2, S, KV, G, hd, S)

    def f(q, k, v):
        return j_attn.chunked_attention(q, k, v, pos, pos, window=window,
                                        prefix_len=prefix, q_chunk=q_chunk)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    tp = torch.tensor(pos)
    out = ops.flash_attention(*leaves, tp, tp, window=window,
                              prefix_len=prefix)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, torch.tensor(do))
    for a, b in zip(got, want):
        b = np.asarray(b)
        err = float(np.abs(a.numpy() - b).max())
        assert err <= 1e-5 * float(np.abs(b).max()), err
    plain = attention_bwd_ref(*(torch.tensor(a) for a in (q, k, v)), tp, tp,
                              torch.tensor(do), window=window,
                              prefix_len=prefix)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


def test_no_grad_path_is_the_forward_alone():
    q, k, v, _, pos = _inputs(1, 12, 1, 2, 8, 0)
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    tp = torch.tensor(pos)
    out = ops.flash_attention(tq, tk, tv, tp, tp)
    assert out.grad_fn is None
    with torch.no_grad():
        tq.requires_grad_()
        assert ops.flash_attention(tq, tk, tv, tp, tp).grad_fn is None
