"""The flash-attention kernel's plain version (``repro_torch.kernels.
flash_attention``) against the JAX package on the CPU: the Pallas kernel in
interpret mode and the model's ``chunked_attention``, on the same numpy
inputs.  Tolerances as the JAX kernel test's: 2e-3 f32, 2e-2 bf16."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.models.attention import chunked_attention as j_chunked
from repro_torch import kernels
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import (POS_SENTINEL,
                                                     chunked_attention,
                                                     direct_attention)

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-3


def _inputs(B, Sq, T, KV, G, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, KV, G, hd)).astype(np.float32)
    k = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(Sq, dtype=np.int32) + (T - Sq),
                           (B, Sq)).copy()
    kpos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    return q, k, v, qpos, kpos


def _both(q, k, v, qpos, kpos, dtype, qdtype=None):
    """The same arrays as JAX and torch inputs (q may take its own type)."""
    jd, td = DT[dtype]
    jq, tq = DT[qdtype or dtype]
    j = (jnp.asarray(q, jq), jnp.asarray(k, jd), jnp.asarray(v, jd),
         jnp.asarray(qpos), jnp.asarray(kpos))
    t = (torch.tensor(q).to(tq), torch.tensor(k).to(td),
         torch.tensor(v).to(td), torch.tensor(qpos), torch.tensor(kpos))
    return j, t


def _close(got, want, dtype):
    tol = _tol(dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("B,Sq,T,KV,G,hd,window,prefix,dtype", [
    (2, 64, 64, 2, 3, 16, 0, 0, "float32"),
    (1, 128, 128, 1, 4, 32, 0, 0, "float32"),
    (2, 64, 64, 2, 2, 16, 24, 0, "float32"),
    (1, 48, 48, 2, 2, 16, 0, 16, "float32"),
    (2, 96, 96, 3, 1, 16, 0, 0, "bfloat16"),
    (1, 40, 72, 2, 2, 8, 0, 0, "float32"),   # Sq != T, ragged blocks
])
def test_plain_matches_pallas_interpret_and_chunked(B, Sq, T, KV, G, hd,
                                                    window, prefix, dtype):
    """The JAX kernel test's six shapes (window, prefix, bf16, Sq != T,
    ragged blocks): the port's plain version within the JAX test's
    tolerance of ``flash_attention_pallas(interpret=True)``, and equal to
    within one f32 rounding of JAX's ``chunked_attention``."""
    j, t = _both(*_inputs(B, Sq, T, KV, G, hd, Sq + T), dtype)
    got = fops.flash_attention(*t, window=window, prefix_len=prefix)
    assert got.dtype == DT[dtype][1] and got.shape == (B, Sq, KV, G, hd)
    pallas = flash_attention_pallas(*j, window=window, prefix_len=prefix,
                                    q_block=32, kv_block=32, interpret=True)
    _close(got, pallas, dtype)
    want = j_chunked(*j, window=window, prefix_len=prefix)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=1e-5, rtol=1e-5)


def test_plain_cache_sentinels_match_pallas():
    """Unwritten cache slots (sentinel positions) contribute nothing."""
    B, Sq, T, KV, G, hd = 1, 16, 64, 1, 2, 16
    q, k, v, qpos, _ = _inputs(B, Sq, T, KV, G, hd, 0)
    qpos = np.broadcast_to(np.arange(Sq, dtype=np.int32), (B, Sq)).copy()
    kpos = np.where(np.arange(T) < Sq, np.arange(T), 2 ** 30)
    kpos = np.broadcast_to(kpos.astype(np.int32), (B, T)).copy()
    j, t = _both(q, k, v, qpos, kpos, "float32")
    got = fops.flash_attention(*t)
    _close(got, flash_attention_pallas(*j, q_block=16, kv_block=16,
                                       interpret=True), "float32")
    _close(got, j_chunked(j[0], j[1][:, :Sq], j[2][:, :Sq], j[3],
                          j[4][:, :Sq]), "float32")


@pytest.mark.parametrize("dtype,window", [("float32", 0),
                                          ("bfloat16", 0),
                                          ("float32", 24)])
def test_plain_decode_matches_pallas_and_direct(dtype, window):
    """Sq = 1 (decode) takes the plain version's direct branch, which
    normalizes p before the PV product; the Pallas kernel divides after."""
    B, T, KV, G, hd = 3, 80, 2, 3, 16
    q, k, v, _, kpos = _inputs(B, 1, T, KV, G, hd, 5)
    qpos = np.array([[79], [50], [30]], np.int32)
    kpos = np.where(kpos <= qpos, kpos, POS_SENTINEL).astype(np.int32)
    j, t = _both(q, k, v, qpos, kpos, dtype)
    got = fops.flash_attention(*t, window=window)
    _close(got, flash_attention_pallas(*j, window=window, q_block=8,
                                       kv_block=32, interpret=True), dtype)
    want = j_chunked(*j, window=window)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=1e-5,
                               rtol=1e-5)
    assert torch.equal(got, direct_attention(*t, window=window))


@pytest.mark.parametrize("window", [64, 40])
def test_plain_wrapped_ring_matches_chunked(window):
    """A window ring read after decode passed it: slot s holds the latest
    position p <= q with p = s (mod T), so slots are out of position
    order.  Every query row sits at its own position; Pallas in interpret
    mode visits every slot there (its causal bound exceeds T)."""
    B, T, KV, G, hd = 3, 64, 1, 4, 32
    q, k, v, _, _ = _inputs(B, 1, T, KV, G, hd, 9)
    last = np.array([[150], [70], [40]], np.int32)
    s = np.arange(T, dtype=np.int32)[None]
    kpos = np.where(s <= last, s + (last - s) // T * T,
                    POS_SENTINEL).astype(np.int32)
    for dtype in ("float32", "bfloat16"):
        j, t = _both(q, k, v, last, kpos, dtype)
        got = fops.flash_attention(*t, window=window)
        _close(got, j_chunked(*j, window=window), dtype)
        _close(got, flash_attention_pallas(*j, window=window, q_block=8,
                                           kv_block=16, interpret=True),
               dtype)


def test_plain_mixed_types_match_chunked():
    """A bf16 model over an f32 cache: q bf16, k/v f32; out in q's type."""
    q, k, v, qpos, kpos = _inputs(2, 20, 30, 1, 2, 16, 3)
    j, t = _both(q, k, v, qpos, kpos, "float32", qdtype="bfloat16")
    got = fops.flash_attention(*t, window=12)
    assert got.dtype == torch.bfloat16
    _close(got, j_chunked(*j, window=12), "bfloat16")


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing (a CUDA tensor launches the kernel or raises)."""
    t = [torch.tensor(a) for a in _inputs(1, 12, 12, 1, 2, 8, 1)]
    before = kernels.launch_counts()["flash_attention"]
    assert torch.equal(fops.flash_attention(*t, window=5),
                       chunked_attention(*t, window=5))
    assert kernels.launch_counts()["flash_attention"] == before
