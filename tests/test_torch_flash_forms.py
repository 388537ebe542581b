"""The flash-attention kernel's forms on the CPU: the plain version of the
split form's arithmetic (``ref.split_attention``: per-split (m, l, o)
partials, then the merge in split order) against the JAX package's
``chunked_attention`` and ``flash_attention_pallas`` in interpret mode on
the same numpy inputs, at the JAX kernel test's f32 tolerance (2e-3); and
the rule that picks a form from shapes and types."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.models.attention import chunked_attention as j_chunked
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import (POS_SENTINEL,
                                                     split_attention,
                                                     split_partials,
                                                     visit_end)

TOL = 2e-3


def _inputs(B, Sq, T, KV, G, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, KV, G, hd)).astype(np.float32)
    k = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, T, KV, hd)).astype(np.float32)
    return q, k, v


def _ring(last, T):
    """Slot positions of a cache after writing 0..last (B, 1): slot s holds
    the latest position p <= last with p = s (mod T); unwritten slots hold
    the sentinel."""
    s = np.arange(T, dtype=np.int64)[None]
    return np.where(s <= last, s + (last - s) // T * T,
                    POS_SENTINEL).astype(np.int32)


def _check(q, k, v, qpos, kpos, *, keys_per_split, window=0, prefix=0,
           against_chunked=True):
    """The split form's plain version within 2e-3 of Pallas in interpret
    mode (q blocks of the kernel's row groups, 32-key blocks: the same
    visited keys) and, where every row has an allowed key, of JAX's
    chunked attention."""
    t = [torch.tensor(a) for a in (q, k, v, qpos, kpos)]
    got = split_attention(*t, window=window, prefix_len=prefix,
                          keys_per_split=keys_per_split)
    assert got.shape == q.shape and got.dtype == torch.float32
    j = [jnp.asarray(a) for a in (q, k, v, qpos, kpos)]
    Sq, G = q.shape[1], q.shape[3]
    pallas = flash_attention_pallas(*j, window=window, prefix_len=prefix,
                                    q_block=max(1, min(Sq, 16 // G)),
                                    kv_block=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=TOL,
                               rtol=TOL)
    if against_chunked:
        want = j_chunked(*j, window=window, prefix_len=prefix)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)
    return got


@pytest.mark.parametrize("T,keys_per_split,last", [
    (96, 96, [95, 50, 20]),          # one split
    (96, 32, [95, 40, 10]),          # 3 splits, row 2's last wholly past
    (256, 32, [255, 100, 3]),        # 8 splits, most past rows 1 and 2
    (100, 32, [99, 70, 33]),         # T not a multiple of the split
    (200, 64, [199, 64, 150]),       # 4 splits of 64, the last of 8 keys
])
def test_split_reference_decode_matches_pallas_and_chunked(T, keys_per_split,
                                                           last):
    B, KV, G, hd = 3, 2, 3, 16
    q, k, v = _inputs(B, 1, T, KV, G, hd, T + keys_per_split)
    qpos = np.array(last, np.int32)[:, None]
    kpos = np.where(np.arange(T)[None] <= qpos, np.arange(T)[None],
                    POS_SENTINEL).astype(np.int32)
    _check(q, k, v, qpos, kpos, keys_per_split=keys_per_split)


def test_split_partials_past_the_causal_bound_are_empty():
    """A split wholly past a row's visited keys gives m = -inf, l = 0,
    o = 0, and the merge takes nothing from it."""
    B, T, KV, G, hd = 2, 256, 1, 4, 8
    q, k, v = _inputs(B, 1, T, KV, G, hd, 1)
    qpos = np.array([[255], [5]], np.int32)
    kpos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    t = [torch.tensor(a) for a in (q, k, v, qpos, kpos)]
    assert visit_end(t[3], T, G).tolist() == [[256], [64]]
    m, l, o = split_partials(*t, keys_per_split=32)
    assert m.shape == (8, B, 1, KV, G) and o.shape == (8, B, 1, KV, G, hd)
    assert torch.isinf(m[2:, 1]).all() and (m[2:, 1] < 0).all()
    assert (l[2:, 1] == 0).all() and (o[2:, 1] == 0).all()
    assert torch.isfinite(m[:, 0]).all() and (l[:, 0] > 0).all()
    _check(q, k, v, qpos, kpos, keys_per_split=32)


@pytest.mark.parametrize("keys_per_split", [32, 64])
def test_split_reference_rows_with_no_allowed_key(keys_per_split):
    """A row with no allowed key averages V over the keys it visits (every
    score -1e30), as the single pass and Pallas do; the splits holding only
    masked keys merge as one pass."""
    B, T, KV, G, hd = 2, 128, 1, 2, 16
    q, k, v = _inputs(B, 1, T, KV, G, hd, 2)
    qpos = np.array([[3], [127]], np.int32)
    # row 0's cache holds only later positions: nothing is allowed
    kpos = np.stack([np.arange(T) + 10, np.arange(T)]).astype(np.int32)
    got = _check(q, k, v, qpos, kpos, keys_per_split=keys_per_split,
                 against_chunked=False)
    vis = 64                          # (3 + 32) // 32 + 1 tiles
    want = v[0, :vis].mean(0)         # (KV, hd), every group alike
    np.testing.assert_allclose(got[0, 0].numpy(),
                               np.broadcast_to(want[:, None], (KV, G, hd)),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("window", [64, 40])
def test_split_reference_wrapped_ring(window):
    """A window ring read after decode passed it: slots out of position
    order, every slot visited."""
    B, T, KV, G, hd = 3, 64, 1, 4, 32
    q, k, v = _inputs(B, 1, T, KV, G, hd, 9)
    last = np.array([[150], [70], [40]], np.int32)
    _check(q, k, v, last, _ring(last, T), keys_per_split=32, window=window)


@pytest.mark.parametrize("Sq,G,prefix,window", [
    (8, 4, 0, 0),      # 32 pairs: the most one split block holds
    (8, 2, 20, 0),     # prefix-LM past the first rows
    (16, 2, 0, 24),    # sliding window, two row groups
])
def test_split_reference_short_prefill(Sq, G, prefix, window):
    """Several query rows a block: rows grouped as the kernel's tiles, a
    prefix raising the bound, a window."""
    B, T, KV, hd = 2, 96, 1, 16
    q, k, v = _inputs(B, Sq, T, KV, G, hd, Sq + prefix)
    qpos = np.broadcast_to(np.arange(Sq, dtype=np.int32) + 40,
                           (B, Sq)).copy()
    kpos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    _check(q, k, v, qpos, kpos, keys_per_split=32, window=window,
           prefix=prefix)


@pytest.mark.parametrize("shape,q_dtype,kv_dtype,form", [
    ((4, 1, 1056, 1, 4, 288), "bf16", "bf16", "split"),   # served decode
    ((4, 1, 1056, 1, 4, 288), "f32", "f32", "split"),
    ((2, 1, 90, 1, 4, 288), "bf16", "f32", "split"),      # mixed decode
    ((3, 1, 50, 2, 3, 20), "f32", "f32", "split"),        # hd % 8 != 0
    ((1, 8, 64, 1, 4, 64), "bf16", "bf16", "split"),      # 32 pairs
    ((1, 1, 64, 1, 32, 64), "bf16", "bf16", "split"),     # G = 32
    ((1, 1000, 1056, 1, 4, 288), "bf16", "bf16", "mma"),  # served prefill
    ((1, 9, 64, 1, 4, 16), "bf16", "bf16", "mma"),        # 36 pairs
    ((1, 64, 64, 1, 20, 16), "bf16", "bf16", "mma"),
    ((1, 1000, 1056, 1, 4, 288), "f32", "f32", "simt"),   # f32 prefill
    ((2, 33, 90, 1, 4, 288), "bf16", "f32", "simt"),      # mixed prefill
    ((2, 33, 90, 1, 4, 288), "f32", "bf16", "simt"),
    ((1, 64, 64, 1, 4, 8), "bf16", "bf16", "simt"),       # hd % 16 != 0
    ((1, 64, 64, 1, 4, 40), "bf16", "bf16", "simt"),
    # past the split and mma forms' G <= 32, hd <= 288: MLA's latent
    # attention (G = 128, hd = 576) takes the simt form in decode and
    # prefill, whatever the types
    ((4, 1, 528, 1, 128, 576), "bf16", "bf16", "simt"),
    ((1, 512, 528, 1, 128, 576), "bf16", "bf16", "simt"),
    ((4, 1, 528, 1, 128, 576), "bf16", "f32", "simt"),
    ((1, 1, 64, 1, 4, 320), "bf16", "bf16", "simt"),      # hd > 288
    ((1, 1, 64, 1, 33, 64), "bf16", "bf16", "simt"),      # G > 32
    ((1, 64, 64, 1, 40, 64), "bf16", "bf16", "simt"),
    ((1, 1, 64, 1, 128, 24), "f32", "f32", "simt"),       # reduced MLA
])
def test_flash_form_rule(shape, q_dtype, kv_dtype, form):
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    assert fops.flash_form(*shape, dt[q_dtype], dt[kv_dtype]) == form


@pytest.mark.parametrize("hd,q_dtype,kv_dtype,tensor_cores", [
    (288, "bf16", "bf16", True),      # the served decode
    (64, "bf16", "bf16", True),
    (288, "f32", "f32", False),
    (288, "bf16", "f32", False),
    (288, "f32", "bf16", False),
    (40, "bf16", "bf16", False),      # hd % 16 != 0
])
def test_split_form_partials_kernel(hd, q_dtype, kv_dtype, tensor_cores):
    """The split form's partials come from the tensor-core kernel for bf16
    q and k/v with hd % 16 == 0, else from the FMA kernel."""
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    assert fops.takes_tensor_cores(hd, dt[q_dtype],
                                   dt[kv_dtype]) is tensor_cores


@pytest.mark.parametrize("B,Sq,T,KV,G", [(1, 1000, 1056, 1, 4),
                                         (1, 200, 1056, 1, 4),
                                         (8, 500, 1056, 1, 4),
                                         (2, 37, 100, 2, 3)])
def test_mma_split_keys(B, Sq, T, KV, G):
    """The mma form's key split: whole 32-key tiles covering T, about
    MMA_BLOCKS blocks where the M tiles alone fall short, none where they
    reach it."""
    kps = fops.mma_split_keys(B, Sq, T, KV, G)
    n_split = -(-T // kps)
    m_tiles = B * KV * -(-Sq * G // (16 * fops.MMA_WARPS))
    assert kps % 32 == 0 and n_split * kps >= T
    if m_tiles >= fops.MMA_BLOCKS:
        assert n_split == 1
    else:
        assert m_tiles * (n_split - 1) < fops.MMA_BLOCKS


@pytest.mark.parametrize("B,KV,T", [(4, 1, 1056), (1, 1, 1056), (4, 1, 50),
                                    (64, 1, 1056), (2, 3, 1000)])
def test_split_keys_cover_the_sms(B, KV, T):
    """Whole 32-key tiles a split, splits covering T, and the grid near
    one block an SM where T allows it."""
    kps = fops.split_keys(B, KV, T)
    n_split = -(-T // kps)
    assert kps % 32 == 0 and kps >= 32 and n_split * kps >= T
    tiles = -(-T // 32)
    assert B * KV * n_split >= min(fops.SPLIT_BLOCKS, B * KV * tiles) // 2
    assert n_split == 1 or B * KV * (n_split - 1) < fops.SPLIT_BLOCKS


@pytest.mark.parametrize("form,keys_per_split,dtype,kw", [
    ("split", 0, torch.float32, {}),
    ("split", 48, torch.float32, {}),     # not whole 32-key tiles, < T
    ("mma", -32, torch.bfloat16, {}),
    ("mma", 80, torch.bfloat16, {}),
    ("split", 32, torch.float32, dict(tensor_cores=True)),
    ("mma", 64, torch.float32, {}),       # tensor cores take bf16 only
    ("wgmma", 32, torch.bfloat16, {}),
])
def test_launch_rejects_what_no_kernel_takes(form, keys_per_split, dtype,
                                             kw):
    """The private launch hook checks its settings before it touches a
    device: key splits of whole tiles (or one split), tensor cores only
    for bf16 operands, a known form."""
    q = torch.zeros(2, 1, 1, 4, 64, dtype=dtype)
    k = torch.zeros(2, 100, 1, 64, dtype=dtype)
    qp = torch.zeros(2, 1, dtype=torch.int32)
    kp = torch.zeros(2, 100, dtype=torch.int32)
    with pytest.raises(ValueError, match="split|tensor-core|form"):
        fops._launch(q, k, k, qp, kp, 0, 0, form, keys_per_split, **kw)


@pytest.mark.parametrize("form,G,hd", [
    ("split", 128, 576), ("mma", 128, 576), ("split", 4, 320),
    ("mma", 4, 320), ("split", 33, 64), ("mma", 40, 64),
    ("simt", 129, 64), ("simt", 4, 577),
])
def test_launch_holds_each_forms_limits(form, G, hd):
    """The simt form takes G <= 128 and hd <= 576 (MLA's latent shape);
    the split and mma forms keep G <= 32 and hd <= 288.  Checked before
    any device is touched."""
    assert (fops.MAX_G, fops.MAX_HD) == (128, 576)
    assert (fops.FAST_MAX_G, fops.FAST_MAX_HD) == (32, 288)
    q = torch.zeros(1, 1, 1, G, hd, dtype=torch.bfloat16)
    k = torch.zeros(1, 64, 1, hd, dtype=torch.bfloat16)
    qp = torch.zeros(1, 1, dtype=torch.int32)
    kp = torch.zeros(1, 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="form takes|kernel takes"):
        fops._launch(q, k, k, qp, kp, 0, 0, form, 64)


@pytest.mark.parametrize("shape,q_dtype,kv_dtype,form", [
    ((8, 2048, 2048, 3, 3, 64), "bf16", "bf16", "mma"),   # the training call
    ((2, 300, 300, 3, 3, 64), "bf16", "bf16", "mma"),
    ((1, 70, 70, 2, 4, 128), "bf16", "bf16", "mma"),      # hd at its limit
    ((1, 70, 70, 2, 4, 144), "bf16", "bf16", "simt"),     # past it
    ((1, 70, 70, 1, 32, 16), "bf16", "bf16", "mma"),      # G at its limit
    ((1, 70, 70, 1, 33, 16), "bf16", "bf16", "simt"),     # past it
    ((1, 70, 70, 4, 1, 64), "bf16", "bf16", "mma"),       # G 1
    ((8, 2048, 2048, 3, 3, 64), "f32", "f32", "simt"),    # the f32 configs
    ((2, 64, 64, 3, 3, 64), "bf16", "f32", "simt"),       # mixed types
    ((2, 64, 64, 3, 3, 64), "f32", "bf16", "simt"),
    ((1, 64, 64, 1, 4, 40), "bf16", "bf16", "simt"),      # hd % 16 != 0
    ((1, 64, 64, 2, 16, 168), "bf16", "bf16", "simt"),    # gemma3-27b's hd
    ((1, 512, 512, 1, 128, 576), "bf16", "bf16", "simt"),  # MLA's latents
    ((4, 64, 64, 1, 4, 24), "f32", "f32", "simt"),        # reduced MLA
])
def test_bwd_form_rule(shape, q_dtype, kv_dtype, form):
    """The backward's form from shapes and types alone: mma for bf16 q and
    k/v with hd % 16 == 0, hd <= 128 and G <= 32, simt for the rest."""
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    assert (fops.BWD_MMA_MAX_HD, fops.BWD_MMA_MAX_G) == (128, 32)
    assert fops.bwd_form(*shape, dt[q_dtype], dt[kv_dtype]) == form


@pytest.mark.parametrize("G,hd,dtype,o_dtype,form", [
    (129, 64, torch.float32, torch.float32, None),     # past simt's G 128
    (4, 577, torch.float32, torch.float32, None),      # past simt's hd 576
    (4, 64, torch.float16, torch.float16, None),       # no form takes f16
    (4, 64, torch.bfloat16, torch.float32, None),      # o not in q's type
    (4, 64, torch.float32, torch.float32, "mma"),      # mma takes bf16 only
    (4, 144, torch.bfloat16, torch.bfloat16, "mma"),   # past mma's hd 128
    (33, 64, torch.bfloat16, torch.bfloat16, "mma"),   # past mma's G 32
    (4, 40, torch.bfloat16, torch.bfloat16, "mma"),    # hd % 16 != 0
    (4, 64, torch.bfloat16, torch.bfloat16, "wgmma"),  # no such form
])
def test_flash_attention_bwd_rejects_what_no_form_takes(G, hd, dtype,
                                                        o_dtype, form):
    """The backward raises on what neither form takes, and the private
    hook on a form that does not take the shapes, before any device is
    touched (meta tensors: no data)."""
    q = torch.zeros(1, 8, 1, G, hd, dtype=dtype, device="meta")
    k = torch.zeros(1, 8, 1, hd, dtype=dtype, device="meta")
    o = torch.zeros(1, 8, 1, G, hd, dtype=o_dtype, device="meta")
    p = torch.zeros(1, 8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="backward|q.s type"):
        if form is None:
            fops.flash_attention_bwd(q, k, k, p, p, o, o)
        else:
            fops._launch_bwd(q, k, k, p, p, o, o, 0, 0, form)
