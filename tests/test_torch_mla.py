"""The port's multi-head latent attention (``attention.mla_attention``,
absorbed form) against the JAX package's on the CPU, on the reduced
deepseek-v3 config (4 heads, kv_lora 16, rope 8, nope 16, v 16), with the
same weights and inputs on both sides (NumPy, seeded).  On the CPU the
latent attention runs K6's plain version (the chunked attention).

Tolerances (f32): outputs within 1e-5; the latent cache exact in
positions, within 1e-5 in ``ckv`` and ``krope``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import attention as j_attn
from repro_torch.configs import get_arch
from repro_torch.models import attention as t_attn
from repro_torch.models.params import tree_map

ARCH = "deepseek-v3-671b"
j_mla = jax.jit(j_attn.mla_attention, static_argnums=1)


@pytest.fixture(scope="module")
def weights():
    """(jax cfg, port cfg, jax params, port params): f32, one layer's MLA
    weights from the port's spec shapes, normal × 0.2 (norms at 1 ± 0.2)."""
    jcfg = dataclasses.replace(j_get_arch(ARCH).reduced,
                               compute_dtype="float32")
    tcfg = dataclasses.replace(get_arch(ARCH).reduced,
                               compute_dtype="float32")
    rng = np.random.default_rng(0)
    p = tree_map(lambda s: ((1.0 if s.init == "ones" else 0.0)
                            + rng.normal(size=s.shape) * 0.2)
                 .astype(np.float32), t_attn.mla_specs(tcfg))
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, p),
            tree_map(torch.tensor, p))


def test_mla_specs_match_jax():
    """The same parameter names and shapes as the JAX package's."""
    from repro.models.params import ParamSpec as JSpec

    for which in ("reduced", "config"):
        want = jax.tree.map(lambda s: s.shape, j_attn.mla_specs(
            getattr(j_get_arch(ARCH), which)),
            is_leaf=lambda s: isinstance(s, JSpec))
        got = tree_map(lambda s: s.shape, t_attn.mla_specs(
            getattr(get_arch(ARCH), which)))
        assert got == want


@pytest.mark.parametrize("window,prefix", [(0, 0), (6, 0), (0, 5)])
def test_mla_without_cache_matches_jax(weights, window, prefix):
    """Prefill-style attention over the sequence's own latents, with the
    causal, window and prefix masks."""
    jcfg, tcfg, jp, tp = weights
    B, S = 2, 13
    x = np.random.default_rng(1).normal(size=(B, S, tcfg.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    yj, cj = j_attn.mla_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                  window=window, prefix_len=prefix)
    yt, ct = t_attn.mla_attention(tp, tcfg, torch.tensor(x),
                                  torch.tensor(pos), window=window,
                                  prefix_len=prefix)
    assert cj is None and ct is None
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5,
                               rtol=1e-5)


def test_mla_with_cache_matches_jax(weights):
    """A prefill of 10 positions into the latent cache, then 6
    single-token steps: outputs within 1e-5; the cache (``ckv``,
    ``krope``, ``pos``) written in place, equal to JAX's."""
    jcfg, tcfg, jp, tp = weights
    B, L = 3, 20
    x = np.random.default_rng(2).normal(size=(B, 16, tcfg.d_model)).astype(
        np.float32)
    jc = j_attn.init_mla_cache(jcfg, B, L, jnp.float32)
    tc = t_attn.init_mla_cache(tcfg, B, L, torch.float32, "cpu")
    m = tcfg.mla
    assert {k: tuple(v.shape) for k, v in tc.items()} == dict(
        ckv=(B, L, m.kv_lora_rank), krope=(B, L, m.qk_rope_dim), pos=(B, L))
    ckv = tc["ckv"]
    for lo, hi in [(0, 10)] + [(i, i + 1) for i in range(10, 16)]:
        pos = np.broadcast_to(np.arange(lo, hi, dtype=np.int32),
                              (B, hi - lo)).copy()
        yj, jc = j_mla(jp, jcfg, jnp.asarray(x[:, lo:hi]),
                       jnp.asarray(pos), cache=jc)
        yt, tc = t_attn.mla_attention(tp, tcfg, torch.tensor(x[:, lo:hi]),
                                      torch.tensor(pos), cache=tc)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5,
                                   rtol=1e-5)
    assert tc["ckv"] is ckv                      # updated in place
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for f in ("ckv", "krope"):
        np.testing.assert_allclose(tc[f].numpy(), np.asarray(jc[f]),
                                   atol=1e-5, rtol=1e-5)


def test_mla_latent_attention_shape_and_zero_values(weights, monkeypatch):
    """The latent attention is one "kv head" of G = H query heads at
    hd = kv_lora + rope, its values ``[ckv | 0]``: the output's rope
    columns are zero and only the first kv_lora columns are kept."""
    from repro_torch.kernels.flash_attention import ops as fops

    _, tcfg, _, tp = weights
    seen = []
    real = t_attn.flash_attention

    def spy(q, k, v, *a, **kw):
        out = real(q, k, v, *a, **kw)
        seen.append((tuple(q.shape), tuple(k.shape), v, out))
        return out

    monkeypatch.setattr(t_attn, "flash_attention", spy)
    x = torch.randn(2, 7, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(3))
    pos = torch.arange(7, dtype=torch.int32)[None].expand(2, 7)
    t_attn.mla_attention(tp, tcfg, x, pos)
    (qs, ks, v, out), = seen
    m, H = tcfg.mla, tcfg.num_heads
    latent = m.kv_lora_rank + m.qk_rope_dim
    assert qs == (2, 7, 1, H, latent) and ks == (2, 7, 1, latent)
    assert float(v[..., m.kv_lora_rank:].abs().max()) == 0.0
    assert float(out[..., m.kv_lora_rank:].abs().max()) == 0.0
    assert fops.flash_form(2, 7, 7, 1, H, latent, torch.float32,
                           torch.float32) == "split"
    full = get_arch(ARCH).config
    assert fops.flash_form(4, 1, 528, 1, full.num_heads,
                           full.mla.kv_lora_rank + full.mla.qk_rope_dim,
                           torch.bfloat16, torch.bfloat16) == "simt"
