"""The port's LM stack (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package on the CPU, on the reduced gemma3-1b and
smollm-135m configs with the JAX weights carried across
(``repro_torch.interop.params_from_numpy``).

The parity tests compute in f32 (``compute_dtype="float32"``), so they
compare the algorithm and not bf16 rounding: logits within 1e-4, caches
exact in positions and within 1e-5 in k/v.  One bf16 forward is held to
the JAX model test's 2e-2."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import transformer as jt
from repro.models.params import count_params as j_count
from repro.models.params import init_params as j_init
from repro_torch import interop
from repro_torch.configs import get_arch, list_archs
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as tt
from repro_torch.models.params import (count_params, init_params,
                                      tree_leaves)

ARCHS = ["gemma3-1b", "smollm-135m"]


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(j_get_arch(arch).reduced,
                                compute_dtype=dtype),
            dataclasses.replace(get_arch(arch).reduced, compute_dtype=dtype))


@pytest.fixture(scope="module")
def carried():
    """JAX weights (seed 0) of each reduced config, and the same weights
    as the port's parameters on the CPU."""
    out = {}
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        jp = j_init(jt.model_specs(jcfg), 0)
        out[arch] = (jp, interop.params_from_numpy(
            jax.tree.map(np.asarray, jp), tcfg, "cpu"))
    return out


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return tok, pos


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_match_jax(arch):
    """The same published and reduced configs; the full config's
    parameter count equals the JAX spec tree's (no allocation)."""
    assert set(ARCHS) <= set(list_archs())
    for field in ("config", "reduced"):
        assert dataclasses.asdict(getattr(get_arch(arch), field)) == \
            dataclasses.asdict(getattr(j_get_arch(arch), field))
    cfg = get_arch(arch).config
    assert count_params(tt.model_specs(cfg)) == \
        j_count(jt.model_specs(j_get_arch(arch).config))


def test_layers_match_jax():
    """rms_norm (f32 and bf16), RoPE and the gated MLP."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    w = rng.normal(size=16).astype(np.float32)
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(j_layers.rms_norm(jnp.asarray(x, jd),
                                            jnp.asarray(w)), np.float32)
        got = t_layers.rms_norm(torch.tensor(x).to(td), torch.tensor(w))
        assert got.dtype == td
        tol = 1e-6 if td == torch.float32 else 1e-2
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=tol)
    pos = rng.integers(0, 3000, (2, 5)).astype(np.int32)
    want = j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = t_layers.apply_rope(torch.tensor(x), torch.tensor(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    p = {k: rng.normal(size=s).astype(np.float32) * 0.1
         for k, s in (("wi", (16, 24)), ("wg", (16, 24)), ("wo", (24, 16)))}
    h = rng.normal(size=(2, 5, 16)).astype(np.float32)
    want = j_layers.mlp({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(h), jnp.float32)
    got = t_layers.mlp({k: torch.tensor(v) for k, v in p.items()},
                       torch.tensor(h), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("window", [0, 16])
def test_gqa_attention_with_cache_matches_jax(carried, window):
    """A prefill of 12 positions into a cache, then 8 single-token steps
    (with window 16 the ring wraps): outputs within 1e-5, caches exact in
    positions and within 1e-5 in k/v."""
    jcfg, tcfg = _cfgs("gemma3-1b")
    jp, tp = carried["gemma3-1b"]
    jl, tl = jp["unit"][0]["attn"], tp["layers"][0]["attn"]
    jl = jax.tree.map(lambda a: a[0], jl)
    B, D = 2, jcfg.d_model
    x = np.random.default_rng(1).normal(size=(B, 20, D)).astype(np.float32)
    jc = j_attn.init_gqa_cache(jcfg, B, 24, window, jnp.float32)
    tc = t_attn.init_gqa_cache(tcfg, B, 24, window, torch.float32, "cpu")
    for lo, hi in [(0, 12)] + [(i, i + 1) for i in range(12, 20)]:
        pos = np.broadcast_to(np.arange(lo, hi, dtype=np.int32),
                              (B, hi - lo)).copy()
        yj, jc = j_attn.gqa_attention(jl, jcfg, jnp.asarray(x[:, lo:hi]),
                                      jnp.asarray(pos), window=window,
                                      cache=jc)
        yt, tc = t_attn.gqa_attention(tl, tcfg, torch.tensor(x[:, lo:hi]),
                                      torch.tensor(pos), window=window,
                                      cache=tc)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5,
                                   rtol=1e-5)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for f in ("k", "v"):
        np.testing.assert_allclose(tc[f].numpy(), np.asarray(jc[f]),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax(carried, arch):
    """forward, prefill and decode_step logits within 1e-4 of JAX; after
    decoding past gemma's 16-token window, the caches exact in positions
    and within 1e-5 in k/v (``interop.cache_to_numpy``)."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = carried[arch]
    B, S, plen = 2, 22, 14
    tok, pos = _tokens(jcfg, B, S, 0)
    hj, _, _ = jt.forward(jp, jcfg, dict(tokens=jnp.asarray(tok),
                                         positions=jnp.asarray(pos)))
    ht, _ = tt.forward(tp, tcfg, dict(tokens=torch.tensor(tok),
                                      positions=torch.tensor(pos)))
    np.testing.assert_allclose(tt.logits_head(tp, tcfg, ht).numpy(),
                               np.asarray(jt.logits_head(jp, jcfg, hj)),
                               atol=1e-4, rtol=1e-4)
    jc = jt.init_cache(jcfg, B, S + 4, jnp.float32)
    tc = tt.init_cache(tcfg, B, S + 4, torch.float32, "cpu")
    lj, jc = jt.prefill(jp, jcfg, dict(tokens=jnp.asarray(tok[:, :plen]),
                                       positions=jnp.asarray(pos[:, :plen])),
                        jc)
    lt, tc = tt.prefill(tp, tcfg, dict(tokens=torch.tensor(tok[:, :plen]),
                                       positions=torch.tensor(pos[:, :plen])),
                        tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                               rtol=1e-4)
    for i in range(plen, S):
        lj, jc = jt.decode_step(jp, jcfg, jnp.asarray(tok[:, i:i + 1]),
                                jnp.int32(i), jc)
        lt, tc = tt.decode_step(tp, tcfg, torch.tensor(tok[:, i:i + 1]), i,
                                tc)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                                   rtol=1e-4)
    got = interop.cache_to_numpy(tc, tcfg)
    want = jax.tree.map(np.asarray, jc)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for key in path:
            g = g[key.key if hasattr(key, "key") else key.idx]
        if path[-1].key == "pos":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_matches_jax(carried, arch):
    """The configs' own bf16 compute type, at the JAX model test's 2e-2."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jp, tp = carried[arch]
    tok, pos = _tokens(jcfg, 2, 12, 2)
    hj, _, _ = jt.forward(jp, jcfg, dict(tokens=jnp.asarray(tok),
                                         positions=jnp.asarray(pos)))
    ht, _ = tt.forward(tp, tcfg, dict(tokens=torch.tensor(tok),
                                      positions=torch.tensor(pos)))
    assert ht.dtype == torch.bfloat16
    np.testing.assert_allclose(ht.float().numpy(),
                               np.asarray(hj, np.float32), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The JAX model test, on the port alone: greedy-decode logits equal
    the full-forward logits at the same positions (bf16 compute, f32
    cache, 2e-2)."""
    cfg = get_arch(arch).reduced
    params = init_params(tt.model_specs(cfg), 0, device="cpu")
    B, S, plen = 2, 12, 8
    tok, pos = (torch.tensor(a) for a in _tokens(cfg, B, S, 3))
    h, _ = tt.forward(params, cfg, dict(tokens=tok, positions=pos))
    full = tt.logits_head(params, cfg, h).float()
    cache = tt.init_cache(cfg, B, S + 4, torch.float32, "cpu")
    lp, cache = tt.prefill(params, cfg, dict(tokens=tok[:, :plen],
                                             positions=pos[:, :plen]), cache)
    torch.testing.assert_close(lp[:, -1].float(), full[:, plen - 1],
                               atol=2e-2, rtol=2e-2)
    for i in range(plen, S):
        ld, cache = tt.decode_step(params, cfg, tok[:, i:i + 1], i, cache)
        torch.testing.assert_close(ld[:, 0].float(), full[:, i], atol=2e-2,
                                   rtol=2e-2)


def test_init_params_is_seeded_and_shaped():
    cfg = get_arch("smollm-135m").reduced
    specs = tt.model_specs(cfg)
    a = init_params(specs, 3, device="cpu")
    b = init_params(specs, 3, device="cpu")
    assert len(a["layers"]) == cfg.num_layers
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], init_params(specs, 4, "cpu")["embed"])
    assert torch.equal(a["final_norm"], torch.ones(cfg.d_model))
    assert tuple(a["layers"][0]["attn"]["wq"].shape) == \
        (cfg.d_model, cfg.num_heads * cfg.hd)
    assert count_params(specs) == sum(t.numel() for t in tree_leaves(a))


def test_later_slice_blocks_raise():
    """MoE, MLA, SSM and hybrid blocks and training are later slices."""
    jcfg = j_get_arch("llama4-scout-17b-a16e").reduced
    with pytest.raises(NotImplementedError):
        tt.model_specs(jcfg)
    cfg = get_arch("gemma3-1b").reduced
    for kind in ("moe", "hymba", "mlstm", "slstm"):
        with pytest.raises(NotImplementedError):
            tt.init_block_cache(cfg, kind, 1, 8, torch.float32, "cpu")
    with pytest.raises(NotImplementedError):
        tt.loss_fn()
    with pytest.raises(KeyError):
        get_arch("deepseek-v3-671b")
