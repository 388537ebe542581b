"""The port's LM stack (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package on the CPU, on every architecture's reduced
config with the JAX weights carried across
(``repro_torch.interop.params_from_numpy``): GQA and MLA attention, dense,
MoE, hymba and xLSTM blocks, and the audio and vision frontends.

The parity tests compute in f32 (``compute_dtype="float32"``), so they
compare the algorithm and not bf16 rounding: logits within 1e-4, caches
exact in positions and within 1e-5 in every other field (k/v, latents,
recurrent states).  One bf16 forward is held to the JAX model test's
2e-2.  The JAX calls are jitted (the configs are static), so each
compiles once a test."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_arch as j_get_arch
from repro.configs import input_specs as j_input_specs
from repro.configs import materialize_batch as j_materialize
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import transformer as jt
from repro.models.params import count_params as j_count
from repro.models.params import init_params as j_init
from repro_torch import interop
from repro_torch.configs import (SHAPES, get_arch, input_specs, list_archs,
                                 materialize_batch)
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as tt
from repro_torch.models.params import (count_params, init_params,
                                      tree_leaves)

ARCHS = ["deepseek-v3-671b", "gemma3-1b", "gemma3-27b", "hymba-1.5b",
         "llama4-scout-17b-a16e", "musicgen-medium", "paligemma-3b",
         "qwen1.5-110b", "smollm-135m", "xlstm-125m"]

j_prefill = jax.jit(jt.prefill, static_argnums=1)
j_decode = jax.jit(jt.decode_step, static_argnums=1)


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(j_get_arch(arch).reduced,
                                compute_dtype=dtype),
            dataclasses.replace(get_arch(arch).reduced, compute_dtype=dtype))


@pytest.fixture(scope="module")
def carried():
    """``carried(arch)``: JAX weights (seed 0) of the reduced config, and
    the same weights as the port's parameters on the CPU (made once)."""
    made = {}

    def get(arch):
        if arch not in made:
            jcfg, tcfg = _cfgs(arch)
            jp = j_init(jt.model_specs(jcfg), 0)
            made[arch] = (jp, interop.params_from_numpy(
                jax.tree.map(np.asarray, jp), tcfg, "cpu"))
        return made[arch]

    return get


def _tokens(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return tok, pos


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_match_jax(arch):
    """The same published and reduced configs; the full config's
    parameter count equals the JAX spec tree's (no allocation)."""
    assert set(ARCHS) == set(list_archs())
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
    jp, tp = carried("gemma3-1b")
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


def _frontend_batches(cfg, tok, pos, plen, seed):
    """The full-sequence batch and the prefill batch of the first
    ``plen`` positions, as NumPy dicts: tokens alone, or the frontend's
    embeddings (audio: every position; vision: the ``vision_prefix``
    patch embeddings before the text tokens)."""
    B, S = tok.shape
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_stub":
        emb = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
        return (dict(embeds=emb, tokens=None, positions=pos),
                dict(embeds=emb[:, :plen], tokens=None,
                     positions=pos[:, :plen]))
    if cfg.frontend == "vision_stub":
        pv = cfg.vision_prefix
        emb = rng.normal(size=(B, pv, cfg.d_model)).astype(np.float32)
        return (dict(embeds=emb, tokens=tok[:, :S - pv], positions=pos),
                dict(embeds=emb, tokens=tok[:, :plen - pv],
                     positions=pos[:, :plen]))
    return (dict(tokens=tok, positions=pos),
            dict(tokens=tok[:, :plen], positions=pos[:, :plen]))


def _as(batch, fn):
    return {k: None if v is None else fn(v) for k, v in batch.items()}


def _decode_token(cfg, tok, i):
    """The token fed at position i: text positions follow the vision
    prefix."""
    off = cfg.vision_prefix if cfg.frontend == "vision_stub" else 0
    return tok[:, i - off:i - off + 1]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax(carried, arch):
    """forward (with the frontend's embeddings, where the arch has one),
    prefill and decode_step logits within 1e-4 of JAX, and the aux
    channel within 1e-5; after decoding past the 16-token windows, every
    cache field exact in positions and within 1e-5 elsewhere
    (``interop.cache_to_numpy``)."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = carried(arch)
    B, S, plen = 2, 22, 14
    tok, pos = _tokens(jcfg, B, S, 0)
    full, pre = _frontend_batches(jcfg, tok, pos, plen, 1)
    hj, _, aj = jt.forward(jp, jcfg, _as(full, jnp.asarray))
    ht, _, at = tt.forward(tp, tcfg, _as(full, torch.tensor), with_aux=True)
    np.testing.assert_allclose(tt.logits_head(tp, tcfg, ht).numpy(),
                               np.asarray(jt.logits_head(jp, jcfg, hj)),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(at), float(aj), atol=1e-5, rtol=1e-5)
    jc = jt.init_cache(jcfg, B, S + 4, jnp.float32)
    tc = tt.init_cache(tcfg, B, S + 4, torch.float32, "cpu")
    lj, jc = j_prefill(jp, jcfg, _as(pre, jnp.asarray), jc)
    lt, tc = tt.prefill(tp, tcfg, _as(pre, torch.tensor), tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                               rtol=1e-4)
    for i in range(plen, S):
        t = _decode_token(jcfg, tok, i)
        lj, jc = j_decode(jp, jcfg, jnp.asarray(t), jnp.int32(i), jc)
        lt, tc = tt.decode_step(tp, tcfg, torch.tensor(t), i, tc)
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
    jp, tp = carried(arch)
    tok, pos = _tokens(jcfg, 2, 12, 2)
    full, _ = _frontend_batches(jcfg, tok, pos, 10, 2)
    hj, _, _ = jt.forward(jp, jcfg, _as(full, jnp.asarray))
    ht, _ = tt.forward(tp, tcfg, _as(full, torch.tensor))
    assert ht.dtype == torch.bfloat16
    np.testing.assert_allclose(ht.float().numpy(),
                               np.asarray(hj, np.float32), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The JAX model test, on the port alone: the prefill's and each
    greedy decode step's logits equal the full-forward logits at the same
    positions (bf16 compute, f32 cache, 2e-2).  The frontends prefill from
    their embeddings; audio decodes from frame embeddings (the JAX test
    stops after its prefill there), vision from the text tokens."""
    cfg = get_arch(arch).reduced
    params = init_params(tt.model_specs(cfg), 0, device="cpu")
    B, S, plen = 2, 12, 8
    if cfg.frontend == "vision_stub":
        S, plen = cfg.vision_prefix + 4, cfg.vision_prefix + 1
    tok, pos = _tokens(cfg, B, S, 3)
    full, pre = (_as(b, torch.tensor)
                 for b in _frontend_batches(cfg, tok, pos, plen, 3))
    h, _ = tt.forward(params, cfg, full)
    logits = tt.logits_head(params, cfg, h).float()
    cache = tt.init_cache(cfg, B, S + 4, torch.float32, "cpu")
    lp, cache = tt.prefill(params, cfg, pre, cache)
    torch.testing.assert_close(lp[:, -1].float(), logits[:, plen - 1],
                               atol=2e-2, rtol=2e-2)
    for i in range(plen, S):
        if cfg.frontend == "audio_stub":
            ld, cache = tt.decode_step(params, cfg, None, i, cache,
                                       embeds=full["embeds"][:, i:i + 1])
        else:
            ld, cache = tt.decode_step(
                params, cfg, torch.tensor(_decode_token(cfg, tok, i)), i,
                cache)
        torch.testing.assert_close(ld[:, 0].float(), logits[:, i],
                                   atol=2e-2, rtol=2e-2)


def _port_cache_as_jax_shapes(cache, cfg):
    """The port's per-layer cache shapes as the JAX package's stacked
    ``{unit, prefix, suffix}`` tree of (shape, dtype name) leaves."""
    def leaf(t):
        return tuple(t.shape), str(t.dtype).replace("torch.", "")

    n_pre, n_unit = len(cfg.prefix_layers), len(cfg.layer_unit)
    G = cfg.num_groups
    layers = [jax.tree.map(leaf, c, is_leaf=torch.is_tensor)
              for c in cache]
    unit = [jax.tree.map(lambda x: ((G,) + x[0], x[1]), layers[n_pre + i],
                         is_leaf=lambda x: isinstance(x, tuple))
            for i in range(n_unit)] if G else []
    return dict(unit=unit, prefix=layers[:n_pre],
                suffix=layers[len(layers) - len(cfg.suffix_layers):])


def _jax_shapes(tree):
    return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(arch):
    """``input_specs`` of the published config: the same batch entries
    and decode caches (shapes and types, on the meta device, nothing
    allocated) as the JAX package's ``ShapeDtypeStruct`` stand-ins, for
    every shape; ``shape_applicable`` agrees."""
    from repro.configs import shape_applicable as j_applicable
    from repro_torch.configs import shape_applicable

    cfg, jcfg = get_arch(arch).config, j_get_arch(arch).config
    assert set(SHAPES) == set(J_SHAPES)
    for name, shape in SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            J_SHAPES[name])
        ok, why = shape_applicable(arch, name)
        assert ok == j_applicable(arch, name)[0] and bool(why) != ok
        got = input_specs(cfg, shape)
        want = j_input_specs(jcfg, J_SHAPES[name])
        if shape.kind == "decode":
            assert all(t.device.type == "meta"
                       for t in tree_leaves(got["cache"]))
            assert _port_cache_as_jax_shapes(got["cache"], cfg) == \
                _jax_shapes(want["cache"])
            got = dict(got, cache=None)
            want = dict(want, cache=None)
        leaves = jax.tree.map(
            lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
            got, is_leaf=torch.is_tensor)
        assert leaves == _jax_shapes(want)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_materialize_batch_matches_jax_shapes(kind):
    """``materialize_batch`` at a small shape: the JAX package's
    structure, shapes and types, ids within the vocabulary, positions
    0..S-1 and the decode index S-1; seeded."""
    shape = dataclasses.replace(
        next(s for s in SHAPES.values() if s.kind == kind),
        seq_len=12, global_batch=2)
    # the frontends' batches; a decode cache with kv and ssm fields
    archs = (("hymba-1.5b",) if kind == "decode"
             else ("paligemma-3b", "musicgen-medium"))
    for arch in archs:
        cfg = get_arch(arch).reduced
        if cfg.frontend == "vision_stub":
            shape = dataclasses.replace(shape,
                                        seq_len=cfg.vision_prefix + 4)
        got = materialize_batch(cfg, shape, seed=1, device="cpu")
        want = j_materialize(j_get_arch(arch).reduced, shape, seed=1)
        if kind == "decode":
            assert _port_cache_as_jax_shapes(got["cache"], cfg) == \
                _jax_shapes(want["cache"])
            assert int(got["index"]) == int(want["index"]) == 11
            got, want = got["tokens"], want["tokens"]
        else:
            np.testing.assert_array_equal(got["batch"]["positions"],
                                          np.asarray(want["batch"]
                                                     ["positions"]))
            got, want = got["batch"], want["batch"]
        shapes = jax.tree.map(
            lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
            got, is_leaf=torch.is_tensor)
        assert shapes == _jax_shapes(want)
        for t in tree_leaves(got):
            if t.dtype == torch.int32 and t.dim() == 2:
                assert 0 <= int(t.min()) and int(t.max()) < cfg.vocab_size
        again = materialize_batch(cfg, shape, seed=1, device="cpu")
        assert all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(again), tree_leaves(
                       materialize_batch(cfg, shape, seed=1,
                                         device="cpu"))))


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
    """What the serving slice left to the training slice runs now:
    ``loss_fn`` (with the MTP loss) and the expert-parallel a2a body over
    a mesh (``tests/test_torch_train.py`` and ``test_torch_moe_a2a.py``
    hold them to the JAX package); every other block kind builds specs
    and caches, and unknown names still raise."""
    from repro_torch.distributed.mesh import ShardMesh

    cfg = get_arch("llama4-scout-17b-a16e").reduced
    params = init_params(tt.model_specs(cfg), 0, device="cpu")
    tok = torch.arange(8, dtype=torch.int32)[None] % cfg.vocab_size
    loss, m = tt.loss_fn(params, cfg, dict(
        tokens=tok, labels=tok, positions=torch.arange(
            8, dtype=torch.int32)[None]))
    assert bool(torch.isfinite(loss)) and int(m["tokens"]) == 8
    p = params["layers"][0]
    x = torch.randn(1, 4, cfg.d_model)
    for impl in ("auto", "a2a"):
        y, aux = t_moe.moe_ffn(p["moe"], cfg, x, impl=impl,
                               mesh=ShardMesh(2, "cpu"))
        assert y.shape == x.shape and bool(torch.isfinite(aux))
    y, aux = t_moe.moe_ffn(p["moe"], cfg, x, impl="dense", mesh=object())
    assert y.shape == x.shape and float(aux) > 0
    with pytest.raises(ValueError, match="impl"):
        t_moe.moe_ffn(p["moe"], cfg, x, impl="grouped")
    for kind in ("moe", "moe_local", "hymba", "hymba_g", "mlstm", "slstm"):
        assert tt.init_block_cache(cfg, kind, 1, 8, torch.float32, "cpu")
    with pytest.raises(ValueError, match="block kind"):
        tt.init_block_cache(cfg, "retnet", 1, 8, torch.float32, "cpu")
    with pytest.raises(KeyError):
        get_arch("gpt-2")
