"""Serving over ranks: prefill and greedy decode of every reduced family
with each rank holding only its blocks, on the CPU.

Four ``gloo`` ranks are spawned once (``launch.mesh.run_ranks``, one
intra-op thread a rank, a hard time limit; ``tests/tp_serving_ranks.py``
imports no JAX).  On ``(data 2, model 2)`` and ``(model 4)`` each rank
holds its blocks of the parameters (``sharding.train_placements`` under
the cache paths' profile, ``transformer.serving_layout``) and of the
cache (``transformer.init_cache(mesh=...)``: the JAX rules' cache
placement, batch over ``"data"``, slots and recurrent-state heads over
``"model"``), prefills 14 positions from 0 and decodes 8 greedy ticks
past the 16-slot rings (``tp_serving_ranks.greedy_generate``).  Held here:

  * the prefill's and every tick's logits (every row, every vocabulary
    block, on every rank) within 1e-5 of the largest magnitude, against
    the one-process port and the JAX package's unsharded ``prefill`` /
    ``decode_step`` fed the same tokens;
  * the greedy tokens equal the one-process port's on every rank;
  * each rank's cache equals its ``local_block`` of the one-process
    cache after the same ticks (positions exactly, the rest within 1e-5);
    the ranks' blocks gathered into the JAX layout
    (``interop.cache_to_numpy(mesh=...)``) equal the JAX package's cache,
    and ``interop.cache_from_numpy(mesh=...)`` cuts the same blocks back;
  * decode attention from K6's partials of each rank's block of the
    slots, gathered over ``"model"`` and merged, bit for bit the
    one-process split form (``ref.split_attention``) where the rank
    blocks are whole key splits.
"""
import concurrent.futures
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import transformer as jt
from repro_torch import interop
from repro_torch.distributed import sharding
from repro_torch.distributed.mesh import ShardMesh
from repro_torch.kernels.flash_attention.ref import split_attention
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import transformer
from repro_torch.models.params import tree_leaves
from tests import tp_serving_ranks as rk
from tests.test_torch_tensor_parallel import _jax_params

CPU = "cpu"
W = 4
TIMEOUT = 150.0          # seconds the spawn of the ranks may take, whole
MESHES = {"dm": dict(data=2, model=2), "m4": dict(model=4)}
ARCHS = ["deepseek-v3-671b", "gemma3-1b", "gemma3-27b", "hymba-1.5b",
         "llama4-scout-17b-a16e", "musicgen-medium", "paligemma-3b",
         "qwen1.5-110b", "smollm-135m", "xlstm-125m"]
CASES = [(a, m) for a in ARCHS for m in MESHES]
KPS = 32                 # the partials case's key split: T / M is whole

j_prefill = jax.jit(jt.prefill, static_argnums=1)
j_decode = jax.jit(jt.decode_step, static_argnums=1)


def _prompt(arch, seed):
    """The prompt batch (tokens, or the frontend's embeddings) of 14
    positions from 0, and the audio frontend's frame embeddings for the
    decode ticks."""
    cfg = rk.serve_cfg(arch)
    rng = np.random.default_rng(seed)
    pos = np.broadcast_to(np.arange(rk.PLEN, dtype=np.int32),
                          (rk.B, rk.PLEN)).copy()
    tok = rng.integers(0, cfg.vocab_size, (rk.B, rk.PLEN)).astype(np.int32)
    if cfg.frontend == "audio_stub":
        emb = rng.normal(size=(rk.B, rk.PLEN + rk.TICKS, cfg.d_model)
                         ).astype(np.float32)
        return dict(batch=dict(embeds=emb[:, :rk.PLEN], positions=pos),
                    embeds=emb[:, rk.PLEN:])
    if cfg.frontend == "vision_stub":
        pv = cfg.vision_prefix
        emb = rng.normal(size=(rk.B, pv, cfg.d_model)).astype(np.float32)
        return dict(batch=dict(embeds=emb, tokens=tok[:, :rk.PLEN - pv],
                               positions=pos), embeds=None)
    return dict(batch=dict(tokens=tok, positions=pos), embeds=None)


def _partials_inputs():
    rng = np.random.default_rng(7)
    B, T, KV, G, hd = 3, 256, 2, 4, 16
    q_pos = np.array([[255], [130], [40]], np.int32)
    kv_pos = np.where(np.arange(T)[None] <= q_pos, np.arange(T)[None],
                      2 ** 30).astype(np.int32)
    return dict(q=rng.normal(size=(B, 1, KV, G, hd)).astype(np.float32),
                k=rng.normal(size=(B, T, KV, hd)).astype(np.float32),
                v=rng.normal(size=(B, T, KV, hd)).astype(np.float32),
                q_pos=q_pos, kv_pos=kv_pos, keys_per_split=KPS)


@functools.lru_cache(maxsize=None)
def _inputs():
    return dict(archs=ARCHS, meshes=MESHES,
                params={a: _jax_params(a) for a in ARCHS},
                prompts={a: _prompt(a, i) for i, a in enumerate(ARCHS)},
                partials=_partials_inputs())


def _torch(d):
    return {k: None if v is None else torch.tensor(v) for k, v in d.items()}


@functools.lru_cache(maxsize=None)
def _one_process(arch):
    """The one-process port: tokens, logits and the cache after."""
    cfg = rk.serve_cfg(arch)
    inp = _inputs()
    params = interop.params_from_numpy(inp["params"][arch], cfg, device=CPU)
    prompt = inp["prompts"][arch]
    cache = transformer.init_cache(cfg, rk.B, rk.MAX_LEN, torch.float32, CPU)
    emb = prompt["embeds"]
    with torch.no_grad():
        tokens, logits = rk.greedy_generate(
            params, cfg, _torch(prompt["batch"]), cache, rk.TICKS,
            embeds=None if emb is None else torch.tensor(emb))
    return tokens.numpy(), torch.stack(logits).numpy(), cache


@functools.lru_cache(maxsize=None)
def _jax(arch):
    """The JAX package's unsharded prefill and decode steps, fed the
    one-process port's greedy tokens: the logits, (ticks + 1, B, V), and
    the cache after (NumPy)."""
    jcfg = dataclasses.replace(j_get_arch(arch).reduced,
                               compute_dtype="float32")
    inp = _inputs()
    tokens, _, _ = _one_process(arch)
    p = jax.tree.map(jnp.asarray, inp["params"][arch])
    prompt = inp["prompts"][arch]
    batch = {k: jnp.asarray(v) for k, v in prompt["batch"].items()}
    batch.setdefault("tokens", None)
    cache = jt.init_cache(jcfg, rk.B, rk.MAX_LEN, jnp.float32)
    lg, cache = j_prefill(p, jcfg, batch, cache)
    out = [np.asarray(lg[:, -1])]
    for i in range(rk.TICKS):
        index = jnp.int32(rk.PLEN + i)
        if prompt["embeds"] is not None:
            lg, cache = j_decode(p, jcfg, None, index, cache,
                                 jnp.asarray(prompt["embeds"][:, i:i + 1]))
        else:
            lg, cache = j_decode(p, jcfg, jnp.asarray(
                tokens[:, i:i + 1].astype(np.int32)), index, cache)
        out.append(np.asarray(lg[:, 0]))
    return np.stack(out), jax.tree.map(np.asarray, cache)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(inputs, every rank's results): one spawn of 4 ranks for all."""
    inputs = _inputs()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        refs = [pool.submit(_one_process, a) for a in ARCHS]
        out = run_ranks(rk.all_cases, W, args=(inputs,), device=CPU,
                        transport="gloo", timeout=TIMEOUT,
                        workdir=str(tmp_path_factory.mktemp("serve-ranks")))
        for f in refs:
            f.result()
    assert [r["rank"] for r in out] == list(range(W))
    assert all(o["ambient"] for o in out)
    return inputs, out


def _close(a, b, rel, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max() if a.size else 0.0
    assert err <= rel * max(np.abs(b).max(), 1e-6), f"{what}: {err}"


@pytest.mark.parametrize("arch,mesh", CASES)
def test_logits_and_tokens_equal_the_one_process_port(ranks, arch, mesh):
    _, out = ranks
    tokens, logits, _ = _one_process(arch)
    for r, o in enumerate(out):
        got = o["serve"][(arch, mesh)]
        _close(got["logits"], logits, 1e-5, (arch, mesh, r))
        np.testing.assert_array_equal(got["tokens"], tokens,
                                      err_msg=(arch, mesh, r))


@pytest.mark.parametrize("arch,mesh", CASES)
def test_logits_equal_the_jax_package(ranks, arch, mesh):
    """Against JAX's unsharded prefill and decode steps fed the same
    tokens (or frame embeddings)."""
    _, out = ranks
    want, _ = _jax(arch)
    for r, o in enumerate(out):
        _close(o["serve"][(arch, mesh)]["logits"], want, 1e-5,
               (arch, mesh, "jax", r))


@pytest.mark.parametrize("arch,mesh", CASES)
def test_each_rank_holds_its_block_of_the_cache(ranks, arch, mesh):
    """After the ticks each rank's cache is its block of the one-process
    cache under ``cache_placements``: the blocks' shapes, positions
    exactly, k/v, latents and recurrent states within 1e-5; every
    attention cache is split by its slots over "model", and a cache leaf
    the rules split is held whole by no rank."""
    _, out = ranks
    _, _, whole = _one_process(arch)
    smesh = ShardMesh(device=CPU, axes=MESHES[mesh])
    place = sharding.cache_placements(whole, smesh, "2d")
    leaves = tree_leaves(whole)
    places = []
    sharding.tree_map(lambda _, p: places.append(p), whole, place)
    kv = [p for layer in place for p in layer.get("kv", {}).values()]
    assert all("model" in p.axes() for p in kv), (arch, mesh)
    for r, o in enumerate(out):
        got = o["serve"][(arch, mesh)]["cache"]
        assert len(got) == len(leaves)
        for i, (g, w, p) in enumerate(zip(got, leaves, places)):
            want = sharding.local_block(w, p, smesh, shard=r).numpy()
            assert g.shape == want.shape, (arch, mesh, r, i)
            if p.axes():
                assert g.shape != tuple(w.shape), (arch, mesh, r, i)
            if w.dtype == torch.int32:
                np.testing.assert_array_equal(g, want,
                                              err_msg=(arch, mesh, r, i))
            else:
                _close(g, want, 1e-5, (arch, mesh, r, i))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_decode_partials_over_rank_blocks_equal_the_split_form(ranks, mesh):
    """Each rank's block of 256 slots (128 or 64 a rank, whole splits of
    32 keys): the ranks' partials gathered rank-major and merged equal the
    one-process split form bit for bit, on every rank."""
    inputs, out = ranks
    inp = inputs["partials"]
    want = split_attention(*(torch.tensor(inp[n]) for n in
                             ("q", "k", "v", "q_pos", "kv_pos")),
                           keys_per_split=KPS).numpy()
    for r, o in enumerate(out):
        np.testing.assert_array_equal(o["partials"][mesh], want,
                                      err_msg=(mesh, r))


@pytest.mark.parametrize("arch,mesh", CASES)
def test_gathered_cache_equals_the_jax_package(ranks, arch, mesh):
    """The ranks' cache blocks gathered whole in the JAX package's stacked
    layout equal the JAX cache after the same steps (positions exactly,
    the rest within 1e-5), and cut back into blocks they are each rank's
    own bit for bit."""
    _, out = ranks
    _, want = _jax(arch)
    got = out[0]["serve"][(arch, mesh)]["whole"]
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for key in path:
            g = g[key.key if hasattr(key, "key") else key.idx]
        if path[-1].key == "pos":
            np.testing.assert_array_equal(g, w, err_msg=(arch, mesh, path))
        else:
            _close(g, w, 1e-5, (arch, mesh, path))
    assert all(o["serve"][(arch, mesh)]["round_trip"] for o in out)


def test_prefill_over_ranks_into_a_used_cache_raises():
    """A prefill over ranks attends over the prompt's own keys, so its
    rows must start at position 0; one that starts later (a cache already
    holding keys) raises rather than miss them.  Rank 0 of a trace mesh
    runs the rank code on real tensors."""
    from repro_torch.distributed.mesh import TraceMesh

    cfg = rk.serve_cfg("gemma3-1b")
    mesh = TraceMesh(dict(model=2))
    params = interop.params_from_numpy(_jax_params("gemma3-1b"), cfg,
                                       device=CPU, mesh=mesh)
    cache = transformer.init_cache(cfg, 2, 16, torch.float32, CPU,
                                   mesh=mesh)
    pos = torch.arange(3, 9, dtype=torch.int32)[None].expand(2, 6)
    batch = dict(tokens=torch.ones((2, 6), dtype=torch.int32),
                 positions=pos.contiguous())
    with torch.no_grad(), sharding.use_mesh(mesh):
        with pytest.raises(NotImplementedError, match="position 0"):
            transformer.prefill(params, cfg, batch, cache)
        batch["positions"] = batch["positions"] - 3
        logits, _ = transformer.prefill(params, cfg, batch, cache)
    assert logits.shape == (2, 1, cfg.vocab_size)
