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
past the 16-slot rings (``tp_serving_ranks.greedy_generate``).  Two more
cases (``tp_serving_ranks.SERVE``): "U", a cache of 23 slots on (data 2,
model 2), whole on every rank of ``"model"`` but for the 16-slot rings;
"C", on (model 4), the prompt prefilled as 8 positions and then 6 into
the cache that holds them (paligemma: its image prefix, then its text).
Besides the ten families, the 4-head hymba (``tp_serving_ranks.VARIANTS``)
on both meshes ("dm" and "m4").  Held here:

  * the prefill's and every tick's logits (every row, every vocabulary
    block, on every rank) within 1e-5 of the largest magnitude, against
    the one-process port and the JAX package's unsharded ``prefill`` /
    ``decode_step`` fed the same tokens;
  * the greedy tokens equal the one-process port's on every rank (the
    one-process port and JAX fed the same chunks);
  * each rank's cache equals its ``local_block`` of the one-process
    cache after the same ticks (positions exactly, the rest within 1e-5);
    the ranks' blocks gathered into the JAX layout
    (``interop.cache_to_numpy(mesh=...)``) equal the JAX package's cache,
    and ``interop.cache_from_numpy(mesh=...)`` cuts the same blocks back;
  * decode attention from K6's partials of each rank's block of the
    slots, gathered over ``"model"`` and merged, bit for bit the
    one-process split form (``ref.split_attention``) where the rank
    blocks are whole key splits;
  * the SSM parts (hymba's mamba, the xLSTM cells) run head parallel
    on their head block of the state exactly where their heads divide
    over ``"model"``, and are gathered elsewhere.
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
         "qwen1.5-110b", "smollm-135m", "xlstm-125m"] + sorted(rk.VARIANTS)
CASES = [(a, c) for a in ARCHS for c in rk.SERVE
         if a not in rk.VARIANTS or c in MESHES]
SSM_CASES = [(a, c) for a, c in CASES
             if a.startswith(("hymba", "xlstm"))]
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
    return dict(cases=CASES, meshes=MESHES,
                params={a: _jax_params(a) for a in ARCHS},
                prompts={a: _prompt(a, i) for i, a in enumerate(ARCHS)},
                partials=_partials_inputs())


def _torch(d):
    return {k: None if v is None else torch.tensor(v) for k, v in d.items()}


@functools.lru_cache(maxsize=None)
def _one_process(arch, max_len, chunks):
    """The one-process port, a cache of ``max_len`` slots, the prompt
    prefilled in ``chunks``: tokens, logits and the cache after."""
    cfg = rk.serve_cfg(arch)
    inp = _inputs()
    params = interop.params_from_numpy(inp["params"][arch], cfg, device=CPU)
    prompt = inp["prompts"][arch]
    cache = transformer.init_cache(cfg, rk.B, max_len, torch.float32, CPU)
    emb = prompt["embeds"]
    with torch.no_grad():
        tokens, logits = rk.greedy_generate(
            params, cfg, _torch(prompt["batch"]), cache, rk.TICKS,
            embeds=None if emb is None else torch.tensor(emb),
            chunks=chunks)
    return tokens.numpy(), torch.stack(logits).numpy(), cache


@functools.lru_cache(maxsize=None)
def _jax(arch, max_len, chunks):
    """The JAX package's unsharded prefill of the same chunks and decode
    steps, fed the one-process port's greedy tokens: the logits, (ticks +
    1, B, V), and the cache after (NumPy)."""
    jcfg = dataclasses.replace(rk.reduced(arch, j_get_arch),
                               compute_dtype="float32")
    inp = _inputs()
    tokens, _, _ = _one_process(arch, max_len, chunks)
    p = jax.tree.map(jnp.asarray, inp["params"][arch])
    prompt = inp["prompts"][arch]
    cache = jt.init_cache(jcfg, rk.B, max_len, jnp.float32)
    lo = 0
    for n in chunks:
        batch = {k: None if v is None else jnp.asarray(v) for k, v in
                 rk.chunk_of(prompt["batch"], lo, lo + n).items()}
        lg, cache = j_prefill(p, jcfg, batch, cache)
        lo += n
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
        # the references (the one-process port's, then JAX's fed its
        # tokens) while the ranks run; "m4" shares "dm"'s
        refs = [pool.submit(_jax, a, *rk.SERVE[c][1:])
                for a, c in CASES if c != "m4"]
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


@pytest.mark.parametrize("arch,case", CASES)
def test_logits_and_tokens_equal_the_one_process_port(ranks, arch, case):
    _, out = ranks
    tokens, logits, _ = _one_process(arch, *rk.SERVE[case][1:])
    for r, o in enumerate(out):
        got = o["serve"][(arch, case)]
        _close(got["logits"], logits, 1e-5, (arch, case, r))
        np.testing.assert_array_equal(got["tokens"], tokens,
                                      err_msg=(arch, case, r))


@pytest.mark.parametrize("arch,case", CASES)
def test_logits_equal_the_jax_package(ranks, arch, case):
    """Against JAX's unsharded prefill of the same chunks and decode
    steps fed the same tokens (or frame embeddings)."""
    _, out = ranks
    want, _ = _jax(arch, *rk.SERVE[case][1:])
    for r, o in enumerate(out):
        _close(o["serve"][(arch, case)]["logits"], want, 1e-5,
               (arch, case, "jax", r))


@pytest.mark.parametrize("arch,case", CASES)
def test_each_rank_holds_its_block_of_the_cache(ranks, arch, case):
    """After the ticks each rank's cache is its block of the one-process
    cache under ``cache_placements``: the blocks' shapes, positions
    exactly, k/v, latents and recurrent states within 1e-5; an attention
    cache is split by its slots over "model" — in "U" only the 16-slot
    rings, the 23-slot caches whole on every member — and a cache leaf
    the rules split is held whole by no rank."""
    _, out = ranks
    mesh, max_len, chunks = rk.SERVE[case]
    _, _, whole = _one_process(arch, max_len, chunks)
    smesh = ShardMesh(device=CPU, axes=MESHES[mesh])
    place = sharding.cache_placements(whole, smesh, "2d")
    leaves = tree_leaves(whole)
    places = []
    sharding.tree_map(lambda _, p: places.append(p), whole, place)
    for layer, p in zip(whole, place):
        if "kv" in layer:
            ring = layer["kv"]["pos"].shape[1] < max_len
            assert all(("model" in q.axes()) == (ring or case != "U")
                       for q in p["kv"].values()), (arch, case)
    for r, o in enumerate(out):
        got = o["serve"][(arch, case)]["cache"]
        assert len(got) == len(leaves)
        for i, (g, w, p) in enumerate(zip(got, leaves, places)):
            want = sharding.local_block(w, p, smesh, shard=r).numpy()
            assert g.shape == want.shape, (arch, case, r, i)
            if p.axes():
                assert g.shape != tuple(w.shape), (arch, case, r, i)
            if w.dtype == torch.int32:
                np.testing.assert_array_equal(g, want,
                                              err_msg=(arch, case, r, i))
            else:
                _close(g, want, 1e-5, (arch, case, r, i))


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


@pytest.mark.parametrize("arch,case", CASES)
def test_gathered_cache_equals_the_jax_package(ranks, arch, case):
    """The ranks' cache blocks gathered whole in the JAX package's stacked
    layout equal the JAX cache after the same steps (positions exactly,
    the rest within 1e-5), and cut back into blocks they are each rank's
    own bit for bit."""
    _, out = ranks
    _, want = _jax(arch, *rk.SERVE[case][1:])
    got = out[0]["serve"][(arch, case)]["whole"]
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for key in path:
            g = g[key.key if hasattr(key, "key") else key.idx]
        if path[-1].key == "pos":
            np.testing.assert_array_equal(g, w, err_msg=(arch, case, path))
        else:
            _close(g, w, 1e-5, (arch, case, path))
    assert all(o["serve"][(arch, case)]["round_trip"] for o in out)


@pytest.mark.parametrize("arch,case", SSM_CASES)
def test_ssm_parts_run_head_parallel_where_their_heads_divide(ranks, arch,
                                                               case):
    """Every rank ran hymba's mamba part and the xLSTM cells head
    parallel ("tp": its heads on its head block of the state, no state
    gathered) exactly where the heads divide over the case's "model" axis
    (xlstm's 2 on (data 2, model 2), the variant's 4 on both meshes),
    else gathered (hymba-1.5b's 5; xlstm's 2 over 4)."""
    _, out = ranks
    cfg = rk.serve_cfg(arch)
    M = MESHES[rk.SERVE[case][0]]["model"]
    want = "tp" if cfg.num_heads % M == 0 else "gather"
    for r, o in enumerate(out):
        plan = o["serve"][(arch, case)]["plan"]
        modes = {p[part] for p in plan.values() for part in ("mamba", "cell")
                 if part in p}
        assert modes == {want}, (arch, case, r, plan)
