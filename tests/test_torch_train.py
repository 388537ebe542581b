"""The port's training slice (``repro_torch.train``, ``loss_fn``,
``distributed.grad_compress`` / ``data_balance``, ``launch.train``) on the
CPU: the JAX package's ``tests/test_train.py`` on the port, then the port
held to the JAX package on the same inputs.

Tolerances (f32 compute on both sides; the two frameworks add in other
orders, and XLA's CPU jit contracts multiply-adds into FMAs):
  * ``loss_fn``: the loss within 2e-6 relative; every gradient leaf within
    1e-4 of the largest magnitude of its JAX counterpart (the attention
    backward is autograd of the chunked attention on both sides);
  * one train step: parameters within 1e-5 absolute (an AdamW step of lr
    1e-3 divides by sqrt(v), so gradient noise of 1e-4 relative moves a
    parameter by about 1e-7 where |g| is not tiny), moments ``mu`` within
    1e-4 of the largest moment of the leaf, ``nu`` within 1e-3 of it,
    the step count exact;
  * router counts and co-activations, batches, assignments and the data
    pipeline's moved shards exact.
"""
import dataclasses
import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.distributed import data_balance as j_db
from repro.models import transformer as jt
from repro.models.params import init_params as j_init
from repro.train import data as j_data
from repro.train import optimizer as j_opt
from repro.train import train_step as j_ts
from repro_torch import interop
from repro_torch.configs import SHAPES, get_arch, list_archs
from repro_torch.configs import materialize_batch
from repro_torch.distributed import data_balance as db
from repro_torch.distributed import grad_compress as gc
from repro_torch.models import transformer
from repro_torch.models.params import init_params, tree_leaves, tree_map
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import data as data_mod
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_step as ts_mod

CPU = "cpu"


@pytest.fixture(scope="module")
def setup():
    cfg = get_arch("smollm-135m").reduced
    params = init_params(transformer.model_specs(cfg), 0, CPU)
    ocfg = opt_mod.OptConfig(lr=3e-3, warmup_steps=5, total_steps=200,
                             weight_decay=0.0)
    return cfg, params, ocfg, ts_mod.make_train_step(cfg, ocfg)


def _np_batch(vocab, B=4, S=24, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, (B, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)], 1)
    pos = np.ascontiguousarray(
        np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)))
    return dict(tokens=toks, labels=labels, positions=pos)


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# -------------------------------------------- tests/test_train.py, ported --


def test_memorizes_fixed_batch(setup):
    cfg, params, ocfg, step = setup
    opt = opt_mod.init(params, device=CPU)
    batch = _t(_np_batch(cfg.vocab_size))
    losses = []
    for _ in range(60):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.5, f"no memorization: {losses[::10]}"


def test_lr_schedule_shape():
    ocfg = opt_mod.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                             min_lr_frac=0.1)
    lrs = [float(opt_mod.schedule(ocfg, torch.tensor(s, dtype=torch.int32)))
           for s in [0, 5, 10, 50, 100]]
    assert lrs[0] == 0.0
    assert abs(lrs[2] - 1.0) < 1e-6
    assert lrs[3] < 1.0
    assert abs(lrs[4] - 0.1) < 1e-2
    # and the JAX schedule's values at every step of the run
    j_ocfg = j_opt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                             min_lr_frac=0.1)
    for s in range(0, 101):
        want = float(j_opt.schedule(j_ocfg, jnp.int32(s)))
        got = float(opt_mod.schedule(ocfg, torch.tensor(s,
                                                        dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7), s


def test_grad_clipping_bounds_update():
    """Adam normalizes the update to about lr whatever the gradient's
    scale; clipping bounds the moments (a huge spike must not give a step
    above lr)."""
    ocfg = opt_mod.OptConfig(lr=1e-2, clip_norm=1.0, warmup_steps=0,
                             total_steps=10, weight_decay=0.0)
    p = dict(w=torch.ones((4, 4)))
    g = dict(w=torch.full((4, 4), 1e6))
    st = opt_mod.init(p, device=CPU)
    p2, st2, m = opt_mod.apply(ocfg, p, g, st)
    assert float(m["grad_norm"]) == pytest.approx(4e6, rel=1e-3)
    assert float((p2["w"] - p["w"]).abs().max()) <= ocfg.lr * 1.01
    assert float(st2.nu["w"].max()) <= (1 - ocfg.b2) * (1.0 / 4) ** 2 * 1.01


def test_weight_decay_mask_skips_1d():
    ocfg = opt_mod.OptConfig(lr=1e-2, weight_decay=10.0, warmup_steps=0,
                             total_steps=10)
    p = dict(w=torch.ones((4, 4)), b=torch.ones((4,)))
    g = tree_map(torch.zeros_like, p)
    st = opt_mod.init(p, device=CPU)
    p2, *_ = opt_mod.apply(ocfg, p, g, st)
    assert float((p2["b"] - 1.0).abs().max()) < 1e-9, "1D: no decay"
    assert float((p2["w"] - 1.0).abs().max()) > 1e-4, "2D: decayed"


def test_checkpoint_resume_bit_exact(setup):
    cfg, params, ocfg, step = setup
    opt = opt_mod.init(params, device=CPU)
    batch = _t(_np_batch(cfg.vocab_size, seed=1))
    pa, oa = params, opt
    for _ in range(6):
        pa, oa, _ = step(pa, oa, batch)
    pb, ob = params, opt
    for _ in range(3):
        pb, ob, _ = step(pb, ob, batch)
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 3, pb, ob)
        pb2, ob2, s, _ = ckpt.restore(d, pb, ob, device=CPU)
        assert s == 3
    for _ in range(3):
        pb2, ob2, _ = step(pb2, ob2, batch)
    for a, b in zip(tree_leaves(pa), tree_leaves(pb2)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(list(oa)), tree_leaves(list(ob2))):
        assert torch.equal(a, b)


def test_checkpoint_gc_and_latest():
    with tempfile.TemporaryDirectory() as d:
        p = dict(w=torch.ones((2,)))
        for s in [1, 2, 3, 4, 5]:
            ckpt.save(d, s, p, keep=2)
        names = sorted(x for x in os.listdir(d) if x.startswith("ckpt_"))
        assert names == ["ckpt_00000004", "ckpt_00000005"]
        assert ckpt.latest_step(d) == 5


def test_data_pipeline_deterministic_and_rebalances():
    dcfg = data_mod.DataConfig(vocab_size=100, seq_len=16, global_batch=4,
                               num_shards=16, seed=7)
    p1 = data_mod.DataPipeline(dcfg, num_ranks=4, device=CPU)
    p2 = data_mod.DataPipeline(dcfg, num_ranks=4, device=CPU)
    b1, b2 = p1.next_batch(), p2.next_batch()
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    info = p1.maybe_rebalance(threshold=1.01)
    if info is not None:
        loads = p1.rank_loads()
        assert loads.max() / loads.mean() < 2.0


def test_grad_compress_error_feedback():
    rng = np.random.default_rng(0)
    g = dict(w=torch.as_tensor(rng.normal(size=(64, 64)).astype(np.float32)))
    res = gc.init_residual(g)
    acc_true = np.zeros((64, 64))
    acc_comp = np.zeros((64, 64))
    for _ in range(10):
        gs = dict(w=torch.as_tensor(
            rng.normal(size=(64, 64)).astype(np.float32)))
        deq, res = gc.compress(gs, res)
        acc_true += gs["w"].numpy()
        acc_comp += deq["w"].numpy()
    rel = np.linalg.norm(acc_true - acc_comp) / np.linalg.norm(acc_true)
    assert rel < 0.05, f"error feedback diverged: {rel}"
    assert float(gc.compression_error(g, gc.init_residual(g))) < 0.05


# ------------------------------------------------- against the JAX package --


def _cfgs(arch):
    return (dataclasses.replace(j_get_arch(arch).reduced,
                                compute_dtype="float32"),
            dataclasses.replace(get_arch(arch).reduced,
                                compute_dtype="float32"))


def _close_trees(got, want, rel, what):
    """Leaf by leaf: |got - want| <= rel * max|want| (+ a floor for
    all-zero leaves)."""
    for i, (a, b) in enumerate(zip(tree_leaves(got), tree_leaves(want))):
        a, b = a.detach().double(), b.double()
        assert a.shape == b.shape, (what, i)
        tol = rel * max(float(b.abs().max()), 1e-6)
        err = float((a - b).abs().max())
        assert err <= tol, f"{what} leaf {i} {tuple(b.shape)}: {err} > {tol}"


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v3-671b"])
def test_loss_and_grads_match_jax(arch):
    """``loss_fn`` (with MTP and router statistics for deepseek) and every
    gradient against ``jax.value_and_grad`` of the JAX ``loss_fn``."""
    jcfg, tcfg = _cfgs(arch)
    collect = tcfg.moe is not None
    jp = j_init(jt.model_specs(jcfg), 0)
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, CPU)
    batch = _np_batch(tcfg.vocab_size, B=2, S=16, seed=3)
    jfn = jax.jit(jax.value_and_grad(functools.partial(
        jt.loss_fn, cfg=jcfg, collect_router_stats=collect), has_aux=True))
    (jl, jm), jg = jfn(jp, batch=_j(batch))
    leaves = [p.requires_grad_() for p in tree_leaves(tp)]
    tl, tm = transformer.loss_fn(tp, tcfg, _t(batch),
                                 collect_router_stats=collect)
    tg = torch.autograd.grad(tl, leaves)
    it = iter(tg)
    tg = tree_map(lambda _: next(it), tp)
    assert float(tl.detach()) == pytest.approx(float(jl), rel=2e-6)
    for k in ("ce", "mtp", "aux"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=2e-6,
                                             abs=1e-7), k
    assert int(tm["tokens"]) == int(jm["tokens"])
    if collect:
        np.testing.assert_array_equal(tm["router_counts"].numpy(),
                                      np.asarray(jm["router_counts"]))
        np.testing.assert_array_equal(tm["router_coact"].numpy(),
                                      np.asarray(jm["router_coact"]))
        assert not tm["router_counts"].requires_grad
    jg_t = interop.params_from_numpy(jax.tree.map(np.asarray, jg), tcfg, CPU)
    _close_trees(tg, jg_t, 1e-4, f"{arch} grads")


def test_train_step_matches_jax():
    """Two steps from the same weights: the JAX package's first step's
    optimizer state carried across (``opt_state_from_numpy``), then one
    step of each package from it."""
    jcfg, tcfg = _cfgs("smollm-135m")
    jp = j_init(jt.model_specs(jcfg), 0)
    j_ocfg = j_opt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    t_ocfg = opt_mod.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(j_ts.make_train_step(jcfg, j_ocfg))
    b0, b1 = (_np_batch(tcfg.vocab_size, B=2, S=16, seed=s) for s in (4, 5))
    jp1, jo1, _ = jstep(jp, j_opt.init(jp), _j(b0))
    jp2, jo2, jm = jstep(jp1, jo1, _j(b1))
    host = functools.partial(jax.tree.map, np.asarray)
    tp1 = interop.params_from_numpy(host(jp1), tcfg, CPU)
    to1 = interop.opt_state_from_numpy(host(jo1), tcfg, CPU)
    tstep = ts_mod.make_train_step(tcfg, t_ocfg)
    tp2, to2, tm = tstep(tp1, to1, _t(b1))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=2e-6)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-5)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    want_p = interop.params_from_numpy(host(jp2), tcfg, CPU)
    for a, b in zip(tree_leaves(tp2), tree_leaves(want_p)):
        assert float((a - b).abs().max()) <= 1e-5
    want_o = interop.opt_state_from_numpy(host(jo2), tcfg, CPU)
    assert int(to2.step) == int(want_o.step) == 2
    _close_trees(to2.mu, want_o.mu, 1e-4, "mu")
    _close_trees(to2.nu, want_o.nu, 1e-3, "nu")


def test_decay_mask_follows_the_jax_stacking():
    """The JAX step decays every tensor of its scanned (stacked) layers,
    norms included, and the unstacked 1-D ones nowhere else."""
    cfg = get_arch("deepseek-v3-671b").reduced
    params = init_params(transformer.model_specs(cfg), 0, CPU)
    mask = ts_mod.decay_mask(cfg, params)
    assert mask["final_norm"] is False and mask["embed"] is True
    assert mask["layers"][0]["norm1"] is False        # the prefix layer
    assert all(m["norm1"] is True for m in mask["layers"][1:])  # scanned
    assert mask["mtp"]["norm"] is False


def test_eval_step_is_the_train_step_loss(setup):
    cfg, params, ocfg, step = setup
    batch = _t(_np_batch(cfg.vocab_size, B=2, S=16, seed=8))
    ev = ts_mod.make_eval_step(cfg)(params, batch)
    _, _, m = step(params, opt_mod.init(params, device=CPU), batch)
    assert torch.equal(ev["loss"], m["loss"])
    assert int(ev["tokens"]) == 2 * 15 and not ev["loss"].requires_grad


def test_remat_full_equals_none():
    cfg = get_arch("smollm-135m").reduced
    params = init_params(transformer.model_specs(cfg), 0, CPU)
    batch = _t(_np_batch(cfg.vocab_size, B=2, S=16, seed=6))
    out = {}
    for remat in ("none", "full", "dots"):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        loss, _ = transformer.loss_fn(live, cfg, batch, remat=remat)
        out[remat] = [loss] + list(torch.autograd.grad(loss, leaves))
    for remat in ("full", "dots"):
        for a, b in zip(out[remat], out["none"]):
            assert torch.equal(a, b), remat


def test_seq_chunks_equal_one_chunk():
    """The chunked CE (chunks of 8 over S = 20, padded) equals one chunk
    within f32 addition order (f32 compute); gradients too."""
    cfg = _cfgs("smollm-135m")[1]
    params = init_params(transformer.model_specs(cfg), 0, CPU)
    batch = _t(_np_batch(cfg.vocab_size, B=2, S=20, seed=7))
    res = []
    for c in (512, 8):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        loss, _ = transformer.loss_fn(live, cfg, batch, seq_chunk=c)
        res.append((loss, torch.autograd.grad(loss, leaves)))
    assert float(res[0][0]) == pytest.approx(float(res[1][0]), rel=1e-6)
    for a, b in zip(res[0][1], res[1][1]):
        assert float((a - b).abs().max()) <= 1e-6 * max(
            float(b.abs().max()), 1e-6)


def test_data_pipeline_batches_equal_jax():
    dcfg = dict(vocab_size=300, seq_len=32, global_batch=8, num_shards=16,
                seed=3)
    jp = j_data.DataPipeline(j_data.DataConfig(**dcfg), num_ranks=4)
    tp = data_mod.DataPipeline(data_mod.DataConfig(**dcfg), num_ranks=4,
                               device=CPU)
    for _ in range(3):
        jb, tb = jp.next_batch(), tp.next_batch()
        for k in ("tokens", "labels", "positions"):
            np.testing.assert_array_equal(np.asarray(tb[k]),
                                          np.asarray(jb[k]))
    ji, ti = jp.maybe_rebalance(threshold=1.01), tp.maybe_rebalance(
        threshold=1.01)
    assert (ji is None) == (ti is None)
    np.testing.assert_array_equal(tp.state.assignment, jp.state.assignment)
    if ji is not None:
        assert ti["moved_shards"] == ji["moved_shards"]
    np.testing.assert_array_equal(tp.rank_loads(), jp.rank_loads())
    jb, tb = jp.next_batch(), tp.next_batch()
    np.testing.assert_array_equal(tb["tokens"], np.asarray(jb["tokens"]))


@pytest.mark.parametrize("num_ranks,seed", [(4, 0), (8, 1), (5, 2)])
def test_balance_shards_equal_jax(num_ranks, seed):
    rng = np.random.default_rng(seed)
    counts = (rng.pareto(2.5, 32) * 1000 + 50).astype(np.int64)
    assign = (np.arange(32) * num_ranks // 32).astype(np.int32)
    ja, _ = j_db.balance_shards(counts, assign, num_ranks)
    ta, _ = db.balance_shards(counts, assign, num_ranks, device=CPU)
    np.testing.assert_array_equal(ta, np.asarray(ja))
    np.testing.assert_array_equal(db.rebalance_global(counts, num_ranks),
                                  j_db.rebalance_global(counts, num_ranks))
    lengths = rng.integers(16, 4096, 64)
    pa = db.pack_balanced(lengths, num_ranks)
    np.testing.assert_array_equal(pa, j_db.pack_balanced(lengths, num_ranks))
    assert db.pack_stats(lengths, pa, num_ranks) == j_db.pack_stats(
        lengths, pa, num_ranks)


def test_grad_compress_equals_jax():
    from repro.distributed import grad_compress as j_gc
    rng = np.random.default_rng(1)
    g = {"a": rng.normal(size=(16, 8)).astype(np.float32),
         "b": [rng.normal(size=(5,)).astype(np.float32)]}
    r = {"a": rng.normal(size=(16, 8)).astype(np.float32) * 1e-3,
         "b": [np.zeros(5, np.float32)]}
    jd, jr = j_gc.compress(jax.tree.map(jnp.asarray, g),
                           jax.tree.map(jnp.asarray, r))
    td, tr = gc.compress(tree_map(torch.as_tensor, g),
                         tree_map(torch.as_tensor, r))
    for a, b in zip(tree_leaves(td) + tree_leaves(tr),
                    jax.tree.leaves(jd) + jax.tree.leaves(jr)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


def test_checkpoint_bf16_round_trips_bit_for_bit():
    rng = np.random.default_rng(2)
    p = dict(w=torch.as_tensor(rng.normal(size=(3, 5)).astype(np.float32)
                               ).to(torch.bfloat16),
             l=[torch.arange(4, dtype=torch.int32)])
    st = opt_mod.init(p, master_fp32=True, device=CPU)
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 7, p, st, data_state=dict(epoch=2, cursor=np.arange(3)))
        p2, st2, s, ds = ckpt.restore(d, p, st, device=CPU)
        with open(os.path.join(d, "ckpt_00000007", "manifest.json")) as f:
            assert '"params/w": "bfloat16"' in f.read()
    assert s == 7 and ds == dict(epoch=2, cursor=[0, 1, 2])
    assert p2["w"].dtype == torch.bfloat16
    assert torch.equal(p2["w"].view(torch.int16), p["w"].view(torch.int16))
    for a, b in zip(tree_leaves(list(st)), tree_leaves(list(st2))):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", list_archs())
def test_train_step_loss_finite(arch):
    cfg = get_arch(arch).reduced
    params = init_params(transformer.model_specs(cfg), 0, CPU)
    opt = opt_mod.init(params, device=CPU)
    step = ts_mod.make_train_step(
        cfg, opt_mod.OptConfig(warmup_steps=1, total_steps=10))
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16,
                                global_batch=2)
    batch = materialize_batch(cfg, shape, seed=0, device=CPU)["batch"]
    p2, o2, m = step(params, opt, batch)
    assert bool(torch.isfinite(m["loss"]))
    assert float(m["grad_norm"]) > 0
    diffs = [float((a.float() - b.float()).abs().max())
             for a, b in zip(tree_leaves(params), tree_leaves(p2))]
    assert max(diffs) > 0


def test_launcher_trains_and_resumes_on_cpu():
    from repro_torch.launch import train as lt
    with tempfile.TemporaryDirectory() as d:
        kw = dict(seq_len=16, global_batch=2, save_every=2, ckpt_dir=d,
                  device=CPU, log_every=0)
        whole = lt.train(lt.RunConfig(steps=4, **kw, resume=False))
        with tempfile.TemporaryDirectory() as d2:
            kw["ckpt_dir"] = d2
            lt.train(lt.RunConfig(steps=2, **kw))
            rest = lt.train(lt.RunConfig(steps=4, **kw))
        assert len(rest["losses"]) == 2
        assert rest["losses"] == whole["losses"][2:]
        for a, b in zip(tree_leaves(rest["params"]),
                        tree_leaves(whole["params"])):
            assert torch.equal(a, b)
