"""The port's expert-parallel MoE (``models.moe.moe_a2a`` over a
``ShardMesh``) against its dense path and the JAX package on the CPU.

The JAX package's EP body (``moe._a2a_local``) runs here under
``jax.vmap`` with a named axis of 4 (the collectives ``all_to_all``,
``pmean`` and ``psum`` over that axis), the per-rank expert slices as the
mapped axis: the JAX a2a on one CPU device, without the 8-device
subprocess of ``tests/test_distributed_small_mesh.py``.

Tolerances (f32): the a2a against ``moe_dense`` at capacity factor 8 (no
pair dropped) within 1e-5 of the output's largest magnitude (the JAX
test allows 2e-2 relative; the products differ only in grouping); against
the JAX a2a, drops included, within 1e-5 likewise, aux within 1e-6
relative; slots, keeps and router statistics exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import moe as j_moe
from repro.models import transformer as jt
from repro.models.params import init_params as j_init
from repro_torch.configs import get_arch
from repro_torch.distributed.mesh import ShardMesh
from repro_torch.models import moe
from repro_torch.models import transformer
from repro_torch.models.params import init_params, tree_leaves

CPU = "cpu"
D = 4


def _cfgs(cf=8.0, E=8, k=2):
    out = []
    for get in (j_get_arch, get_arch):
        c = dataclasses.replace(get("deepseek-v3-671b").reduced,
                                compute_dtype="float32")
        out.append(dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, num_experts=E, top_k=k, capacity_factor=cf,
            impl="a2a")))
    return out


def _params(jcfg):
    """One MoE layer's JAX weights (seed 0) and the same as tensors."""
    jp = j_init(jt.model_specs(jcfg), 0)
    mp = jax.tree.map(lambda a: np.asarray(a)[0], jp["unit"][0]["moe"])
    return mp, {k: torch.tensor(v) for k, v in mp.items()}


def _x(cfg, B=2, S=8, seed=0):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def _jax_a2a(mp, cfg, x, collect):
    """The JAX EP body over a vmapped named axis of D ranks: rank d holds
    the sequence block d of every row and experts [d E/D, (d+1) E/D)."""
    B, S, Dm = x.shape
    E = cfg.moe.num_experts
    xl = jnp.asarray(x).reshape(B, D, S // D, Dm).transpose(1, 0, 2, 3)

    def split(w):
        return jnp.asarray(w).reshape(D, E // D, *w.shape[1:])

    def body(xr, wi, wg, wo):
        return j_moe._a2a_local(xr, jnp.asarray(mp["router"]), wi, wg, wo,
                                cfg=cfg, ep=D, ep_axis="ep",
                                tok_axes=("ep",), collect_stats=collect)

    out = jax.vmap(body, axis_name="ep")(xl, split(mp["wi"]),
                                         split(mp["wg"]), split(mp["wo"]))
    y = np.asarray(out[0]).transpose(1, 0, 2, 3).reshape(B, S, Dm)
    return (y,) + tuple(out[1:])


def _close(a, b, rel, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.abs(a - b).max()
    assert err <= rel * max(np.abs(b).max(), 1e-6), f"{what}: {err}"


def test_a2a_equals_dense_without_drops():
    jcfg, tcfg = _cfgs(cf=8.0)
    mp, tp = _params(jcfg)
    x = _x(tcfg)
    mesh = ShardMesh(D, CPU)
    ya, aux_a = moe.moe_ffn(tp, tcfg, torch.tensor(x), mesh=mesh)
    yd, aux_d = moe.moe_dense(tp, tcfg, torch.tensor(x))
    jd, _ = j_moe.moe_dense(mp, jcfg, jnp.asarray(x))
    _close(ya.numpy(), yd.numpy(), 1e-5, "a2a vs the port's dense")
    _close(ya.numpy(), np.asarray(jd), 1e-5, "a2a vs the JAX dense")
    # the aux losses differ by design: the a2a's is a mean over shards
    assert np.isfinite(float(aux_a)) and np.isfinite(float(aux_d))


@pytest.mark.parametrize("cf", [8.0, 1.25, 0.5])
def test_a2a_matches_jax_a2a(cf):
    """Against the JAX EP body itself, with dropped pairs at cf < 8."""
    jcfg, tcfg = _cfgs(cf=cf)
    mp, tp = _params(jcfg)
    x = _x(tcfg, S=16, seed=1)
    yj, auxj, stj = _jax_a2a(mp, jcfg, x, collect=True)
    yt, auxt, stt = moe.moe_a2a(tp, tcfg, torch.tensor(x), True,
                                mesh=ShardMesh(D, CPU))
    # the shared expert is added outside the body in both packages
    yj = yj + np.asarray(j_moe._shared(mp, jcfg, jnp.asarray(x),
                                       jnp.float32))
    _close(yt.numpy(), yj, 1e-5, f"a2a at capacity factor {cf}")
    assert float(auxt) == pytest.approx(float(np.asarray(auxj)[0]),
                                        rel=1e-6)
    np.testing.assert_array_equal(stt.counts.numpy(),
                                  np.asarray(stj.counts)[0])
    np.testing.assert_array_equal(stt.coact.numpy(),
                                  np.asarray(stj.coact)[0])
    T = x.shape[0] * x.shape[1]
    assert float(stt.counts.sum()) == T * tcfg.moe.top_k


def _onehot_cumsum_slots(flat_e, E):
    """The JAX body's slots in NumPy: one-hot cumsum a shard."""
    out = []
    for row in flat_e:
        oh = np.eye(E, dtype=np.int64)[row]
        out.append((np.cumsum(oh, 0) * oh).sum(1) - 1)
    return np.stack(out)


@pytest.mark.parametrize("E,n,seed", [(8, 64, 0), (16, 200, 1), (5, 33, 2)])
def test_dispatch_slots_equal_onehot_cumsum(E, n, seed):
    flat_e = np.random.default_rng(seed).integers(0, E, (D, n))
    for cap in (1, 3, n):
        slot, keep = moe.dispatch_slots(torch.tensor(flat_e), E, cap)
        want = _onehot_cumsum_slots(flat_e, E)
        np.testing.assert_array_equal(slot.numpy(), want)
        np.testing.assert_array_equal(keep.numpy(), want < cap)


def test_router_stats_sum_over_shards():
    jcfg, tcfg = _cfgs(cf=1.25)
    mp, tp = _params(jcfg)
    x = torch.tensor(_x(tcfg, S=16, seed=2))
    _, _, st = moe.moe_a2a(tp, tcfg, x, True, mesh=ShardMesh(D, CPU))
    _, _, sd = moe.moe_dense(tp, tcfg, x, True)
    assert torch.equal(st.counts, sd.counts)
    assert torch.equal(st.coact, sd.coact)


def test_impls_and_fallbacks():
    jcfg, tcfg = _cfgs(cf=1.25)
    _, tp = _params(jcfg)
    mesh = ShardMesh(D, CPU)
    x = torch.tensor(_x(tcfg, S=16, seed=3))
    a2a = moe.moe_a2a(tp, tcfg, x, mesh=mesh)[0]
    dense = moe.moe_dense(tp, tcfg, x)[0]
    assert not torch.equal(a2a, dense)           # cf 1.25 drops pairs
    for impl, want in (("a2a", a2a), ("auto", a2a), ("dense", dense)):
        assert torch.equal(moe.moe_ffn(tp, tcfg, x, impl, mesh=mesh)[0],
                           want), impl
        with moe.use_mesh(mesh):
            assert torch.equal(moe.moe_ffn(tp, tcfg, x, impl)[0], want)
    assert torch.equal(moe.moe_ffn(tp, tcfg, x)[0], dense)   # no mesh
    # S = 6 does not divide over 4 shards: the dense path
    x6 = x[:, :6]
    assert torch.equal(moe.moe_ffn(tp, tcfg, x6, mesh=mesh)[0],
                       moe.moe_dense(tp, tcfg, x6)[0])


def test_a2a_gradients_finite_and_equal_dense_without_drops():
    jcfg, tcfg = _cfgs(cf=8.0)
    _, tp = _params(jcfg)
    x = torch.tensor(_x(tcfg, S=8, seed=4))
    grads = {}
    for name, fn in (("a2a", lambda p, xx: moe.moe_a2a(
            p, tcfg, xx, mesh=ShardMesh(D, CPU))),
                     ("dense", lambda p, xx: moe.moe_dense(p, tcfg, xx))):
        p = {k: v.clone().requires_grad_() for k, v in tp.items()}
        xx = x.clone().requires_grad_()
        y, aux = fn(p, xx)
        g = torch.autograd.grad((y ** 2).sum(), [xx] + list(p.values()))
        assert all(bool(torch.isfinite(t).all()) for t in g), name
        grads[name] = g
    for a, b in zip(grads["a2a"], grads["dense"]):
        _close(a.numpy(), b.numpy(), 1e-5, "a2a gradient vs dense")


def test_loss_fn_over_a_mesh():
    """deepseek-v3 reduced (MLA, MoE, MTP) through ``loss_fn`` with the a2a
    over ShardMesh(4): the dense loss at capacity factor 8, gradients
    finite at the config's own 1.25."""
    B, S = 2, 8
    rng = np.random.default_rng(5)
    tok = rng.integers(1, 512, (B, S)).astype(np.int32)
    batch = dict(tokens=torch.tensor(tok), labels=torch.tensor(
        np.concatenate([tok[:, 1:], np.full((B, 1), -1, np.int32)], 1)),
        positions=torch.arange(S, dtype=torch.int32)[None].expand(
            B, S).contiguous())
    base = dataclasses.replace(get_arch("deepseek-v3-671b").reduced,
                               compute_dtype="float32")
    params = init_params(transformer.model_specs(base), 0, CPU)
    wide = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=8.0, impl="a2a"))
    with moe.use_mesh(ShardMesh(D, CPU)):
        la, ma = transformer.loss_fn(params, wide, batch,
                                     collect_router_stats=True)
    ld, md = transformer.loss_fn(params, base, batch,
                                 collect_router_stats=True)
    assert float(ma["ce"]) == pytest.approx(float(md["ce"]), rel=1e-5)
    assert torch.equal(ma["router_counts"], md["router_counts"])
    own = dataclasses.replace(base, moe=dataclasses.replace(base.moe,
                                                            impl="a2a"))
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    with moe.use_mesh(ShardMesh(D, CPU)):
        loss, _ = transformer.loss_fn(params, own, batch)
    g = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert all(t is None or bool(torch.isfinite(t).all()) for t in g)


def test_train_step_over_a_mesh_equals_one_device():
    """``tests/test_distributed_small_mesh.py``'s sharded train step: the
    reduced deepseek-v3's step with the a2a over ShardMesh(4) (capacity 8,
    nothing dropped) against the single-device dense step: loss within
    1e-5 relative, grad norm within 1e-4, parameters within 2.5 lr (an
    element whose gradient is near 0 may take the first AdamW step the
    other way), router counts exact.  Then every gradient leaf (taken
    through ``grad_transform``) within 1e-5 of its largest magnitude, with
    the router's aux weight at 0: the a2a's aux is the mean of the shards'
    Switch losses, as in the JAX package, not the global one, so its
    gradient differs from the dense path's by design (by about 3% of the
    router gate's)."""
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts_mod

    base = dataclasses.replace(get_arch("deepseek-v3-671b").reduced,
                               compute_dtype="float32")
    params = init_params(transformer.model_specs(base), 0, CPU)
    rng = np.random.default_rng(6)
    tok = rng.integers(1, 512, (2, 8)).astype(np.int32)
    batch = dict(tokens=torch.tensor(tok), labels=torch.tensor(
        np.concatenate([tok[:, 1:], np.full((2, 1), -1, np.int32)], 1)),
        positions=torch.arange(8, dtype=torch.int32)[None].expand(
            2, 8).contiguous())
    ocfg = opt_mod.OptConfig(warmup_steps=1, total_steps=10)

    def steps(aux_weight):
        dense = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, router_aux_weight=aux_weight))
        wide = dataclasses.replace(dense, moe=dataclasses.replace(
            dense.moe, capacity_factor=8.0, impl="a2a"))
        out, grads = {}, {}
        for name, cfg in (("dense", dense), ("a2a", wide)):
            def keep(g, name=name):
                grads[name] = [t.clone() for t in tree_leaves(g)]
                return g

            step = ts_mod.make_train_step(cfg, ocfg, grad_transform=keep,
                                          collect_router_stats=True)
            with moe.use_mesh(ShardMesh(D, CPU)):
                out[name] = step(params, opt_mod.init(params, device=CPU),
                                 batch)
        return out, grads

    out, _ = steps(base.moe.router_aux_weight)
    (pd, _, md), (pa, _, ma) = out["dense"], out["a2a"]
    assert float(ma["loss"]) == pytest.approx(float(md["loss"]), rel=1e-5)
    assert float(ma["grad_norm"]) == pytest.approx(float(md["grad_norm"]),
                                                   rel=1e-4)
    assert torch.equal(ma["router_counts"], md["router_counts"])
    lr = float(md["lr"])
    for a, b in zip(tree_leaves(pa), tree_leaves(pd)):
        assert float((a - b).abs().max()) <= 2.5 * lr
    _, grads = steps(0.0)
    assert len(grads["a2a"]) == len(grads["dense"]) == len(
        tree_leaves(params))
    for ga, gd in zip(grads["a2a"], grads["dense"]):
        scale = float(gd.abs().max())
        assert scale > 0
        assert float((ga - gd).abs().max()) <= 1e-5 * scale
