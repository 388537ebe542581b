"""Parity of the PyTorch port's runtime (``repro_torch.runtime``) with the
JAX package on the CPU: manifests exact on both build methods, and trigger
fire steps exact on a load series for all three triggers."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import cost as j_cost
from repro.runtime import migrate as j_mig
from repro.runtime import triggers as j_trig
from repro_torch.runtime import cost as t_cost
from repro_torch.runtime import migrate as t_mig
from repro_torch.runtime import triggers as t_trig


def _owners(n, P, seed):
    rng = np.random.default_rng(seed)
    old = rng.integers(0, P, n).astype(np.int32)
    new = np.where(rng.random(n) < 0.3, rng.integers(0, P, n), old)
    return old, new.astype(np.int32)


@pytest.mark.parametrize("method", ["sort", "scatter", "auto"])
@pytest.mark.parametrize("n,P", [(1, 1), (997, 4), (5000, 8), (3000, 70)])
def test_build_manifest_exact(method, n, P):
    old, new = _owners(n, P, seed=n + P)
    want = j_mig.build_manifest(jnp.asarray(old), jnp.asarray(new), P,
                                method=method)
    got = t_mig.build_manifest(torch.as_tensor(old), torch.as_tensor(new),
                               P, method=method)
    for f in ("order", "offsets", "send_counts", "moved"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert (got.dest is None) == (want.dest is None)
    if got.dest is not None:
        np.testing.assert_array_equal(got.dest.numpy(), np.asarray(want.dest))
    assert int(got.moved_count) == int(want.moved_count)
    assert t_mig.resolve_method(method, n=n, num_nodes=P) == \
        j_mig.resolve_method(method, n=n, num_nodes=P)


def test_build_and_apply_relocates_and_inverse_undoes():
    old, new = _owners(4000, 8, seed=1)
    payload = np.random.default_rng(2).random(4000).astype(np.float32)
    ids = np.arange(4000, dtype=np.int32)
    (pt, it), man = t_mig.build_and_apply(
        torch.as_tensor(old), torch.as_tensor(new),
        (torch.as_tensor(payload), torch.as_tensor(ids)), num_nodes=8)
    (pj, ij), _ = j_mig.build_and_apply(
        jnp.asarray(old), jnp.asarray(new),
        (jnp.asarray(payload), jnp.asarray(ids)), num_nodes=8)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    # every node's items in its slot region, nothing lost or duplicated
    off = man.offsets.numpy()
    for p in range(8):
        assert (new[it.numpy()[off[p]:off[p + 1]]] == p).all()
    inv = t_mig.inverse_permutation(man.order)
    np.testing.assert_array_equal(pt.numpy()[inv.numpy()], payload)
    np.testing.assert_array_equal(
        inv.numpy(), np.asarray(j_mig.inverse_permutation(man.order.numpy())))


def _load_series(T=80, C=36, P=4, seed=0):
    """Per-step object loads with a drifting hotspot and noise."""
    rng = np.random.default_rng(seed)
    base = rng.random((T, C)).astype(np.float32) * 2 + 1
    drift = np.linspace(0, 6, T)[:, None] * (np.arange(C) < C // 6)
    loads = (base + drift).astype(np.float32)
    assignment = (np.arange(C) * P // C).astype(np.int32)
    return loads, assignment


@pytest.mark.parametrize("spec", [
    "every", "threshold", "predictive",
    ("threshold", dict(hi=1.3, lo=1.1, min_interval=3, rearm_after=6)),
    ("predictive", dict(window=4, horizon=12, efficiency=0.5,
                        measured_gate=False)),
    ("predictive", dict(cost_kw=dict(t_load=1.0, t_byte=0.02,
                                     lb_overhead=0.5))),
])
def test_trigger_fire_steps_exact(spec):
    """Fed the same load series (and, on fired steps, the same measured
    exchange volume), both packages fire on the same steps."""
    loads, assignment = _load_series()
    P = 4
    if isinstance(spec, str):
        jt = j_trig.resolve(spec, lb_every=7)
        tt = t_trig.resolve(spec, lb_every=7)
    else:
        name, kw = spec
        kw = dict(kw)
        cost_kw = kw.pop("cost_kw", None)
        if cost_kw:
            kw["cost"] = j_cost.RuntimeCostModel(**cost_kw)
        jt = j_trig._BY_NAME[name](**kw)
        if cost_kw:
            kw["cost"] = t_cost.RuntimeCostModel(**cost_kw)
        tt = t_trig._BY_NAME[name](**kw)
    js, ts = jt.init_state(), tt.init_state("cpu")
    fired_j, fired_t = [], []
    for t in range(loads.shape[0]):
        jm, ja, jtot = j_trig.load_stats(jnp.asarray(loads[t]),
                                         jnp.asarray(assignment), P)
        tm, ta, ttot = t_trig.load_stats(torch.as_tensor(loads[t]),
                                         torch.as_tensor(assignment), P)
        assert float(tm) == float(jm) and float(ttot) == float(jtot)
        dj, js = jt.decide(js, jnp.int32(t), jm, ja, jtot)
        dt, ts = tt.decide(ts, t, tm, ta, ttot)
        fired_j.append(bool(dj))
        fired_t.append(bool(dt))
        if bool(dj):
            moved = float(loads[t].sum()) * 0.1 + t
            js = jt.observe(js, jnp.float32(moved), jnp.asarray(True))
            ts = tt.observe(ts, moved, True)
    assert fired_t == fired_j
    assert any(fired_j)


def test_trigger_resolution_matches():
    for strat in ("diff-comm", "diff-comm+threshold", "diff-coord+predictive",
                  "none"):
        assert type(t_trig.resolve_for_strategy(
            None, lb_every=5, strategy=strat)).__name__ == type(
            j_trig.resolve_for_strategy(
                None, lb_every=5, strategy=strat)).__name__
    with pytest.raises(KeyError):
        t_trig.resolve("sometimes", lb_every=5)
    with pytest.raises(TypeError):
        t_trig.resolve(3, lb_every=5)
    assert t_trig.resolve("every", lb_every=0).never


def test_cost_model_matches():
    kw = dict(t_load=2e-8, t_byte=3e-8, bytes_per_load=48.0,
              lb_overhead=1e-4, moved_frac_est=0.2)
    jm, tm = j_cost.RuntimeCostModel(**kw), t_cost.RuntimeCostModel(**kw)
    x = np.array([0.0, 10.0, 1e6], np.float32)
    for f, args in (("migration_seconds", (x,)),
                    ("est_migration_seconds", (x,)),
                    ("imbalance_seconds", (x, x[::-1].copy())),
                    ("step_seconds", (x, x, np.array([0, 1, 1], np.float32)))):
        np.testing.assert_allclose(
            getattr(tm, f)(*(torch.as_tensor(a) for a in args)).numpy(),
            np.asarray(getattr(jm, f)(*(jnp.asarray(a) for a in args))),
            rtol=1e-6)
