"""Live expert rebalancing of the port (``repro_torch.train.ep_runtime``,
the ``routing-skew`` scenario) against the JAX package on the CPU,
mirroring ``tests/test_ep_runtime.py``.

The contracts:

  * the device-resident loop equals the host loop bit for bit — fire
    steps, max/avg records, placements, slot layouts, payload signature
    and moved bytes — and both equal the JAX package's replay of the same
    workload exactly (every float that feeds a decision has XLA's CPU
    bits: the EMA as its fused multiply-add, the load sums in its order);
    ``max_avg`` is held exactly as well (0 ulp);
  * every executed exchange conserves the expert population and keeps the
    placement capacity-exact;
  * the predictive trigger's gate amortizes against the executed bytes;
  * ``execute_placement`` relocates real MoE parameters (reduced
    deepseek-v3 widths) without changing the layer's function, equal to
    the JAX package's relocation; over a ``ShardMesh`` of 8 shards on one
    device (the JAX test's 8 virtual devices) the ring exchange equals
    the single-device relocation and the sharded replay equals the
    single-device replay;
  * ``EPRebalancer`` histories equal the JAX package's.
The JAX references are computed once per module.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import cost as j_cost
from repro.runtime import triggers as j_trig
from repro.train import ep_runtime as j_epr
from repro_torch.configs import get_arch
from repro_torch.distributed.mesh import ShardMesh
from repro_torch.models import moe as t_moe
from repro_torch.models.params import tree_map
from repro_torch.runtime import cost as t_cost
from repro_torch.runtime import triggers as t_trig
from repro_torch.train import ep_runtime as epr

CPU = "cpu"
W = dict(num_experts=32, num_ranks=4, tokens_per_step=256, trace_len=24,
         seed=1)
TW, JW = epr.RoutingWorkload(**W), j_epr.RoutingWorkload(**W)
FIELDS = ("lb_fired", "max_avg", "moved_experts", "moved_bytes",
          "final_placement", "final_slot_expert", "final_wsig")


def _equal(got, want, what):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{what}: {f}")


def _run(steps=24, **kw):
    return epr.run_ep_replay(TW, steps=steps, device=CPU, **kw)


@functools.lru_cache(maxsize=None)
def _jax(steps=24, **kw):
    return j_epr.run_ep_replay(JW, steps=steps, **kw)


# ------------------------------------------------------------ replay core --


def test_scan_host_parity_bitforbit_and_equal_to_jax():
    a = _run(strategy="diff-comm", lb_every=6)
    b = _run(strategy="diff-comm", lb_every=6, scan=False)
    assert a.scanned and not b.scanned
    _equal(a, b, "device-resident vs host loop")
    _equal(a, _jax(strategy="diff-comm", lb_every=6), "port vs JAX")
    assert a.lb_fired.sum() == 3


def test_exchange_conserves_experts_and_capacity():
    r = _run(strategy="diff-comm", lb_every=6)
    assert r.lb_fired.sum() > 0, "cadence trigger must fire"
    E, R = W["num_experts"], W["num_ranks"]
    assert sorted(r.final_slot_expert) == list(range(E))
    assert (np.bincount(r.final_placement, minlength=R) == E // R).all()
    np.testing.assert_array_equal(
        np.sort(r.final_wsig, axis=0),
        np.sort(epr._sig0(E, device=CPU).numpy(), 0))
    cap = E // R
    rank_of = r.final_placement[r.final_slot_expert]
    np.testing.assert_array_equal(rank_of, np.arange(E) // cap)


def test_moved_bytes_are_executed_volume():
    r = _run(strategy="diff-comm", lb_every=6)
    np.testing.assert_array_equal(r.moved_bytes,
                                  r.moved_experts * TW.weight_bytes)
    fired = r.lb_fired.astype(bool)
    assert (r.moved_experts[~fired] == 0).all()
    assert r.moved_experts[fired].sum() > 0


def test_rebalancing_reduces_skew():
    """With a drifting hotspot the cadence-triggered diffusion replay ends
    less imbalanced than never rebalancing; both equal the JAX
    package's."""
    kw = dict(num_experts=32, num_ranks=4, hot_amp=8.0,
              tokens_per_step=512, trace_len=32, seed=3)
    tw, jw = epr.RoutingWorkload(**kw), j_epr.RoutingWorkload(**kw)
    never = epr.run_ep_replay(tw, steps=32, strategy="none", device=CPU)
    lb = epr.run_ep_replay(tw, steps=32, strategy="diff-comm", lb_every=4,
                           device=CPU)
    assert lb.max_avg[-8:].mean() < never.max_avg[-8:].mean()
    assert never.lb_fired.sum() == 0
    _equal(lb, j_epr.run_ep_replay(jw, steps=32, strategy="diff-comm",
                                   lb_every=4), "lb_every=4")


def _predictive(pkg_trig, pkg_cost, **cost):
    return pkg_trig.PredictiveTrigger(cost=pkg_cost.RuntimeCostModel(**cost))


def test_predictive_gate_uses_measured_bytes():
    """Pricing weight bytes up makes the predictive trigger fire less:
    the gate reads the executed volume of the last exchange.  Fire steps,
    placements and bytes equal the JAX package's under both prices, on
    both loops."""
    cheap_c = dict(t_byte=1e-6)
    dear_c = dict(t_byte=0.5, lb_overhead=50.0)
    kw = dict(steps=32, strategy="diff-comm")
    cheap = _run(trigger=_predictive(t_trig, t_cost, **cheap_c), **kw)
    dear = _run(trigger=_predictive(t_trig, t_cost, **dear_c), **kw)
    assert dear.lb_fired.sum() < cheap.lb_fired.sum()
    assert cheap.lb_fired.sum() > 0
    _equal(cheap, _run(trigger=_predictive(t_trig, t_cost, **cheap_c),
                       scan=False, **kw), "predictive host loop")
    _equal(cheap, _jax(trigger=_predictive(j_trig, j_cost, **cheap_c),
                       **kw), "predictive (cheap) vs JAX")
    _equal(dear, _jax(trigger=_predictive(j_trig, j_cost, **dear_c), **kw),
           "predictive (dear) vs JAX")


def test_greedy_baseline_moves_more():
    """The capacity-capped greedy rebalances from scratch every fire on
    the host loop; diffusion moves incrementally.  The greedy replay
    equals the JAX package's."""
    d = _run(strategy="diff-comm", lb_every=6)
    g = _run(strategy="greedy", lb_every=6)
    assert not g.scanned                     # host baseline path
    assert d.total_moved_bytes <= g.total_moved_bytes
    _equal(g, _jax(strategy="greedy", lb_every=6), "greedy vs JAX")
    with pytest.raises(ValueError, match="jittable"):
        _run(strategy="ep-greedy", lb_every=6, scan=True)


def test_trace_workload_replays_like_source():
    trace = epr.record_routing(TW, steps=24, device=CPU)
    assert trace.table.shape == (24, 256, 4) and trace.top_k == 4
    np.testing.assert_array_equal(trace.table.numpy(), JW.ids_table()[:24])
    a = _run(strategy="diff-comm", lb_every=6)
    b = epr.run_ep_replay(trace, steps=24, strategy="diff-comm", lb_every=6,
                          device=CPU)
    _equal(a, b, "trace vs source")


def test_telemetry_records_the_replay():
    """``telemetry="full"``: one record a step that agrees with the
    result's arrays; ``off`` gives the run without it."""
    r = _run(strategy="diff-comm", lb_every=6, telemetry="full")
    off = _run(strategy="diff-comm", lb_every=6, telemetry="off")
    _equal(r, off, "telemetry full vs off")
    snap = r.telemetry
    assert off.telemetry is None and snap.steps_total == 24
    for col, arr in (("t", np.arange(24)), ("fired", r.lb_fired),
                     ("moved_items", r.moved_experts),
                     ("moved_bytes", r.moved_bytes)):
        np.testing.assert_array_equal(snap.column(col),
                                      np.asarray(arr, np.float32))
    assert snap.node_loads.shape == (24, W["num_ranks"])
    assert (snap.column("sweeps")[r.lb_fired == 1] > 0).all()


def test_ema_update_has_xla_cpu_bits():
    """``ema_update`` equals the JAX package's jitted EMA bit for bit
    (XLA contracts it into a fused multiply-add), where the plain two
    roundings differ."""
    rng = np.random.default_rng(0)
    n = 1 << 16
    old = (rng.random(n) * 1000).astype(np.float32)
    new = rng.integers(0, 4096, n).astype(np.float32)
    for ema in (0.9, 0.5, 0.7):
        want = np.asarray(jax.jit(lambda a, b: ema * a + (1.0 - ema) * b)(
            old, new))
        got = epr.ema_update(ema, torch.as_tensor(old), torch.as_tensor(new))
        np.testing.assert_array_equal(got.numpy(), want)
    plain = (np.float32(0.9) * old + np.float32(0.1) * new)
    want = np.asarray(jax.jit(lambda a, b: 0.9 * a + 0.1 * b)(old, new))
    assert (plain != want).any()


# --------------------------------------------------- real-weight exchange --


def _tiny_moe(seed=0):
    """Reduced deepseek-v3 MoE weights (8 experts, one shared expert) as
    NumPy, f32, and the config."""
    cfg = dataclasses.replace(get_arch("deepseek-v3-671b").reduced,
                              compute_dtype="float32")
    rng = np.random.default_rng(seed)
    np_params = tree_map(lambda s: (rng.normal(size=s.shape) * 0.3).astype(
        np.float32), t_moe.moe_specs(cfg))
    return cfg, np_params


def test_execute_placement_preserves_moe_semantics():
    """Relocating expert weights and router columns through the executed
    manifest keeps the MoE layer's function; the relocated tensors,
    slot layout and moved bytes equal the JAX package's."""
    cfg, npp = _tiny_moe()
    params = tree_map(torch.tensor, npp)
    E, R = cfg.moe.num_experts, 4
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(2, 8, cfg.d_model)).astype(np.float32))
    y0, _ = t_moe.moe_dense(params, cfg, x)
    se = np.arange(E, dtype=np.int32)
    newp = np.asarray([2, 0, 1, 0, 3, 1, 2, 3], np.int32)
    layers, se2, moved, moved_b = epr.execute_placement(
        [params], se, newp, num_ranks=R, device=CPU)
    assert moved > 0
    assert moved_b == moved * epr.expert_param_bytes([params])
    y1, _ = t_moe.moe_dense(layers[0], cfg, x)
    np.testing.assert_allclose(y0.numpy(), y1.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(newp[se2.numpy()], np.arange(E) // (E // R))
    assert layers[0]["shared_wi"] is params["shared_wi"]
    jl, jse, jm, jb = j_epr.execute_placement(
        [{k: jnp.asarray(v) for k, v in npp.items()}], se, newp,
        num_ranks=R)
    np.testing.assert_array_equal(se2.numpy(), np.asarray(jse))
    assert (moved, moved_b) == (jm, jb)
    for k in epr.EXPERT_KEYS:
        np.testing.assert_array_equal(layers[0][k].numpy(),
                                      np.asarray(jl[0][k]), err_msg=k)
    # in place: the same tensors, relocated in their own storage
    inplace = tree_map(torch.tensor, npp)
    wi = inplace["wi"]
    l2, se3, m3, _ = epr.execute_placement([inplace], se, newp,
                                           num_ranks=R, device=CPU,
                                           in_place=True)
    assert l2[0] is inplace and inplace["wi"] is wi and m3 == moved
    assert torch.equal(se3, se2)
    for k in epr.EXPERT_KEYS:
        assert torch.equal(l2[0][k], layers[0][k]), k


def test_execute_placement_stacked_layout():
    """A G-leading stack of MoE layers relocates like each layer alone
    (the expert axis is found from the end)."""
    _, a = _tiny_moe(1)
    _, b = _tiny_moe(2)
    stacked = {k: torch.tensor(np.stack([a[k], b[k]])) for k in a}
    E = stacked["wi"].shape[1]
    se = np.arange(E, dtype=np.int32)
    newp = np.asarray([1, 0, 3, 2, 1, 0, 3, 2], np.int32)
    layers, se2, _, _ = epr.execute_placement([stacked], se, newp,
                                              num_ranks=4, device=CPU)
    for k in epr.EXPERT_KEYS:
        assert layers[0][k].shape == stacked[k].shape, k
    for g, npp in enumerate((a, b)):
        lg, se2g, _, _ = epr.execute_placement(
            [tree_map(torch.tensor, npp)], se, newp, num_ranks=4,
            device=CPU)
        assert torch.equal(se2, se2g)
        for k in epr.EXPERT_KEYS:
            assert torch.equal(layers[0][k][g], lg[0][k]), k


def _metrics_stream(E, t, slot_expert, drifting):
    counts = np.full(E, 1.0 if drifting else 10.0)
    hot = (np.arange(3) + t // 3) % E if drifting else np.arange(3)
    counts[hot] += 500.0
    coact = np.ones((E, E)) - np.eye(E)
    return counts[slot_expert], coact[np.ix_(slot_expert, slot_expert)]


def _rebalance(make, cfg, layer, steps, drifting, **kw):
    """Run ``steps`` of the rebalancer ``make`` builds on the metrics
    stream; returns (rebalancer, final layer)."""
    E = cfg.moe.num_experts
    reb = make(E, 2, strategy="diff-comm", ema=0.0, **kw)
    layers = [layer]
    for t in range(steps):
        c, co = _metrics_stream(E, t, reb.slot_expert, drifting)
        layers, info = reb.step(t, c, co, layers)
    return reb, layers[0]


def test_rebalancer_consumes_train_metrics():
    """EPRebalancer: router statistics in, executed relocation and
    executed-byte observe out; its history equals the JAX package's."""
    cfg, npp = _tiny_moe()
    x = torch.tensor(np.random.default_rng(2).normal(
        size=(2, 8, cfg.d_model)).astype(np.float32))
    params = tree_map(torch.tensor, npp)
    y0, _ = t_moe.moe_dense(params, cfg, x)
    reb, layer = _rebalance(
        functools.partial(epr.EPRebalancer, device=CPU), cfg, params, 6,
        False, trigger="every", lb_every=2)
    jreb, jlayer = _rebalance(
        j_epr.EPRebalancer, cfg, {k: jnp.asarray(v) for k, v in npp.items()},
        6, False, trigger="every", lb_every=2)
    bpe = epr.expert_param_bytes([params])
    fired = [h for h in reb.history if h["fired"]]
    assert fired and any(h["moved_bytes"] > 0 for h in fired)
    for h in fired:
        assert h["moved_bytes"] == h["moved_experts"] * bpe
    y1, _ = t_moe.moe_dense(layer, cfg, x)
    np.testing.assert_allclose(y0.numpy(), y1.numpy(), rtol=2e-4, atol=2e-4)
    assert (np.bincount(reb.placement, minlength=2) == 4).all()
    np.testing.assert_array_equal(reb.slot_expert, jreb.slot_expert)
    for h, jh in zip(reb.history, jreb.history):
        for key in ("t", "fired", "moved_experts", "moved_bytes"):
            assert h.get(key) == jh.get(key), (h["t"], key)
        assert h["max_avg"] == pytest.approx(jh["max_avg"], rel=1e-6)
    for k in epr.EXPERT_KEYS:
        np.testing.assert_array_equal(layer[k].numpy(),
                                      np.asarray(jlayer[k]), err_msg=k)


def test_rebalancer_feeds_trigger_measured_bytes():
    """A predictive rebalancer's trigger state carries the executed volume
    of the last exchange, in load units; fire steps equal JAX's."""
    cfg, npp = _tiny_moe()

    def trig(pkg_trig, pkg_cost):
        return pkg_trig.PredictiveTrigger(
            cost=pkg_cost.RuntimeCostModel(t_byte=1e-9), min_interval=1)

    reb = epr.EPRebalancer(8, 2, strategy="diff-comm",
                           trigger=trig(t_trig, t_cost), ema=0.0,
                           device=CPU)
    assert float(reb.tstate.last_moved) < 0          # cold start
    jreb = j_epr.EPRebalancer(8, 2, strategy="diff-comm",
                              trigger=trig(j_trig, j_cost), ema=0.0)
    layers = [tree_map(torch.tensor, npp)]
    jlayers = [{k: jnp.asarray(v) for k, v in npp.items()}]
    last = None
    for t in range(8):
        c, co = _metrics_stream(8, t, reb.slot_expert, True)
        layers, info = reb.step(t, c, co, layers)
        jc, jco = _metrics_stream(8, t, jreb.slot_expert, True)
        jlayers, jinfo = jreb.step(t, jc, jco, jlayers)
        assert info["fired"] == jinfo["fired"], t
        if info["fired"]:
            last = info
            assert info["moved_bytes"] == jinfo["moved_bytes"]
    assert last is not None, "predictive trigger must fire"
    assert float(reb.tstate.last_moved) >= 0
    assert float(reb.tstate.last_moved) * reb.bytes_per_load == \
        pytest.approx(last["moved_bytes"])
    assert float(reb.tstate.last_moved) == float(jreb.tstate.last_moved)


def test_routing_skew_scenario_registered():
    from repro_torch.sim import scenarios

    prob, evolve = scenarios.get("routing-skew").instantiate(
        device=CPU, num_experts=32, num_ranks=4, tokens_per_step=256,
        trace_len=12)
    assert int(prob.loads.shape[0]) == 32 and prob.num_nodes == 4
    p1 = evolve(prob, torch.tensor(3, dtype=torch.int32))
    assert p1.loads.shape == prob.loads.shape
    assert p1.edges_bytes.shape == prob.edges_bytes.shape
    assert bool((p1.loads > 0).all())
    assert evolve.device_resident


# ------------------------------------------------ 8 shards on one device --


def test_ep_runtime_on_8_shards():
    """The JAX package's 8-virtual-device test as a ``ShardMesh(8)`` on
    the CPU: the sharded replay equals the single-device host loop (and
    the JAX package's), the ring weight exchange over 4 shards equals the
    single-device relocation."""
    kw = dict(num_experts=32, num_ranks=8, tokens_per_step=256,
              trace_len=16, seed=2)
    w = epr.RoutingWorkload(**kw)
    r1 = epr.run_ep_replay(w, steps=8, strategy="diff-comm", lb_every=3,
                           scan=False, device=CPU)
    r8 = epr.run_ep_replay(w, steps=8, strategy="diff-comm", lb_every=3,
                           num_shards=8, device=CPU)
    assert r8.sharded and not r8.scanned and r1.lb_fired.sum() > 0
    _equal(r8, r1, "8 shards vs one device")
    _equal(r1, j_epr.run_ep_replay(j_epr.RoutingWorkload(**kw), steps=8,
                                   strategy="diff-comm", lb_every=3,
                                   scan=False), "host loop vs JAX")
    r8m = epr.run_ep_replay(w, steps=8, strategy="diff-comm", lb_every=3,
                            mesh=ShardMesh(8, CPU), device=CPU)
    _equal(r8m, r1, "mesh= vs one device")
    with pytest.raises(ValueError, match="host-driven"):
        epr.run_ep_replay(w, steps=2, num_shards=8, scan=True, device=CPU)

    rng = np.random.default_rng(0)
    E, D_, F = 16, 6, 10
    moe = dict(wi=rng.normal(size=(E, D_, F)).astype(np.float32),
               wg=rng.normal(size=(E, D_, F)).astype(np.float32),
               wo=rng.normal(size=(E, F, D_)).astype(np.float32),
               router=rng.normal(size=(D_, E)).astype(np.float32),
               shared_wi=rng.normal(size=(D_, F)).astype(np.float32))
    moe = {k: torch.tensor(v) for k, v in moe.items()}
    se = np.arange(E, dtype=np.int32)
    newp = np.repeat(np.arange(4), 4)[
        np.argsort(rng.normal(size=E), kind="stable")].astype(np.int32)
    l1, se1, m1, b1 = epr.execute_placement([moe], se, newp, num_ranks=4,
                                            device=CPU)
    l2, se2, m2, b2 = epr.execute_placement([moe], se, newp, num_ranks=4,
                                            mesh=ShardMesh(4, CPU))
    assert torch.equal(se1, se2)
    for k in moe:
        assert torch.equal(l1[0][k], l2[0][k]), k
    assert m1 == m2 and b1 == b2 and m1 > 0
