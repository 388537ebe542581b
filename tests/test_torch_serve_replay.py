"""The serving fleet replay of the port (``serve.replay``, the
``serving-trace`` scenario) against the JAX package on the CPU.

The contracts, as in ``tests/test_serve_replay.py``:

  * the device-resident loop equals the host loop bit for bit: fire
    steps, per-tick records and the final per-session placement;
  * the port equals the JAX package's replay of the same workload: fire
    steps, ``final_replica_by_uid``, moved sessions, deferred counts and
    occupancy exactly; max/avg, prefix locality and moved KV within
    ``RTOL`` (in practice equal: every float sum that feeds a decision
    adds in the JAX package's CPU order);
  * every exchange conserves the sessions and their KV bytes; a slot
    budget bounds occupancy; a recorded trace reproduces its source and
    loops past its length;
  * the multi-replica-group (sharded) path — fired exchanges as ring
    all-to-alls over a ``ShardMesh`` of D shards on one device — equals
    the device-resident loop bit for bit at D ∈ {1, 2, 4, 8}, and refuses
    ``scan=True``.
"""
import functools

import numpy as np
import pytest
import torch

from repro.runtime.cost import RuntimeCostModel as JCost
from repro.runtime.triggers import PredictiveTrigger as JPredictive
from repro.serve import replay as j_sr
from repro.sim import scenarios as j_scen
from repro.sim import simulator as j_sim
from repro_torch.runtime.cost import RuntimeCostModel as TCost
from repro_torch.runtime.triggers import PredictiveTrigger as TPredictive
from repro_torch.serve import replay as t_sr
from repro_torch.sim import scenarios as t_scen
from repro_torch.sim import simulator as t_sim

CPU = "cpu"
RTOL = 1e-6
EXACT_FIELDS = ("lb_fired", "moved_sessions", "deferred", "occ_max")
FLOAT_FIELDS = ("max_avg", "prefix_local", "moved_kv_bytes")


def _wl(pkg, **kw):
    base = dict(num_sessions=48, num_replicas=4, group_size=4,
                turn_period=6, turn_len=3, burst_period=7, seed=0)
    base.update(kw)
    return pkg.ServeWorkload(**base)


def _assert_parity(ref, got):
    """Two loops of the port: every record and the placement equal."""
    for f in EXACT_FIELDS + FLOAT_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(ref, f)), np.asarray(getattr(got, f)),
            err_msg=f"serving replay diverged on {f}")
    np.testing.assert_array_equal(ref.final_replica_by_uid,
                                  got.final_replica_by_uid)
    np.testing.assert_array_equal(np.sort(ref.final_uid),
                                  np.sort(got.final_uid))


def _assert_matches_jax(got, want):
    for f in EXACT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, err_msg=f)
    np.testing.assert_array_equal(got.final_replica_by_uid,
                                  want.final_replica_by_uid)
    np.testing.assert_allclose(np.sort(got.final_kv), np.sort(want.final_kv),
                               rtol=RTOL)


# -------------------------------------- device loop / host loop / JAX --


@pytest.mark.parametrize("trigger", [None, "every", "threshold"])
def test_scan_matches_host(trigger):
    kw = dict(steps=24, lb_every=6, strategy="diff-comm", trigger=trigger)
    dev = t_sr.run_serve_replay(_wl(t_sr), scan=True, device=CPU, **kw)
    host = t_sr.run_serve_replay(_wl(t_sr), scan=False, device=CPU, **kw)
    assert dev.scanned and not host.scanned
    assert dev.lb_fired.sum() > 0
    _assert_parity(dev, host)
    _assert_matches_jax(dev, j_sr.run_serve_replay(_wl(j_sr), scan=True,
                                                   **kw))


def test_scan_matches_host_predictive_measured_gate():
    def kw(pkg_trig, cost):
        return dict(steps=30, lb_every=5, strategy="diff-comm+predictive",
                    trigger=pkg_trig(cost=cost(bytes_per_load=8.0)))

    dev = t_sr.run_serve_replay(_wl(t_sr), scan=True, device=CPU,
                                **kw(TPredictive, TCost))
    host = t_sr.run_serve_replay(_wl(t_sr), scan=False, device=CPU,
                                 **kw(TPredictive, TCost))
    assert dev.lb_fired.sum() > 0
    _assert_parity(dev, host)
    _assert_matches_jax(dev, j_sr.run_serve_replay(
        _wl(j_sr), scan=True, **kw(JPredictive, JCost)))


def test_port_equals_jax_on_the_serve_bench_policy():
    """The serve bench's predictive policy (the measured gate fires about
    every other tick) under a slot budget on 256 sessions: fire steps,
    placements, moved sessions and deferred counts exactly as the JAX
    package's, moved KV within ``RTOL``."""
    def kw(trig, cost):
        return dict(steps=40, lb_every=10, strategy="diff-comm+predictive",
                    slot_capacity=36,
                    trigger=trig(cost=cost(t_byte=2e-3, lb_overhead=1.0)))

    w = dict(num_sessions=256, num_replicas=8, seed=2)
    got = t_sr.run_serve_replay(t_sr.ServeWorkload(**w), device=CPU,
                                **kw(TPredictive, TCost))
    want = j_sr.run_serve_replay(j_sr.ServeWorkload(**w),
                                 **kw(JPredictive, JCost))
    assert got.lb_fired.sum() >= 5 and got.deferred.sum() > 0
    _assert_matches_jax(got, want)


def test_every_trigger_fires_on_legacy_cadence():
    r = t_sr.run_serve_replay(_wl(t_sr), steps=25, lb_every=10,
                              strategy="diff-comm", trigger="every",
                              device=CPU)
    assert list(np.flatnonzero(r.lb_fired)) == [10, 20]


# ----------------------------------------------------------- conservation --


def test_exchanges_conserve_sessions_and_kv():
    w = _wl(t_sr, num_sessions=64)
    r = t_sr.run_serve_replay(w, steps=20, lb_every=4, strategy="diff-comm",
                              trigger="every", device=CPU)
    assert r.lb_fired.sum() >= 4 and r.total_moved_kv > 0
    S = w.num_sessions
    np.testing.assert_array_equal(np.sort(r.final_uid), np.arange(S))
    # each session's KV is its initial KV plus its decode growth, added
    # in the same order: the exchanges add nothing and lose nothing
    uid = torch.arange(S, dtype=torch.int32)
    kv = w.kv0_of(uid)
    for t in range(20):
        kv = kv + w.kv_per_token * w.loads_at(t, uid)
    by_uid = np.empty(S, np.float32)
    by_uid[r.final_uid] = r.final_kv
    np.testing.assert_array_equal(by_uid, kv.numpy())


def test_no_lb_keeps_initial_block_placement():
    w = _wl(t_sr)
    r = t_sr.run_serve_replay(w, steps=8, strategy="none", device=CPU)
    assert r.lb_fired.sum() == 0 and r.total_moved_kv == 0
    S, R = w.num_sessions, w.num_replicas
    np.testing.assert_array_equal(r.final_replica_by_uid,
                                  (np.arange(S) * R) // S)


# -------------------------------------------------------------- capacity --


def test_slot_capacity_bounds_occupancy_and_defers():
    cap = 18                      # 64 sessions / 4 replicas = 16 each
    kw = dict(steps=24, lb_every=4, strategy="diff-comm", trigger="every",
              slot_capacity=cap)
    r = t_sr.run_serve_replay(_wl(t_sr, num_sessions=64), scan=True,
                              device=CPU, **kw)
    assert r.occ_max.max() <= cap and r.deferred.sum() > 0
    assert np.sort(r.final_uid).tolist() == list(range(64))
    host = t_sr.run_serve_replay(_wl(t_sr, num_sessions=64), scan=False,
                                 device=CPU, **kw)
    _assert_parity(r, host)
    _assert_matches_jax(r, j_sr.run_serve_replay(
        _wl(j_sr, num_sessions=64), **kw))
    free = t_sr.run_serve_replay(
        _wl(t_sr, num_sessions=64), steps=24, lb_every=4,
        strategy="diff-comm", trigger="every", device=CPU)
    assert free.occ_max.max() > cap or free.deferred.sum() == 0


# ------------------------------------------------------------ trace replay --


def test_trace_workload_reproduces_its_source():
    w = _wl(t_sr)
    tw = t_sr.record_trace(w, steps=20, device=CPU)
    jtw = j_sr.record_trace(_wl(j_sr), steps=20)
    np.testing.assert_array_equal(tw.table.numpy(), np.asarray(jtw.table))
    np.testing.assert_array_equal(tw.group.numpy(), np.asarray(jtw.group))
    kw = dict(steps=20, lb_every=5, strategy="diff-comm", trigger="every")
    ref = t_sr.run_serve_replay(w, scan=True, device=CPU, **kw)
    got = t_sr.run_serve_replay(tw, scan=True, device=CPU, **kw)
    _assert_parity(ref, got)
    _assert_parity(got, t_sr.run_serve_replay(tw, scan=False, device=CPU,
                                              **kw))


def test_trace_loops_past_its_length():
    tw = t_sr.record_trace(_wl(t_sr), steps=6, device=CPU)
    r = t_sr.run_serve_replay(tw, steps=15, lb_every=5,
                              strategy="diff-comm", device=CPU)
    assert np.isfinite(r.max_avg).all()
    want = j_sr.run_serve_replay(j_sr.record_trace(_wl(j_sr), steps=6),
                                 steps=15, lb_every=5, strategy="diff-comm")
    _assert_matches_jax(r, want)


# ------------------------------------------------------- host baselines --


def test_greedy_baseline_executes_real_exchanges():
    kw = dict(steps=18, lb_every=6, strategy="greedy", trigger="every")
    r = t_sr.run_serve_replay(_wl(t_sr), device=CPU, **kw)
    assert not r.scanned               # a host planner: the host loop
    assert r.lb_fired.sum() > 0 and r.total_moved_kv > 0
    np.testing.assert_array_equal(np.sort(r.final_uid), np.arange(48))
    _assert_matches_jax(r, j_sr.run_serve_replay(_wl(j_sr), **kw))


def test_scan_rejects_host_only_strategy():
    with pytest.raises(ValueError, match="not jittable"):
        t_sr.run_serve_replay(_wl(t_sr), steps=4, strategy="greedy",
                              scan=True, device=CPU)


def test_sharded_paths_raise_not_implemented():
    """What the multi-replica-group path refuses (it was the sharded
    slice's ``NotImplementedError`` before that slice): ``scan=True`` (a
    host-driven loop, as in the JAX package), a mesh that is not a
    ``ShardMesh``, a shard count the sessions or replicas do not divide,
    and ``mesh`` with ``num_shards``."""
    from repro_torch.distributed.mesh import ShardMesh

    w = _wl(t_sr)
    with pytest.raises(ValueError, match="host-driven"):
        t_sr.run_serve_replay(w, steps=4, scan=True, num_shards=2,
                              device=CPU)
    with pytest.raises(TypeError, match="ShardMesh"):
        t_sr.run_serve_replay(w, steps=4, mesh=object(), device=CPU)
    with pytest.raises(ValueError, match="divide"):
        t_sr.run_serve_replay(w, steps=4, num_shards=3, device=CPU)
    with pytest.raises(ValueError, match="not both"):
        t_sr.run_serve_replay(w, steps=4, num_shards=2,
                              mesh=ShardMesh(2, CPU), device=CPU)


@pytest.mark.parametrize("D", [1, 2, 4])
def test_sharded_matches_scanned(D):
    """The JAX package's ``test_sharded_matches_scanned_single_shard`` at
    D shards: every record and the placement bit for bit the
    device-resident loop's, and the JAX package's scanned replay in its
    exact fields."""
    w = _wl(t_sr)
    kw = dict(steps=20, lb_every=5, strategy="diff-comm", trigger="every")
    ref = t_sr.run_serve_replay(w, scan=True, device=CPU, **kw)
    sh = t_sr.run_serve_replay(w, num_shards=D, device=CPU, **kw)
    assert sh.sharded and not sh.scanned and not ref.sharded
    assert ref.lb_fired.sum() > 0
    _assert_parity(ref, sh)
    np.testing.assert_array_equal(sh.final_uid, ref.final_uid)
    np.testing.assert_array_equal(sh.final_kv, ref.final_kv)
    _assert_matches_jax(sh, _jax_sharded_ref())


@functools.lru_cache(maxsize=None)
def _jax_sharded_ref():
    return j_sr.run_serve_replay(
        _wl(j_sr), scan=True, steps=20, lb_every=5, strategy="diff-comm",
        trigger="every")


@pytest.mark.parametrize("trigger", ["every", "threshold"])
def test_sharded_fleet_on_8_shards(trigger):
    """The JAX package's 8-device test, in process: 256 sessions on 16
    replicas over 8 shards equal the single-device replay."""
    w = t_sr.ServeWorkload(num_sessions=256, num_replicas=16, group_size=4,
                           turn_period=6, turn_len=3, burst_period=7, seed=0)
    kw = dict(steps=20, lb_every=5, strategy="diff-comm", trigger=trigger)
    ref = t_sr.run_serve_replay(w, scan=True, device=CPU, **kw)
    sh = t_sr.run_serve_replay(w, num_shards=8, device=CPU, **kw)
    assert sh.sharded and ref.lb_fired.sum() > 0
    _assert_parity(ref, sh)
    np.testing.assert_array_equal(np.sort(sh.final_uid), np.arange(256))


# -------------------------------------------------- serving-trace scenario --


def test_serving_trace_scenario_parity():
    kw_i = dict(num_sessions=64, num_replicas=4, trace_len=24)
    tp, tev = t_scen.get("serving-trace").instantiate(device=CPU, **kw_i)
    tp.validate()
    jp, jev = j_scen.get("serving-trace").instantiate(**kw_i)
    kw = dict(steps=18, lb_every=6, strategy="diff-comm",
              strategy_kwargs=dict(k=2))
    dev = t_sim.run_series(tp, tev, scan=True, **kw)
    host = t_sim.run_series(tp, tev, scan=False, **kw)
    for f in ("max_avg", "lb_fired", "migrations", "migrated_load",
              "final_assignment"):
        np.testing.assert_array_equal(
            np.asarray(getattr(dev, f)), np.asarray(getattr(host, f)),
            err_msg=f"serving-trace scenario diverged on {f}")
    want = j_sim.run_series(jp, jev, scan=True, **kw)
    for f in ("lb_fired", "final_assignment"):
        np.testing.assert_array_equal(getattr(dev, f), getattr(want, f))
    # the sharded replay of the scenario: the device loop's bits
    sh = t_sim.run_series_sharded(tp, tev, num_shards=2, **kw)
    np.testing.assert_array_equal(dev.max_avg, sh.max_avg)
    np.testing.assert_array_equal(dev.final_assignment, sh.final_assignment)
    for f in ("max_avg", "migrations", "migrated_load"):
        np.testing.assert_allclose(getattr(dev, f), getattr(want, f),
                                   rtol=RTOL, err_msg=f)
