"""The port's resilience layer (``runtime.resilience``, the masked trigger
stats, ``LBEngine.plan_health_fn``, the spill exchange and the resilient
sharded replays) against the JAX package, on the CPU.

Contracts, as in ``tests/test_resilience.py``:

  * a ``FaultSchedule``'s health projection equals the JAX package's at
    every step; an empty or never-active schedule changes nothing;
  * ``rehome_dead``, ``mask_preference``, ``load_stats_masked``,
    ``plan_health_fn`` and ``validate_plan`` give the JAX package's
    answers on the same inputs (integers exact, floats within ``RTOL``);
  * a dead shard is evacuated with nothing lost (series: no object on a
    dead node; PIC: every particle kept) — at D ∈ {1, 2, 4} shards, each
    run held to the JAX package's 1-device resilient run where D = 1
    gives the same health, and to the port's run at another D;
  * the spill exchange keeps every item and defers exactly what the
    admission fixed point says;
  * the checkpointed replay equals the uninterrupted one bit for bit,
    with and without injected failures.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._hyp import given, settings, st

from repro.core import comm_graph as j_cg
from repro.core import engine as j_engine
from repro.runtime import migrate as j_migrate
from repro.runtime import resilience as j_rz
from repro.runtime import triggers as j_trig
from repro.sim import scenarios as j_scen
from repro.sim import simulator as j_sim
from repro_torch import interop
from repro_torch.core import comm_graph
from repro_torch.core import engine as core_engine
from repro_torch.distributed.mesh import ShardMesh
from repro_torch.pic import driver as pic_driver
from repro_torch.runtime import migrate as rt_migrate
from repro_torch.runtime import resilience as rz
from repro_torch.runtime import triggers as rt_triggers
from repro_torch.sim import scenarios, simulator

CPU = "cpu"
RTOL = 1e-5
SERIES_FIELDS = ("max_avg", "ext_int", "migrations", "lb_fired",
                 "max_load", "migrated_load", "final_assignment")


# --------------------------------------------------------- FaultSchedule --


def test_fault_schedule_validates_events():
    with pytest.raises(ValueError, match="unknown fault kind"):
        rz.FaultSchedule(events=((1, 0, "explode"),))
    with pytest.raises(ValueError, match="non-negative"):
        rz.FaultSchedule(events=((-1, 0, "die"),))
    with pytest.raises(ValueError, match="duplicate"):
        rz.FaultSchedule(events=((3, 1, "die"), (3, 1, "recover")))
    with pytest.raises(ValueError, match="slow_factor"):
        rz.FaultSchedule(events=((1, 0, "slow"),), slow_factor=0.0)
    assert rz.FaultSchedule().empty
    assert rz.FaultSchedule().max_shard() == -1
    assert rz.FaultSchedule(events=((2, 3, "die"),)).max_shard() == 3
    hash(rz.FaultSchedule(events=((2, 3, "die"),)))


@pytest.mark.parametrize("events", [
    ((5, 1, "die"), (9, 1, "recover"), (3, 0, "slow")),
    ((2, 0, "die"), (2, 2, "slow"), (6, 2, "recover"), (7, 0, "recover"),
     (8, 3, "slow"), (10, 3, "die")),
])
def test_fault_schedule_health_equals_jax(events):
    fs = rz.FaultSchedule(events=events, slow_factor=0.25)
    jfs = j_rz.FaultSchedule(events=events, slow_factor=0.25)
    for t in range(-1, 13):
        a, s = fs.shard_health(t, 4)
        ja, js = jfs.shard_health(t, 4)
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        assert fs.changed_at(t, 4) == bool(jfs.changed_at(t, 4))
        an, sn = fs.node_health(t, 8, 4)
        jan, jsn = jfs.node_health(t, 8, 4)
        np.testing.assert_array_equal(an.numpy(), np.asarray(jan))
        np.testing.assert_array_equal(sn.numpy(), np.asarray(jsn))


def test_fault_schedule_health_projection():
    fs = rz.FaultSchedule(
        events=((5, 1, "die"), (9, 1, "recover"), (3, 0, "slow")),
        slow_factor=0.25)
    alive, speed = (v.numpy() for v in fs.shard_health(6, 2))
    assert alive.tolist() == [True, False]
    assert speed.tolist() == [0.25, 1.0]
    assert fs.changed_at(5, 2) and fs.changed_at(3, 2) and fs.changed_at(9, 2)
    assert not fs.changed_at(6, 2) and not fs.changed_at(0, 2)
    alive_n, speed_n = (v.numpy() for v in fs.node_health(6, 4, 2))
    assert alive_n.tolist() == [True, True, False, False]
    assert speed_n.tolist() == [0.25, 0.25, 1.0, 1.0]


# ------------------------------------------------- health-masked planning --


def _pair(loads, assignment, edges, edge_bytes, num_nodes):
    kw = dict(loads=np.asarray(loads, np.float32),
              assignment=np.asarray(assignment, np.int32),
              edges=np.asarray(edges),
              edge_bytes=np.asarray(edge_bytes, np.float32),
              num_nodes=num_nodes)
    return (j_cg.make_problem(**kw),
            comm_graph.make_problem(**kw, device=CPU))


def test_rehome_dead_matches_jax():
    cases = [
        # node 1 dies; object 1 talks to object 0 (owner 0) → node 0
        (([1, 2, 3, 4], [0, 1, 2, 3], [[0, 1], [2, 3]], [5, 1], 4),
         [1, 0, 1, 1], [0, 0, 2, 3]),
        # node 2's object has no alive partner → least-loaded alive node
        (([9, 1, 1, 1], [0, 0, 1, 2], [[0, 1]], [1], 4), [1, 1, 0, 1],
         [0, 0, 1, 3]),
        # all dead: unchanged
        (([1, 2, 3, 4], [0, 1, 2, 3], [[0, 1], [2, 3]], [5, 1], 4),
         [0, 0, 0, 0], [0, 1, 2, 3]),
    ]
    for args, alive, want in cases:
        jp, tp = _pair(*args)
        got = rz.rehome_dead(tp, torch.as_tensor(alive, dtype=torch.bool))
        ref = j_rz.rehome_dead(jp, jnp.asarray(alive, bool))
        assert got.tolist() == want == np.asarray(ref).tolist()


def test_mask_preference_identity_when_all_alive():
    pref = torch.arange(16.0).reshape(4, 4)
    assert torch.equal(rz.mask_preference(pref, torch.ones(4, dtype=bool)),
                       pref)
    alive = torch.tensor([1, 0, 1, 1], dtype=torch.bool)
    masked = rz.mask_preference(pref, alive)
    np.testing.assert_array_equal(
        masked.numpy(), np.asarray(j_rz.mask_preference(
            jnp.arange(16.0).reshape(4, 4), jnp.asarray(alive.numpy()))))
    assert (masked[1, :] == 0).all() and (masked[:, 1] == 0).all()


def test_degrade_problem_matches_jax():
    jp, tp = _pair([1, 2, 3, 4], [0, 1, 2, 3], [[0, 1], [2, 3]], [5, 1], 4)
    alive = np.array([1, 0, 1, 1], bool)
    speed = np.array([1.0, 1.0, 0.5, 0.25], np.float32)
    got = rz.degrade_problem(tp, torch.as_tensor(alive),
                             torch.as_tensor(speed))
    ref = j_rz.degrade_problem(jp, jnp.asarray(alive), jnp.asarray(speed))
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(ref.assignment))
    np.testing.assert_array_equal(got.loads.numpy(), np.asarray(ref.loads))


def test_load_stats_masked_matches_jax():
    loads = np.array([1.0, 2.0, 3.0, 10.0], np.float32)
    a = np.array([0, 1, 2, 3], np.int32)
    for alive, speed in (([1, 1, 1, 1], None), ([1, 1, 1, 0], None),
                         ([1, 1, 1, 1], [1.0, 1.0, 1.0, 0.5])):
        got = rt_triggers.load_stats_masked(
            torch.as_tensor(loads), torch.as_tensor(a), 4,
            torch.as_tensor(alive, dtype=torch.bool),
            None if speed is None else torch.as_tensor(speed))
        ref = j_trig.load_stats_masked(
            jnp.asarray(loads), jnp.asarray(a), 4, jnp.asarray(alive, bool),
            None if speed is None else jnp.asarray(speed, jnp.float32))
        for g, r in zip(got, ref):
            assert float(g) == float(r)
    mx, av, tot = rt_triggers.load_stats_masked(
        torch.as_tensor(loads), torch.as_tensor(a), 4,
        torch.tensor([1, 1, 1, 0], dtype=torch.bool))
    assert float(mx) == 3.0 and float(av) == pytest.approx(2.0)
    assert float(tot) == 16.0
    # healthy: the unmasked stats
    um = rt_triggers.load_stats(torch.as_tensor(loads), torch.as_tensor(a),
                                4)
    hm = rt_triggers.load_stats_masked(torch.as_tensor(loads),
                                       torch.as_tensor(a), 4,
                                       torch.ones(4, dtype=torch.bool))
    assert [float(v) for v in um] == [float(v) for v in hm]


def test_engine_plan_health_fn_matches_jax_and_avoids_dead_nodes():
    jp, jev = j_scen.get("stencil-wave").instantiate(grid=8, num_nodes=4)
    jp = jev(jp, jnp.int32(3))
    d = {f: np.asarray(getattr(jp, f)) for f in
         ("loads", "assignment", "edges_src", "edges_dst", "edges_bytes")}
    d.update(num_nodes=4, coords=np.asarray(jp.coords))
    tp = interop.problem_from_numpy(d, device=CPU)
    eng = core_engine.get_engine(variant="comm", k=2, device=CPU)
    alive = np.array([1, 0, 1, 1], bool)
    speed = np.array([1.0, 1.0, 0.5, 1.0], np.float32)
    a, _ = eng.plan_health_fn(tp, torch.as_tensor(alive),
                              torch.as_tensor(speed))
    ref, _ = jax.jit(j_engine.get_engine(variant="comm", k=2)
                     .plan_health_fn)(jp, jnp.asarray(alive),
                                      jnp.asarray(speed))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ref))
    assert not np.isin(a.numpy(), [1]).any()
    assert bool(rz.validate_plan(a, tp.loads, num_nodes=4,
                                 alive=torch.as_tensor(alive)))
    a0, s0 = eng.plan_health_fn(tp, None)
    a1, s1 = eng.plan_fn(tp)
    assert torch.equal(a0, a1)
    for f, x, y in zip(s0._fields, s0, s1):
        assert torch.equal(x, y), f


# ----------------------------------------------------------- validate_plan --


@settings(max_examples=25, deadline=None)
@given(num_nodes=st.integers(min_value=1, max_value=12),
       n=st.integers(min_value=1, max_value=64),
       seed=st.integers(min_value=0, max_value=999))
def test_validate_plan_accepts_valid_assignments(num_nodes, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, num_nodes, size=n).astype(np.int32)
    loads = rng.uniform(0.1, 5.0, size=n).astype(np.float32)
    assert bool(rz.validate_plan(a, loads, num_nodes=num_nodes))
    assert bool(rz.validate_plan(a, loads, num_nodes=num_nodes,
                                 alive=np.ones(num_nodes, bool),
                                 node_capacity=n))


@settings(max_examples=25, deadline=None)
@given(num_nodes=st.integers(min_value=2, max_value=12),
       n=st.integers(min_value=2, max_value=64),
       seed=st.integers(min_value=0, max_value=999),
       mode=st.sampled_from(["range_low", "range_high", "dead", "nan",
                             "capacity"]))
def test_validate_plan_rejects_broken_assignments(num_nodes, n, seed,
                                                  mode):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, num_nodes, size=n).astype(np.int32)
    loads = rng.uniform(0.1, 5.0, size=n).astype(np.float32)
    alive = cap = None
    if mode == "range_low":
        a[rng.integers(n)] = -1
    elif mode == "range_high":
        a[rng.integers(n)] = num_nodes
    elif mode == "dead":
        dead = int(rng.integers(num_nodes))
        alive = np.ones(num_nodes, bool)
        alive[dead] = False
        a[rng.integers(n)] = dead
    elif mode == "nan":
        loads[rng.integers(n)] = np.nan
    else:
        a[:] = 0
        cap = n - 1
    assert not bool(rz.validate_plan(a, loads, num_nodes=num_nodes,
                                     alive=alive, node_capacity=cap))


def test_validate_plan_matches_jax():
    a = np.array([0, 2, 1, 2, 3], np.int32)
    loads = np.array([1.0, 2.0, 0.5, 4.0, 1.0], np.float32)
    for kw in (dict(), dict(alive=np.array([1, 1, 1, 0], bool)),
               dict(node_capacity=1), dict(node_capacity=2)):
        assert bool(rz.validate_plan(a, loads, num_nodes=4, **kw)) == \
            bool(j_rz.validate_plan(a, loads, num_nodes=4, **kw)), kw


def test_validate_plan_rejects_non_vector_assignment():
    with pytest.raises(ValueError, match="dense"):
        rz.validate_plan(torch.zeros((2, 2), dtype=torch.int32),
                         torch.ones(4), num_nodes=2)


def test_finite_or():
    v = torch.tensor([1.0, np.nan, np.inf, -2.0])
    assert rz.finite_or(v, 7.0).tolist() == [1.0, 7.0, 7.0, -2.0]


# ------------------------------------------------------------------ spill --


@settings(max_examples=25, deadline=None)
@given(P=st.integers(min_value=2, max_value=6),
       cap=st.integers(min_value=4, max_value=24),
       seed=st.integers(min_value=0, max_value=999))
def test_spill_admissions_fixed_point(P, cap, seed):
    rng = np.random.default_rng(seed)
    occ = rng.integers(0, cap + 1, size=P).astype(np.int32)
    flow = np.zeros((P, P), np.int32)
    for s in range(P):
        for d in rng.integers(0, P, size=int(rng.integers(0, occ[s] + 1))):
            if d != s:
                flow[s, d] += 1
    A = rt_migrate.spill_admissions(torch.as_tensor(flow),
                                    torch.as_tensor(occ), cap).numpy()
    F = flow * (1 - np.eye(P, dtype=np.int32))
    assert (A >= 0).all() and (A <= F).all()
    assert (occ - A.sum(1) + A.sum(0) <= cap).all()
    if (occ - F.sum(1) + F.sum(0) <= cap).all():
        np.testing.assert_array_equal(A, F)     # feasible flows stay whole


def test_spill_admissions_equals_jax():
    rng = np.random.default_rng(0)
    P = 5
    flow = rng.integers(0, 6, (P, P)).astype(np.int32)
    occ = np.full(P, 12, np.int32)
    for cap in (12, 14, 20):
        np.testing.assert_array_equal(
            rt_migrate.spill_admissions(torch.as_tensor(flow),
                                        torch.as_tensor(occ), cap).numpy(),
            np.asarray(j_migrate.spill_admissions(flow, occ, cap)))


def test_migrate_eager_capacity_error_is_structured():
    oo = torch.zeros(8, dtype=torch.int32)
    on = torch.tensor([0, 0, 0, 1, 1, 1, 1, 1], dtype=torch.int32)
    arrays = [torch.arange(8, dtype=torch.float32)]
    _, man = rt_migrate.migrate(oo, on, arrays, num_nodes=2, capacity=5)
    assert man.offsets.diff().tolist() == [3, 5]
    with pytest.raises(rt_migrate.CapacityOverflowError,
                       match="capacity") as ei:
        rt_migrate.migrate(oo, on, arrays, num_nodes=2, capacity=4)
    err = ei.value
    assert err.capacity == 4 and err.unit == "node"
    assert err.counts == [3, 5] and err.offending == [1]
    assert "node ids [1]" in str(err)


def test_migrate_sharded_spill_single_shard():
    on = np.array([1] * 7 + [0], np.int32)
    arrays = [np.arange(8, dtype=np.float32)]
    with pytest.raises(ValueError, match="occupancy"):
        rt_migrate.migrate_sharded(torch.as_tensor(on),
                                   [torch.as_tensor(arrays[0])],
                                   num_nodes=2, capacity=4,
                                   on_overflow="spill")
    owner, outs, counts, deferred = rt_migrate.migrate_sharded(
        torch.as_tensor(on), [torch.as_tensor(arrays[0])], num_nodes=2,
        capacity=8, on_overflow="spill")
    # one shard: everything stays local, in slab order
    assert deferred == 0 and int(counts.sum()) == 8
    np.testing.assert_array_equal(owner.numpy(), on)
    np.testing.assert_array_equal(outs[0].numpy(), arrays[0])


@pytest.mark.parametrize("D", [2, 4, 8])
def test_sharded_spill_keeps_every_item_and_defers_the_fixed_point(D):
    """Everything wants two shards' nodes: strict raises the structured
    error naming them, spill keeps every item once and defers exactly
    the flow the admission fixed point (the JAX package's solver) cuts."""
    P, n = 2 * D, 200 * D
    owner = np.zeros(n, np.int32)
    owner[: 3 * n // 4] = P - 1             # 3/4 to the last shard
    arrays = [torch.arange(n, dtype=torch.int32)]
    mesh = ShardMesh(D, CPU)
    with pytest.raises(rt_migrate.CapacityOverflowError) as ei:
        rt_migrate.migrate_sharded(torch.as_tensor(owner), arrays,
                                   num_nodes=P, capacity=n // D, mesh=mesh)
    inflow = np.bincount(owner // (P // D), minlength=D)
    assert ei.value.unit == "shard" and D - 1 in ei.value.offending
    assert ei.value.offending == [d for d in range(D)
                                  if inflow[d] > n // D]
    _, outs, counts, deferred = rt_migrate.migrate_sharded(
        torch.as_tensor(owner), arrays, num_nodes=P, capacity=n // D,
        mesh=mesh, on_overflow="spill")
    cap = n // D
    kept = np.concatenate([outs[0].numpy()[d * cap:d * cap + int(c)]
                           for d, c in enumerate(counts)])
    np.testing.assert_array_equal(np.sort(kept), np.arange(n))
    assert (counts.numpy() <= cap).all()
    shard_of = owner.reshape(D, -1) // (P // D)
    flow = np.stack([np.bincount(r, minlength=D) for r in shard_of])
    A = np.asarray(j_migrate.spill_admissions(flow, flow.sum(1), cap))
    assert deferred == int((flow * (1 - np.eye(D, dtype=int))).sum()
                           - A.sum()) > 0


def test_ring_exchange_rejects_unknown_mode():
    with pytest.raises(ValueError, match="on_overflow"):
        rt_migrate.migrate_sharded(torch.zeros(4, dtype=torch.int32),
                                   [torch.zeros(4)], num_nodes=2,
                                   on_overflow="drop")
    with pytest.raises(ValueError, match="mode"):
        rt_migrate.ring_exchange(torch.zeros((1, 4), dtype=torch.int32),
                                 (), num_nodes=2, mesh=ShardMesh(1, CPU),
                                 capacity=4, mode="drop")


# --------------------------------------------------- replay integration --


def _series_kw(**over):
    kw = dict(steps=16, lb_every=4, strategy="diff-comm",
              strategy_kwargs=dict(k=2))
    kw.update(over)
    return kw


def _assert_series_equal(ref, got):
    for f in SERIES_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(ref, f)), np.asarray(getattr(got, f)),
            err_msg=f"resilient replay diverged on {f}")


@functools.lru_cache(maxsize=None)
def _wave(num_nodes=4):
    return scenarios.get("stencil-wave").instantiate(
        grid=8, num_nodes=num_nodes, device=CPU)


def test_empty_schedule_is_bit_identical():
    prob, evolve = _wave()
    base = simulator.run_series_sharded(prob, evolve, **_series_kw())
    empty = simulator.run_series_sharded(
        prob, evolve, faults=rz.FaultSchedule(), **_series_kw())
    _assert_series_equal(base, empty)
    assert empty.plan_rejected is None


@pytest.mark.parametrize("D", [1, 2, 4])
def test_never_active_schedule_keeps_parity(D):
    prob, evolve = _wave()
    base = simulator.run_series_sharded(prob, evolve, num_shards=D,
                                        **_series_kw())
    never = rz.FaultSchedule(events=((10_000, 0, "die"),))
    resil = simulator.run_series_sharded(prob, evolve, faults=never,
                                         num_shards=D, **_series_kw())
    _assert_series_equal(base, resil)
    assert resil.plan_rejected is not None
    assert resil.plan_rejected.sum() == 0


def test_guard_only_mode_records_and_keeps_parity():
    prob, evolve = scenarios.get("bimodal-churn").instantiate(
        grid=8, num_nodes=4, device=CPU)
    base = simulator.run_series_sharded(prob, evolve, **_series_kw())
    guarded = simulator.run_series_sharded(prob, evolve, guard=True,
                                           **_series_kw())
    _assert_series_equal(base, guarded)
    assert guarded.plan_rejected.sum() == 0


def test_faults_validation_errors():
    prob, evolve = _wave()
    with pytest.raises(ValueError, match="shard"):
        simulator.run_series_sharded(
            prob, evolve, faults=rz.FaultSchedule(events=((2, 99, "die"),)),
            **_series_kw())
    with pytest.raises(ValueError, match="active LB"):
        simulator.run_series_sharded(
            prob, evolve, faults=rz.FaultSchedule(events=((2, 0, "die"),)),
            **_series_kw(strategy="none", strategy_kwargs=None))
    with pytest.raises(TypeError, match="FaultSchedule"):
        simulator.run_series_sharded(prob, evolve, faults=object(),
                                     **_series_kw())


def test_pic_driver_rejects_resilience_without_sharded_replay():
    base = dict(L=20, n_particles=512, steps=2, cx=4, cy=4, num_pes=2,
                device=CPU)
    cfg = pic_driver.PICConfig(**base, faults=rz.FaultSchedule(
        events=((1, 0, "die"),)))
    with pytest.raises(ValueError, match="sharded_replay"):
        pic_driver.run(cfg)
    with pytest.raises(ValueError, match="sharded_replay"):
        pic_driver.run(pic_driver.PICConfig(**base, on_overflow="spill"))


@functools.lru_cache(maxsize=None)
def _jax_dead_run(steps):
    """The JAX package's 1-device resilient replay (its one shard holds
    every node, so a shard death there is a mesh death): run on a
    schedule that slows shard 0 and recovers it, which one shard sees
    as the port's shard 0 at D = 1."""
    jp, jev = j_scen.get("stencil-wave").instantiate(grid=8, num_nodes=16)
    fs = j_rz.FaultSchedule(events=((5, 0, "slow"), (11, 0, "recover")))
    return j_sim.run_series_sharded(jp, jev, faults=fs, **_series_kw(
        steps=steps, strategy_kwargs=dict(k=3)))


def test_slowed_single_shard_matches_jax():
    prob, evolve = _wave(16)
    fs = rz.FaultSchedule(events=((5, 0, "slow"), (11, 0, "recover")))
    got = simulator.run_series_sharded(prob, evolve, faults=fs, num_shards=1,
                                       **_series_kw(strategy_kwargs=dict(
                                           k=3)))
    want = _jax_dead_run(16)
    for f in ("lb_fired", "final_assignment", "plan_rejected"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    for f in ("max_avg", "migrations", "migrated_load"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("D", [2, 4])
def test_dead_shard_is_evacuated(D):
    prob, evolve = _wave(16)
    rpd = 16 // D
    fs = rz.FaultSchedule(events=((9, D - 1, "die"),))
    dead = simulator.run_series_sharded(prob, evolve, faults=fs,
                                        num_shards=D, **_series_kw(
                                            steps=14,
                                            strategy_kwargs=dict(k=3)))
    fa = dead.final_assignment
    assert fa.shape == (64,)
    assert not np.isin(fa, np.arange((D - 1) * rpd, D * rpd)).any()
    assert dead.lb_fired[9] == 1.0 and np.isfinite(dead.max_avg).all()
    again = simulator.run_series_sharded(prob, evolve, faults=fs,
                                         num_shards=D, **_series_kw(
                                             steps=14,
                                             strategy_kwargs=dict(k=3)))
    _assert_series_equal(dead, again)
    np.testing.assert_array_equal(dead.plan_rejected, again.plan_rejected)


@pytest.mark.parametrize("D", [2, 4])
def test_pic_dead_shard_and_spill_keep_every_particle(D):
    pic = dict(L=100, n_particles=2000, steps=18, k=1, rho=0.9, cx=10,
               cy=10, num_pes=8, mapping="striped", lb_every=4,
               strategy="diff-comm", strategy_kwargs=dict(k=3), seed=0,
               device=CPU)
    none = pic_driver.run(pic_driver.PICConfig(**dict(
        pic, strategy="none", strategy_kwargs=None)))
    pr = pic_driver.run(pic_driver.PICConfig(
        sharded_replay=True, replay_shards=D,
        faults=rz.FaultSchedule(events=((8, D - 1, "die"),)), **pic))
    np.testing.assert_array_equal(pr.final_x, none.final_x)
    np.testing.assert_array_equal(pr.final_y, none.final_y)
    assert pr.lb_steps[8] == 1.0 and pr.plan_rejected is not None
    sp = pic_driver.run(pic_driver.PICConfig(
        sharded_replay=True, replay_shards=D, on_overflow="spill",
        replay_capacity=2000 // D + 60, **dict(pic, lb_every=2)))
    np.testing.assert_array_equal(sp.final_x, none.final_x)
    np.testing.assert_array_equal(sp.final_y, none.final_y)
    assert sp.deferred.max() > 0 and sp.deferred[-1] == 0
    assert (sp.shard_counts <= 2000 // D + 60).all()


# ------------------------------------------------- checkpointed replay --


def test_checkpointed_is_bit_exact_without_failures():
    prob, evolve = _wave()
    base = simulator.run_series_sharded(prob, evolve, **_series_kw())
    ck = rz.run_series_checkpointed(prob, evolve, checkpoint_every=5,
                                    **_series_kw())
    _assert_series_equal(base, ck)


@pytest.mark.parametrize("D", [1, 2])
def test_checkpointed_restarts_bit_exact(D):
    prob, evolve = scenarios.get("bimodal-churn").instantiate(
        grid=8, num_nodes=4, device=CPU)
    base = simulator.run_series_sharded(prob, evolve, num_shards=D,
                                        **_series_kw(trigger="predictive"))
    ck = rz.run_series_checkpointed(prob, evolve, checkpoint_every=3,
                                    fail_at=(1, 3, 3), num_shards=D,
                                    **_series_kw(trigger="predictive"))
    _assert_series_equal(base, ck)


def test_checkpointed_composes_with_guard_and_faults():
    prob, evolve = _wave(16)
    fs = rz.FaultSchedule(events=((6, 1, "die"), (12, 1, "recover")))
    one = simulator.run_series_sharded(prob, evolve, faults=fs,
                                       num_shards=4, **_series_kw())
    ck = rz.run_series_checkpointed(prob, evolve, checkpoint_every=4,
                                    faults=fs, fail_at=(2,), num_shards=4,
                                    **_series_kw())
    _assert_series_equal(one, ck)
    np.testing.assert_array_equal(one.plan_rejected, ck.plan_rejected)


def test_checkpointed_validates_cadence_and_exhausts_restarts():
    from repro_torch.train import fault_tolerance as ft

    prob, evolve = _wave()
    with pytest.raises(ValueError, match="checkpoint_every"):
        rz.run_series_checkpointed(prob, evolve, checkpoint_every=0,
                                   **_series_kw())
    with pytest.raises(ft.WorkerFailure):
        rz.run_series_checkpointed(prob, evolve, checkpoint_every=4,
                                   fail_at=(1, 2, 3), max_restarts=2,
                                   **_series_kw())
