"""The port's sharded replays (``distributed.replay_shard``) against the
port's single-device loops and the JAX package, on the CPU.

Contracts, as in ``tests/test_replay_shard.py``, at D ∈ {1, 2, 4} shards
of one device, in process:

  * ``run_series_sharded`` equals the port's device-resident
    ``run_series`` bit for bit in every series field, and the JAX
    package's scanned replay and its 1-device ``run_series_sharded`` on
    the same (JAX-recorded) loads: fire steps, migrations and the final
    assignment exactly, float records within ``RTOL`` (in practice equal);
  * the sharded PIC driver (``PICConfig(sharded_replay=True)``) equals the
    single-device driver bit for bit in every PIC field (``final_x`` /
    ``final_y`` included) and the JAX package's scanned and sharded
    drivers in the integer-valued records, positions within 1e-4;
  * repeated exchanges keep every particle; an undersized capacity raises
    after the run; host planners are refused.
"""
import dataclasses
import functools
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.pic import driver as j_driver
from repro.runtime import migrate as j_migrate
from repro.sim import scenarios as j_scen
from repro.sim import simulator as j_sim
from repro_torch import interop
from repro_torch.distributed.mesh import ShardMesh
from repro_torch.pic import driver as t_driver
from repro_torch.runtime import migrate as t_migrate
from repro_torch.sim import scenarios as t_scen
from repro_torch.sim import simulator as t_sim

CPU = "cpu"
RTOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]
SERIES_FIELDS = ("max_avg", "ext_int", "migrations", "lb_fired",
                 "max_load", "migrated_load", "final_assignment")
SERIES_EXACT = ("lb_fired", "migrations", "final_assignment")
PIC_FIELDS = ("max_avg", "ext_bytes", "int_bytes", "migrations",
              "migrated_bytes", "lb_steps", "final_x", "final_y")
PIC_EXACT = ("lb_steps", "migrated_bytes", "ext_bytes", "int_bytes",
             "max_avg")


def _bitwise(got, want, fields):
    for f in fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
            err_msg=f"sharded replay diverged on {f}")


def _matches_jax(got, want):
    for f in SERIES_EXACT:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    for f in ("max_avg", "ext_int", "max_load", "migrated_load"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=RTOL, atol=1e-6, err_msg=f)


@functools.lru_cache(maxsize=None)
def _recorded(name, steps, grid=8, num_nodes=4):
    """(port problem, port evolve, JAX problem, JAX evolve): both evolves
    replay the loads and edge bytes JAX's evolve gives at each step."""
    jp, jev = j_scen.get(name).instantiate(grid=grid, num_nodes=num_nodes)
    states = [jev(jp, jnp.int32(t)) for t in range(steps)]
    loads = np.stack([np.asarray(s.loads) for s in states])
    ebytes = np.stack([np.asarray(s.edges_bytes) for s in states])

    def j_evolve(p, t):
        return dataclasses.replace(p, loads=jnp.asarray(loads)[t],
                                   edges_bytes=jnp.asarray(ebytes)[t])
    j_evolve.jittable = True

    d = {f: np.asarray(getattr(jp, f)) for f in
         ("loads", "assignment", "edges_src", "edges_dst", "edges_bytes")}
    d.update(num_nodes=jp.num_nodes, coords=np.asarray(jp.coords))
    tp = interop.problem_from_numpy(d, device=CPU)
    t_loads, t_bytes = torch.as_tensor(loads), torch.as_tensor(ebytes)

    def t_evolve(p, t):
        return dataclasses.replace(p, loads=t_loads[t],
                                   edges_bytes=t_bytes[t])
    t_evolve.device_resident = True
    return tp, t_evolve, jp, j_evolve


@functools.lru_cache(maxsize=None)
def _jax_series(name, steps, lb_every, trigger, threads, sharded):
    _, _, jp, jev = _recorded(name, steps)
    kw = dict(steps=steps, lb_every=lb_every, strategy="diff-comm",
              strategy_kwargs=dict(k=2), trigger=trigger,
              threads_per_node=threads)
    if sharded:
        return j_sim.run_series_sharded(jp, jev, **kw)
    return j_sim.run_series(jp, jev, scan=True, **kw)


SERIES_CASES = [("stencil-wave", 14, 4, None), ("bimodal-churn", 20, 5,
                                                "threshold"),
                ("bimodal-churn", 20, 5, "predictive")]


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("name,steps,lb_every,trigger", SERIES_CASES)
def test_series_sharded_matches_device_loop_and_jax(name, steps, lb_every,
                                                    trigger, D):
    tp, tev, _, _ = _recorded(name, steps)
    kw = dict(steps=steps, lb_every=lb_every, strategy="diff-comm",
              strategy_kwargs=dict(k=2), trigger=trigger)
    ref = t_sim.run_series(tp, tev, **kw)
    sh = t_sim.run_series_sharded(tp, tev, num_shards=D, **kw)
    assert sh.scanned and ref.scanned and sh.lb_fired.sum() > 0
    assert sh.plan_rejected is None
    _bitwise(sh, ref, SERIES_FIELDS)
    _matches_jax(sh, _jax_series(name, steps, lb_every, trigger, None,
                                 False))
    if trigger is None:
        # the JAX package's 1-device sharded replay (its own tests hold it
        # to its scanned replay bit for bit under every trigger)
        _matches_jax(sh, _jax_series(name, steps, lb_every, trigger, None,
                                     True))


@pytest.mark.parametrize("D", [1, 4])
def test_series_sharded_threads_per_node_parity(D):
    tp, tev, _, _ = _recorded("stencil-wave", 14)
    kw = dict(steps=14, lb_every=4, strategy="diff-comm",
              strategy_kwargs=dict(k=2), threads_per_node=2)
    ref = t_sim.run_series(tp, tev, **kw)
    sh = t_sim.run_series_sharded(tp, tev, num_shards=D, **kw)
    np.testing.assert_array_equal(ref.thread_max_avg, sh.thread_max_avg)
    np.testing.assert_allclose(
        sh.thread_max_avg,
        _jax_series("stencil-wave", 14, 4, None, 2, False).thread_max_avg,
        rtol=RTOL)


@pytest.mark.parametrize("D", [2, 4])
def test_series_sharded_coord_and_telemetry(D):
    """diff-coord over the mesh, and the StepRecord ring: equal to the
    device loop's (the records of the same run)."""
    tp, tev, _, _ = _recorded("stencil-wave", 14)
    kw = dict(steps=14, lb_every=4, strategy="diff-coord",
              strategy_kwargs=dict(k=2), telemetry="counters")
    ref = t_sim.run_series(tp, tev, **kw)
    sh = t_sim.run_series_sharded(tp, tev, num_shards=D, **kw)
    _bitwise(sh, ref, SERIES_FIELDS)
    np.testing.assert_array_equal(sh.telemetry.records,
                                  ref.telemetry.records)


def test_series_sharded_validates_inputs():
    prob, evolve = t_scen.get("stencil-wave").instantiate(
        grid=8, num_nodes=4, device=CPU)
    kw = dict(steps=4, lb_every=2)
    with pytest.raises(ValueError, match="not jittable"):
        t_sim.run_series_sharded(prob, evolve, strategy="greedy", **kw)
    with pytest.raises(ValueError, match="scan-safe"):
        t_sim.run_series_sharded(prob, lambda p, t: p, **kw)
    with pytest.raises(ValueError, match="cannot honor"):
        t_sim.run_series_sharded(prob, evolve, strategy="diff-comm",
                                 strategy_kwargs=dict(step_fn=None), **kw)
    with pytest.raises(ValueError, match="not both"):
        t_sim.run_series_sharded(prob, evolve, mesh=ShardMesh(1, CPU),
                                 num_shards=1, **kw)
    with pytest.raises(ValueError, match="divide"):
        t_sim.run_series_sharded(prob, evolve, num_shards=3, **kw)
    with pytest.raises(ValueError, match="steps"):
        t_sim.run_series_sharded(prob, evolve, steps=0, lb_every=2)


# ---------------------------------------------------------- PIC replay --


PIC_BASE = dict(L=100, n_particles=2000, steps=20, k=1, rho=0.9, cx=10,
                cy=10, num_pes=4, mapping="striped", lb_every=5,
                strategy="diff-comm", strategy_kwargs=dict(k=2), seed=0)


def _pic(**kw):
    return t_driver.run(t_driver.PICConfig(**{**PIC_BASE, **kw},
                                           device=CPU))


@functools.lru_cache(maxsize=None)
def _jax_pic(trigger=None, sharded=False):
    cfg = dict(PIC_BASE, trigger=trigger)
    if sharded:
        return j_driver.run(j_driver.PICConfig(**cfg, sharded_replay=True))
    return j_driver.run(j_driver.PICConfig(**cfg, scan=True))


def _pic_matches_jax(got, want):
    """Integer-valued records exact; ``migrations`` (a mean over the
    chares, added in another order) as the count of chares moved, exact;
    positions within 1e-4."""
    for f in PIC_EXACT:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    C = PIC_BASE["cx"] * PIC_BASE["cy"]
    np.testing.assert_array_equal(np.rint(got.migrations * C),
                                  np.rint(want.migrations * C))
    err = max(np.abs(got.final_x - want.final_x).max(),
              np.abs(got.final_y - want.final_y).max())
    assert err <= 1e-4


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("trigger", [None, "threshold"])
def test_pic_sharded_matches_single_device_and_jax(trigger, D):
    ref = _pic(trigger=trigger)
    sh = _pic(trigger=trigger, sharded_replay=True, replay_shards=D)
    assert sh.migrated_bytes.sum() > 0 and sh.lb_steps.sum() > 0
    assert sh.plan_rejected is None and sh.deferred is None
    assert sh.shard_counts.shape == (PIC_BASE["steps"], D)
    assert (sh.shard_counts.sum(1) == PIC_BASE["n_particles"]).all()
    _bitwise(sh, ref, PIC_FIELDS)
    _pic_matches_jax(sh, _jax_pic(trigger))
    if trigger is None:
        _pic_matches_jax(sh, _jax_pic(trigger, sharded=True))


def test_pic_sharded_plans_replicated_when_pes_do_not_divide():
    """6 PEs over 4 shards: the particles shard (2000 % 4 == 0 is not
    enough: the PEs must divide too), so the mesh shrinks to 2."""
    ref = _pic(num_pes=6)
    sh = _pic(num_pes=6, sharded_replay=True)
    _bitwise(sh, ref, PIC_FIELDS)
    with pytest.raises(ValueError, match="divide"):
        _pic(num_pes=6, sharded_replay=True, replay_shards=4)


def test_pic_sharded_conservation_under_repeated_migrations():
    # lb_every=2 → many exchanges; the slab prefixes stay a permutation of
    # the particles, and the trajectories are those of the LB-free run
    r = _pic(sharded_replay=True, replay_shards=4, lb_every=2, steps=16)
    assert (r.lb_steps > 0).sum() >= 5 and r.migrated_bytes.sum() > 0
    assert r.final_x.shape == (PIC_BASE["n_particles"],)
    never = _pic(strategy="none", strategy_kwargs=None, steps=16)
    np.testing.assert_array_equal(r.final_x, never.final_x)
    np.testing.assert_array_equal(r.final_y, never.final_y)


def test_pic_sharded_capacity_overflow_raises():
    with pytest.raises(ValueError, match="replay_capacity"):
        _pic(sharded_replay=True, replay_shards=4, replay_capacity=100)
    with pytest.raises(ValueError, match="replay_capacity"):
        _pic(sharded_replay=True, replay_shards=4, replay_capacity=510)
    # the tight capacity of a run is enough for that run
    r = _pic(sharded_replay=True, replay_shards=4)
    tight = _pic(sharded_replay=True, replay_shards=4,
                 replay_capacity=int(r.shard_counts.max()))
    _bitwise(tight, r, PIC_FIELDS)


def test_pic_sharded_rejects_host_strategies_and_bad_modes():
    with pytest.raises(ValueError, match="not jittable"):
        _pic(sharded_replay=True, strategy="greedy", strategy_kwargs=None)
    with pytest.raises(ValueError, match="on_overflow"):
        _pic(sharded_replay=True, on_overflow="drop")


# ----------------------------------------- capacity-planned sharded apply --


@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_migrate_sharded_plans_capacity_from_the_plan(D):
    P, n = 4 * D, 32 * D
    rng = np.random.default_rng(3)
    on = rng.integers(0, P, n).astype(np.int32)
    x = rng.normal(size=n).astype(np.float32)
    ids = np.arange(n, dtype=np.int32)
    planned = t_migrate.planned_capacity(on, num_nodes=P, num_shards=D)
    assert planned == j_migrate.planned_capacity(on, num_nodes=P,
                                                 num_shards=D)
    owner_out, (xo, ido), counts = t_migrate.migrate_sharded(
        torch.as_tensor(on), (torch.as_tensor(x), torch.as_tensor(ids)),
        num_nodes=P, mesh=ShardMesh(D, CPU))
    assert xo.shape[0] == D * planned
    (ref_x, ref_ids), _ = j_migrate.migrate(on, on, (x, ids), num_nodes=P)
    keep = np.concatenate([np.arange(d * planned, d * planned + int(c))
                           for d, c in enumerate(counts)])
    np.testing.assert_array_equal(ido.numpy()[keep], np.asarray(ref_ids))
    np.testing.assert_array_equal(xo.numpy()[keep], np.asarray(ref_x))
    np.testing.assert_array_equal(owner_out.numpy()[keep], np.sort(on))


# ------------------------------------- chip_smoke's phases, rehearsed --


def test_chip_smoke_sharded_phases_rehearse_on_cpu(monkeypatch):
    """chip_smoke's sharded phases (the sharded PIC path at two
    capacities, the sharded series, the resilient runs against the CPU,
    the exchange alone, the sharded fleet) run end to end on the CPU's
    plain versions at small sizes.  (Fig 5's sharded branch is left to
    the card: its modeled-time assertion reads measured plan wall time,
    which a small CPU run does not hold steadily.)"""
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.syspath_prepend(str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.serve import replay as sr

    monkeypatch.setattr(cs, "DEV", CPU)
    for k in ("SHARDED_PIC_KERNELS", "SHARDED_SIM_KERNELS",
              "SHARDED_EXCHANGE_KERNELS", "SHARDED_FLEET_KERNELS"):
        monkeypatch.setattr(cs, k, ())                # CPU: none launched
    monkeypatch.setattr(cs, "PIC", dict(
        L=100, n_particles=4000, steps=21, cx=8, cy=8, num_pes=4, rho=0.9,
        mode="GEOMETRIC", lb_every=10, strategy="diff-comm",
        strategy_kwargs={"k": 2}))
    monkeypatch.setattr(cs, "SHARDED_PIC", dict(sharded_replay=True,
                                                replay_shards=4))
    monkeypatch.setattr(cs, "SIM_SCENARIO", dict(grid=16, num_nodes=8,
                                                 mapping="tiled"))
    monkeypatch.setattr(cs, "SIM", dict(steps=24, lb_every=10,
                                        strategy="diff-comm",
                                        strategy_kwargs={"k": 4}))
    monkeypatch.setattr(cs, "SHARDED_SIM_SHARDS", 4)
    monkeypatch.setattr(cs, "FLEET", dict(num_sessions=512, num_replicas=8,
                                          seed=1))
    monkeypatch.setattr(cs, "FLEET_SHARDS", 4)
    monkeypatch.setattr(cs, "EXCHANGE", dict(n=1 << 12, shards=4, nodes=64))
    monkeypatch.setattr(cs, "RESIL_SIM", dict(
        cs.RESIL_SIM, scenario=dict(grid=16, num_nodes=16), steps=18))
    monkeypatch.setattr(cs, "RESIL_PIC", dict(cs.RESIL_PIC,
                                              n_particles=2000, steps=18))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = t_driver.run(t_driver.PICConfig(**cs.PIC, device=CPU))
        cs.sharded_pic(single)
        p, ev = t_scen.get("stencil-wave").instantiate(device=CPU,
                                                       **cs.SIM_SCENARIO)
        cs.sharded_series(t_sim.run_series(p, ev, **cs.SIM))
        cs.resilience_phase()
        cs.exchange_phase()
        cs.sharded_fleet(sr.run_serve_replay(
            sr.ServeWorkload(**cs.FLEET), **cs.FLEET_RUN, device=CPU))
    finally:
        torch.set_num_threads(threads)
    assert set(cs.SHARDED) >= {"PIC", "series", "exchange", "fleet",
                               "resilience"}
    assert sys.modules["chip_smoke"] is cs
