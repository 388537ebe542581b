"""The port's multi-process mesh (``distributed.mesh.ProcessMesh``: one
rank a shard over ``torch.distributed``) against its in-process
``ShardMesh`` and the JAX package, on the CPU.

D ∈ {2, 4} ``gloo`` ranks are spawned once per D (``launch.mesh.
run_ranks``, a file store under the test's temporary directory, one
intra-op thread a rank, a hard time limit); every rank runs every case
(``tests/process_mesh_ranks.py``) and returns its results, which are held
here to the same calls over ``ShardMesh(D)`` in this process:

  * the collectives, bit for bit;
  * ``ShardedLBEngine.plan_fn`` (both variants, the mesh resolved from the
    group) bit for bit, and its assignment exact against the JAX package;
    the registered sharded strategy, which raises where the world size
    does not divide P, and the engine cache, which follows the group;
  * ``run_series_sharded`` on a JAX-recorded scenario under a threshold
    trigger, every field bit for bit, and against the JAX package exact in
    fire steps, migrations and the final assignment, floats within RTOL;
  * ``run_pic_sharded`` at the JAX package's 8-device config (8 PEs), every
    PIC field equal to the single-device driver; an undersized capacity
    (n/D, which the run outgrows) raises on every rank; with a dead shard
    and with the spill exchange, equal to the in-process mesh's runs;
  * the checkpointed series with a fault schedule and an injected
    failure (``runtime.resilience``);
  * the fleet and EP replays and the expert relocation over the ranks;
  * a shard count other than the world size raises.

Every rank's results are compared, so the ranks also agree.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as j_engine
from repro.sim import scenarios as j_scen
from repro.sim import simulator as j_sim
from repro.sim import stencil as j_stencil
from repro.sim import synthetic as j_synthetic
from repro_torch import interop
from repro_torch.core import engine as t_engine
from repro_torch.distributed import lb_shard
from repro_torch.distributed.mesh import ShardMesh
from repro_torch.launch.mesh import RanksFailed, run_ranks
from repro_torch.pic import driver as t_driver
from repro_torch.runtime import resilience as rz
from repro_torch.serve import replay as t_sr
from repro_torch.sim import simulator as t_sim
from repro_torch.train import ep_runtime as t_epr
from tests import process_mesh_ranks as ranks_mod

CPU = "cpu"
RTOL = 1e-5
TIMEOUT = 120.0         # seconds a spawn of the ranks may take, whole
PROBLEM_FIELDS = ("loads", "assignment", "edges_src", "edges_dst",
                  "edges_bytes")
SERIES = dict(name="bimodal-churn", grid=8, num_nodes=4, kw=dict(
    steps=20, lb_every=5, strategy="diff-comm", strategy_kwargs=dict(k=2),
    trigger="threshold"))
# the JAX package's 8-device script (tests/test_replay_shard.py)
PIC = dict(L=100, n_particles=2000, steps=18, k=1, rho=0.9, cx=10, cy=10,
           num_pes=8, mapping="striped", lb_every=4, strategy="diff-comm",
           strategy_kwargs=dict(k=3), seed=0)
PIC_FIELDS = ("max_avg", "ext_bytes", "int_bytes", "migrations",
              "migrated_bytes", "lb_steps", "final_x", "final_y")
FLEET = dict(num_sessions=256, num_replicas=16, group_size=4,
             turn_period=6, turn_len=3, burst_period=7, seed=0)
FLEET_RUN = dict(steps=20, lb_every=5, strategy="diff-comm",
                 trigger="threshold")
EP = dict(num_experts=32, num_ranks=8, tokens_per_step=256, trace_len=16,
          seed=2)
EP_RUN = dict(steps=8, strategy="diff-comm", lb_every=3)
MOE_E, MOE_RANKS = 16, 4
SERIES_FAULTS = ((6, 1, "die"), (12, 1, "recover"))
CHECKPOINTED = dict(checkpoint_every=4, fail_at=(2,))


def _np_problem(jp):
    d = {f: np.asarray(getattr(jp, f)) for f in PROBLEM_FIELDS}
    d.update(num_nodes=jp.num_nodes, coords=np.asarray(jp.coords))
    return d


@functools.lru_cache(maxsize=None)
def _hotspot():
    """(JAX problem, its arrays): the planner tests' hotspot at P = 16."""
    jp = j_synthetic.hotspot(j_stencil.stencil_2d(16, 16, 16), node=3,
                             factor=7.0)
    return jp, _np_problem(jp)


@functools.lru_cache(maxsize=None)
def _recorded():
    """The series scenario's problem and the loads and edge bytes JAX's
    evolve gives at each step, with JAX's replay of those tables."""
    c = SERIES
    jp, jev = j_scen.get(c["name"]).instantiate(grid=c["grid"],
                                                num_nodes=c["num_nodes"])
    states = [jev(jp, jnp.int32(t)) for t in range(c["kw"]["steps"])]
    loads = np.stack([np.asarray(s.loads) for s in states])
    ebytes = np.stack([np.asarray(s.edges_bytes) for s in states])

    def j_evolve(p, t):
        return dataclasses.replace(p, loads=jnp.asarray(loads)[t],
                                   edges_bytes=jnp.asarray(ebytes)[t])
    j_evolve.jittable = True
    want = j_sim.run_series(jp, j_evolve, scan=True, **c["kw"])
    return dict(problem=_np_problem(jp), loads=loads, ebytes=ebytes,
                kw=c["kw"]), want


def _moe():
    rng = np.random.default_rng(0)
    E, Dm, F = MOE_E, 6, 10
    moe = dict(wi=rng.normal(size=(E, Dm, F)).astype(np.float32),
               wg=rng.normal(size=(E, Dm, F)).astype(np.float32),
               wo=rng.normal(size=(E, F, Dm)).astype(np.float32),
               router=rng.normal(size=(Dm, E)).astype(np.float32),
               shared_wi=rng.normal(size=(Dm, F)).astype(np.float32))
    placement = np.repeat(np.arange(MOE_RANKS), E // MOE_RANKS)[np.argsort(
        rng.normal(size=E), kind="stable")].astype(np.int32)
    return moe, np.arange(E, dtype=np.int32), placement


def _inputs(D):
    rng = np.random.default_rng(D)
    moe, slot_expert, placement = _moe()
    return dict(
        x=np.arange(D * 6, dtype=np.float32).reshape(D * 3, 2) * 1.5,
        partial=(rng.normal(size=(D, 5)) * 10.0 ** rng.integers(
            -3, 4, (D, 5))).astype(np.float32),
        problem=_hotspot()[1], series=_recorded()[0], pic=PIC,
        # the first exchange (step 4) outgrows n/D slots a shard
        pic_undersized=dict(steps=6, replay_capacity=PIC["n_particles"] // D),
        pic_dead=dict(steps=10), pic_dead_events=((8, D - 1, "die"),),
        pic_spill=dict(lb_every=2, steps=10,
                       replay_capacity=PIC["n_particles"] // D + 60),
        series_faults=SERIES_FAULTS, checkpointed=CHECKPOINTED, fleet=FLEET,
        fleet_run=FLEET_RUN, ep=EP, ep_run=EP_RUN, moe=moe,
        slot_expert=slot_expert, placement=placement, moe_ranks=MOE_RANKS)


@pytest.fixture(scope="module", params=[2, 4], ids=["D2", "D4"])
def ranks(request, tmp_path_factory):
    """(D, inputs, every rank's results): one spawn of D ranks for all
    cases."""
    D = request.param
    inputs = _inputs(D)
    inputs["solo_store"] = str(tmp_path_factory.mktemp(f"solo{D}") / "s")
    out = run_ranks(ranks_mod.all_cases, D, args=(inputs,), device=CPU,
                    transport="gloo", timeout=TIMEOUT,
                    workdir=str(tmp_path_factory.mktemp(f"ranks{D}")))
    assert [r["rank"] for r in out] == list(range(D))
    return D, inputs, out


def _fields(res):
    """Every field of a result dataclass but measured times and
    telemetry, as NumPy arrays."""
    return {f.name: np.asarray(getattr(res, f.name))
            for f in dataclasses.fields(res)
            if "seconds" not in f.name and f.name != "telemetry"
            and getattr(res, f.name) is not None}


def _bitwise(got, want, what):
    g, w = _fields(got), _fields(want)
    assert g.keys() == w.keys(), what
    for f in g:
        np.testing.assert_array_equal(g[f], w[f], err_msg=f"{what}: {f}")


# ------------------------------------------------------------- the mesh --


def test_collectives_equal_the_in_process_mesh(ranks):
    D, inputs, out = ranks
    mesh = ShardMesh(D, CPU)
    x = mesh.shard(torch.as_tensor(inputs["x"]))
    partial = torch.as_tensor(inputs["partial"])
    np.testing.assert_array_equal(mesh.shard_index().numpy(),
                                  np.arange(D)[:, None])
    for r, o in enumerate(out):
        c = o["collectives"]
        assert o["num_shards"] == D and "transport='gloo'" in o["repr"]
        np.testing.assert_array_equal(c["shard"], x[r:r + 1].numpy())
        np.testing.assert_array_equal(c["ring_shift"],
                                      mesh.ring_shift(x)[r:r + 1].numpy())
        np.testing.assert_array_equal(c["all_gather"],
                                      mesh.all_gather(x).numpy())
        # two blocks in one collective, each as its own all_gather
        for g, b in zip(c["all_gather_many"], (x, x[:, :, :1] * 3.0)):
            np.testing.assert_array_equal(g, mesh.all_gather(b).numpy())
        # a float psum: the gathered partials added as ShardMesh adds them
        np.testing.assert_array_equal(c["psum"], mesh.psum(partial).numpy())
        np.testing.assert_array_equal(c["shard_index"], [[r]])


def test_shard_counts_other_than_the_world_size_raise(ranks):
    D, _, out = ranks
    for o in out:
        assert all(m is not None and f"{D} ranks" in m
                   for m in o["wrong_shards"]), o["wrong_shards"]


def test_sharded_strategy_needs_the_world_size_to_divide_p(ranks):
    """Inside a group the registered sharded strategy plans on the group's
    mesh; P = D + 1 nodes raise, naming P and the world size."""
    D, _, out = ranks
    for o in out:
        m = o["plan"]["strategy_odd"]
        assert m is not None and f"{D + 1} balancer nodes" in m \
            and f"{D} ranks" in m, m


def test_cached_sharded_engine_follows_the_process_group(ranks):
    """An engine cached inside one group is not handed out in the next:
    after a rank leaves its D-rank group for a group of its own, the
    cache gives an engine on the new group's mesh."""
    D, _, out = ranks
    for r, o in enumerate(out):
        g = o["regrouped"]
        assert f"num_shards={D}, rank={r}," in g["before"], g
        assert "num_shards=1, rank=0," in g["after"] and not g["same"], g


# -------------------------------------------------------------- planner --


@functools.lru_cache(maxsize=None)
def _jax_plan(variant):
    a, _ = jax.jit(j_engine.get_engine(variant=variant, k=4).plan_fn)(
        _hotspot()[0])
    return np.asarray(a)


def test_plan_fn_equals_the_in_process_mesh_and_jax(ranks):
    D, _, out = ranks
    tp = interop.problem_from_numpy(_hotspot()[1], device=CPU)
    single_a, single_s = t_engine.get_engine(k=4, device=CPU).plan_fn(tp)
    for variant in ("comm", "coord"):
        a, s = lb_shard.ShardedLBEngine(
            mesh=ShardMesh(D, CPU), variant=variant, k=4).plan_fn(tp)
        for o in out:
            got = o["plan"][variant]
            assert got["num_shards"] == D
            np.testing.assert_array_equal(got["assignment"], a.numpy())
            for f in s._fields:
                np.testing.assert_array_equal(got[f], getattr(s, f).numpy(),
                                              err_msg=f"{variant}: {f}")
            np.testing.assert_array_equal(got["assignment"],
                                          _jax_plan(variant))
            if variant == "comm":
                np.testing.assert_array_equal(got["assignment"],
                                              single_a.numpy())
                for f in s._fields:
                    np.testing.assert_array_equal(
                        got[f], getattr(single_s, f).numpy(), err_msg=f)
    for o in out:
        np.testing.assert_array_equal(o["plan"]["strategy"],
                                      single_a.numpy())


# ------------------------------------------------------------- replays --


def test_series_equals_the_in_process_mesh_and_jax(ranks):
    D, inputs, out = ranks
    s, want = _recorded()
    ref = t_sim.run_series_sharded(
        interop.problem_from_numpy(s["problem"], device=CPU),
        ranks_mod.recorded_evolve(s["loads"], s["ebytes"]), num_shards=D,
        **s["kw"])
    assert ref.lb_fired.sum() > 0
    for o in out:
        got = o["series"]
        _bitwise(got, ref, "series")
        for f in ("lb_fired", "migrations", "final_assignment"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
        for f in ("max_avg", "ext_int", "max_load", "migrated_load"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=RTOL, atol=1e-6, err_msg=f)


@functools.lru_cache(maxsize=None)
def _pic_single():
    return t_driver.run(t_driver.PICConfig(**PIC, device=CPU))


def test_pic_equals_the_single_device_driver(ranks):
    D, _, out = ranks
    single = _pic_single()
    ref = t_driver.run(t_driver.PICConfig(**PIC, sharded_replay=True,
                                          replay_shards=D, device=CPU))
    assert ref.migrated_bytes.sum() > 0
    for o in out:
        got = o["pic"]
        _bitwise(got, ref, "PIC")
        for f in PIC_FIELDS:
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(single, f), err_msg=f)
        assert got.shard_counts.shape == (PIC["steps"], D)
        assert (got.shard_counts.sum(1) == PIC["n_particles"]).all()
        # every rank raises after the run, on the gathered slot counts
        assert "replay_capacity" in o["pic_overflow"]
        assert "overflowed" in o["pic_overflow"]


def test_resilient_pic_and_series_equal_the_in_process_mesh(ranks):
    """A dead shard, the spill exchange and the checkpointed series with
    a fault schedule and an injected failure, over the ranks."""
    D, inputs, out = ranks
    dead = t_driver.run(t_driver.PICConfig(
        **{**PIC, **inputs["pic_dead"]}, sharded_replay=True,
        replay_shards=D, device=CPU,
        faults=rz.FaultSchedule(events=inputs["pic_dead_events"])))
    spill = t_driver.run(t_driver.PICConfig(
        **{**PIC, **inputs["pic_spill"]}, sharded_replay=True,
        replay_shards=D, on_overflow="spill", device=CPU))
    assert dead.lb_steps[8] == 1.0 and spill.deferred.max() > 0
    s, _ = _recorded()
    ck = rz.run_series_checkpointed(
        interop.problem_from_numpy(s["problem"], device=CPU),
        ranks_mod.recorded_evolve(s["loads"], s["ebytes"]),
        faults=rz.FaultSchedule(events=SERIES_FAULTS), num_shards=D,
        **CHECKPOINTED, **s["kw"])
    assert ck.plan_rejected is not None
    for o in out:
        _bitwise(o["pic_dead"], dead, "PIC with a dead shard")
        _bitwise(o["pic_spill"], spill, "PIC, spill")
        _bitwise(o["checkpointed"], ck, "checkpointed series")


def test_fleet_and_expert_replays_equal_the_in_process_mesh(ranks):
    D, inputs, out = ranks
    fleet = t_sr.run_serve_replay(t_sr.ServeWorkload(**FLEET), num_shards=D,
                                  device=CPU, **FLEET_RUN)
    ep = t_epr.run_ep_replay(t_epr.RoutingWorkload(**EP), num_shards=D,
                             device=CPU, **EP_RUN)
    assert fleet.lb_fired.sum() > 0 and ep.lb_fired.sum() > 0
    moe = {k: torch.as_tensor(v) for k, v in inputs["moe"].items()}
    layers, se, moved, nbytes = t_epr.execute_placement(
        [moe], inputs["slot_expert"], inputs["placement"],
        num_ranks=MOE_RANKS, mesh=ShardMesh(D, CPU))
    assert moved > 0
    for o in out:
        _bitwise(o["fleet"], fleet, "fleet")
        _bitwise(o["ep"], ep, "EP")
        got = o["placement"]
        np.testing.assert_array_equal(got["slot_expert"], se.numpy())
        assert (got["moved"], got["bytes"]) == (moved, nbytes)
        for k, v in layers[0].items():
            np.testing.assert_array_equal(got["layers"][k], v.numpy(),
                                          err_msg=k)


# ------------------------------------------------------------ the spawn --


def test_a_failed_or_stuck_rank_fails_the_run(tmp_path):
    """A rank that raises while the others wait on it, or ranks past the
    time limit: every rank is killed and the run raises with the
    tracebacks."""
    with pytest.raises(RanksFailed, match="rank failed on purpose"):
        run_ranks(ranks_mod.fail_on_last_rank, 2, device=CPU,
                  transport="gloo", timeout=TIMEOUT, workdir=str(tmp_path))
    with pytest.raises(RanksFailed, match="ran past"):
        run_ranks(ranks_mod.sleep_past, 2, args=(60,), device=CPU,
                  transport="gloo", timeout=2, workdir=str(tmp_path))
