"""Batched planning and the batched replay of the port
(``comm_graph.stack_problems``, ``LBEngine.plan_batch``,
``scenarios.batch_instances``, ``simulator.run_series_batch``) and
``RuntimeCostModel.from_pic``, against the JAX package on the CPU."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import engine as j_engine
from repro.pic import driver as j_driver
from repro.runtime import cost as j_cost
from repro.sim import scenarios as j_scen
from repro.sim import simulator as j_sim
from repro.sim import stencil as j_stencil
from repro.sim import synthetic as j_syn
from repro_torch.core import api as t_api
from repro_torch.core import comm_graph as t_cg
from repro_torch.core import engine as t_engine
from repro_torch.pic import driver as t_driver
from repro_torch.runtime import cost as t_cost
from repro_torch.sim import scenarios as t_scen
from repro_torch.sim import simulator as t_sim
from repro_torch.sim import stencil as t_stencil
from repro_torch.sim import synthetic as t_syn

CPU = "cpu"
HOTSPOTS = [(0, 6.0), (3, 2.0), (5, 9.0)]


def _jax_lanes(inst, grid, num_nodes):
    """The JAX package's (problem, evolve) for each of the port's lanes:
    the same scenario at the same :data:`BATCH_VARIANTS` parameters."""
    out, seen = [], {}
    for name, _, _ in inst:
        v = seen[name] = seen.get(name, -1) + 1
        kw = t_scen.BATCH_VARIANTS[name](v, grid, num_nodes)
        out.append(j_scen.get(name).instantiate(**kw))
    return out


def test_stack_problems_pads_edges_and_stacks_leaves():
    probs = [p for _, p, _ in t_scen.batch_instances(4, device=CPU)]
    stacked = t_cg.stack_problems(probs)
    E = max(p.num_edges for p in probs)
    assert stacked.loads.shape == (4,) + tuple(probs[0].loads.shape)
    assert stacked.edges_src.shape == (4, E)
    assert stacked.num_nodes == probs[0].num_nodes
    for b, p in enumerate(probs):
        # padding slots carry the standard (-1, -1, 0.0) convention
        assert (stacked.edges_src[b, p.num_edges:] == -1).all()
        assert (stacked.edges_bytes[b, p.num_edges:] == 0).all()
        lane = t_cg.lane(stacked, b)
        assert (lane.loads == p.loads).all()
        assert (lane.edges_dst[:p.num_edges] == p.edges_dst).all()


def test_stack_problems_rejects_mixed_shapes():
    a = t_stencil.stencil_2d(8, 8, 4, device=CPU)
    b = t_stencil.stencil_2d(12, 12, 4, device=CPU)
    with pytest.raises(ValueError, match="common"):
        t_cg.stack_problems([a, b])
    with pytest.raises(ValueError, match="common"):
        t_sim.run_series_batch(
            [(a, t_scen.get("stencil-wave").instantiate(
                device=CPU, grid=8, num_nodes=4)[1]),
             (b, t_scen.get("stencil-wave").instantiate(
                 device=CPU, grid=12, num_nodes=4)[1])],
            steps=2, lb_every=1)


@pytest.mark.parametrize("stacked", [False, True])
def test_plan_batch_matches_per_problem_plans_and_jax(stacked):
    """One plan per problem, equal to the port's own per-problem plan and
    to the JAX package's vmapped ``plan_batch``, exactly."""
    t_probs = [t_syn.hotspot(t_stencil.stencil_2d(12, 12, 9, device=CPU),
                             node=n, factor=f) for n, f in HOTSPOTS]
    j_probs = [j_syn.hotspot(j_stencil.stencil_2d(12, 12, 9), node=n,
                             factor=f) for n, f in HOTSPOTS]
    eng = t_engine.get_engine(k=4, device=CPU)
    plans = eng.plan_batch(t_cg.stack_problems(t_probs) if stacked
                           else t_probs)
    want = j_engine.get_engine(k=4).plan_batch(j_probs)
    assert len(plans) == 3
    for b, (p, plan, jplan) in enumerate(zip(t_probs, plans, want)):
        single = t_api.run_strategy("diff-comm", p, k=4)
        np.testing.assert_array_equal(plan.assignment, single.assignment)
        np.testing.assert_array_equal(plan.assignment, jplan.assignment)
        assert plan.info["batch_size"] == 3 and plan.info["batch_index"] == b
        for k in ("protocol_rounds", "diffusion_iters"):
            assert plan.info[k] == jplan.info[k] == single.info[k]


def test_run_series_batch_matches_single_lanes_and_jax():
    """Each lane equals ``run_series`` on its own workload (the port runs
    the lanes one after another) and the JAX package's vmapped replay
    within ``tests/test_engine.py``'s tolerances."""
    grid, nodes = 8, 4
    inst = t_scen.batch_instances(4, grid=grid, num_nodes=nodes, device=CPU)
    assert [n for n, _, _ in inst] == sorted(t_scen.SCENARIOS)
    kw = dict(steps=12, lb_every=4, strategy="diff-comm",
              strategy_kwargs=dict(k=2))
    bres = t_sim.run_series_batch(inst, **kw)
    assert bres.batch == 4 and bres.steps == 12
    assert bres.wall_seconds >= sum(s.wall_seconds for s in bres.series)
    want = j_sim.run_series_batch(_jax_lanes(inst, grid, nodes), **kw)
    for (_, p, ev), lane, jlane in zip(inst, bres.series, want.series):
        single = t_sim.run_series(p, ev, scan=True, **kw)
        for f in ("max_avg", "ext_int", "migrations", "lb_fired",
                  "final_assignment"):
            np.testing.assert_array_equal(getattr(lane, f),
                                          getattr(single, f), err_msg=f)
        assert lane.lb_fired.sum() == 2
        np.testing.assert_allclose(lane.max_avg, jlane.max_avg, rtol=1e-4)
        np.testing.assert_allclose(lane.ext_int, jlane.ext_int, rtol=1e-4)
        np.testing.assert_allclose(lane.migrations, jlane.migrations,
                                   atol=1e-6)


@pytest.mark.parametrize("strategy,match", [
    ("greedy", "jittable"), ("metis", "jittable"),
    ("diff-comm+threshold", "trigger"), ("diff-coord+predictive", "trigger"),
])
def test_run_series_batch_rejects_host_and_trigger_strategies(strategy,
                                                              match):
    inst = t_scen.batch_instances(2, grid=8, num_nodes=4, device=CPU)
    with pytest.raises(ValueError, match=match):
        t_sim.run_series_batch(inst, steps=4, lb_every=2, strategy=strategy)


def test_run_series_batch_rejects_host_evolve():
    p, ev = t_scen.get("stencil-wave").instantiate(device=CPU, grid=8,
                                                   num_nodes=4)
    with pytest.raises(ValueError, match="device-resident"):
        t_sim.run_series_batch([(p, lambda q, t: ev(q, t))], steps=2,
                               lb_every=1)


def test_batch_instances_cover_the_registry_and_vary_lanes():
    inst = t_scen.batch_instances(8, grid=8, num_nodes=4, device=CPU)
    names = [n for n, _, _ in inst]
    assert names == sorted(t_scen.SCENARIOS) * 2
    for _, p, _ in inst:
        assert (p.num_nodes, p.num_objects) == (4, 64)
    # replicas are independent problems, not copies
    a, b = inst[0][1:], inst[4][1:]
    assert not bool((a[1](a[0], 3).loads == b[1](b[0], 3).loads).all())
    # the JAX package's lane at the same variant gives the same loads
    # (within float32 rounding of exp)
    jp, jev = _jax_lanes(inst[:1], 8, 4)[0]
    np.testing.assert_allclose(
        a[1](a[0], 3).loads.numpy(), np.asarray(jev(jp, jnp.int32(3)).loads),
        rtol=1e-6)


def test_batch_instances_raise_for_a_scenario_without_variant(monkeypatch):
    extra = dataclasses.replace(t_scen.get("stencil-wave"), name="extra")
    monkeypatch.setitem(t_scen.SCENARIOS, "extra", extra)
    with pytest.raises(ValueError, match="extra"):
        t_scen.batch_instances(2, device=CPU)


@pytest.mark.parametrize("strategy", ["diff-comm", "greedy-refine"])
def test_cost_model_from_pic_matches_jax(strategy):
    kw = dict(strategy=strategy, num_pes=8, bytes_per_particle=48.0,
              plan_seconds=0.25, moved_frac_est=0.2)
    got = t_cost.RuntimeCostModel.from_pic(t_driver.CostModel(), **kw)
    want = j_cost.RuntimeCostModel.from_pic(j_driver.CostModel(), **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.lb_overhead == (0.25 / 8 if strategy == "diff-comm" else 0.25)
