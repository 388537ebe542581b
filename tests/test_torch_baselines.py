"""The port's host baselines (``repro_torch.core.baselines`` and the host
strategies of its registry) against the JAX package on the CPU: the same
problems give the same assignments, the simulator's host replay and the
PIC driver's loop under ``greedy-refine`` give the same fire steps,
assignments and bytes, and the behavioral contracts of
``tests/test_baselines.py`` hold on the port."""
import numpy as np
import pytest
import torch

from repro.core import api as j_api
from repro.core import baselines as j_base
from repro.core import engine as j_engine
from repro.pic import driver as j_driver
from repro.sim import scenarios as j_scen
from repro.sim import simulator as j_sim
from repro.sim import stencil as j_stencil
from repro.sim import synthetic as j_syn
from repro_torch.core import api as t_api
from repro_torch.core import baselines as t_base
from repro_torch.core import engine as t_engine
from repro_torch.core import metrics as t_metrics
from repro_torch.pic import driver as t_driver
from repro_torch.sim import scenarios as t_scen
from repro_torch.sim import simulator as t_sim
from repro_torch.sim import stencil as t_stencil
from repro_torch.sim import synthetic as t_syn

CPU = "cpu"
HOST = ("greedy", "ep-greedy", "greedy-refine", "metis", "parmetis")
PROBLEMS = {
    # Table II's smallest benchmark
    "stencil3d-mod7": (
        lambda: j_syn.mod7(j_stencil.stencil_3d(8, 8, 8, 8,
                                                mapping="striped")),
        lambda: t_syn.mod7(t_stencil.stencil_3d(8, 8, 8, 8,
                                                mapping="striped",
                                                device=CPU))),
    # Table I's setting: one node overloaded on a 2D stencil
    "stencil2d-hotspot": (
        lambda: j_syn.hotspot(j_stencil.stencil_2d(16, 12, 6), node=2,
                              factor=6.0),
        lambda: t_syn.hotspot(t_stencil.stencil_2d(16, 12, 6, device=CPU),
                              node=2, factor=6.0)),
}


@pytest.fixture(scope="module")
def problems():
    return {k: (j(), t()) for k, (j, t) in PROBLEMS.items()}


@pytest.fixture(scope="module")
def prob3d():
    return PROBLEMS["stencil3d-mod7"][1]()


def test_problems_hand_the_baselines_the_same_inputs(problems):
    """Both packages' constructors give the same edge list, in the same
    order, and the same loads: what the host baselines' heaps and RNG
    depend on."""
    for jp, tp in problems.values():
        want, got = j_base._np(jp), t_base._np(tp)
        for w, g in zip(want, got):
            assert w.dtype == g.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
@pytest.mark.parametrize("name", HOST)
def test_host_strategy_assignment_equals_jax(problems, name, problem):
    jp, tp = problems[problem]
    want = j_api.run_strategy(name, jp)
    got = t_api.run_strategy(name, tp)
    np.testing.assert_array_equal(got.assignment, want.assignment)
    assert got.assignment.dtype == np.int32
    for k in ("max_avg_load", "ext_int_comm", "pct_migrations"):
        np.testing.assert_allclose(got.info[k], want.info[k], rtol=1e-6)


@pytest.mark.parametrize("fn,kw", [
    ("greedy_capped", dict(cap=100)), ("metis_like", dict(use_coords=True)),
    ("metis_like", dict(coarsen_to=16, seed=3)),
    ("parmetis_like", dict(itr=10.0, passes=3)),
])
def test_baseline_options_equal_jax(problems, fn, kw):
    """The knobs the registry leaves at their defaults: RCB seeding, the
    multilevel path, the migration-cost knob, a looser cap."""
    for jp, tp in problems.values():
        np.testing.assert_array_equal(getattr(t_base, fn)(tp, **kw),
                                      getattr(j_base, fn)(jp, **kw))


def _jax_core_strategies():
    """The JAX package's registry without the ``-sharded`` planners that
    importing ``repro.distributed.lb_shard`` adds (the sharded slice)."""
    return {n for n in j_engine.available() if not n.endswith("-sharded")}


def test_registry_holds_every_jax_strategy():
    assert set(t_engine.available()) == _jax_core_strategies()
    for name in t_engine.available():
        t, j = t_engine.get_strategy(name), j_engine.get_strategy(name)
        assert t.host == (not j.jittable), name
        assert t.trigger == j.trigger and t.variant == j.variant
        assert dict(t.defaults) == dict(j.defaults)


def test_host_plan_fn_returns_int32_on_the_problem_device(prob3d):
    a, stats = t_engine.get_strategy("greedy-refine").plan_fn(prob3d)
    assert a.dtype == torch.int32 and a.device == prob3d.device
    assert int(stats.diffusion_iters) == 0


# ------------------------------------------ tests/test_baselines.py, port --


def _greedy(p):
    m = t_metrics.evaluate(p, torch.as_tensor(t_base.greedy(p)))
    assert m["max_avg_load"] < 1.05
    assert m["pct_migrations"] > 0.5


def _greedy_refine(p):
    m = t_metrics.evaluate(p, torch.as_tensor(t_base.greedy_refine(p)))
    assert m["max_avg_load"] < 1.1
    assert m["pct_migrations"] < 0.3


def _metis_balanced(p):
    a = t_base.metis_like(p)
    m = t_metrics.evaluate(p, torch.as_tensor(a))
    assert m["max_avg_load"] < 1.15
    assert len(np.unique(a)) == p.num_nodes


def _metis_cuts_well(p):
    m = t_metrics.evaluate(p, torch.as_tensor(t_base.metis_like(p)))
    init = t_metrics.evaluate(p)
    assert m["pct_migrations"] > 0.5
    assert m["ext_int_comm"] < init["ext_int_comm"] * 1.2


def _parmetis_fewer(p):
    mm = t_metrics.evaluate(p, torch.as_tensor(t_base.metis_like(p)))
    mp = t_metrics.evaluate(p, torch.as_tensor(t_base.parmetis_like(p)))
    assert mp["pct_migrations"] < mm["pct_migrations"]
    assert mp["max_avg_load"] < 1.15


def _parmetis_itr(p):
    lo = t_base.parmetis_like(p, itr=10_000.0)   # migration expensive
    hi = t_base.parmetis_like(p, itr=1.0)        # migration cheap
    m_lo = t_metrics.evaluate(p, torch.as_tensor(lo))["pct_migrations"]
    m_hi = t_metrics.evaluate(p, torch.as_tensor(hi))["pct_migrations"]
    assert m_lo <= m_hi + 1e-9


def _registry_runs_everything(_):
    prob = t_syn.random_pm(t_stencil.stencil_2d(12, 12, 4, device=CPU), 0.4)
    for name in t_api.STRATEGIES:
        kw = dict(k=2) if name.startswith("diff") else {}
        plan = t_api.run_strategy(name, prob, **kw)
        assert plan.assignment.shape == (prob.num_objects,)
        assert (plan.assignment >= 0).all()
        assert (plan.assignment < prob.num_nodes).all()


def _rcb_balanced(_):
    rng = np.random.default_rng(0)
    part = t_base._rcb(rng.random((256, 2)), np.ones(256), 8)
    counts = np.bincount(part, minlength=8)
    assert counts.max() - counts.min() <= 2


@pytest.mark.parametrize("prop", [
    _greedy, _greedy_refine, _metis_balanced, _metis_cuts_well,
    _parmetis_fewer, _parmetis_itr, _registry_runs_everything,
    _rcb_balanced], ids=lambda f: f.__name__.strip("_"))
def test_baseline_contract(prob3d, prop):
    """The eight behavioral contracts of ``tests/test_baselines.py``."""
    prop(prob3d)


# ------------------------------------------------- the replays' host path --


def test_run_series_greedy_refine_matches_jax_host_replay():
    kw = dict(steps=24, lb_every=6, strategy="greedy-refine")
    small = dict(grid=12, num_nodes=4)
    want = j_sim.run_series(*j_scen.get("stencil-wave").instantiate(**small),
                            **kw)
    got = t_sim.run_series(*t_scen.get("stencil-wave").instantiate(
        device=CPU, **small), **kw)
    assert not got.scanned and not want.scanned
    assert got.lb_fired.sum() == 3
    np.testing.assert_array_equal(got.lb_fired, want.lb_fired)
    np.testing.assert_array_equal(got.final_assignment,
                                  want.final_assignment)
    np.testing.assert_allclose(got.max_avg, want.max_avg, rtol=1e-5)
    np.testing.assert_allclose(got.migrations, want.migrations, rtol=1e-6)


def test_run_series_scan_true_rejects_host_strategy():
    p, ev = t_scen.get("stencil-wave").instantiate(device=CPU, grid=8,
                                                   num_nodes=4)
    with pytest.raises(ValueError, match="jittable"):
        t_sim.run_series(p, ev, steps=4, lb_every=2, strategy="metis",
                         scan=True)


def test_pic_greedy_refine_matches_jax_host_loop():
    """20k particles, 30 steps, 4 PEs on 8×8 chares of width 12.5 (exact
    in float32, so the JAX host loop's float64 chare ids and the port's
    float32 ones agree): fire steps, chares moved and every byte count
    exact; max/avg within float32 rounding of the JAX float64 bincount;
    positions within the 1e-4 of ``tests/test_torch_pic.py``."""
    cfg = dict(L=100, n_particles=20_000, steps=30, cx=8, cy=8, num_pes=4,
               lb_every=10, strategy="greedy-refine")
    want = j_driver.run(j_driver.PICConfig(**cfg))
    got = t_driver.run(t_driver.PICConfig(**cfg, device=CPU))
    assert not want.scanned
    for f in ("lb_steps", "migrations", "migrated_bytes", "ext_bytes",
              "int_bytes"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.lb_steps.sum() == 2 and got.migrated_bytes.sum() > 0
    np.testing.assert_allclose(got.max_avg, want.max_avg, rtol=1e-6)
    err = max(np.abs(got.final_x - want.final_x).max(),
              np.abs(got.final_y - want.final_y).max())
    assert err <= 1e-4
    # each fired plan is timed, as the JAX host loop times it
    assert got.lb_seconds > 0
