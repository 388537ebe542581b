"""The port's paper scripts (``benchmarks_torch/``) against the JAX
package on the CPU, at reduced sizes: their assertions hold and their
integer results equal JAX's."""
import numpy as np
import pytest
import torch

from repro.core import api as j_api
from repro.sim import stencil as j_stencil
from repro.sim import synthetic as j_syn
from repro.sim import viz as j_viz

CPU = "cpu"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The scripts run many small CPU ops; beside other test workers,
    several intra-op threads a process spin against each other (a Fig 5
    run took 30× its time alone), so each test here runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_table1_reduced_matches_jax():
    """The port's Table I at ring 32 × 8, 8 PEs: its assertions hold and
    ``diffusion_iters`` and assignments equal JAX's for every K."""
    from benchmarks_torch import table1_neighbor_count as t1

    out = t1.run(nx=32, ny=8, pes=8, device=CPU)
    jp = j_syn.hotspot(j_stencil.stencil_2d(32, 8, 8, mapping="ring"),
                       node=0, factor=10.0)
    for k in (1, 2, 4, 8):
        plan = j_api.run_strategy("diff-comm", jp, k=k)
        assert out["cells"][k]["diffusion_iters"] == \
            plan.info["diffusion_iters"]
        np.testing.assert_array_equal(out["assignments"][k], plan.assignment)


def test_fig2_reduced_matches_jax():
    from benchmarks_torch import fig2_stencil as f2

    out = f2.run(grid=24, pes=9, device=CPU)
    jp = j_syn.random_pm(j_stencil.stencil_2d(24, 24, 9, mapping="tiled"),
                         0.4, seed=1)
    for variant in ("diff-comm", "diff-coord"):
        plan = j_api.run_strategy(variant, jp, k=4)
        for k in ("max_avg_load", "ext_int_comm", "pct_migrations",
                  "diffusion_iters"):
            np.testing.assert_allclose(out[variant][k], plan.info[k],
                                       rtol=1e-6)
        assert out[variant + "_locality"] == \
            j_viz.locality_summary(plan.assignment, 24, 24)


# ---------------------------------- Table II, Fig 4, Fig 5 (host baselines) --

T2_BENCH = [(32, (16, 16, 8))]
T2_TRIGGER_STEPS = 40


def test_table2_reduced_matches_jax(monkeypatch):
    """The port's Table II at 32 PEs with a 40-step trigger section (the
    8-PE benchmark's baselines are held in ``test_torch_baselines.py``):
    its assertions hold, and every strategy's max/avg, ext/int and
    migrations, and the trigger policies' rebalances, equal the JAX
    script's at the same sizes (floats within 1e-6 relative)."""
    import functools

    from benchmarks import table2_strategies as j_t2
    from benchmarks_torch import table2_strategies as t2

    out = t2.run(device=CPU, bench=T2_BENCH, trigger_steps=T2_TRIGGER_STEPS)
    monkeypatch.setattr(j_t2, "BENCH", T2_BENCH)
    monkeypatch.setattr(j_t2, "save_result", lambda *a, **k: None)
    monkeypatch.setattr(j_t2, "trigger_policy_section", functools.partial(
        j_t2.trigger_policy_section, steps=T2_TRIGGER_STEPS))
    want = j_t2.run()
    for pes, _ in T2_BENCH:
        for strat in t2.STRATS:
            for k in ("max_avg_load", "ext_int_comm", "pct_migrations",
                      "migrated_load"):
                np.testing.assert_allclose(out[pes][strat][k],
                                           want[pes][strat][k], rtol=1e-6,
                                           err_msg=f"{pes} {strat} {k}")
    for strat in t2.TRIGGER_STRATS:
        got, ref = out["trigger_policies"][strat], want["trigger_policies"][
            strat]
        assert got["rebalances"] == ref["rebalances"], strat
        for k in ("mean_max_avg", "migrated_load", "modeled_seconds"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5)


def test_fig4_reduced_matches_jax(monkeypatch):
    """The port's Fig 4 at 20k particles, 40 steps: its assertions hold,
    and every strategy's fire steps, external bytes and migrated bytes
    equal the JAX script's (``greedy-refine`` against the JAX host loop,
    the rest against its scanned driver); mean max/avg within 1e-6."""
    from benchmarks import fig4_pic_lb as j_f4
    from benchmarks_torch import fig4_pic_lb as f4

    out = f4.run(steps=40, n=20_000, device=CPU)
    monkeypatch.setattr(j_f4, "save_result", lambda *a, **k: None)
    want = j_f4.run(steps=40, n=20_000)
    for strat, ref in want.items():
        got = out[strat]
        for k in ("mean_ext_bytes", "total_migrated_bytes"):
            assert got[k] == ref[k], (strat, k)
        np.testing.assert_allclose(got["mean_max_avg"], ref["mean_max_avg"],
                                   rtol=1e-6)
        np.testing.assert_allclose(got["max_avg_series"],
                                   ref["max_avg_series"], rtol=1e-6)
    assert sum(out["greedy-refine"]["lb_steps"]) == 3


def test_fig5_reduced_matches_jax(monkeypatch):
    """The port's Fig 5 at 4 and 8 PEs, 50k particles, 50 steps, with a
    4-lane, 12-step batched sweep: its assertions hold; per scale and
    strategy, external bytes equal the JAX script's and max/avg is within
    1e-6; the sweep's four lanes (the same scenarios in both registries)
    agree within ``tests/test_engine.py``'s 1e-4.  The modeled times include the
    measured plan wall time: at this size the assertion holds with 2.9 s
    or more of diff-comm planning (about 0.1 s on an idle CPU), where at
    20k particles × 30 steps a loaded CPU's 0.36 s broke it."""
    import functools

    from benchmarks import fig5_scaling as j_f5
    from benchmarks_torch import fig5_scaling as f5

    sweep = dict(batch=4, steps=12)
    out = f5.run(n=50_000, steps=50, device=CPU, scales=[4, 8],
                 sweep=sweep)
    monkeypatch.setattr(j_f5, "SCALES", [4, 8])
    monkeypatch.setattr(j_f5, "save_result", lambda *a, **k: None)
    monkeypatch.setattr(j_f5, "batched_scenario_sweep", functools.partial(
        j_f5.batched_scenario_sweep, **sweep))
    want = j_f5.run(n=50_000, steps=50)
    assert not want["sharded_planner"] and not out["sharded_planner"]
    for pes in (4, 8):
        for strat in ("none", "greedy-refine", "diff-comm"):
            got, ref = out[pes][strat], want[pes][strat]
            assert got["mean_ext"] == ref["mean_ext"], (pes, strat)
            np.testing.assert_allclose(got["max_avg"], ref["max_avg"],
                                       rtol=1e-6)
    cells = out["batched_scenarios"]["per_scenario"]
    ref_cells = want["batched_scenarios"]["per_scenario"]
    common = sorted(set(cells) & set(ref_cells))
    assert len(common) == 4 and set(cells) == set(ref_cells)
    for name in common:
        np.testing.assert_allclose(cells[name]["mean_max_avg"],
                                   ref_cells[name]["mean_max_avg"],
                                   rtol=1e-4)
