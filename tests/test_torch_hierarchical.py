"""Two-level placement of the port (paper §III.D: ``core.hierarchical``,
``LBEngine.plan_hier_fn``, ``threads_per_node`` in ``run_series`` and the
PIC driver) against the JAX package on the CPU.

Integer outputs (threads) are exact against ``repro.core.hierarchical``'s
device LPT and its NumPy oracle, ties included; thread loads are exact
(both add in the same order); ``thread_max_avg`` of the replays is held
to the JAX package's within 1e-6 relative (the two packages' per-step
load vectors agree to float32 rounding)."""
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.core import comm_graph as j_cg
from repro.core import engine as j_engine
from repro.core import hierarchical as j_hier
from repro.pic import driver as j_driver
from repro.sim import scenarios as j_scen
from repro.sim import simulator as j_sim
from repro.sim import stencil as j_stencil
from repro.sim import synthetic as j_syn
from repro_torch.core import comm_graph as t_cg
from repro_torch.core import engine as t_engine
from repro_torch.core import hierarchical as t_hier
from repro_torch.pic import driver as t_driver
from repro_torch.sim import scenarios as t_scen
from repro_torch.sim import simulator as t_sim
from repro_torch.sim import stencil as t_stencil
from repro_torch.sim import synthetic as t_syn

CPU = "cpu"
RTOL = 1e-6


def _makespans(loads, assignment, thread, P, T):
    pe = np.asarray(assignment) * T + np.asarray(thread)
    return np.bincount(pe, weights=np.asarray(loads), minlength=P * T)


def _lpt(loads, assignment, P, T):
    """The port's LPT threads; every call also holds them to the JAX
    package's device LPT, exactly."""
    loads = np.asarray(loads, np.float32)
    assignment = np.asarray(assignment, np.int32)
    got = t_hier.lpt_threads(torch.as_tensor(loads),
                             torch.as_tensor(assignment), num_nodes=P,
                             threads_per_node=T).numpy()
    want = np.asarray(j_hier.lpt_threads(loads, assignment, num_nodes=P,
                                         threads_per_node=T))
    np.testing.assert_array_equal(got, want)
    return got


# ------------------------------------------------------------ exactness --


def test_lpt_balances_hand_checked_case_exactly():
    loads = np.array([5, 4, 3, 2, 1], np.float32)
    thread = _lpt(loads, np.zeros(5, np.int32), 1, 3)
    tl = _makespans(loads, np.zeros(5, np.int32), thread, 1, 3)
    np.testing.assert_array_equal(tl, [5.0, 5.0, 5.0])


def test_lpt_descending_order_and_tie_breaks():
    # equal loads: rank r goes to thread r (argmin takes the lowest index)
    # and equal loads keep index order (stable sort)
    loads = np.ones(7, np.float32)
    thread = _lpt(loads, np.zeros(7, np.int32), 1, 3)
    np.testing.assert_array_equal(thread, [0, 1, 2, 0, 1, 2, 0])


def _brute_force_makespan(loads, T):
    best = np.inf
    for assign in itertools.product(range(T), repeat=len(loads)):
        tl = np.zeros(T)
        for load, t in zip(loads, assign):
            tl[t] += load
        best = min(best, tl.max())
    return best


def test_lpt_within_classic_bound_of_bruteforce_optimum():
    rng = np.random.default_rng(7)
    for trial in range(6):
        n, T = int(rng.integers(4, 9)), int(rng.integers(2, 4))
        loads = rng.integers(1, 20, n).astype(np.float32)
        thread = _lpt(loads, np.zeros(n, np.int32), 1, T)
        got = _makespans(loads, np.zeros(n, np.int32), thread, 1, T).max()
        opt = _brute_force_makespan(loads, T)
        # Graham's LPT bound: makespan <= (4/3 - 1/(3T)) * OPT
        assert got <= (4.0 / 3.0 - 1.0 / (3 * T)) * opt + 1e-5, (
            trial, loads, got, opt)


# ----------------------------------------------------------- edge cases --


def test_lpt_empty_node_and_uneven_nodes():
    loads = np.array([3, 1, 2, 5], np.float32)
    assignment = np.array([0, 0, 2, 2], np.int32)       # node 1 empty
    thread = _lpt(loads, assignment, 3, 2)
    assert (thread >= 0).all() and (thread < 2).all()
    tl = _makespans(loads, assignment, thread, 3, 2)
    np.testing.assert_array_equal(tl, [3, 1, 0, 0, 5, 2])


def test_lpt_more_threads_than_objects():
    thread = _lpt(np.array([2.0, 1.0], np.float32), np.zeros(2, np.int32),
                  1, 8)
    np.testing.assert_array_equal(thread, [0, 1])


def test_lpt_single_thread_is_all_zero():
    rng = np.random.default_rng(0)
    loads = rng.random(50).astype(np.float32)
    assignment = rng.integers(0, 5, 50).astype(np.int32)
    np.testing.assert_array_equal(_lpt(loads, assignment, 5, 1),
                                  np.zeros(50, np.int32))


# ---------------------------------------------- device LPT vs the oracle --


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_lpt_matches_host_oracle_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    N, P, T = 300, 9, 4
    loads = (rng.random(N) * 10).astype(np.float32)
    assignment = rng.integers(0, P, N).astype(np.int32)
    dev = _lpt(loads, assignment, P, T)
    np.testing.assert_array_equal(
        dev, t_hier.within_node_lpt(loads, assignment, P, T))
    np.testing.assert_array_equal(
        dev, j_hier.within_node_lpt(loads, assignment, P, T))
    # thread loads: the same float32 bits as the JAX package's
    got = t_hier.thread_loads(torch.as_tensor(loads),
                              torch.as_tensor(assignment),
                              torch.as_tensor(dev), num_nodes=P,
                              threads_per_node=T).numpy()
    want = np.asarray(j_hier.thread_loads(loads, assignment, dev,
                                          num_nodes=P, threads_per_node=T))
    np.testing.assert_array_equal(got, want)


def test_device_lpt_matches_host_with_ties():
    # heavy tie pressure: few distinct loads, and the idle-load case where
    # most objects share one value
    rng = np.random.default_rng(3)
    loads = rng.integers(1, 4, 120).astype(np.float32)
    assignment = rng.integers(0, 4, 120).astype(np.int32)
    np.testing.assert_array_equal(
        _lpt(loads, assignment, 4, 3),
        t_hier.within_node_lpt(loads, assignment, 4, 3))
    idle = np.where(rng.random(200) < 0.8, np.float32(0.05),
                    rng.random(200).astype(np.float32))
    a = rng.integers(0, 6, 200).astype(np.int32)
    np.testing.assert_array_equal(_lpt(idle, a, 6, 5),
                                  j_hier.within_node_lpt(idle, a, 6, 5))


def test_flatten_hierarchy_and_thread_loads():
    loads = np.array([1, 2, 3, 4], np.float32)
    assignment = np.array([0, 1, 0, 1], np.int32)
    thread = np.array([1, 0, 0, 1], np.int32)
    pe = t_hier.flatten_hierarchy(torch.as_tensor(assignment),
                                  torch.as_tensor(thread), 2)
    np.testing.assert_array_equal(pe.numpy(), [1, 2, 0, 3])
    np.testing.assert_array_equal(
        pe.numpy(), j_hier.flatten_hierarchy(assignment, thread, 2))
    tl = t_hier.thread_loads(torch.as_tensor(loads),
                             torch.as_tensor(assignment),
                             torch.as_tensor(thread), num_nodes=2,
                             threads_per_node=2)
    np.testing.assert_array_equal(tl.numpy(), [3, 1, 2, 4])


# ------------------------------------------------------- engine wiring --


def _problems():
    t = t_syn.hotspot(t_stencil.stencil_2d(12, 12, 9, mapping="tiled",
                                           device=CPU), node=0, factor=6.0)
    j = j_syn.hotspot(j_stencil.stencil_2d(12, 12, 9, mapping="tiled"),
                      node=0, factor=6.0)
    return t, j


def test_engine_plan_hier_fn_is_plan_fn_plus_lpt():
    """Assignment, threads and sweeps equal the JAX package's
    ``plan_hier_fn`` exactly, and the port's own plan_fn + LPT."""
    tp, jp = _problems()
    eng = t_engine.get_engine(k=4, threads_per_node=4, device=CPU)
    a, thread, stats = eng.plan_hier_fn(tp)
    a_ref, stats_ref = t_engine.get_engine(k=4, device=CPU).plan_fn(tp)
    np.testing.assert_array_equal(a.numpy(), a_ref.numpy())
    assert int(stats.diffusion_iters) == int(stats_ref.diffusion_iters)
    np.testing.assert_array_equal(
        thread.numpy(), t_hier.lpt_threads(tp.loads, a, num_nodes=9,
                                           threads_per_node=4).numpy())
    ja, jt, jstats = jax.jit(j_engine.get_engine(
        k=4, threads_per_node=4).plan_hier_fn)(jp)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(thread.numpy(), np.asarray(jt))
    assert int(stats.diffusion_iters) == int(jstats.diffusion_iters)


def test_engine_plan_emits_thread_placement_in_info():
    tp, jp = _problems()
    plan = t_engine.get_engine(k=4, threads_per_node=3, device=CPU).plan(tp)
    assert plan.info["threads_per_node"] == 3
    thread = plan.info["thread"]
    assert thread.shape == plan.assignment.shape
    assert (thread >= 0).all() and (thread < 3).all()
    want = j_engine.get_engine(k=4, threads_per_node=3).plan(jp)
    np.testing.assert_array_equal(thread, want.info["thread"])
    np.testing.assert_array_equal(
        t_engine.get_engine(k=4, threads_per_node=3,
                            device=CPU).plan_hier(tp).info["thread"], thread)


def test_engine_without_threads_rejects_hier_plan():
    eng = t_engine.get_engine(k=4, device=CPU)
    with pytest.raises(ValueError, match="threads_per_node"):
        eng.plan_hier_fn(_problems()[0])
    with pytest.raises(ValueError, match="threads_per_node"):
        eng.plan_hier(_problems()[0])


def test_plan_hier_batch_fn_matches_per_problem():
    hot = [(0, 5.0), (2, 3.0)]
    tprobs = [t_syn.hotspot(t_stencil.stencil_2d(10, 10, 4, device=CPU),
                            node=n, factor=f) for n, f in hot]
    jprobs = [j_syn.hotspot(j_stencil.stencil_2d(10, 10, 4), node=n,
                            factor=f) for n, f in hot]
    eng = t_engine.get_engine(k=2, threads_per_node=2, device=CPU)
    a_b, t_b, _ = eng.plan_hier_batch_fn(t_cg.stack_problems(tprobs))
    ja, jt, _ = jax.jit(j_engine.get_engine(
        k=2, threads_per_node=2).plan_hier_batch_fn)(
            j_cg.stack_problems(jprobs))
    for b, p in enumerate(tprobs):
        a1, t1, _ = eng.plan_hier_fn(p)
        np.testing.assert_array_equal(a_b[b].numpy(), a1.numpy())
        np.testing.assert_array_equal(t_b[b].numpy(), t1.numpy())
    np.testing.assert_array_equal(a_b.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(t_b.numpy(), np.asarray(jt))


# -------------------------------------------------- replay-layer wiring --


def test_run_series_thread_metrics_host_vs_scan_parity():
    """Both loops record thread max/avg a step, equal to each other and
    within ``RTOL`` of the JAX package's scanned and host replays; fire
    steps equal."""
    tp, tev = t_scen.get("stencil-wave").instantiate(device=CPU, grid=12,
                                                     num_nodes=4)
    jp, jev = j_scen.get("stencil-wave").instantiate(grid=12, num_nodes=4)
    kw = dict(steps=12, lb_every=4, strategy="diff-comm",
              strategy_kwargs=dict(k=2), threads_per_node=4)
    host = t_sim.run_series(tp, tev, scan=False, **kw)
    scan = t_sim.run_series(tp, tev, scan=True, **kw)
    assert scan.thread_max_avg.shape == (12,)
    np.testing.assert_allclose(host.thread_max_avg, scan.thread_max_avg,
                               rtol=RTOL)
    assert (scan.thread_max_avg >= 1.0 - 1e-5).all()
    for scan_j in (True, False):
        want = j_sim.run_series(jp, jev, scan=scan_j, **kw)
        np.testing.assert_array_equal(scan.lb_fired, want.lb_fired)
        np.testing.assert_allclose(scan.thread_max_avg,
                                   want.thread_max_avg, rtol=RTOL)


def test_run_series_without_threads_has_no_thread_series():
    p, ev = t_scen.get("stencil-wave").instantiate(device=CPU, grid=8,
                                                   num_nodes=4)
    for scan in (True, False):
        res = t_sim.run_series(p, ev, steps=6, lb_every=3, strategy="none",
                               scan=scan)
        assert res.thread_max_avg is None


def test_pic_driver_thread_metrics_host_vs_scan_parity():
    """The port's PIC loop records thread max/avg a step, within ``RTOL``
    of the JAX driver's scanned and host loops (which agree with each
    other); the LB steps equal."""
    base = dict(L=100, n_particles=2000, steps=12, k=1, rho=0.9, cx=8,
                cy=8, num_pes=4, mapping="striped", lb_every=5, seed=0,
                strategy="diff-comm", strategy_kwargs=dict(k=2),
                threads_per_node=2)
    got = t_driver.run(t_driver.PICConfig(**base, device=CPU))
    assert got.thread_max_avg.shape == (12,)
    assert (got.thread_max_avg >= 1.0 - 1e-5).all()
    for scan in (True, False):
        want = j_driver.run(j_driver.PICConfig(scan=scan, **base))
        np.testing.assert_array_equal(got.lb_steps, want.lb_steps)
        np.testing.assert_allclose(got.thread_max_avg, want.thread_max_avg,
                                   rtol=RTOL)
