"""Replays: the PyTorch port's ``run_series`` (both of its loops) against
the JAX package's scanned replay on the CPU.

Whole replays are held exactly on evolves that replay a JAX-recorded load
table, so that a 1-ulp difference in an evolved load cannot flip a
take-while decision and hide behind it; ``bimodal-churn``, whose evolve is
integer arithmetic, is also replayed through both registries.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sim import scenarios as j_scen
from repro.sim import simulator as j_sim
from repro_torch import interop
from repro_torch.sim import scenarios as t_scen
from repro_torch.sim import simulator as t_sim

CPU = "cpu"
STEPS, LB_EVERY = 24, 6


def _recorded(name, **kw):
    """(torch problem, torch evolve, JAX problem, JAX evolve): both evolves
    replay the loads (and edge bytes) JAX's evolve gives at t = 0..STEPS-1."""
    jp, jev = j_scen.get(name).instantiate(**kw)
    states = [jev(jp, jnp.int32(t)) for t in range(STEPS)]
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


def _assert_series_match(got, want):
    """lb_fired and final_assignment exact; max_avg, ext_int and
    migrated_load within 1e-5 relative (f32 sums in another order)."""
    np.testing.assert_array_equal(got.lb_fired, want.lb_fired)
    np.testing.assert_array_equal(got.final_assignment,
                                  want.final_assignment)
    for f in ("max_avg", "ext_int", "migrated_load", "max_load",
              "migrations"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-5, atol=1e-6, err_msg=f)


CASES = [("diff-comm", "every"), ("diff-comm", "threshold"),
         ("diff-coord", "predictive"), ("none", None)]


@pytest.mark.parametrize("strategy,trigger", CASES)
@pytest.mark.parametrize("name", ["stencil-wave", "pic-geometric"])
def test_run_series_recorded_matches_jax_scanned(name, strategy, trigger):
    """Both port loops against JAX's scanned replay on a recorded table."""
    kw = (dict(grid=16, num_nodes=8) if name == "stencil-wave"
          else dict(num_pes=4))
    tp, tev, jp, jev = _recorded(name, **kw)
    rkw = dict(steps=STEPS, lb_every=LB_EVERY, strategy=strategy,
               trigger=trigger)
    want = j_sim.run_series(jp, jev, scan=True, **rkw)
    device = t_sim.run_series(tp, tev, **rkw)          # picks the device loop
    host = t_sim.run_series(tp, tev, scan=False, **rkw)
    assert device.scanned and not host.scanned
    for got in (device, host):
        _assert_series_match(got, want)
    if strategy != "none":
        assert want.lb_fired.sum() > 0
    fired = device.lb_fired > 0
    assert (device.plan_step_seconds[fired] > 0).all()
    assert (device.plan_step_seconds[~fired] == 0).all()
    assert device.plan_seconds == pytest.approx(
        device.plan_step_seconds.sum())


@pytest.mark.parametrize("trigger", ["every", "threshold"])
def test_run_series_bimodal_churn_registry_matches_jax(trigger):
    """The registered ``bimodal-churn`` evolve (exact in both packages)
    replayed through each package's registry."""
    kw = dict(grid=16, num_nodes=8, churn_every=2)
    tp, tev = t_scen.get("bimodal-churn").instantiate(device=CPU, **kw)
    jp, jev = j_scen.get("bimodal-churn").instantiate(**kw)
    rkw = dict(steps=STEPS, lb_every=LB_EVERY, trigger=trigger)
    want = j_sim.run_series(jp, jev, **rkw)
    got = t_sim.run_series(tp, tev, **rkw)
    assert want.scanned and got.scanned
    _assert_series_match(got, want)


@pytest.mark.parametrize("name", ["stencil-wave", "adversarial-hotspot"])
def test_run_series_loops_agree_on_registered_scenarios(name):
    """The port's device-resident and host loops on a registered evolve:
    every record equal."""
    tp, tev = t_scen.get(name).instantiate(device=CPU, grid=16, num_nodes=8)
    rkw = dict(steps=STEPS, lb_every=LB_EVERY, trigger="threshold")
    a = t_sim.run_series(tp, tev, scan=True, **rkw)
    b = t_sim.run_series(tp, tev, scan=False, **rkw)
    for f in ("lb_fired", "final_assignment", "max_avg", "ext_int",
              "max_load", "migrated_load"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert a.lb_fired.sum() > 0
