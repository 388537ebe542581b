"""The PyTorch port's PIC PRK driver against the JAX package's scanned
driver, end to end on the CPU.

Both draw the same particles from one seed (the port carries a copy of the
numpy initializer), push them, measure chare loads, fire the same
rebalances, plan the same assignments and execute the same exchanges.
"""
import numpy as np
import pytest
import torch

from repro.pic import chares as j_chares
from repro.pic import driver as j_driver
from repro.pic import particles as j_particles
from repro_torch.pic import chares as t_chares
from repro_torch.pic import driver as t_driver
from repro_torch.pic import particles as t_particles

BASE = dict(L=100, n_particles=4000, steps=40, cx=8, cy=8, num_pes=4,
            lb_every=10)
EXACT = ("lb_steps", "migrations", "migrated_bytes", "ext_bytes",
         "int_bytes", "max_avg")


def _edge_report(fx, fy, want_x, want_y, L, cx, cy):
    """Particles whose positions differ, and whether each sits on a chare
    edge (where one ulp moves it to the neighbouring chare)."""
    bad = np.nonzero((fx != want_x) | (fy != want_y))[0]
    w, h = L / cx, L / cy
    on_edge = [min(abs(want_x[i] / w - round(want_x[i] / w)),
                   abs(want_y[i] / h - round(want_y[i] / h))) < 1e-5
               for i in bad]
    return list(zip(bad.tolist(), on_edge))


@pytest.mark.parametrize("strategy,trigger", [
    ("diff-comm", None), ("diff-coord", None),
    ("diff-comm+threshold", None), ("diff-comm", "predictive"),
    ("none", None),
])
def test_pic_run_matches_jax_scanned(strategy, trigger):
    """Integer-valued records (fired steps, chares moved, bytes migrated,
    ext/int bytes) and max/avg exact; final positions within 1e-4 (a few
    f32 ulp at L = 100; none were off at the time of writing).  A position
    mismatch is reported with whether the particle sits on a chare edge."""
    cfg = dict(BASE, strategy=strategy, trigger=trigger)
    want = j_driver.run(j_driver.PICConfig(**cfg, scan=True))
    got = t_driver.run(t_driver.PICConfig(**cfg, device="cpu"))
    for f in EXACT:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    err = max(np.abs(got.final_x - want.final_x).max(),
              np.abs(got.final_y - want.final_y).max())
    assert err <= 1e-4, _edge_report(got.final_x, got.final_y, want.final_x,
                                     want.final_y, cfg["L"], cfg["cx"],
                                     cfg["cy"])
    if strategy != "none":
        assert got.lb_steps.sum() > 0 and got.migrated_bytes.sum() > 0
    gs, ws = got.summary(), want.summary()
    for k in ("mean_max_avg", "mean_ext_bytes", "mean_ext_int",
              "total_migrated_bytes"):
        assert gs[k] == pytest.approx(ws[k], rel=1e-12)


def test_pic_run_at_fig5_shape_matches_jax_scanned():
    """Fig 5's strong-scaling run at 8 PEs (L = 1200, 20×10 chares, k = 4,
    LB every 5, diff-comm k = 3), 50k particles: most chares are empty, so
    the stage-3 prefix sums round, and the port adds them in JAX's order.
    Every record exact."""
    cfg = dict(L=1200, n_particles=50_000, steps=12, k=4, rho=0.9,
               mode="GEOMETRIC", cx=20, cy=10, num_pes=8, mapping="striped",
               lb_every=5, strategy="diff-comm", strategy_kwargs=dict(k=3))
    want = j_driver.run(j_driver.PICConfig(**cfg, scan=True))
    got = t_driver.run(t_driver.PICConfig(**cfg, device="cpu"))
    for f in EXACT:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.lb_steps.sum() == 2


def test_same_particles_from_one_seed():
    for mode in ("GEOMETRIC", "SINUSOIDAL", "LINEAR", "PATCH"):
        a = j_particles.initialize(mode, 50, 1000, k=2, seed=4)
        b = t_particles.initialize(mode, 50, 1000, k=2, seed=4)
        for f in ("x", "y", "vx", "vy", "q"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_chare_of_device_matches_jax_exactly():
    """Float floor division as JAX does it, on cell and chare edges too."""
    import jax.numpy as jnp

    L, cx, cy = 1000, 12, 12
    rng = np.random.default_rng(0)
    x = (rng.random(20_000) * L).astype(np.float32)
    y = (rng.random(20_000) * L).astype(np.float32)
    w = np.float32(L / cx)
    edges = (np.arange(cx + 1) * w).astype(np.float32)
    x[:cx + 1] = edges
    x[cx + 1:2 * cx + 2] = np.nextafter(edges, np.float32(0))
    x[2 * cx + 2] = np.nextafter(np.float32(L), np.float32(0))
    y[:cx + 1] = edges
    got = t_chares.chare_of_device(torch.as_tensor(x), torch.as_tensor(y),
                                   L, cx, cy)
    want = j_chares.chare_of_device(jnp.asarray(x), jnp.asarray(y), L, cx, cy)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_later_slice_options_raise():
    # the sharded replay has been ported: it equals the single-device run;
    # faults and spill need it, as in the JAX package
    one = t_driver.run(t_driver.PICConfig(**BASE, device="cpu"))
    sh = t_driver.run(t_driver.PICConfig(**BASE, sharded_replay=True,
                                         replay_shards=2, device="cpu"))
    for f in EXACT + ("final_x", "final_y"):
        np.testing.assert_array_equal(getattr(sh, f), getattr(one, f))
    for kw in (dict(faults=object()), dict(on_overflow="spill")):
        with pytest.raises(ValueError, match="sharded_replay"):
            t_driver.run(t_driver.PICConfig(**BASE, **kw, device="cpu"))
    # two-level placement and telemetry have been ported
    res = t_driver.run(t_driver.PICConfig(
        **BASE, threads_per_node=2, telemetry="counters", device="cpu"))
    assert res.thread_max_avg.shape == res.max_avg.shape
    assert res.telemetry.steps_total == len(res.max_avg)
    # the host baselines have been ported: greedy plans in the step loop
    res = t_driver.run(t_driver.PICConfig(**BASE, strategy="greedy",
                                          device="cpu"))
    assert res.lb_steps.sum() == 3
    with pytest.raises(KeyError):
        t_driver.run(t_driver.PICConfig(**BASE, strategy="no-such",
                                        device="cpu"))
