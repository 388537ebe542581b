#!/usr/bin/env python3
"""Sharded replay against the single-device replay on the port
(counterpart of ``benchmarks/replay_shard_bench.py``).

Replays every registered scenario (``sim/scenarios.py``, default sizes,
diff-comm k = 4, 200 steps, LB every 10) twice: through the single-device
device-resident loop (``run_series(scan=True)``) and through the sharded
replay (``run_series_sharded``: evolve, trigger and metrics on the
problem, each fired plan's diffusion over the mesh); and the PIC driver
(20 000 particles, 60 steps) with ``sharded_replay=True`` (the particles
in per-shard slabs, every fired exchange a ring all-to-all).

The JAX script forces 8 virtual XLA host devices.  Here the mesh is a
``distributed.mesh.ShardMesh`` on one device: the D shards are the
leading axis of every per-shard tensor, D the largest count up to
``NUM_SHARDS`` = 8 that divides the extents (the JAX rule with 8
devices: 8 for 16 nodes, 4 for pic-geometric's 4).  The JSON says so
(``device``, ``num_shards``, ``shards_share_one_device: true``).

The JAX script's gates, unchanged (**parity, not speed**): every scenario
reproduces the single-device run bit for bit in ``SERIES_FIELDS``, the
PIC run in ``PIC_FIELDS``, and the PIC exchange conserves particles.  The
resilience section (one shard of the mesh dead at step 40 of 120; the
PIC run's shard D/2 dead at step 20) keeps its gates: the degraded run
finite, the dead shard's nodes evacuated, no plan rejected, the
post-fault peak load within ``DEGRADE_BOUND`` = 3.0 of the healthy run's,
and the PIC fault run's particles equal to the ``strategy="none"`` run's.
Wall times are reported, not asserted (D shards on one device measure
the shard axis' overhead, not distributed planning).

Results go to ``artifacts/bench_torch/replay_shard_bench.json`` and the
stable schema's ``artifacts/bench_torch/BENCH_replay.json`` (device, the
card's name and power limit, torch/CUDA versions, git commit); the
repository root's ``BENCH_replay.json`` is the JAX package's.

Run from the repository root:
    python3 benchmarks_torch/replay_shard_bench.py [--device cuda|cpu]
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from benchmarks_torch.common import (  # noqa: E402
    PIC_BASE, bench_main, finish, median_run, table)
from repro_torch.kernels import resolve_device  # noqa: E402

SCHEMA = "replay-bench/v4"
REPEATS = 3
#: the JAX script's virtual device count
NUM_SHARDS = 8
DEGRADE_BOUND = 3.0

SERIES_FIELDS = ("max_avg", "ext_int", "migrations", "lb_fired",
                 "max_load", "migrated_load", "final_assignment")
PIC_FIELDS = ("max_avg", "ext_bytes", "int_bytes", "migrations",
              "migrated_bytes", "lb_steps", "final_x", "final_y")


def num_shards(*extents, limit=NUM_SHARDS) -> int:
    """The JAX rule for ``limit`` devices: the largest count up to
    ``limit`` that divides every extent."""
    D = min([limit, *extents])
    while any(m % D for m in extents):
        D -= 1
    return D


def _parity(ref, got, fields):
    """Per-field bit-for-bit equality (wall-derived fields excluded)."""
    return {f: bool(np.array_equal(np.asarray(getattr(ref, f)),
                                   np.asarray(getattr(got, f))))
            for f in fields}


def bench_scenarios(out, *, steps=200, lb_every=10, k=4, device="cuda",
                    repeats=REPEATS, names=None):
    from repro_torch.sim import scenarios, simulator

    dev = resolve_device(device)
    out["scenarios"] = {}
    rows = []
    for name in names or scenarios.available():
        prob, evolve = scenarios.get(name).instantiate(device=dev)
        kw = dict(steps=steps, lb_every=lb_every, strategy="diff-comm",
                  strategy_kwargs=dict(k=k))
        single, single_wall = median_run(
            lambda: simulator.run_series(prob, evolve, scan=True, **kw),
            repeats)
        D = num_shards(prob.num_nodes)
        sharded, sharded_wall = median_run(
            lambda: simulator.run_series_sharded(prob, evolve,
                                                 num_shards=D, **kw),
            repeats)
        par = _parity(single, sharded, SERIES_FIELDS)
        out["scenarios"][name] = dict(
            num_nodes=prob.num_nodes, num_shards=D,
            rebalances=float(single.lb_fired.sum()),
            migrated_load=float(single.migrated_load.sum()),
            single_wall_seconds=single_wall,
            sharded_wall_seconds=sharded_wall,
            parity=par, bit_for_bit=all(par.values()))
        rows.append([name, prob.num_nodes, D, int(single.lb_fired.sum()),
                     f"{single_wall:.3f}", f"{sharded_wall:.3f}",
                     all(par.values())])
    print(f"\nscenario registry replay (diff-comm k={k}, {steps} steps on "
          f"{dev}, median of {repeats})")
    print(table(["scenario", "P", "shards", "rebalances", "single s",
                 "sharded s", "bit-for-bit"], rows))
    return out


def bench_pic(out, *, steps=60, lb_every=10, n_particles=20_000,
              device="cuda", repeats=REPEATS):
    from repro_torch.pic import driver
    from repro_torch.runtime import migrate as rt_migrate

    dev = resolve_device(device)
    base = dict(PIC_BASE, n_particles=n_particles, steps=steps,
                lb_every=lb_every, strategy="diff-comm",
                strategy_kwargs=dict(k=4), device=str(dev))
    D = num_shards(base["n_particles"], base["num_pes"])
    single, single_wall = median_run(
        lambda: driver.run(driver.PICConfig(**base)), repeats)
    sharded, sharded_wall = median_run(
        lambda: driver.run(driver.PICConfig(
            sharded_replay=True, replay_shards=D, **base)), repeats)
    par = _parity(single, sharded, PIC_FIELDS)
    conserved = bool(sharded.final_x.shape[0] == base["n_particles"]
                     and np.isfinite(sharded.final_x).all())
    out["pic"] = dict(
        n_particles=base["n_particles"], num_pes=base["num_pes"],
        manifest_method=rt_migrate.resolve_method(
            "auto", n=base["n_particles"], num_nodes=base["num_pes"],
            device=dev),
        num_shards=D,
        rebalances=float(single.lb_steps.sum()),
        migrated_bytes=float(single.migrated_bytes.sum()),
        particles_conserved=conserved,
        single_wall_seconds=single_wall,
        sharded_wall_seconds=sharded_wall,
        parity=par, bit_for_bit=all(par.values()))
    print(f"\nPIC driver {base['n_particles']} particles, {steps} steps, "
          f"{D} shards on {dev}, executed ring exchange")
    print(table(
        ["path", "rebalances", "migrated bytes", "wall s", "bit-for-bit"],
        [["single", int(single.lb_steps.sum()),
          f"{single.migrated_bytes.sum():.0f}", f"{single_wall:.3f}", "-"],
         ["sharded", int(sharded.lb_steps.sum()),
          f"{sharded.migrated_bytes.sum():.0f}", f"{sharded_wall:.3f}",
          all(par.values())]]))
    return out


def bench_resilience(out, *, steps=120, lb_every=10, k=4, pic_steps=60,
                     pic_fault_step=20, n_particles=20_000, device="cuda"):
    """Fault-injected replay: one shard dies at ``steps // 3``; the PIC
    run's shard D/2 at ``pic_fault_step``.  The gates of the JAX script
    (see the module docstring)."""
    from repro_torch.pic import driver
    from repro_torch.runtime import resilience as rz
    from repro_torch.sim import scenarios, simulator

    dev = resolve_device(device)
    prob, evolve = scenarios.get("stencil-wave").instantiate(device=dev)
    D = num_shards(prob.num_nodes)
    fault_step = steps // 3
    dead_shard = D // 2
    kw = dict(steps=steps, lb_every=lb_every, strategy="diff-comm",
              strategy_kwargs=dict(k=k), num_shards=D)
    healthy = simulator.run_series_sharded(prob, evolve, **kw)
    fs = rz.FaultSchedule(events=((fault_step, dead_shard, "die"),))
    degraded = simulator.run_series_sharded(prob, evolve, faults=fs, **kw)

    rpd = prob.num_nodes // D
    dead_nodes = np.arange(dead_shard * rpd, (dead_shard + 1) * rpd)
    evacuated = not np.isin(degraded.final_assignment, dead_nodes).any()
    finite = bool(np.isfinite(degraded.max_avg).all()
                  and np.isfinite(degraded.max_load).all())
    rejected = float(degraded.plan_rejected.sum())
    post = slice(fault_step + lb_every, None)  # past the evacuation spike
    healthy_peak = float(np.mean(healthy.max_load[post]))
    degraded_peak = float(np.mean(degraded.max_load[post]))
    inflation = degraded_peak / healthy_peak

    pic = dict(PIC_BASE, n_particles=n_particles, steps=pic_steps,
               lb_every=lb_every, seed=0, sharded_replay=True,
               device=str(dev))
    pic_D = num_shards(pic["n_particles"], pic["num_pes"])
    pic_fs = rz.FaultSchedule(events=((pic_fault_step, pic_D // 2, "die"),))
    pic_ref = driver.run(driver.PICConfig(strategy="none",
                                          replay_shards=pic_D, **pic))
    pic_dead = driver.run(driver.PICConfig(
        strategy="diff-comm", strategy_kwargs=dict(k=4), faults=pic_fs,
        replay_shards=pic_D, **pic))
    pic_conserved = bool(
        np.array_equal(pic_dead.final_x, pic_ref.final_x)
        and np.array_equal(pic_dead.final_y, pic_ref.final_y))

    out["resilience"] = dict(
        num_shards=D, fault_step=fault_step, dead_shard=dead_shard,
        evacuated=evacuated, finite=finite, plans_rejected=rejected,
        healthy_peak_load=healthy_peak, degraded_peak_load=degraded_peak,
        peak_inflation=inflation, degrade_bound=DEGRADE_BOUND,
        pic_num_shards=pic_D, pic_particles_conserved=pic_conserved,
        pic_deferred_final=float(np.asarray(pic_dead.deferred)[-1])
        if pic_dead.deferred is not None else 0.0)
    print(f"\nresilience: shard {dead_shard}/{D} dies at step "
          f"{fault_step} of {steps}")
    print(table(
        ["gate", "value", "pass"],
        [["evacuated (0 objects on dead nodes)", str(evacuated), evacuated],
         ["finite metrics", str(finite), finite],
         ["plans rejected", f"{rejected:.0f}", rejected == 0.0],
         ["post-fault peak inflation",
          f"{inflation:.2f}x (bound {DEGRADE_BOUND}x)",
          inflation < DEGRADE_BOUND],
         ["PIC particles conserved (dead shard)", str(pic_conserved),
          pic_conserved]]))
    return out


def gates(out):
    """Each gate of the JAX script: ``{name: (holds, message)}``."""
    res = {}
    for name, r in out.get("scenarios", {}).items():
        res[f"{name}: sharded == single"] = (
            r["bit_for_bit"], f"sharded replay diverged from single-device "
            f"on {name}: {[f for f, v in r['parity'].items() if not v]}")
    if "pic" in out:
        p = out["pic"]
        res["pic: particles conserved"] = (
            p["particles_conserved"], "sharded exchange must conserve "
            "particles")
        res["pic: sharded == single"] = (
            p["bit_for_bit"], f"sharded PIC replay diverged: "
            f"{[f for f, v in p['parity'].items() if not v]}")
    if "resilience" in out:
        z = out["resilience"]
        res.update({
            "resilience: finite": (
                z["finite"], "degraded replay produced non-finite metrics"),
            "resilience: evacuated": (
                z["evacuated"], f"dead shard {z['dead_shard']} still owns "
                "objects after the run"),
            "resilience: no plan rejected": (
                z["plans_rejected"] == 0.0, f"{z['plans_rejected']:.0f} "
                "engine plans failed validate_plan on a live mesh"),
            "resilience: peak inflation < bound": (
                z["peak_inflation"] < DEGRADE_BOUND,
                f"post-fault peak load {z['peak_inflation']:.2f}x exceeds "
                f"{DEGRADE_BOUND}x"),
            "resilience: PIC particles conserved": (
                z["pic_particles_conserved"],
                "PIC fault run lost or corrupted particles")})
    return res


def check(out):
    for holds, msg in gates(out).values():
        assert holds, msg


def run(device="cuda", *, repeats=REPEATS, out_path=None):
    dev = resolve_device(device)
    out = dict(device=str(dev), num_shards=NUM_SHARDS,
               shards_share_one_device=True)
    bench_scenarios(out, device=dev, repeats=repeats)
    bench_pic(out, device=dev, repeats=repeats)
    bench_resilience(out, device=dev)
    return finish("replay_shard_bench", out, bench="replay", schema=SCHEMA,
                  device=dev, repeats=repeats, check=check,
                  out_path=out_path)


if __name__ == "__main__":
    bench_main(run, __doc__, REPEATS)
