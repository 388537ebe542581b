#!/usr/bin/env python3
"""LBEngine throughput on the port: the host loop against the
device-resident loop, and the batched replay against the per-scenario
loop (counterpart of ``benchmarks/engine_bench.py``).

In the port, ``run_series(scan=True)`` is the device-resident loop
(evolve, trigger and plan on the problem's device, records copied to the
host once) and ``scan=False`` the host loop (eager planning, each step's
metrics read to the host); ``sim/simulator.py`` describes both.
Sections, each the median of ``--repeats`` warm runs:

  * ``series``: ``stencil-wave`` with diff-comm at P = 64 nodes, K = 8,
    grid 32, 200 steps, LB every 10 — the host loop against the
    device-resident loop, with the plan trajectories' parity;
  * ``batch``: 16 lanes (``scenarios.batch_instances``) × 100 steps, LB
    every 5, k = 4 — ``run_series_batch`` against a Python loop of
    device-resident ``run_series`` calls, on end-to-end suite time from
    cold per-process caches, with warm times beside them.  The JAX
    package compiles one vmapped runner against 16; the port compiles
    nothing, and its batched replay runs its lanes one after another
    (``torch.vmap`` cannot trace the planner's loops).  "Cold" here
    clears the caches the port has: the planner engines
    (``core.engine._ENGINE_CACHE``), the named triggers
    (``runtime.triggers._named``) and the scenario memo
    (``sim.scenarios._INSTANCE_MEMO``; the 16 instances themselves are
    built once, before timing, as in the JAX script);
  * ``scenarios``: steps/s of each registered scenario through the
    device-resident loop (diff-comm k = 4, 100 steps, LB every 5);
  * ``pic``: the PIC driver's step loop (20 000 particles, 60 steps).
    The port's driver has one loop, device-resident (``pic/driver.py``);
    the JAX package's host loop (``PICConfig(scan=False)``) has no
    counterpart, so the section times that loop alone and reports
    ``host_seconds`` and ``speedup`` as None.

The JAX script's gates, kept as written: parity of the series and of
every batched lane first, then ``speedup >= 5.0`` (series) and
``batch_speedup >= 4.0`` (batch).  The script writes its JSON, then fails
(exit 1) on the first gate that does not hold.

Results go to ``artifacts/bench_torch/engine_bench.json`` and the stable
schema's ``artifacts/bench_torch/BENCH_engine.json`` (device, the card's
name and power limit, torch/CUDA versions, git commit); the repository
root's ``BENCH_engine.json`` is the JAX package's.

Run from the repository root:
    python3 benchmarks_torch/engine_bench.py [--device cuda|cpu]
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from benchmarks_torch.common import (  # noqa: E402
    PIC_BASE, bench_main, finish, median_run, table)
from repro_torch.kernels import resolve_device  # noqa: E402
from repro_torch.sim import scenarios, simulator  # noqa: E402

SCHEMA = "engine-bench/v2"
REPEATS = 3
SPEEDUP_GATE = 5.0
BATCH_SPEEDUP_GATE = 4.0


def _series(problem, evolve, *, scan, steps, lb_every, strategy, kw):
    return simulator.run_series(
        problem, evolve, steps=steps, lb_every=lb_every, strategy=strategy,
        strategy_kwargs=kw, scan=scan)


def bench_series(out, *, P=64, K=8, steps=200, grid=32, lb_every=10,
                 device="cuda", repeats=REPEATS):
    """Headline: stencil-wave, diff-comm, device-resident vs host loop."""
    dev = resolve_device(device)
    problem, evolve = scenarios.get("stencil-wave").instantiate(
        grid=grid, num_nodes=P, device=dev)
    kw = dict(k=K)
    common = dict(steps=steps, lb_every=lb_every, strategy="diff-comm",
                  kw=kw)
    # warm both loops
    _series(problem, evolve, scan=True, **common)
    _series(problem, evolve, scan=False, steps=lb_every + 2,
            lb_every=lb_every, strategy="diff-comm", kw=kw)
    res_scan, t_scan = median_run(
        lambda: _series(problem, evolve, scan=True, **common), repeats)
    res_eager, t_eager = median_run(
        lambda: _series(problem, evolve, scan=False, **common), repeats)
    parity = bool(
        np.allclose(res_eager.max_avg, res_scan.max_avg, rtol=1e-4)
        and np.allclose(res_eager.migrations, res_scan.migrations,
                        atol=1e-6))
    speedup = t_eager / max(t_scan, 1e-12)
    out["series"] = dict(
        P=P, K=K, steps=steps, grid=grid, lb_every=lb_every,
        repeats=repeats,
        eager_seconds=t_eager, scanned_seconds=t_scan,
        eager_steps_per_sec=steps / t_eager,
        scanned_steps_per_sec=steps / t_scan,
        speedup=speedup, parity=parity)
    print(f"run_series diff-comm  P={P} K={K} grid={grid}² steps={steps} "
          f"on {dev} (median of {repeats})")
    print(table(
        ["path", "seconds", "steps/sec"],
        [["host loop", f"{t_eager:.3f}", f"{steps / t_eager:.1f}"],
         ["device-resident", f"{t_scan:.4f}", f"{steps / t_scan:.1f}"],
         ["speedup", f"{speedup:.1f}x", ""]]))
    print(f"plan-trajectory parity (max/avg + migrations): {parity}")
    return out


def clear_caches():
    """The port's per-process caches (what "cold" clears)."""
    from repro_torch.core import engine
    from repro_torch.runtime import triggers

    engine._ENGINE_CACHE.clear()
    triggers._named.cache_clear()
    scenarios._INSTANCE_MEMO.clear()


def bench_batch(out, *, batch=16, steps=100, lb_every=5, k=4,
                device="cuda", repeats=REPEATS):
    """B scenario lanes: the batched replay vs the per-scenario loop, on
    end-to-end suite time from cold caches (the gated number) and warm."""
    dev = resolve_device(device)
    inst = scenarios.batch_instances(batch, device=dev)
    kw = dict(steps=steps, lb_every=lb_every, strategy="diff-comm",
              strategy_kwargs=dict(k=k))

    def loop():
        return [simulator.run_series(p, ev, scan=True, **kw)
                for _, p, ev in inst]

    def batched():
        return simulator.run_series_batch(inst, **kw)

    def cold(fn):
        clear_caches()
        return fn()

    batched()
    loop()
    bres, t_batch = median_run(lambda: cold(batched), repeats)
    singles, t_loop = median_run(lambda: cold(loop), repeats)
    _, t_batch_warm = median_run(batched, repeats)
    _, t_loop_warm = median_run(loop, repeats)
    parity = all(
        np.allclose(s.max_avg, b.max_avg, rtol=1e-4)
        and np.allclose(s.migrations, b.migrations, atol=1e-6)
        for s, b in zip(singles, bres.series))
    speedup = t_loop / max(t_batch, 1e-12)
    out["batch"] = dict(
        batch=batch, steps=steps, lb_every=lb_every, k=k, repeats=repeats,
        scenarios=[n for n, _, _ in inst],
        loop_seconds=t_loop, batched_seconds=t_batch,
        loop_warm_seconds=t_loop_warm, batched_warm_seconds=t_batch_warm,
        warm_speedup=t_loop_warm / max(t_batch_warm, 1e-12),
        loop_lane_steps_per_sec=batch * steps / t_loop,
        batched_lane_steps_per_sec=batch * steps / t_batch,
        speedup=speedup, parity=parity,
        lanes_in_sequence=True)
    print(f"\nbatched replay, {batch} scenario lanes × {steps} steps on "
          f"{dev}, suite time from cold caches (median of {repeats})")
    print(table(
        ["path", "suite seconds", "warm seconds"],
        [["per-scenario loop", f"{t_loop:.3f}", f"{t_loop_warm:.3f}"],
         ["batched replay", f"{t_batch:.3f}", f"{t_batch_warm:.3f}"],
         ["speedup", f"{speedup:.2f}x",
          f"{t_loop_warm / max(t_batch_warm, 1e-12):.2f}x"]]))
    print(f"per-lane trajectory parity: {parity}")
    return out


# the JAX script's small shapes for the per-scenario section
SMALL = {
    "stencil-wave": dict(grid=16, num_nodes=16),
    "pic-geometric": dict(cx=8, cy=8, num_pes=8, n_particles=10_000.0),
    "adversarial-hotspot": dict(grid=16, num_nodes=16),
    "bimodal-churn": dict(grid=16, num_nodes=16),
}


def bench_scenarios(out, *, steps=100, device="cuda", repeats=REPEATS):
    """Per-scenario steps/s of the device-resident loop."""
    dev = resolve_device(device)
    rows = []
    out["scenarios"] = {}
    for name in scenarios.available():
        prob, ev = scenarios.get(name).instantiate(device=dev,
                                                   **SMALL.get(name, {}))
        c = dict(steps=steps, lb_every=5, strategy="diff-comm",
                 kw=dict(k=4))
        _series(prob, ev, scan=True, **c)                     # warm-up
        r, t = median_run(
            lambda prob=prob, ev=ev: _series(prob, ev, scan=True, **c),
            repeats)
        mig = r.migrations[r.migrations > 0]
        rows.append([name, f"{steps / t:.0f}", f"{r.max_avg.mean():.3f}",
                     f"{mig.mean() if mig.size else 0:.3f}"])
        out["scenarios"][name] = dict(
            steps_per_sec=steps / t, mean_max_avg=float(r.max_avg.mean()))
    print(f"\ndevice-resident replay on {dev}, diff-comm k=4, {steps} "
          f"steps (median of {repeats})")
    print(table(["scenario", "steps/sec", "mean max/avg", "migr/LB"], rows))
    return out


def bench_pic(out, *, n_particles=20_000, steps=60, device="cuda",
              repeats=REPEATS):
    """The PIC driver's one (device-resident) step loop."""
    from repro_torch.pic import driver

    dev = resolve_device(device)
    cfg = driver.PICConfig(**dict(PIC_BASE, n_particles=n_particles,
                                  steps=steps, lb_every=10,
                                  strategy="diff-comm",
                                  strategy_kwargs=dict(k=4)),
                           device=str(dev))
    driver.run(cfg)                                           # warm-up
    res, t_s = median_run(lambda: driver.run(cfg), repeats)
    out["pic"] = dict(
        host_seconds=None, scanned_seconds=t_s, repeats=repeats,
        speedup=None, parity=None, steps_per_sec=steps / t_s,
        mean_max_avg=float(res.max_avg.mean()))
    print(f"\nPIC driver {n_particles} particles, {steps} steps on {dev}: "
          f"device-resident loop {t_s:.4f}s ({steps / t_s:.1f} steps/s; "
          "the port has no host PIC loop)")
    return out


def gates(out):
    """The JAX script's gates in its order: ``{name: (holds, message)}``."""
    res = {}
    if "series" in out:
        s = out["series"]
        res["series parity"] = (s["parity"],
                                "device-resident plan must equal the host "
                                "loop's plan")
        res[f"series speedup >= {SPEEDUP_GATE}"] = (
            s["speedup"] >= SPEEDUP_GATE,
            f"device-resident loop must be >={SPEEDUP_GATE:.0f}x the host "
            f"loop, got {s['speedup']:.2f}x")
    if "batch" in out:
        b = out["batch"]
        res["batch parity"] = (b["parity"], "batched lanes must match "
                               "per-scenario replays")
        res[f"batch speedup >= {BATCH_SPEEDUP_GATE}"] = (
            b["speedup"] >= BATCH_SPEEDUP_GATE,
            f"batched path must be >={BATCH_SPEEDUP_GATE:.0f}x the "
            f"per-scenario loop, got {b['speedup']:.2f}x")
    return res


def check(out):
    for holds, msg in gates(out).values():
        assert holds, msg


def run(device="cuda", *, repeats=REPEATS, out_path=None):
    dev = resolve_device(device)
    out = {}
    t0 = time.perf_counter()
    bench_series(out, device=dev, repeats=repeats)
    bench_batch(out, device=dev, repeats=repeats)
    bench_scenarios(out, device=dev, repeats=repeats)
    bench_pic(out, device=dev, repeats=repeats)
    out["seconds"] = time.perf_counter() - t0
    return finish("engine_bench", out, bench="engine", schema=SCHEMA,
                  device=dev, repeats=repeats, check=check,
                  out_path=out_path)


if __name__ == "__main__":
    bench_main(run, __doc__, REPEATS)
