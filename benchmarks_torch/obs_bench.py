#!/usr/bin/env python3
"""Telemetry overhead gate on the port: the StepRecord ring must be near
free (counterpart of ``benchmarks/obs_bench.py``).

The loops' telemetry (``repro_torch.obs.telemetry``) rides inside the
device-resident replays; ``level="off"`` adds nothing to them (the loops
resolve it to None; ``tests/test_torch_obs.py`` holds the dispatched
operations equal).  This bench measures the cost of ``counters`` and
``full`` as the warm-run slowdown against ``off`` on two paths:

  * ``sim-scan``: ``run_series`` on ``stencil-wave`` (P 64, K 8, grid 32,
    200 steps, LB every 10, diff-comm, the device-resident loop);
  * ``serve-scan``: ``run_serve_replay`` (512 sessions, 8 replicas, 400
    ticks, LB every 10, diff-comm+predictive).

The JAX script's gates, unchanged (per path, best of ``REPEATS`` = 9
warm runs, levels interleaved round robin so that drift hits all three):

  * ``counters`` <= 5 % slowdown against ``off``;
  * ``full``     <= 15 % slowdown against ``off``.

Best of N is the statistic, as in the JAX script: the overhead of a fixed
program is a lower-bound property.  On a card every level's loop is
host-bound (a few hundred launches a step), so the ring's host work is
what these ratios measure.

Results go to ``artifacts/bench_torch/obs_bench.json`` and the stable
schema's ``artifacts/bench_torch/BENCH_obs.json`` (with the device, the
card's name and power limit, torch/CUDA versions, git commit); the
repository root's ``BENCH_obs.json`` is the JAX package's.  The script
writes both, then fails (exit 1) on the first gate that does not hold.

Run from the repository root:
    python3 benchmarks_torch/obs_bench.py [--device cuda|cpu] [--repeats N]
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from benchmarks_torch.common import (  # noqa: E402
    bench_main, finish, table)
from repro_torch.kernels import resolve_device  # noqa: E402

SCHEMA = "obs-bench/v1"
REPEATS = 9

#: level -> max tolerated warm-run slowdown against level="off"
GATES = {"counters": 0.05, "full": 0.15}
LEVELS = ("off", "counters", "full")


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_levels(run, dev, repeats):
    """Best-of-``repeats`` warm seconds per level, interleaved round
    robin."""
    for level in LEVELS:
        run(level)                                   # warm every level
    best = {level: float("inf") for level in LEVELS}
    for _ in range(repeats):
        for level in LEVELS:
            _sync(dev)
            t0 = time.perf_counter()
            run(level)
            _sync(dev)
            best[level] = min(best[level], time.perf_counter() - t0)
    return best


def bench_sim(out, *, P=64, K=8, grid=32, steps=200, lb_every=10,
              device="cuda", repeats=REPEATS):
    from repro_torch.sim import scenarios, simulator

    dev = resolve_device(device)
    problem, evolve = scenarios.get("stencil-wave").instantiate(
        grid=grid, num_nodes=P, device=dev)
    kw = dict(steps=steps, lb_every=lb_every, strategy="diff-comm",
              strategy_kwargs=dict(k=K), scan=True)

    def run(level):
        return simulator.run_series(problem, evolve, telemetry=level, **kw)

    _report("sim-scan", out, _time_levels(run, dev, repeats),
            dict(P=P, K=K, grid=grid, steps=steps, lb_every=lb_every),
            repeats)
    return out


def bench_serve(out, *, sessions=512, replicas=8, ticks=400, lb_every=10,
                device="cuda", repeats=REPEATS):
    from repro_torch.serve import replay as sr

    dev = resolve_device(device)
    w = sr.ServeWorkload(num_sessions=sessions, num_replicas=replicas)
    kw = dict(steps=ticks, lb_every=lb_every,
              strategy="diff-comm+predictive", device=dev)

    def run(level):
        return sr.run_serve_replay(w, telemetry=level, **kw)

    _report("serve-scan", out, _time_levels(run, dev, repeats),
            dict(sessions=sessions, replicas=replicas, ticks=ticks,
                 lb_every=lb_every), repeats)
    return out


def _report(name, out, times, config, repeats):
    t_off = max(times["off"], 1e-12)
    overhead = {lvl: times[lvl] / t_off - 1.0 for lvl in GATES}
    out[name] = dict(
        config=config, repeats=repeats,
        seconds={lvl: times[lvl] for lvl in LEVELS},
        overhead=overhead,
        gates=dict(GATES),
    )
    print(f"\n{name} telemetry overhead "
          f"(best of {repeats} interleaved warm runs)")
    print(table(
        ["level", "seconds", "overhead", "gate"],
        [["off", f"{times['off']:.4f}", "-", "-"]]
        + [[lvl, f"{times[lvl]:.4f}", f"{overhead[lvl]*100:+.1f}%",
            f"<={GATES[lvl]*100:.0f}%"] for lvl in GATES]))


def gates(out):
    """Each gate of the JAX script: ``{name: (holds, message)}``."""
    res = {}
    for name, r in out.items():
        if not (isinstance(r, dict) and "overhead" in r):
            continue
        for lvl, bound in GATES.items():
            got = r["overhead"][lvl]
            res[f"{name}: {lvl} <= {bound*100:.0f}%"] = (
                got <= bound,
                f"{name}: telemetry level={lvl!r} costs {got*100:.1f}% "
                f"(gate {bound*100:.0f}%) — the ring write must stay "
                "near-free")
    return res


def check(out):
    for holds, msg in gates(out).values():
        assert holds, msg


def run(device="cuda", *, repeats=REPEATS, out_path=None):
    dev = resolve_device(device)
    out = {}
    bench_sim(out, device=dev, repeats=repeats)
    bench_serve(out, device=dev, repeats=repeats)
    return finish("obs_bench", out, bench="obs", schema=SCHEMA, device=dev,
                  repeats=repeats, check=check, out_path=out_path)


if __name__ == "__main__":
    bench_main(run, __doc__, REPEATS)
