#!/usr/bin/env python3
"""Serving policy benchmark on the port: diffusion + predictive against
greedy + a fixed cadence (counterpart of ``benchmarks/serve_bench.py``).

Replays bursty multi-turn session fleets through the serving fleet replay
(``repro_torch.serve.replay``: trigger, plan and **executed** KV-slab
exchange every tick) and prices what a serving operator pays: replica
load imbalance (p95 of the per-tick max/avg, the tail-latency pressure)
and the KV bytes migration moved.  The gate, the JAX script's: the
comm-aware diffusion planner with the predictive trigger must be no worse
than ``greedy`` on a fixed cadence on both at once, on a synthetic
workload (2048 sessions, 16 replicas) and on a recorded trace (1024
sessions, 8 replicas), 120 ticks each.

The scale entry replays 131072 sessions on 64 replicas (30 ticks, LB
every 10, ``diff-comm`` under the fixed cadence, so the fire count does
not depend on how a cost model prices the fleet) and reports wall seconds
and session-ticks/s: measured, not gated.

Results go to ``artifacts/bench_torch/serve_bench.json`` (or ``--out``).

Run from the repository root:
    python3 benchmarks_torch/serve_bench.py [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from benchmarks_torch.common import (  # noqa: E402
    median_run, save_result, table)
from repro_torch.kernels import resolve_device  # noqa: E402
from repro_torch.runtime.cost import RuntimeCostModel  # noqa: E402
from repro_torch.runtime.triggers import PredictiveTrigger  # noqa: E402
from repro_torch.serve import replay as sr  # noqa: E402

#: trigger cost model of the gated runs (the JAX script's): KV bytes
#: priced so a fleet-wide exchange costs the order of the imbalance time
#: the horizon projects, where the measured predictive gate has a real
#: decision to make
T_BYTE = 2e-3
REPEATS = 3
#: the gated workloads: (num_sessions, num_replicas, ServeWorkload kwargs,
#: recorded as a trace)
WORKLOADS = {"synthetic": (2048, 16, dict(seed=0), False),
             "trace": (1024, 8, dict(burst_period=18, seed=3), True)}
SCALE = dict(num_sessions=131_072, num_replicas=64, steps=30, seed=1)


def policies():
    cost = RuntimeCostModel(t_byte=T_BYTE, lb_overhead=1.0)
    return {
        "diff-comm+predictive": dict(strategy="diff-comm+predictive",
                                     trigger=PredictiveTrigger(cost=cost)),
        "greedy+every": dict(strategy="greedy", trigger="every"),
    }


def replay_one(workload, steps, policy, *, device, repeats=REPEATS):
    res, wall = median_run(lambda: sr.run_serve_replay(
        workload, steps=steps, lb_every=10, device=device, **policy),
        repeats)
    return dict(
        p95_imbalance=float(np.percentile(res.max_avg, 95)),
        mean_imbalance=float(res.max_avg.mean()),
        moved_kv_bytes=float(res.total_moved_kv),
        moved_sessions=float(res.moved_sessions.sum()),
        rebalances=float(res.lb_fired.sum()),
        fire_steps=[int(t) for t in np.flatnonzero(res.lb_fired)],
        prefix_locality=float(res.prefix_local.mean()),
        device_resident=bool(res.scanned),
        wall_seconds=wall,
    )


def bench_policies(out, *, steps=120, device="cuda", workloads=WORKLOADS,
                   repeats=REPEATS):
    """The gated comparison on every workload; asserts both gates."""
    dev = resolve_device(device)
    out["workloads"] = {}
    for wname, (S, R, extra, as_trace) in workloads.items():
        w = sr.ServeWorkload(num_sessions=S, num_replicas=R, **extra)
        if as_trace:
            w = sr.record_trace(w, steps=steps, device=dev)
        entry = dict(num_sessions=S, num_replicas=R, steps=steps,
                     policies={})
        rows = []
        for pname, policy in policies().items():
            r = replay_one(w, steps, policy, device=dev, repeats=repeats)
            entry["policies"][pname] = r
            rows.append([pname, int(r["rebalances"]),
                         f"{r['p95_imbalance']:.3f}",
                         f"{r['moved_kv_bytes']:.0f}",
                         f"{r['prefix_locality']:.3f}",
                         f"{r['wall_seconds']:.3f}"])
        diff = entry["policies"]["diff-comm+predictive"]
        base = entry["policies"]["greedy+every"]
        entry["gates"] = dict(
            p95_imbalance_no_worse=diff["p95_imbalance"]
            <= base["p95_imbalance"],
            moved_kv_no_more=diff["moved_kv_bytes"]
            <= base["moved_kv_bytes"])
        out["workloads"][wname] = entry
        print(f"\n{wname}: S={S} R={R} T={steps} on {dev} (median of "
              f"{repeats})")
        print(table(["policy", "fires", "p95 max/avg", "moved KV",
                     "prefix-local", "wall s"], rows))
        assert entry["gates"]["p95_imbalance_no_worse"], (
            f"{wname}: diffusion+predictive p95 imbalance "
            f"{diff['p95_imbalance']:.3f} worse than greedy "
            f"{base['p95_imbalance']:.3f}")
        assert entry["gates"]["moved_kv_no_more"], (
            f"{wname}: diffusion+predictive moved "
            f"{diff['moved_kv_bytes']:.0f} KV bytes > greedy "
            f"{base['moved_kv_bytes']:.0f}")
    return out


def bench_scale(out, *, num_sessions=SCALE["num_sessions"],
                num_replicas=SCALE["num_replicas"], steps=SCALE["steps"],
                seed=SCALE["seed"], device="cuda", repeats=REPEATS):
    """The fleet at scale: wall seconds and session-ticks/s, not gated."""
    dev = resolve_device(device)
    w = sr.ServeWorkload(num_sessions=num_sessions,
                         num_replicas=num_replicas, seed=seed)
    res, wall = median_run(lambda: sr.run_serve_replay(
        w, steps=steps, lb_every=10, strategy="diff-comm", trigger="every",
        device=dev), repeats)
    assert np.isfinite(res.max_avg).all()
    assert int(res.lb_fired.sum()) > 0 and res.total_moved_kv > 0
    out["scale"] = dict(
        num_sessions=num_sessions, num_replicas=num_replicas, steps=steps,
        rebalances=float(res.lb_fired.sum()),
        moved_kv_bytes=float(res.total_moved_kv),
        p95_imbalance=float(np.percentile(res.max_avg, 95)),
        wall_seconds=wall, loop_seconds=res.wall_seconds,
        ticks_per_second=steps / max(wall, 1e-9),
        session_ticks_per_second=num_sessions * steps / max(wall, 1e-9))
    print(f"\nscale: S={num_sessions} R={num_replicas} T={steps} on {dev} "
          f"(median of {repeats})")
    print(table(
        ["fires", "moved KV", "p95 max/avg", "wall s", "session-ticks/s"],
        [[int(res.lb_fired.sum()), f"{res.total_moved_kv:.0f}",
          f"{out['scale']['p95_imbalance']:.3f}", f"{wall:.3f}",
          f"{out['scale']['session_ticks_per_second']:.4g}"]]))
    return out


def run(device="cuda", *, out_path=None):
    import torch

    dev = resolve_device(device)
    out = {"device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "torch": torch.__version__, "t_byte": T_BYTE}
    bench_policies(out, device=dev)
    bench_scale(out, device=dev)
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(out, indent=1))
        print(f"\nsaved {out_path}")
    else:
        print(f"\nsaved {save_result('serve_bench', out)}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="JSON path (default artifacts/bench_torch/"
                         "serve_bench.json)")
    a = ap.parse_args()
    run(a.device, out_path=a.out)
