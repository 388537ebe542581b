#!/usr/bin/env python3
"""Where the time of the port's simulator path goes, on one NVIDIA card.

Replays the configuration that ``chip_smoke.py`` drives (``stencil-wave``
at grid 1024 × 1024, 8192 nodes tiled 64 × 128, diff-comm k = 8, 30
steps, LB every 10): once to warm up (graph capture, allocator), once
plain for the replay's wall time, each fired plan's seconds and peak
device memory, and once under ``torch.profiler``.  It prints:

  * the card's name and power limit (nvidia-smi);
  * the replay's wall time and plan seconds, with and without the
    profiler;
  * over the profiled replay: the device's busy time (the union of every
    kernel, memcpy and memset interval) and its idle share;
  * device time by kernel name (top 25), with counts.

Run from the repository root:  python3 benchmarks_torch/sim_profile.py
It needs a card and fails without one.  The full table is also written as
JSON to ``--out`` (default ``artifacts/sim_profile.json``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SCENARIO = dict(grid=1024, num_nodes=8192, mapping="tiled")
REPLAY = dict(steps=30, lb_every=10, strategy="diff-comm",
              strategy_kwargs={"k": 8})

# profiler bookkeeping that kineto reports on the device timeline
_NOT_WORK = ("Activity Buffer Request", "Buffer Flush")


def _union_us(intervals) -> float:
    """Length of the union of ``intervals``."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        s = max(s, end)
        if e > s:
            busy += e - s
            end = e
    return busy


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "artifacts" / "sim_profile.json")
    args = ap.parse_args()
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("sim_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch import kernels
    from repro_torch.sim import scenarios, simulator

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    kernels.build_all()
    problem, evolve = scenarios.get("stencil-wave").instantiate(
        device="cuda", **SCENARIO)
    simulator.run_series(problem, evolve, **REPLAY)
    torch.cuda.reset_peak_memory_stats()
    plain = simulator.run_series(problem, evolve, **REPLAY)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = simulator.run_series(problem, evolve, **REPLAY)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and e.name not in _NOT_WORK]
    if not dev_events:
        raise SystemExit("sim_profile: the profiler recorded no device time")
    busy_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in dev_events])
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev_events:
        by_name[e.name[:90]][0] += (e.time_range.end
                                    - e.time_range.start) / 1e3
        by_name[e.name[:90]][1] += 1
    rows = sorted((dict(name=n, device_ms=v[0], count=v[1])
                   for n, v in by_name.items()),
                  key=lambda r: -r["device_ms"])
    fired = np.nonzero(plain.lb_fired)[0].tolist()
    out = dict(device=torch.cuda.get_device_name(0),
               replay_ms=plain.wall_seconds * 1e3,
               plan_seconds=[float(plain.plan_step_seconds[t])
                             for t in fired],
               peak_device_gib=peak_gib, profiled_replay_ms=wall_ms,
               profiled_plan_seconds=[float(res.plan_step_seconds[t])
                                      for t in fired],
               device_busy_ms=busy_us / 1e3,
               idle_share=1.0 - busy_us / 1e3 / wall_ms, kernels=rows)
    print(f"replay {out['replay_ms']:.1f} ms ({REPLAY['steps']} steps, "
          f"plans {out['plan_seconds']} s), peak device memory "
          f"{peak_gib:.2f} GiB; under the profiler {wall_ms:.1f} ms, "
          f"device busy {out['device_busy_ms']:.1f} ms, idle share "
          f"{out['idle_share']:.3f}")
    for r in rows[:25]:
        print(f"  {r['device_ms']:9.3f} ms  {r['count']:6d}x  {r['name']}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items() if k != "kernels"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
