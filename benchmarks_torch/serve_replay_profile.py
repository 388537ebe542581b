#!/usr/bin/env python3
"""Where the time of the serving fleet replay goes, on one NVIDIA card.

Runs the fleet that ``chip_smoke.py`` drives (``ServeWorkload`` of 131072
sessions on 64 replicas, seed 1, 30 ticks, LB every 10, ``diff-comm``
under the fixed cadence): once short to warm up, once plain for the tick
loop's wall time, session-ticks/s and peak device memory, and once under
``torch.profiler``.  It prints:
  * the card's name and power limit (nvidia-smi);
  * the tick loop's wall time, with and without the profiler;
  * over the profiled tick loop: the device's busy time (the union of
    every kernel, memcpy and memset interval) and its idle share;
  * device time by kernel name inside that window (top 25), with counts.

Run from the repository root:
    python3 benchmarks_torch/serve_replay_profile.py [--out PATH]
(default ``artifacts/serve_replay_profile.json``).
It needs a card and fails without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

FLEET = dict(num_sessions=131_072, num_replicas=64, seed=1)
RUN = dict(steps=30, lb_every=10, strategy="diff-comm", trigger="every")

# profiler bookkeeping that kineto reports on the device timeline
_NOT_WORK = ("Activity Buffer Request", "Buffer Flush")


def _union_us(intervals, lo, hi) -> float:
    """Length of the union of ``intervals`` clipped to ``[lo, hi]``."""
    busy, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            busy += e - s
            end = e
    return busy


def profile_replay(run_fn, start=None):
    """Run ``run_fn()`` (a replay returning a result with
    ``wall_seconds``) under ``torch.profiler``: ``(result, dict(loop_ms,
    device_busy_ms, idle_share, kernels))``, the window the replay's
    synchronized tick loop from its first device event — or, given
    ``start``, from the first device event whose name contains it (a loop
    with device work before it: the loop's first kernel)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run_fn()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and e.name not in _NOT_WORK]
    if not dev_events:
        raise SystemExit("the profiler recorded no device time")
    first = [e for e in dev_events if start is None or start in e.name]
    if not first:
        raise SystemExit(f"the profiler recorded no {start!r} event")
    lo = min(e.time_range.start for e in first)
    hi = lo + res.wall_seconds * 1e6
    window = [e for e in dev_events if lo <= e.time_range.start < hi]
    busy_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in window], lo, hi)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in window:
        by_name[e.name[:90]][0] += (e.time_range.end
                                    - e.time_range.start) / 1e3
        by_name[e.name[:90]][1] += 1
    rows = sorted((dict(name=n, device_ms=v[0], count=v[1])
                   for n, v in by_name.items()),
                  key=lambda r: -r["device_ms"])
    loop_ms = res.wall_seconds * 1e3
    return res, dict(loop_ms=loop_ms, device_busy_ms=busy_us / 1e3,
                     idle_share=1.0 - busy_us / 1e3 / loop_ms,
                     kernels=rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "artifacts" / "serve_replay_profile.json")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("serve_replay_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch import kernels
    from repro_torch.serve import replay as sr

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi)
    kernels.build_all()
    w = sr.ServeWorkload(**FLEET)
    S, T = FLEET["num_sessions"], RUN["steps"]
    sr.run_serve_replay(w, **dict(RUN, steps=11), device="cuda")  # warm-up
    torch.cuda.reset_peak_memory_stats()
    plain = sr.run_serve_replay(w, **RUN, device="cuda")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    _, prof = profile_replay(
        lambda: sr.run_serve_replay(w, **RUN, device="cuda"))
    out = dict(card=smi, device=torch.cuda.get_device_name(0), **FLEET,
               **RUN, tick_loop_ms=plain.wall_seconds * 1e3,
               session_ticks_per_s=S * T / plain.wall_seconds,
               fired=int(plain.lb_fired.sum()),
               moved_kv=float(plain.total_moved_kv),
               p95_max_avg=float(np.percentile(plain.max_avg, 95)),
               peak_device_gib=peak_gib,
               profiled_tick_loop_ms=prof["loop_ms"],
               device_busy_ms=prof["device_busy_ms"],
               idle_share=prof["idle_share"], kernels=prof["kernels"])
    print(f"tick loop {out['tick_loop_ms']:.1f} ms ({T} ticks, "
          f"{out['fired']} rebalances, {out['session_ticks_per_s']:.4g} "
          f"session-ticks/s), peak device memory {peak_gib:.3f} GiB; under "
          f"the profiler {prof['loop_ms']:.1f} ms, device busy "
          f"{prof['device_busy_ms']:.1f} ms, idle share "
          f"{prof['idle_share']:.3f}")
    for r in prof["kernels"][:25]:
        print(f"  {r['device_ms']:9.3f} ms  {r['count']:6d}x  {r['name']}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items() if k != "kernels"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
