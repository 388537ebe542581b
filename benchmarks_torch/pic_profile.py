#!/usr/bin/env python3
"""Where the time of the port's PIC main path goes, on one NVIDIA card.

Runs the configuration that ``chip_smoke.py`` drives (L = 1000, 12×12
chares, 2^24 GEOMETRIC particles, 8 PEs, diff-comm k = 4, LB every 10
steps, 100 steps): once short to warm up, once plain for the step loop's
wall time and peak device memory, and once under ``torch.profiler``.  It
prints:

  * the card's name and power limit (nvidia-smi);
  * the step loop's wall time, with and without the profiler;
  * over the profiled step loop (from the first push kernel's start, for
    the loop's wall time): the device's busy time (the union of every
    kernel, memcpy and memset interval) and its idle share;
  * device time by kernel name inside that window (top 25), with counts.

Run from the repository root:  python3 benchmarks_torch/pic_profile.py
[--strategy greedy-refine] (the strategy of the run; diff-comm by
default).  It needs a card and fails without one.  The full table is also written as
JSON to ``--out`` (default ``artifacts/pic_profile.json``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CFG = dict(L=1000, n_particles=1 << 24, steps=100, cx=12, cy=12, num_pes=8,
           rho=0.9, mode="GEOMETRIC", lb_every=10, strategy="diff-comm",
           strategy_kwargs={"k": 4})

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "artifacts" / "pic_profile.json")
    ap.add_argument("--strategy", default=CFG["strategy"])
    args = ap.parse_args()
    cfg = dict(CFG, strategy=args.strategy,
               strategy_kwargs=(CFG["strategy_kwargs"]
                                if args.strategy.startswith("diff") else {}))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("pic_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch import kernels
    from repro_torch.pic import driver

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    kernels.build_all()
    driver.run(driver.PICConfig(**{**cfg, "steps": 20}, device="cuda"))
    torch.cuda.reset_peak_memory_stats()
    plain = driver.run(driver.PICConfig(**cfg, device="cuda"))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = driver.run(driver.PICConfig(**cfg, device="cuda"))
        torch.cuda.synchronize()

    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and e.name not in _NOT_WORK]
    if not dev_events:
        raise SystemExit("pic_profile: the profiler recorded no device time")
    pushes = [e.time_range.start for e in dev_events
              if "pic_push_kernel" in e.name]
    lo = min(pushes)                       # the step loop's first kernel
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
    out = dict(device=torch.cuda.get_device_name(0), strategy=args.strategy,
               step_loop_ms=plain.wall_seconds * 1e3,
               steps_per_s=CFG["steps"] / plain.wall_seconds,
               peak_device_gib=peak_gib,
               profiled_step_loop_ms=loop_ms,
               device_busy_ms=busy_us / 1e3,
               idle_share=1.0 - busy_us / 1e3 / loop_ms,
               fired=int(res.lb_steps.sum()), kernels=rows)
    print(f"step loop {out['step_loop_ms']:.1f} ms ({CFG['steps']} steps, "
          f"{out['fired']} rebalances, {out['steps_per_s']:.2f} steps/s), "
          f"peak device memory {peak_gib:.2f} GiB; under the profiler "
          f"{loop_ms:.1f} ms, device busy {out['device_busy_ms']:.1f} ms, "
          f"idle share {out['idle_share']:.3f}")
    for r in rows[:25]:
        print(f"  {r['device_ms']:9.3f} ms  {r['count']:6d}x  {r['name']}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items() if k != "kernels"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
