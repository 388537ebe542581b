#!/usr/bin/env python3
"""Where the time of the port's serving path goes, on one NVIDIA card.

Serves the configuration that ``chip_smoke.py`` drives (gemma3-1b at full
width with random weights from seed 0; a ``DiffusionScheduler`` places 8
requests of 512 to 1000 prompt tokens on 2 replicas and rebalances; two
``ServeEngine``s with 4 slots, max_len 1056 and a bf16 cache drain them
with 32 new tokens each): once to warm up, once plain for the wall time
and peak device memory, and once under ``torch.profiler`` with the host
synchronized at the end of every phase: the placement and rebalance,
each prefill, each decode tick.  It prints:

  * the card's name and power limit (nvidia-smi);
  * wall time by phase (rebalance, prefill, decode) and tokens/s;
  * over the profiled run: the device's busy time (the union of every
    kernel, memcpy and memset interval), its idle share, and busy time by
    phase (a device interval counts for the phase whose host range holds
    its start);
  * device time by kernel name (top 25), with counts, overall and by
    phase (top 8).

Run from the repository root:  python3 benchmarks_torch/serve_profile.py
It needs a card and fails without one.  The full table is also written as
JSON to ``--out`` (default ``artifacts/serve_profile.json``).
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

ARCH = "gemma3-1b"
SERVE = dict(replicas=2, slots=4, max_len=1056, dtype="bfloat16",
             max_new=32,
             prompt_lens=(1000, 996, 512, 576, 640, 704, 768, 832))
PHASES = ("serve/rebalance", "serve/prefill", "serve/decode")

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


def serve(cfg, params, wall):
    """One run of the serving path; ``wall[phase]`` collects synchronized
    host seconds, each phase under ``record_function(phase)``."""
    import numpy as np
    import torch
    from torch.profiler import record_function

    from repro_torch.serve.engine import Request, ServeConfig, ServeEngine
    from repro_torch.serve.scheduler import DiffusionScheduler, Session

    def phase(name, fn, *a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        with record_function(name):
            out = fn(*a)
            torch.cuda.synchronize()
        wall[name] += time.perf_counter() - t
        return out

    engines = [ServeEngine(cfg, params, ServeConfig(
        num_slots=SERVE["slots"], max_len=SERVE["max_len"],
        dtype=SERVE["dtype"])) for _ in range(SERVE["replicas"])]
    for e in engines:
        # a tick is admission (prefills) then one decode step
        prefill, decode = e._prefill_slot, e.tick
        e._prefill_slot = (lambda p, s, f=prefill:
                           phase("serve/prefill", f, p, s))
        e.tick = lambda f=decode: phase("serve/decode", f)
    sched = DiffusionScheduler(SERVE["replicas"])
    rng = np.random.default_rng(0)

    def place_and_rebalance():
        for i, plen in enumerate(SERVE["prompt_lens"]):
            prompt = rng.integers(1, cfg.vocab_size, size=plen)
            r = sched.place_new(Session(uid=i, replica=0, tokens_per_s=1.0,
                                        prefix_group=i % 2))
            engines[r].submit(Request(uid=i, prompt=prompt,
                                      max_new_tokens=SERVE["max_new"]))
        return sched.rebalance()

    phase("serve/rebalance", place_and_rebalance)
    done = []
    for e in engines:
        done += e.run_until_drained()
    # a decode range holds the tick's prefills: take them out
    wall["serve/decode"] -= wall["serve/prefill"]
    return done, sum(e.ticks for e in engines)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "artifacts" / "serve_profile.json")
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("serve_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    kernels.build_all()
    cfg = get_arch(ARCH).config
    params = init_params(transformer.model_specs(cfg), 0)
    serve(cfg, params, defaultdict(float))                 # warm-up
    torch.cuda.reset_peak_memory_stats()
    wall = defaultdict(float)
    t0 = time.perf_counter()
    done, ticks = serve(cfg, params, wall)
    total = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    tokens = sum(len(r.out) for r in done)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(cfg, params, defaultdict(float))
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3

    events = prof.events()
    # the device timeline also carries the phases' own annotations
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and e.name not in _NOT_WORK and e.name not in PHASES]
    if not dev:
        raise SystemExit("serve_profile: the profiler recorded no device "
                         "time")
    ranges = {p: [(e.time_range.start, e.time_range.end) for e in events
                  if e.name == p and e.device_type == DeviceType.CPU]
              for p in PHASES}

    def phase_of(start):
        # the innermost phase whose host range holds the start (a prefill
        # range lies inside its tick's decode range)
        for p in ("serve/prefill", "serve/rebalance", "serve/decode"):
            if any(s <= start <= e for s, e in ranges[p]):
                return p
        return "other"

    busy_us = _union_us([(e.time_range.start, e.time_range.end)
                         for e in dev])
    by_phase = defaultdict(list)
    names = defaultdict(lambda: defaultdict(lambda: [0.0, 0]))
    for e in dev:
        p = phase_of(e.time_range.start)
        by_phase[p].append((e.time_range.start, e.time_range.end))
        for key in (p, "all"):
            names[key][e.name[:90]][0] += (e.time_range.end
                                           - e.time_range.start) / 1e3
            names[key][e.name[:90]][1] += 1

    def top(key, n):
        return sorted((dict(name=k, device_ms=v[0], count=v[1])
                       for k, v in names[key].items()),
                      key=lambda r: -r["device_ms"])[:n]

    n_req = len(SERVE["prompt_lens"])
    out = dict(
        device=torch.cuda.get_device_name(0), requests=n_req,
        tokens=tokens, ticks=ticks, wall_ms=total * 1e3,
        tokens_per_s=tokens / total,
        phase_wall_ms={p: wall[p] * 1e3 for p in PHASES},
        prefill_ms_per_request=wall["serve/prefill"] * 1e3 / n_req,
        decode_ms_per_tick=wall["serve/decode"] * 1e3 / ticks,
        peak_device_gib=peak_gib, profiled_ms=prof_ms,
        device_busy_ms=busy_us / 1e3, idle_share=1 - busy_us / 1e3 / prof_ms,
        phase_device_busy_ms={p: _union_us(v) / 1e3
                              for p, v in by_phase.items()},
        kernels=top("all", 25),
        phase_kernels={p: top(p, 8) for p in list(PHASES) + ["other"]
                       if p in names})
    print(f"served {n_req} requests, {tokens} tokens, {ticks} ticks in "
          f"{out['wall_ms']:.1f} ms ({out['tokens_per_s']:.2f} tokens/s); "
          f"by phase {out['phase_wall_ms']} ms; prefill "
          f"{out['prefill_ms_per_request']:.3f} ms a request, decode "
          f"{out['decode_ms_per_tick']:.3f} ms a tick; peak device memory "
          f"{peak_gib:.3f} GiB")
    print(f"under the profiler {prof_ms:.1f} ms, device busy "
          f"{out['device_busy_ms']:.1f} ms, idle share "
          f"{out['idle_share']:.3f}; device busy by phase "
          f"{out['phase_device_busy_ms']}")
    for r in out["kernels"]:
        print(f"  {r['device_ms']:9.3f} ms  {r['count']:6d}x  {r['name']}")
    for p, rows in out["phase_kernels"].items():
        print(f" {p}:")
        for r in rows:
            print(f"  {r['device_ms']:9.3f} ms  {r['count']:6d}x  "
                  f"{r['name']}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("kernels", "phase_kernels")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
