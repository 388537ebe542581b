"""Serving launcher (counterpart of ``repro.launch.serve``): batched
requests against a model on the port, or the serving fleet replay.

    python -m repro_torch.launch.serve --arch smollm-135m --requests 8
    python -m repro_torch.launch.serve --device cpu     # plain versions
    python -m repro_torch.launch.serve --fleet-replay 131072 --replicas 64 \
        --ticks 30 [--telemetry full --trace-out trace.json]

It builds ``--replicas`` ServeEngines on the reduced config of ``--arch``
(any of the ten in ``configs.list_archs()``) with random weights (seed 0)
sharing one set of parameters, places the requests through the
``DiffusionScheduler`` (prefix group ``i % max(requests // 4,
1)``, one token/s each), rebalances once, drains every engine and reports
throughput and the scheduler's metrics through ``repro_torch.obs.metrics``.
The card is the default device.

``--fleet-replay N`` runs no model: it drives ``N`` synthetic bursty
multi-turn sessions over ``--replicas`` replicas through
``serve.replay.run_serve_replay`` (trigger, plan and executed KV-slab
exchange, LB every 10 ticks under ``--strategy``) and reports the
balance and KV-traffic summary the serving benchmark gates on, through
the metrics registry.  ``--telemetry counters|full`` records the
StepRecord ring, ``--trace-out f.json`` exports it as a Chrome/Perfetto
trace, and ``--profile-dir d`` wraps the run in ``torch.profiler`` and
writes its trace to ``d``.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np


def profiled(profile_dir):
    """``torch.profiler`` over the run (host and, on a card, device
    activity), its Chrome trace written to ``profile_dir``; a no-op
    context without a directory."""
    if not profile_dir:
        return contextlib.nullcontext()
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)

    def write(prof):
        prof.export_chrome_trace(os.path.join(profile_dir,
                                              "torch_trace.json"))

    return torch.profiler.profile(activities=acts, on_trace_ready=write)


def fleet_replay(args):
    from repro_torch.kernels import resolve_device
    from repro_torch.obs import metrics, trace_export
    from repro_torch.serve import replay as sr

    dev = resolve_device(args.device)
    w = sr.ServeWorkload(num_sessions=args.fleet_replay,
                         num_replicas=args.replicas)
    t0 = time.time()
    with profiled(args.profile_dir):
        r = sr.run_serve_replay(w, steps=args.ticks, lb_every=10,
                                strategy=args.strategy,
                                telemetry=args.telemetry, device=dev)
    metrics.gauge("serve/replay_seconds").set(time.time() - t0)
    metrics.counter("serve/sessions").inc(w.num_sessions)
    metrics.counter("serve/ticks").inc(args.ticks)
    metrics.counter("serve/rebalances").inc(int(r.lb_fired.sum()))
    metrics.counter("serve/moved_kv_bytes").inc(float(r.total_moved_kv))
    metrics.gauge("serve/p95_max_avg").set(
        float(np.percentile(r.max_avg, 95)))
    metrics.gauge("serve/prefix_local").set(float(r.prefix_local.mean()))
    s = metrics.snapshot()
    print(f"replayed {int(s['serve/sessions'])} sessions x "
          f"{int(s['serve/ticks'])} ticks on {w.num_replicas} replicas in "
          f"{s['serve/replay_seconds']:.2f}s on {dev} "
          f"({'device-resident' if r.scanned else 'host'} loop; "
          f"{w.num_sessions * args.ticks / r.wall_seconds:.4g} "
          "session-ticks/s)")
    print(f"  rebalances {int(s['serve/rebalances'])}, moved KV "
          f"{s['serve/moved_kv_bytes']:.0f} bytes, p95 max/avg "
          f"{s['serve/p95_max_avg']:.3f}, prefix-local "
          f"{s['serve/prefix_local']:.3f}")
    if r.telemetry is not None and args.trace_out:
        trace_export.export_chrome_trace(r.telemetry, path=args.trace_out,
                                         label="serve-replay")
        print(f"  wrote Chrome trace to {args.trace_out} "
              f"({len(r.telemetry.records)} steps recorded, "
              f"{r.telemetry.dropped} dropped)")
    return r


def main(argv=None):
    from repro_torch.configs import list_archs

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list_archs(),
                    help="served on its reduced config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--fleet-replay", type=int, default=0,
                    help="replay N synthetic sessions through "
                         "serve.replay instead of serving a model")
    ap.add_argument("--ticks", type=int, default=60)
    ap.add_argument("--strategy", default="diff-comm+predictive")
    ap.add_argument("--telemetry", default="off",
                    choices=("off", "counters", "full"),
                    help="StepRecord telemetry level (fleet replay)")
    ap.add_argument("--trace-out", default=None,
                    help="write the recorded run as a Chrome/Perfetto "
                         "trace JSON (needs --telemetry)")
    ap.add_argument("--profile-dir", default=None,
                    help="wrap the run in torch.profiler, its trace to DIR")
    args = ap.parse_args(argv)

    if args.fleet_replay > 0:
        return fleet_replay(args)

    from repro_torch.configs import get_arch
    from repro_torch.kernels import resolve_device
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params
    from repro_torch.obs import metrics
    from repro_torch.serve.engine import Request, ServeConfig, ServeEngine
    from repro_torch.serve.scheduler import DiffusionScheduler, Session

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch).reduced
    params = init_params(transformer.model_specs(cfg), 0, device=dev)

    sched = DiffusionScheduler(args.replicas, device=dev)
    engines = [ServeEngine(cfg, params, ServeConfig(num_slots=args.slots),
                           device=dev)
               for _ in range(args.replicas)]

    rng = np.random.default_rng(0)
    t0 = time.time()
    with profiled(args.profile_dir):
        for i in range(args.requests):
            prompt = rng.integers(1, cfg.vocab_size,
                                  size=rng.integers(4, 12))
            sess = Session(uid=i, replica=0, tokens_per_s=1.0,
                           prefix_group=i % max(args.requests // 4, 1))
            r = sched.place_new(sess)
            engines[r].submit(Request(uid=i, prompt=prompt,
                                      max_new_tokens=args.max_new))
        info = sched.rebalance()
        done = []
        for e in engines:
            done += e.run_until_drained()
    metrics.gauge("serve/seconds").set(time.time() - t0)
    metrics.counter("serve/requests").inc(len(done))
    metrics.counter("serve/tokens").inc(sum(len(r.out) for r in done))
    metrics.gauge("serve/max_avg_load").set(info.get("max_avg_load", 1))
    metrics.gauge("serve/ext_int_comm").set(info.get("ext_int_comm", 0))
    metrics.counter("serve/moved_kv_bytes").inc(
        float(info.get("moved_kv_bytes", 0)))
    s = metrics.snapshot()
    dt, toks = s["serve/seconds"], s["serve/tokens"]
    print(f"served {int(s['serve/requests'])} requests, {int(toks)} "
          f"tokens in {dt:.2f}s ({toks/dt:.1f} tok/s) on {dev}")
    print(f"scheduler: max/avg load {s['serve/max_avg_load']:.3f}, "
          f"ext/int {s['serve/ext_int_comm']:.3f}, moved KV "
          f"{s['serve/moved_kv_bytes']:.0f} bytes")
    for r in done[:4]:
        print(f"  req {r.uid}: {len(r.out)} tokens {r.out[:8]}...")
    return done


if __name__ == "__main__":
    main()
