"""Serving launcher: batched requests against a model on the port
(counterpart of the model-serving branch of ``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch smollm-135m --requests 8
    python -m repro_torch.launch.serve --device cpu     # plain versions

It builds ``--replicas`` ServeEngines on the arch's reduced config with
random weights (seed 0) sharing one set of parameters, places the requests
through the ``DiffusionScheduler`` (prefix group ``i % max(requests // 4,
1)``, one token/s each), rebalances once, drains every engine and reports
throughput and the scheduler's metrics through ``repro_torch.obs.metrics``.
The card is the default device.  ``--fleet-replay`` (the scan-compiled
serving replay) belongs to a later slice.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

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
    for i in range(args.requests):
        prompt = rng.integers(1, cfg.vocab_size, size=rng.integers(4, 12))
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
