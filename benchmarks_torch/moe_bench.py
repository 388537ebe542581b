#!/usr/bin/env python3
"""Live MoE expert rebalancing on the port: diffusion + predictive against
greedy + a fixed cadence (counterpart of ``benchmarks/moe_bench.py``).

Replays skewed top-k routing traffic through the expert-placement runtime
(``repro_torch.train.ep_runtime``: routing statistics on the device, the
trigger's decision, the **executed** expert-weight exchange) and prices
what an MoE training operator pays: step time lost to expert-load
imbalance (the slowest EP rank gates the step) and the expert-weight
bytes rebalancing moves.  Tokens/s come from ``RuntimeCostModel.
step_seconds`` over each replay's records, the model the predictive
trigger amortizes against.  The JAX script's three gates:

  * diffusion + predictive beats greedy + every on tokens/s **and** moves
    no more weight bytes, on a synthetic workload (128 experts on 8 ranks,
    4096 tokens a step) and a recorded trace (128 on 8, 2048 tokens), 96
    steps each;
  * the device-resident and host loops agree bit for bit (fires,
    placements, moved bytes) before anything is priced;
  * the scale entry (256 experts on 32 ranks, 4096 tokens a step, 48
    steps, LB every 8 under the fixed cadence) fires and moves bytes; its
    wall time and steps/s are measured, not gated.

Results go to ``artifacts/bench_torch/moe_bench.json`` (or ``--out``) with
the device (the card's name and power limit), torch/CUDA versions and git
commit; the JAX package's ``BENCH_moe.json`` is not touched.

Run from the repository root:
    python3 benchmarks_torch/moe_bench.py [--device cuda|cpu]
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
    environment, median_run, save_result, table)
from repro_torch.kernels import resolve_device  # noqa: E402
from repro_torch.runtime.cost import RuntimeCostModel  # noqa: E402
from repro_torch.runtime.triggers import PredictiveTrigger  # noqa: E402
from repro_torch.train import ep_runtime as epr  # noqa: E402

REPEATS = 3
#: per-token-load second: the slowest rank's EMA token count in step
#: seconds
T_LOAD = 1e-3
#: seconds per expert-weight byte: a greedy full-shuffle fire costs the
#: order of the imbalance time a drift epoch accumulates, where the
#: measured predictive gate has a real decision to make
T_BYTE = 4e-5
#: fixed per-fire cost (planning + barrier), seconds
LB_OVERHEAD = 0.05
SCALE = dict(num_experts=256, num_ranks=32, steps=48)


def _cost():
    return RuntimeCostModel(t_load=T_LOAD, t_byte=T_BYTE,
                            lb_overhead=LB_OVERHEAD)


def policies():
    return {
        "diff-comm+predictive": dict(
            strategy="diff-comm", trigger=PredictiveTrigger(cost=_cost())),
        "greedy+every": dict(strategy="greedy", trigger="every"),
    }


def workloads(steps: int, device):
    """The gated workloads: synthetic, and a recorded trace on
    ``device``."""
    synth = epr.RoutingWorkload(num_experts=128, num_ranks=8,
                                tokens_per_step=4096, alpha=0.5,
                                hot_amp=2.0, drift_period=16,
                                trace_len=64, seed=0)
    trace = epr.record_routing(
        epr.RoutingWorkload(num_experts=128, num_ranks=8,
                            tokens_per_step=2048, alpha=0.5, hot_amp=2.5,
                            drift_period=12, trace_len=48, seed=3),
        steps=steps, device=device)
    return {"synthetic": synth, "trace": trace}


def tokens_per_sec(workload, res):
    """Modeled training throughput of one replay: routed tokens over the
    summed step seconds (slowest rank + executed weight traffic)."""
    cost = _cost()
    ideal = workload.tokens_per_step * workload.top_k / workload.num_ranks
    max_load = res.max_avg * ideal
    secs = cost.step_seconds(
        max_load.astype(np.float32),
        (res.moved_bytes / cost.bytes_per_load).astype(np.float32),
        res.lb_fired.astype(np.float32)).cpu().numpy()
    total = float(secs.sum())
    steps = len(res.max_avg)
    return workload.tokens_per_step * steps / max(total, 1e-12), total


def replay_one(workload, steps, policy, *, device, repeats=REPEATS):
    res, wall = median_run(lambda: epr.run_ep_replay(
        workload, steps=steps, lb_every=10, device=device, **policy),
        repeats)
    toks, modeled = tokens_per_sec(workload, res)
    return dict(
        tokens_per_second=toks, modeled_seconds=modeled,
        mean_imbalance=float(res.max_avg.mean()),
        final_imbalance=float(res.max_avg[-8:].mean()),
        moved_weight_bytes=res.total_moved_bytes,
        moved_experts=float(res.moved_experts.sum()),
        rebalances=float(res.lb_fired.sum()),
        fire_steps=[int(t) for t in np.flatnonzero(res.lb_fired)],
        device_resident=bool(res.scanned), wall_seconds=wall,
        loop_seconds=res.wall_seconds)


FIELDS = ("lb_fired", "max_avg", "moved_experts", "moved_bytes",
          "final_placement", "final_slot_expert", "final_wsig")


def scan_host_parity(workload, steps, *, device):
    """The runtime's contract, checked before anything is priced: the
    device-resident and host loops are the same computation bit for bit.
    Returns the fire count."""
    kw = dict(steps=steps, strategy="diff-comm", lb_every=10,
              device=device)
    a = epr.run_ep_replay(workload, **kw)
    b = epr.run_ep_replay(workload, scan=False, **kw)
    assert a.scanned and not b.scanned
    for field in FIELDS:
        assert np.array_equal(getattr(a, field), getattr(b, field)), \
            f"device-resident <-> host divergence in {field}"
    return float(a.lb_fired.sum())


def bench_policies(out, *, steps=96, device="cuda", repeats=REPEATS):
    """The gated comparison on both workloads; asserts every gate."""
    dev = resolve_device(device)
    out["parity_fires"] = scan_host_parity(
        epr.RoutingWorkload(num_experts=32, num_ranks=8,
                            tokens_per_step=512, trace_len=24, seed=7),
        24, device=dev)
    print(f"device-resident <-> host parity OK ({out['parity_fires']:.0f} "
          "fires replayed bit for bit)")
    out["workloads"] = {}
    for wname, w in workloads(steps, dev).items():
        entry = dict(num_experts=int(w.num_experts),
                     num_ranks=int(w.num_ranks), steps=steps, policies={})
        rows = []
        for pname, policy in policies().items():
            r = replay_one(w, steps, policy, device=dev, repeats=repeats)
            entry["policies"][pname] = r
            rows.append([pname, int(r["rebalances"]),
                         f"{r['tokens_per_second']:.0f}",
                         f"{r['mean_imbalance']:.3f}",
                         f"{r['moved_weight_bytes']:.0f}",
                         f"{r['wall_seconds']:.3f}"])
        diff = entry["policies"]["diff-comm+predictive"]
        base = entry["policies"]["greedy+every"]
        entry["gates"] = dict(
            tokens_per_sec_recovered=diff["tokens_per_second"]
            >= base["tokens_per_second"],
            moved_weight_no_more=diff["moved_weight_bytes"]
            <= base["moved_weight_bytes"])
        out["workloads"][wname] = entry
        print(f"\n{wname}: E={w.num_experts} R={w.num_ranks} T={steps} on "
              f"{dev} (median of {repeats})")
        print(table(["policy", "fires", "tokens/s", "mean max/avg",
                     "moved W bytes", "wall s"], rows))
        assert entry["gates"]["tokens_per_sec_recovered"], (
            f"{wname}: diffusion+predictive "
            f"{diff['tokens_per_second']:.0f} tokens/s below greedy "
            f"{base['tokens_per_second']:.0f}")
        assert entry["gates"]["moved_weight_no_more"], (
            f"{wname}: diffusion+predictive moved "
            f"{diff['moved_weight_bytes']:.0f} weight bytes > greedy "
            f"{base['moved_weight_bytes']:.0f}")
    return out


def bench_scale(out, *, num_experts=SCALE["num_experts"],
                num_ranks=SCALE["num_ranks"], steps=SCALE["steps"],
                top_k=4, device="cuda", repeats=REPEATS):
    """A production-shaped expert count through the device-resident
    replay: wall seconds and steps/s measured; gated only on firing and
    moving bytes."""
    dev = resolve_device(device)
    w = epr.RoutingWorkload(num_experts=num_experts, num_ranks=num_ranks,
                            top_k=top_k, tokens_per_step=4096, alpha=0.5,
                            hot_amp=2.0, trace_len=48, seed=1)
    res, wall = median_run(lambda: epr.run_ep_replay(
        w, steps=steps, lb_every=8, strategy="diff-comm", trigger="every",
        device=dev), repeats)
    assert np.isfinite(res.max_avg).all()
    assert int(res.lb_fired.sum()) > 0 and res.total_moved_bytes > 0
    out["scale"] = dict(
        num_experts=num_experts, num_ranks=num_ranks, top_k=top_k,
        steps=steps, rebalances=float(res.lb_fired.sum()),
        moved_weight_bytes=res.total_moved_bytes,
        mean_imbalance=float(res.max_avg.mean()), wall_seconds=wall,
        loop_seconds=res.wall_seconds,
        steps_per_second=steps / max(wall, 1e-9))
    print(f"\nscale: E={num_experts} R={num_ranks} top-{top_k} T={steps} "
          f"on {dev} (median of {repeats})")
    print(table(
        ["fires", "moved W bytes", "mean max/avg", "wall s", "steps/s"],
        [[int(res.lb_fired.sum()), f"{res.total_moved_bytes:.0f}",
          f"{out['scale']['mean_imbalance']:.3f}", f"{wall:.3f}",
          f"{out['scale']['steps_per_second']:.2f}"]]))
    return out


def run(device="cuda", *, out_path=None, repeats=REPEATS):
    dev = resolve_device(device)
    out = dict(environment=environment(dev), t_load=T_LOAD, t_byte=T_BYTE,
               lb_overhead=LB_OVERHEAD, repeats=repeats)
    bench_policies(out, device=dev, repeats=repeats)
    bench_scale(out, device=dev, repeats=repeats)
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(out, indent=1))
        print(f"\nsaved {out_path}")
    else:
        print(f"\nsaved {save_result('moe_bench', out)}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--repeats", type=int, default=REPEATS)
    ap.add_argument("--out", default=None,
                    help="JSON path (default artifacts/bench_torch/"
                         "moe_bench.json)")
    a = ap.parse_args()
    run(a.device, out_path=a.out, repeats=a.repeats)
