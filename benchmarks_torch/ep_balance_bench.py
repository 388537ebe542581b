#!/usr/bin/env python3
"""The paper's balancer as MoE expert placement, on the port (counterpart
of ``benchmarks/ep_balance_bench.py``).

Simulates deepseek-style routing drift (a Zipf expert popularity whose
peak rotates every period) and compares three placement policies on the
max/avg token load across EP ranks, the experts moved (and their weight
traffic at llama-like expert sizes), and the cross-rank co-activation
(the ext/int analogue):

  static      — never move experts;
  greedy      — re-place every expert by load each period (the
                capacity-capped ``ep-greedy``);
  diff-comm   — the paper's three-stage balancer on the expert graph.

The JAX script's gates: diff-comm's mean max/avg is below static's, and
it moves no more experts than greedy.  The routing draws are NumPy
(seeded), as in the JAX script; planning runs on ``--device`` (the card
by default).  Results go to ``artifacts/bench_torch/ep_balance.json``
(or ``--out``) with the device, torch/CUDA versions and git commit.

Run from the repository root:
    python3 benchmarks_torch/ep_balance_bench.py [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from benchmarks_torch.common import environment, save_result, table  # noqa: E402
from repro_torch.distributed import ep_balance as eb  # noqa: E402
from repro_torch.kernels import resolve_device  # noqa: E402


def _route(E, T, k, phase, rng):
    """Skewed routing with a drifting hotspot: popularity ∝ Zipf rotated
    by ``phase``."""
    ranks = (np.arange(E) - phase) % E
    p = 1.0 / (1 + ranks.astype(np.float64)) ** 1.2
    p /= p.sum()
    flat = rng.choice(E, size=T * k, p=p)
    return flat.reshape(T, k)


def _ext_coact(stats: eb.ExpertStats, placement) -> float:
    same = stats.coact * (placement[:, None] == placement[None, :])
    tot = stats.coact.sum()
    return float((tot - same.sum()) / max(same.sum(), 1e-9))


def policies(E: int = 64, R: int = 8, periods: int = 12, T: int = 4096,
             k: int = 2, seed: int = 0, device="cuda"):
    """The three policies' numbers; asserts both gates."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    bytes_per_expert = 3 * 4096 * 14336 * 2 / 2**20   # MiB, llama-ish
    results = {}
    for policy in ["static", "greedy", "diff-comm"]:
        stats = eb.ExpertStats(E, ema=0.7)
        placement = (np.arange(E) * R // E).astype(np.int32)
        ma, moved, ext = [], 0, []
        for t in range(periods):
            ids = _route(E, T, k, phase=t * 3, rng=rng)
            stats.update(ids)
            if policy != "static" and t % 2 == 1:
                new, _ = eb.plan_placement(
                    stats, placement, R, device=dev,
                    strategy="greedy" if policy == "greedy" else "diff-comm")
                moved += int((new != placement).sum())
                placement = new
            loads = np.bincount(ids.reshape(-1), minlength=E)
            rank_load = np.bincount(placement, weights=loads, minlength=R)
            ma.append(rank_load.max() / rank_load.mean())
            ext.append(_ext_coact(stats, placement))
        results[policy] = dict(
            mean_max_avg=float(np.mean(ma)), moved_experts=moved,
            migration_mib=moved * bytes_per_expert,
            mean_ext_coact=float(np.mean(ext)))
    rows = [[p, f"{r['mean_max_avg']:.3f}", r["moved_experts"],
             f"{r['migration_mib']:.0f}", f"{r['mean_ext_coact']:.2f}"]
            for p, r in results.items()]
    print(f"EP balance — {E} experts / {R} ranks, drifting zipf routing, "
          f"planned on {dev}")
    print(table(["policy", "max/avg", "moved", "migr MiB", "ext coact"],
                rows))
    gates = dict(
        max_avg_below_static=results["diff-comm"]["mean_max_avg"]
        < results["static"]["mean_max_avg"],
        moved_no_more_than_greedy=results["diff-comm"]["moved_experts"]
        <= results["greedy"]["moved_experts"])
    assert gates["max_avg_below_static"], results
    assert gates["moved_no_more_than_greedy"], results
    return dict(config=dict(E=E, R=R, periods=periods, T=T, k=k, seed=seed),
                policies=results, gates=gates)


def run(device="cuda", *, out_path=None):
    out = dict(environment=environment(resolve_device(device)))
    out.update(policies(device=device))
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(out, indent=1))
        print(f"saved {out_path}")
    else:
        print(f"saved {save_result('ep_balance', out)}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="JSON path (default artifacts/bench_torch/"
                         "ep_balance.json)")
    a = ap.parse_args()
    run(a.device, out_path=a.out)
