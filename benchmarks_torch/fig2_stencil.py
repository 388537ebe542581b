#!/usr/bin/env python3
"""Paper Fig 2 on the port: 2D stencil, 16 PEs, tiled start, ±40%
synthetic noise, K = 4 (counterpart of ``benchmarks/fig2_stencil.py``).

Paper values: comm-based  max/avg 1.04, ext/int 0.06;
              coord-based max/avg 1.02, ext/int 0.072.

The paper's grid size is unstated; at 64×64 the relations are what to
compare: both variants restore balance while keeping ext/int near the
tiled optimum, coord slightly rounder and slightly less local (§V.A).

Run from the repository root:
    python3 benchmarks_torch/fig2_stencil.py [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from benchmarks_torch.common import save_result, table  # noqa: E402
from repro_torch.core import api, metrics  # noqa: E402
from repro_torch.sim import stencil, synthetic, viz  # noqa: E402


def run(grid: int = 64, pes: int = 16, k: int = 4, noise: float = 0.4,
        seed: int = 1, device="cuda"):
    prob = stencil.stencil_2d(grid, grid, pes, mapping="tiled",
                              device=device)
    prob = synthetic.random_pm(prob, noise, seed=seed)
    before = metrics.evaluate(prob)
    rows = [["initial", f"{before['max_avg_load']:.3f}",
             f"{before['ext_int_comm']:.3f}", "-", "-"]]
    out = dict(before=before)
    for variant in ("diff-comm", "diff-coord"):
        plan = api.run_strategy(variant, prob, k=k)
        out[variant] = plan.info
        rows.append([
            variant, f"{plan.info['max_avg_load']:.3f}",
            f"{plan.info['ext_int_comm']:.3f}",
            f"{plan.info['pct_migrations']*100:.1f}%",
            f"{plan.info['plan_seconds']:.2f}s",
        ])
        out[variant + "_locality"] = viz.locality_summary(
            plan.assignment, grid, grid)
    print(f"Fig 2 — {grid}x{grid} stencil, {pes} PEs, ±{noise:.0%}, K={k}, "
          f"on {device}")
    print(table(["strategy", "max/avg", "ext/int", "%migr", "plan"], rows))
    print("paper: comm 1.04/.06, coord 1.02/.072 (relations: both balance; "
          "coord trades locality for roundness)")
    save_result("fig2_stencil", out)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    run(device=ap.parse_args().device)
