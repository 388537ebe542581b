#!/usr/bin/env python3
"""Paper Table II on the port: 5 strategies × 3 synthetic 3D-stencil
benchmarks (8/32/128 PEs), mod-7 load injection (counterpart of
``benchmarks/table2_strategies.py``).

Paper relations validated:
  * GreedyRefine: best max/avg (1.00), WORST ext/int, ~19% migrations;
  * METIS: best ext/int, ~87-99% migrations;
  * ParMETIS: middling balance, fewest migrations (hard-to-tune knob);
  * Diff-Comm/Diff-Coord: 1.02-1.14 max/avg, ext/int between GreedyRefine
    and METIS, 15-19% migrations — the middle ground the paper claims.

The host baselines plan in NumPy on the host (as in Charm++ and the JAX
package); the diffusion strategies plan on ``--device``.  A trigger
section replays ``bimodal-churn`` under the trigger-wrapped registry
variants.

Run from the repository root:
    python3 benchmarks_torch/table2_strategies.py [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from benchmarks_torch.common import save_result, table  # noqa: E402
from repro_torch.runtime import cost as rt_cost  # noqa: E402
from repro_torch.sim import (scenarios, simulator, stencil,  # noqa: E402
                             synthetic)

BENCH = [(8, (8, 8, 8)), (32, (16, 16, 8)), (128, (32, 16, 16))]
STRATS = ["greedy-refine", "metis", "parmetis", "diff-comm", "diff-coord"]
# trigger-wrapped registry variants (runtime.triggers policies) — same
# planner, adaptive *when*; surfaced over a time-evolving replay where
# the wrapping matters (snapshot planning is identical to diff-comm)
TRIGGER_STRATS = ["diff-comm", "diff-comm+threshold", "diff-comm+predictive"]
#: the JAX package's runtime bench model (``benchmarks/runtime_bench.py``):
#: bytes_per_load matches the PIC driver's 48 B/particle payload; t_byte
#: and lb_overhead put migration and planning overhead at the order of one
#: step's imbalance excess
MODEL = rt_cost.RuntimeCostModel(t_load=1.0, t_byte=0.002,
                                 bytes_per_load=48.0, lb_overhead=30.0)


def trigger_policy_section(steps: int = 200, lb_every: int = 10,
                           device="cuda"):
    """Replay the churn workload under each trigger-wrapped strategy
    (registry defaults)."""
    model = MODEL
    prob, evolve = scenarios.get("bimodal-churn").instantiate(device=device)
    out = {}
    rows = []
    for strat in TRIGGER_STRATS:
        res = simulator.run_series(
            prob, evolve, steps=steps, lb_every=lb_every, strategy=strat,
            strategy_kwargs=dict(k=4), scan=True)
        total = float(rt_cost.series_modeled_seconds(res, model).sum())
        # per-policy migration cost: the executed exchange volume priced
        # by the same model (per-rebalance overhead only at fired steps)
        per_step = np.asarray(
            model.migration_seconds(res.migrated_load.astype(np.float32)))
        migr_cost = float((per_step * res.lb_fired).sum())
        out[strat] = dict(
            rebalances=float(res.lb_fired.sum()),
            mean_max_avg=float(res.max_avg.mean()),
            migrated_load=float(res.migrated_load.sum()),
            migration_seconds=migr_cost,
            modeled_seconds=total,
            plan_seconds=float(res.plan_seconds),
            wall_seconds=float(res.wall_seconds),
        )
        rows.append([strat, int(res.lb_fired.sum()),
                     f"{res.max_avg.mean():.3f}",
                     f"{res.migrated_load.sum():.0f}",
                     f"{migr_cost:.0f}", f"{total:.0f}"])
    print(f"\nTrigger policies on bimodal-churn ({steps} steps)")
    print(table(["strategy", "rebalances", "mean max/avg",
                 "migrated load", "migr cost s", "modeled s"],
                rows))
    return out


def run(mapping: str = "striped", device="cuda", bench=BENCH,
        trigger_steps: int = 200):
    model = MODEL
    out = {}
    for pes, dims in bench:
        prob = stencil.stencil_3d(*dims, pes, mapping=mapping,
                                  device=device)
        prob = synthetic.mod7(prob)
        rows = simulator.compare(
            prob, STRATS,
            strategy_kwargs={"diff-comm": dict(k=4), "diff-coord": dict(k=4)})
        print(f"\nBenchmark {pes} PEs ({dims[0]}x{dims[1]}x{dims[2]} "
              f"{mapping}) on {device}")
        print(simulator.format_table(rows))
        out[pes] = {r.strategy: dict(r.after, **{
            k: v for k, v in r.info.items() if isinstance(v, (int, float))})
            for r in rows}
        out[f"{pes}_before"] = rows[0].before
        # migration-cost columns (§II metric 3): the load volume each plan
        # moves, priced by the runtime cost model
        mig_rows = []
        for r in rows:
            cost_s = float(model.migration_seconds(
                np.float32(r.info["migrated_load"])))
            out[pes][r.strategy]["migration_seconds"] = cost_s
            mig_rows.append([r.strategy,
                             f"{r.info['migrated_load']:.0f}",
                             f"{100 * r.after['pct_migrations']:.1f}%",
                             f"{cost_s:.0f}"])
        print(table(["strategy", "migrated load", "%objs", "migr cost s"],
                    mig_rows))

        by = out[pes]
        # paper's qualitative relations
        assert by["greedy-refine"]["max_avg_load"] <= 1.05
        assert by["metis"]["pct_migrations"] > 0.5, "METIS migrates heavily"
        assert (by["diff-comm"]["pct_migrations"]
                < by["metis"]["pct_migrations"] / 2), "diffusion migrates far less"
        # locality: diffusion never materially worse than GreedyRefine...
        assert (by["diff-comm"]["ext_int_comm"]
                < by["greedy-refine"]["ext_int_comm"] * 1.1), \
            "diffusion must not lose locality vs GreedyRefine"
        assert by["diff-comm"]["max_avg_load"] < 1.15
    # ...and strictly better where it matters (the largest benchmark —
    # the paper's gap also widens with scale, §VI.C)
    big = bench[-1][0]
    assert (out[big]["diff-comm"]["ext_int_comm"]
            < out[big]["greedy-refine"]["ext_int_comm"])
    out["trigger_policies"] = trigger_policy_section(steps=trigger_steps,
                                                     device=device)
    save_result("table2_strategies", out)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    run(device=ap.parse_args().device)
