#!/usr/bin/env python3
"""Paper Fig 5/6 on the port: PIC PRK strong scaling under Diffusion vs
GreedyRefine (counterpart of ``benchmarks/fig5_scaling.py``).

The paper measures wall time on 1-8 Perlmutter nodes (128 PEs/node).
Here, as in the JAX package, scaling is *modeled*: the PIC driver runs
the real algorithm at each PE count (same particles, same LB decisions)
and the step time is composed from the per-term cost model
(``driver.CostModel``): slowest-PE compute + inter-PE particle traffic +
LB planning amortization, where the planning term is the measured wall
time of the plans on ``--device``.  Reported per PE count:

  * modeled time/step for none / greedy-refine / diff-comm
  * mean external bytes (the Fig 6 communication-time proxy)

Paper claims asserted: diffusion's modeled step time ≤ GreedyRefine's
(within 5%) at every scale, and no-LB scales worst.  Not modeled:
per-step synchronization wait, so the paper's 7×-vs-none claim is not
asserted.

A batched scenario sweep rides along: every registered scenario
(``scenarios.batch_instances``) replayed at a common chare-level shape by
``run_series_batch``.  The JAX package's mesh-sharded planner branch is a
later slice of the port; with it off the assertions always run.

Run from the repository root:
    python3 benchmarks_torch/fig5_scaling.py [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from benchmarks_torch.common import save_result, table  # noqa: E402
from repro_torch.core import api  # noqa: E402
from repro_torch.pic import chares as ch  # noqa: E402
from repro_torch.pic import driver  # noqa: E402
from repro_torch.sim import scenarios, simulator  # noqa: E402

SCALES = [4, 8, 16, 32]


def batched_scenario_sweep(*, batch: int = 8, steps: int = 60,
                           lb_every: int = 5, k: int = 3, grid: int = 16,
                           num_nodes: int = 16, device="cuda"):
    """Every registered scenario in one batched replay (chare level)."""
    inst = scenarios.batch_instances(batch, grid=grid, num_nodes=num_nodes,
                                     device=device)
    kw = dict(steps=steps, lb_every=lb_every, strategy="diff-comm",
              strategy_kwargs=dict(k=k))
    simulator.run_series_batch(inst, **kw)            # warm-up
    t0 = time.perf_counter()
    bres = simulator.run_series_batch(inst, **kw)
    wall = time.perf_counter() - t0
    cell = {}
    rows = []
    for (name, _, _), s in zip(inst, bres.series):
        e = cell.setdefault(name, dict(lanes=0, mean_max_avg=0.0))
        e["lanes"] += 1
        e["mean_max_avg"] += float(s.max_avg.mean())
    for name, e in sorted(cell.items()):
        e["mean_max_avg"] /= e["lanes"]
        rows.append([name, e["lanes"], f"{e['mean_max_avg']:.3f}"])
    out = dict(batch=batch, steps=steps,
               lane_steps_per_sec=bres.lane_steps_per_sec,
               wall_seconds=wall, per_scenario=cell,
               lb_fired=[s.lb_fired.tolist() for s in bres.series],
               final_assignments=[s.final_assignment for s in bres.series])
    print(f"batched scenario sweep: {batch} lanes × {steps} steps in "
          f"{wall:.3f}s ({bres.lane_steps_per_sec:.0f} lane-steps/sec) on "
          f"{device}")
    print(table(["scenario", "lanes", "mean max/avg"], rows))
    return out


def _warmup(pes: int, cx: int, cy: int, L: int, device):
    """Plan once with diff-comm at this (chares, PEs) shape, so the first
    measured plan does not pay the kernels' build and first launches."""
    loads = np.random.default_rng(0).random(cx * cy).astype(np.float32) + 0.1
    assignment = ch.initial_mapping(cx, cy, pes, "striped")
    prob = ch.build_problem(torch.as_tensor(loads, device=device),
                            torch.as_tensor(assignment, device=device),
                            L=L, cx=cx, cy=cy, num_pes=pes, k=4, vy0=1.0,
                            lb_period=5)
    api.run_strategy("diff-comm", prob, k=3)


def run(n: int = 200_000, L: int = 1200, steps: int = 50,
        scenario: str = "pic-geometric", device="cuda", scales=SCALES,
        sweep=None):
    # particle mode / mapping / density come from the scenario registry;
    # charge k, the chare grid and the PE scales stay the Fig-5
    # strong-scaling setup
    print("planning with the single-device engine (the mesh-sharded "
          "planner is a later slice of the port)")
    diff_name = "diff-comm"
    sc = dict(scenarios.get(scenario).pic_config or {})
    out = {"batched_scenarios": batched_scenario_sweep(
               device=device, **(sweep or {})),
           "sharded_planner": False}
    rows = []
    for pes in scales:
        cell = {}
        _warmup(pes, 20, 10, L, device)
        for strat in ["none", "greedy-refine", diff_name]:
            kw = dict(k=3) if strat.startswith("diff") else {}
            cfg = driver.PICConfig(
                L=L, n_particles=n, steps=steps, k=4,
                rho=sc.get("rho", 0.9), mode=sc.get("mode", "GEOMETRIC"),
                cx=20, cy=10, num_pes=pes,
                mapping=sc.get("mapping", "striped"), lb_every=5,
                strategy=strat, strategy_kwargs=kw, device=device)
            r = driver.run(cfg)
            cell[strat] = dict(
                modeled_time=float(r.step_seconds.sum()),
                mean_ext=float(r.ext_bytes.mean()),
                max_avg=float(r.max_avg.mean()),
                lb_seconds=float(r.lb_seconds),
                lb_steps=r.lb_steps.tolist(),
                wall_seconds=float(r.wall_seconds),
            )
        out[pes] = cell
        rows.append([
            pes,
            f"{cell['none']['modeled_time']:.3f}",
            f"{cell['greedy-refine']['modeled_time']:.3f}",
            f"{cell[diff_name]['modeled_time']:.3f}",
            f"{cell[diff_name]['modeled_time'] / cell['greedy-refine']['modeled_time']:.2f}",
            f"{cell[diff_name]['mean_ext'] / max(cell['greedy-refine']['mean_ext'], 1):.2f}",
            f"{cell['greedy-refine']['lb_seconds']:.4f}",
            f"{cell[diff_name]['lb_seconds']:.4f}",
        ])
    print(f"Fig 5 — modeled strong scaling, {n} particles {L}x{L} "
          f"(cost model: compute+comm+LB), on {device}")
    print(table(["PEs", "none (s)", "greedy (s)", "diff (s)",
                 "diff/greedy", "ext ratio", "greedy lb s", "diff lb s"],
                rows))
    # paper: diffusion <= greedy at every scale
    for pes in scales:
        assert (out[pes][diff_name]["modeled_time"]
                <= out[pes]["greedy-refine"]["modeled_time"] * 1.05), pes
    # no-LB scales worst: its time barely improves from 4 to max PEs
    t_none = [out[p]["none"]["modeled_time"] for p in scales]
    t_diff = [out[p][diff_name]["modeled_time"] for p in scales]
    assert (t_diff[-1] / t_diff[0]
            < t_none[-1] / max(t_none[0], 1e-9) + 0.5)
    save_result("fig5_scaling", out)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    run(device=ap.parse_args().device)
