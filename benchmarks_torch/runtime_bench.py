#!/usr/bin/env python3
"""Online rebalancing runtime on the port: fixed vs threshold vs predictive
triggers (counterpart of ``benchmarks/runtime_bench.py``).

Replays every registered scenario (``sim/scenarios.py``, each at its
default size) under the three trigger policies with the ``diff-comm``
planner, 200 steps, LB every 10, k = 4, through ``run_series``'s
device-resident loop (``scan=True``), and prices each trajectory with
``runtime.cost.RuntimeCostModel``: slowest-node compute + executed
migration traffic + per-rebalance overhead.  The JAX script's gates,
unchanged (modeled time, not wall time, so they hold on a card exactly as
on the CPU):

  * on ``bimodal-churn`` and ``adversarial-hotspot`` both the threshold
    and the predictive policy beat the fixed ``lb_every=10`` cadence on
    total modeled seconds;
  * the executed PIC migration (20 000 particles, 60 steps, every /
    threshold / predictive) conserves the particle count.

On a card the PIC section runs K5 and K4 every step, K1 at each fired
plan and K3 at each exchange; its ``manifest_method`` is what
``runtime.migrate.resolve_method("auto", ...)`` picks for that device.
Replay wall time is the median of ``--repeats`` warm runs.

Results go to ``artifacts/bench_torch/runtime_bench.json`` and the
stable-schema ``artifacts/bench_torch/BENCH_runtime.json`` (the JAX
script's schema string, with the device, the card's name and power limit,
torch/CUDA versions and git commit); the repository root's
``BENCH_runtime.json`` belongs to the JAX package and is not touched.

Run from the repository root:
    python3 benchmarks_torch/runtime_bench.py [--device cuda|cpu] [--repeats N]
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from benchmarks_torch.common import (  # noqa: E402
    PIC_BASE, bench_main, finish, median_run, table)
from repro_torch.kernels import resolve_device  # noqa: E402
from repro_torch.pic import driver  # noqa: E402
from repro_torch.runtime import cost as rt_cost  # noqa: E402
from repro_torch.runtime import migrate as rt_migrate  # noqa: E402
from repro_torch.runtime import triggers as rt_triggers  # noqa: E402
from repro_torch.sim import scenarios, simulator  # noqa: E402

SCHEMA = "runtime-bench/v3"
REPEATS = 3

#: bytes_per_load matches the PIC driver's 48 B/particle payload;
#: t_byte/lb_overhead put migration and planning overhead at the same
#: order as one step's imbalance excess, so the amortization trade-off
#: is actually exercised (the JAX script's constant)
MODEL = rt_cost.RuntimeCostModel(t_load=1.0, t_byte=0.002,
                                 bytes_per_load=48.0, lb_overhead=30.0)
#: the predictive policy amortizes against the same model the bench
#: prices trajectories with
POLICIES = (
    ("every", "every"),
    ("threshold", "threshold"),
    ("predictive", rt_triggers.PredictiveTrigger(cost=MODEL)),
)
GATED = ("bimodal-churn", "adversarial-hotspot")


def bench_scenarios(out, *, steps=200, lb_every=10, k=4, device="cuda",
                    repeats=REPEATS, names=None):
    """Every scenario (or ``names``) under the three policies."""
    dev = resolve_device(device)
    out["scenarios"] = {}
    for name in names or scenarios.available():
        prob, evolve = scenarios.get(name).instantiate(device=dev)
        rows = []
        out["scenarios"][name] = {}
        for policy, spec in POLICIES:
            kw = dict(steps=steps, lb_every=lb_every, strategy="diff-comm",
                      strategy_kwargs=dict(k=k), trigger=spec, scan=True)
            simulator.run_series(prob, evolve, **kw)          # warm-up
            res, wall = median_run(
                lambda kw=kw: simulator.run_series(prob, evolve, **kw),
                repeats)
            modeled = float(
                rt_cost.series_modeled_seconds(res, MODEL).sum())
            out["scenarios"][name][policy] = dict(
                rebalances=float(res.lb_fired.sum()),
                fire_steps=[int(t) for t in np.flatnonzero(res.lb_fired)],
                mean_max_avg=float(res.max_avg.mean()),
                migrated_load=float(res.migrated_load.sum()),
                modeled_seconds=modeled,
                wall_seconds=wall,
            )
            rows.append([policy, int(res.lb_fired.sum()),
                         f"{res.max_avg.mean():.3f}",
                         f"{res.migrated_load.sum():.0f}",
                         f"{modeled:.0f}", f"{wall:.3f}"])
        print(f"\n{name}  (diff-comm k={k}, {steps} steps on {dev}, "
              f"median of {repeats})")
        print(table(["trigger", "rebalances", "mean max/avg",
                     "migrated load", "modeled s", "wall s"], rows))
    return out


def bench_pic(out, *, steps=60, lb_every=10, n_particles=20_000,
              device="cuda", repeats=REPEATS):
    """Executed particle migration under fixed vs adaptive triggering."""
    dev = resolve_device(device)
    base = dict(PIC_BASE, strategy="diff-comm", strategy_kwargs=dict(k=4),
                n_particles=n_particles, steps=steps,
                lb_every=lb_every)
    # the PIC predictive policy amortizes against the PIC CostModel
    # bridged into runtime terms (t_particle/t_byte/48 B per particle)
    pic_predictive = rt_triggers.PredictiveTrigger(
        cost=rt_cost.RuntimeCostModel.from_pic(
            driver.CostModel(), strategy=base["strategy"],
            num_pes=base["num_pes"], bytes_per_particle=48.0))
    out["pic"] = dict(manifest_method=rt_migrate.resolve_method(
        "auto", n=base["n_particles"], num_nodes=base["num_pes"],
        device=dev))
    rows = []
    for policy in (None, "threshold", pic_predictive):
        cfg = driver.PICConfig(trigger=policy, device=str(dev), **base)
        driver.run(cfg)                                       # warm-up
        res, wall = median_run(lambda cfg=cfg: driver.run(cfg), repeats)
        s = res.summary()
        label = ("every" if policy is None
                 else policy if isinstance(policy, str) else "predictive")
        conserved = bool(res.final_x.shape[0] == base["n_particles"]
                         and np.isfinite(res.final_x).all())
        out["pic"][label] = dict(
            rebalances=float(res.lb_steps.sum()),
            migrated_bytes=float(res.migrated_bytes.sum()),
            modeled_time=s["modeled_time"],
            mean_max_avg=s["mean_max_avg"],
            particles_conserved=conserved,
            wall_seconds=wall,
        )
        rows.append([label, int(res.lb_steps.sum()),
                     f"{res.migrated_bytes.sum():.0f}",
                     f"{s['modeled_time']:.4f}", conserved])
    print(f"\nPIC driver {base['n_particles']} particles, {steps} steps on "
          f"{dev}, executed migration ({out['pic']['manifest_method']} "
          "manifest)")
    print(table(["trigger", "rebalances", "migrated bytes (measured)",
                 "modeled s", "conserved"], rows))
    return out


def gates(out):
    """Each gate of the JAX script: ``{name: (holds, message)}``."""
    res = {}
    for name in GATED:
        by = out["scenarios"][name]
        for policy in ("threshold", "predictive"):
            got = by[policy]["modeled_seconds"]
            ref = by["every"]["modeled_seconds"]
            res[f"{name}: {policy} < every"] = (
                got < ref, f"{policy} must beat the fixed cadence on "
                f"{name}: {got:.0f} vs {ref:.0f}")
    for label, r in out["pic"].items():
        if isinstance(r, dict):
            res[f"pic {label}: particles conserved"] = (
                r["particles_conserved"],
                "executed migration must conserve particles")
    return res


def check(out):
    """Assert every gate (all deterministic: modeled seconds, counts)."""
    for holds, msg in gates(out).values():
        assert holds, msg


def run(device="cuda", *, repeats=REPEATS, out_path=None):
    dev = resolve_device(device)
    out = {}
    bench_scenarios(out, device=dev, repeats=repeats)
    bench_pic(out, device=dev, repeats=repeats)
    return finish(
        "runtime_bench", out, bench="runtime", schema=SCHEMA, device=dev,
        repeats=repeats, check=check, out_path=out_path,
        cost_model=dict(t_load=MODEL.t_load, t_byte=MODEL.t_byte,
                        bytes_per_load=MODEL.bytes_per_load,
                        lb_overhead=MODEL.lb_overhead))


if __name__ == "__main__":
    bench_main(run, __doc__, REPEATS)
