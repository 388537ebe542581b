#!/usr/bin/env python3
"""Strategy comparison on time-evolving workloads on the port (paper §V;
counterpart of ``examples/stencil_lb_demo.py``).

Replays every registered scenario (``sim/scenarios.py``) under periodic
rebalancing and prints per-strategy trajectories — the simulator-level
version of the paper's Fig 4.  Device planners (none / diff-*) take the
device-resident loop; the NumPy baseline (greedy-refine) takes the host
loop — the same ``run_series`` call either way; the ``path`` column says
which (``SeriesResult.scanned``).

Run from the repository root:
    python3 examples_torch/stencil_lb_demo.py [--device cuda|cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.sim import scenarios, simulator  # noqa: E402

STRATEGIES = ["none", "greedy-refine", "diff-comm", "diff-coord"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = []
    for name in scenarios.available():
        sc = scenarios.get(name)
        problem, evolve = sc.instantiate(device=args.device)
        print(f"\n=== {name}: {sc.description}")
        print(f"{'strategy':>14} {'mean max/avg':>13} {'mean ext/int':>13} "
              f"{'migr/step':>10} {'path':>8} {'wall s':>8}")
        for strategy in STRATEGIES:
            kw = dict(k=4) if strategy.startswith("diff") else {}
            if strategy == "diff-coord" and problem.coords is None:
                continue
            res = simulator.run_series(
                problem, evolve, steps=60, lb_every=5, strategy=strategy,
                strategy_kwargs=kw)
            mig = (res.migrations[res.migrations > 0].mean()
                   if (res.migrations > 0).any() else 0.0)
            path = "scan" if res.scanned else "host"
            print(f"{strategy:>14} {res.max_avg.mean():>13.3f} "
                  f"{res.ext_int.mean():>13.3f} {mig:>10.3f} "
                  f"{path:>8} {res.wall_seconds:>8.3f}")
            rows.append((name, strategy, path, res))
    return rows


if __name__ == "__main__":
    main()
