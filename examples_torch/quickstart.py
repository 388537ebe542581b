#!/usr/bin/env python3
"""Quickstart on the port: the paper's balancer on a toy problem
(counterpart of ``examples/quickstart.py``).

Run from the repository root:
    python3 examples_torch/quickstart.py [--device cuda|cpu]
"""
import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import api, metrics  # noqa: E402
from repro_torch.sim import stencil, synthetic, viz  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # 8x8 grid of objects on 4 nodes, 5-point-stencil communication
    problem = stencil.stencil_2d(8, 8, 4, mapping="tiled",
                                 device=args.device)

    # inject imbalance: node 0's objects get 5x the load
    problem = synthetic.hotspot(problem, node=0, factor=5.0)

    print("before:", metrics.evaluate(problem))
    print(viz.ownership_map(problem.assignment.cpu().numpy(), 8, 8))

    # run the paper's three-stage communication-aware diffusion with K=2
    plan = api.diffusion_lb(problem, k=2, variant="comm",
                            device=args.device)

    print("\nafter:", metrics.evaluate(
        problem, torch.as_tensor(plan.assignment, device=problem.device)))
    print(viz.ownership_map(plan.assignment, 8, 8))
    print("\nplan info:", {k: round(v, 4) if isinstance(v, float) else v
                           for k, v in plan.info.items()})
    return plan


if __name__ == "__main__":
    main()
