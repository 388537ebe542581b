#!/usr/bin/env python3
"""End-to-end PIC PRK driver run with diffusion load balancing on the port
(paper §VI; counterpart of ``examples/pic_prk_run.py``).

Run from the repository root:
    python3 examples_torch/pic_prk_run.py [--particles 100000] [--device cuda|cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.pic import driver  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--particles", type=int, default=50_000)
    ap.add_argument("--grid", type=int, default=500)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--pes", type=int, default=4)
    ap.add_argument("--strategy", default="diff-comm",
                    choices=["none", "greedy-refine", "diff-comm",
                             "diff-coord", "metis", "parmetis", "greedy"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = driver.PICConfig(
        L=args.grid, n_particles=args.particles, steps=args.steps,
        k=2, rho=0.9, cx=12, cy=12, num_pes=args.pes, mapping="striped",
        lb_every=10, strategy=args.strategy,
        strategy_kwargs=dict(k=3) if args.strategy.startswith("diff") else {},
        device=args.device)
    print(f"PIC PRK: {args.particles} particles on {args.grid}² grid, "
          f"{args.pes} PEs, strategy={args.strategy}, on {args.device}")
    r = driver.run(cfg)
    s = r.summary()
    print(f"mean max/avg particles per PE: {s['mean_max_avg']:.3f}")
    print(f"mean external bytes/step:      {s['mean_ext_bytes']:.0f}")
    print(f"LB planning time total:        {s['lb_seconds']:.2f}s")
    print(f"modeled runtime:               {s['modeled_time']:.4f}s")
    print("max/avg trajectory:",
          " ".join(f"{v:.2f}" for v in r.max_avg[::max(args.steps // 15, 1)]))
    return r


if __name__ == "__main__":
    main()
