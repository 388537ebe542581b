#!/usr/bin/env python3
"""Paper Table I on the port: ring of processors, single 10× hotspot,
K ∈ {1, 2, 4, 8} (counterpart of ``benchmarks/table1_neighbor_count.py``).

Paper values:    K:        1      2      4      8
  max/avg load         4.9    1.7    1.3    1.1
  ext/int comm (MB)   .142   .151   .25    .26

Claims checked: (1) balance improves monotonically with K; (2) external/
internal communication rises with K (§V.B).

Run from the repository root:
    python3 benchmarks_torch/table1_neighbor_count.py [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from benchmarks_torch.common import save_result, table  # noqa: E402
from repro_torch.core import api, metrics  # noqa: E402
from repro_torch.sim import stencil, synthetic  # noqa: E402

PAPER = {1: (4.9, 0.142), 2: (1.7, 0.151), 4: (1.3, 0.25), 8: (1.1, 0.26)}


def run(nx: int = 64, ny: int = 16, pes: int = 16, factor: float = 10.0,
        device="cuda"):
    prob = stencil.stencil_2d(nx, ny, pes, mapping="ring", device=device)
    prob = synthetic.hotspot(prob, node=0, factor=factor)
    before = metrics.evaluate(prob)
    rows = []
    out = dict(before=before, cells={}, assignments={})
    for k in (1, 2, 4, 8):
        plan = api.run_strategy("diff-comm", prob, k=k)
        info = plan.info
        out["cells"][k] = info
        out["assignments"][k] = plan.assignment
        pm, pe = PAPER[k]
        rows.append([k, f"{info['max_avg_load']:.2f}", f"{pm}",
                     f"{info['ext_int_comm']:.3f}", f"{pe}",
                     f"{info['diffusion_iters']}"])
    print(f"Table I — ring, one {factor:.0f}x hotspot "
          f"(initial max/avg {before['max_avg_load']:.2f}), on {device}")
    print(table(["K", "max/avg", "paper", "ext/int", "paper", "iters"],
                rows))
    ks = sorted(out["cells"])
    ma = [out["cells"][k]["max_avg_load"] for k in ks]
    ei = [out["cells"][k]["ext_int_comm"] for k in ks]
    assert all(a >= b - 0.05 for a, b in zip(ma, ma[1:])), "balance vs K"
    assert ei[-1] > ei[0], "locality degrades with K (paper §V.B)"
    save_result("table1_neighbor_count", out)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    run(device=ap.parse_args().device)
