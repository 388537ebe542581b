#!/usr/bin/env python3
"""The port's benchmark orchestrator (counterpart of
``benchmarks/run.py``): one entry per paper table or figure and per
framework bench, each the port script's ``run()`` on ``--device``.

Run from the repository root:
    python3 benchmarks_torch/run.py                 # everything
    python3 benchmarks_torch/run.py fig4 roofline   # a subset
    python3 benchmarks_torch/run.py --device cpu engine
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from benchmarks_torch import (engine_bench, ep_balance_bench,  # noqa: E402
                              fig2_stencil, fig4_pic_lb, fig5_scaling,
                              kernel_bench, replay_shard_bench, roofline,
                              runtime_bench, table1_neighbor_count,
                              table2_strategies)

ALL = {
    "fig2": fig2_stencil.run,
    "table1": table1_neighbor_count.run,
    "table2": table2_strategies.run,
    "fig4": fig4_pic_lb.run,
    "fig5": fig5_scaling.run,
    "engine": engine_bench.run,
    "runtime": runtime_bench.run,
    "replay": replay_shard_bench.run,
    "ep_balance": ep_balance_bench.run,
    "kernels": kernel_bench.run,
    "roofline": roofline.run,
}
#: entries that read artifacts and run nothing on a device
NO_DEVICE = ("roofline",)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*",
                    help=f"entries to run (default: all of {list(ALL)})")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    names = args.names or list(ALL)
    failures = []
    t0 = time.time()
    for name in names:
        print(f"\n{'='*72}\n== {name}\n{'='*72}", flush=True)
        try:
            t1 = time.time()
            if name in NO_DEVICE:
                ALL[name]()
            else:
                ALL[name](device=args.device)
            print(f"-- {name} OK ({time.time()-t1:.1f}s)", flush=True)
        except Exception:
            failures.append(name)
            traceback.print_exc()
    print(f"\n{'='*72}")
    print(f"benchmarks done in {time.time()-t0:.0f}s; "
          f"{len(names)-len(failures)}/{len(names)} OK"
          + (f"; FAILED: {failures}" if failures else ""))
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
