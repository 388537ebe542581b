#!/usr/bin/env python3
"""Roofline table of the port (counterpart of ``benchmarks/roofline.py``):
reads the dry run's artifacts (``artifacts/dryrun_torch/*__single.json``,
written by ``python -m repro_torch.launch.dryrun``) and prints the three
terms per (arch × shape) on one NVIDIA H100 — compute at the bf16 dense
peak (989 TFLOP/s), memory traffic at 3.35 TB/s HBM, and collectives
(none on one card) — the dominant bottleneck, the useful-flop ratio, and
a one-line what-would-move-it note.

Run from the repository root:
    python3 benchmarks_torch/roofline.py [single] [tag]
"""
from __future__ import annotations

import glob
import json
import os
import sys
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from benchmarks_torch.common import save_result, table  # noqa: E402

ARTIFACTS = str(ROOT / "artifacts" / "dryrun_torch")

NOTES = {
    ("compute",): "more chips or lower-precision matmuls",
    ("memory",): "fuse/eliminate copies+transposes; seq-shard activations",
    ("collective",): "resharde params (EP/TP) to cut gathers; overlap",
}


def load(mesh: str = "single", tag: str = "") -> List[Dict]:
    suffix = f"__{tag}.json" if tag else ".json"
    recs = []
    for path in sorted(glob.glob(os.path.join(ARTIFACTS,
                                              f"*__{mesh}{suffix}"))):
        base = os.path.basename(path)
        if not tag and base.count("__") != 2:
            continue
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def note_for(rec: Dict) -> str:
    dom = rec["roofline"]["dominant"]
    if dom == "collective":
        ag = rec["collectives"]["all-gather"]["bytes"]
        ar = rec["collectives"]["all-reduce"]["bytes"]
        if ag > ar:
            return "param all-gathers dominate: shard experts/params wider"
        return "grad all-reduce dominates: reduce-scatter + compress"
    if dom == "memory":
        if rec["op_census"]["transpose"] > 500:
            return "layout churn (transposes); pick matmul-friendly layouts"
        return "activation traffic; seq-shard / fuse elementwise"
    return "compute-bound: good — push batch or precision"


def run(mesh: str = "single", tag: str = ""):
    recs = load(mesh, tag)
    rows = []
    out = {}
    for r in recs:
        key = f"{r['arch']}×{r['shape']}"
        if r["status"] == "skip":
            rows.append([key, "skip", "-", "-", "-", "-", "-", "-"])
            continue
        if r["status"] == "fail":
            rows.append([key, "FAIL", "-", "-", "-", "-", "-", "-"])
            continue
        rl = r["roofline"]
        rows.append([
            key,
            f"{rl['t_compute']*1e3:.1f}",
            f"{rl['t_memory']*1e3:.1f}",
            f"{rl['t_collective']*1e3:.1f}",
            rl["dominant"],
            f"{rl['useful_flop_frac']*100:.0f}%",
            f"{rl['roofline_frac']*100:.2f}%",
            f"{r['memory']['peak_device_bytes']/2**30:.1f}",
        ])
        out[key] = dict(rl, peak_gib=r["memory"]["peak_device_bytes"] / 2**30,
                        note=note_for(r))
    print(f"Roofline — mesh={mesh}{' tag=' + tag if tag else ''} "
          f"(terms in ms/step/device; H100: 989 TFLOP/s bf16, 3.35 TB/s "
          f"HBM, no collectives on one card)")
    print(table(["arch×shape", "t_comp", "t_mem", "t_coll", "dominant",
                 "useful", "roofline", "GiB/dev"], rows))
    save_result(f"roofline_{mesh}{('_' + tag) if tag else ''}", out)
    return out


if __name__ == "__main__":
    run(*(sys.argv[1:] or ["single"]))
