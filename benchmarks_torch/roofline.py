#!/usr/bin/env python3
"""Roofline table of the port (counterpart of ``benchmarks/roofline.py``):
reads the dry run's artifacts (``artifacts/dryrun_torch/*__<mesh>.json``,
written by ``python -m repro_torch.launch.dryrun --mesh <mesh>``) and
prints the three terms per (arch × shape) a card — compute at the H100's
bf16 dense peak (989 TFLOP/s), memory traffic at 3.35 TB/s HBM, and the
collectives at the dry run's stated link rates (none on one card;
NVLink 4 within a node, NDR across nodes on the ``pod`` and ``multi``
meshes) — the dominant bottleneck, the useful-flop ratio, whether the
cell fits the card, and a one-line what-would-move-it note.

Run from the repository root:
    python3 benchmarks_torch/roofline.py [single|pod|multi] [tag]
    python3 benchmarks_torch/roofline.py --mesh multi [--tag t]
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
            rows.append([key, "skip", "-", "-", "-", "-", "-", "-", "-"])
            continue
        if r["status"] == "fail":
            rows.append([key, "FAIL", "-", "-", "-", "-", "-", "-", "-"])
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
            "yes" if r["memory"]["fits"] else "no",
        ])
        out[key] = dict(rl, peak_gib=r["memory"]["peak_device_bytes"] / 2**30,
                        fits=r["memory"]["fits"], chips=r["chips"],
                        collective_bytes=r["collective_bytes"],
                        note=note_for(r))
    links = ("no collectives on one card" if mesh == "single" else
             "collectives at 450 GB/s NVLink in a node, 50 GB/s NDR across")
    print(f"Roofline — mesh={mesh}{' tag=' + tag if tag else ''} "
          f"(terms in ms/step/device; H100: 989 TFLOP/s bf16, 3.35 TB/s "
          f"HBM, {links})")
    print(table(["arch×shape", "t_comp", "t_mem", "t_coll", "dominant",
                 "useful", "roofline", "GiB/dev", "fits"], rows))
    save_result(f"roofline_{mesh}{('_' + tag) if tag else ''}", out)
    return out


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mesh_pos", nargs="?", default=None)
    ap.add_argument("tag_pos", nargs="?", default="")
    ap.add_argument("--mesh", default=None,
                    choices=["single", "pod", "multi"])
    ap.add_argument("--tag", default=None)
    args = ap.parse_args(argv)
    return run(args.mesh or args.mesh_pos or "single",
               args.tag if args.tag is not None else args.tag_pos)


if __name__ == "__main__":
    main()
