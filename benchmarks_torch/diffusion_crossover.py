#!/usr/bin/env python3
"""Where each form of the fused diffusion kernel K1 pays, on one NVIDIA
card: the measurement behind ``kernels/diffusion/ops.py`` ``WARP_MAX_PK``,
``BLOCK_MAX_PK`` and ``FUSED_MAX_PK``.

For K in {4, 8} and P in {8, 32, 128, 512, 1024, ..., 131072} nodes, and
at K = 8 on to P = 2^20 (P K = 2^23, past ``FUSED_MAX_PK``), on a
periodic 2D grid graph (K = 4: the four edge neighbours; K = 8: the Moore
neighbourhood), with loads drawn from a seed, it times one S = 8 chunk from
the initial carry (all eight sweeps active) of

  * each form of K1 (``csrc/diffusion.cu``) that takes the shape: ``warp``
    and ``block`` (one block, state in shared memory) and ``grid`` (a
    cooperative launch, state in L2);
  * ``streaming``: the streaming sweep kernel (``csrc/diffusion_sweep.cu``)
    once a sweep inside the plain masked chunk body, replayed from a CUDA
    graph (``ops.streaming_nsweeps``);
  * ``eager``: the same chunk issued op by op from Python
    (``reference_nsweeps(step_fn=ops.diffusion_sweep)``, what an explicit
    ``LBEngine(step_fn=...)`` runs);

and one sweep of the streaming kernel and of its plain version.  Times are
CUDA-event means over ``--reps`` calls after a warm-up (what a caller waits
for, the wrapper's host work where that is longer); each K1 form also
with its device time (``torch.profiler``, the sum of its kernel), the
streaming chunk and the sweep with theirs (CUDA events around calls
queued behind a sleep kernel, ``common.queued_device_ms``).  It checks that
every chunk ends on the same ``it`` and ``stall`` (and the two streaming
ones on the same bits) and prints which form ``k1_form`` and which path
``sweep_impl`` pick.  Prints the card's name and power limit and a table;
writes the rows as JSON to ``--out``.

Run from the repository root on a machine with one card:
``python3 benchmarks_torch/diffusion_crossover.py --out
diffusion_crossover.json``.  It needs a card and fails without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks_torch.common import (event_ms as time_ms,  # noqa: E402
                                     queued_device_ms, table)

# P for both K, then the K = 8 sizes past K1's limit
SIZES = (8, 32, 128, *(512 << i for i in range(9)))
WIDE = (1 << 18, 1 << 19, 1 << 20)


def grid_graph(P: int, K: int):
    """(P, K) neighbour table of a periodic a × b grid (a·b = P)."""
    a = 1 << (P.bit_length() - 1) // 2
    b = P // a
    ii, jj = np.meshgrid(np.arange(a), np.arange(b), indexing="ij")
    if K == 4:
        offs = ((-1, 0), (1, 0), (0, -1), (0, 1))
    elif K == 8:
        offs = tuple((di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)
                     if (di, dj) != (0, 0))
    else:
        raise ValueError(f"K = 4 or 8, got {K}")
    nb = [((ii + di) % a) * b + (jj + dj) % b for di, dj in offs]
    return np.stack([c.ravel() for c in nb], 1).astype(np.int32)


def device_ms(fn, reps: int) -> float:
    """Device time of a call: the sum of its kernels' intervals under
    ``torch.profiler``, over ``reps`` calls after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA and "_kernel" in e.name)
    return us / 1e3 / reps


def measure(P: int, K: int, reps: int):
    from repro_torch.core import virtual_lb as vlb
    from repro_torch.kernels.diffusion import ops as dops
    from repro_torch.kernels.diffusion.ref import diffusion_sweep_ref

    dev = "cuda"
    nbr = torch.as_tensor(grid_graph(P, K), device=dev)
    mask = torch.ones_like(nbr, dtype=torch.bool)
    rev = vlb.reverse_slots(nbr, mask)
    x = torch.as_tensor(
        np.random.default_rng(P + K).random(P).astype(np.float32) * 100,
        device=dev)
    alpha = float(torch.tensor(1.0 / (K + 1.0), dtype=torch.float32))
    carry = (x, x, torch.zeros((P, K), device=dev),
             torch.zeros((), dtype=torch.int32, device=dev),
             vlb.neighborhood_residual(x, nbr, mask),
             torch.zeros((), dtype=torch.int32, device=dev))
    kw = dict(n_sweeps=8, single_hop=True, tol=0.02, max_iters=512)
    args = (*carry, nbr, mask, rev, alpha)

    def streaming():
        return dops.streaming_nsweeps(*args, **kw)

    def eager():
        return vlb.reference_nsweeps(*args, **kw,
                                     step_fn=dops.diffusion_sweep)

    s, e = streaming(), eager()
    stat = (int(s[3]), int(s[5]))
    same = all(torch.equal(a, b) for a, b in zip(s, e))
    row = dict(P=P, K=K, sweeps=stat[0])
    for form in dops.K1_FORMS:
        if not dops.k1_takes(form, P, K):
            row[f"{form}_ms"] = row[f"{form}_device_ms"] = None
            continue
        f = dops._fused_form(form, *args, **kw)
        same &= (int(f[3]), int(f[5])) == stat
        row[f"{form}_ms"] = time_ms(lambda: dops._fused_form(
            form, *args, **kw), reps)
        row[f"{form}_device_ms"] = device_ms(lambda: dops._fused_form(
            form, *args, **kw), reps)
    sw = (x, x, nbr, mask, rev, alpha, True)
    row.update(
        agree=same, streaming_ms=time_ms(streaming, reps),
        # few calls: a chunk's graph replay fills the launch queue
        streaming_device_ms=queued_device_ms(streaming, 4),
        eager_ms=time_ms(eager, max(2, reps // 4)),
        sweep_ms=time_ms(lambda: dops.diffusion_sweep(*sw), reps),
        sweep_device_ms=queued_device_ms(
            lambda: dops.diffusion_sweep(*sw), reps),
        plain_sweep_ms=time_ms(lambda: diffusion_sweep_ref(*sw), reps),
        form=dops.k1_form(P, K), picks=dops.sweep_impl(P, K, dev))
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="artifacts/diffusion_crossover.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("diffusion_crossover: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    kernels.build_all()
    rows = [measure(P, K, args.reps) for K in (4, 8)
            for P in SIZES + (WIDE if K == 8 else ())]

    def ms(v):
        return "-" if v is None else f"{v:.4f}"

    print(table(["K", "P", "sweeps", "warp ms", "block ms", "grid ms",
                 "warp dev", "block dev", "grid dev",
                 "streaming ms", "streaming dev", "eager ms", "K2 sweep ms",
                 "K2 sweep dev", "plain sweep ms",
                 "k1_form", "sweep_impl", "agree"],
                [[r["K"], r["P"], r["sweeps"], ms(r["warp_ms"]),
                  ms(r["block_ms"]), ms(r["grid_ms"]),
                  ms(r["warp_device_ms"]), ms(r["block_device_ms"]),
                  ms(r["grid_device_ms"]),
                  ms(r["streaming_ms"]), ms(r["streaming_device_ms"]),
                  ms(r["eager_ms"]), ms(r["sweep_ms"]),
                  ms(r["sweep_device_ms"]), ms(r["plain_sweep_ms"]),
                  r["form"],
                  r["picks"], r["agree"]] for r in rows]))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(device=smi, rows=rows), indent=1))
    if not all(r["agree"] for r in rows):
        print("diffusion_crossover: the chunks disagree", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
