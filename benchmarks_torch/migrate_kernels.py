#!/usr/bin/env python3
"""K3 (the counting scatter) on one NVIDIA card, at the shapes its paths
give it, and the sort/scatter crossover of the manifest build.

Times are ms a wrapper call, three ways: ``events`` (CUDA events around
back-to-back calls), ``device`` (the sum of every kernel, memset and copy
a call issues, ``torch.profiler``) and ``host`` (a perf_counter around
back-to-back calls that are not waited for).

Sections:

  * ``pic``: ``n = 2^24`` owners over C = 8 PEs of the PIC path's initial
    particles (a random chare → PE map of the 12 x 12 chares), in the
    initial order and bucketed (the same owners after a stable sort, as an
    exchange leaves them), through the public wrapper, beside the plain
    version, ``torch.argsort(stable=True)`` and the bounds (8 and 12
    bytes an item at 3.35 TB/s).  Every output is checked exact.
  * ``forms`` (with ``--forms``): each form forced at C = 8 ... 256 (small
    against shared, both orders, n = 2^24) and C = 1024 ... 8192 (shared
    against radix digits, n = 2^20 and 2^24): the measurements behind
    ``SMALL_MAX_C`` and ``SHARED_MAX_C``.
  * ``crossover`` (with ``--crossover``): ``build_manifest`` with
    ``method="scatter"`` against ``method="sort"`` at n in {2^12, 2^16,
    2^20, 2^24} and C in {2, 8, 64, 256, 1024, 4096}, random owners; the
    two manifests must be identical.
  * ``spill`` (with ``--spill``): ``spill_owner`` over 2^20 items at 64
    and 257 nodes (4096 and 66049 pair buckets; half the items moving to
    the first half of the nodes, a budget of 1.25 n / P), and its ranks
    alone, beside one C = 8 scatter of 2^20 items.

``--src DIR`` imports the port from another checkout's ``src`` (a parent
commit, for a before-and-after in one call; only ``pic`` runs there).

Run from the repository root:
    python3 benchmarks_torch/migrate_kernels.py --forms --crossover --spill
It needs a card and fails without one.  The rows are also written as JSON
to ``--out`` (default ``artifacts/migrate_kernels.json``).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)


def events_ms(fn, reps: int = 50) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_by_name(fn, reps: int = 20) -> dict:
    """ms a call of each kernel, memset and copy ``fn`` issues (its
    device time, ``torch.profiler``), by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    skip = ("Activity Buffer Request", "Buffer Flush")
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name not in skip:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0][-48:]
            out[name] = out.get(name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / reps
    return out


def device_ms(fn, reps: int = 20) -> float:
    return sum(device_by_name(fn, reps).values())


def host_ms(fn, reps: int = 50) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / reps


def three(fn, reps: int = 50) -> dict:
    return dict(events_ms=events_ms(fn, reps), device_ms=device_ms(fn),
                host_ms=host_ms(fn, reps))


def bounds_ms(n: int) -> dict:
    return {"bound_8B_ms": 1e3 * 8 * n / PEAK_BYTES_PER_S,
            "floor_12B_ms": 1e3 * 12 * n / PEAK_BYTES_PER_S}


def pic_owners(n: int = 1 << 24, P: int = 8):
    """Owners of the PIC path's initial particles under a random chare →
    PE map (seed 0), initial order and bucketed."""
    import numpy as np
    import torch
    from repro_torch.pic import chares
    from repro_torch.pic.particles import initialize

    L, cx, cy = 1000, 12, 12
    p = initialize("GEOMETRIC", L, n, k=2, vy0=1.0, rho=0.9, seed=0)
    x, y = (torch.as_tensor(a, device="cuda") for a in (p.x, p.y))
    ids = chares.chare_of_device(x, y, L, cx, cy)
    amap = torch.as_tensor(np.random.default_rng(0).integers(0, P, cx * cy),
                           dtype=torch.int32, device="cuda")
    owner = amap[ids.long()].contiguous()
    return owner, owner[torch.argsort(owner, stable=True)].contiguous()


def check_exact(mops, ref, ids, C) -> bool:
    import torch

    d, c, off = mops.scatter_dest(ids, C=C)
    dr, cr = ref.scatter_dest_ref(ids, C=C)
    offr = torch.cat([cr.new_zeros(1), torch.cumsum(cr, 0,
                                                    dtype=torch.int32)])
    inv = torch.empty_like(d)
    inv[d.long()] = torch.arange(ids.shape[0], dtype=torch.int32,
                                 device=ids.device)
    return bool(torch.equal(d, dr) and torch.equal(c, cr)
                and torch.equal(off, offr)
                and torch.equal(inv.long(), torch.argsort(ids, stable=True)))


def pic_rows():
    import torch
    from repro_torch.kernels.migrate import ops as mops
    from repro_torch.kernels.migrate import ref

    C = 8
    rows = []
    for order, ids in zip(("initial", "bucketed"), pic_owners()):
        n = ids.shape[0]
        row = dict(kernel="K3", case=f"n=2^24, C={C}, {order} order",
                   form=(mops.scatter_form(n, C)
                         if hasattr(mops, "scatter_form") else "one"),
                   exact=check_exact(mops, ref, ids, C),
                   **three(lambda: mops.scatter_dest(ids, C=C)),
                   device_by_kernel=device_by_name(
                       lambda: mops.scatter_dest(ids, C=C)),
                   plain_ms=events_ms(lambda: ref.scatter_dest_ref(ids, C=C),
                                      reps=3),
                   argsort_ms=events_ms(lambda: torch.argsort(ids,
                                                              stable=True)),
                   **bounds_ms(n))
        rows.append(row)
    return rows


def form_rows():
    import numpy as np
    import torch
    from repro_torch.kernels.migrate import ops as mops
    from repro_torch.kernels.migrate import ref

    rows = []

    def case(label, ids, C, fn):
        d, c = fn()[:2]
        if ids.shape[0] * C <= 1 << 28:
            dr, cr = ref.scatter_dest_ref(ids, C=C)
            exact = bool(torch.equal(d, dr) and torch.equal(c, cr))
        else:
            inv = torch.empty_like(d)
            inv[d.long()] = torch.arange(ids.shape[0], dtype=torch.int32,
                                         device="cuda")
            exact = bool(torch.equal(inv.long(),
                                     torch.argsort(ids, stable=True)))
        rows.append(dict(kernel="K3", case=label, exact=exact, **three(fn)))
        print(json.dumps(rows[-1]), flush=True)

    n = 1 << 24
    rng = np.random.default_rng(0)
    for C in (8, 16, 32, 64, 128, 256):
        ids = torch.as_tensor(rng.integers(0, C, n), dtype=torch.int32,
                              device="cuda")
        for order, i in (("random", ids),
                         ("bucketed", ids[torch.argsort(ids, stable=True)])):
            for form in ("small", "shared"):
                if form == "small" and C > 226:
                    continue
                case(f"n=2^24, C={C}, {order}, {form}", i, C,
                     lambda: mops._one_pass(i, C, form))
    for n in (1 << 20, 1 << 24):
        for C in (1024, 2048, 4096, 8192):
            ids = torch.as_tensor(rng.integers(0, C, n), dtype=torch.int32,
                                  device="cuda")
            if C <= 6400:
                case(f"n=2^{n.bit_length() - 1}, C={C}, random, shared", ids,
                     C, lambda: mops._one_pass(ids, C, "shared"))
            for limit in (64, 256, 1024):
                bases = mops.digit_bases(C, limit)
                case(f"n=2^{n.bit_length() - 1}, C={C}, random, radix "
                     f"{bases}", ids, C,
                     lambda: mops.scatter_by_digits(
                         ids, C, bases, mops._digit_pass, mops._count))
    return rows


def crossover_rows():
    import numpy as np
    import torch
    from repro_torch.runtime import migrate as rt

    rows = []
    rng = np.random.default_rng(1)
    for n in (1 << 12, 1 << 16, 1 << 20, 1 << 24):
        for C in (2, 8, 64, 256, 1024, 4096):
            old = torch.as_tensor(rng.integers(0, C, n), dtype=torch.int32,
                                  device="cuda")
            new = torch.where(torch.as_tensor(rng.random(n) < 0.3,
                                              device="cuda"),
                              torch.as_tensor(rng.integers(0, C, n),
                                              dtype=torch.int32,
                                              device="cuda"), old)
            ms = rt.build_manifest(old, new, C, method="scatter")
            mo = rt.build_manifest(old, new, C, method="sort")
            same = all(torch.equal(getattr(ms, f), getattr(mo, f))
                       for f in ("order", "offsets", "send_counts", "moved"))
            rows.append(dict(
                n=n, C=C, identical=same,
                scatter_ms=events_ms(lambda: rt.build_manifest(
                    old, new, C, method="scatter"), reps=10),
                sort_ms=events_ms(lambda: rt.build_manifest(
                    old, new, C, method="sort"), reps=10)))
            print(json.dumps(rows[-1]), flush=True)
    return rows


def spill_rows():
    import numpy as np
    import torch
    from repro_torch.kernels.migrate import ops as mops
    from repro_torch.runtime import migrate as rt

    n = 1 << 20
    rng = np.random.default_rng(2)
    rows = []
    ids = torch.as_tensor(rng.integers(0, 8, n), dtype=torch.int32,
                          device="cuda")
    rows.append(dict(case="scatter, n=2^20, C=8",
                     **three(lambda: mops.scatter_dest(ids, C=8))))
    for P in (64, 257):
        # slab order; half the items move to the first half of the nodes,
        # whose budget of 1.25 n / P then defers some (as chip_smoke.py)
        old = torch.as_tensor((np.arange(n) * P) // n, dtype=torch.int32,
                              device="cuda")
        new = torch.where(torch.as_tensor(rng.random(n) < 0.5,
                                          device="cuda"),
                          torch.as_tensor(rng.integers(0, P // 2, n),
                                          dtype=torch.int32, device="cuda"),
                          old)
        cap = int(1.25 * n / P)
        keys = torch.where(new != old, old * P + new, P * P)
        rows.append(dict(
            case=f"spill_owner, n=2^20, {P} nodes (C={P * P}, "
                 f"{mops.scatter_form(n, P * P)})",
            deferred=int(rt.spill_owner(old, new, num_nodes=P,
                                        capacity=cap)[1].sum()),
            **three(lambda: rt.spill_owner(old, new, num_nodes=P,
                                           capacity=cap), reps=10),
            bucket_ranks=three(lambda: mops.bucket_ranks(keys, C=P * P),
                               reps=10)))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "artifacts" / "migrate_kernels.json")
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the checkout's src directory to import the port "
                    "from")
    ap.add_argument("--forms", action="store_true")
    ap.add_argument("--crossover", action="store_true")
    ap.add_argument("--spill", action="store_true")
    args = ap.parse_args()
    sys.path[:0] = [str(args.src.resolve())]
    import torch

    if not torch.cuda.is_available():
        print("migrate_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"port from {args.src.resolve()}")
    kernels.build_all()
    out = dict(device=smi, src=str(args.src.resolve()), pic=pic_rows())
    for r in out["pic"]:
        print(json.dumps(r), flush=True)
    if args.forms:
        out["forms"] = form_rows()
    if args.crossover:
        out["crossover"] = crossover_rows()
    if args.spill:
        out["spill"] = spill_rows()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    bad = [r["case"] for rows in out.values() if isinstance(rows, list)
           for r in rows if r.get("exact") is False
           or r.get("identical") is False]
    if bad:
        print(f"migrate_kernels: not exact: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
