#!/usr/bin/env python3
"""K1 (the fused diffusion chunk) and K4 (the chare histogram) on one
NVIDIA card, at the shapes their paths give them.

For each case it prints the mean time of a wrapper call three ways:

  * ``events``: CUDA events around back-to-back calls (what a caller
    waits for when the calls queue; the host's work when it is longer);
  * ``device``: the device time of a call, the sum of every kernel,
    memset and copy the call issues (``torch.profiler``);
  * ``host``: the host's time to issue a call (a perf_counter around
    back-to-back calls that are not waited for).

K4: ``n = 2^24`` chare ids of the PIC path's initial GEOMETRIC particles
(L = 1000, 12 x 12 chares) with ones, in the initial order and bucketed
by PE as after an exchange (a stable sort by the first plan's owner), and
the same particles over 24 x 24 chares (C = 576, the shared form), beside
``torch.bincount``, and ``torch.sum`` of the weights as a yardstick of
read bandwidth; with f32 weights it reports whether two calls agree bit
for bit.  K1: one S = 8 chunk from the initial carry at the PIC path's
P = 8, K = 4 (the first plan's neighbour graph) and on periodic grid
graphs at P = 8192 and 32768, K = 8, in the form the wrapper selects and,
where the wrapper has several, in each form.  With ``--sim`` it also
times stage 2 of the simulator path's first fired plan (stencil-wave,
2^20 objects, 8192 nodes, k = 8) through the selected chunk and through
the streaming one, and runs the replay (30 steps, LB every 10) to print
its fire steps and a SHA-256 of its final assignment.

Run from the repository root:  python3 benchmarks_torch/lb_kernels.py
It needs a card and fails without one.  The rows are also written as JSON
to ``--out`` (default ``artifacts/lb_kernels.json``).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks_torch.diffusion_crossover import grid_graph  # noqa: E402

PIC = dict(L=1000, n=1 << 24, cx=12, cy=12, num_pes=8, rho=0.9)


def events_ms(fn, reps: int = 50) -> float:
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


def device_ms(fn, reps: int = 20) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    skip = ("Activity Buffer Request", "Buffer Flush")
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA and e.name not in skip)
    return us / 1e3 / reps


def host_ms(fn, reps: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / reps


def three(fn) -> dict:
    return dict(events_ms=events_ms(fn), device_ms=device_ms(fn),
                host_ms=host_ms(fn))


def pic_inputs():
    """The PIC path's chare ids in both orders, the first plan's stage-2
    inputs (node loads, neighbour table, mask), and the same particles'
    ids over 24 x 24 chares (C = 576, the histogram's shared form) in both
    orders (bucketed by a striped owner of 8 PEs)."""
    from repro_torch.core import comm_graph, engine
    from repro_torch.core import neighbor_selection as ns
    from repro_torch.kernels.histogram.ops import histogram
    from repro_torch.pic import chares
    from repro_torch.pic.particles import initialize

    L, C, P = PIC["L"], PIC["cx"] * PIC["cy"], PIC["num_pes"]
    p = initialize("GEOMETRIC", L, PIC["n"], k=2, vy0=1.0, rho=PIC["rho"],
                   seed=0)
    x, y = (torch.as_tensor(a, device="cuda") for a in (p.x, p.y))
    ids = chares.chare_of_device(x, y, L, PIC["cx"], PIC["cy"])
    problem = chares.build_problem(
        histogram(ids, torch.ones_like(x), C=C), torch.as_tensor(
            chares.initial_mapping(PIC["cx"], PIC["cy"], P), device="cuda"),
        L=L, cx=PIC["cx"], cy=PIC["cy"], num_pes=P, k=2, vy0=1.0,
        lb_period=10)
    planned, _ = engine.get_strategy("diff-comm").bind(k=4)(problem)
    ids_x = ids[torch.argsort(planned[ids.long()], stable=True)]
    nres = ns.select_neighbors(
        ns.comm_preference(comm_graph.node_comm_matrix(problem)), k=4)
    wide = chares.chare_of_device(x, y, L, 24, 24)
    owner = torch.as_tensor(chares.initial_mapping(24, 24, P), device="cuda")
    wide_x = wide[torch.argsort(owner[wide.long()], stable=True)]
    return (ids, ids_x, (comm_graph.node_loads(problem), nres.nbr_idx,
                         nres.nbr_mask), (wide, wide_x))


def k4_rows(ids, ids_x, wide):
    from repro_torch.kernels.histogram import ops as hops
    from repro_torch.kernels.histogram.ref import histogram_ref

    w = torch.ones(ids.shape[0], device="cuda")
    wf = torch.rand(ids.shape[0], device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    rows = []
    C0 = PIC["cx"] * PIC["cy"]
    cases = [(C0, "initial", ids), (C0, "after an exchange", ids_x),
             (576, "initial", wide[0]), (576, "after an exchange", wide[1])]
    for C, order, i in cases:
        exact = torch.equal(hops.histogram(i, w, C=C),
                            histogram_ref(i, w, C=C))
        repeat = torch.equal(hops.histogram(i, wf, C=C),
                             hops.histogram(i, wf, C=C))
        rows.append(dict(
            kernel="K4", case=f"n=2^24, C={C}, {order} order", exact=exact,
            float_repeatable=repeat,
            **three(lambda: hops.histogram(i, w, C=C)),
            bincount_ms=events_ms(lambda: torch.bincount(i, weights=w,
                                                         minlength=C))))
    return rows


def k1_carry(nl, nbr, mask):
    from repro_torch.core import virtual_lb as vlb

    P, K = nbr.shape
    rev = vlb.reverse_slots(nbr, mask)
    alpha = float(torch.tensor(1.0 / (K + 1.0), dtype=torch.float32))
    carry = (nl, nl, torch.zeros((P, K), device="cuda"),
             torch.zeros((), dtype=torch.int32, device="cuda"),
             vlb.neighborhood_residual(nl, nbr, mask),
             torch.zeros((), dtype=torch.int32, device="cuda"))
    return (*carry, nbr, mask, rev, alpha)


def k1_rows(pic_graph):
    from repro_torch.kernels.diffusion import ops as dops

    kw = dict(n_sweeps=8, single_hop=True, tol=0.02, max_iters=512)
    cases = [("P=8, K=4 (PIC path)", pic_graph)]
    for P in (8192, 32768):
        nbr = torch.as_tensor(grid_graph(P, 8), device="cuda")
        nl = torch.as_tensor(np.random.default_rng(P).random(P).astype(
            np.float32) * 100, device="cuda")
        cases.append((f"P={P}, K=8", (nl, nbr, torch.ones_like(
            nbr, dtype=torch.bool))))
    # a tree whose K1 has a single one-block form has no K1_FORMS; the
    # script measures it too, for a before-and-after in one call
    forms = getattr(dops, "K1_FORMS", ())
    rows = []
    for label, (nl, nbr, mask) in cases:
        args = k1_carry(nl, nbr.to(torch.int32), mask)
        P, K = nbr.shape
        out = dops.fused_nsweeps(*args, **kw)
        row = dict(kernel="K1", case=label, sweeps=int(out[3]),
                   selected=(dops.k1_form(P, K) if forms else "one block"),
                   **three(lambda: dops.fused_nsweeps(*args, **kw)))
        for form in forms:
            if dops.k1_takes(form, P, K):
                got = dops._fused_form(form, *args, **kw)
                row[form] = dict(
                    it_stall=(int(got[3]), int(got[5])),
                    **three(lambda: dops._fused_form(form, *args, **kw)))
        rows.append(row)
    return rows


def sim_stage2():
    """Stage 2 of the simulator path's first fired plan, through the
    selected chunk and through the streaming one (seconds, synchronized,
    second of two calls)."""
    from repro_torch.core import comm_graph
    from repro_torch.core import neighbor_selection as ns
    from repro_torch.core import virtual_lb as vlb
    from repro_torch.kernels.diffusion import ops as dops
    from repro_torch.sim import scenarios, simulator

    problem, evolve = scenarios.get("stencil-wave").instantiate(
        device="cuda", grid=1024, num_nodes=8192, mapping="tiled")
    snap = evolve(problem, 10)
    nres = ns.select_neighbors(
        ns.comm_preference(comm_graph.node_comm_matrix(snap)), k=8)
    args = (comm_graph.node_loads(snap), nres.nbr_idx, nres.nbr_mask)
    out = {}
    for name, fn in (("selected", dops.diffusion_nsweeps),
                     ("streaming", dops.streaming_nsweeps)):
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = vlb.virtual_balance(*args, chunk_fn=fn)
            torch.cuda.synchronize()
            t = time.perf_counter() - t0
        out[name] = dict(seconds=t, iters=int(r.iters))
    out["impl"] = dops.sweep_impl(8192, 8, "cuda")
    # the replay itself: its fire steps and a digest of its final
    # assignment (equal digests: equal assignments)
    res = simulator.run_series(problem, evolve, steps=30, lb_every=10,
                               strategy="diff-comm",
                               strategy_kwargs={"k": 8})
    out["replay_fired"] = np.nonzero(res.lb_fired)[0].tolist()
    out["replay_assignment_sha256"] = hashlib.sha256(np.ascontiguousarray(
        res.final_assignment).tobytes()).hexdigest()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "artifacts" / "lb_kernels.json")
    ap.add_argument("--sim", action="store_true",
                    help="also time stage 2 of the simulator path's plan")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lb_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    kernels.build_all()
    ids, ids_x, pic_graph, wide = pic_inputs()
    rows = k4_rows(ids, ids_x, wide) + k1_rows(pic_graph)
    # a read yardstick for K4: torch.sum over the 64 MB of f32 weights
    w = torch.ones(ids.shape[0], device="cuda")
    rows.append(dict(kernel="yardstick", case="torch.sum of 2^24 f32",
                     device_ms=device_ms(lambda: w.sum())))
    for r in rows:
        print(json.dumps(r))
    out = dict(device=smi, rows=rows)
    if args.sim:
        out["sim_stage2"] = sim_stage2()
        print(json.dumps(out["sim_stage2"]))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    bad = [r["case"] for r in rows if r["kernel"] == "K4"
           and not r["exact"]]
    if bad:
        print(f"lb_kernels: K4 not exact with ones: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
