#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the five CUDA kernels from ``src/repro_torch/csrc``, then:

  1. drives the PIC path — the PIC PRK driver with the diff-comm balancer
     (``repro_torch.pic.driver.run``) at the paper's setup (L = 1000, 12×12
     chares, GEOMETRIC ρ = 0.9, 8 PEs), 2^24 particles, 100 steps, LB every
     10 — with every launch count set to 0 just before and read just after,
     and checks its invariants against a ``strategy="none"`` run of the
     same configuration;
  2. checks a small PIC run on the card against the same run on the CPU
     (plain PyTorch versions);
  3. drives the simulator path — ``repro_torch.sim.simulator.run_series``
     on the ``stencil-wave`` scenario at grid 1024 × 1024 (2^20 objects,
     5-point edges) over 8192 nodes tiled 64 × 128, diff-comm k = 8, 30
     steps, LB every 10 — with the launch counts set to 0 just before and
     read just after, and checks it against a ``strategy="none"`` replay;
  4. plans the first fired step's snapshot through
     ``LBEngine(step_fn=ops.diffusion_sweep)`` and the default engine, and
     stage 2 through the streaming kernel against the fused one;
  5. runs the port's Table I and Fig 2 scripts on the card, and a small
     replay on the card against the same replay on the CPU;
  6. holds each kernel against its plain PyTorch version on the card at the
     shapes its path gives it (and the fused diffusion kernel also at
     P = 32768, K = 8), timing kernel, plain version and the one-call
     PyTorch yardstick where there is one.

It prints the card's name and power limit, one JSON line of per-kernel
numbers, and as its last line ``{"ok": true, "device": {...}}``.  Any
failed check raises, so the script exits non-zero and prints no result.
It exits non-zero at once where ``torch.cuda.is_available()`` is False.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12       # also used for the kernels' 32-bit integer ops

PIC = dict(L=1000, n_particles=1 << 24, steps=100, cx=12, cy=12,
           num_pes=8, rho=0.9, mode="GEOMETRIC", lb_every=10,
           strategy="diff-comm", strategy_kwargs={"k": 4})
PIC_KERNELS = ("diffusion_nsweeps", "histogram", "pic_push", "scatter_dest")

# the simulator path: stencil-wave at 2^20 objects over 8192 nodes
SIM_SCENARIO = dict(grid=1024, num_nodes=8192, mapping="tiled")
SIM = dict(steps=30, lb_every=10, strategy="diff-comm",
           strategy_kwargs={"k": 8})
SIM_KERNELS = ("diffusion_sweep",)
DEV = "cuda"   # the card; a rehearsal on the CPU sets "cpu"


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str):
    if not cond:
        fail(msg)


def time_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs (CUDA events),
    after one warm-up run."""
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


def bound_ms(nbytes: float, ops: float, peak_ops=PEAK_F32_PER_S):
    tb, to = nbytes / PEAK_BYTES_PER_S, ops / peak_ops
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def spacing(v) -> float:
    """f32 spacing at max |v| (one ulp there)."""
    import torch

    s = v.abs().max()
    return float(torch.nextafter(s, s + 1) - s)


# ------------------------------------------------------------ main path --


def main_path():
    import numpy as np
    from repro_torch import kernels
    from repro_torch.pic import chares, driver

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = driver.run(driver.PICConfig(**PIC, device="cuda"))
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    print(f"PIC path: {PIC['n_particles']} particles, {PIC['steps']} steps "
          f"in {wall:.3f} s end to end ({res.wall_seconds:.3f} s step loop, "
          f"{PIC['steps'] / res.wall_seconds:.2f} steps/s); launches "
          f"{counts}")
    for name in PIC_KERNELS:
        check(counts[name] > 0, f"kernel {name} was not launched on the PIC "
              "path")

    N = PIC["n_particles"]
    fx, fy = res.final_x, res.final_y
    check(fx.shape == (N,) and fy.shape == (N,), "particles not conserved")
    check(np.isfinite(fx).all() and np.isfinite(fy).all(),
          "non-finite positions")
    check(((fx >= 0) & (fx <= PIC["L"]) & (fy >= 0)
           & (fy <= PIC["L"])).all(), "positions left the grid")
    import torch

    xt = torch.as_tensor(fx, device="cuda")
    yt = torch.as_tensor(fy, device="cuda")
    from repro_torch.kernels.histogram.ops import histogram

    loads = histogram(chares.chare_of_device(xt, yt, PIC["L"], PIC["cx"],
                                             PIC["cy"]),
                      torch.ones_like(xt), C=PIC["cx"] * PIC["cy"])
    check(float(loads.sum()) == N, f"chare loads sum to {float(loads.sum())}"
          f", not {N}")
    fired = int(res.lb_steps.sum())
    check(fired == (PIC["steps"] - 1) // PIC["lb_every"],
          f"LB fired {fired} times")
    check(res.migrated_bytes.sum() > 0, "no particle was migrated")

    none = driver.run(driver.PICConfig(**{**PIC, "strategy": "none"},
                                       device="cuda"))
    bal, ref = res.summary()["mean_max_avg"], none.summary()["mean_max_avg"]
    print(f"mean max/avg: diff-comm {bal:.6f} vs none {ref:.6f}; migrated "
          f"{res.migrated_bytes.sum():.0f} B over {fired} rebalances")
    check(bal < ref, "diff-comm did not lower mean max/avg below none")
    return counts, res


def cpu_parity():
    """A small PIC run on the card equals the same run on the CPU."""
    import numpy as np
    from repro_torch.pic import driver

    small = dict(L=100, n_particles=4000, steps=40, cx=8, cy=8, num_pes=4,
                 lb_every=10, strategy="diff-comm")
    g = driver.run(driver.PICConfig(**small, device="cuda"))
    c = driver.run(driver.PICConfig(**small, device="cpu"))
    for f in ("lb_steps", "migrations", "migrated_bytes", "ext_bytes",
              "int_bytes", "max_avg"):
        check(np.array_equal(getattr(g, f), getattr(c, f)),
              f"small PIC run: {f} differs between cuda and cpu")
    err = max(np.abs(g.final_x - c.final_x).max(),
              np.abs(g.final_y - c.final_y).max())
    check(err <= 1e-3, f"small PIC run: positions differ by {err}")
    print(f"small PIC run on cuda == cpu (positions within {err:.3g})")


# ------------------------------------------------------- simulator path --


def _sync():
    import torch

    if DEV == "cuda":
        torch.cuda.synchronize()


def sim_path():
    """The stencil-wave replay at full size; returns its launch counts and
    the snapshot of its first fired step (the initial assignment)."""
    import numpy as np
    from repro_torch import kernels
    from repro_torch.kernels.diffusion import ops as dops
    from repro_torch.sim import scenarios, simulator

    problem, evolve = scenarios.get("stencil-wave").instantiate(
        device=DEV, **SIM_SCENARIO)
    P, K = SIM_SCENARIO["num_nodes"], SIM["strategy_kwargs"]["k"]
    N = SIM_SCENARIO["grid"] ** 2
    print(f"sweep_impl({P}, {K}) = {dops.sweep_impl(P, K, DEV)!r} (the "
          f"fused kernel up to P*K = {dops.FUSED_MAX_PK})")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = simulator.run_series(problem, evolve, **SIM)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    fired = np.nonzero(res.lb_fired)[0].tolist()
    plan_s = [float(res.plan_step_seconds[t]) for t in fired]
    print(f"simulator path: stencil-wave, {N} objects, {P} nodes, "
          f"{SIM['steps']} steps in {wall:.3f} s end to end "
          f"({res.wall_seconds:.3f} s replay loop); fired at steps {fired}, "
          f"plan seconds {plan_s}; launches {counts}")
    for name in SIM_KERNELS:
        check(counts[name] > 0, f"kernel {name} was not launched on the "
              "simulator path")
    check(res.scanned, "the replay did not take the device-resident loop")
    check(fired == [10, 20], f"LB fired at steps {fired}, not [10, 20]")
    check(np.isfinite(res.max_avg).all() and np.isfinite(res.ext_int).all()
          and np.isfinite(res.migrated_load).all(), "non-finite records")
    fa = res.final_assignment
    check(fa.shape == (N,) and fa.min() >= 0 and fa.max() < P,
          "final assignment out of range")
    check((res.migrations[fired] > 0).all(), "a fired plan moved nothing")
    none = simulator.run_series(problem, evolve,
                                **{**SIM, "strategy": "none"})
    for t in fired:
        check(res.max_avg[t] < none.max_avg[t],
              f"step {t}: max/avg {res.max_avg[t]} not below none's "
              f"{none.max_avg[t]}")
    print("max/avg at the fired steps: diff-comm "
          f"{[float(res.max_avg[t]) for t in fired]} vs none "
          f"{[float(none.max_avg[t]) for t in fired]}; ext/int "
          f"{[float(res.ext_int[t]) for t in fired]} vs "
          f"{[float(none.ext_int[t]) for t in fired]}; moved "
          f"{[float(res.migrations[t]) for t in fired]} of the objects")
    return counts, evolve(problem, fired[0])


def sim_engines(snap):
    """Plan the snapshot through ``LBEngine(step_fn=ops.diffusion_sweep)``
    and the default engine, then stage 2 through the fused kernel against
    the streaming one; returns the stage-2 inputs ``(loads, nbr, mask)``."""
    import numpy as np
    import torch
    from repro_torch.core import comm_graph, engine, metrics
    from repro_torch.core import neighbor_selection as ns
    from repro_torch.core import object_selection as osel
    from repro_torch.core import virtual_lb as vlb
    from repro_torch.kernels.diffusion import ops as dops

    K = SIM["strategy_kwargs"]["k"]
    step = engine.LBEngine(k=K, step_fn=dops.diffusion_sweep,
                           device=DEV).plan(snap)
    default = engine.get_engine(k=K, device=DEV).plan(snap)
    print(f"full-size plan: LBEngine(step_fn=diffusion_sweep) "
          f"{step.info['plan_seconds']:.3f} s, default engine "
          f"{default.info['plan_seconds']:.3f} s; "
          f"{default.info['diffusion_iters']} sweeps, "
          f"{default.info['protocol_rounds']} handshake rounds")
    check(step.info["diffusion_iters"] == default.info["diffusion_iters"],
          "step_fn engine and default engine differ in sweeps")
    check(np.array_equal(step.assignment, default.assignment),
          "step_fn engine and default engine differ in assignment")

    def timed(fn):
        _sync()
        t0 = time.perf_counter()
        out = fn()
        _sync()
        return out, time.perf_counter() - t0

    nres, s1 = timed(lambda: ns.select_neighbors(
        ns.comm_preference(comm_graph.node_comm_matrix(snap)), k=K))
    nl = comm_graph.node_loads(snap)
    args = (nl, nres.nbr_idx, nres.nbr_mask)
    # stage 2 three ways: K1 forced, the selected streaming chunk (K2 in a
    # replayed CUDA graph), and K2 issued sweep by sweep (step_fn)
    fused, s2f = timed(lambda: vlb.virtual_balance(
        *args, chunk_fn=dops.fused_nsweeps))
    stream, s2s = timed(lambda: vlb.virtual_balance(
        *args, chunk_fn=dops.diffusion_nsweeps))
    eager, s2e = timed(lambda: vlb.virtual_balance(
        *args, step_fn=dops.diffusion_sweep))
    a_f, s3 = timed(lambda: osel.select_objects(
        snap, nres.nbr_idx, nres.nbr_mask, fused.flows).assignment)
    a_s = osel.select_objects(snap, nres.nbr_idx, nres.nbr_mask,
                              stream.flows).assignment
    print(f"stages at full size: 1 (neighbor selection) {s1:.3f} s, "
          f"{int(nres.rounds)} rounds; 2 fused {s2f:.3f} s / streaming "
          f"{s2s:.3f} s / step_fn {s2e:.3f} s; 3 (object selection) "
          f"{s3:.3f} s")
    check(all(torch.equal(a, b) for a, b in zip(stream, eager)),
          "stage 2: the graph-replayed and the step_fn streaming paths "
          "differ")
    check(int(fused.iters) == int(stream.iters),
          f"stage 2: fused {int(fused.iters)} vs streaming "
          f"{int(stream.iters)} sweeps")
    ulp = spacing(nl)
    err = max(float((fused.target_loads - stream.target_loads).abs().max()),
              float((fused.flows - stream.flows).abs().max()))
    print(f"stage 2 fused vs streaming: {int(fused.iters)} sweeps each, "
          f"max_abs_err {err:.6g} ({err / ulp:.1f} ulp of the largest "
          "load); the streaming graph and step_fn paths equal bit for bit")
    check(err <= 64 * ulp, "stage 2: fused and streaming more than 64 ulp "
          "apart")
    n_diff = int((a_f != a_s).sum())
    if n_diff:
        m_f = metrics.evaluate(snap, a_f)
        m_s = metrics.evaluate(snap, a_s)
        print(f"stage 3: assignments differ on {n_diff} objects (a float "
              f"tie); max/avg {m_f['max_avg_load']} vs "
              f"{m_s['max_avg_load']}, ext/int {m_f['ext_int_comm']} vs "
              f"{m_s['ext_int_comm']}")
        for key in ("max_avg_load", "ext_int_comm"):
            check(abs(m_f[key] - m_s[key]) <= 1e-4 * abs(m_s[key]),
                  f"stage 3: {key} differs by more than 1e-4 relative")
    else:
        print("stage 3: the fused and streaming flows give equal "
              "assignments")
    return args


def paper_scripts_and_small_replay():
    """Table I and Fig 2 on the card (their assertions hold), and a small
    replay on the card against the CPU."""
    import numpy as np
    from benchmarks_torch import fig2_stencil, table1_neighbor_count
    from repro_torch.sim import scenarios, simulator

    table1_neighbor_count.run(device=DEV)
    fig2_stencil.run(device=DEV)
    kw = dict(steps=24, lb_every=6, strategy="diff-comm")
    small = dict(grid=16, num_nodes=8)
    cpu = simulator.run_series(*scenarios.get("stencil-wave").instantiate(
        device="cpu", **small), **kw)
    for scan in (True, False):
        g = simulator.run_series(*scenarios.get("stencil-wave").instantiate(
            device=DEV, **small), scan=scan, **kw)
        for f in ("lb_fired", "final_assignment"):
            check(np.array_equal(getattr(g, f), getattr(cpu, f)),
                  f"small replay (scan={scan}): {f} differs between cuda "
                  "and cpu")
    print("small stencil-wave replay on cuda == cpu on both loops "
          f"(fired {int(cpu.lb_fired.sum())} times)")


def device_ms(fn, reps: int = 20) -> float:
    """Device time of ``fn()`` per call: the sum of its kernels' intervals
    under ``torch.profiler``, over ``reps`` calls after a warm-up."""
    import torch
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


# -------------------------------------------------------------- kernels --


def kernel_rows(counts, sim_graph):
    import numpy as np
    import torch
    from repro_torch.core import comm_graph, engine
    from repro_torch.core import neighbor_selection as ns
    from repro_torch.core import virtual_lb as vlb
    from repro_torch.kernels.diffusion import ops as dops
    from repro_torch.kernels.diffusion.ref import (diffusion_nsweeps_ref,
                                                   diffusion_sweep_ref)
    from repro_torch.kernels.histogram import ops as hops
    from repro_torch.kernels.histogram.ref import histogram_ref
    from repro_torch.kernels.migrate import ops as mops
    from repro_torch.kernels.migrate.ref import scatter_dest_ref
    from repro_torch.kernels.pic_push import ops as pops
    from repro_torch.kernels.pic_push.ref import pic_push_ref
    from repro_torch.pic import chares
    from repro_torch.pic.grid import alternating_grid
    from repro_torch.pic.particles import initialize

    dev = "cuda"
    L, N, C = PIC["L"], PIC["n_particles"], PIC["cx"] * PIC["cy"]
    rows = []

    def row(name, replaces, source, err, tol, ms, plain, bound, lib):
        print(f"{name}: max_abs_err {err:.6g} (tolerance {tol}), kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound[0]:.6f} ms "
              f"({bound[1]}), library "
              f"{'n/a' if lib is None else f'{lib:.4f} ms'}")
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces,
                         launches=counts[name],
                         max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=bound[0], bound_by=bound[1],
                         library_ms=lib))

    # K5 — particle push at the main path's shapes
    p = initialize(PIC["mode"], L, N, k=2, vy0=1.0, rho=PIC["rho"], seed=0)
    x, y, vx, vy, q = (torch.as_tensor(a, device=dev)
                       for a in (p.x, p.y, p.vx, p.vy, p.q))
    grid = torch.as_tensor(alternating_grid(L), device=dev)
    # advance a few steps so positions are off the cell centres
    for _ in range(3):
        x, y, vx, vy = pic_push_ref(grid, x, y, vx, vy, q, L=L)
    got = pops.pic_push(grid, x, y, vx, vy, q, L=L)
    want = pic_push_ref(grid, x, y, vx, vy, q, L=L)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    for a, b in zip(got, want):
        sp = torch.nextafter(b.abs(), torch.full_like(b, float("inf"))) \
            - b.abs()
        check(((a - b).abs() <= sp).all(), "pic_push: more than 1 ulp off")
    row("pic_push", "src/repro/kernels/pic_push/kernel.py:64",
        "src/repro_torch/csrc/pic_push.cu", err, "1 ulp elementwise",
        time_ms(lambda: pops.pic_push(grid, x, y, vx, vy, q, L=L)),
        time_ms(lambda: pic_push_ref(grid, x, y, vx, vy, q, L=L), reps=5),
        bound_ms(9 * 4 * N + 4 * L * L, 95 * N), None)

    # the first plan of the main path on these particles' chare loads
    P = PIC["num_pes"]
    ids = chares.chare_of_device(x, y, L, PIC["cx"], PIC["cy"])
    w = torch.ones(N, device=dev)
    problem = chares.build_problem(
        hops.histogram(ids, w, C=C), torch.as_tensor(
            chares.initial_mapping(PIC["cx"], PIC["cy"], P), device=dev),
        L=L, cx=PIC["cx"], cy=PIC["cy"], num_pes=P, k=2, vy0=1.0,
        lb_period=PIC["lb_every"])
    planned, _ = engine.get_strategy(PIC["strategy"]).bind(
        **PIC["strategy_kwargs"])(problem)

    # K4 — chare loads (weights are ones on the path).  After an exchange
    # the particles lie bucketed by PE, so a warp sees few distinct chares
    # and its shared-memory atomics contend: time that order, which every
    # step after the first rebalance gives the kernel, and the initial one
    ids_x = ids[torch.argsort(planned[ids.long()], stable=True)]
    for order, i in (("initial", ids), ("after an exchange", ids_x)):
        got, want = hops.histogram(i, w, C=C), histogram_ref(i, w, C=C)
        err = float((got - want).abs().max())
        check(err == 0.0, f"histogram ({order} order): off by {err} on "
              "integer weights")
    print(f"histogram in the initial particle order: kernel "
          f"{time_ms(lambda: hops.histogram(ids, w, C=C)):.4f} ms")
    wf = torch.rand(N, device=dev, generator=torch.Generator(dev).manual_seed(0))
    errf = float((hops.histogram(ids_x, wf, C=C)
                  - histogram_ref(ids_x, wf, C=C)).abs().max())
    # the plain version's float atomics add ~10^6 terms a bin in any order
    check(errf <= 1e-3 * float(histogram_ref(ids_x, wf, C=C).abs().max()),
          f"histogram: float weights off by {errf}")
    row("histogram", "src/repro/kernels/histogram/kernel.py:41",
        "src/repro_torch/csrc/histogram.cu", err, "exact (ones)",
        time_ms(lambda: hops.histogram(ids_x, w, C=C)),
        time_ms(lambda: histogram_ref(ids_x, w, C=C), reps=5),
        bound_ms(8 * N + 4 * C, N),
        time_ms(lambda: torch.bincount(ids_x, weights=w, minlength=C)))

    # K3 — owner ids of those particles under a rebalanced mapping
    amap = torch.as_tensor(np.random.default_rng(0).integers(0, P, C),
                           dtype=torch.int32, device=dev)
    owner = amap[ids.long()]
    dg, cg = mops._scatter_dest_cuda(owner, P)
    dr, cr = scatter_dest_ref(owner, C=P)
    check(torch.equal(dg, dr) and torch.equal(cg, cr),
          "scatter_dest: kernel differs from plain version")
    inv = torch.empty_like(dg)
    inv[dg.long()] = torch.arange(N, dtype=torch.int32, device=dev)
    check(torch.equal(inv.long(), torch.argsort(owner, stable=True)),
          "scatter_dest: not the inverse of a stable argsort")
    pad = owner.clone()
    pad[::7] = -1
    check(all(torch.equal(a, b) for a, b in zip(
        mops._scatter_dest_cuda(pad, P), scatter_dest_ref(pad, C=P))),
        "scatter_dest: padding ids differ")
    row("scatter_dest", "src/repro/kernels/migrate/kernel.py:99",
        "src/repro_torch/csrc/migrate.cu", 0.0, "exact",
        time_ms(lambda: mops._scatter_dest_cuda(owner, P)),
        time_ms(lambda: scatter_dest_ref(owner, C=P), reps=5),
        bound_ms(8 * N + 4 * P, 6 * N),
        time_ms(lambda: torch.argsort(owner, stable=True)))

    # K1 — the first plan's stage-2 chunk (P = 8, K = 4, S = 8), and
    # P = 32768, K = 8 on a periodic 2D stencil for the simulator slice
    def k1_case(nl, nbr, mask, S):
        rev = vlb.reverse_slots(nbr, mask)
        Pn, K = nbr.shape
        alpha = float(torch.tensor(1.0 / (K + 1.0), dtype=torch.float32))
        res0 = vlb.neighborhood_residual(nl, nbr, mask)
        carry = (nl, nl, torch.zeros((Pn, K), device=dev),
                 torch.zeros((), dtype=torch.int32, device=dev), res0,
                 torch.zeros((), dtype=torch.int32, device=dev))
        kw = dict(n_sweeps=S, single_hop=True, tol=0.02, max_iters=512)
        got = dops.fused_nsweeps(*carry, nbr, mask, rev, alpha, **kw)
        want = diffusion_nsweeps_ref(*carry, nbr, mask, rev, alpha, **kw)
        check(int(got[3]) == int(want[3]) and int(got[5]) == int(want[5]),
              f"diffusion P={Pn}: it/stall {int(got[3])}/{int(got[5])} vs "
              f"{int(want[3])}/{int(want[5])}")
        # x, own, flow within 16 ulp of the largest load (sums over K and
        # P are taken in another order); res, a deviation over the mean
        # load, within that over the mean load
        ulp = spacing(nl)
        err = max(float((got[i] - want[i]).abs().max()) for i in (0, 1, 2))
        err_res = abs(float(got[4]) - float(want[4])) * float(nl.mean())
        err_u = max(err, err_res) / ulp
        check(err_u <= 16, f"diffusion P={Pn}: {err_u:.1f} ulp off")
        sweeps = int(got[3])
        nbytes = 4 * (2 * Pn + Pn * K) * 2 + 9 * Pn * K
        ops = sweeps * (15 * Pn * K + 10 * Pn)
        return (err, err_u, sweeps,
                time_ms(lambda: dops.fused_nsweeps(
                    *carry, nbr, mask, rev, alpha, **kw)),
                time_ms(lambda: diffusion_nsweeps_ref(
                    *carry, nbr, mask, rev, alpha, **kw), reps=5),
                bound_ms(nbytes, ops))

    nres = ns.select_neighbors(
        ns.comm_preference(comm_graph.node_comm_matrix(problem)), k=4)
    err, err_u, sweeps, ms, plain, bound = k1_case(
        comm_graph.node_loads(problem), nres.nbr_idx, nres.nbr_mask, 8)
    print(f"diffusion P=8: {sweeps} sweeps, {err_u:.1f} ulp")
    row("diffusion_nsweeps", "src/repro/kernels/diffusion/kernel.py:198",
        "src/repro_torch/csrc/diffusion.cu", err, "16 ulp of the largest load",
        ms, plain, bound, None)

    side = (128, 256)
    ii, jj = np.meshgrid(np.arange(side[0]), np.arange(side[1]),
                         indexing="ij")
    nb = [((ii + di) % side[0]) * side[1] + (jj + dj) % side[1]
          for di in (-1, 0, 1) for dj in (-1, 0, 1) if (di, dj) != (0, 0)]
    nbr = torch.as_tensor(np.stack([a.ravel() for a in nb], 1),
                          dtype=torch.int32, device=dev)
    mask = torch.ones_like(nbr, dtype=torch.bool)
    nl = torch.as_tensor(np.random.default_rng(1).random(nbr.shape[0]) * 100,
                         dtype=torch.float32, device=dev)
    err, err_u, sweeps, ms, plain, bound = k1_case(nl, nbr, mask, 8)
    print(f"diffusion_nsweeps at P=32768, K=8 (global-memory state): "
          f"{sweeps} sweeps, max_abs_err {err:.6g} ({err_u:.1f} ulp), kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound[0]:.6f} ms "
          f"({bound[1]})")

    # K2 — one sweep of the simulator path's stage 2 (its first sweep, on
    # the full-size snapshot's neighbour table), then the whole stage 2
    # with the kernel and with the plain sweep as step_fn
    nl, nbr, mask = sim_graph
    Pn, K = nbr.shape
    rev = vlb.reverse_slots(nbr, mask)
    alpha = float(torch.tensor(1.0 / (K + 1.0), dtype=torch.float32))
    sw = (nl, nl, nbr, mask, rev, alpha, True)
    got = dops.diffusion_sweep(*sw)
    want = diffusion_sweep_ref(*sw)
    ulp = spacing(nl)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    check(err <= 8 * ulp, f"diffusion_sweep: {err / ulp:.1f} ulp off")
    vk = vlb.virtual_balance(nl, nbr, mask, step_fn=dops.diffusion_sweep)
    vp = vlb.virtual_balance(nl, nbr, mask, step_fn=diffusion_sweep_ref)
    check(int(vk.iters) == int(vp.iters),
          f"stage 2 with diffusion_sweep: {int(vk.iters)} sweeps, with the "
          f"plain sweep {int(vp.iters)}")
    err_v = max(float((vk.target_loads - vp.target_loads).abs().max()),
                float((vk.flows - vp.flows).abs().max()))
    check(err_v <= 64 * ulp, f"stage 2 with diffusion_sweep: "
          f"{err_v / ulp:.1f} ulp off the plain sweep")
    dms = device_ms(lambda: dops.diffusion_sweep(*sw))
    print(f"diffusion_sweep at P={Pn}, K={K}: one sweep {err / ulp:.1f} ulp "
          f"off the plain version; stage 2 {int(vk.iters)} sweeps, "
          f"{err_v / ulp:.1f} ulp; device time of its two kernels "
          f"{dms:.4f} ms a sweep (profiler)")
    row("diffusion_sweep", "src/repro/kernels/diffusion/kernel.py:100",
        "src/repro_torch/csrc/diffusion_sweep.cu", err,
        "8 ulp of the largest load",
        time_ms(lambda: dops.diffusion_sweep(*sw)),
        time_ms(lambda: diffusion_sweep_ref(*sw)),
        bound_ms(16 * Pn + 13 * Pn * K, 8 * Pn * K + 5 * Pn), None)
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch import kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    kernels.build_all()
    print(f"built {sorted(kernels.registry())} in "
          f"{time.perf_counter() - t0:.1f} s")

    counts, _ = main_path()
    cpu_parity()
    sim_counts, snap = sim_path()
    sim_graph = sim_engines(snap)
    paper_scripts_and_small_replay()
    # each kernel's launches on its own path's run
    counts.update({name: sim_counts[name] for name in SIM_KERNELS})
    rows = kernel_rows(counts, sim_graph)
    check(len(rows) == 5, f"{len(rows)} kernel rows, not 5")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
