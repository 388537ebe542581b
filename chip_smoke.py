#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It builds the four CUDA kernels from ``src/repro_torch/csrc``, then:

  1. drives the port's main path — the PIC PRK driver with the diff-comm
     balancer (``repro_torch.pic.driver.run``) at the paper's setup (L =
     1000, 12×12 chares, GEOMETRIC ρ = 0.9, 8 PEs), 2^24 particles, 100
     steps, LB every 10 — with every launch count set to 0 just before and
     read just after, and checks its invariants against a ``strategy=
     "none"`` run of the same configuration;
  2. checks a small PIC run on the card against the same run on the CPU
     (plain PyTorch versions);
  3. holds each kernel against its plain PyTorch version on the card at the
     shapes the main path gives it (and the diffusion kernel also at P =
     32768, K = 8), timing kernel, plain version and the one-call PyTorch
     yardstick where there is one.

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

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12       # also used for the kernels' 32-bit integer ops

PIC = dict(L=1000, n_particles=1 << 24, steps=100, cx=12, cy=12,
           num_pes=8, rho=0.9, mode="GEOMETRIC", lb_every=10,
           strategy="diff-comm", strategy_kwargs={"k": 4})


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
    print(f"main path: {PIC['n_particles']} particles, {PIC['steps']} steps "
          f"in {wall:.3f} s end to end ({res.wall_seconds:.3f} s step loop, "
          f"{PIC['steps'] / res.wall_seconds:.2f} steps/s); launches "
          f"{counts}")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched on the main path")

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


# -------------------------------------------------------------- kernels --


def kernel_rows(counts):
    import numpy as np
    import torch
    from repro_torch.core import comm_graph, engine
    from repro_torch.core import neighbor_selection as ns
    from repro_torch.core import virtual_lb as vlb
    from repro_torch.kernels.diffusion import ops as dops
    from repro_torch.kernels.diffusion.ref import diffusion_nsweeps_ref
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
        got = dops.diffusion_nsweeps(*carry, nbr, mask, rev, alpha, **kw)
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
                time_ms(lambda: dops.diffusion_nsweeps(
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
    rows = kernel_rows(counts)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
