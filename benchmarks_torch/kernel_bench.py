#!/usr/bin/env python3
"""The port's kernel micro-benchmarks on one NVIDIA card (counterpart of
``benchmarks/kernel_bench.py``).

Sections:

  * ``diffusion``: the streaming sweep K2 (``csrc/diffusion_sweep.cu``)
    on the JAX script's ring graphs (K/2 hops each side) at (P, K) in
    (4096, 4), (8192, 8), (65536, 8) and (1048576, 8), loads from seed 0,
    as that script builds them.  For one sweep: K2's device time (CUDA
    events around calls queued behind a sleep kernel), its event time
    (back-to-back calls; the wrapper's host work where that is longer)
    and the plain sweep's; for one S = 8 chunk from the initial carry:
    ``diffusion_nsweeps`` (the implementation ``sweep_impl`` selects), the
    streaming chunk (K2 in a replayed CUDA graph) and K1
    (``fused_nsweeps``).  Beside them the bytes a sweep must move,
    16 P + 13 P K (x, own, nbr, rev, mask read; x, own, flow written), and
    the JAX script's count (``diffusion_numbers``, which adds the push
    matrix's round trip), each over 3.35 TB/s.  Checks: K2 within 8 ulp
    of the largest load of the plain sweep and twice bit for bit; the
    chunks' it and stall equal, x, own and flow within 64 ulp.
  * ``migrate``: the manifest build and apply
    (``runtime.migrate.build_and_apply``) with the stable argsort against
    the counting scatter K3, n in {2^16, 2^20} items over P = 8 nodes with
    3 payload arrays, the median of 3 means; the outputs must be equal.
    The JAX script's gate, unchanged: the scatter no slower than the
    argsort at n = 2^20 (the script fails otherwise).

Prints the card's name and power limit and writes the result through
``common.save_result`` (``artifacts/bench_torch/kernel_bench.json``), and
to ``--out`` if given.  ``--src DIR`` imports the port from another
checkout's ``src`` (a parent commit, for a before-and-after in one call;
only ``diffusion`` runs then, saved as ``kernel_bench_src.json``).
``--device cpu`` runs both sections on the CPU with the plain versions
(host-clock times; no device time) at the sizes ``--shapes`` and
``--sizes`` give.

Run from the repository root on a machine with one card:
    python3 benchmarks_torch/kernel_bench.py [--out chiprun_out/kb.json]
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
SHAPES = ((4096, 4), (8192, 8), (65536, 8), (1 << 20, 8))
MIGRATE_SIZES = (1 << 16, 1 << 20)
MIGRATE_P = 8                   # the PIC loops' and replays' node count
MIGRATE_PAYLOADS = 3            # (position, velocity, id) slabs
GATE_N = 1 << 20
REPEATS = 3


def sweep_bytes(P: int, K: int) -> int:
    """Bytes one sweep must move: x, own (f32), nbr, rev (i32) and mask
    (u8) read once; x, own and flow (f32) written once."""
    return 16 * P + 13 * P * K


def diffusion_numbers(P: int, K: int, block_p: int = 512) -> dict:
    """The JAX script's count for a sweep of its two-pass Pallas kernel
    (``benchmarks/kernel_bench.py`` ``diffusion_numbers``): the push
    matrix written and read back included."""
    bytes_hbm = (P * 4 * 2 + P * K * (4 + 1 + 4) + P * K * 4 * 2
                 + P * 4 * 2 + P * K * 4)
    flops = P * K * 6
    vmem = P * 4 * 2 + block_p * K * (4 + 1 + 4) + block_p * K * 4
    return dict(bytes=bytes_hbm, flops=flops, intensity=flops / bytes_hbm,
                vmem_block=vmem)


def bound_ms(nbytes: float) -> float:
    return 1e3 * nbytes / PEAK_BYTES_PER_S


def ring_graph(P: int, K: int):
    """(P, K) i32 ring table of the JAX script: hops +1..+K/2, then
    -1..-(K - K/2)."""
    import numpy as np

    cols = [(np.arange(P) + h) % P for h in range(1, K // 2 + 1)]
    cols += [(np.arange(P) - h) % P for h in range(1, K - len(cols) + 1)]
    return np.stack(cols[:K], 1).astype(np.int32)


def times(fn, dev, reps: int) -> dict:
    """On a card: ``device_ms`` and ``event_ms``; on the CPU: ``cpu_ms``
    (a perf_counter around ``reps`` calls after a warm-up)."""
    from benchmarks_torch.common import event_ms, queued_device_ms

    if dev.type == "cuda":
        return dict(device_ms=queued_device_ms(fn, reps),
                    event_ms=event_ms(fn, reps))
    fn()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return dict(cpu_ms=1e3 * (time.perf_counter() - t) / reps)


def _spacing(v) -> float:
    import torch

    s = v.abs().max()
    return float(torch.nextafter(s, s + 1) - s)


def diffusion_row(P: int, K: int, dev, reps: int) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import virtual_lb as vlb
    from repro_torch.kernels.diffusion import ops as dops
    from repro_torch.kernels.diffusion.ref import diffusion_sweep_ref

    nbr = torch.as_tensor(ring_graph(P, K), device=dev)
    mask = torch.ones_like(nbr, dtype=torch.bool)
    rev = vlb.reverse_slots(nbr, mask)
    x = torch.as_tensor(np.random.default_rng(0).random(P).astype(
        np.float32), device=dev)
    alpha = float(torch.tensor(1.0 / (K + 1.0), dtype=torch.float32))
    ulp = _spacing(x)
    sw = (x, x, nbr, mask, rev, alpha, True)
    got = dops.diffusion_sweep(*sw)
    again = dops.diffusion_sweep(*sw)
    want = diffusion_sweep_ref(*sw)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))

    carry = (x, x, torch.zeros((P, K), device=dev),
             torch.zeros((), dtype=torch.int32, device=dev),
             vlb.neighborhood_residual(x, nbr, mask),
             torch.zeros((), dtype=torch.int32, device=dev))
    args = (*carry, nbr, mask, rev, alpha)
    kw = dict(n_sweeps=8, single_hop=True, tol=0.02, max_iters=512)
    chunks = {"selected": lambda: dops.diffusion_nsweeps(*args, **kw),
              "streaming": lambda: dops.streaming_nsweeps(*args, **kw),
              "k1": lambda: dops.fused_nsweeps(*args, **kw)}
    outs = {name: fn() for name, fn in chunks.items()}
    ref = outs["streaming"]
    chunk_err = max(float((o[i] - ref[i]).abs().max())
                    for o in outs.values() for i in (0, 1, 2))
    agree = all((int(o[3]), int(o[5])) == (int(ref[3]), int(ref[5]))
                for o in outs.values()) and chunk_err <= 64 * ulp
    jax_bytes = diffusion_numbers(P, K)["bytes"]
    return dict(
        P=P, K=K, impl=dops.sweep_impl(P, K, dev), k1_form=dops.k1_form(P, K),
        max_abs_err=err, err_ulp=err / ulp, repeat=repeat,
        chunk_sweeps=int(ref[3]), chunk_err_ulp=chunk_err / ulp,
        agree=agree and repeat and err <= 8 * ulp,
        sweep=times(lambda: dops.diffusion_sweep(*sw), dev, reps),
        plain_sweep=times(lambda: diffusion_sweep_ref(*sw), dev,
                          max(2, reps // 4)),
        # few calls: a chunk's graph replay fills the launch queue
        chunks={name: times(fn, dev, 4) for name, fn in chunks.items()},
        bytes=sweep_bytes(P, K), bound_ms=bound_ms(sweep_bytes(P, K)),
        jax_bytes=jax_bytes, jax_bound_ms=bound_ms(jax_bytes))


def migrate_row(n: int, dev, reps: int) -> dict:
    import numpy as np
    import torch
    from repro_torch.runtime import migrate as rt_migrate

    rng = np.random.default_rng(n)
    oo, on = (torch.as_tensor(rng.integers(0, MIGRATE_P, n).astype(np.int32),
                              device=dev) for _ in range(2))
    arrs = tuple(torch.as_tensor(rng.random(n).astype(np.float32),
                                 device=dev)
                 for _ in range(MIGRATE_PAYLOADS))

    def run(method):
        return rt_migrate.build_and_apply(oo, on, arrs, num_nodes=MIGRATE_P,
                                          method=method)[0]

    exact = all(torch.equal(a, b) for a, b in zip(run("sort"),
                                                  run("scatter")))
    key = "event_ms" if dev.type == "cuda" else "cpu_ms"
    row = dict(n=n, P=MIGRATE_P, payload_arrays=MIGRATE_PAYLOADS,
               exact=exact)
    for method in ("sort", "scatter"):
        runs = [times(lambda: run(method), dev, reps)
                for _ in range(REPEATS)]
        row[method] = {k: statistics.median(r[k] for r in runs)
                       for k in runs[0]}
        row[f"{method}_ms"] = row[method][key]
    row["speedup"] = row["sort_ms"] / row["scatter_ms"]
    return row


def migrate_gate(rows) -> tuple:
    """``(holds, message)``: the scatter no slower than the argsort at
    ``GATE_N`` items; ``holds`` is None where that size was not run."""
    big = [r for r in rows if r["n"] == GATE_N]
    if not big:
        return None, f"migrate gate: n = {GATE_N} not run"
    r = big[0]
    return r["speedup"] >= 1.0, (
        f"migrate gate (scatter no slower than argsort at n = {GATE_N}): "
        f"{r['scatter_ms']:.4f} ms vs {r['sort_ms']:.4f} ms, "
        f"{r['speedup']:.2f}x")


def _fmt(v, digits=4):
    return "-" if v is None else f"{v:.{digits}f}"


def _pairs(spec: str):
    return tuple(tuple(int(v) for v in s.split(":")) for s in spec.split(","))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--src", type=Path, default=None,
                    help="the src directory of the checkout whose port to "
                         "import (default: this checkout's)")
    ap.add_argument("--shapes", type=_pairs, default=SHAPES,
                    help="diffusion (P, K) shapes as P:K,P:K")
    ap.add_argument("--sizes", default=None,
                    help="migrate item counts as n,n (default 2^16,2^20)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    src = str((args.src or ROOT / "src").resolve())
    for p in (str(ROOT), src):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from benchmarks_torch.common import environment, save_result, table

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("kernel_bench: needs a CUDA card (or --device cpu)",
                  file=sys.stderr)
            return 1
        dev = torch.device("cuda", torch.cuda.current_device())
    env = environment(dev)
    print(env["gpu"] or f"device {dev}")
    import repro_torch

    print(f"port from {Path(repro_torch.__file__).parent}")
    if dev.type == "cuda":
        from repro_torch.kernels.diffusion import ops as dops
        from repro_torch.kernels.migrate import ops as mops

        for k in (dops.KERNEL, dops.SWEEP_KERNEL, mops.KERNEL):
            k.load()
    out = dict(environment=env, src=src,
               diffusion=[diffusion_row(P, K, dev, args.reps)
                          for P, K in args.shapes])
    t_key = "device_ms" if dev.type == "cuda" else "cpu_ms"
    print(f"diffusion sweep and S = 8 chunk ({t_key}; event ms in "
          "brackets on a card)")
    print(table(
        ["P", "K", "K2 sweep", "plain sweep", "selected chunk",
         "streaming chunk", "K1 chunk", "bound", "JAX count bound",
         "impl", "ulp", "agree"],
        [[r["P"], r["K"],
          _fmt(r["sweep"][t_key]) + (
              f" ({r['sweep']['event_ms']:.4f})" if "event_ms" in r["sweep"]
              else ""),
          _fmt(r["plain_sweep"][t_key]),
          _fmt(r["chunks"]["selected"][t_key]),
          _fmt(r["chunks"]["streaming"][t_key]),
          _fmt(r["chunks"]["k1"][t_key]), _fmt(r["bound_ms"], 6),
          _fmt(r["jax_bound_ms"], 6), r["impl"], f"{r['err_ulp']:.1f}",
          r["agree"]] for r in out["diffusion"]]))
    ok = all(r["agree"] for r in out["diffusion"])
    if args.src is None:
        sizes = (tuple(int(v) for v in args.sizes.split(","))
                 if args.sizes else MIGRATE_SIZES)
        out["migrate"] = [migrate_row(n, dev, max(2, args.reps // 2))
                          for n in sizes]
        key = "event_ms" if dev.type == "cuda" else "cpu_ms"
        print(f"\nmigrate manifest build + apply (P = {MIGRATE_P}, "
              f"{MIGRATE_PAYLOADS} payload arrays, median of {REPEATS}, "
              f"{key})")
        print(table(["n", "argsort", "counting scatter", "speedup", "exact"],
                    [[r["n"], _fmt(r["sort_ms"]), _fmt(r["scatter_ms"]),
                      f"{r['speedup']:.2f}x", r["exact"]]
                     for r in out["migrate"]]))
        holds, msg = migrate_gate(out["migrate"])
        out["migrate_gate"] = dict(holds=holds, message=msg)
        print(msg)
        ok &= all(r["exact"] for r in out["migrate"]) and holds is not False
    path = save_result("kernel_bench" if args.src is None
                       else "kernel_bench_src", out)
    print(f"saved {path}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1, default=str))
    if not ok:
        print("kernel_bench: FAILED (a check or the migrate gate)",
              file=sys.stderr)
        return 1
    return 0


def run(device="cuda"):
    """``main`` with its defaults on ``device``, for the orchestrator
    (``benchmarks_torch/run.py``): raises where ``main`` would exit 1."""
    if main(["--device", str(device)]):
        raise RuntimeError("kernel_bench failed (a check or the migrate "
                           "gate; see its output)")


if __name__ == "__main__":
    sys.exit(main())
