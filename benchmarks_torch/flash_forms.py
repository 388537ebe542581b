#!/usr/bin/env python3
"""K6's forms against each other on one NVIDIA card, at the served model's
attention shapes (gemma3-1b: KV 1, G 4, hd 288, bf16 cache).

Times by CUDA events (mean over repeated calls after a warm-up):

  * decode, B = 4, Sq = 1, T = 1056 (the serving path's global layers, its
    positions): the split form at several keys a split, L2-hot (one cache
    read again and again) and cold (26 caches, one a layer as on the path,
    rotated call to call: 127 MB, past the 50 MB L2); the simt form; one
    SDPA call (GQA expanded, boolean mask) as the yardstick;
  * the same decode over an f32 cache, with bf16 or f32 q: the split
    form's FMA partials, hot and cold, the simt form, SDPA in f32;
  * short query blocks, Sq = 1, 2, 4, 8 at B = 4 (Sq·G <= 32, where the
    split form applies): split, mma and simt forms side by side;
  * prefill, B = 1, Sq = 1000, T = 1056: the mma form with 32- and 64-pair
    M tiles, with and without a key split; the simt form; SDPA.

Every form is first held against the plain version (2e-2, bf16).  Prints
the card's name and power limit, one line a case, and writes the table as
JSON to ``--out`` (default ``artifacts/flash_forms.json``).  Needs a card.

Run from the repository root:  python3 benchmarks_torch/flash_forms.py
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

KV, G, HD = 1, 4, 288
DECODE_LAST = (1030, 1026, 543, 607)     # the serving path's slots
LAYERS = 26


def device_ms(fn, reps=20):
    """Device time of ``fn()`` a call: the sum of its device intervals under
    ``torch.profiler`` over ``reps`` calls after a warm-up."""
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
             if e.device_type == DeviceType.CUDA
             and e.name not in ("Activity Buffer Request", "Buffer Flush"))
    return us / 1e3 / reps


def host_us(fn, reps=200):
    """Host time of ``fn()`` a call, without waiting for the device."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e6 * t / reps


def time_ms(fn, reps=50):
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "artifacts" / "flash_forms.json")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_forms: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (POS_SENTINEL,
                                                         chunked_attention,
                                                         mask)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi)
    dev, bf16 = "cuda", torch.bfloat16
    gen = torch.Generator(dev).manual_seed(0)
    rows = []

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    def cache_pos(B, T, last):
        s = torch.arange(T, device=dev)[None]
        kp = torch.where(s <= last[:, None], s, POS_SENTINEL)
        return kp.to(torch.int32).contiguous()

    def sdpa(q, k, v, qp, kp):
        B, Sq = qp.shape
        qs = q.reshape(B, Sq, KV * G, HD).transpose(1, 2).contiguous()
        ks = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
        vs = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
        am = mask(qp, kp, 0, 0)[:, None].contiguous()
        return lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                      attn_mask=am)

    def run(case, variant, fn, check=None, reps=50):
        if check is not None:
            got = fn()
            torch.cuda.synchronize()
            diff = (got.float() - check.float()).abs()
            assert bool((diff <= 2e-2 + 2e-2 * check.float().abs()).all()), \
                f"{case} {variant}: max_abs_err {float(diff.max())}"
        ms = time_ms(fn, reps)
        dms, hus = device_ms(fn), host_us(fn)
        rows.append(dict(case=case, variant=variant, ms=ms, device_ms=dms,
                         host_us=hus))
        print(f"{case:34s} {variant:26s} {ms:.4f} ms (device {dms:.4f} ms, "
              f"host {hus:.1f} us a call)")

    def form(q, k, v, qp, kp, name, **kw):
        return lambda: fops._launch(q, k, v, qp, kp, 0, 0, name, **kw)

    def default(q, k, v, qp, kp):
        return lambda: fops.flash_attention(q, k, v, qp, kp)

    # decode at the serving path's shape: hot and cold
    B, T = 4, 1056
    last = torch.tensor(DECODE_LAST, device=dev)
    qp = last[:, None].to(torch.int32)
    kp = cache_pos(B, T, last)
    q = rand(B, 1, KV, G, HD)
    caches = [(rand(B, T, KV, HD), rand(B, T, KV, HD))
              for _ in range(LAYERS)]
    k, v = caches[0]
    want = chunked_attention(q, k, v, qp, kp)
    print(f"decode: default split of {fops.split_keys(B, KV, T)} keys")
    for tc, name in ((True, "tensor cores"), (False, "FMA")):
        for kps in (32, 64, 96, 128, 1056):
            kw = dict(keys_per_split=kps, tensor_cores=tc)
            run("decode hot B=4 T=1056", f"split {kps} keys, {name}",
                form(q, k, v, qp, kp, "split", **kw), want)
            it = iter(range(10 ** 9))
            run("decode cold B=4 T=1056", f"split {kps} keys, {name}",
                lambda: fops._launch(q, *caches[next(it) % LAYERS], qp, kp,
                                     0, 0, "split", **kw), reps=2 * LAYERS)
    run("decode hot B=4 T=1056", "simt", form(q, k, v, qp, kp, "simt"),
        want)
    run("decode hot B=4 T=1056", "SDPA", sdpa(q, k, v, qp, kp))
    fns = [sdpa(q, kc, vc, qp, kp) for kc, vc in caches]
    it = iter(range(10 ** 9))
    run("decode cold B=4 T=1056", "SDPA",
        lambda: fns[next(it) % LAYERS](), reps=2 * LAYERS)

    # decode over an f32 cache (ServeConfig's default type; bf16 q from the
    # bf16 model, or f32 q): the split form's FMA partials, hot and cold,
    # against the simt form, and SDPA in f32
    f32 = torch.float32
    caches32 = [(kc.to(f32), vc.to(f32)) for kc, vc in caches]
    k32, v32 = caches32[0]
    for qdt in (bf16, f32):
        qm = q.to(qdt)
        case = f"decode {str(qdt)[6:]} q, f32 cache"
        want = chunked_attention(qm, k32, v32, qp, kp)
        run(f"{case} hot", f"split {fops.split_keys(B, KV, T)} keys, FMA",
            default(qm, k32, v32, qp, kp), want)
        it = iter(range(10 ** 9))
        run(f"{case} cold", f"split {fops.split_keys(B, KV, T)} keys, FMA",
            lambda: fops.flash_attention(qm, *caches32[next(it) % LAYERS],
                                         qp, kp), reps=2 * LAYERS)
        run(f"{case} hot", "simt", form(qm, k32, v32, qp, kp, "simt"), want)
    run("decode f32 q, f32 cache hot", "SDPA", sdpa(q.to(f32), k32, v32,
                                                    qp, kp))
    del caches32, k32, v32

    # short query blocks: where the split form stops paying
    for Sq in (1, 2, 4, 8):
        qs = rand(B, Sq, KV, G, HD)
        qps = (last[:, None] - torch.arange(Sq - 1, -1, -1, device=dev))
        qps = qps.to(torch.int32).contiguous()
        want = chunked_attention(qs, k, v, qps, kp)
        case = f"Sq={Sq} B=4 T=1056"
        for tc, name in ((True, "tensor cores"), (False, "FMA")):
            run(case, f"split, {name}", form(
                qs, k, v, qps, kp, "split", tensor_cores=tc,
                keys_per_split=fops.split_keys(B, KV, T)), want)
        run(case, "mma 4 warps", form(
            qs, k, v, qps, kp, "mma",
            keys_per_split=fops.mma_split_keys(B, Sq, T, KV, G)), want)
        run(case, "simt", form(qs, k, v, qps, kp, "simt"), want)

    # prefill at the serving path's longest prompt
    Sq = 1000
    q = rand(1, Sq, KV, G, HD)
    k, v = rand(1, T, KV, HD), rand(1, T, KV, HD)
    qp = torch.arange(Sq, dtype=torch.int32, device=dev)[None]
    kp = cache_pos(1, T, torch.tensor([Sq - 1], device=dev))
    want = chunked_attention(q, k, v, qp, kp)
    case = "prefill B=1 Sq=1000 T=1056"
    print(f"prefill: default split of "
          f"{fops.mma_split_keys(1, Sq, T, KV, G)} keys, "
          f"{fops.MMA_WARPS} warps")
    for w in (2, 4):
        for kps in (T, 352, 256, 224, 128):
            run(case, f"mma {w} warps, split {kps if kps < T else 'none'}",
                form(q, k, v, qp, kp, "mma", warps=w, keys_per_split=kps),
                want)
    run(case, "simt", form(q, k, v, qp, kp, "simt"), want, reps=10)
    run(case, "SDPA", sdpa(q, k, v, qp, kp))

    out = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
               rows=rows)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
