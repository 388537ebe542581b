#!/usr/bin/env python3
"""K6's backward in its two forms against each other, the plain version and
SDPA's backward, on one NVIDIA card.

Cases (bf16, positions 0..S-1 unless said): the training path's attention
call (smollm-135m: B 8, S 2048, KV 3, G 3, hd 64, causal), B 2, a window
of 512, a prefix-LM of 256, hd 128 (KV 2, G 4), hd 16 with G 32, ragged
S 70, and shifted positions (the first rows see no key) with sentinel
kv slots.  Each case:

  * the form ``ops.bwd_form`` names, counted by ``ops.bwd_form_launches``;
  * dq, dk, dv within 2e-2 of each gradient's largest magnitude of the
    plain version (the autograd of the chunked attention on the inputs
    upcast to f32; not with shifted positions, where rows without an
    allowed key follow the forward's visit rule) and of the simt form at
    the same inputs; two calls of each form equal bit for bit;
  * times by CUDA events (mean over repeated calls after a warm-up) of the
    mma form, the simt form and, where the masks are SDPA's causal one,
    SDPA's backward (GQA expanded), with the bound: 2.5 x the forward's
    causal flops at 989 TFLOP/s, or the bytes at 3.35 TB/s if more.

``--ptxas`` first compiles the source with ``-Xptxas -v`` and prints the
registers, shared memory and spills of every kernel.  ``--profile`` adds
each case's device time by kernel (``torch.profiler``, 5 calls of the
form ``bwd_form`` names).  ``--quick`` checks
without timing.  Prints the card's name and power limit, a line a case,
and writes the table as JSON to ``--out`` (default
``artifacts/flash_bwd.json``).  Needs a card.

Run from the repository root:  python3 benchmarks_torch/flash_bwd.py
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
TOL = 2e-2
CASES = [  # label, B, S, KV, G, hd, window, prefix, positions
    ("training call", 8, 2048, 3, 3, 64, 0, 0, "causal"),
    ("B 2", 2, 2048, 3, 3, 64, 0, 0, "causal"),
    ("window 512", 2, 2048, 3, 3, 64, 512, 0, "causal"),
    ("prefix-LM 256", 1, 1024, 3, 3, 64, 0, 256, "causal"),
    ("hd 128", 1, 2048, 2, 4, 128, 0, 0, "causal"),
    ("hd 16, G 32", 1, 300, 1, 32, 16, 0, 0, "causal"),
    ("ragged S 70", 2, 70, 2, 3, 64, 0, 0, "causal"),
    ("shifted, sentinel slots", 2, 300, 2, 3, 64, 0, 0, "shifted"),
]


def ptxas(source: Path) -> str:
    from repro_torch.kernels import NVCC_FLAGS, _nvcc

    with tempfile.TemporaryDirectory() as d:
        out = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(d) / "lib.so"), str(source)],
            capture_output=True, text=True, timeout=600)
    return out.stdout + out.stderr


def time_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def inputs(gen, B, S, KV, G, hd, how):
    import torch

    dev, bf16 = "cuda", torch.bfloat16
    q = torch.randn((B, S, KV, G, hd), generator=gen, device=dev).to(bf16)
    k = torch.randn((B, S, KV, hd), generator=gen, device=dev).to(bf16)
    v = torch.randn((B, S, KV, hd), generator=gen, device=dev).to(bf16)
    do = torch.randn((B, S, KV, G, hd), generator=gen, device=dev).to(bf16)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)
    qp = kp = pos.contiguous()
    if how == "shifted":
        # keys 40 positions ahead of their slots (the first 40 rows see
        # no key), and a tenth of the kv slots unwritten
        kp = (pos + 40).contiguous()
        kp[:, S // 3: S // 3 + S // 10] = 1 << 30
    return q, k, v, qp, kp, do


def close(got, want):
    return max(float((a.float() - b.float()).abs().max())
               / max(float(b.float().abs().max()), 1e-30)
               for a, b in zip(got, want))


def kernel_ms(fn, reps=5):
    """Device ms a call of each kernel ``fn`` runs, by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = e.cuda_time_total
        if us > 0:
            name = re.search(r"(\w+)(<|\(|$)", e.key.replace(
                "(anonymous namespace)::", ""))
            key = name.group(1) if name else e.key[:60]
            out[key] = out.get(key, 0.0) + us / 1e3 / reps
    return out


def sdpa_bwd(q, k, v, do):
    import torch
    import torch.nn.functional as F

    B, S, KV, G, hd = q.shape
    qs = q.reshape(B, S, KV * G, hd).transpose(1, 2).contiguous()
    ks = k.repeat_interleave(G, 2).transpose(1, 2).contiguous()
    vs = v.repeat_interleave(G, 2).transpose(1, 2).contiguous()
    gy = do.reshape(B, S, KV * G, hd).transpose(1, 2).contiguous()
    leaves = [t.requires_grad_() for t in (qs, ks, vs)]
    y = F.scaled_dot_product_attention(*leaves, is_causal=True)
    return lambda: torch.autograd.grad(y, leaves, gy, retain_graph=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "artifacts" /
                                         "flash_bwd.json"))
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("flash_bwd: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         mask)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    if args.ptxas:
        log = ptxas(fops.BWD_KERNEL.source)
        print("\n".join(ln for ln in log.splitlines()
                        if "registers" in ln or "Compiling entry" in ln
                        or "spill" in ln))
    gen = torch.Generator("cuda").manual_seed(0)
    rows, ok = [], True
    for label, B, S, KV, G, hd, win, pre, how in CASES:
        q, k, v, qp, kp, do = inputs(gen, B, S, KV, G, hd, how)
        kw = dict(window=win, prefix_len=pre)
        o = fops.flash_attention(q, k, v, qp, kp, **kw)
        form = fops.bwd_form(B, S, S, KV, G, hd, q.dtype, k.dtype)
        before = dict(fops.bwd_form_launches)
        got = fops.flash_attention_bwd(q, k, v, qp, kp, o, do, **kw)
        took = [f for f in fops.BWD_FORMS
                if fops.bwd_form_launches[f] != before[f]]
        again = fops.flash_attention_bwd(q, k, v, qp, kp, o, do, **kw)
        simt = fops._launch_bwd(q, k, v, qp, kp, o, do, win, pre, "simt")
        simt2 = fops._launch_bwd(q, k, v, qp, kp, o, do, win, pre, "simt")
        want = attention_bwd_ref(q.float(), k.float(), v.float(), qp, kp,
                                 do.float(), **kw)
        torch.cuda.synchronize()
        r = dict(case=label, shape=[B, S, KV, G, hd], window=win,
                 prefix=pre, positions=how, form=form, took=took,
                 err_vs_plain=close(got, want), err_vs_simt=close(got, simt),
                 simt_err_vs_plain=close(simt, want),
                 repeatable=all(torch.equal(a, b) for a, b in
                                zip(got, again)),
                 simt_repeatable=all(torch.equal(a, b) for a, b in
                                     zip(simt, simt2)),
                 finite=all(bool(torch.isfinite(t).all()) for t in got))
        del want
        # rows with no allowed key average v over the keys they visit,
        # which the plain version does not bound: there only the forms
        # are held to each other
        good = (took == [form] and (how == "shifted"
                                    or r["err_vs_plain"] <= TOL)
                and r["err_vs_simt"] <= TOL and r["repeatable"]
                and r["simt_repeatable"] and r["finite"])
        ok &= good
        if not args.quick:
            allowed = sum(int(mask(qp[b], kp[b], win, pre).sum())
                          for b in range(B))
            flops = 2.5 * 4 * hd * G * KV * allowed
            nbytes = 2 * sum(t.numel() * t.element_size()
                             for t in (q, k, v)) + sum(
                t.numel() * t.element_size() for t in (o, do, qp, kp))
            r["bound_ms"] = 1e3 * max(flops / PEAK_BF16, nbytes / PEAK_BYTES)
            r["ms"] = time_ms(lambda: fops.flash_attention_bwd(
                q, k, v, qp, kp, o, do, **kw), args.reps)
            r["simt_ms"] = time_ms(lambda: fops._launch_bwd(
                q, k, v, qp, kp, o, do, win, pre, "simt"),
                max(2, args.reps // 10))
            if args.profile:
                r["kernel_ms"] = kernel_ms(lambda: fops.flash_attention_bwd(
                    q, k, v, qp, kp, o, do, **kw))
            r["sdpa_bwd_ms"] = None
            if how == "causal" and not win and not pre:
                r["sdpa_bwd_ms"] = time_ms(sdpa_bwd(q, k, v, do), args.reps)
        print(json.dumps(r), "" if good else "  <-- FAILED", flush=True)
        rows.append(r)
        del q, k, v, o, do, got, again, simt, simt2
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(gpu=smi, cases=rows), indent=1))
    print(json.dumps(dict(ok=ok, gpu=smi)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
