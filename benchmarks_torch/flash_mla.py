#!/usr/bin/env python3
"""K6 (the flash-attention kernel) at MLA's full-width latent shapes on
one NVIDIA card: deepseek-v3's 128 query heads on one latent "kv head" of
hd = 576 (kv_lora 512 + rope 64), values ``[ckv | 0]``, bf16, in the form
``flash_form`` names (SIMT), decode (B = 4, Sq = 1, T = 536) and prefill
(B = 1, Sq = 512, T = 536).

For each it prints CUDA-event times over 1, 5 and 20 back-to-back calls
with the host's issue time, five single synchronized calls, and the
kernel runs ``torch.profiler`` records over 20 calls (their number and
mean), beside the card's name and power limit.  The numbers are also
written as JSON to ``--out`` (default ``artifacts/flash_mla.json``).

Run from the repository root:  python3 benchmarks_torch/flash_mla.py
It needs a card and fails without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CASES = {"decode": (4, 1, 536, [527, 460, 372, 280]),
         "prefill": (1, 512, 536, [511])}     # B, Sq, T, last positions


def inputs(B, Sq, T, last, gen):
    import torch
    from repro_torch.kernels.flash_attention.ref import POS_SENTINEL

    dev = "cuda"
    q = torch.randn((B, Sq, 1, 128, 576), generator=gen,
                    device=dev).bfloat16()
    k = torch.randn((B, T, 1, 576), generator=gen, device=dev).bfloat16()
    v = torch.cat([k[..., :512], torch.zeros_like(k[..., 512:])], -1)
    lt = torch.tensor(last, device=dev)[:, None]
    qp = (lt - torch.arange(Sq - 1, -1, -1, device=dev)).int().contiguous()
    s = torch.arange(T, device=dev)[None].expand(B, T)
    kp = torch.where(s <= lt, s, POS_SENTINEL).int().contiguous()
    return q, k, v, qp, kp


def measure(fn):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {}
    for reps in (1, 5, 20):
        st = torch.cuda.Event(enable_timing=True)
        en = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        st.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = time.perf_counter() - t0
        en.record()
        torch.cuda.synchronize()
        out[f"events_ms_{reps}"] = st.elapsed_time(en) / reps
        out[f"host_issue_ms_{reps}"] = 1e3 * host / reps
    singles = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        singles.append(1e3 * (time.perf_counter() - t0))
    out["single_sync_ms"] = singles
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    runs = [(e.time_range.end - e.time_range.start) / 1e3
            for e in prof.events() if e.device_type == DeviceType.CUDA]
    out["profiler_runs_of_20"] = len(runs)
    out["profiler_ms_a_run"] = sum(runs) / max(len(runs), 1)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path,
                    default=ROOT / "artifacts" / "flash_mla.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flash_mla: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops as fops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi)
    kernels.build_all()
    gen = torch.Generator("cuda").manual_seed(0)
    res = {"device": smi}
    for label, (B, Sq, T, last) in CASES.items():
        q, k, v, qp, kp = inputs(B, Sq, T, last, gen)
        form = fops.flash_form(B, Sq, T, 1, 128, 576, q.dtype, k.dtype)
        res[label] = dict(form=form, **measure(
            lambda: fops.flash_attention(q, k, v, qp, kp)))
        print(label, json.dumps(res[label]))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
