"""Shared utilities of the port's paper scripts: table formatting and
result capture (counterpart of ``benchmarks/common.py``)."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

ARTIFACTS = Path(__file__).resolve().parents[1] / "artifacts" / "bench_torch"


def _jsonable(o):
    return o.tolist() if hasattr(o, "tolist") else float(o)


def save_result(name: str, payload: Dict) -> str:
    """Write ``payload`` as ``artifacts/bench_torch/<name>.json``."""
    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    path = ARTIFACTS / f"{name}.json"
    path.write_text(json.dumps(payload, indent=1, default=_jsonable))
    return str(path)


def table(headers: List[str], rows: List[List]) -> str:
    w = [max(len(str(h)), max((len(str(r[i])) for r in rows), default=0))
         for i, h in enumerate(headers)]
    out = ["  ".join(str(h).rjust(w[i]) for i, h in enumerate(headers))]
    out.append("  ".join("-" * w[i] for i in range(len(headers))))
    for r in rows:
        out.append("  ".join(str(c).rjust(w[i]) for i, c in enumerate(r)))
    return "\n".join(out)


def environment(device) -> Dict:
    """Where a bench ran: the device (with the card's name and power limit
    from ``nvidia-smi`` on a card), the torch and CUDA versions and the
    git commit (None outside a git checkout)."""
    import subprocess

    import torch

    dev = torch.device(device)
    out = dict(device=str(dev), torch=torch.__version__,
               cuda=torch.version.cuda, git_sha=None, gpu=None)
    if dev.type == "cuda":
        out["gpu"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=30, cwd=Path(__file__).resolve().parents[1])
        if sha.returncode == 0:
            out["git_sha"] = sha.stdout.strip()
    except OSError:
        pass
    return out


def event_ms(fn, reps: int = 20) -> float:
    """Mean ms of ``fn()`` by CUDA events around ``reps`` back-to-back
    calls after a warm-up: what a caller waits for when the calls queue
    (the wrapper's host work where that is the longer)."""
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


def queued_device_ms(fn, reps: int = 20) -> float:
    """Device time of ``fn()`` a call, the launch gaps between its kernels
    included: CUDA events around ``reps`` calls issued behind a queued
    sleep kernel, so that the card never waits on the host between them.
    Raises if the host had not issued them all before the sleep ended."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    issue_ms = 1e3 * (time.perf_counter() - t)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # 2e6 cycles are at least 1 ms at the card's clock (at most 1.98 GHz)
    torch.cuda._sleep(int(2e6 * (20 + 3 * reps * issue_ms)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    behind = not start.query()
    torch.cuda.synchronize()
    if not behind:
        raise RuntimeError(f"queued_device_ms: the sleep ended before the "
                           f"host had issued {reps} calls ({issue_ms:.3f} "
                           "ms each to issue)")
    return start.elapsed_time(end) / reps
