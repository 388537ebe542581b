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
