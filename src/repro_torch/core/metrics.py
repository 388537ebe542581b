"""Cost metrics from the paper's problem definition (§II), counterpart of
``repro.core.metrics``:

  (1) load imbalance      — max / average node load;
  (2) communication cost  — external / internal bytes ratio;
  (3) migration cost      — fraction of objects that moved.

``evaluate_device`` returns 0-d tensors on the problem's device;
``evaluate`` is the host dict view.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.core import comm_graph
from repro_torch.core.comm_graph import segment_sum

#: ``ext_int_comm`` for an all-external mapping (zero internal bytes):
#: finite, far above any physical ratio, and f32-exact.
EXT_INT_ALL_EXTERNAL = 1.0e6


class StepMetrics(NamedTuple):
    """Per-snapshot cost metrics as f32 0-d tensors."""

    max_avg_load: torch.Tensor
    ext_int_comm: torch.Tensor
    ext_bytes: torch.Tensor
    int_bytes: torch.Tensor
    pct_migrations: torch.Tensor
    node_load_std: torch.Tensor
    max_load: torch.Tensor
    avg_load: torch.Tensor


def evaluate_device(problem: comm_graph.LBProblem,
                    assignment: Optional[torch.Tensor] = None) -> StepMetrics:
    cur = problem.assignment
    a = cur if assignment is None else assignment.to(cur.device)
    nl = segment_sum(problem.loads, a, problem.num_nodes)
    avg = nl.mean() + 1e-30
    valid = problem.edges_src >= 0
    al = a.long()
    src_n = al[torch.where(valid, problem.edges_src, 0).long()]
    dst_n = al[torch.where(valid, problem.edges_dst, 0).long()]
    w = torch.where(valid, problem.edges_bytes, 0.0)
    ext = torch.where(src_n != dst_n, w, 0.0).sum()
    internal = torch.where(src_n == dst_n, w, 0.0).sum()
    moved = (a != cur).to(torch.float32).mean()
    ext_int = torch.where(
        internal > 0, ext / torch.where(internal > 0, internal, 1.0),
        torch.where(ext > 0, EXT_INT_ALL_EXTERNAL, 0.0))
    return StepMetrics(
        max_avg_load=nl.max() / avg,
        ext_int_comm=ext_int,
        ext_bytes=ext,
        int_bytes=internal,
        pct_migrations=moved,
        node_load_std=nl.std(correction=0) / avg,
        max_load=nl.max(),
        avg_load=avg,
    )


def evaluate(problem: comm_graph.LBProblem,
             assignment: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """Host dict view of :func:`evaluate_device`; every value is finite."""
    m = evaluate_device(problem, assignment)
    vals = torch.stack(list(m)).cpu().tolist()          # one transfer
    out = dict(zip(StepMetrics._fields, vals))
    for k, v in out.items():
        if not math.isfinite(v):
            out[k] = EXT_INT_ALL_EXTERNAL if v > 0 else 0.0
    return out
