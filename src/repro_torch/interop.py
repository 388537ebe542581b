"""Carrying an ``LBProblem`` across packages as a dict of NumPy arrays.

Imports only torch and NumPy: a caller (in practice the parity tests)
builds the dict from the JAX package's problem with ``np.asarray`` on
each field and hands the same arrays to both packages.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.comm_graph import LBProblem
from repro_torch.kernels import resolve_device

_FIELDS = {"loads": torch.float32, "assignment": torch.int32,
           "edges_src": torch.int32, "edges_dst": torch.int32,
           "edges_bytes": torch.float32}


def problem_from_numpy(d: Dict, device="cuda") -> LBProblem:
    """``LBProblem`` from ``{loads, assignment, edges_src, edges_dst,
    edges_bytes, num_nodes[, coords]}``."""
    dev = resolve_device(device)
    # copies: the arrays may be read-only views of another package's buffers
    t = {k: torch.tensor(np.asarray(d[k]), dtype=dt, device=dev)
         for k, dt in _FIELDS.items()}
    coords = d.get("coords")
    return LBProblem(
        **t, num_nodes=int(d["num_nodes"]),
        coords=None if coords is None else torch.tensor(
            np.asarray(coords), dtype=torch.float32, device=dev))


def problem_to_numpy(problem: LBProblem) -> Dict:
    """Inverse of :func:`problem_from_numpy`."""
    d = {k: getattr(problem, k).cpu().numpy() for k in _FIELDS}
    d["num_nodes"] = problem.num_nodes
    d["coords"] = (None if problem.coords is None
                   else problem.coords.cpu().numpy())
    return d
