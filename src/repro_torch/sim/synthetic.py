"""Synthetic load-imbalance injectors used by the paper's experiments
(counterpart of ``repro.sim.synthetic``)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import comm_graph


def random_pm(problem: comm_graph.LBProblem, frac: float = 0.4,
              seed: int = 0) -> comm_graph.LBProblem:
    """Fig 2 setting: every object's load randomly ±``frac``.  The factors
    are ``np.random.default_rng(seed)`` draws, as in the JAX package."""
    rng = np.random.default_rng(seed)
    loads = problem.loads.cpu().numpy()
    factor = 1.0 + rng.uniform(-frac, frac, loads.shape[0])
    new = np.maximum(loads * factor, 1e-6).astype(np.float32)
    return dataclasses.replace(
        problem, loads=torch.as_tensor(new, device=problem.device))


def mod7(problem: comm_graph.LBProblem, over: float = 1.5,
         under: float = 0.7) -> comm_graph.LBProblem:
    """Table II setting: every 1st and 2nd PE mod 7 overloaded, every 3rd
    mod 7 underloaded (applied multiplicatively to that PE's objects)."""
    m = problem.assignment % 7
    loads = problem.loads.to(torch.float32)
    loads = torch.where((m == 1) | (m == 2), loads * over, loads)
    loads = torch.where(m == 3, loads * under, loads)
    return dataclasses.replace(problem, loads=loads)


def hotspot(problem: comm_graph.LBProblem, node: int = 0,
            factor: float = 10.0) -> comm_graph.LBProblem:
    """Table I setting: a single node overloaded by ``factor``."""
    loads = problem.loads.to(torch.float32)
    return dataclasses.replace(problem, loads=torch.where(
        problem.assignment == node, loads * factor, loads))
