"""ASCII ownership-map views (paper Figs 1-2), counterpart of
``repro.sim.viz``; they take numpy arrays or tensors on any device."""
from __future__ import annotations

import numpy as np
import torch

_GLYPHS = "0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def _grid(assignment, nx: int, ny: int) -> np.ndarray:
    if isinstance(assignment, torch.Tensor):
        assignment = assignment.cpu().numpy()
    return np.asarray(assignment).reshape(nx, ny)


def ownership_map(assignment, nx: int, ny: int) -> str:
    """Render a (nx*ny,) assignment of a 2D grid as an ASCII block map."""
    a = _grid(assignment, nx, ny)
    return "\n".join("".join(_GLYPHS[int(p) % len(_GLYPHS)] for p in row)
                     for row in a)


def locality_summary(assignment, nx: int, ny: int) -> float:
    """Fraction of 4-neighbor grid links that stay within one node — a
    scalar for 'contiguous blocks of color' (Fig 1 intuition)."""
    a = _grid(assignment, nx, ny)
    same = (a == np.roll(a, 1, axis=0)).sum() + (
        a == np.roll(a, 1, axis=1)).sum()
    return float(same) / (2 * a.size)
