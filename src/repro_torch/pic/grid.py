"""PIC PRK charge grid (paper §VI).  NumPy; a copy of ``repro.pic.grid``.

L×L grid points carry fixed electromagnetic charges that alternate sign by
column — the PRK construction that, combined with the particle-charge
formula in particles.py, makes every particle's horizontal displacement
exactly (2k+1) cells per time step.
"""
from __future__ import annotations

import numpy as np

# Geometry factor: a particle at a cell center feels a net horizontal
# Coulomb force of GEOM_FACTOR * q_p * Q from the four corners (two +Q·s,
# two -Q·s at distance sqrt(0.5); vertical components cancel).
GEOM_FACTOR = 4.0 * np.sqrt(2.0)


def alternating_grid(L: int, Q: float = 1.0) -> np.ndarray:
    """(L, L) charges: +Q in even columns, -Q in odd columns (PRK)."""
    cols = np.where(np.arange(L) % 2 == 0, Q, -Q).astype(np.float32)
    return np.broadcast_to(cols[:, None], (L, L)).copy()
