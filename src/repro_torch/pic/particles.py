"""PIC PRK particle initialization (paper §VI.A).

NumPy; a copy of ``repro.pic.particles``, so both packages draw the same
particles from one seed.

Distribution modes from the PRK benchmark [17]:
  GEOMETRIC   — column i holds ~A·ρ^i particles (exponential skew, the
                paper's evaluation mode), rows uniform;
  SINUSOIDAL  — density ∝ cos²(πi/L);
  LINEAR      — density a linear ramp along x;
  PATCH       — uniform inside a sub-rectangle.

Determinism construction: particles start at cell centers with zero
horizontal velocity; the particle charge
    q_p = (2k+1) · 2 · m / (GEOM_FACTOR · Q) · sign(column)
yields horizontal acceleration a = ±2(2k+1), so displacement alternates
a/2 = (2k+1) cells every step (odd ⇒ the column-parity force sign flips,
velocity returns to 0 every other step).  Vertical: constant speed
``vy0`` cells/step, no vertical force at cell centers.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.pic.grid import GEOM_FACTOR


@dataclasses.dataclass
class Particles:
    x: np.ndarray
    y: np.ndarray
    vx: np.ndarray
    vy: np.ndarray
    q: np.ndarray

    @property
    def n(self) -> int:
        return self.x.shape[0]


def _cells_from_density(col_density: np.ndarray, L: int, n: int, rng):
    """Sample n (col, row) cells: columns ∝ density, rows uniform."""
    p = col_density / col_density.sum()
    cols = rng.choice(L, size=n, p=p)
    rows = rng.integers(0, L, size=n)
    return cols, rows


def initialize(
    mode: str,
    L: int,
    n: int,
    *,
    k: int = 1,
    vy0: float = 1.0,
    rho: float = 0.9,
    Q: float = 1.0,
    mass: float = 1.0,
    patch=(0.25, 0.25, 0.5, 0.5),
    seed: int = 0,
) -> Particles:
    rng = np.random.default_rng(seed)
    mode = mode.upper()
    i = np.arange(L)
    if mode == "GEOMETRIC":
        density = rho ** i
    elif mode == "SINUSOIDAL":
        density = np.cos(np.pi * i / L) ** 2 + 1e-9
    elif mode == "LINEAR":
        density = 1.0 - 0.9 * i / L
    elif mode == "PATCH":
        x0, y0, w, h = patch
        density = ((i >= x0 * L) & (i < (x0 + w) * L)).astype(float) + 1e-12
    else:
        raise ValueError(f"unknown distribution mode {mode!r}")

    cols, rows = _cells_from_density(density, L, n, rng)
    if mode == "PATCH":
        rows = rng.integers(int(patch[1] * L), int((patch[1] + patch[3]) * L),
                            size=n)
    x = cols + 0.5
    y = rows + 0.5
    sign = np.where(cols % 2 == 0, 1.0, -1.0)
    qp = (2 * k + 1) * 2.0 * mass / (GEOM_FACTOR * Q) * sign
    return Particles(
        x=x.astype(np.float32),
        y=y.astype(np.float32),
        vx=np.zeros(n, np.float32),
        vy=np.full(n, vy0, np.float32),
        q=qp.astype(np.float32),
    )
