"""Chare (object) decomposition of the PIC grid — paper §VI (counterpart of
``repro.pic.chares``).

The L×L cell grid is tiled into cx×cy chares.  Initial chare→PE mappings:
``striped`` (column-major round robin, the paper's choice) or ``quad``
(contiguous 2D tiles).  Chare comm edges model PRK particle traffic: east
at (2k+1) cells/step and north at vy cells/step, weighted by the expected
handoff bytes over one LB period.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import comm_graph


def chare_shape(L: int, cx: int, cy: int):
    """Cells per chare (fractional when the chare grid doesn't divide L —
    the paper's own setup is 12×12 chares on a 1000² grid)."""
    return L / cx, L / cy


def _floor_divide(x: torch.Tensor, w: float) -> torch.Tensor:
    """``jnp.floor_divide`` on f32: ``round((x - fmod(x, w)) / w)``, one
    less where the remainder is non-zero with the other sign — rounded
    half away from zero, as ``lax.round``."""
    w32 = torch.tensor(w, dtype=torch.float32, device=x.device)
    mod = torch.fmod(x, w32)
    div = (x - mod) / w32
    ind = (mod != 0) & (torch.sign(w32) != torch.sign(mod))
    div = torch.where(ind, div - 1, div)
    t = torch.trunc(div)
    return t + torch.where((div - t).abs() >= 0.5, torch.sign(div), 0.0)


def chare_of_device(x: torch.Tensor, y: torch.Tensor, L: int, cx: int,
                    cy: int) -> torch.Tensor:
    """Chare ids of f32 particle positions on their device; equal to the
    JAX package's ``chare_of_device`` (same float floor division)."""
    w, h = chare_shape(L, cx, cy)
    ci = torch.clamp(_floor_divide(x, w), max=cx - 1).to(torch.int32)
    cj = torch.clamp(_floor_divide(y, h), max=cy - 1).to(torch.int32)
    return ci * cy + cj


def initial_mapping(cx: int, cy: int, num_pes: int, mode: str = "striped"):
    """(cx*cy,) chare→PE assignment (NumPy)."""
    n = cx * cy
    if mode == "striped":
        return (np.arange(n) * num_pes // n).astype(np.int32)
    if mode == "quad":
        px = int(np.sqrt(num_pes))
        while num_pes % px:
            px -= 1
        py = num_pes // px
        ci = np.arange(cx)[:, None] * px // cx
        cj = np.arange(cy)[None, :] * py // cy
        return (ci * py + cj).astype(np.int32).reshape(-1)
    raise ValueError(f"unknown mapping {mode!r}")


def chare_coords(cx: int, cy: int, L: int):
    """(cx*cy, 2) tile-center coordinates (for the coordinate variant)."""
    w, h = chare_shape(L, cx, cy)
    ci, cj = np.meshgrid(np.arange(cx), np.arange(cy), indexing="ij")
    return np.stack(
        [(ci.ravel() + 0.5) * w, (cj.ravel() + 0.5) * h], axis=1
    ).astype(np.float32)


def edge_structure(cx: int, cy: int) -> np.ndarray:
    """(2·cx·cy, 2) static east+north edge pairs of the chare torus."""
    n = cx * cy
    ci = np.arange(n) // cy
    cj = np.arange(n) % cy
    east = ((ci + 1) % cx) * cy + cj
    north = ci * cy + (cj + 1) % cy
    return np.concatenate(
        [np.stack([np.arange(n), east], 1), np.stack([np.arange(n), north], 1)]
    ).astype(np.int32)


def edge_bytes_device(chare_loads: torch.Tensor, *, L: int, cx: int,
                      cy: int, k: int, vy0: float, lb_period: int,
                      bytes_per_particle: float = 48.0) -> torch.Tensor:
    """(2·cx·cy,) expected handoff bytes in :func:`edge_structure` order."""
    w, h = chare_shape(L, cx, cy)
    speed_x = 2 * k + 1
    frac_x = min(1.0, speed_x * lb_period / w)
    frac_y = min(1.0, abs(vy0) * lb_period / h)
    eps = 1e-3 * bytes_per_particle  # stencil adjacency floor
    loads = chare_loads.to(torch.float32)
    we = loads * frac_x * bytes_per_particle + eps
    wn = loads * frac_y * bytes_per_particle + eps
    return torch.cat([we, wn])


def build_problem(chare_loads: torch.Tensor, assignment, *, L: int, cx: int,
                  cy: int, num_pes: int, k: int, vy0: float, lb_period: int,
                  bytes_per_particle: float = 48.0) -> comm_graph.LBProblem:
    """LBProblem with chares as objects and particle-flux comm edges, on
    the device of ``chare_loads``."""
    ebytes = edge_bytes_device(
        chare_loads, L=L, cx=cx, cy=cy, k=k, vy0=vy0, lb_period=lb_period,
        bytes_per_particle=bytes_per_particle)
    return comm_graph.make_problem(
        loads=torch.clamp(chare_loads.to(torch.float32), min=1e-3),
        assignment=assignment,
        edges=edge_structure(cx, cy),
        edge_bytes=ebytes,
        num_nodes=num_pes,
        coords=chare_coords(cx, cy, L),
        device=chare_loads.device,
    )
