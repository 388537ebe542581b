"""Synthetic stencil problem generators (paper §I, §V), counterpart of
``repro.sim.stencil``.

2D 5-point and 3D 7-point stencils with periodic boundaries, one object per
grid point, with ``tiled`` (contiguous blocks), ``striped`` (contiguous
bands), ``ring`` (a 1D ring of nodes along x, Table I) or ``random``
(seeded, drawn from ``np.random.default_rng(seed)`` as the JAX package
draws) object→node mappings.  The index arithmetic is a numpy copy of the
JAX package's; the problem is then built on ``device``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import comm_graph


def _factor2(p: int):
    a = int(np.sqrt(p))
    while p % a:
        a -= 1
    return a, p // a


def _factor3(p: int):
    best = (1, 1, p)
    for a in range(1, int(round(p ** (1 / 3))) + 2):
        if p % a:
            continue
        q = p // a
        b = int(np.sqrt(q))
        while q % b:
            b -= 1
        cand = tuple(sorted((a, b, q // b)))
        if max(cand) - min(cand) < max(best) - min(best):
            best = cand
    return best


def stencil_2d(nx: int, ny: int, num_nodes: int, *, mapping: str = "tiled",
               periodic: bool = True, bytes_per_edge: float = 1.0,
               base_load: float = 1.0, seed: int = 0,
               device="cuda") -> comm_graph.LBProblem:
    """One object per grid point, 5-point neighbor edges.  ``seed`` drives
    the ``"random"`` mapping only."""
    N = nx * ny
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()
    coords = np.stack([ii, jj], axis=1).astype(np.float32)

    edges = []
    for di, dj in ((1, 0), (0, 1)):
        ni, nj = ii + di, jj + dj
        if periodic:
            ni, nj = ni % nx, nj % ny
            keep = np.ones(N, bool)
        else:
            keep = (ni < nx) & (nj < ny)
            ni, nj = np.minimum(ni, nx - 1), np.minimum(nj, ny - 1)
        src = (ii * ny + jj)[keep]
        dst = (ni * ny + nj)[keep]
        edges.append(np.stack([src, dst], axis=1))
    edges = np.concatenate(edges)

    return comm_graph.make_problem(
        loads=np.full(N, base_load, np.float32),
        assignment=_map_2d(ii, jj, nx, ny, num_nodes, mapping, seed),
        edges=edges,
        edge_bytes=np.full(edges.shape[0], bytes_per_edge, np.float32),
        num_nodes=num_nodes, coords=coords, device=device)


def _map_2d(ii, jj, nx, ny, P, mapping, seed=0):
    if mapping == "tiled":
        px, py = _factor2(P)
        tx = (ii * px // nx).clip(0, px - 1)
        ty = (jj * py // ny).clip(0, py - 1)
        return (tx * py + ty).astype(np.int32)
    if mapping == "striped":
        # column-major stripes: contiguous column bands per node
        return (jj * P // ny).clip(0, P - 1).astype(np.int32)
    if mapping == "ring":
        # 1D ring of nodes along x (Table I setting)
        return (ii * P // nx).clip(0, P - 1).astype(np.int32)
    if mapping == "random":
        rng = np.random.default_rng(seed)
        return rng.integers(0, P, ii.shape[0]).astype(np.int32)
    raise ValueError(f"unknown mapping {mapping!r}")


def stencil_3d(nx: int, ny: int, nz: int, num_nodes: int, *,
               mapping: str = "tiled", periodic: bool = True,
               bytes_per_edge: float = 1.0, base_load: float = 1.0,
               seed: int = 0, device="cuda") -> comm_graph.LBProblem:
    """7-point 3D stencil (Table II).  ``mapping``: "tiled" (3D blocks),
    "striped" (contiguous ranges of the x-major order) or "random"."""
    N = nx * ny * nz
    ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    ii, jj, kk = ii.ravel(), jj.ravel(), kk.ravel()
    coords = np.stack([ii, jj, kk], axis=1).astype(np.float32)

    def lin(a, b, c):
        return (a * ny + b) * nz + c

    edges = []
    for d in ((1, 0, 0), (0, 1, 0), (0, 0, 1)):
        na, nb, nc = ii + d[0], jj + d[1], kk + d[2]
        if periodic:
            na, nb, nc = na % nx, nb % ny, nc % nz
            keep = np.ones(N, bool)
        else:
            keep = (na < nx) & (nb < ny) & (nc < nz)
            na, nb, nc = (np.minimum(na, nx - 1), np.minimum(nb, ny - 1),
                          np.minimum(nc, nz - 1))
        edges.append(np.stack([lin(ii, jj, kk)[keep],
                               lin(na, nb, nc)[keep]], axis=1))
    edges = np.concatenate(edges)

    if mapping == "tiled":
        px, py, pz = _factor3(num_nodes)
        tx = (ii * px // nx).clip(0, px - 1)
        ty = (jj * py // ny).clip(0, py - 1)
        tz = (kk * pz // nz).clip(0, pz - 1)
        assignment = ((tx * py + ty) * pz + tz).astype(np.int32)
    elif mapping == "striped":
        lin_id = lin(ii, jj, kk).astype(np.int64)
        assignment = (lin_id * num_nodes // N).clip(
            0, num_nodes - 1).astype(np.int32)
    elif mapping == "random":
        rng = np.random.default_rng(seed)
        assignment = rng.integers(0, num_nodes, N).astype(np.int32)
    else:
        raise ValueError(f"unknown mapping {mapping!r}")

    return comm_graph.make_problem(
        loads=np.full(N, base_load, np.float32), assignment=assignment,
        edges=edges,
        edge_bytes=np.full(edges.shape[0], bytes_per_edge, np.float32),
        num_nodes=num_nodes, coords=coords, device=device)
