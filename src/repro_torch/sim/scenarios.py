"""Scenario registry: named time-evolving workloads for the replay layers
(counterpart of ``repro.sim.scenarios``).

A scenario bundles an initial :class:`LBProblem` with an
``evolve(problem, t) -> problem`` that runs on the problem's device: loads
(and edge bytes, where they track loads) are recomputed from the step
index, never accumulated, so the device-resident and host replays see the
same workload.  ``t`` is taken as an int32 tensor, the type the JAX
package's scanned replay gives it, so the arithmetic follows the same f32
path.  Every registered evolve carries ``evolve.device_resident = True``,
which lets ``sim.simulator.run_series`` pick its device-resident loop.

Registered workloads:

  stencil-wave        — load hotspot orbiting a 2D stencil (the paper's §V
                        simulator setting);
  pic-geometric       — chare-level PIC PRK proxy: the geometric particle
                        column profile advects east at (2k+1) cells/step,
                        edge bytes follow the loads (paper §VI);
  adversarial-hotspot — a hotspot that teleports across the domain every
                        ``dwell`` steps (worst case for one-hop diffusion);
  bimodal-churn       — bimodal object loads whose heavy-set membership
                        churns over time.

``batch_instances`` instantiates every registered scenario at one common
shape for the batched replay.  ``serving-trace`` and ``routing-skew`` come
with the serving-replay and MoE slices of the port.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import comm_graph
from repro_torch.kernels import resolve_device
from repro_torch.pic import chares
from repro_torch.sim import stencil

EvolveFn = Callable[[comm_graph.LBProblem, object], comm_graph.LBProblem]


def finite_loads(loads, floor: float = 1e-3) -> torch.Tensor:
    """Shared finite guard for evolved load vectors: non-finite entries
    become ``floor`` and finite ones are clamped to at least ``floor`` (a
    bitwise identity on the loads every registered scenario produces)."""
    loads = torch.as_tensor(loads, dtype=torch.float32)
    return torch.where(torch.isfinite(loads),
                       torch.clamp(loads, min=floor),
                       torch.full_like(loads, floor))


def _step(t, device) -> torch.Tensor:
    """The step index as an int32 0-d tensor on ``device``."""
    return torch.as_tensor(t, dtype=torch.int32, device=device)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named workload: ``factory(device=..., **kw) -> (problem, evolve)``."""

    name: str
    description: str
    factory: Callable[..., Tuple[comm_graph.LBProblem, EvolveFn]]
    defaults: Mapping = dataclasses.field(default_factory=dict)
    # PICConfig field overrides for the particle-level driver; None for
    # purely simulator-level scenarios
    pic_config: Optional[Mapping] = None

    def instantiate(self, device="cuda", **overrides):
        """(problem, evolve) for this workload on ``device``.

        Memoized on the device and the parameter set, so re-instantiating
        returns the same evolve object."""
        dev = resolve_device(device)
        kw = {**self.defaults, **overrides}
        try:
            key = (self.name, str(dev), tuple(sorted(kw.items())))
            hash(key)
        except TypeError:
            key = None  # unhashable override: fall through uncached
        if key is not None and key in _INSTANCE_MEMO:
            return _INSTANCE_MEMO[key]
        problem, evolve = self.factory(device=dev, **kw)
        evolve.device_resident = True
        if key is not None:
            _INSTANCE_MEMO[key] = (problem, evolve)
        return problem, evolve


_INSTANCE_MEMO: Dict = {}

SCENARIOS: Dict[str, Scenario] = {}


def register(s: Scenario) -> Scenario:
    SCENARIOS[s.name] = s
    return s


def get(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; available: {sorted(SCENARIOS)}"
        ) from None


def available() -> Tuple[str, ...]:
    return tuple(sorted(SCENARIOS))


#: per scenario, ``(replica v, grid, num_nodes) -> instantiate kwargs`` at
#: the common shape of ``batch_instances`` (the JAX package's entries)
BATCH_VARIANTS: Dict[str, Callable[[int, int, int], Dict]] = {
    "stencil-wave": lambda v, grid, num_nodes: dict(
        grid=grid, num_nodes=num_nodes, period=40 + 10 * v,
        amp=6.0 + 2.0 * v),
    "adversarial-hotspot": lambda v, grid, num_nodes: dict(
        grid=grid, num_nodes=num_nodes, dwell=6 + 2 * v, seed=v),
    "bimodal-churn": lambda v, grid, num_nodes: dict(
        grid=grid, num_nodes=num_nodes, churn_every=4 + v, seed=v),
    "pic-geometric": lambda v, grid, num_nodes: dict(
        cx=grid, cy=grid, num_pes=num_nodes, rho=0.85 + 0.03 * v,
        n_particles=20_000.0),
}


def batch_instances(batch: int = 16, *, grid: int = 16, num_nodes: int = 16,
                    device="cuda"):
    """B ``(name, problem, evolve)`` instances at one common shape.

    Feeds ``simulator.run_series_batch``: every registered scenario is
    instantiated at the same ``(N, P)`` envelope — the stencil family at
    ``grid²`` objects / ``num_nodes`` nodes, the PIC proxy at a
    ``grid×grid`` chare array over ``num_nodes`` PEs — cycling through the
    names in sorted order; replicas beyond one a scenario vary workload
    parameters (period, dwell, churn seed, density), so the B lanes are
    independent problems, not copies.

    Raises for a registered scenario without a :data:`BATCH_VARIANTS`
    entry: the batched sweeps cover the whole registry, so a new scenario
    must be taught its shape there rather than silently dropped."""
    missing = sorted(set(SCENARIOS) - set(BATCH_VARIANTS))
    if missing:
        raise ValueError(
            f"scenarios {missing} have no common-shape variant entry in "
            "batch_instances; add one so the batched sweeps keep covering "
            "the whole registry")
    names = sorted(SCENARIOS)
    out = []
    for i in range(batch):
        name = names[i % len(names)]
        kw = BATCH_VARIANTS[name](i // len(names), grid, num_nodes)
        problem, evolve = SCENARIOS[name].instantiate(device=device, **kw)
        out.append((name, problem, evolve))
    return out


# ------------------------------------------------------------ stencil wave --


def _stencil_wave(*, device, grid: int = 32, num_nodes: int = 16,
                  mapping: str = "tiled", period: int = 60,
                  amp: float = 8.0, seed: int = 0):
    problem = stencil.stencil_2d(grid, grid, num_nodes, mapping=mapping,
                                 seed=seed, device=device)
    cx0, cy0 = problem.coords[:, 0], problem.coords[:, 1]
    sigma2 = torch.tensor(2.0 * (grid / 8.0) ** 2, dtype=torch.float32,
                          device=device)

    def evolve(p: comm_graph.LBProblem, t) -> comm_graph.LBProblem:
        angle = 2.0 * math.pi * _step(t, device) / period
        cx = grid / 2.0 + grid / 3.0 * torch.cos(angle)
        cy = grid / 2.0 + grid / 3.0 * torch.sin(angle)
        d2 = (cx0 - cx) ** 2 + (cy0 - cy) ** 2
        loads = 1.0 + amp * torch.exp(-d2 / sigma2)
        return dataclasses.replace(p, loads=finite_loads(loads))

    return problem, evolve


register(Scenario(
    "stencil-wave",
    "load hotspot orbiting a 2D stencil grid (paper §V)",
    _stencil_wave,
    defaults=dict(grid=32, num_nodes=16, mapping="tiled", period=60,
                  amp=8.0, seed=0),
))


# ----------------------------------------------------------- PIC geometric --


def _pic_geometric(*, device, L: int = 1000, cx: int = 12, cy: int = 12,
                   num_pes: int = 4, k: int = 2, vy0: float = 1.0,
                   rho: float = 0.9, lb_period: int = 10,
                   n_particles: float = 100_000.0,
                   bytes_per_particle: float = 48.0,
                   mapping: str = "striped"):
    n = cx * cy
    w = L / cx
    # chare-column center cell, one per chare (loads are uniform along y)
    col = (torch.div(torch.arange(n, dtype=torch.float32, device=device),
                     cy, rounding_mode="floor") + 0.5) * w
    speed = torch.tensor(2 * k + 1, dtype=torch.float32, device=device)
    rho32 = torch.tensor(rho, dtype=torch.float32, device=device)
    assignment = torch.as_tensor(
        chares.initial_mapping(cx, cy, num_pes, mapping), device=device)

    def loads_at(t):
        # geometric column density, advected east with wraparound
        shifted = torch.remainder(col - speed * _step(t, device), L)
        dens = torch.pow(rho32, shifted)
        return dens / dens.sum() * n_particles

    def evolve(p: comm_graph.LBProblem, t) -> comm_graph.LBProblem:
        loads = loads_at(t)
        eb = chares.edge_bytes_device(
            loads, L=L, cx=cx, cy=cy, k=k, vy0=vy0, lb_period=lb_period,
            bytes_per_particle=bytes_per_particle)
        return dataclasses.replace(
            p, loads=finite_loads(loads), edges_bytes=eb)

    problem = chares.build_problem(
        loads_at(0), assignment, L=L, cx=cx, cy=cy, num_pes=num_pes, k=k,
        vy0=vy0, lb_period=lb_period, bytes_per_particle=bytes_per_particle)
    return problem, evolve


register(Scenario(
    "pic-geometric",
    "chare-level PIC PRK proxy: geometric column profile drifting east "
    "(paper §VI)",
    _pic_geometric,
    defaults=dict(L=1000, cx=12, cy=12, num_pes=4, k=2, vy0=1.0, rho=0.9,
                  lb_period=10, n_particles=100_000.0, mapping="striped"),
    pic_config=dict(mode="GEOMETRIC", L=1000, cx=12, cy=12, num_pes=4,
                    k=2, rho=0.9, mapping="striped", lb_every=10),
))


# ---------------------------------------------------- adversarial hotspot --


def _adversarial_hotspot(*, device, grid: int = 32, num_nodes: int = 16,
                         mapping: str = "tiled", dwell: int = 8,
                         amp: float = 12.0, n_sites: int = 16,
                         seed: int = 0):
    # seed drives both the teleport sites and a "random" initial mapping
    problem = stencil.stencil_2d(grid, grid, num_nodes, mapping=mapping,
                                 seed=seed, device=device)
    coords = problem.coords
    rng = np.random.default_rng(seed)
    sites = torch.as_tensor(
        rng.uniform(0, grid, size=(n_sites, 2)).astype(np.float32),
        device=device)
    sigma2 = torch.tensor(2.0 * (grid / 10.0) ** 2, dtype=torch.float32,
                          device=device)

    def evolve(p: comm_graph.LBProblem, t) -> comm_graph.LBProblem:
        phase = torch.div(_step(t, device), dwell, rounding_mode="floor")
        c = sites[torch.remainder(phase, n_sites).long()]
        d2 = ((coords - c[None, :]) ** 2).sum(dim=1)
        loads = 1.0 + amp * torch.exp(-d2 / sigma2)
        return dataclasses.replace(p, loads=finite_loads(loads))

    return problem, evolve


register(Scenario(
    "adversarial-hotspot",
    "hotspot teleporting across the domain every `dwell` steps — worst "
    "case for one-hop diffusive migration",
    _adversarial_hotspot,
    defaults=dict(grid=32, num_nodes=16, mapping="tiled", dwell=8,
                  amp=12.0, n_sites=16, seed=0),
))


# --------------------------------------------------------- bimodal churn --


def _bimodal_churn(*, device, grid: int = 32, num_nodes: int = 16,
                   mapping: str = "tiled", heavy_frac: float = 0.1,
                   heavy_load: float = 20.0, churn_every: int = 5,
                   stride: int = 7919, seed: int = 0):
    # seed drives both the churn permutation and a "random" initial mapping
    problem = stencil.stencil_2d(grid, grid, num_nodes, mapping=mapping,
                                 seed=seed, device=device)
    N = grid * grid
    rng = np.random.default_rng(seed)
    perm = torch.as_tensor(rng.permutation(N).astype(np.int32),
                           device=device)
    heavy_count = max(1, int(heavy_frac * N))

    def evolve(p: comm_graph.LBProblem, t) -> comm_graph.LBProblem:
        phase = torch.div(_step(t, device), churn_every,
                          rounding_mode="floor")
        # deterministic churn: rotate the permutation ranks each phase
        rank = torch.remainder(perm + phase * stride, N)
        loads = torch.where(rank < heavy_count,
                            torch.tensor(heavy_load, device=device),
                            torch.tensor(1.0, device=device))
        return dataclasses.replace(p, loads=finite_loads(loads))

    return problem, evolve


register(Scenario(
    "bimodal-churn",
    "bimodal loads whose heavy-set membership churns every few steps "
    "(unpredictable imbalance)",
    _bimodal_churn,
    defaults=dict(grid=32, num_nodes=16, mapping="tiled", heavy_frac=0.1,
                  heavy_load=20.0, churn_every=5, stride=7919, seed=0),
))
