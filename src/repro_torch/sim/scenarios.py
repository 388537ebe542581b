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

  serving-trace       — a recorded trace of the serving fleet replay's
                        bursty multi-turn sessions over replicas, with
                        prefix-sharing comm edges (``serve/replay.py``);
  routing-skew        — a recorded MoE expert-routing trace: EMA tokens per
                        expert as loads, co-activation comm edges over EP
                        ranks (``train/ep_runtime.py``).

``batch_instances`` instantiates every registered scenario at one common
shape for the batched replay.
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
    "serving-trace": lambda v, grid, num_nodes: dict(
        num_sessions=grid * grid, num_replicas=num_nodes,
        burst_period=20 + 5 * v, seed=v),
    "routing-skew": lambda v, grid, num_nodes: dict(
        num_experts=grid * grid, num_ranks=num_nodes,
        drift_period=12 + 4 * v, seed=v),
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


# --------------------------------------------------------- serving trace --


def _serving_trace(*, device, num_sessions: int = 256,
                   num_replicas: int = 16, group_size: int = 4,
                   trace_len: int = 64, turn_period: int = 12,
                   turn_len: int = 6, burst_waves: int = 4,
                   burst_period: int = 25, burst_amp: float = 3.0,
                   seed: int = 0):
    """A recorded serving trace as a registry workload: ``trace_len`` ticks
    of ``serve.replay.ServeWorkload``'s traffic in a ``(T, S)`` table,
    sessions as objects (identity fixed to the slot: the simulator moves
    no payload), replicas as nodes, the prefix-sharing star and ring edges
    (``comm_graph.prefix_group_edges``) re-priced from the floored loads
    every step.  The table loops past its length."""
    from repro_torch.serve import replay as serve_replay  # serve uses core

    w = serve_replay.ServeWorkload(
        num_sessions=num_sessions, num_replicas=num_replicas,
        group_size=group_size, turn_period=turn_period, turn_len=turn_len,
        burst_waves=burst_waves, burst_period=burst_period,
        burst_amp=burst_amp, seed=seed)
    trace = serve_replay.record_trace(w, steps=trace_len, device=device)
    table, group = trace.table, trace.group
    S, T = num_sessions, trace_len
    uid = torch.arange(S, dtype=torch.int32, device=device)
    assignment = torch.div(uid * num_replicas, S,
                           rounding_mode="floor").to(torch.int32)

    def edges(loads):
        return comm_graph.prefix_group_edges(group, loads, None)

    loads0 = finite_loads(table[0])
    es, ed, ew = edges(loads0)
    problem = comm_graph.LBProblem(
        loads=loads0, assignment=assignment, edges_src=es, edges_dst=ed,
        edges_bytes=ew, num_nodes=num_replicas)

    def evolve(p: comm_graph.LBProblem, t) -> comm_graph.LBProblem:
        row = torch.remainder(_step(t, device), T).reshape(1).long()
        loads = finite_loads(table.index_select(0, row)[0])
        _, _, ew = edges(loads)
        return dataclasses.replace(p, loads=loads, edges_bytes=ew)

    return problem, evolve


register(Scenario(
    "serving-trace",
    "trace-driven serving replay: recorded bursty multi-turn session "
    "loads with prefix-sharing comm edges (serve/replay.py)",
    _serving_trace,
    defaults=dict(num_sessions=256, num_replicas=16, group_size=4,
                  trace_len=64, turn_period=12, turn_len=6, burst_waves=4,
                  burst_period=25, burst_amp=3.0, seed=0),
))


# ---------------------------------------------------------- routing skew --


def _routing_skew(*, device, num_experts: int = 64, num_ranks: int = 8,
                  top_k: int = 4, tokens_per_step: int = 1024,
                  trace_len: int = 48, alpha: float = 1.0,
                  hot_frac: float = 0.25, hot_amp: float = 4.0,
                  drift_period: int = 16, edges_per_expert: int = 4,
                  ema: float = 0.9, seed: int = 0):
    """A recorded MoE expert-routing trace as a registry workload.

    ``trace_len`` steps of ``train.ep_runtime.RoutingWorkload``'s skewed
    drifting top-k traffic, replayed as EMA routing statistics: experts
    are the objects, EP ranks the nodes, loads the EMA tokens per expert;
    the comm graph is the static set of strongest co-activation pairs (the
    top ``edges_per_expert·E`` by total EMA co-activation over the trace,
    plus a ring for connectivity), re-weighted from the recorded EMA
    co-activation every step.  The statistics are computed in NumPy as the
    JAX package computes them (``np.argpartition`` included), so the edge
    set and every table entry are equal.  The table loops past its
    length."""
    from repro_torch.distributed import ep_balance  # uses core
    from repro_torch.train import ep_runtime

    E = num_experts
    w = ep_runtime.RoutingWorkload(
        num_experts=E, num_ranks=num_ranks, top_k=top_k,
        tokens_per_step=tokens_per_step, alpha=alpha, hot_frac=hot_frac,
        hot_amp=hot_amp, drift_period=drift_period, trace_len=trace_len,
        seed=seed)
    ids = w.ids_table()                              # (L, T, k)
    L = trace_len
    counts = np.zeros((L, E), np.float32)
    coact = np.zeros((L, E, E), np.float32)
    run_c = np.zeros(E)
    run_x = np.zeros((E, E))
    for t in range(L):
        c, x = ep_balance.pair_stats_np(ids[t], E)
        run_c = ema * run_c + (1.0 - ema) * c
        run_x = ema * run_x + (1.0 - ema) * x
        counts[t] = run_c
        coact[t] = run_x
    # static edge set: strongest persistent co-activation pairs + ring
    iu, ju = np.triu_indices(E, k=1)
    tot = coact.sum(axis=0)[iu, ju]
    M = min(len(iu), edges_per_expert * E)
    top = np.sort(np.argpartition(-tot, M - 1)[:M])
    ring = {(i, (i + 1) % E) for i in range(E)}
    ring |= {(j, i) for i, j in ring if i > j}
    pairs = sorted({(int(iu[m]), int(ju[m])) for m in top}
                   | {(min(a, b), max(a, b)) for a, b in ring})
    es = np.asarray([a for a, _ in pairs], np.int32)
    ed = np.asarray([b for _, b in pairs], np.int32)
    ew_table = torch.as_tensor(coact[:, es, ed] + 1e-3, device=device)
    counts_t = torch.as_tensor(counts, device=device)
    cap = E // num_ranks
    assignment = torch.div(torch.arange(E, dtype=torch.int32, device=device),
                           cap, rounding_mode="floor").to(torch.int32)
    problem = comm_graph.LBProblem(
        loads=finite_loads(counts_t[0]), assignment=assignment,
        edges_src=torch.as_tensor(es, device=device),
        edges_dst=torch.as_tensor(ed, device=device),
        edges_bytes=ew_table[0], num_nodes=num_ranks)

    def evolve(p: comm_graph.LBProblem, t) -> comm_graph.LBProblem:
        row = torch.remainder(_step(t, device), L).reshape(1).long()
        return dataclasses.replace(
            p, loads=finite_loads(counts_t.index_select(0, row)[0]),
            edges_bytes=ew_table.index_select(0, row)[0])

    return problem, evolve


register(Scenario(
    "routing-skew",
    "recorded MoE expert-routing trace: EMA tokens-per-expert loads and "
    "co-activation comm edges over EP ranks (train/ep_runtime.py)",
    _routing_skew,
    defaults=dict(num_experts=64, num_ranks=8, top_k=4,
                  tokens_per_step=1024, trace_len=48, alpha=1.0,
                  hot_frac=0.25, hot_amp=4.0, drift_period=16,
                  edges_per_expert=4, ema=0.9, seed=0),
))
