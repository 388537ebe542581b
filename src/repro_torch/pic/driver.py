"""PIC PRK end-to-end driver with integrated load balancing (paper §VI),
counterpart of ``repro.pic.driver``.

Each step, on one device:

  1. pushes the particles (``kernels.pic_push``);
  2. measures the chare loads (``kernels.histogram``);
  3. asks the trigger whether to rebalance (``runtime.triggers``);
  4. when it fires, plans with the registered strategy (``core.engine``)
     and executes the plan as a particle exchange (``runtime.migrate``,
     whose manifest comes from ``kernels.migrate``).

Particles, loads and the assignment stay on the device; per-step metrics
are kept as device scalars and copied to the host once, after the run.
The host reads one scalar per step — the trigger's decision (none for the
fixed ``every`` cadence) — plus the planner's loop flags on fired steps.
Final positions come back in particle-id order.

A host planner (``greedy-refine``, ``metis``, ..., ``Strategy.host``)
plans inside the same loop: on fired steps its ``plan_fn`` reads the
chare problem to the host and puts the assignment back on the device, and
the exchange runs on the device as for any strategy.  The JAX package
runs such strategies in its host loop, which takes chare ids with a
float64 NumPy floor division and per-PE loads with a float64
``np.bincount``; this loop keeps the float32 device versions, which give
the same chare ids wherever the chare width is exact in float32 (as at
the test sizes), and ``max_avg`` within float32 rounding.

``lb_seconds``: a device planner is charged one warmed-up estimate (its
plan timed once on the initial snapshot) at every fired step, as the JAX
package's scanned path charges it; a host planner is timed at each fired
plan, synchronized, as the JAX host loop times it.

Not in this slice (they raise ``NotImplementedError``): two-level
placement (``threads_per_node``), telemetry, the sharded replay and its
fault injection.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import engine as core_engine
from repro_torch.core.comm_graph import segment_sum
from repro_torch.core.metrics import EXT_INT_ALL_EXTERNAL
from repro_torch.kernels import resolve_device
from repro_torch.kernels.histogram.ops import histogram
from repro_torch.kernels.pic_push.ops import pic_push
from repro_torch.pic import chares as ch
from repro_torch.pic.grid import alternating_grid
from repro_torch.pic.particles import initialize
from repro_torch.runtime import migrate as rt_migrate
from repro_torch.runtime import triggers as rt_triggers


@dataclasses.dataclass
class PICConfig:
    L: int = 1000
    n_particles: int = 100_000
    steps: int = 100
    k: int = 2
    rho: float = 0.9
    vy0: float = 1.0
    mode: str = "GEOMETRIC"
    cx: int = 12
    cy: int = 12
    num_pes: int = 4
    mapping: str = "striped"
    lb_every: int = 10
    strategy: str = "diff-comm"
    strategy_kwargs: Optional[Dict] = None
    # None → the strategy's registered trigger, else the fixed lb_every
    # cadence; "every" / "threshold" / "predictive" or a Trigger instance
    trigger: Optional[object] = None
    # sweeps per diffusion chunk in the planner (None: engine default)
    sweep_chunk: Optional[int] = None
    bytes_per_particle: float = 48.0
    seed: int = 0
    device: str = "cuda"
    # later slices: each raises NotImplementedError when set
    threads_per_node: Optional[int] = None
    telemetry: Optional[object] = None
    sharded_replay: bool = False
    faults: Optional[object] = None


@dataclasses.dataclass
class CostModel:
    """Per-term model for simulated strong scaling (Fig 5).

    t_particle — seconds per particle push on one PE;
    t_byte     — seconds per byte crossing a node boundary;
    diffusion planning is a distributed algorithm, so its measured wall
    time is divided by num_pes; centralized planners pay it in full."""
    t_particle: float = 2.0e-8
    t_byte: float = 2.0e-8

    def lb_seconds(self, wall: float, strategy: str, num_pes: int) -> float:
        if strategy.startswith("diff"):
            return wall / max(num_pes, 1)
        return wall


@dataclasses.dataclass
class PICResult:
    max_avg: np.ndarray         # (T,) max/avg particles per PE
    ext_bytes: np.ndarray       # (T,) external comm bytes per step
    int_bytes: np.ndarray       # (T,)
    migrations: np.ndarray      # (T,) fraction of chares moved (LB steps)
    migrated_bytes: np.ndarray  # (T,) particle bytes moved by LB
    lb_seconds: float
    step_seconds: np.ndarray    # (T,) modeled time per step
    final_x: np.ndarray
    final_y: np.ndarray
    wall_seconds: float = 0.0   # wall time of the step loop (synchronized)
    lb_steps: Optional[np.ndarray] = None  # (T,) 1.0 where LB executed

    def summary(self) -> Dict[str, float]:
        # mean ext/int ratio; all-external steps use the metrics sentinel
        ratio = np.where(
            self.int_bytes > 0,
            self.ext_bytes / np.where(self.int_bytes > 0,
                                      self.int_bytes, 1.0),
            np.where(self.ext_bytes > 0, EXT_INT_ALL_EXTERNAL, 0.0))
        return dict(
            mean_max_avg=float(self.max_avg.mean()),
            mean_ext_bytes=float(self.ext_bytes.mean()),
            mean_ext_int=float(ratio.mean()),
            total_migrated_bytes=float(self.migrated_bytes.sum()),
            lb_seconds=float(self.lb_seconds),
            modeled_time=float(self.step_seconds.sum()),
            wall_seconds=float(self.wall_seconds),
        )


def _lb_amort(cfg: PICConfig, trig) -> int:
    """Steps one plan's cost is amortized over in the modeled step time."""
    if isinstance(trig, rt_triggers.EveryTrigger):
        return max(cfg.lb_every, 1)
    return 1


def _check_slice(cfg: PICConfig) -> None:
    later = [("threads_per_node", cfg.threads_per_node is not None,
              "two-level placement"),
             ("telemetry", cfg.telemetry is not None, "telemetry"),
             ("sharded_replay", cfg.sharded_replay,
              "sharded planning and replay"),
             ("faults", cfg.faults is not None,
              "sharded planning and replay")]
    for field, on, slice_name in later:
        if on:
            raise NotImplementedError(
                f"PICConfig.{field} belongs to the {slice_name} slice of "
                "the port, not yet ported")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cfg: PICConfig, cost: CostModel = CostModel()) -> PICResult:
    _check_slice(cfg)
    dev = resolve_device(cfg.device)
    kw = dict(cfg.strategy_kwargs or {})
    if cfg.sweep_chunk is not None and cfg.strategy.startswith("diff"):
        kw["sweep_chunk"] = cfg.sweep_chunk
    strat = core_engine.get_strategy(cfg.strategy)   # KeyError if unknown
    trig = rt_triggers.resolve_for_strategy(
        cfg.trigger, lb_every=cfg.lb_every, strategy=cfg.strategy)
    lb_on = cfg.strategy != "none" and not trig.never
    plan = strat.bind(**kw)
    L, cx, cy, P = cfg.L, cfg.cx, cfg.cy, cfg.num_pes
    n_chares = cx * cy
    bpp = cfg.bytes_per_particle

    p = initialize(cfg.mode, L, cfg.n_particles, k=cfg.k, vy0=cfg.vy0,
                   rho=cfg.rho, seed=cfg.seed)
    x, y, vx, vy, q = (torch.as_tensor(a, device=dev)
                       for a in (p.x, p.y, p.vx, p.vy, p.q))
    grid_q = torch.as_tensor(alternating_grid(L), device=dev)
    assignment = torch.as_tensor(
        ch.initial_mapping(cx, cy, P, cfg.mapping), device=dev)
    chare_id = ch.chare_of_device(x, y, L, cx, cy)
    perm = torch.arange(cfg.n_particles, dtype=torch.int32, device=dev)
    ones = torch.ones(cfg.n_particles, dtype=torch.float32, device=dev)

    def problem_of(loads, a):
        return ch.build_problem(loads, a, L=L, cx=cx, cy=cy, num_pes=P,
                                k=cfg.k, vy0=cfg.vy0, lb_period=cfg.lb_every,
                                bytes_per_particle=bpp)

    # planning cost for the CostModel: a device planner's measured once
    # on the initial snapshot (after a warm-up call) and charged at every
    # LB step; a host planner's timed at each fired plan
    lb_est = 0.0
    plan_s = np.zeros(cfg.steps)
    if lb_on and not strat.host:
        problem0 = problem_of(histogram(chare_id, ones, C=n_chares),
                              assignment)
        strat.run(problem0, **kw)
        lb_est = strat.run(problem0, **kw).info["plan_seconds"]

    tstate = trig.init_state(dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    rows = []                               # per-step device scalars
    _sync(dev)
    t_start = time.perf_counter()
    for t in range(cfg.steps):
        x, y, vx, vy = pic_push(grid_q, x, y, vx, vy, q, L=L)
        new_chare = ch.chare_of_device(x, y, L, cx, cy)
        # particle handoffs: chare changed → bytes move; PE boundary → ext
        moved = new_chare != chare_id
        crossed = assignment[chare_id.long()] != assignment[new_chare.long()]
        ext = (moved & crossed).sum().to(torch.float32) * bpp
        intra = (moved & ~crossed).sum().to(torch.float32) * bpp
        chare_id = new_chare

        loads = histogram(chare_id, ones, C=n_chares)
        pe_loads = segment_sum(loads, assignment, P)
        pe_max = pe_loads.max()
        ma = pe_max / (pe_loads.mean() + 1e-30)

        migf = migb = fired = zero
        if lb_on:
            mx, av, tot = rt_triggers.load_stats(loads, assignment, P)
            do, tstate = trig.decide(tstate, t, mx, av, tot)
            do = bool(do)                   # the step's one device read
            if do:
                problem = problem_of(loads, assignment)
                if strat.host:
                    _sync(dev)
                    t_plan = time.perf_counter()
                new_assignment, _ = plan(problem)
                if strat.host:
                    _sync(dev)
                    plan_s[t] = time.perf_counter() - t_plan
                new_assignment = new_assignment.to(torch.int32)
                migf = (new_assignment != assignment).to(
                    torch.float32).mean()
                # execute the plan: relocate particle payload into the
                # PE-owned slot regions; bytes measured from the exchange
                owner_old = assignment[chare_id.long()]
                owner_new = new_assignment[chare_id.long()]
                (x, y, vx, vy, q, chare_id, perm), man = \
                    rt_migrate.build_and_apply(
                        owner_old, owner_new,
                        (x, y, vx, vy, q, chare_id, perm), num_nodes=P)
                moved_n = man.moved_count.to(torch.float32)
                migb = moved_n * bpp
                fired = torch.ones((), dtype=torch.float32, device=dev)
                assignment = new_assignment
                # measured feedback for the predictive gate (particles)
                tstate = trig.observe(tstate, moved_n, True)
        rows.append(torch.stack([ma, pe_max, ext, intra, migf, migb, fired]))
    _sync(dev)
    wall = time.perf_counter() - t_start

    stats = torch.stack(rows).cpu().numpy().astype(np.float64)
    ma, pe_max, ext_b, int_b, mig, mig_bytes, fired = stats.T
    lb_s_t = plan_s if strat.host else np.where(fired > 0, lb_est, 0.0)
    step_s = (pe_max * cost.t_particle
              + (ext_b + mig_bytes) * cost.t_byte
              + np.array([cost.lb_seconds(s, cfg.strategy, P)
                          for s in lb_s_t]) / _lb_amort(cfg, trig))
    # the particles are slot-ordered (bucketed by owning PE); report them
    # in particle-id order, undoing the exchanges
    order = perm.long()
    fx = torch.empty_like(x)
    fy = torch.empty_like(y)
    fx[order] = x
    fy[order] = y
    return PICResult(ma, ext_b, int_b, mig, mig_bytes,
                     float(lb_s_t.sum()), step_s,
                     fx.cpu().numpy(), fy.cpu().numpy(), wall_seconds=wall,
                     lb_steps=fired)
