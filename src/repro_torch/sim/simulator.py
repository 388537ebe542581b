"""Load-balancing simulation (paper §V), counterpart of
``repro.sim.simulator``.

The paper's simulator replays strategies on snapshots of an application at
any scale on one process; ours does the same for ``LBProblem`` instances.
``compare`` runs a set of strategies on one snapshot; ``run_series``
replays a time-evolving workload with trigger-policed rebalancing.

``run_series`` has two loops:

  * **device-resident** (``scan=True``; the default for a device planner
    and an evolve marked ``device_resident``, as every scenario of
    ``sim/scenarios.py`` is): evolve, trigger and plan stay on the
    problem's device, per-step records are 0-d device tensors copied to
    the host once, after the run.  The host reads only the trigger's
    decision (nothing for the fixed ``every`` cadence) and, on fired
    steps, the planner's loop flags.
  * **host loop** (``scan=False``; the default for a host planner such as
    ``greedy-refine`` or ``metis``, ``engine.Strategy.host``): eager
    planning through ``core.api.run_strategy`` with per-step host
    metrics, also for host-side ``evolve`` callables.

``run_series_batch`` replays B workloads at a common shape (e.g.
``scenarios.batch_instances``) under one fixed cadence.

Later slices of the port bring ``threads_per_node``, telemetry and
``run_series_sharded``; here they raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import api, comm_graph, engine, metrics
from repro_torch.runtime import triggers as rt_triggers


@dataclasses.dataclass
class CompareRow:
    strategy: str
    before: Dict[str, float]
    after: Dict[str, float]
    info: Dict


def compare(problem: comm_graph.LBProblem, strategies: Sequence[str],
            strategy_kwargs: Optional[Dict[str, Dict]] = None
            ) -> List[CompareRow]:
    """Plan one snapshot with each strategy; before/after metrics."""
    strategy_kwargs = strategy_kwargs or {}
    before = metrics.evaluate(problem)
    loads = problem.loads.cpu().numpy().astype(np.float32)
    initial = problem.assignment.cpu().numpy()
    rows = []
    for name in strategies:
        plan = api.run_strategy(name, problem,
                                **strategy_kwargs.get(name, {}))
        after = metrics.evaluate(problem, torch.as_tensor(
            plan.assignment, device=problem.device))
        # load volume the plan would migrate (the §II metric-3 numerator)
        moved = np.asarray(plan.assignment) != initial
        plan.info["migrated_load"] = float(
            np.where(moved, loads, np.float32(0)).sum())
        rows.append(CompareRow(name, before, after, plan.info))
    return rows


def format_table(rows: List[CompareRow]) -> str:
    """Paper-Table-II-style text table."""
    cols = ["strategy", "max/avg", "ext/int", "%migr", "plan_s"]
    out = ["  ".join(f"{c:>12}" for c in cols)]
    if rows:
        b = rows[0].before
        out.append("  ".join([
            f"{'(initial)':>12}", f"{b['max_avg_load']:>12.3f}",
            f"{b['ext_int_comm']:>12.3f}", f"{'-':>12}", f"{'-':>12}",
        ]))
    for r in rows:
        out.append("  ".join([
            f"{r.strategy:>12}",
            f"{r.after['max_avg_load']:>12.3f}",
            f"{r.after['ext_int_comm']:>12.3f}",
            f"{100*r.after['pct_migrations']:>11.1f}%",
            f"{r.info.get('plan_seconds', float('nan')):>12.3f}",
        ]))
    return "\n".join(out)


@dataclasses.dataclass
class SeriesResult:
    max_avg: np.ndarray        # (T,) per step
    ext_int: np.ndarray        # (T,)
    migrations: np.ndarray     # (T,) fraction moved at that step (0 if no LB)
    plan_seconds: float        # cumulative planning wall time (both loops)
    scanned: bool = False      # True for the device-resident loop
    wall_seconds: float = 0.0  # total replay wall time (both loops)
    # two-level placement (later slice): always None here
    thread_max_avg: Optional[np.ndarray] = None
    # per-step records: whether the trigger fired, the max node load, and
    # the total load of the objects the rebalance moved — the inputs to
    # ``runtime.cost.series_modeled_seconds``
    lb_fired: Optional[np.ndarray] = None      # (T,) 0/1
    max_load: Optional[np.ndarray] = None      # (T,)
    migrated_load: Optional[np.ndarray] = None  # (T,)
    # (N,) final object→node assignment after the last step
    final_assignment: Optional[np.ndarray] = None
    # resilient sharded replay and telemetry (later slices): always None
    plan_rejected: Optional[np.ndarray] = None
    telemetry: Optional[object] = None
    # (T,) planning wall seconds of each fired step (0 elsewhere); the JAX
    # package's scanned replay cannot time a plan inside its scan
    plan_step_seconds: Optional[np.ndarray] = None


def _later_slice(what: str, slice_name: str):
    raise NotImplementedError(
        f"{what} belongs to the {slice_name} slice of the port, not yet "
        "ported")


def _check_slice(threads_per_node, telemetry) -> None:
    if threads_per_node is not None:
        _later_slice("run_series(threads_per_node=...)",
                     "two-level placement")
    if telemetry is not None:
        _later_slice("run_series(telemetry=...)", "telemetry")


def run_series(
    initial: comm_graph.LBProblem,
    evolve: Callable[[comm_graph.LBProblem, int], comm_graph.LBProblem],
    *,
    steps: int,
    lb_every: int,
    strategy: str = "diff-comm",
    strategy_kwargs: Optional[Dict] = None,
    scan: Optional[bool] = None,
    threads_per_node: Optional[int] = None,
    trigger=None,
    telemetry=None,
) -> SeriesResult:
    """Replay ``steps`` of a workload with trigger-policed rebalancing.

    ``evolve(problem, t)`` advances loads/comm one application step while
    keeping the current assignment.  ``trigger`` selects the rebalancing
    policy (``runtime.triggers``): ``None`` takes the strategy's registered
    trigger, then the fixed ``lb_every`` period.  ``scan=True`` runs the
    device-resident loop, ``scan=False`` the host loop; ``None`` picks the
    device-resident loop for a device planner and an evolve marked
    ``device_resident``, else the host loop.  Both loops fire on the same
    steps and plan alike.  A host planner with ``scan=True`` raises
    ``ValueError``."""
    _check_slice(threads_per_node, telemetry)
    strategy_kwargs = strategy_kwargs or {}
    strat = engine.get_strategy(strategy)        # KeyError if unknown
    trig = rt_triggers.resolve_for_strategy(trigger, lb_every=lb_every,
                                            strategy=strategy)
    if scan and strat.host:
        raise ValueError(
            f"strategy {strategy!r} is not jittable: it plans on the host; "
            "the device-resident replay needs a device plan_fn (use "
            "scan=False or a diff-* / none strategy)")
    if scan is None:
        scan = (not strat.host
                and bool(getattr(evolve, "device_resident", False)))
    run = _run_series_device if scan else _run_series_host
    return run(initial, evolve, steps=steps, strategy=strategy,
               strategy_kwargs=strategy_kwargs, trig=trig)


@dataclasses.dataclass
class BatchSeriesResult:
    """A replay of B workloads: per-lane series and the batch's wall."""

    series: List[SeriesResult]   # one per input instance, in order
    wall_seconds: float          # wall time of the whole batched replay
    steps: int

    @property
    def batch(self) -> int:
        return len(self.series)

    @property
    def lane_steps_per_sec(self) -> float:
        """Aggregate throughput: (B × T) scenario-steps per second."""
        return self.batch * self.steps / max(self.wall_seconds, 1e-12)


def run_series_batch(instances: Sequence, *, steps: int, lb_every: int,
                     strategy: str = "diff-comm",
                     strategy_kwargs: Optional[Dict] = None
                     ) -> BatchSeriesResult:
    """Replay B workloads under the fixed ``lb_every`` cadence.

    ``instances`` is a sequence of ``(problem, evolve)`` pairs, or
    ``(name, problem, evolve)`` triples as ``scenarios.batch_instances``
    gives them, at a common ``(num_nodes, num_objects)`` shape; every
    evolve must be ``device_resident`` and the strategy a device planner
    without a trigger of its own.

    The JAX package runs the B lanes as one vmapped scan.  The planner's
    data-dependent loops cannot be traced by ``torch.vmap``, so here the
    lanes run one after another, each as ``run_series``'s device-resident
    loop on its problem's device; each lane's ``SeriesResult`` is that
    run's own, and ``wall_seconds`` is the synchronized wall time of the
    whole batch."""
    strategy_kwargs = strategy_kwargs or {}
    strat = engine.get_strategy(strategy)
    if strat.host:
        raise ValueError(
            f"strategy {strategy!r} is not jittable: it plans on the host; "
            "the batched replay needs a device plan_fn (diff-* / none)")
    if strat.trigger is not None:
        raise ValueError(
            f"strategy {strategy!r} carries an adaptive trigger; the "
            "batched replay only supports the fixed lb_every cadence — "
            "use run_series or the base strategy")
    pairs = [inst[-2:] for inst in instances]
    for _, ev in pairs:
        if not getattr(ev, "device_resident", False):
            raise ValueError(
                "every evolve in a batched replay must be device-resident "
                "(scenarios from sim/scenarios.py are)")
    comm_graph.common_shape([p for p, _ in pairs])
    trig = rt_triggers.resolve(None, lb_every=lb_every)
    devices = {p.device for p, _ in pairs}
    for dev in devices:
        _sync(dev)
    t_start = time.perf_counter()
    series = [_run_series_device(p, ev, steps=steps, strategy=strategy,
                                 strategy_kwargs=strategy_kwargs, trig=trig)
              for p, ev in pairs]
    for dev in devices:
        _sync(dev)
    return BatchSeriesResult(series, time.perf_counter() - t_start, steps)


def run_series_sharded(initial, evolve, **kwargs):
    """Mesh-sharded ``run_series``: the sharded replay slice."""
    _later_slice("run_series_sharded", "sharded planning and replay")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------------- host loop --


def _run_series_host(initial, evolve, *, steps, strategy, strategy_kwargs,
                     trig) -> SeriesResult:
    dev = initial.device
    t_start = time.perf_counter()
    problem = initial
    ma, ei, mig, fired, mxl, migl = [], [], [], [], [], []
    plan_t = np.zeros(steps)
    lb_on = strategy != "none" and not trig.never
    # the fixed cadence ignores the load stats: decide it on the host
    is_every = isinstance(trig, rt_triggers.EveryTrigger)
    tstate = trig.init_state(dev)
    for t in range(steps):
        problem = evolve(problem, t)
        do = False
        if lb_on:
            if is_every:
                do = t > 0 and t % trig.every == 0
            else:
                mx, av, tot = rt_triggers.load_stats(
                    problem.loads, problem.assignment, problem.num_nodes)
                d, tstate = trig.decide(tstate, t, mx, av, tot)
                do = bool(d)
        if do:
            plan = api.run_strategy(strategy, problem, **strategy_kwargs)
            delta = plan.assignment != problem.assignment.cpu().numpy()
            mig.append(float(np.mean(delta)))
            migl.append(float(torch.where(
                torch.as_tensor(delta, device=dev),
                problem.loads.to(torch.float32), 0.0).sum()))
            problem = problem.with_assignment(
                torch.as_tensor(plan.assignment, device=dev))
            plan_t[t] = plan.info["plan_seconds"]
        else:
            mig.append(0.0)
            migl.append(0.0)
        if lb_on and not is_every:
            # executed exchange volume for the measured predictive gate
            tstate = trig.observe(
                tstate, torch.tensor(migl[-1], dtype=torch.float32,
                                     device=dev), do)
        fired.append(1.0 if do else 0.0)
        m = metrics.evaluate(problem)
        ma.append(m["max_avg_load"])
        ei.append(m["ext_int_comm"])
        mxl.append(m["max_load"])
    return SeriesResult(
        np.array(ma), np.array(ei), np.array(mig), float(plan_t.sum()),
        scanned=False, wall_seconds=time.perf_counter() - t_start,
        lb_fired=np.array(fired), max_load=np.array(mxl),
        migrated_load=np.array(migl),
        final_assignment=problem.assignment.cpu().numpy().astype(np.int32),
        plan_step_seconds=plan_t)


# ------------------------------------------------- device-resident loop --


def _run_series_device(initial, evolve, *, steps, strategy, strategy_kwargs,
                       trig) -> SeriesResult:
    dev = initial.device
    plan = engine.get_strategy(strategy).bind(**strategy_kwargs)
    lb_on = strategy != "none" and not trig.never
    problem = initial
    tstate = trig.init_state(dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    plan_t = np.zeros(steps)
    rows = []                                   # per-step device scalars
    _sync(dev)
    t_start = time.perf_counter()
    for t in range(steps):
        problem = evolve(problem, t)
        moved = migrated = fired = zero
        if lb_on:
            mx, av, tot = rt_triggers.load_stats(
                problem.loads, problem.assignment, problem.num_nodes)
            do, tstate = trig.decide(tstate, t, mx, av, tot)
            if bool(do):                        # the step's one device read
                _sync(dev)
                t_plan = time.perf_counter()
                new_assignment, _ = plan(problem)
                new_assignment = new_assignment.to(torch.int32)
                delta = new_assignment != problem.assignment
                moved = delta.to(torch.float32).mean()
                migrated = torch.where(delta, problem.loads, 0.0).sum()
                fired = one
                problem = problem.with_assignment(new_assignment)
                _sync(dev)
                plan_t[t] = time.perf_counter() - t_plan
            # executed exchange volume for the measured predictive gate
            tstate = trig.observe(tstate, migrated, do)
        m = metrics.evaluate_device(problem)
        rows.append(torch.stack([m.max_avg_load, m.ext_int_comm, moved,
                                 fired, m.max_load, migrated]))
    stats = (torch.stack(rows).cpu().numpy().astype(np.float64) if rows
             else np.zeros((0, 6)))
    final = problem.assignment.cpu().numpy().astype(np.int32)
    wall = time.perf_counter() - t_start
    ma, ei, mig, fired, mxl, migl = stats.T
    return SeriesResult(
        ma, ei, mig, float(plan_t.sum()), scanned=True, wall_seconds=wall,
        lb_fired=fired, max_load=mxl, migrated_load=migl,
        final_assignment=final, plan_step_seconds=plan_t)
