"""Sharded replays (counterpart of ``repro.distributed.replay_shard``).

The JAX package runs each replay's whole step loop inside one
``shard_map`` over a 1-D ``"lb"`` mesh.  Here the mesh is a
``distributed.mesh.ShardMesh``: the D shards are the leading axis of the
per-shard tensors on one device, and the loop is host-driven as the
port's single-device loops are.

  * :func:`run_series_sharded` — the sharded twin of
    ``sim.simulator.run_series``'s device-resident loop.  Each fired
    plan's stage 2 runs over (D, P/D) row blocks with ring halo exchanges
    (``lb_shard.plan_step_sharded``).
  * :func:`run_pic_sharded` — the sharded PIC driver
    (``PICConfig(sharded_replay=True)``).  The particles live in D
    (capacity,) slabs with a live-prefix count each: K5 pushes every
    shard's slab, K4 takes the per-shard chare histograms (integer
    partials, completed with an exact ``psum``), and every fired
    rebalance re-buckets the slabs into PE-owned slot regions with
    ``runtime.migrate.ring_exchange`` (K3 at every hop).

Parity: both are **bit for bit** the single-device paths — the same
per-step metrics, fire steps, migrations, final assignments and (PIC)
final particle positions.  Data movement (ring hops, gathers) copies
exactly; every reduction that feeds a decision or a metric is taken on
the gathered full-size values with the single-device expression
(``comm_graph.ordered_sum`` / ``segment_sum``, K4's ordered form on a
card), or, for the PIC's handoff counts and chare histograms, as an
integer ``psum``.

Resilience (``runtime.resilience``): ``faults`` injects a
``FaultSchedule`` (health-masked trigger stats and planning, a forced
fire on every health transition and while an object sits on a dead node,
``validate_plan``-guarded adoption, the per-step ``plan_rejected``);
``guard`` validates without faults; the PIC's ``on_overflow="spill"``
clamps each shard's inflow to its slab (the per-step ``deferred``).  With
neither, no operation is added.

Capacity (PIC): the slabs hold ``capacity`` slots a shard, by default the
worst case ``n_particles``; ``PICConfig.replay_capacity`` sizes them down.
A strict run whose shard needed more slots raises ``ValueError`` after the
run (payload is never dropped silently).
"""
from __future__ import annotations

import functools
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import comm_graph, hierarchical, metrics
from repro_torch.core import engine as core_engine
from repro_torch.distributed import lb_shard
from repro_torch.distributed.mesh import ShardMesh, resolve_mesh
from repro_torch.obs import telemetry as obs_telemetry
from repro_torch.runtime import migrate as rt_migrate
from repro_torch.runtime import resilience as rt_resilience
from repro_torch.runtime import triggers as rt_triggers

#: planner configuration a diff-* strategy can carry into the sharded
#: replays (``LBEngine``'s defaults)
_ENGINE_DEFAULTS = dict(k=4, tol=0.02, max_iters=512, max_rounds=64,
                        single_hop=True, sweep_chunk=8)


def _engine_params(strat: core_engine.Strategy,
                   strategy_kwargs: Optional[Dict]) -> Dict:
    """Planner configuration of the sharded twin of ``strat``: its
    registered defaults under the caller's kwargs, checked against the
    knobs the sharded planner takes."""
    merged = strat.params(**(strategy_kwargs or {}))
    unknown = sorted(set(merged) - set(_ENGINE_DEFAULTS))
    if unknown:
        raise ValueError(
            f"sharded replay cannot honor strategy kwargs {unknown}; "
            f"supported: {sorted(_ENGINE_DEFAULTS)}")
    out = {**_ENGINE_DEFAULTS, **merged}
    return {k: (bool(v) if k == "single_hop" else
                float(v) if k == "tol" else int(v))
            for k, v in out.items()}


def _resolve_resilience(faults, guard, D: int, strategy: str, trig):
    """Normalize ``faults`` / ``guard``: an empty schedule becomes None
    (no operation added); ``guard`` defaults to on exactly when a schedule
    is active.  A schedule needs an active strategy and trigger and may
    name only shards the mesh has."""
    if faults is not None:
        if not isinstance(faults, rt_resilience.FaultSchedule):
            raise TypeError(
                "faults must be a runtime.resilience.FaultSchedule")
        if faults.empty:
            faults = None
    guard = (faults is not None) if guard is None else bool(guard)
    if faults is not None:
        if strategy == "none" or trig.never:
            raise ValueError(
                "fault injection needs an active LB strategy/trigger — "
                "with planning disabled a dead shard's objects can never "
                "be evacuated")
        if faults.max_shard() >= D:
            raise ValueError(
                f"fault schedule references shard {faults.max_shard()} "
                f"but the mesh has only {D} shards")
    return faults, guard


def _check_strategy(strategy: str) -> core_engine.Strategy:
    strat = core_engine.get_strategy(strategy)
    if strat.host:
        raise ValueError(
            f"strategy {strategy!r} is not jittable: it plans on the host; "
            "the sharded replay needs a device plan_fn (diff-* / none)")
    return strat


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ----------------------------------------------------- series replay ----


class _PreparedSeries:
    """A validated sharded series replay, driven chunk by chunk.

    ``initial_carry`` / ``run_chunk`` / ``package`` let a supervisor
    (``runtime.resilience.run_series_checkpointed``) own the loop state
    between chunks, and ``to_host`` / ``from_host`` copy it out and back;
    :func:`run_series_sharded` runs one chunk of every step through the
    same step, so a chunked run is bit for bit the one-shot run."""

    def __init__(self, *, initial, evolve, strategy, strategy_kwargs,
                 trig, mesh, threads_per_node, faults, guard, tel=None):
        self.initial = initial
        self.evolve = evolve
        self.trig = trig
        self.mesh = mesh
        self.threads_per_node = threads_per_node
        self.faults = faults
        self.guard = bool(guard)
        self.track = faults is not None or self.guard
        self.tel = tel
        self.P = initial.num_nodes
        self.D = mesh.num_shards
        self.dev = initial.device
        self.lb_on = strategy != "none" and not trig.never
        strat = core_engine.get_strategy(strategy)
        self.plan = None
        if self.lb_on:
            self.plan = functools.partial(
                lb_shard.plan_step_sharded, mesh=mesh,
                variant=strat.variant,
                **_engine_params(strat, strategy_kwargs))
        self.plan_seconds = 0.0

    def initial_carry(self):
        """``(problem, trigger state, telemetry state)`` at t = 0."""
        p = self.initial
        p = p.with_assignment(p.assignment.to(torch.int32))
        obs = (obs_telemetry.init_state(self.tel, self.P, self.dev)
               if self.tel else None)
        return (p, self.trig.init_state(self.dev), obs)

    @staticmethod
    def to_host(carry):
        """A host copy of the loop state (a checkpoint)."""
        problem, tstate, obs = carry

        def copy(t):
            return None if t is None else t.detach().cpu().clone()

        snap = comm_graph.LBProblem(
            loads=copy(problem.loads), assignment=copy(problem.assignment),
            edges_src=copy(problem.edges_src),
            edges_dst=copy(problem.edges_dst),
            edges_bytes=copy(problem.edges_bytes),
            num_nodes=problem.num_nodes, coords=copy(problem.coords))
        return (snap, type(tstate)(*(copy(t) for t in tstate)), obs)

    def from_host(self, snap):
        """The loop state back on the run's device from a checkpoint."""
        problem, tstate, obs = snap
        return (problem.to(self.dev),
                type(tstate)(*(t.to(self.dev) for t in tstate)), obs)

    def _step(self, carry, t: int):
        problem, tstate, obs_state = carry
        dev, P, D = self.dev, self.P, self.D
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        one = torch.ones((), dtype=torch.float32, device=dev)
        problem = self.evolve(problem, t)
        prev = problem.assignment
        moved = migrated = fired = rejected = health = zero
        moved_n = sweeps = 0.0
        if self.lb_on:
            alive = speed = None
            if self.faults is not None:
                alive, speed = self.faults.node_health(t, P, D, dev)
                mx, av, tot = rt_triggers.load_stats_masked(
                    problem.loads, problem.assignment, P, alive, speed)
            else:
                mx, av, tot = rt_triggers.load_stats(
                    problem.loads, problem.assignment, P)
            d, tstate = self.trig.decide(tstate, t, mx, av, tot)
            do = bool(d)                        # the step's one device read
            if self.faults is not None:
                # a health transition, or an object stranded on a dead
                # node, fires a rebalance whatever the policy says
                changed = self.faults.changed_at(t, D)
                stranded = bool((~alive[prev.long().clamp(0, P - 1)]).any())
                health = one if changed else zero
                do = do or changed or stranded
                d = do
            if do:
                _sync(dev)
                t_plan = time.perf_counter()
                planned, stats = self.plan(problem, alive=alive,
                                           speed=speed)
                planned = planned.to(torch.int32)
                ok = (not self.track) or bool(rt_resilience.validate_plan(
                    planned, problem.loads, num_nodes=P, alive=alive))
                if ok:
                    delta = planned != prev
                    moved = delta.to(torch.float32).mean()
                    migrated = comm_graph.ordered_sum(
                        torch.where(delta, problem.loads, 0.0))
                    problem = problem.with_assignment(planned)
                    if self.tel:
                        moved_n = delta.sum()
                else:
                    rejected = one
                fired = one
                if self.tel:
                    sweeps = stats.diffusion_iters
                _sync(dev)
                self.plan_seconds += time.perf_counter() - t_plan
            # executed exchange volume for the measured predictive gate
            tstate = self.trig.observe(tstate, migrated, d)
        m = metrics.evaluate_device(problem)
        row = [m.max_avg_load, m.ext_int_comm, moved, fired, m.max_load,
               migrated]
        if self.threads_per_node:
            row.append(hierarchical.thread_max_avg(
                problem.loads, problem.assignment, num_nodes=P,
                threads_per_node=self.threads_per_node))
        if self.track:
            row.append(rejected)
        if self.tel:
            obs_state = obs_telemetry.record(
                obs_state, self.tel, t=t,
                node_loads=obs_telemetry.node_loads(
                    problem.loads, problem.assignment, P),
                fired=fired, trigger_kind=obs_telemetry.trigger_kind(
                    self.trig),
                plan_rejected=rejected, sweeps=sweeps, moved_items=moved_n,
                moved_bytes=migrated, health_changed=health)
        return (problem, tstate, obs_state), torch.stack(row)

    def run_chunk(self, carry, t_start: int, chunk: int):
        """Advance ``chunk`` steps from ``carry``: ``(new_carry, rows)``
        with ``rows`` the (chunk, F) per-step records on the host."""
        rows = []
        for t in range(int(t_start), int(t_start) + int(chunk)):
            carry, row = self._step(carry, t)
            rows.append(row)
        return carry, torch.stack(rows).cpu().numpy().astype(np.float64)

    def package(self, carry, ys, *, wall_seconds: float):
        """Final loop state and the concatenated records → the
        ``SeriesResult`` of ``run_series``."""
        from repro_torch.sim import simulator as sim

        problem, _, obs_state = carry
        ma, ei, mig, fired, mxl, migl = ys.T[:6]
        col = 6
        tma = rej = None
        if self.threads_per_node:
            tma, col = ys[:, col], col + 1
        if self.track:
            rej = ys[:, col]
        return sim.SeriesResult(
            ma, ei, mig, float(self.plan_seconds), scanned=True,
            wall_seconds=wall_seconds, thread_max_avg=tma, lb_fired=fired,
            max_load=mxl, migrated_load=migl,
            final_assignment=problem.assignment.cpu().numpy().astype(
                np.int32),
            plan_rejected=rej,
            telemetry=(obs_telemetry.snapshot(obs_state, self.tel)
                       if self.tel else None))


def prepare_series(initial: comm_graph.LBProblem, evolve, *, steps: int,
                   lb_every: int, strategy: str = "diff-comm",
                   strategy_kwargs: Optional[Dict] = None, trigger=None,
                   mesh: Optional[ShardMesh] = None,
                   num_shards: Optional[int] = None,
                   threads_per_node: Optional[int] = None, faults=None,
                   guard: Optional[bool] = None,
                   telemetry=None) -> _PreparedSeries:
    """Validate and stage a sharded series replay for chunked driving;
    arguments and checks as :func:`run_series_sharded`."""
    if int(steps) < 1:
        raise ValueError("steps must be >= 1")
    strat = _check_strategy(strategy)
    if strategy != "none" and strat.variant is None:
        raise ValueError(
            f"strategy {strategy!r} has no diffusion variant; the "
            "sharded replay can only distribute diff-* strategies")
    if not getattr(evolve, "device_resident", False):
        raise ValueError(
            "the sharded replay needs a scan-safe, device-resident evolve "
            "(scenarios from sim/scenarios.py are)")
    trig = rt_triggers.resolve_for_strategy(trigger, lb_every=lb_every,
                                            strategy=strategy)
    P = initial.num_nodes
    mesh = resolve_mesh(mesh, num_shards, (P,), initial.device)
    if mesh.device != initial.device:
        raise ValueError(f"the mesh is on {mesh.device}, the problem on "
                         f"{initial.device}")
    faults, guard = _resolve_resilience(faults, guard, mesh.num_shards,
                                        strategy, trig)
    return _PreparedSeries(
        initial=initial, evolve=evolve, strategy=strategy,
        strategy_kwargs=strategy_kwargs or {}, trig=trig, mesh=mesh,
        threads_per_node=threads_per_node, faults=faults, guard=guard,
        tel=obs_telemetry.enabled_or_none(telemetry))


def run_series_sharded(initial: comm_graph.LBProblem, evolve, *,
                       steps: int, lb_every: int,
                       strategy: str = "diff-comm",
                       strategy_kwargs: Optional[Dict] = None,
                       trigger=None, mesh: Optional[ShardMesh] = None,
                       num_shards: Optional[int] = None,
                       threads_per_node: Optional[int] = None, faults=None,
                       guard: Optional[bool] = None, telemetry=None):
    """Mesh-sharded ``run_series``: bit for bit its device-resident loop.

    Evolve, trigger and metrics run on the replicated problem; each fired
    plan runs ``lb_shard.plan_step_sharded`` over the mesh.  Arguments
    mirror ``run_series`` (a device diff-* or ``none`` strategy; a
    device-resident evolve).  ``mesh`` / ``num_shards`` pick the mesh (by
    default one shard a real device dividing P).  ``faults`` (a
    ``FaultSchedule``) and ``guard`` add the resilient step and the
    ``plan_rejected`` series; an empty schedule with ``guard`` unset adds
    nothing.  ``telemetry`` records the StepRecord ring."""
    prepared = prepare_series(
        initial, evolve, steps=steps, lb_every=lb_every, strategy=strategy,
        strategy_kwargs=strategy_kwargs, trigger=trigger, mesh=mesh,
        num_shards=num_shards, threads_per_node=threads_per_node,
        faults=faults, guard=guard, telemetry=telemetry)
    _sync(prepared.dev)
    t0 = time.perf_counter()
    carry, ys = prepared.run_chunk(prepared.initial_carry(), 0, int(steps))
    return prepared.package(carry, ys,
                            wall_seconds=time.perf_counter() - t0)


# -------------------------------------------------------- PIC replay ----


def _pad_slabs(arrays, n: int, D: int, capacity: int, dev):
    """(n,) arrays → (D, capacity) slabs on ``dev`` with n/D live items at
    each shard's prefix (shard d holds items ``[d·n/D, (d+1)·n/D)``)."""
    per = n // D
    out = []
    for a in arrays:
        a = torch.as_tensor(a, device=dev)
        slab = torch.zeros((D, capacity), dtype=a.dtype, device=dev)
        slab[:, :per] = a.reshape(D, per)
        out.append(slab)
    return out


def run_pic_sharded(cfg, cost):
    """Sharded PIC driver (``PICConfig(sharded_replay=True)``), bit for
    bit the single-device driver's ``PICResult`` (``final_x/final_y`` in
    particle-id order); wall-derived fields (``step_seconds``,
    ``lb_seconds``) embed measured times.

    ``PICConfig.faults`` injects a ``FaultSchedule`` and
    ``on_overflow="spill"`` swaps the exchange for the admission-clamped
    spill ring; either adds the ``plan_rejected`` / ``deferred``
    series."""
    from repro_torch.kernels.histogram.ops import histogram
    from repro_torch.kernels.pic_push.ops import pic_push
    from repro_torch.pic import chares as ch
    from repro_torch.pic import driver as pic_driver
    from repro_torch.pic.grid import alternating_grid
    from repro_torch.pic.particles import initialize

    strat = _check_strategy(cfg.strategy)
    n = int(cfg.n_particles)
    L, cx, cy, P = cfg.L, cfg.cx, cfg.cy, cfg.num_pes
    mesh = resolve_mesh(None, cfg.replay_shards, (n, P), cfg.device)
    D, dev = mesh.num_shards, mesh.device
    capacity = n if cfg.replay_capacity is None else int(cfg.replay_capacity)
    if capacity < n // D:
        raise ValueError(
            f"replay_capacity={capacity} cannot even hold the initial "
            f"even split of {n} particles over {D} shards "
            f"({n // D} per shard); raise replay_capacity "
            f"(n_particles={n} is always safe)")
    on_overflow = cfg.on_overflow
    if on_overflow not in ("strict", "spill"):
        raise ValueError(f"unknown on_overflow mode {on_overflow!r}")
    spill = on_overflow == "spill"
    kw = dict(cfg.strategy_kwargs or {})
    if cfg.sweep_chunk is not None and cfg.strategy.startswith("diff"):
        kw["sweep_chunk"] = cfg.sweep_chunk
    trig = rt_triggers.resolve_for_strategy(
        cfg.trigger, lb_every=cfg.lb_every, strategy=cfg.strategy)
    lb_on = cfg.strategy != "none" and not trig.never
    faults, _ = _resolve_resilience(cfg.faults, None, D, cfg.strategy, trig)
    resilient = faults is not None
    track = resilient or spill
    tel = obs_telemetry.enabled_or_none(cfg.telemetry)
    T = cfg.threads_per_node
    n_chares = cx * cy
    bpp = cfg.bytes_per_particle

    # the chare-level plan: over the mesh when it divides the PEs, else
    # the single-device planner (health-masked when faults are active)
    plan = None
    if lb_on:
        if strat.variant is not None and P % D == 0:
            plan = functools.partial(
                lb_shard.plan_step_sharded, mesh=mesh,
                variant=strat.variant, **_engine_params(strat, kw))
        elif resilient:
            plan = core_engine.get_engine(
                variant=strat.variant, device=dev,
                **_engine_params(strat, kw)).plan_health_fn
        else:
            plan = strat.bind(**kw)

    p = initialize(cfg.mode, L, n, k=cfg.k, vy0=cfg.vy0, rho=cfg.rho,
                   seed=cfg.seed)
    grid_q = torch.as_tensor(alternating_grid(L), device=dev)
    assignment = torch.as_tensor(
        ch.initial_mapping(cx, cy, P, cfg.mapping), device=dev)
    chare0 = ch.chare_of_device(torch.as_tensor(p.x, device=dev),
                                torch.as_tensor(p.y, device=dev), L, cx, cy)

    def problem_of(loads, a):
        return ch.build_problem(loads, a, L=L, cx=cx, cy=cy, num_pes=P,
                                k=cfg.k, vy0=cfg.vy0, lb_period=cfg.lb_every,
                                bytes_per_particle=bpp)

    # planning cost for the CostModel: measured once on the initial
    # snapshot (after a warm-up call), as the single-device driver does
    lb_est = 0.0
    if lb_on:
        ones = torch.ones(n, dtype=torch.float32, device=dev)
        problem0 = problem_of(histogram(chare0, ones, C=n_chares),
                              assignment)
        strat.run(problem0, **kw)
        lb_est = strat.run(problem0, **kw).info["plan_seconds"]
        del ones

    x, y, vx, vy, q, chare_id, perm = _pad_slabs(
        (p.x, p.y, p.vx, p.vy, p.q, chare0,
         torch.arange(n, dtype=torch.int32, device=dev)), n, D, capacity,
        dev)
    count = torch.full((D,), n // D, dtype=torch.int32, device=dev)
    me = torch.arange(D, device=dev)[:, None]
    slots = torch.arange(capacity, device=dev)[None, :]
    tstate = trig.init_state(dev)
    obs_state = obs_telemetry.init_state(tel, P, dev) if tel else None
    tkind = obs_telemetry.trigger_kind(trig) if tel else 0
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    rows, counts_ts = [], []
    _sync(dev)
    t_start = time.perf_counter()
    for t in range(cfg.steps):
        # K5 over every shard's slab (padding included)
        x, y, vx, vy = (a.reshape(D, capacity) for a in pic_push(
            grid_q, x.reshape(-1), y.reshape(-1), vx.reshape(-1),
            vy.reshape(-1), q.reshape(-1), L=L))
        new_chare = ch.chare_of_device(x, y, L, cx, cy)
        live = slots < count[:, None]
        # particle handoffs: chare changed → bytes move; PE boundary →
        # ext.  Integer partials: the psum is exact
        moved = (new_chare != chare_id) & live
        crossed = assignment[chare_id.long()] != assignment[new_chare.long()]
        ext = mesh.psum((moved & crossed).sum(1)).to(torch.float32) * bpp
        intra = mesh.psum((moved & ~crossed).sum(1)).to(torch.float32) * bpp
        # K4: the per-shard chare histograms in one launch (shard d's
        # chares are buckets d·C .. d·C + C-1), summed over the shards
        loads = mesh.psum(histogram(
            (me * n_chares + new_chare).reshape(-1),
            live.to(torch.float32).reshape(-1),
            C=D * n_chares).reshape(D, n_chares))
        pe_loads = comm_graph.segment_sum(loads, assignment, P)
        pe_max = pe_loads.max()
        ma = pe_max / (pe_loads.mean() + 1e-30)
        migf = migb = fired = sweeps = rejected = health = zero
        deferred = zero
        if lb_on:
            alive = speed = None
            if resilient:
                alive, speed = faults.node_health(t, P, D, dev)
                mx, av, tot = rt_triggers.load_stats_masked(
                    loads, assignment, P, alive, speed)
            else:
                mx, av, tot = rt_triggers.load_stats(loads, assignment, P)
            do, tstate = trig.decide(tstate, t, mx, av, tot)
            do = bool(do)                       # the step's one device read
            if resilient:
                # evacuate dead PEs now: fire on every health transition
                # and while any chare is owned by a dead PE
                changed = faults.changed_at(t, D)
                stranded = bool((~alive[assignment.long()]).any())
                health = one if changed else zero
                do = do or changed or stranded
            if do:
                problem = problem_of(loads, assignment)
                if resilient:
                    new_assignment, stats = plan(problem, alive=alive,
                                                 speed=speed)
                else:
                    new_assignment, stats = plan(problem)
                new_assignment = new_assignment.to(torch.int32)
                ok = True
                if resilient:
                    # adopt validated plans only: owners alive and in
                    # range, and (strict) every shard's inflow within its
                    # slab — a plan that does not fit would drop payload
                    ok = rt_resilience.validate_plan(
                        new_assignment, loads, num_nodes=P, alive=alive)
                    if not spill:
                        pe_new = comm_graph.segment_sum(
                            loads, new_assignment.clamp(0, P - 1), P)
                        ok = ok & (pe_new.reshape(D, P // D).sum(1)
                                   <= capacity).all()
                    ok = bool(ok)
                if ok:
                    migf = (new_assignment != assignment).to(
                        torch.float32).mean()
                    # execute the plan: the masked ring all-to-all
                    # re-buckets the live slab prefixes into PE-owned
                    # slot regions
                    owner_old = assignment[new_chare.long()]
                    owner_new = new_assignment[new_chare.long()]
                    want = mesh.psum(((owner_old != owner_new) & live)
                                     .sum(1)).to(torch.int32)
                    out = rt_migrate.ring_exchange(
                        owner_new, (x, y, vx, vy, q, new_chare, perm),
                        num_nodes=P, mesh=mesh, capacity=capacity,
                        count_loc=count, mode=on_overflow)
                    (x, y, vx, vy, q, new_chare, perm), count = out[1:3]
                    moved_n = want
                    if spill:
                        deferred = out[3].to(torch.float32)
                        moved_n = want - out[3]
                    moved_n = moved_n.to(torch.float32)
                    migb = moved_n * bpp
                    assignment = new_assignment
                else:
                    rejected = one
                    moved_n = zero
                fired = one
                tstate = trig.observe(tstate, moved_n, True)
                if tel:
                    sweeps = stats.diffusion_iters
        chare_id = new_chare
        row = [ma, pe_max, ext, intra, migf, migb, fired]
        if T:
            row.append(hierarchical.thread_max_avg(
                loads, assignment, num_nodes=P, threads_per_node=T))
        if track:
            row += [rejected, deferred]
        rows.append(torch.stack(row))
        counts_ts.append(count)
        if tel:
            obs_state = obs_telemetry.record(
                obs_state, tel, t=t,
                node_loads=obs_telemetry.node_loads(loads, assignment, P),
                fired=fired, trigger_kind=tkind, plan_rejected=rejected,
                sweeps=sweeps, moved_items=migb / bpp, moved_bytes=migb,
                deferred=deferred, health_changed=health)
    _sync(dev)
    wall = time.perf_counter() - t_start

    counts_ts = (torch.stack(counts_ts).cpu().numpy() if counts_ts
                 else np.zeros((0, D), np.int32))
    # spill clamps inflow inside the exchange; strict fails loud
    if not spill and (counts_ts > capacity).any():
        raise ValueError(
            f"replay_capacity={capacity} overflowed (largest shard "
            f"needed {int(counts_ts.max())} slots at some step); the "
            "exchange would have dropped payload — raise replay_capacity "
            f"(n_particles={n} is always safe) or use "
            "on_overflow='spill'")
    width = 7 + (1 if T else 0) + (2 if track else 0)
    stats_np = (torch.stack(rows).cpu().numpy().astype(np.float64) if rows
                else np.zeros((0, width)))
    ma, pe_max, ext_b, int_b, mig, mig_bytes, fired = stats_np.T[:7]
    lb_s_t = np.where(fired > 0, lb_est, 0.0)
    step_s = (pe_max * cost.t_particle
              + (ext_b + mig_bytes) * cost.t_byte
              + np.array([cost.lb_seconds(s_, cfg.strategy, P)
                          for s_ in lb_s_t])
              / pic_driver._lb_amort(cfg, trig))
    # the per-shard valid prefixes concatenated are the single-device slot
    # layout; undo the exchanges back to particle-id order
    cnt = count.cpu().tolist()
    keep = torch.cat([torch.arange(d * capacity, d * capacity + cnt[d],
                                   device=dev) for d in range(D)])
    xs, ys_, order = (a.reshape(-1)[keep] for a in (x, y, perm))
    fx, fy = torch.empty_like(xs), torch.empty_like(ys_)
    fx[order.long()] = xs
    fy[order.long()] = ys_
    col = 7 + (1 if T else 0)
    return pic_driver.PICResult(
        ma, ext_b, int_b, mig, mig_bytes, float(lb_s_t.sum()), step_s,
        fx.cpu().numpy(), fy.cpu().numpy(), wall_seconds=wall,
        lb_steps=fired, thread_max_avg=stats_np[:, 7] if T else None,
        plan_rejected=stats_np[:, col] if track else None,
        deferred=stats_np[:, col + 1] if track else None,
        shard_counts=counts_ts,
        telemetry=(obs_telemetry.snapshot(obs_state, tel) if tel else None))
