"""Serving fleet replay with executed KV moves (counterpart of
``repro.serve.replay``).

``run_serve_replay`` drives a fleet of ``S`` persistent multi-turn
sessions over ``R`` serving replicas for ``T`` ticks.  Each tick advances
the workload, asks the trigger whether to rebalance and, when it fires,
plans with the registered strategy over the sessions' prefix-sharing graph
and **executes** the KV-slab exchange.  The fleet is a set of fixed-shape
slabs on one device: ``uid`` (which session occupies each slot),
``replica`` (its owner) and ``kv`` (its resident KV bytes, growing with
decode activity).  A fired exchange re-buckets the slabs into
replica-contiguous order through the counting-scatter manifest (K3 on a
card) and reads the moved volume off ``Manifest.moved_sum`` with each
session's KV size; that volume, in the trigger cost model's load units,
feeds ``Trigger.observe``, so the predictive gate prices the next fire
against what the last exchange really moved.  ``slot_capacity`` bounds
live sessions a replica through ``migrate.spill_owner``: overflow moves
stay put and retry at the next fire.

Two loops share one set of step pieces (:func:`_make_parts`):

  * **device-resident** (``scan=True``; the default for a device
    planner): records stay 0-d device tensors until the run ends; the host
    reads one scalar a tick, the trigger's decision (none for the fixed
    ``every`` cadence), plus the planner's loop flags on fired ticks —
    the counterpart of the JAX package's ``lax.scan``;
  * **host loop** (``scan=False``; the default for a host planner such as
    ``greedy``): the same pieces, each tick's records read to the host.

Both give equal fire steps, placements and moved KV.  Every float sum
that feeds the trigger adds in the JAX package's CPU order
(``comm_graph.segment_sum`` and ``comm_graph.ordered_sum``), so fire steps
equal the JAX package's and the card's equal the CPU's.

Workloads: :class:`ServeWorkload` (synthetic bursty multi-turn traffic;
its per-session tables come from ``numpy.random.default_rng``, as in the
JAX package, so loads are exact) and :class:`TraceWorkload` (a recorded
``(T, S)`` load table, e.g. from :func:`record_trace`).  The
multi-replica-group path (``num_shards`` / ``mesh``) runs each fired
exchange as a ring all-to-all over a ``distributed.mesh.ShardMesh``
(``runtime.migrate.migrate_sharded``, strict mode), whose concatenated
per-shard valid prefixes are the single-device bucketed slabs bit for bit;
it takes the host loop, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import comm_graph, engine
from repro_torch.kernels import resolve_device
from repro_torch.obs import telemetry as obs_telemetry
from repro_torch.runtime import migrate as rt_migrate
from repro_torch.runtime import triggers as rt_triggers
from repro_torch.serve.scheduler import LOAD_FLOOR

# ------------------------------------------------------------- workloads --


@dataclasses.dataclass(frozen=True)
class ServeWorkload:
    """Synthetic bursty multi-turn session traffic (a pure function of t).

    Session ``u``'s load at tick ``t`` is ``idle_load`` outside its decode
    turns and ``rate[u] * surge`` inside them: turns open for ``turn_len``
    of every ``turn_period`` ticks at a per-session random phase, and
    ``surge`` is ``1 + burst_amp`` while the session's burst wave is the
    active one (waves rotate every ``burst_period`` ticks).  Prefix groups
    are ``uid // group_size``."""

    num_sessions: int = 4096
    num_replicas: int = 16
    group_size: int = 4
    turn_period: int = 12
    turn_len: int = 6
    burst_waves: int = 4
    burst_period: int = 25
    burst_amp: float = 3.0
    idle_load: float = 0.05
    rate_lo: float = 0.5
    rate_hi: float = 2.0
    kv0: float = 64.0
    kv_per_token: float = 1.0
    seed: int = 0

    def tables(self, device):
        """(rate, phase, wave, kv0) tensors on ``device``."""
        return _device_tables(self, str(device))

    def loads_at(self, t: int, uid: torch.Tensor) -> torch.Tensor:
        """(S,) f32 decode load of the sessions in ``uid`` at tick t."""
        rate, phase, wave, _ = self.tables(uid.device)
        uid = uid.long()
        t = int(t)
        in_turn = torch.remainder(t + phase[uid], self.turn_period) \
            < self.turn_len
        hot = wave[uid] == (t // self.burst_period) % self.burst_waves
        surge = 1.0 + self.burst_amp * hot.to(torch.float32)
        return torch.where(in_turn, rate[uid] * surge, self.idle_load)

    def group_of(self, uid: torch.Tensor) -> torch.Tensor:
        return torch.div(uid.to(torch.int32), max(1, self.group_size),
                         rounding_mode="floor")

    def kv0_of(self, uid: torch.Tensor) -> torch.Tensor:
        return self.tables(uid.device)[3][uid.long()]


@functools.lru_cache(maxsize=64)
def _serve_tables(w: ServeWorkload):
    """Per-session random tables (rate, phase, wave, kv0) as NumPy, drawn
    as the JAX package draws them."""
    rng = np.random.default_rng(w.seed)
    S = w.num_sessions
    rate = rng.uniform(w.rate_lo, w.rate_hi, S).astype(np.float32)
    phase = rng.integers(0, max(1, w.turn_period), S).astype(np.int32)
    wave = rng.integers(0, max(1, w.burst_waves), S).astype(np.int32)
    kv0 = (w.kv0 * rng.uniform(0.5, 1.5, S)).astype(np.float32)
    return rate, phase, wave, kv0


@functools.lru_cache(maxsize=64)
def _device_tables(w: ServeWorkload, device: str):
    return tuple(torch.as_tensor(a, device=device)
                 for a in _serve_tables(w))


@dataclasses.dataclass(frozen=True, eq=False)
class TraceWorkload:
    """Trace-driven workload: a recorded ``(T, S)`` load table.

    ``group`` ids must be canonical (``[0, S)``, -1 for ungrouped); the
    table loops when replayed past its length."""

    table: torch.Tensor           # (T, S) f32 per-tick session loads
    group: torch.Tensor           # (S,) i32 prefix groups
    kv0: torch.Tensor             # (S,) f32 initial KV bytes
    num_replicas: int = 16
    kv_per_token: float = 1.0

    @property
    def num_sessions(self) -> int:
        return int(self.table.shape[1])

    def to(self, device) -> "TraceWorkload":
        return dataclasses.replace(self, table=self.table.to(device),
                                   group=self.group.to(device),
                                   kv0=self.kv0.to(device))

    def loads_at(self, t: int, uid: torch.Tensor) -> torch.Tensor:
        return self.table[int(t) % self.table.shape[0]][uid.long()]

    def group_of(self, uid: torch.Tensor) -> torch.Tensor:
        return self.group[uid.long()]

    def kv0_of(self, uid: torch.Tensor) -> torch.Tensor:
        return self.kv0[uid.long()]


def record_trace(workload, *, steps: int, device="cuda") -> TraceWorkload:
    """Capture ``steps`` ticks of any workload into a :class:`TraceWorkload`
    on ``device`` (the ``serving-trace`` scenario's source)."""
    dev = resolve_device(device)
    uid = torch.arange(workload.num_sessions, dtype=torch.int32, device=dev)
    rows = torch.stack([workload.loads_at(t, uid) for t in range(steps)])
    return TraceWorkload(
        table=rows.to(torch.float32),
        group=workload.group_of(uid).to(torch.int32),
        kv0=workload.kv0_of(uid).to(torch.float32),
        num_replicas=workload.num_replicas,
        kv_per_token=float(workload.kv_per_token))


# --------------------------------------------------------------- results --


@dataclasses.dataclass
class ServeReplayResult:
    """Per-tick records and the final fleet state of one serving replay."""

    max_avg: np.ndarray           # (T,) post-LB replica load imbalance
    lb_fired: np.ndarray          # (T,) 0/1 trigger decisions
    moved_sessions: np.ndarray    # (T,) sessions exchanged at that tick
    moved_kv_bytes: np.ndarray    # (T,) executed KV transfer volume
    prefix_local: np.ndarray      # (T,) intra-replica prefix-edge fraction
    deferred: np.ndarray          # (T,) capacity-deferred moves (spill)
    occ_max: np.ndarray           # (T,) max live sessions on one replica
    final_uid: np.ndarray         # (S,) slot → session id
    final_replica: np.ndarray     # (S,) slot → replica
    final_kv: np.ndarray          # (S,) slot → resident KV bytes
    scanned: bool = False         # True for the device-resident loop
    sharded: bool = False
    wall_seconds: float = 0.0     # synchronized wall time of the tick loop
    # StepRecord ring snapshot when an enabled telemetry config was passed
    telemetry: Optional[obs_telemetry.TelemetrySnapshot] = None

    @property
    def final_replica_by_uid(self) -> np.ndarray:
        """(S,) replica of each session id (identity lives in ``uid``; the
        exchange re-buckets slots)."""
        out = np.full(self.final_uid.shape, -1, np.int32)
        out[self.final_uid] = self.final_replica
        return out

    @property
    def total_moved_kv(self) -> float:
        return float(self.moved_kv_bytes.sum())


# ------------------------------------------------------------- step body --


def _floored(workload, t: int, uid: torch.Tensor) -> torch.Tensor:
    return torch.clamp(workload.loads_at(t, uid), min=LOAD_FLOOR)


def _locality(group, loads_c, replica) -> torch.Tensor:
    """Intra-replica fraction of prefix-sharing (star) edge weight."""
    S = int(group.shape[0])
    es, ed, ew = comm_graph.prefix_group_edges(group, loads_c, None,
                                               ring_eps=LOAD_FLOOR)
    es, ed, ew = es[:S], ed[:S], ew[:S]
    valid = es >= 0
    w = torch.where(valid, ew, 0.0)
    same = replica[es.clamp(0, S - 1).long()] \
        == replica[ed.clamp(0, S - 1).long()]
    intra = torch.where(valid & same, ew, 0.0)
    return comm_graph.ordered_sum(intra) / torch.clamp(
        comm_graph.ordered_sum(w), min=1e-30)


def _make_parts(workload, trig, plan, slot_capacity, R: int, lb_on: bool,
                bytes_per_load: float, mesh=None):
    """The step pieces both loops run: ``pre`` advances the workload and
    decides, ``plan_owner`` plans a fired tick (the spill clamp included),
    ``fire`` executes it (over ``mesh`` as a ring all-to-all when one is
    given), ``post`` gives the tick's records."""
    is_every = isinstance(trig, rt_triggers.EveryTrigger)

    def pre(uid, kv, replica, tstate, t):
        ld = workload.loads_at(t, uid)
        kv = kv + workload.kv_per_token * ld
        if not lb_on:
            return kv, False, tstate
        if is_every:            # the fixed cadence ignores the load stats
            return kv, t > 0 and t % trig.every == 0, tstate
        ldc = torch.clamp(ld, min=LOAD_FLOOR)
        mx, av, tot = rt_triggers.load_stats(ldc, replica, R)
        do, tstate = trig.decide(tstate, t, mx, av, tot)
        return kv, do, tstate

    def plan_owner(uid, replica, t):
        """Post-spill target owners of a fired tick, the deferred count
        and the planner's diffusion sweeps."""
        ldc = _floored(workload, t, uid)
        es, ed, ew = comm_graph.prefix_group_edges(
            workload.group_of(uid), ldc, None, ring_eps=LOAD_FLOOR)
        problem = comm_graph.LBProblem(
            loads=ldc, assignment=replica, edges_src=es, edges_dst=ed,
            edges_bytes=ew, num_nodes=R)
        owner_new, stats = plan(problem)
        owner_new = owner_new.to(torch.int32)
        deferred = None
        if slot_capacity is not None:
            owner_new, dmask = rt_migrate.spill_owner(
                replica, owner_new, num_nodes=R,
                capacity=int(slot_capacity))
            deferred = dmask.sum().to(torch.float32)
        return owner_new, deferred, stats.diffusion_iters

    def fire(uid, kv, replica, t):
        owner_new, deferred, sweeps = plan_owner(uid, replica, t)
        if mesh is not None:
            return fire_sharded(uid, kv, replica, owner_new) + (deferred,
                                                                sweeps)
        (uid2, kv2), man = rt_migrate.build_and_apply(
            replica, owner_new, (uid, kv), num_nodes=R)
        # the moved volume reads the sizes in the pre-exchange slot order
        return (uid2, kv2, owner_new[man.order.long()],
                man.moved_count.to(torch.float32), man.moved_sum(kv),
                deferred, sweeps)

    def fire_sharded(uid, kv, replica, owner_new):
        moved = owner_new != replica
        moved_kv = comm_graph.ordered_sum(torch.where(moved, kv, 0.0))
        owner_out, (uid_p, kv_p), counts = rt_migrate.migrate_sharded(
            owner_new, (uid, kv), num_nodes=R, mesh=mesh)
        # strict layout contract: the concatenated valid prefixes are the
        # single-device bucketed slabs
        cap = owner_out.shape[0] // mesh.num_shards
        cnt = counts.cpu().tolist()
        keep = torch.cat([torch.arange(d * cap, d * cap + c,
                                       device=uid.device)
                          for d, c in enumerate(cnt)])
        return (uid_p[keep], kv_p[keep], owner_out[keep],
                moved.sum().to(torch.float32), moved_kv)

    def post(uid, kv, replica, tstate, do, moved_kv, t):
        if lb_on and not is_every:
            tstate = trig.observe(tstate, moved_kv / bytes_per_load, do)
        ldc = _floored(workload, t, uid)
        mx, av, _ = rt_triggers.load_stats(ldc, replica, R)
        occ = comm_graph.segment_count(replica, R)
        ploc = _locality(workload.group_of(uid), ldc, replica)
        return tstate, ldc, (mx / av, ploc, occ.max().to(torch.float32))

    return pre, fire, post


def _initial_state(workload, dev):
    S, R = workload.num_sessions, workload.num_replicas
    uid = torch.arange(S, dtype=torch.int32, device=dev)
    replica = torch.div(uid * R, S, rounding_mode="floor").to(torch.int32)
    kv = workload.kv0_of(uid).to(torch.float32)
    return uid, kv, replica


def _resolve(workload, strategy, strategy_kwargs, trigger, lb_every):
    strat = engine.get_strategy(strategy)        # KeyError if unknown
    kw = dict(strategy_kwargs or {})
    if strat.variant is not None:
        kw.setdefault("k", max(1, min(4, int(workload.num_replicas) - 1)))
    trig = rt_triggers.resolve_for_strategy(
        trigger, lb_every=lb_every, strategy=strategy)
    cost = getattr(trig, "cost", None)
    bpl = float(cost.bytes_per_load) if cost is not None else 1.0
    lb_on = strategy != "none" and not trig.never
    return strat, kw, trig, bpl, lb_on


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _loop(workload, steps, strat, kw, trig, bpl, lb_on, slot_capacity,
          dev, tel, device_resident: bool, mesh=None):
    """One replay; ``device_resident`` keeps the records on the device
    until the end, else each tick's records are read to the host."""
    R = workload.num_replicas
    pre, fire, post = _make_parts(workload, trig, strat.bind(**kw),
                                  slot_capacity, R, lb_on, bpl, mesh)
    uid, kv, replica = _initial_state(workload, dev)
    tstate = trig.init_state(dev)
    obs_state = obs_telemetry.init_state(tel, R, dev) if tel else None
    tkind = obs_telemetry.trigger_kind(trig) if tel else 0
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    rows = []
    for t in range(steps):
        kv, do, tstate = pre(uid, kv, replica, tstate, t)
        fired = bool(do)                 # the tick's one device read
        moved_n = moved_kv = deferred = sweeps = zero
        if fired:
            uid, kv, replica, moved_n, moved_kv, d, sweeps = fire(
                uid, kv, replica, t)
            deferred = zero if d is None else d
        tstate, ldc, (ma, ploc, occ) = post(uid, kv, replica, tstate, do,
                                            moved_kv, t)
        if tel:
            obs_state = obs_telemetry.record(
                obs_state, tel, t=t,
                node_loads=obs_telemetry.node_loads(ldc, replica, R),
                fired=float(fired), trigger_kind=tkind, sweeps=sweeps,
                moved_items=moved_n, moved_bytes=moved_kv,
                deferred=deferred)
        row = torch.stack([ma, one if fired else zero, moved_n, moved_kv,
                           ploc, deferred, occ])
        rows.append(row if device_resident
                    else row.cpu().numpy().astype(np.float64))
    if device_resident:
        recs = (torch.stack(rows).cpu().numpy().astype(np.float64) if rows
                else np.zeros((0, 7)))
    else:
        recs = np.asarray(rows, np.float64).reshape(steps, 7)
    return uid, kv, replica, recs, obs_state


# ------------------------------------------------------------- the entry --


def run_serve_replay(
    workload,
    *,
    steps: int,
    strategy: str = "diff-comm",
    strategy_kwargs: Optional[Dict] = None,
    trigger=None,
    lb_every: int = 10,
    slot_capacity: Optional[int] = None,
    scan: Optional[bool] = None,
    num_shards: Optional[int] = None,
    mesh=None,
    telemetry=None,
    device="cuda",
) -> ServeReplayResult:
    """Replay ``steps`` serving ticks with executed KV-cache migration on
    ``device`` (the card unless the caller asks for the CPU).

    ``scan=None`` takes the device-resident loop for a device planner and
    the host loop for a host planner (``greedy`` & co); ``scan=True`` with
    a host planner raises ``ValueError``.  ``trigger`` resolves through
    ``runtime.triggers.resolve_for_strategy``.  ``slot_capacity`` must lie
    above ``S / R``, the initial per-replica count (``spill_owner`` needs
    every current count within the budget).  ``telemetry`` records the
    StepRecord ring (``off`` / None add nothing).  ``num_shards`` /
    ``mesh`` run the fired exchanges as ring all-to-alls over a
    ``ShardMesh`` (bit for bit the single-device trajectory; S and R must
    divide the shard count) in the host loop; ``scan=True`` with them
    raises ``ValueError``."""
    dev = resolve_device(device)
    sharded = mesh is not None or num_shards is not None
    if sharded:
        if scan:
            raise ValueError(
                "the sharded serving replay is a host-driven loop; "
                "pass scan=False/None")
        from repro_torch.distributed.mesh import resolve_mesh

        mesh = resolve_mesh(mesh, num_shards, (workload.num_sessions,
                                               workload.num_replicas), dev)
        scan = False
    if isinstance(workload, TraceWorkload) and workload.table.device != dev:
        workload = workload.to(dev)
    strat, kw, trig, bpl, lb_on = _resolve(
        workload, strategy, strategy_kwargs, trigger, lb_every)
    tel = obs_telemetry.enabled_or_none(telemetry)
    if scan and strat.host:
        raise ValueError(
            f"strategy {strategy!r} is not jittable: it plans on the host; "
            "the device-resident serving replay needs a device plan_fn "
            "(use scan=False or a diff-* / none strategy)")
    if scan is None:
        scan = not strat.host
    _sync(dev)
    t0 = time.perf_counter()
    uid, kv, replica, recs, obs_state = _loop(
        workload, int(steps), strat, kw, trig, bpl, lb_on,
        None if slot_capacity is None else int(slot_capacity), dev, tel,
        bool(scan), mesh)
    final_uid = uid.cpu().numpy().astype(np.int32)
    final_replica = replica.cpu().numpy().astype(np.int32)
    final_kv = kv.cpu().numpy().astype(np.float32)
    wall = time.perf_counter() - t0
    return ServeReplayResult(
        max_avg=recs[:, 0], lb_fired=recs[:, 1], moved_sessions=recs[:, 2],
        moved_kv_bytes=recs[:, 3], prefix_local=recs[:, 4],
        deferred=recs[:, 5], occ_max=recs[:, 6],
        final_uid=final_uid, final_replica=final_replica, final_kv=final_kv,
        scanned=bool(scan), sharded=sharded, wall_seconds=wall,
        telemetry=(obs_telemetry.snapshot(obs_state, tel) if tel else None))
