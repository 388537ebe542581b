"""Cross-replica session scheduling on the runtime (counterpart of
``repro.serve.scheduler``).

Serving replicas are nodes; sessions (multi-turn decode requests) are the
persistently interacting objects: a session's KV cache lives on its
replica, sessions sharing a prompt prefix form comm edges (prefix-cache
hits need the sharers colocated), and session loads persist over many
scheduling periods.

The store is a host NumPy mirror of fixed-shape slabs (auto-growing by
doubling); :meth:`DiffusionScheduler.fleet` puts it on the scheduler's
device as a :class:`SessionFleet`, where the prefix-sharing graph
(``core.comm_graph.prefix_group_edges``), the plan (the Strategy
registry) and the exchange run.  A rebalance is executed: the fleet slabs
are re-bucketed into replica-contiguous slot order by
``runtime.migrate.migrate`` (the counting-scatter kernel on a card), the
moved KV bytes are read off ``Manifest.moved_sum``, and an optional
per-replica slot budget defers overflow through
``runtime.migrate.spill_owner``.  ``maybe_rebalance`` adds the control
plane: a ``runtime.triggers`` policy decides when to rebalance.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import comm_graph, engine, metrics
from repro_torch.kernels import resolve_device
from repro_torch.runtime import migrate as rt_migrate
from repro_torch.runtime import triggers as rt_triggers
from repro_torch.runtime.cost import RuntimeCostModel

#: shared load floor: node loads and edge weights are priced from the
#: same clamped values
LOAD_FLOOR = 1e-3


@dataclasses.dataclass
class Session:
    uid: int
    replica: int
    tokens_per_s: float             # decode load (EMA)
    prefix_group: int = -1          # sessions sharing a prompt prefix
    kv_bytes: float = 1.0           # resident KV cache size (exchange cost)


class SessionFleet(NamedTuple):
    """Device-resident session store: one fixed-shape slab per field.
    ``uid < 0`` marks a free slot; ``group`` ids are canonical in
    ``[0, S)`` with ``-1`` for ungrouped."""

    uid: torch.Tensor        # (S,) i32
    load: torch.Tensor       # (S,) f32 — decode tokens/s EMA
    group: torch.Tensor      # (S,) i32 — canonical prefix-group id
    replica: torch.Tensor    # (S,) i32 — owning replica
    kv: torch.Tensor         # (S,) f32 — resident KV bytes

    @property
    def active(self) -> torch.Tensor:
        return self.uid >= 0


def fleet_loads(fleet: SessionFleet) -> torch.Tensor:
    """(S,) f32 planning loads: live sessions floored at ``LOAD_FLOOR``,
    free slots exactly the floor."""
    floor = torch.tensor(LOAD_FLOOR, dtype=torch.float32,
                         device=fleet.load.device)
    return torch.where(fleet.active,
                       torch.maximum(fleet.load.to(torch.float32), floor),
                       floor)


def fleet_problem(fleet: SessionFleet, num_replicas: int,
                  *, coords=None) -> comm_graph.LBProblem:
    """``LBProblem`` over the fleet on its device: N = S slots, P =
    replicas; edge weights and node loads both from :func:`fleet_loads`."""
    loads = fleet_loads(fleet)
    es, ed, ew = comm_graph.prefix_group_edges(
        fleet.group, loads, fleet.active, ring_eps=LOAD_FLOOR)
    return comm_graph.LBProblem(
        loads=loads, assignment=fleet.replica.to(torch.int32),
        edges_src=es, edges_dst=ed, edges_bytes=ew,
        num_nodes=int(num_replicas), coords=coords)


def prefix_locality(fleet: SessionFleet, assignment=None) -> torch.Tensor:
    """f32 0-d tensor in [0, 1]: the fraction of prefix-sharing (star)
    edge weight kept intra-replica."""
    a = (fleet.replica if assignment is None
         else torch.as_tensor(assignment, device=fleet.uid.device))
    a = a.to(torch.int32)
    S = int(a.shape[0])
    es, ed, ew = comm_graph.prefix_group_edges(
        fleet.group, fleet_loads(fleet), fleet.active, ring_eps=LOAD_FLOOR)
    es, ed, ew = es[:S], ed[:S], ew[:S]        # star edges only
    valid = es >= 0
    w = torch.where(valid, ew, 0.0)
    same = a[es.clamp(0, S - 1).long()] == a[ed.clamp(0, S - 1).long()]
    intra = torch.where(valid & same, ew, 0.0)
    return intra.sum() / torch.clamp(w.sum(), min=1e-30)


def _strategy_params(strat: engine.Strategy, num_replicas: int,
                     k: int) -> Dict:
    """Diffusion variants get the clamped neighbor count; ``none`` none."""
    if strat.variant is None:
        return {}
    return dict(k=max(1, min(int(k), int(num_replicas) - 1)))


class DiffusionScheduler:
    """Session → replica placement with executed KV migration, planned and
    exchanged on ``device`` (default the card)."""

    def __init__(self, num_replicas: int, *, k: int = 4,
                 capacity: int = 64, device="cuda"):
        self.num_replicas = int(num_replicas)
        self.k = int(k)
        self.device = resolve_device(device)
        S = max(8, int(capacity))
        self._uid = np.full(S, -1, np.int32)
        self._load = np.zeros(S, np.float32)
        self._group = np.full(S, -1, np.int64)   # raw (caller) group ids
        self._replica = np.zeros(S, np.int32)
        self._kv = np.zeros(S, np.float32)
        self._slot: Dict[int, int] = {}
        self._trig = None
        self._tstate = None
        self._tstep = 0

    # ------------------------------------------------------------ store --

    @property
    def capacity(self) -> int:
        return int(self._uid.shape[0])

    def __len__(self) -> int:
        return len(self._slot)

    @property
    def sessions(self) -> Dict[int, Session]:
        """Materialized ``{uid: Session}`` view of the slabs."""
        return {
            int(self._uid[i]): Session(
                uid=int(self._uid[i]), replica=int(self._replica[i]),
                tokens_per_s=float(self._load[i]),
                prefix_group=int(self._group[i]),
                kv_bytes=float(self._kv[i]))
            for i in self._slot.values()
        }

    def _grow(self) -> None:
        S = self.capacity
        for name in ("_uid", "_load", "_group", "_replica", "_kv"):
            a = getattr(self, name)
            pad = np.full(S, -1 if name in ("_uid", "_group") else 0,
                          a.dtype)
            setattr(self, name, np.concatenate([a, pad]))

    def add(self, s: Session) -> None:
        if s.uid in self._slot:
            i = self._slot[s.uid]
        else:
            free = np.flatnonzero(self._uid < 0)
            if not len(free):
                self._grow()
                free = np.flatnonzero(self._uid < 0)
            i = int(free[0])
            self._slot[s.uid] = i
        self._uid[i] = s.uid
        self._load[i] = s.tokens_per_s
        self._group[i] = s.prefix_group
        self._replica[i] = s.replica
        self._kv[i] = s.kv_bytes

    def remove(self, uid: int) -> None:
        i = self._slot.pop(uid, None)
        if i is not None:
            self._uid[i] = -1
            self._load[i] = 0.0
            self._group[i] = -1
            self._kv[i] = 0.0

    def place_new(self, s: Session) -> int:
        """Admission: the least-loaded replica among those already holding
        s's prefix group, else the least-loaded replica overall."""
        load = self.replica_loads()
        if s.prefix_group >= 0:
            peers = (self._uid >= 0) & (self._group == s.prefix_group)
            if peers.any():
                reps = np.unique(self._replica[peers])
                s.replica = int(reps[np.argmin(load[reps])])
                self.add(s)
                return s.replica
        s.replica = int(np.argmin(load))
        self.add(s)
        return s.replica

    def replica_loads(self) -> np.ndarray:
        act = self._uid >= 0
        return np.bincount(self._replica[act],
                           weights=self._load[act].astype(np.float64),
                           minlength=self.num_replicas)

    # ------------------------------------------------------------ fleet --

    def _canonical_groups(self) -> np.ndarray:
        """Raw group ids → canonical ids in [0, S), -1 for ungrouped/free."""
        out = np.full(self.capacity, -1, np.int32)
        act = np.flatnonzero(self._uid >= 0)
        grouped = act[self._group[act] >= 0]
        if len(grouped):
            _, inv = np.unique(self._group[grouped], return_inverse=True)
            out[grouped] = inv.astype(np.int32)
        return out

    def fleet(self) -> SessionFleet:
        """Device snapshot of the session store."""
        def t(a, dt):
            return torch.as_tensor(a, dtype=dt, device=self.device)

        return SessionFleet(
            uid=t(self._uid, torch.int32), load=t(self._load, torch.float32),
            group=t(self._canonical_groups(), torch.int32),
            replica=t(self._replica, torch.int32),
            kv=t(self._kv, torch.float32))

    def problem(self) -> comm_graph.LBProblem:
        return fleet_problem(self.fleet(), self.num_replicas)

    # -------------------------------------------------------- rebalance --

    def rebalance(self, *, strategy: str = "diff-comm",
                  slot_capacity: Optional[int] = None) -> Dict:
        """Plan through the Strategy registry, then execute the placement
        delta as a slab exchange through ``runtime.migrate``.
        ``slot_capacity`` bounds the live sessions per replica: moves that
        would overflow are deferred in place (``deferred_sessions``)."""
        if len(self._slot) < 2:
            return dict(skipped=True)
        dev = self.device
        fleet = self.fleet()
        prob = fleet_problem(fleet, self.num_replicas)
        strat = engine.get_strategy(strategy)
        plan = strat.run(
            prob, **_strategy_params(strat, self.num_replicas, self.k))
        info = dict(plan.info)
        planned = torch.as_tensor(plan.assignment, dtype=torch.int32,
                                  device=dev)
        owner_new = planned
        deferred = 0
        if slot_capacity is not None:
            # free slots are parked on a virtual node with unbounded
            # capacity, so they neither use the budget nor block moves
            R = park = self.num_replicas
            act = fleet.active
            cap = torch.full((R + 1,), int(slot_capacity), dtype=torch.int32,
                             device=dev)
            cap[park] = self.capacity
            eff, dmask = rt_migrate.spill_owner(
                torch.where(act, fleet.replica, park),
                torch.where(act, owner_new, park),
                num_nodes=R + 1, capacity=cap)
            owner_new = torch.where(act, eff, owner_new)
            deferred = int((dmask & act).sum())
        (uid, load, _, kv, raw_group), man = rt_migrate.migrate(
            fleet.replica, owner_new,
            (fleet.uid, fleet.load, fleet.group, fleet.kv,
             torch.as_tensor(self._group, device=dev)),
            num_nodes=self.num_replicas)
        new_replica = owner_new[man.order.long()]
        moved_kv = float(man.moved_sum(fleet.kv, where=fleet.active))
        moved_n = int((man.moved & fleet.active).sum())
        # refresh the host mirror from the relocated slabs
        self._uid = uid.cpu().numpy().astype(np.int32)
        self._load = load.cpu().numpy().astype(np.float32)
        self._group = raw_group.cpu().numpy()
        self._replica = new_replica.cpu().numpy().astype(np.int32)
        self._kv = kv.cpu().numpy().astype(np.float32)
        self._slot = {int(u): i for i, u in enumerate(self._uid) if u >= 0}
        info.update(metrics.evaluate(prob, planned))
        info.update(moved_kv_bytes=moved_kv, moved_sessions=moved_n,
                    deferred_sessions=deferred,
                    prefix_local=float(prefix_locality(self.fleet())))
        return info

    # ---------------------------------------------------- control plane --

    def maybe_rebalance(self, *, strategy: str = "diff-comm+predictive",
                        trigger=None, lb_every: int = 10,
                        slot_capacity: Optional[int] = None,
                        cost: Optional[RuntimeCostModel] = None) -> Dict:
        """One control-plane tick: the trigger decides, ``rebalance``
        executes; after a fire the executed KV volume is fed back through
        ``Trigger.observe`` in load units (``moved_kv_bytes /
        cost.bytes_per_load``)."""
        trig = rt_triggers.resolve_for_strategy(
            trigger, lb_every=lb_every, strategy=strategy)
        if cost is None:
            cost = getattr(trig, "cost", None) or RuntimeCostModel()
        if trig is not self._trig:
            self._trig, self._tstate, self._tstep = (
                trig, trig.init_state(self.device), 0)
        t = self._tstep
        self._tstep += 1
        fleet = self.fleet()
        mx, av, tot = rt_triggers.load_stats(
            fleet_loads(fleet), fleet.replica, self.num_replicas)
        do, self._tstate = trig.decide(self._tstate, t, mx, av, tot)
        fired = bool(do)
        if fired:
            info = self.rebalance(strategy=strategy,
                                  slot_capacity=slot_capacity)
            moved_load = (info.get("moved_kv_bytes", 0.0)
                          / max(cost.bytes_per_load, 1e-30))
        else:
            info = dict(skipped=True)
            moved_load = 0.0
        self._tstate = trig.observe(self._tstate, moved_load, fired)
        info.update(fired=fired, t=t)
        return info
