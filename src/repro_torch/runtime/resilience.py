"""Resilience layer of the sharded replays (counterpart of
``repro.runtime.resilience``).

* **Fault injection** — :class:`FaultSchedule`: a static list of
  ``(step, shard, kind)`` events (``die`` / ``slow`` / ``recover``) whose
  health projection is a pure function of the step, so a schedule replays
  identically in one run, a chunked run or after a checkpoint restore.
* **Health-masked planning** — :func:`rehome_dead` moves a dead node's
  objects onto the alive node they communicate with most (else the
  least-loaded alive node), :func:`mask_preference` zeroes the stage-1
  preference rows and columns of dead nodes, :func:`degrade_problem`
  applies both and scales slowed nodes' loads.
* **Plan guardrails** — :func:`validate_plan` checks a candidate
  assignment on the device (owners in range and alive, finite loads,
  optional per-node slot bound); the replays adopt a plan only if it
  passes and report ``plan_rejected`` otherwise.
* **Checkpointed replay** — :func:`run_series_checkpointed` drives the
  sharded series replay in chunks under
  ``train.fault_tolerance.run_resilient``, snapshotting the loop state at
  every chunk boundary and resuming from it after an injected failure,
  bit for bit the uninterrupted run.

The spill exchange (graceful capacity degradation) lives with the
exchange itself: ``runtime.migrate.spill_admissions`` / ``spill_owner`` /
``ring_exchange(mode="spill")``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import comm_graph
from repro_torch.core.comm_graph import segment_sum

_KINDS = ("die", "slow", "recover")


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """Deterministic shard-fault script for the replays.

    ``events`` is a tuple of ``(step, shard, kind)``: ``"die"`` (the
    shard's nodes stop hosting objects), ``"slow"`` (the shard runs at
    ``slow_factor`` of full speed: its load reads ``1/slow_factor``
    heavier in trigger stats and planning) or ``"recover"``.  An event
    takes effect at its step and holds until a later event for the same
    shard.  The schedule is hashable; an empty one is inert (the replays
    normalize it to None)."""

    events: Tuple[Tuple[int, int, str], ...] = ()
    slow_factor: float = 0.5

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(
            (int(s), int(d), str(k)) for s, d, k in self.events))
        seen = set()
        for step, shard, kind in self.events:
            if kind not in _KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} (one of {_KINDS})")
            if step < 0 or shard < 0:
                raise ValueError(
                    f"fault event ({step}, {shard}, {kind!r}) must have "
                    "non-negative step and shard")
            if (step, shard) in seen:
                raise ValueError(
                    f"duplicate fault event for shard {shard} at step "
                    f"{step} — one event per (step, shard)")
            seen.add((step, shard))
        if not (0.0 < float(self.slow_factor) <= 1.0):
            raise ValueError("slow_factor must be in (0, 1]")

    @property
    def empty(self) -> bool:
        return not self.events

    def max_shard(self) -> int:
        """Largest shard id referenced (-1 for an empty schedule)."""
        return max((d for _, d, _ in self.events), default=-1)

    def _health_np(self, t: int, D: int):
        """``(alive, speed)`` as NumPy (D,) bool / f32 at step ``t``."""
        last = np.full((3, D), -1, np.int64)
        for step, shard, kind in self.events:
            if step <= t and shard < D:
                k = _KINDS.index(kind)
                last[k, shard] = max(last[k, shard], step)
        die, slow, rec = last
        alive = die <= rec
        slowed = (slow > rec) & (slow > die)
        speed = np.where(alive & slowed, np.float32(self.slow_factor),
                         np.float32(1.0)).astype(np.float32)
        return alive, speed

    def shard_health(self, t: int, D: int, device="cpu"):
        """``(alive (D,) bool, speed (D,) f32)`` at step ``t`` on
        ``device``.  A shard is dead iff its latest ``die`` is more recent
        than its latest ``recover``; slowed iff its latest ``slow``
        postdates both.  Negative ``t`` is before every event."""
        alive, speed = self._health_np(int(t), int(D))
        return (torch.as_tensor(alive, device=device),
                torch.as_tensor(speed, device=device))

    def node_health(self, t: int, num_nodes: int, D: int, device="cpu"):
        """Shard health at node granularity: shard ``d`` owns the
        contiguous node rows ``[d*rpd, (d+1)*rpd)``."""
        alive, speed = self.shard_health(t, D, device)
        rpd = num_nodes // D
        return (torch.repeat_interleave(alive, rpd),
                torch.repeat_interleave(speed, rpd))

    def changed_at(self, t: int, D: int) -> bool:
        """Did any shard's health change at step ``t``?  (A host
        decision: a pure function of the step.)"""
        if self.empty:
            return False
        a0, s0 = self._health_np(int(t) - 1, int(D))
        a1, s1 = self._health_np(int(t), int(D))
        return bool(((a0 != a1) | (s0 != s1)).any())


# ------------------------------------------------ health-masked planning --


def mask_preference(preference, alive):
    """Zero the stage-1 preference rows and columns of dead nodes
    (``select_neighbors`` takes ``preference > 0`` as candidates); an
    all-alive mask is the identity."""
    alive = torch.as_tensor(alive, device=preference.device).bool()
    return torch.where(alive[:, None] & alive[None, :], preference, 0.0)


def rehome_dead(problem: comm_graph.LBProblem, alive) -> torch.Tensor:
    """Re-home the objects of dead nodes onto healthy ones.

    Each displaced object moves to the alive node it exchanges the most
    bytes with under the current assignment, else (no alive partner) to
    the least-loaded alive node; ties go to the lowest node id.  With no
    node alive the assignment is returned as is (``validate_plan`` then
    rejects the plan)."""
    P = problem.num_nodes
    dev = problem.device
    a = problem.assignment.to(torch.int32)
    alive = torch.as_tensor(alive, device=dev).bool()
    dead_obj = ~alive[a.clamp(0, P - 1).long()]
    valid = problem.edges_src >= 0
    src = torch.where(valid, problem.edges_src, 0).long()
    dst = torch.where(valid, problem.edges_dst, 0).long()
    w = torch.where(valid, problem.edges_bytes, 0.0).to(torch.float32)
    N = int(a.shape[0])
    # (N, P) bytes each object exchanges with each node
    byts = (segment_sum(w, src * P + a[dst].long(), N * P)
            + segment_sum(w, dst * P + a[src].long(), N * P)).reshape(N, P)
    score = torch.where(alive[None, :], byts, -1.0)
    best = torch.argmax(score, dim=1).to(torch.int32)
    has_comm = score.amax(dim=1) > 0.0
    nl = comm_graph.node_loads(problem)
    fallback = torch.argmin(torch.where(alive, nl, float("inf"))).to(
        torch.int32)
    target = torch.where(has_comm, best, fallback)
    return torch.where(dead_obj & alive.any(), target, a)


def degrade_problem(problem: comm_graph.LBProblem, alive,
                    speed=None) -> comm_graph.LBProblem:
    """The problem as the degraded mesh sees it before planning: dead
    nodes' objects re-homed (:func:`rehome_dead`) and, with ``speed``,
    each object's load scaled by its owner's reciprocal speed (planning
    only; metrics keep the true loads)."""
    a = rehome_dead(problem, alive)
    problem = problem.with_assignment(a)
    if speed is not None:
        speed = torch.as_tensor(speed, dtype=torch.float32,
                                device=problem.device)
        w = 1.0 / torch.clamp(speed, min=1e-6)
        problem = dataclasses.replace(
            problem, loads=problem.loads * w[a.long()])
    return problem


# -------------------------------------------------------- plan guardrails --


def validate_plan(assignment, loads, *, num_nodes: int, alive=None,
                  node_capacity=None) -> torch.Tensor:
    """Plan guardrail, a 0-d bool tensor: every owner in
    ``[0, num_nodes)``, every load finite, every owner alive (given
    ``alive``), no node above ``node_capacity`` objects (given one)."""
    a = torch.as_tensor(assignment)
    if a.ndim != 1:
        raise ValueError("assignment must be a dense (N,) owner vector")
    a = a.to(torch.int64)
    loads = torch.as_tensor(loads, device=a.device)
    ok = ((a >= 0) & (a < num_nodes)).all() & torch.isfinite(loads).all()
    safe = a.clamp(0, num_nodes - 1)
    if alive is not None:
        ok = ok & torch.as_tensor(alive, device=a.device).bool()[safe].all()
    if node_capacity is not None:
        counts = comm_graph.segment_count(safe, num_nodes)
        ok = ok & (counts <= int(node_capacity)).all()
    return ok


def finite_or(value, fallback):
    """``value`` where finite, ``fallback`` elsewhere."""
    value = torch.as_tensor(value)
    return torch.where(torch.isfinite(value), value,
                       torch.as_tensor(fallback, dtype=value.dtype,
                                       device=value.device))


# --------------------------------------------- checkpointed sharded replay --


def run_series_checkpointed(initial, evolve, *, steps: int,
                            checkpoint_every: int, lb_every: int = 10,
                            strategy: str = "diff-comm",
                            strategy_kwargs: Optional[dict] = None,
                            trigger=None, mesh=None,
                            num_shards: Optional[int] = None,
                            threads_per_node: Optional[int] = None,
                            faults: Optional[FaultSchedule] = None,
                            guard: Optional[bool] = None,
                            fail_at=(), max_restarts: int = 8):
    """Checkpoint/restart-supervised sharded series replay, bit for bit
    ``distributed.replay_shard.run_series_sharded``.

    The replay runs in ``checkpoint_every``-step chunks; its state (the
    problem's tensors and the trigger state) is copied to the host at
    every chunk boundary, and ``train.fault_tolerance.run_resilient``
    restores the last copy and reruns the chunk after a
    ``WorkerFailure``.  ``fail_at`` (chunk indices) injects one failure
    before each named chunk, once each.  Returns the ``SeriesResult`` of
    ``run_series_sharded``."""
    import time

    from repro_torch.distributed import replay_shard as rs
    from repro_torch.train import fault_tolerance as ft

    if checkpoint_every < 1:
        raise ValueError("checkpoint_every must be >= 1")
    t0 = time.perf_counter()
    chunks = [min(checkpoint_every, steps - s)
              for s in range(0, steps, checkpoint_every)]
    prepared = rs.prepare_series(
        initial, evolve, steps=steps, lb_every=lb_every, strategy=strategy,
        strategy_kwargs=strategy_kwargs, trigger=trigger, mesh=mesh,
        num_shards=num_shards, threads_per_node=threads_per_node,
        faults=faults, guard=guard)
    carry = prepared.initial_carry()
    snapshots: Dict[int, tuple] = {0: prepared.to_host(carry)}
    ys_chunks: Dict[int, np.ndarray] = {}
    pending = set(int(c) for c in fail_at)
    state = {"carry": carry}

    def step_fn(ci):
        if ci in pending:
            pending.discard(ci)
            raise ft.WorkerFailure(f"injected failure before chunk {ci}")
        new_carry, ys = prepared.run_chunk(state["carry"], sum(chunks[:ci]),
                                           chunks[ci])
        state["carry"] = new_carry
        ys_chunks[ci] = ys

    def save_fn(ci):
        snapshots[ci] = prepared.to_host(state["carry"])

    def restore_fn():
        ci = max(snapshots)
        state["carry"] = prepared.from_host(snapshots[ci])
        return ci

    ft.run_resilient(step_fn, start_step=0, num_steps=len(chunks),
                     save_every=1, save_fn=save_fn, restore_fn=restore_fn,
                     max_restarts=max_restarts)
    ys = np.concatenate([ys_chunks[ci] for ci in range(len(chunks))])
    return prepared.package(state["carry"], ys,
                            wall_seconds=time.perf_counter() - t0)
