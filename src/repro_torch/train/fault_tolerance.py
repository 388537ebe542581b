"""Fault tolerance and straggler mitigation (counterpart of
``repro.train.fault_tolerance``).

1. **Checkpoint/restart loop** (:func:`run_resilient`): the step function
   runs under a supervisor that catches worker failures (injected or
   real), restores the last checkpoint and continues.
2. **Failure detection** (:class:`HeartbeatMonitor`): each host posts a
   heartbeat after every step; hosts whose last beat is older than
   ``timeout_steps`` are dead.
3. **Straggler mitigation** (:class:`StragglerBalancer`): per-host step
   times are the balancer's loads and the hosts' data-parallel ring its
   comm graph; an EMA filters noise, and a persistent straggler sheds data
   shards to its neighbors through the diffusion planner.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core import comm_graph
from repro_torch.core import engine as core_engine


class WorkerFailure(RuntimeError):
    """Raised (or injected) when a worker dies mid-step."""


def run_resilient(step_fn: Callable[[int], None], *, start_step: int,
                  num_steps: int, save_every: int,
                  save_fn: Callable[[int], None],
                  restore_fn: Callable[[], int], max_restarts: int = 8,
                  on_failure: Optional[Callable[[int, Exception], None]]
                  = None) -> Dict:
    """Supervised step loop: ``step_fn(step)`` may raise
    :class:`WorkerFailure`; the supervisor restores (``restore_fn``
    returns the step to resume at) and goes on, at most ``max_restarts``
    times.  Returns ``{"final_step", "restarts"}``."""
    restarts = 0
    step = start_step
    while step < num_steps:
        try:
            step_fn(step)
            step += 1
            if step % save_every == 0:
                save_fn(step)
        except WorkerFailure as e:  # noqa: PERF203 — failure path is rare
            restarts += 1
            if on_failure is not None:
                on_failure(step, e)
            if restarts > max_restarts:
                raise
            step = restore_fn()
    return dict(final_step=step, restarts=restarts)


@dataclasses.dataclass
class HeartbeatMonitor:
    num_hosts: int
    timeout_steps: int = 3
    _last: Optional[np.ndarray] = None

    def __post_init__(self):
        self._last = np.zeros(self.num_hosts, np.int64)

    def beat(self, host: int, step: int) -> None:
        self._last[host] = step

    def dead_hosts(self, current_step: int) -> List[int]:
        age = current_step - self._last
        return list(np.nonzero(age > self.timeout_steps)[0])

    def healthy_mesh_size(self, current_step: int) -> int:
        """The largest power-of-two host count left once dead hosts are
        excluded (a re-mesh candidate)."""
        alive = self.num_hosts - len(self.dead_hosts(current_step))
        size = 1
        while size * 2 <= alive:
            size *= 2
        return size


@dataclasses.dataclass
class StragglerBalancer:
    """Diffusion-based data re-sharding against persistent stragglers;
    plans with ``diff-comm`` on ``device``."""

    num_hosts: int
    shards_per_host: int = 8
    ema: float = 0.8
    trigger: float = 1.15          # max/avg EMA step time that triggers LB
    device: str = "cuda"

    def __post_init__(self):
        self._ema_time = np.ones(self.num_hosts)
        n = self.num_hosts * self.shards_per_host
        self._shard_host = (np.arange(n) // self.shards_per_host).astype(
            np.int32)

    @property
    def shard_assignment(self) -> np.ndarray:
        return self._shard_host.copy()

    def host_share(self) -> np.ndarray:
        """(H,) fraction of data shards per host."""
        return np.bincount(self._shard_host,
                           minlength=self.num_hosts) / len(self._shard_host)

    def observe(self, step_times: np.ndarray) -> Optional[Dict]:
        """Feed per-host step times; returns the plan's info when it
        rebalanced."""
        self._ema_time = (self.ema * self._ema_time
                          + (1 - self.ema) * np.asarray(step_times))
        ratio = self._ema_time.max() / (self._ema_time.mean() + 1e-30)
        if ratio < self.trigger:
            return None
        return self._rebalance()

    def _rebalance(self) -> Dict:
        n = len(self._shard_host)
        # shard load = host slowness (time per unit data) × shard size (1)
        loads = self._ema_time[self._shard_host]
        nxt = (np.arange(n) + 1) % n
        prob = comm_graph.make_problem(
            loads=loads.astype(np.float32), assignment=self._shard_host,
            edges=np.stack([np.arange(n), nxt], axis=1),
            edge_bytes=np.ones(n, np.float32), num_nodes=self.num_hosts,
            coords=np.arange(n, dtype=np.float32)[:, None],
            device=self.device)
        plan = core_engine.get_strategy("diff-comm").run(
            prob, k=min(2, self.num_hosts - 1))
        moved = int((plan.assignment != self._shard_host).sum())
        self._shard_host = plan.assignment.astype(np.int32)
        return dict(moved_shards=moved, **plan.info)
