"""LB triggers: *when* to rebalance (counterpart of ``repro.runtime.triggers``).

Every trigger is a frozen dataclass with

  * ``init_state(device) -> TriggerState`` — fixed-shape state tensors;
  * ``decide(state, t, max_load, avg_load, total_load) -> (do, state)`` —
    called every step *before* planning with the pre-LB load statistics;
    ``t`` is the host step index and ``do`` a bool (a 0-d tensor for the
    load-driven triggers);
  * ``observe(state, moved_load, fired)`` — execution feedback;
  * ``never`` — True means the trigger never fires.

Triggers:

  ``EveryTrigger``      — fixed period ``(t > 0) & (t % every == 0)``,
                          decided on the host with no device read.
  ``ThresholdTrigger``  — fires when max/avg exceeds ``hi``, with
                          hysteresis and a refractory period.
  ``PredictiveTrigger`` — least-squares trend of the excess load; fires when
                          the projected imbalance time beats the (measured,
                          else estimated) migration cost.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Union

import torch

from repro_torch.core.comm_graph import segment_sum
from repro_torch.runtime.cost import RuntimeCostModel


class TriggerState(NamedTuple):
    """State tensors shared by every trigger kind (``history`` newest
    sample last; ``last_moved`` < 0 until an exchange was observed)."""

    last_lb: torch.Tensor     # i32 — step of the last fired rebalance
    armed: torch.Tensor       # bool — hysteresis arm flag
    history: torch.Tensor     # (W,) f32 — recent excess-load samples
    hist_len: torch.Tensor    # i32 — valid entries at the tail of history
    last_moved: torch.Tensor  # f32 — load moved by the last exchange


def _init_state(window: int, device) -> TriggerState:
    return TriggerState(
        last_lb=torch.tensor(-(1 << 30), dtype=torch.int32, device=device),
        armed=torch.tensor(True, device=device),
        history=torch.zeros(max(1, int(window)), dtype=torch.float32,
                            device=device),
        hist_len=torch.tensor(0, dtype=torch.int32, device=device),
        last_moved=torch.tensor(-1.0, dtype=torch.float32, device=device),
    )


def load_stats(loads, assignment, num_nodes: int):
    """(max, avg, total) node load as f32 0-d tensors — the trigger inputs."""
    nl = segment_sum(loads.to(torch.float32), assignment, num_nodes)
    total = nl.sum()
    return nl.max(), total / num_nodes, total


@dataclasses.dataclass(frozen=True)
class EveryTrigger:
    """Fixed-period trigger — the ``lb_every`` cadence."""

    every: int = 10

    @property
    def never(self) -> bool:
        return self.every <= 0

    def init_state(self, device="cpu") -> TriggerState:
        return _init_state(1, device)

    def decide(self, state, t: int, max_load, avg_load, total_load):
        if self.never:
            return False, state
        return (t > 0) and (t % self.every == 0), state

    def observe(self, state, moved_load, fired):
        return state


@dataclasses.dataclass(frozen=True)
class ThresholdTrigger:
    """Fires when ``max/avg > hi`` while armed and at least
    ``min_interval`` steps after the last rebalance; re-arms below ``lo``
    or after ``rearm_after`` steps."""

    hi: float = 1.10
    lo: float = 1.05
    min_interval: int = 2
    rearm_after: int = 4

    @property
    def never(self) -> bool:
        return False

    def init_state(self, device="cpu") -> TriggerState:
        return _init_state(1, device)

    def decide(self, state, t: int, max_load, avg_load, total_load):
        ma = max_load / torch.clamp(avg_load, min=1e-30)
        since = t - state.last_lb
        armed = state.armed | (ma < self.lo) | (since >= self.rearm_after)
        do = (t > 0) & armed & (ma > self.hi) & (since >= self.min_interval)
        return do, state._replace(
            last_lb=torch.where(do, t, state.last_lb).to(torch.int32),
            armed=torch.where(do, False, armed))

    def observe(self, state, moved_load, fired):
        return state


@dataclasses.dataclass(frozen=True)
class PredictiveTrigger:
    """Linear-trend predictive trigger with cost amortization: fires when
    ``efficiency`` × the projected imbalance time over ``horizon`` steps
    exceeds the migration cost — that of the last executed exchange once
    one was observed (``measured_gate``), else the a-priori estimate."""

    window: int = 8
    horizon: int = 8
    min_interval: int = 2
    efficiency: float = 0.8
    cost: RuntimeCostModel = RuntimeCostModel()
    measured_gate: bool = True

    @property
    def never(self) -> bool:
        return False

    def init_state(self, device="cpu") -> TriggerState:
        return _init_state(self.window, device)

    def decide(self, state, t: int, max_load, avg_load, total_load):
        W = self.window
        dev = state.history.device
        f32 = torch.float32
        excess = torch.clamp(max_load.to(f32) - avg_load.to(f32), min=0.0)
        hist = torch.cat([state.history[1:], excess.reshape(1)])
        # a rebalance resets the trend
        hist_len = torch.clamp(
            torch.where(state.last_lb == t - 1, 1, state.hist_len + 1),
            max=W)
        x = torch.arange(W, dtype=f32, device=dev)
        valid = (x >= W - hist_len).to(f32)
        n = torch.clamp(valid.sum(), min=1.0)
        xm = (x * valid).sum() / n
        ym = (hist * valid).sum() / n
        var = (valid * (x - xm) ** 2).sum()
        slope = torch.where(
            var > 0, (valid * (x - xm) * (hist - ym)).sum() / var, 0.0)
        h = torch.arange(1, self.horizon + 1, dtype=f32, device=dev)
        projected = torch.clamp(excess + slope * h, min=0.0).sum()
        loss = projected * self.cost.t_load * self.efficiency
        est = self.cost.est_migration_seconds(total_load.to(f32))
        if self.measured_gate:
            gate = torch.where(
                state.last_moved >= 0.0,
                self.cost.migration_seconds(state.last_moved), est)
        else:
            gate = est
        do = ((t > 0) & (hist_len >= 2) & (loss > gate)
              & (t - state.last_lb >= self.min_interval))
        return do, TriggerState(
            last_lb=torch.where(do, t, state.last_lb).to(torch.int32),
            armed=state.armed, history=hist,
            hist_len=hist_len.to(torch.int32),
            last_moved=state.last_moved)

    def observe(self, state, moved_load, fired):
        """Record the measured load volume of an executed exchange."""
        moved = torch.as_tensor(moved_load, dtype=torch.float32,
                                device=state.last_moved.device)
        return state._replace(last_moved=torch.where(
            torch.as_tensor(fired, device=moved.device).to(torch.bool),
            moved, state.last_moved))


Trigger = Union[EveryTrigger, ThresholdTrigger, PredictiveTrigger]

_BY_NAME = {
    "every": EveryTrigger,
    "threshold": ThresholdTrigger,
    "predictive": PredictiveTrigger,
}


@functools.lru_cache(maxsize=256)
def _named(name: str, lb_every: int) -> Trigger:
    if name == "every":
        return EveryTrigger(every=lb_every)
    return _BY_NAME[name]()


def resolve(spec, *, lb_every: int,
            strategy_trigger: Optional[str] = None) -> Trigger:
    """Canonical trigger from ``None`` (the strategy's registered trigger,
    else the fixed period), a name, or a trigger instance."""
    if spec is None:
        spec = strategy_trigger or "every"
    if isinstance(spec, str):
        if spec not in _BY_NAME:
            raise KeyError(
                f"unknown trigger {spec!r}; available: {sorted(_BY_NAME)}")
        return _named(spec, int(lb_every))
    if not all(hasattr(spec, a)
               for a in ("decide", "init_state", "never", "observe")):
        raise TypeError(
            f"trigger must be a name or a Trigger instance (decide / "
            f"init_state / never / observe), got {spec!r}")
    return spec


def resolve_for_strategy(spec, *, lb_every: int, strategy: str) -> Trigger:
    """:func:`resolve` with the strategy registry as the ``None`` fallback."""
    from repro_torch.core import engine  # local: keep runtime importable alone

    try:
        strategy_trigger = engine.get_strategy(strategy).trigger
    except KeyError:
        strategy_trigger = None
    return resolve(spec, lb_every=lb_every,
                   strategy_trigger=strategy_trigger)
