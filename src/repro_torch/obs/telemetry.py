"""LB telemetry: a fixed-shape StepRecord ring buffer (counterpart of
``repro.obs.telemetry``).

Every replay loop of the port (``sim.simulator.run_series``, the PIC
driver, ``serve.replay.run_serve_replay``) accepts a
:class:`TelemetryConfig` and, when enabled, writes one record a step into
a :class:`TelemetryState`: a ``(ring, F)`` f32 buffer on the run's device
plus, at ``level="full"``, a ``(ring, P)`` per-node load buffer.  The
loops are host-driven, so the record count is a Python int and the slot a
host index: writing a record issues no device read.

``off`` costs nothing: a disabled config (``level="off"``, or no config
at all) is resolved to ``None`` by the loops, and every telemetry
expression sits behind a Python ``if tel:``, so an ``off`` run issues the
same launches and gives the same bits as a run without the argument
(``tests/test_torch_obs.py`` holds both).

Record fields (one f32 row a step, in the fixed order of :data:`FIELDS`,
the JAX package's): step index, max/avg/p95 node load, whether the
trigger fired and which trigger kind, plan_rejected, diffusion sweeps
executed, moved items, moved bytes (load units where the path has no byte
notion), the spill/deferred backlog and health-mask transitions.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.comm_graph import segment_sum

LEVELS = ("off", "counters", "full")

#: StepRecord column order.  Append-only: consumers (trace_export, tests)
#: address columns by name.
FIELDS = (
    "t",              # step index
    "max_load",       # max node load after the step
    "avg_load",       # mean node load
    "p95_load",       # 95th-percentile node load
    "fired",          # 0/1 — the trigger fired this step
    "trigger_kind",   # static trigger id (see TRIGGER_KINDS)
    "plan_rejected",  # 0/1 — a fired plan failed validation
    "sweeps",         # diffusion sweeps actually executed (PlanStats)
    "moved_items",    # objects/particles/sessions relocated
    "moved_bytes",    # executed exchange volume (load units if byteless)
    "deferred",       # spill/deferred backlog after the step
    "health_changed", # nodes whose alive mask flipped this step
)
NF = len(FIELDS)

TRIGGER_KINDS = {"every": 0, "threshold": 1, "predictive": 2, "other": 3}


def trigger_kind(trig) -> int:
    """Static integer id of a trigger policy (constant a run)."""
    from repro_torch.runtime import triggers as rt

    if isinstance(trig, rt.EveryTrigger):
        return TRIGGER_KINDS["every"]
    if isinstance(trig, rt.ThresholdTrigger):
        return TRIGGER_KINDS["threshold"]
    if isinstance(trig, rt.PredictiveTrigger):
        return TRIGGER_KINDS["predictive"]
    return TRIGGER_KINDS["other"]


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Telemetry knob.

    ``level="off"`` (the default): no state, nothing recorded, the same
    run as without a config.  ``"counters"``: the (ring, F) StepRecord
    buffer.  ``"full"``: also the per-node loads of every step, from which
    the Chrome trace builds its per-node lanes and migration flows."""

    level: str = "off"
    ring: int = 256

    def __post_init__(self):
        if self.level not in LEVELS:
            raise ValueError(f"telemetry level {self.level!r} not in {LEVELS}")
        if self.ring < 1:
            raise ValueError("telemetry ring must hold at least one record")

    @property
    def enabled(self) -> bool:
        return self.level != "off"

    @property
    def full(self) -> bool:
        return self.level == "full"


def resolve(cfg: Optional[TelemetryConfig]) -> TelemetryConfig:
    """``None`` → the default (off) config; strings allowed for CLIs."""
    if cfg is None:
        return TelemetryConfig()
    if isinstance(cfg, str):
        return TelemetryConfig(level=cfg)
    return cfg


def enabled_or_none(cfg) -> Optional[TelemetryConfig]:
    """The loops' view: the resolved config when it records, else None."""
    tel = resolve(cfg)
    return tel if tel.enabled else None


class TelemetryState(NamedTuple):
    """Ring state: the records written so far and the two buffers."""

    count: int              # total records ever written (host int)
    records: torch.Tensor   # (ring, NF) f32
    loads: torch.Tensor     # (ring, P) f32 — P == 0 below level="full"


def init_state(cfg: TelemetryConfig, num_nodes: int,
               device="cpu") -> TelemetryState:
    """A fresh ring for a run over ``num_nodes`` nodes on ``device``."""
    P = int(num_nodes) if cfg.full else 0
    return TelemetryState(
        count=0,
        records=torch.zeros((cfg.ring, NF), dtype=torch.float32,
                            device=device),
        loads=torch.zeros((cfg.ring, P), dtype=torch.float32, device=device))


def node_loads(loads, assignment, num_nodes: int) -> torch.Tensor:
    """Per-node load vector (the full level's lane source), added in index
    order (``comm_graph.segment_sum``: K4's ordered form on a card)."""
    return segment_sum(loads.to(torch.float32),
                       assignment.to(torch.int32), num_nodes)


def _scalar(v, device) -> torch.Tensor:
    """A 0-d f32 tensor on ``device``; host numbers become a fill launch
    there, never a host-to-device copy."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(v), dtype=torch.float32, device=device)


def record(state: TelemetryState, cfg: TelemetryConfig, *, t, node_loads,
           fired, trigger_kind: int = TRIGGER_KINDS["other"],
           plan_rejected=0.0, sweeps=0.0, moved_items=0.0, moved_bytes=0.0,
           deferred=0.0, health_changed=0.0) -> TelemetryState:
    """Write one StepRecord at ``count % ring``.

    ``node_loads`` is the per-node load vector after the step; max, mean
    and p95 (linear interpolation, as ``jnp.quantile``) derive from it
    here, so every path records the same statistics.  Call sites guard
    the call behind ``if tel:`` — this function assumes an enabled
    config."""
    dev = state.records.device
    nl = torch.as_tensor(node_loads, device=dev).to(torch.float32)
    row = torch.stack([
        _scalar(t, dev), nl.max(), nl.mean(),
        torch.quantile(nl, 0.95, interpolation="linear"),
        _scalar(fired, dev), _scalar(trigger_kind, dev),
        _scalar(plan_rejected, dev), _scalar(sweeps, dev),
        _scalar(moved_items, dev), _scalar(moved_bytes, dev),
        _scalar(deferred, dev), _scalar(health_changed, dev)])
    slot = state.count % cfg.ring
    state.records[slot] = row
    if cfg.full:
        state.loads[slot] = nl
    return state._replace(count=state.count + 1)


@dataclasses.dataclass
class TelemetrySnapshot:
    """Host-side, chronological view of a recorded run."""

    config: TelemetryConfig
    records: np.ndarray                 # (N, NF) — oldest → newest
    node_loads: Optional[np.ndarray]    # (N, P) at level="full", else None
    steps_total: int                    # records ever written (incl dropped)

    @property
    def dropped(self) -> int:
        """Records overwritten by ring wraparound."""
        return max(0, self.steps_total - len(self.records))

    def column(self, name: str) -> np.ndarray:
        """One StepRecord field over time, addressed by name."""
        return self.records[:, FIELDS.index(name)]


def snapshot(state: TelemetryState, cfg: TelemetryConfig) -> TelemetrySnapshot:
    """One host transfer: unroll the ring into chronological order."""
    count = int(state.count)
    ring = cfg.ring
    recs = state.records.cpu().numpy().astype(np.float32)
    loads = state.loads.cpu().numpy().astype(np.float32)
    if count >= ring:
        order = (np.arange(ring) + count % ring) % ring
        recs, loads = recs[order], loads[order]
    else:
        recs, loads = recs[:count], loads[:count]
    return TelemetrySnapshot(
        config=cfg, records=recs,
        node_loads=loads if cfg.full else None, steps_total=count)
