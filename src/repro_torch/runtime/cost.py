"""Migration / amortization cost model for the online rebalancing runtime
(counterpart of ``repro.runtime.cost``): the single place where the
trade-off between imbalance time recovered and migration paid is priced.
Every method is a pure function of scalars or tensors."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RuntimeCostModel:
    """Per-term cost model in seconds, shared by triggers and benchmarks.

    Attributes:
      t_load:         seconds one unit of object load costs the critical
                      path per application step (PIC: seconds/particle).
      t_byte:         seconds per byte crossing a node boundary.
      bytes_per_load: migration payload bytes carried by one unit of load.
      lb_overhead:    fixed seconds charged per executed rebalance.
      moved_frac_est: a-priori load fraction a rebalance migrates, used by
                      the predictive trigger before any plan exists.
    """

    t_load: float = 1.0
    t_byte: float = 1.0
    bytes_per_load: float = 1.0
    lb_overhead: float = 0.0
    moved_frac_est: float = 0.15

    def imbalance_seconds(self, max_load, avg_load):
        """Per-step time lost to imbalance, priced at ``t_load``."""
        return torch.clamp(max_load - avg_load, min=0.0) * self.t_load

    def migration_seconds(self, moved_load):
        """Executed-exchange cost: payload bytes plus fixed overhead."""
        return (moved_load * self.bytes_per_load * self.t_byte
                + self.lb_overhead)

    def est_migration_seconds(self, total_load):
        """A-priori migration cost: ``moved_frac_est`` of the total load."""
        return self.migration_seconds(self.moved_frac_est * total_load)

    def step_seconds(self, max_load, moved_load, lb_fired):
        """Modeled seconds of one step: slowest-node compute + executed
        migration traffic + LB overhead when fired."""
        f32 = torch.float32
        return (torch.as_tensor(max_load, dtype=f32) * self.t_load
                + torch.as_tensor(moved_load, dtype=f32)
                * self.bytes_per_load * self.t_byte
                + torch.as_tensor(lb_fired, dtype=f32) * self.lb_overhead)

    @classmethod
    def from_pic(cls, pic_cost, *, strategy: str, num_pes: int,
                 bytes_per_particle: float, plan_seconds: float = 0.0,
                 moved_frac_est: float = 0.15) -> "RuntimeCostModel":
        """Bridge from the PIC driver's ``pic.driver.CostModel``.

        ``plan_seconds`` is the measured planning wall time, amortized as
        ``CostModel.lb_seconds`` amortizes it (diffusion is distributed —
        divided by ``num_pes``; centralized planners pay it in full)."""
        return cls(
            t_load=float(pic_cost.t_particle),
            t_byte=float(pic_cost.t_byte),
            bytes_per_load=float(bytes_per_particle),
            lb_overhead=float(
                pic_cost.lb_seconds(plan_seconds, strategy, num_pes)),
            moved_frac_est=float(moved_frac_est),
        )


def series_modeled_seconds(result, model: RuntimeCostModel) -> np.ndarray:
    """(T,) modeled seconds per step of a ``sim.simulator.SeriesResult``
    (its ``max_load``, ``migrated_load`` and ``lb_fired`` records)."""
    for field in ("max_load", "migrated_load", "lb_fired"):
        if getattr(result, field, None) is None:
            raise ValueError(
                f"SeriesResult.{field} missing — series_modeled_seconds "
                "needs a result from sim.simulator.run_series")
    f32 = torch.float32
    return model.step_seconds(
        torch.as_tensor(result.max_load, dtype=f32),
        torch.as_tensor(result.migrated_load, dtype=f32),
        torch.as_tensor(result.lb_fired, dtype=f32)).numpy()
