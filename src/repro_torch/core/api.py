"""Public API: the three-stage communication-aware diffusion balancer
(counterpart of ``repro.core.api``).  Planning lives in
:mod:`repro_torch.core.engine`; ``STRATEGIES`` is a mapping view over its
registry."""
from __future__ import annotations

from collections.abc import Mapping
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from repro_torch.core import comm_graph, engine, metrics


class LBPlan(NamedTuple):
    assignment: np.ndarray
    info: Dict


class _StrategyView(Mapping):
    """Dict view: name -> eager ``(problem, **kw) -> LBPlan``."""

    def __getitem__(self, name: str) -> Callable[..., LBPlan]:
        return engine.get_strategy(name).run

    def __iter__(self):
        return iter(engine.available())

    def __len__(self) -> int:
        return len(engine.available())


STRATEGIES: Mapping[str, Callable[..., LBPlan]] = _StrategyView()


def run_strategy(name: str, problem: comm_graph.LBProblem, **kw) -> LBPlan:
    plan = STRATEGIES[name](problem, **kw)
    plan.info.update(metrics.evaluate(
        problem, torch.as_tensor(plan.assignment, device=problem.device)))
    return plan
