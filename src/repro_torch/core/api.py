"""Public API: the three-stage communication-aware diffusion balancer
(counterpart of ``repro.core.api``).

``diffusion_lb(problem)`` composes the stages of §III (plus the §IV
coordinate variant) and returns a new assignment with planning stats.
Planning lives in :mod:`repro_torch.core.engine`; ``STRATEGIES`` is a
mapping view over its registry."""
from __future__ import annotations

from collections.abc import Mapping
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import comm_graph, engine, metrics


class LBPlan(NamedTuple):
    assignment: np.ndarray
    info: Dict


def diffusion_lb(
    problem: comm_graph.LBProblem,
    *,
    k: int = 4,
    variant: str = "comm",          # "comm" (§III) | "coord" (§IV)
    tol: float = 0.02,
    max_iters: int = 512,
    max_rounds: int = 64,
    single_hop: bool = True,
    step_fn: Optional[Callable] = None,
    device="cuda",
) -> LBPlan:
    """Eager single-snapshot planning through the cached engine of
    ``device`` (the problem moves there first if it lives elsewhere)."""
    eng = engine.get_engine(
        variant=variant, k=k, tol=tol, max_iters=max_iters,
        max_rounds=max_rounds, single_hop=single_hop, step_fn=step_fn,
        device=device)
    return eng.plan(problem)


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
