"""LB engine: the three planning stages fused into one ``plan_fn``, plus the
Strategy registry (counterpart of ``repro.core.engine``).

``LBEngine`` holds the static configuration ``(variant, K, tol, iteration
caps, device)`` and exposes

  * ``plan_fn(problem) -> (assignment, PlanStats)`` — tensors stay on the
    engine's device; stage 2 runs ``kernels.diffusion.ops.
    diffusion_nsweeps`` (on a card the fused or the streaming CUDA kernel
    by ``sweep_impl``, on the CPU the plain chunk), or, with an explicit
    ``step_fn``, that sweep inside the plain chunk body;
  * ``plan_health_fn(problem, alive, speed)`` — the plan on a degraded
    mesh (dead nodes' objects re-homed, no flow toward them; the resilient
    replays take it); ``alive=None`` is ``plan_fn``;
  * ``plan(problem) -> LBPlan`` — eager convenience with timing and the
    ``info`` dict;
  * ``plan_batch_fn`` / ``plan_batch`` — one plan per problem of a batch
    (``comm_graph.stack_problems``);
  * with ``threads_per_node`` set, ``plan_hier_fn`` / ``plan_hier`` — the
    plan plus the within-node LPT thread of every object (paper §III.D,
    ``core.hierarchical``), and ``plan`` adds ``info["thread"]``.

The registry holds every strategy the JAX package registers: ``none``,
``diff-comm``, ``diff-coord`` and their ``+threshold`` / ``+predictive``
trigger-wrapped variants plan on the problem's device; ``greedy``,
``ep-greedy``, ``greedy-refine``, ``metis`` and ``parmetis`` are host
planners (``Strategy.host``, NumPy in ``core.baselines``) that read the
problem from its device once a plan and put the assignment back there.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import baselines, comm_graph, hierarchical
from repro_torch.core import neighbor_selection as ns
from repro_torch.core import object_selection as osel
from repro_torch.core import virtual_lb as vlb
from repro_torch.kernels import resolve_device
from repro_torch.kernels.diffusion import ops as diffusion_ops


class PlanStats(NamedTuple):
    """Planner statistics as 0-d tensors."""

    protocol_rounds: torch.Tensor     # i32 — stage-1 handshake rounds
    mean_degree: torch.Tensor         # f32 — mean confirmed neighbor count
    diffusion_iters: torch.Tensor     # i32 — stage-2 sweeps executed
    diffusion_residual: torch.Tensor  # f32 — final neighborhood imbalance
    unrealized_flow: torch.Tensor     # f32 — |wanted - shipped| load


def zero_stats(device) -> PlanStats:
    """Neutral PlanStats (the no-LB plan)."""
    i = torch.zeros((), dtype=torch.int32, device=device)
    f = torch.zeros((), dtype=torch.float32, device=device)
    return PlanStats(i, f, i, f, f)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class LBEngine:
    """Fused three-stage diffusion planner with static configuration."""

    def __init__(self, *, variant: str = "comm", k: int = 4,
                 tol: float = 0.02, max_iters: int = 512,
                 max_rounds: int = 64, single_hop: bool = True,
                 step_fn: Optional[Callable] = None, sweep_chunk: int = 8,
                 threads_per_node: Optional[int] = None, device="cuda"):
        if variant not in ("comm", "coord"):
            raise ValueError(f"unknown variant {variant!r}")
        self.variant = variant
        self.k = int(k)
        self.tol = float(tol)
        self.max_iters = int(max_iters)
        self.max_rounds = int(max_rounds)
        self.single_hop = bool(single_hop)
        self.step_fn = step_fn
        self.sweep_chunk = int(sweep_chunk)
        # optional stage 4 (paper §III.D): within-node LPT over T threads
        self.threads_per_node = (None if threads_per_node is None
                                 else int(threads_per_node))
        self.device = resolve_device(device)
        # production stage 2: the S-sweep chunk picked by sweep_impl; an
        # explicit step_fn opts out and runs per sweep inside the chunk
        self.chunk_fn = (diffusion_ops.diffusion_nsweeps
                         if step_fn is None else None)

    def plan_fn(self, problem: comm_graph.LBProblem
                ) -> Tuple[torch.Tensor, PlanStats]:
        """Neighbor selection → virtual balance → object selection."""
        return self._plan_stages(problem, None)

    def plan_health_fn(self, problem: comm_graph.LBProblem, alive,
                       speed=None) -> Tuple[torch.Tensor, PlanStats]:
        """Health-masked :meth:`plan_fn` for a degraded mesh.

        ``alive`` is a (P,) bool node mask, ``speed`` an optional (P,)
        f32 speed in (0, 1].  Dead nodes' objects are re-homed onto their
        strongest alive communication partner and slowed nodes' loads
        scaled by the reciprocal speed (``runtime.resilience.
        degrade_problem``), and the stage-1 preference rows and columns
        of dead nodes are zeroed, so no flow or object targets a dead
        node.  ``alive=None`` is exactly :meth:`plan_fn`."""
        if alive is None:
            return self._plan_stages(problem, None)
        from repro_torch.runtime import resilience  # runtime imports core

        if problem.device != self.device:
            problem = problem.to(self.device)
        problem = resilience.degrade_problem(problem, alive, speed)
        return self._plan_stages(problem, torch.as_tensor(
            alive, device=self.device).bool())

    def _plan_stages(self, problem: comm_graph.LBProblem, alive
                     ) -> Tuple[torch.Tensor, PlanStats]:
        """The three stages; ``alive=None`` adds no operation."""
        if problem.device != self.device:
            problem = problem.to(self.device)
        # stage 1: neighbor selection
        if self.variant == "comm":
            pref = ns.comm_preference(comm_graph.node_comm_matrix(problem))
        else:
            if problem.coords is None:
                raise ValueError("coordinate variant needs coords")
            pref = ns.coordinate_preference(osel.centroids(
                problem.coords, problem.assignment, problem.num_nodes))
        if alive is not None:
            # zeroed rows and columns drop dead nodes from the candidates
            pref = torch.where(alive[:, None] & alive[None, :], pref, 0.0)
        nres = ns.select_neighbors(pref, k=self.k,
                                   max_rounds=self.max_rounds)
        # stage 2: virtual load balancing
        vres = vlb.virtual_balance(
            comm_graph.node_loads(problem), nres.nbr_idx, nres.nbr_mask,
            tol=self.tol, max_iters=self.max_iters,
            single_hop=self.single_hop, step_fn=self.step_fn,
            sweep_chunk=self.sweep_chunk, chunk_fn=self.chunk_fn)
        # stage 3: object selection
        sres = osel.select_objects(problem, nres.nbr_idx, nres.nbr_mask,
                                   vres.flows, metric=self.variant)
        stats = PlanStats(
            protocol_rounds=nres.rounds.to(torch.int32),
            mean_degree=nres.degree.to(torch.float32).mean(),
            diffusion_iters=vres.iters.to(torch.int32),
            diffusion_residual=vres.residual.to(torch.float32),
            unrealized_flow=sres.residual.abs().sum(),
        )
        return sres.assignment, stats

    def plan(self, problem: comm_graph.LBProblem):
        """Eager plan with wall-clock timing and the ``info`` dict; with
        ``threads_per_node`` set, ``info`` also holds the two-level
        placement: ``thread`` ((N,) i32) and ``threads_per_node`` (object
        ``o`` runs on global PE ``assignment[o] * T + thread[o]``)."""
        if not self.threads_per_node:
            return _timed_plan(self.plan_fn, problem,
                               f"diff-{self.variant}", self.device,
                               dict(k=self.k))
        out = {}

        def fn(p):
            assignment, out["thread"], stats = self.plan_hier_fn(p)
            return assignment, stats

        plan = _timed_plan(fn, problem, f"diff-{self.variant}", self.device,
                           dict(k=self.k))
        plan.info.update(thread=out["thread"].cpu().numpy(),
                         threads_per_node=self.threads_per_node)
        return plan

    # ------------------------------------------------- hierarchical stage --

    def plan_hier_fn(self, problem: comm_graph.LBProblem
                     ) -> Tuple[torch.Tensor, torch.Tensor, PlanStats]:
        """Two-level placement: :meth:`plan_fn` then the within-node LPT
        (``hierarchical.lpt_threads``) on the planned assignment.  Returns
        ``(assignment (N,), thread (N,), stats)``; needs
        ``threads_per_node``."""
        if not self.threads_per_node:
            raise ValueError(
                "plan_hier_fn needs threads_per_node set on the engine "
                "(get_engine(..., threads_per_node=T))")
        if problem.device != self.device:
            problem = problem.to(self.device)
        assignment, stats = self.plan_fn(problem)
        thread = hierarchical.lpt_threads(
            problem.loads, assignment, num_nodes=problem.num_nodes,
            threads_per_node=self.threads_per_node)
        return assignment, thread, stats

    def plan_hier(self, problem: comm_graph.LBProblem):
        """Eager two-level plan: :meth:`plan` with ``info["thread"]``;
        needs ``threads_per_node``."""
        if not self.threads_per_node:
            raise ValueError(
                "plan_hier needs threads_per_node set on the engine "
                "(get_engine(..., threads_per_node=T))")
        return self.plan(problem)

    def plan_hier_batch_fn(self, problems: comm_graph.LBProblem
                           ) -> Tuple[torch.Tensor, torch.Tensor, PlanStats]:
        """:meth:`plan_hier_fn` over a stacked batch, the lanes one after
        another as in :meth:`plan_batch_fn`: ``(assignments (B, N),
        threads (B, N), PlanStats of (B,) tensors)``."""
        plans = [self.plan_hier_fn(comm_graph.lane(problems, b))
                 for b in range(problems.loads.shape[0])]
        assignments = torch.stack([a.to(torch.int32) for a, _, _ in plans])
        threads = torch.stack([t for _, t, _ in plans])
        stats = PlanStats(*(torch.stack(field)
                            for field in zip(*(s for _, _, s in plans))))
        return assignments, threads, stats

    # ------------------------------------------------------ batched path --

    def plan_batch_fn(self, problems: comm_graph.LBProblem
                      ) -> Tuple[torch.Tensor, PlanStats]:
        """:meth:`plan_fn` over a stacked batch (every tensor with a
        leading B axis, ``comm_graph.stack_problems``): ``(assignments
        (B, N), PlanStats of (B,) tensors)``.

        The JAX package vmaps the planner; its stages end on
        data-dependent loops that ``torch.vmap`` cannot trace, so the
        lanes are planned one after another on the device, each lane's
        padded edges masked as every consumer masks them (so a lane plans
        as its unpadded problem does)."""
        plans = [self.plan_fn(comm_graph.lane(problems, b))
                 for b in range(problems.loads.shape[0])]
        assignments = torch.stack([a.to(torch.int32) for a, _ in plans])
        stats = PlanStats(*(torch.stack(field)
                            for field in zip(*(s for _, s in plans))))
        return assignments, stats

    def plan_batch(self, problems):
        """Eager batched planning: a list of ``LBPlan``s, one a problem.

        Accepts a sequence of same-shaped ``LBProblem``s (stacked here) or
        an already-stacked batch; ``info["plan_seconds"]`` is the
        synchronized wall time of the whole batch."""
        from repro_torch.core.api import LBPlan  # local import: api imports us

        if not isinstance(problems, comm_graph.LBProblem):
            problems = comm_graph.stack_problems(problems)
        _sync(self.device)
        t0 = time.perf_counter()
        assignments, stats = self.plan_batch_fn(problems)
        assignments = assignments.cpu().numpy()   # waits for the device
        stats = PlanStats(*(f.cpu().numpy() for f in stats))
        dt = time.perf_counter() - t0
        B = assignments.shape[0]
        return [LBPlan(assignments[b], dict(
            strategy=f"diff-{self.variant}", k=self.k, batch_index=b,
            batch_size=B,
            protocol_rounds=int(stats.protocol_rounds[b]),
            mean_degree=float(stats.mean_degree[b]),
            diffusion_iters=int(stats.diffusion_iters[b]),
            diffusion_residual=float(stats.diffusion_residual[b]),
            unrealized_flow=float(stats.unrealized_flow[b]),
            plan_seconds=dt)) for b in range(B)]


def _timed_plan(plan_fn, problem, name: str, device, params: Dict):
    from repro_torch.core.api import LBPlan  # local import: api imports us

    _sync(device)
    t0 = time.perf_counter()
    assignment, stats = plan_fn(problem)
    assignment = assignment.cpu().numpy()        # waits for the device
    info = dict(strategy=name, **params)
    if name.startswith("diff"):
        info.update(
            protocol_rounds=int(stats.protocol_rounds),
            mean_degree=float(stats.mean_degree),
            diffusion_iters=int(stats.diffusion_iters),
            diffusion_residual=float(stats.diffusion_residual),
            unrealized_flow=float(stats.unrealized_flow))
    _sync(device)
    info["plan_seconds"] = time.perf_counter() - t0
    return LBPlan(assignment, info)


_ENGINE_CACHE: Dict[tuple, LBEngine] = {}
_ENGINE_CACHE_MAX = 64


def _engine_key(cfg: Dict) -> tuple:
    """Canonical hashable cache key: values coerced as ``LBEngine``
    coerces them, so positional and keyword spellings, and int and float
    spellings, of one configuration share an entry.  An unhashable
    ``step_fn`` is keyed by identity (the cached engine holds it, so the id
    stays valid while the entry lives)."""
    step_fn = cfg["step_fn"]
    try:
        hash(step_fn)
    except TypeError:
        step_fn = ("step_fn_id", id(step_fn))
    return (str(cfg["variant"]), int(cfg["k"]), float(cfg["tol"]),
            int(cfg["max_iters"]), int(cfg["max_rounds"]),
            bool(cfg["single_hop"]), step_fn, int(cfg["sweep_chunk"]),
            None if cfg["threads_per_node"] is None
            else int(cfg["threads_per_node"]), str(cfg["device"]))


def get_engine(variant: str = "comm", k: int = 4, tol: float = 0.02,
               max_iters: int = 512, max_rounds: int = 64,
               single_hop: bool = True, step_fn: Optional[Callable] = None,
               sweep_chunk: int = 8, threads_per_node: Optional[int] = None,
               device="cuda") -> LBEngine:
    """Engine cache — one engine per static configuration and device."""
    cfg = dict(variant=variant, k=k, tol=tol, max_iters=max_iters,
               max_rounds=max_rounds, single_hop=single_hop,
               step_fn=step_fn, sweep_chunk=sweep_chunk,
               threads_per_node=threads_per_node,
               device=resolve_device(device))
    key = _engine_key(cfg)
    eng = _ENGINE_CACHE.get(key)
    if eng is None:
        eng = _ENGINE_CACHE[key] = LBEngine(**cfg)
        while len(_ENGINE_CACHE) > _ENGINE_CACHE_MAX:  # drop oldest entry
            _ENGINE_CACHE.pop(next(iter(_ENGINE_CACHE)))
    return eng


# ------------------------------------------------------ Strategy protocol --


@dataclasses.dataclass(frozen=True)
class Strategy:
    """A registered load-balancing strategy.

    ``plan_fn(problem, **params) -> (assignment, PlanStats)`` returns
    tensors on the problem's device.  ``host`` marks a planner that runs
    NumPy on the host (the JAX package's strategies that are not
    ``jittable``): the device-resident replay loops and the batched
    replay refuse it.  ``defaults`` are merged under caller params.
    ``trigger`` names the strategy's default rebalancing policy
    (``runtime.triggers``); ``variant`` the diffusion variant behind a
    diff-* strategy (None for ``none``)."""

    name: str
    plan_fn: Callable[..., Tuple[torch.Tensor, PlanStats]]
    host: bool = False
    defaults: Mapping = dataclasses.field(default_factory=dict)
    trigger: Optional[str] = None
    variant: Optional[str] = None

    def params(self, **overrides) -> Dict:
        return {**self.defaults, **overrides}

    def bind(self, **overrides) -> Callable:
        """Closure ``problem -> (assignment, PlanStats)``."""
        p = self.params(**overrides)
        return lambda problem: self.plan_fn(problem, **p)

    def run(self, problem: comm_graph.LBProblem, **overrides):
        """Eager execution returning an ``LBPlan`` (timed to completion)."""
        params = self.params(**overrides)
        return _timed_plan(
            lambda p: self.plan_fn(p, **params), problem, self.name,
            problem.device,
            {k: v for k, v in params.items()
             if isinstance(v, (int, float, bool, str))})


_REGISTRY: Dict[str, Strategy] = {}


def register(strategy: Strategy) -> Strategy:
    _REGISTRY[strategy.name] = strategy
    return strategy


def get_strategy(name: str) -> Strategy:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown strategy {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def available() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _diffusion_plan_fn(variant: str):
    def plan_fn(problem, **params):
        return get_engine(variant=variant, device=problem.device,
                          **params).plan_fn(problem)
    return plan_fn


def _none_plan_fn(problem):
    return problem.assignment.to(torch.int32), zero_stats(problem.device)


def _host(fn):
    """Wrap a NumPy baseline as a Strategy plan_fn: the assignment goes
    back to the problem's device as int32."""
    def plan_fn(problem, **params):
        a = np.asarray(fn(problem, **params), np.int32)
        return (torch.as_tensor(a, device=problem.device),
                zero_stats(problem.device))
    return plan_fn


register(Strategy("none", _none_plan_fn))
register(Strategy("greedy", _host(baselines.greedy), host=True))
register(Strategy("ep-greedy", _host(baselines.greedy_capped), host=True,
                  defaults=dict(cap=0)))
register(Strategy("greedy-refine", _host(baselines.greedy_refine),
                  host=True))
register(Strategy("metis", _host(baselines.metis_like), host=True))
register(Strategy("parmetis", _host(baselines.parmetis_like), host=True))
for _variant in ("comm", "coord"):
    register(Strategy(f"diff-{_variant}", _diffusion_plan_fn(_variant),
                      variant=_variant))
    for _trig in ("threshold", "predictive"):
        register(Strategy(f"diff-{_variant}+{_trig}",
                          _diffusion_plan_fn(_variant), trigger=_trig,
                          variant=_variant))
del _variant, _trig
