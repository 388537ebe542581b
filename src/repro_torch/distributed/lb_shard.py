"""Mesh-sharded LB planner (counterpart of ``repro.distributed.lb_shard``).

The paper's balancer is distributed by construction: each of the P nodes
exchanges load only with its stage-1 neighbors.  Here the P balancer nodes
are row-sharded over the D shards of a ``distributed.mesh.ShardMesh`` (the
shards are the leading axis of (D, P/D) tensors on one device):

  * **stage 2 (virtual diffusion)** — the hot loop.  Per-node state
    (``x``, ``own``, the (P/D, K) flows) lives in the shard blocks; each
    sweep's neighbor loads and push-backs arrive by **ring halo
    exchanges** (:func:`_ring_gather_values`): the blocks rotate D-1 hops
    and every shard takes the entries its neighbor table points at as
    they pass.  The gathers copy values exactly, and each row's sums add
    in the order of the single-device chunk (:func:`_row_sum`), so every
    row is the single-device sweep's, bit for bit.
  * **stage 1 and 3** — the handshake, whose inputs and outputs every
    shard holds alike in the JAX package, runs once; its rows go to the
    shards.  The preference assembly and the selection's comm scores run
    once on the problem too.

Parity: every reduction that feeds a decision is taken on gathered
full-size values with the single-device expression (the loop scalars —
residual, movement, mean |x| — on the gathered (P,) loads), so a plan is
``LBEngine.plan_fn``'s bit for bit on the CPU, for the planner-only
:class:`ShardedLBEngine` as for the replays.  The JAX package completes
the planner-only engine's float reductions with ``psum`` instead (a
few-ulp contract on the flows); on the card that form gave plans other
than the single-device planner's in Fig 5 at 8 PEs, so the port does not
keep it.  On a card the rows add in K1's order and the three loop sums in
torch's, which K1 adds as a tree: they only gate the loop, and agree
unless a residual lies within an ulp of ``tol``.

``diff-comm-sharded`` / ``diff-coord-sharded`` are registered as
strategies on import.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import comm_graph, hierarchical
from repro_torch.core import engine as core_engine
from repro_torch.core import neighbor_selection as ns
from repro_torch.core import object_selection as osel
from repro_torch.core import virtual_lb as vlb
from repro_torch.distributed.mesh import ShardMesh, num_devices
from repro_torch.kernels import resolve_device


# ------------------------------------------------------- halo primitives --


def _row_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the single-device chunk's order: on a
    card K1's (``csrc/diffusion.cu``: k = 0, 1, ... one at a time), on the
    CPU the plain chunk's ``sum``, whose order depends on K but not on
    the leading axes."""
    if not t.is_cuda:
        return t.sum(-1)
    acc = t[..., 0]
    for k in range(1, t.shape[-1]):
        acc = acc + t[..., k]
    return acc


def _ring_gather_values(mesh: ShardMesh, vec_local, owner, idx_local):
    """``vec[global]`` from a row-sharded flat vector by the ring.

    ``vec_local`` is the (D, m) shard blocks; ``owner`` / ``idx_local``
    ((D, ...) integer) name the shard and in-shard position of every
    wanted entry.  The blocks rotate D-1 hops; each shard takes the
    entries it needs as the owning block passes.  Pure data movement."""
    D = mesh.num_shards
    shape = owner.shape
    owner = owner.reshape(D, -1)
    safe = idx_local.reshape(D, -1).clamp(0, vec_local.shape[1] - 1).long()
    me = torch.arange(D, device=owner.device)[:, None]
    out = torch.zeros(owner.shape, dtype=vec_local.dtype,
                      device=vec_local.device)
    buf = vec_local
    for s in range(D):
        out = torch.where(owner == (me + s) % D, buf.gather(1, safe), out)
        if s + 1 < D:
            buf = mesh.ring_shift(buf)   # now the next shard's block
    return out.reshape(shape)


def _sharded_sweep_fn(mesh: ShardMesh, rpd: int):
    """One diffusion sweep over the (D, rpd) row blocks — the sharded
    twin of ``virtual_lb.reference_sweep`` (neighbor loads and push-backs
    arrive by the ring).  Signature of ``sweep_chunk_body``'s sweep."""
    D = mesh.num_shards

    def sweep(x, own, nbr_idx, nbr_mask, rev, alpha, single_hop):
        safe_nbr = torch.where(nbr_mask, nbr_idx, 0)
        owner = torch.div(safe_nbr, rpd, rounding_mode="floor")
        xn = torch.where(
            nbr_mask,
            _ring_gather_values(mesh, x, owner, safe_nbr % rpd),
            x[..., None])
        push = torch.clamp(alpha * (x[..., None] - xn), min=0.0) * nbr_mask
        if single_hop:
            tot = _row_sum(push)
            scale = torch.where(
                tot > 0, torch.clamp(own / (tot + 1e-30), max=1.0), 1.0)
            push = push * scale[..., None]
        # recv[i, k]: what neighbor j pushed toward i — entry
        # [j % rpd, rev] of j's shard of the (P, K) push table
        K = nbr_idx.shape[-1]
        flat_local = (safe_nbr % rpd) * K + torch.where(nbr_mask, rev, 0)
        recv = torch.where(
            nbr_mask,
            _ring_gather_values(mesh, push.reshape(D, -1), owner,
                                flat_local),
            0.0)
        sent = _row_sum(push)
        return x - sent + _row_sum(recv), own - sent, push - recv

    return sweep


def _diffuse(x0, K: int, chunk_body, residual, *, n_sweeps: int,
             max_iters: int, tol: float):
    """The stage-2 fixed-point loop over the (D, rpd) row blocks: chunks
    of ``n_sweeps`` masked sweeps, one device read a chunk (as
    ``virtual_lb.virtual_balance``)."""
    D, rpd = x0.shape
    dev = x0.device
    carry = (x0, x0, torch.zeros((D, rpd, K), dtype=torch.float32,
                                 device=dev),
             torch.zeros((), dtype=torch.int32, device=dev), residual(x0),
             torch.zeros((), dtype=torch.int32, device=dev))
    while True:
        _, _, _, it, res, stall = carry
        if not bool((it < max_iters) & (res > tol) & (stall < 3)):
            break
        for _ in range(n_sweeps):
            carry = chunk_body(carry)
    return carry


def _alpha(K: int) -> float:
    """``virtual_balance``'s default step 1/(K+1), rounded to f32."""
    return float(torch.tensor(1.0 / (K + 1.0), dtype=torch.float32))


# ----------------------------------------------------------- plan body --


def _stats(nres, iters, res_fin, sres) -> core_engine.PlanStats:
    return core_engine.PlanStats(
        protocol_rounds=nres.rounds.to(torch.int32),
        mean_degree=nres.degree.to(torch.float32).mean(),
        diffusion_iters=iters.to(torch.int32),
        diffusion_residual=res_fin.to(torch.float32),
        unrealized_flow=sres.residual.abs().sum())


def plan_step_sharded(problem: comm_graph.LBProblem, *, mesh: ShardMesh,
                      variant: str, k: int, tol: float, max_iters: int,
                      max_rounds: int, single_hop: bool, sweep_chunk: int,
                      alive=None, speed=None):
    """One three-stage plan over the mesh (the JAX package's
    ``replay_shard._plan_step_sharded``; also ``ShardedLBEngine``'s).

    Stage 2 runs sharded over the (D, P/D) row blocks with the ring halo
    exchanges; stage 1, 3 and the handshake run once on the replicated
    problem with the single-device expressions.  The loop scalars
    (residual, movement, mean |x|) **gather then reduce**: the ring moved
    exact copies, so reducing the gathered (P,) vectors with the
    single-device expressions keeps every early-exit decision the
    single-device plan's (see the module docstring for the card).

    ``alive`` / ``speed`` are the (P,) node health of the resilient
    replays (``LBEngine.plan_health_fn``'s masks); None adds nothing."""
    from repro_torch.runtime import resilience   # runtime imports core

    if alive is not None:
        problem = resilience.degrade_problem(problem, alive, speed)
    D = mesh.num_shards
    P = problem.num_nodes
    rpd = P // D
    # -- stage 1: preference assembly and handshake (replicated) --------
    if variant == "comm":
        pref = ns.comm_preference(comm_graph.node_comm_matrix(problem))
    else:
        pref = ns.coordinate_preference(osel.centroids(
            problem.coords, problem.assignment, P))
    if alive is not None:
        pref = resilience.mask_preference(pref, alive)
    nres = ns.select_neighbors(pref, k=k, max_rounds=max_rounds)
    rev = vlb.reverse_slots(nres.nbr_idx, nres.nbr_mask)

    # -- stage 2: sharded virtual diffusion (the hot loop) --------------
    K = nres.nbr_idx.shape[1]
    x0 = comm_graph.node_loads(problem).to(torch.float32).reshape(D, rpd)
    gather = mesh.all_gather

    def residual(x_loc):
        return vlb.neighborhood_residual(gather(x_loc), nres.nbr_idx,
                                         nres.nbr_mask)

    body = vlb.sweep_chunk_body(
        _sharded_sweep_fn(mesh, rpd), nres.nbr_idx.reshape(D, rpd, K),
        nres.nbr_mask.reshape(D, rpd, K), rev.reshape(D, rpd, K),
        _alpha(K), single_hop, tol, max_iters, residual_fn=residual,
        sum_fn=lambda v: gather(v).sum(),
        mean_abs_fn=lambda x2: gather(x2).abs().mean())
    _x, _own, flows_loc, iters, res_fin, _stall = _diffuse(
        x0, K, body, residual, n_sweeps=max(1, min(sweep_chunk, max_iters)),
        max_iters=max_iters, tol=tol)

    # -- stage 3: selection on the gathered flows (replicated) ----------
    sres = osel.select_objects(problem, nres.nbr_idx, nres.nbr_mask,
                               gather(flows_loc), metric=variant)
    return sres.assignment.to(torch.int32), _stats(nres, iters, res_fin,
                                                   sres)


# -------------------------------------------------------------- engine --


class ShardedLBEngine:
    """The three-stage planner over a ``ShardMesh``.

    Mirrors ``LBEngine`` (``plan_fn``, ``plan``, ``threads_per_node`` with
    ``plan_hier_fn``) with the P balancer nodes sharded over the mesh;
    needs ``P % num_shards == 0``.  ``mesh`` or ``num_shards`` (on
    ``device``) picks the mesh; neither takes one shard a real device."""

    def __init__(self, *, mesh: Optional[ShardMesh] = None,
                 num_shards: Optional[int] = None, variant: str = "comm",
                 k: int = 4, tol: float = 0.02, max_iters: int = 512,
                 max_rounds: int = 64, single_hop: bool = True,
                 sweep_chunk: int = 8,
                 threads_per_node: Optional[int] = None, device="cuda"):
        if variant not in ("comm", "coord"):
            raise ValueError(f"unknown variant {variant!r}")
        if mesh is None:
            mesh = ShardMesh(num_devices(device) if num_shards is None
                             else num_shards, device)
        elif num_shards is not None:
            raise ValueError("pass either mesh or num_shards, not both")
        self.mesh = mesh
        self.num_shards = mesh.num_shards
        self.device = mesh.device
        self.variant = variant
        self.k = int(k)
        self.tol = float(tol)
        self.max_iters = int(max_iters)
        self.max_rounds = int(max_rounds)
        self.single_hop = bool(single_hop)
        self.sweep_chunk = int(sweep_chunk)
        self.threads_per_node = (None if threads_per_node is None
                                 else int(threads_per_node))

    def plan_fn(self, problem: comm_graph.LBProblem
                ) -> Tuple[torch.Tensor, core_engine.PlanStats]:
        """Sharded neighbor selection → diffusion → selection."""
        P, D = problem.num_nodes, self.num_shards
        if P % D:
            raise ValueError(
                f"num_nodes={P} must divide over the {D}-shard mesh")
        if self.variant == "coord" and problem.coords is None:
            raise ValueError("coordinate variant needs coords")
        if problem.device != self.device:
            problem = problem.to(self.device)
        return plan_step_sharded(
            problem, mesh=self.mesh, variant=self.variant, k=self.k,
            tol=self.tol, max_iters=self.max_iters,
            max_rounds=self.max_rounds, single_hop=self.single_hop,
            sweep_chunk=self.sweep_chunk)

    def plan_hier_fn(self, problem: comm_graph.LBProblem):
        """Sharded plan then the within-node LPT (``LBEngine.
        plan_hier_fn``'s contract)."""
        if not self.threads_per_node:
            raise ValueError(
                "plan_hier_fn needs threads_per_node configured")
        if problem.device != self.device:
            problem = problem.to(self.device)
        assignment, stats = self.plan_fn(problem)
        thread = hierarchical.lpt_threads(
            problem.loads, assignment, num_nodes=problem.num_nodes,
            threads_per_node=self.threads_per_node)
        return assignment, thread, stats

    def apply(self, owner_new, arrays, *, num_nodes: int,
              capacity: Optional[int] = None, on_overflow: str = "strict"):
        """Execute a plan over this engine's mesh:
        ``runtime.migrate.migrate_sharded``."""
        from repro_torch.runtime import migrate as rt_migrate

        return rt_migrate.migrate_sharded(
            owner_new, arrays, num_nodes=num_nodes, mesh=self.mesh,
            capacity=capacity, on_overflow=on_overflow)

    def plan(self, problem: comm_graph.LBProblem):
        """Eager plan with timing and the ``info`` dict (plus
        ``num_shards``; with ``threads_per_node``, ``thread``)."""
        name = f"diff-{self.variant}-sharded"
        params = dict(k=self.k, num_shards=self.num_shards)
        if not self.threads_per_node:
            return core_engine._timed_plan(self.plan_fn, problem, name,
                                           self.device, params)
        out = {}

        def fn(p):
            assignment, out["thread"], stats = self.plan_hier_fn(p)
            return assignment, stats

        plan = core_engine._timed_plan(fn, problem, name, self.device,
                                       params)
        plan.info.update(thread=out["thread"].cpu().numpy(),
                         threads_per_node=self.threads_per_node)
        return plan


# --------------------------------------------------------------- cache --


_SHARDED_CACHE: Dict[tuple, ShardedLBEngine] = {}
_SHARDED_CACHE_MAX = 16

_DEFAULTS = dict(num_shards=None, variant="comm", k=4, tol=0.02,
                 max_iters=512, max_rounds=64, single_hop=True,
                 sweep_chunk=8, threads_per_node=None, device="cuda")


def get_sharded_engine(*, mesh: Optional[ShardMesh] = None,
                       **cfg) -> ShardedLBEngine:
    """Sharded-engine cache, keyed canonically like
    ``engine.get_engine``; an explicit ``mesh`` builds uncached."""
    if mesh is not None:
        return ShardedLBEngine(mesh=mesh, **cfg)
    unknown = set(cfg) - set(_DEFAULTS)
    if unknown:
        raise TypeError(
            f"get_sharded_engine() got unexpected keyword arguments "
            f"{sorted(unknown)}")
    c = {**_DEFAULTS, **cfg}
    c["device"] = resolve_device(c["device"])
    key = (None if c["num_shards"] is None else int(c["num_shards"]),
           str(c["variant"]), int(c["k"]), float(c["tol"]),
           int(c["max_iters"]), int(c["max_rounds"]),
           bool(c["single_hop"]), int(c["sweep_chunk"]),
           None if c["threads_per_node"] is None
           else int(c["threads_per_node"]), str(c["device"]))
    eng = _SHARDED_CACHE.get(key)
    if eng is None:
        eng = _SHARDED_CACHE[key] = ShardedLBEngine(**c)
        while len(_SHARDED_CACHE) > _SHARDED_CACHE_MAX:  # drop the oldest
            _SHARDED_CACHE.pop(next(iter(_SHARDED_CACHE)))
    return eng


# ---------------------------------------------------------- strategies --


def best_shards(num_nodes: int, device="cuda") -> int:
    """The largest shard count up to the real devices (one here) that
    divides ``num_nodes``."""
    D = min(num_devices(device), int(num_nodes))
    while num_nodes % D:
        D -= 1
    return D


def _sharded_plan_fn(variant: str):
    def plan_fn(problem, **params):
        params.setdefault("num_shards",
                          best_shards(problem.num_nodes, problem.device))
        return get_sharded_engine(variant=variant, device=problem.device,
                                  **params).plan_fn(problem)
    return plan_fn


for _variant in ("comm", "coord"):
    core_engine.register(core_engine.Strategy(
        f"diff-{_variant}-sharded", _sharded_plan_fn(_variant),
        variant=_variant))
del _variant
