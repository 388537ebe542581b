"""Live MoE expert rebalancing (counterpart of ``repro.train.ep_runtime``).

Router statistics accumulate on the device, the runtime triggers decide
*when* to replace the expert placement, the Strategy registry plans
*where* every expert goes, and the placement delta executes as an
expert-weight exchange whose executed bytes feed the predictive gate.
Objects are experts, loads EMA routed tokens, edges co-activations, nodes
EP ranks, and migration is expert-weight traffic.  Three layers:

  * :func:`run_ep_replay` — the replay driver: a :class:`RoutingWorkload`
    (or a recorded :class:`RoutingTrace`) gives each step's (T, k) routed
    ids; the EMA token and co-activation statistics are fixed-shape
    tensors on the device, updated from the ids by ``models.moe.
    pair_stats``; the trigger reads the expert-load skew
    (``runtime.triggers.load_stats``); a fired step plans through the
    registered strategy and :func:`ep_balance.repair_capacity`, and
    executes the placement over the expert slabs with
    ``runtime.migrate.build_and_apply`` (K3 where the scatter is picked).
    Two loops share one set of step pieces (:func:`_make_parts`), as in
    ``serve/replay.py``: the **device-resident** loop (``scan=True``, the
    default for a device planner) keeps the records on the device until
    the end and reads one scalar a step, the trigger's decision (none for
    the fixed ``every`` cadence), plus the planner's loop flags on fired
    steps; the **host loop** (``scan=False``, the default for a host
    planner such as ``ep-greedy``) reads each step's records.  Both give
    equal fire steps, placements, slot layouts and moved bytes.
    ``num_shards``/``mesh`` run each fired exchange as a ring all-to-all
    over a ``distributed.mesh.ShardMesh`` (``migrate.migrate_sharded``,
    strict mode, ``E // D`` slots a shard), bit for bit the single-device
    trajectory.
  * :func:`execute_placement` — relocates real MoE parameters (``wi``/
    ``wg``/``wo`` on the expert axis, ``router`` on its column axis) by
    the manifest permutation, or over a mesh as the ring exchange of
    slot-leading slabs; returns the executed moved-byte count.
  * :class:`EPRebalancer` — the train-loop driver: it takes the router's
    physical-slot statistics, converts them to logical-expert statistics
    through the tracked ``slot_expert`` permutation, and on a fired step
    plans, repairs and executes, feeding the trigger the bytes moved.

Float order: every float that feeds a decision has the JAX package's CPU
bits on every device.  The EMA update ``ema * x + (1 - ema) * s`` is what
XLA's CPU jit makes of it, a fused multiply-add ``fma(ema, x, (1 - ema)
* s)`` (:func:`ema_update`); the counts and co-activations are integers
held in f32 (exact with TF32 off); the load sums add in XLA's order
(``comm_graph.segment_sum`` / ``ordered_sum``).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import comm_graph, engine
from repro_torch.distributed import ep_balance
from repro_torch.kernels import resolve_device
from repro_torch.models import moe as moe_mod
from repro_torch.obs import telemetry as obs_telemetry
from repro_torch.runtime import migrate as rt_migrate
from repro_torch.runtime import triggers as rt_triggers

LOAD_FLOOR = 1e-3


# ------------------------------------------------------------- workloads --


@dataclasses.dataclass(frozen=True)
class RoutingWorkload:
    """Synthetic skewed top-k routing traffic (a pure function of t).

    Expert popularity is Zipf-like (``(rank+1)^-alpha`` over a random
    expert order) with a rotating hotspot: every ``drift_period`` steps the
    hot block of ``hot_frac·E`` experts advances, and hot experts'
    popularity multiplies by ``1 + hot_amp``.  ``trace_len`` steps of (T,
    k) routed ids are drawn once per instance with NumPy (as the JAX
    package draws them, so the ids are equal) and loop past the end."""

    num_experts: int = 64
    num_ranks: int = 8
    top_k: int = 4
    tokens_per_step: int = 2048
    alpha: float = 1.0
    hot_frac: float = 0.25
    hot_amp: float = 4.0
    drift_period: int = 16
    trace_len: int = 64
    weight_bytes: float = 2048.0   # per-expert weight size (exchange unit)
    seed: int = 0

    def ids_table(self) -> np.ndarray:
        """(trace_len, T, k) i32 routed expert ids."""
        return _routing_tables(self)

    def table_on(self, device) -> torch.Tensor:
        """The id table on ``device``, copied there once."""
        return _device_table(self, str(resolve_device(device)))

    def ids_at(self, t: int, device="cuda") -> torch.Tensor:
        tab = self.table_on(device)
        return tab[int(t) % tab.shape[0]]


@functools.lru_cache(maxsize=64)
def _routing_tables(w: RoutingWorkload) -> np.ndarray:
    """Draw the recorded routing trace (NumPy, cached)."""
    rng = np.random.default_rng(w.seed)
    E, T, k = w.num_experts, w.tokens_per_step, w.top_k
    base = (np.argsort(rng.permutation(E)) + 1.0) ** (-w.alpha)
    hot_n = max(1, int(round(w.hot_frac * E)))
    ids = np.empty((w.trace_len, T, k), np.int32)
    for t in range(w.trace_len):
        epoch = t // max(1, w.drift_period)
        hot = (np.arange(hot_n) + epoch * hot_n) % E
        p = base.copy()
        p[hot] *= 1.0 + w.hot_amp
        p /= p.sum()
        ids[t] = rng.choice(E, size=(T, k), p=p)
    return ids


@functools.lru_cache(maxsize=64)
def _device_table(w: RoutingWorkload, device: str) -> torch.Tensor:
    return torch.as_tensor(_routing_tables(w), device=device)


@dataclasses.dataclass(frozen=True, eq=False)
class RoutingTrace:
    """Trace-driven routing workload: a recorded ``(L, T, k)`` id table
    (it loops past its length)."""

    table: torch.Tensor           # (L, T, k) i32 routed ids
    num_experts: int
    num_ranks: int = 8
    weight_bytes: float = 2048.0

    @property
    def top_k(self) -> int:
        return int(self.table.shape[2])

    @property
    def tokens_per_step(self) -> int:
        return int(self.table.shape[1])

    def table_on(self, device) -> torch.Tensor:
        return self.table.to(resolve_device(device))

    def ids_at(self, t: int, device="cuda") -> torch.Tensor:
        tab = self.table_on(device)
        return tab[int(t) % tab.shape[0]]


def record_routing(workload, *, steps: int, device="cuda") -> RoutingTrace:
    """Capture ``steps`` routing steps into a :class:`RoutingTrace` on
    ``device`` (the ``routing-skew`` scenario's source)."""
    tab = workload.table_on(device)
    rows = tab[torch.arange(steps, device=tab.device) % tab.shape[0]]
    return RoutingTrace(
        table=rows.to(torch.int32).contiguous(),
        num_experts=int(workload.num_experts),
        num_ranks=int(workload.num_ranks),
        weight_bytes=float(workload.weight_bytes))


# --------------------------------------------------------------- results --


@dataclasses.dataclass
class EPReplayResult:
    """Per-step records and the final placement of one rebalancing
    replay."""

    max_avg: np.ndarray           # (T,) post-LB expert-load imbalance
    lb_fired: np.ndarray          # (T,) 0/1 trigger decisions
    moved_experts: np.ndarray     # (T,) experts exchanged at that step
    moved_bytes: np.ndarray       # (T,) executed weight transfer volume
    final_placement: np.ndarray   # (E,) logical expert → rank
    final_slot_expert: np.ndarray  # (E,) physical slot → logical expert
    final_wsig: np.ndarray        # (E, d) relocated payload signature
    scanned: bool = False         # True for the device-resident loop
    sharded: bool = False
    wall_seconds: float = 0.0     # synchronized wall time of the step loop
    # StepRecord ring snapshot when an enabled telemetry config was passed
    telemetry: Optional[obs_telemetry.TelemetrySnapshot] = None

    @property
    def total_moved_bytes(self) -> float:
        return float(self.moved_bytes.sum())


# ------------------------------------------------------------- step body --


def ema_update(ema: float, old: torch.Tensor,
               new: torch.Tensor) -> torch.Tensor:
    """``ema * old + (1 - ema) * new`` in f32 with the JAX package's CPU
    bits: XLA contracts the first product into a fused multiply-add,
    ``fma(ema, old, round((1 - ema) * new))``.  The fma is computed
    exactly on every device: the f32 product is exact in f64, the f64 sum
    is rounded to odd (its TwoSum error decides the last bit), and the
    final rounding to f32 is then the single correct rounding."""
    a = torch.full((), ema, dtype=torch.float32, device=old.device)
    g = torch.full((), 1.0 - ema, dtype=torch.float32, device=old.device)
    c = (g * new.to(torch.float32)).double()
    p = a.double() * old.double()                        # exact
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)                      # TwoSum: exact
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _sig0(E: int, d: int = 4, device="cuda") -> torch.Tensor:
    """Deterministic (E, d) payload signature: a stand-in expert-weight
    slab that makes relocation observable (each row survives every
    exchange exactly)."""
    dev = resolve_device(device)
    return (torch.arange(E, dtype=torch.float32, device=dev)[:, None] * d
            + torch.arange(d, dtype=torch.float32, device=dev)[None, :])


def _edge_template(E: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static all-upper-triangle edge list and ring mask: every expert pair
    is an edge (fixed shapes), weighted from the live co-activation matrix
    with a 1e-3 floor on the ring pairs (i, i+1), (0, E-1) that keeps the
    graph connected before any co-activation accumulates."""
    iu, ju = np.triu_indices(E, k=1)
    ring = (ju == iu + 1) | ((iu == 0) & (ju == E - 1))
    return iu.astype(np.int32), ju.astype(np.int32), ring


def _make_parts(workload, trig, plan, R: int, E: int, lb_on: bool,
                bytes_per_load: float, ema: float, dev, strategy: str,
                kw: Dict, mesh=None):
    """The step pieces both loops run.

    ``pre`` accumulates the routing statistics and decides; ``fire``
    plans a fired step (``plan_placement``: the device planner, or the
    host planner through ``ep_balance.plan_placement`` when ``plan`` is
    None) and executes the exchange (over ``mesh`` as a ring all-to-all
    when one is given); ``post`` observes the executed bytes and gives the
    step's max/avg."""
    cap = E // R
    table = workload.table_on(dev)
    L = int(table.shape[0])
    iu, ju, ring = _edge_template(E)
    iu_t = torch.as_tensor(iu, device=dev)
    ju_t = torch.as_tensor(ju, device=dev)
    iu_l, ju_l = iu_t.long(), ju_t.long()
    ring_t = torch.as_tensor(ring, dtype=torch.float32, device=dev)
    floor = torch.full((), LOAD_FLOOR, dtype=torch.float32, device=dev)
    bpe = torch.full((), float(workload.weight_bytes), dtype=torch.float32,
                     device=dev)
    bpl = torch.full((), float(bytes_per_load), dtype=torch.float32,
                     device=dev)
    is_every = isinstance(trig, rt_triggers.EveryTrigger)

    def pre(tokens, coact, placement, tstate, t: int):
        st = moe_mod.pair_stats(table[t % L], E)
        tokens = ema_update(ema, tokens, st.counts)
        coact = ema_update(ema, coact, st.coact)
        if not lb_on:
            return tokens, coact, False, tstate
        if is_every:            # the fixed cadence ignores the load stats
            return tokens, coact, t > 0 and t % trig.every == 0, tstate
        mx, av, tot = rt_triggers.load_stats(
            torch.clamp(tokens, min=LOAD_FLOOR), placement, R)
        do, tstate = trig.decide(tstate, t, mx, av, tot)
        return tokens, coact, do, tstate

    def plan_placement(placement, tokens, coact):
        """Capacity-exact new logical placement of a fired step and the
        planner's executed diffusion sweeps."""
        if plan is None:                      # host planner (ep-greedy, ...)
            stats = ep_balance.ExpertStats(
                num_experts=E, ema=0.0,
                tokens=tokens.cpu().numpy().astype(np.float64),
                coact=coact.cpu().numpy().astype(np.float64))
            new, _ = ep_balance.plan_placement(
                stats, placement.cpu().numpy(), R, strategy=strategy,
                device=dev, **({"k": kw["k"]} if "k" in kw else {}))
            return (torch.as_tensor(new, device=dev),
                    torch.zeros((), dtype=torch.float32, device=dev))
        problem = comm_graph.LBProblem(
            loads=torch.clamp(tokens, min=LOAD_FLOOR),
            assignment=placement, edges_src=iu_t, edges_dst=ju_t,
            edges_bytes=coact[iu_l, ju_l] + floor * ring_t, num_nodes=R)
        new, stats = plan(problem)
        newp = ep_balance.repair_capacity(new.to(torch.int32), tokens,
                                          num_ranks=R, cap=cap)
        return newp, stats.diffusion_iters.to(torch.float32)

    def fire(se, ws, placement, tokens, coact):
        newp, sweeps = plan_placement(placement, tokens, coact)
        oo = placement[se.long()]                 # == slot // cap
        on = newp[se.long()]
        if mesh is None:
            (se2, ws2), man = rt_migrate.build_and_apply(
                oo, on, (se, ws), num_nodes=R)
            moved_n = man.moved_count.to(torch.float32)
            return se2, ws2, newp, moved_n, man.moved_bytes(bpe), sweeps
        moved_n = (on != oo).sum().to(torch.float32)
        D = mesh.num_shards
        _, (se2, ws2), counts = rt_migrate.migrate_sharded(
            on, (se, ws), num_nodes=R, mesh=mesh, capacity=E // D)
        if not bool((counts == E // D).all()):
            raise ValueError(
                "a capacity-exact placement must fill every shard slab")
        return se2, ws2, newp, moved_n, moved_n * bpe, sweeps

    def post(placement, tokens, tstate, do, moved_b):
        if lb_on and not is_every:
            tstate = trig.observe(tstate, moved_b / bpl, do)
        mx, av, _ = rt_triggers.load_stats(
            torch.clamp(tokens, min=LOAD_FLOOR), placement, R)
        return tstate, mx / av

    return pre, fire, post


def _initial_state(workload, dev):
    E = int(workload.num_experts)
    R = int(workload.num_ranks)
    cap = E // R
    slot_expert = torch.arange(E, dtype=torch.int32, device=dev)
    placement = torch.div(slot_expert, cap,
                          rounding_mode="floor").to(torch.int32)
    tokens = torch.zeros((E,), dtype=torch.float32, device=dev)
    coact = torch.zeros((E, E), dtype=torch.float32, device=dev)
    return slot_expert, _sig0(E, device=dev), placement, tokens, coact


def _resolve(workload, strategy, strategy_kwargs, trigger, lb_every):
    strat = engine.get_strategy(ep_balance._ALIASES.get(strategy, strategy))
    kw = dict(strategy_kwargs or {})
    if strat.variant is not None:
        kw.setdefault("k", max(1, min(4, int(workload.num_ranks) - 1)))
    trig = rt_triggers.resolve_for_strategy(
        trigger, lb_every=lb_every, strategy=strategy)
    cost = getattr(trig, "cost", None)
    bpl = float(cost.bytes_per_load) if cost is not None else 1.0
    lb_on = strategy != "none" and not trig.never
    return strat, kw, trig, bpl, lb_on


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _loop(workload, steps, strategy, strat, kw, trig, bpl, lb_on, ema, dev,
          tel, device_resident: bool, mesh=None):
    """One replay; ``device_resident`` keeps the records on the device
    until the end, else each step's records are read to the host."""
    E, R = int(workload.num_experts), int(workload.num_ranks)
    plan = None if strat.host else strat.bind(**kw)
    pre, fire, post = _make_parts(workload, trig, plan, R, E, lb_on, bpl,
                                  ema, dev, strategy, kw, mesh)
    se, ws, placement, tokens, coact = _initial_state(workload, dev)
    tstate = trig.init_state(dev)
    obs_state = obs_telemetry.init_state(tel, R, dev) if tel else None
    tkind = obs_telemetry.trigger_kind(trig) if tel else 0
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    rows = []
    for t in range(steps):
        tokens, coact, do, tstate = pre(tokens, coact, placement, tstate, t)
        fired = bool(do)                 # the step's one device read
        moved_n = moved_b = sweeps = zero
        if fired:
            se, ws, placement, moved_n, moved_b, sweeps = fire(
                se, ws, placement, tokens, coact)
        tstate, ma = post(placement, tokens, tstate, do, moved_b)
        if tel:
            obs_state = obs_telemetry.record(
                obs_state, tel, t=t,
                node_loads=obs_telemetry.node_loads(
                    torch.clamp(tokens, min=LOAD_FLOOR), placement, R),
                fired=float(fired), trigger_kind=tkind, sweeps=sweeps,
                moved_items=moved_n, moved_bytes=moved_b)
        row = torch.stack([ma, one if fired else zero, moved_n, moved_b])
        rows.append(row if device_resident
                    else row.cpu().numpy().astype(np.float64))
    if device_resident:
        recs = (torch.stack(rows).cpu().numpy().astype(np.float64) if rows
                else np.zeros((0, 4)))
    else:
        recs = np.asarray(rows, np.float64).reshape(steps, 4)
    return se, ws, placement, recs, obs_state


# ------------------------------------------------------------- the entry --


def run_ep_replay(
    workload,
    *,
    steps: int,
    strategy: str = "diff-comm",
    strategy_kwargs: Optional[Dict] = None,
    trigger=None,
    lb_every: int = 10,
    ema: float = 0.9,
    scan: Optional[bool] = None,
    num_shards: Optional[int] = None,
    mesh=None,
    telemetry=None,
    device="cuda",
) -> EPReplayResult:
    """Replay ``steps`` training steps of live expert rebalancing on
    ``device`` (the card unless the caller asks for the CPU).

    ``scan=None`` takes the device-resident loop for a device planner and
    the host loop for a host planner (``greedy``/``ep-greedy`` & co);
    ``scan=True`` with a host planner raises ``ValueError``.  ``trigger``
    resolves through ``runtime.triggers.resolve_for_strategy``: the
    predictive policy amortizes fires against the executed weight bytes of
    the previous exchange.  ``num_shards``/``mesh`` execute the fired
    exchanges as ring all-to-alls over a ``ShardMesh`` (bit for bit the
    single-device trajectory; ``E`` and ``num_ranks`` must divide the
    shard count) in the host loop; ``scan=True`` with them raises.
    ``telemetry`` records the StepRecord ring (``off``/None add
    nothing)."""
    dev = resolve_device(device)
    strat, kw, trig, bpl, lb_on = _resolve(
        workload, strategy, strategy_kwargs, trigger, lb_every)
    tel = obs_telemetry.enabled_or_none(telemetry)
    E, R = int(workload.num_experts), int(workload.num_ranks)
    if E % R:
        raise ValueError(f"num_experts={E} must divide num_ranks={R}")
    sharded = mesh is not None or num_shards is not None
    if sharded:
        if scan:
            raise ValueError(
                "the sharded rebalancing replay is a host-driven loop; "
                "pass scan=False/None")
        from repro_torch.distributed.mesh import resolve_mesh

        mesh = resolve_mesh(mesh, num_shards, (E, R), dev)
        scan = False
    if scan and strat.host:
        raise ValueError(
            f"strategy {strategy!r} is not jittable: it plans on the host; "
            "the device-resident replay needs a device plan_fn (use "
            "scan=False or a diff-* strategy)")
    if scan is None:
        scan = not strat.host
    _sync(dev)
    t0 = time.perf_counter()
    se, ws, placement, recs, obs_state = _loop(
        workload, int(steps), strategy, strat, kw, trig, bpl, lb_on,
        float(ema), dev, tel, bool(scan), mesh)
    final_se = se.cpu().numpy().astype(np.int32)
    final_ws = ws.cpu().numpy().astype(np.float32)
    final_p = placement.cpu().numpy().astype(np.int32)
    wall = time.perf_counter() - t0
    return EPReplayResult(
        max_avg=recs[:, 0], lb_fired=recs[:, 1], moved_experts=recs[:, 2],
        moved_bytes=recs[:, 3], final_placement=final_p,
        final_slot_expert=final_se, final_wsig=final_ws,
        scanned=bool(scan), sharded=sharded, wall_seconds=wall,
        telemetry=(obs_telemetry.snapshot(obs_state, tel) if tel else None))


# ------------------------------------------- real-weight execution layer --


#: the per-expert-slot tensors of a MoE layer; everything else in the
#: parameter dict (shared-expert weights) has no expert axis and rides no
#: exchange
EXPERT_KEYS = ("wi", "wg", "wo", "router")


def _expert_axis(key: str, ndim: int) -> int:
    """Expert axis of a per-expert MoE parameter, layout-agnostic:
    ``wi``/``wg``/``wo`` are (..., E, D, F), the ``router`` (..., D, E)."""
    return ndim - 1 if key == "router" else ndim - 3


def _expert_items(moe_params: Dict):
    for k in EXPERT_KEYS:
        if k in moe_params:
            yield k, moe_params[k]


def apply_order_to_moe(moe_params: Dict, order, *,
                       in_place: bool = False) -> Dict:
    """Gather every per-slot tensor of one MoE layer by the manifest
    permutation (slot ``p`` of the relocated layout holds old slot
    ``order[p]``); non-expert tensors pass through.

    ``in_place`` relocates each tensor in its own storage and returns the
    given dict: the permutation's cycles are followed slot by slot (one
    slot copied out a cycle, every other moved slot copied once from the
    slot it takes), so the traffic is about twice the moved bytes and the
    extra memory one slot; the full gather reads and writes every slot
    into a new tensor."""
    if not in_place:
        out = dict(moe_params)
        for k, v in list(_expert_items(moe_params)):
            out[k] = v.index_select(_expert_axis(k, v.ndim), torch.as_tensor(
                order, device=v.device).long())
        return out
    cycles = _cycles(torch.as_tensor(order).cpu().numpy())
    for k, v in list(_expert_items(moe_params)):
        ax = _expert_axis(k, v.ndim)
        for cyc in cycles:
            first = v.select(ax, cyc[0]).clone()
            for p, q in zip(cyc, cyc[1:]):
                v.select(ax, p).copy_(v.select(ax, q))
            v.select(ax, cyc[-1]).copy_(first)
    return moe_params


def _cycles(order: np.ndarray) -> list:
    """The cycles of length > 1 of the gather permutation ``order``, each
    ``[p, order[p], order[order[p]], ...]``."""
    seen = np.zeros(order.shape[0], bool)
    out = []
    for p0 in np.flatnonzero(order != np.arange(order.shape[0])):
        if seen[p0]:
            continue
        cyc, p = [], int(p0)
        while not seen[p]:
            seen[p] = True
            cyc.append(p)
            p = int(order[p])
        out.append(cyc)
    return out


def expert_param_bytes(moe_layers: Sequence[Dict]) -> float:
    """Weight bytes resident per expert slot, summed over MoE layers — the
    unit :func:`execute_placement` reports moved volume in."""
    total = 0.0
    for layer in moe_layers:
        for k, v in _expert_items(layer):
            E = v.shape[_expert_axis(k, v.ndim)]
            total += v.numel() * v.element_size() / float(E)
    return total


def execute_placement(moe_layers: Sequence[Dict], slot_expert,
                      new_placement, *, num_ranks: int, mesh=None,
                      device="cuda", in_place: bool = False):
    """Relocate real expert weights to a new logical placement on
    ``device`` (every expert tensor must lie there).

    ``moe_layers`` are the MoE parameter dicts sharing one placement;
    ``slot_expert`` maps physical slot → logical expert and
    ``new_placement`` logical expert → rank (capacity-exact).  On one
    device the relocation is the manifest gather (K3 builds the manifest
    where ``preferred_method`` picks the scatter; ``in_place`` moves the
    slots within each tensor's own storage, see :func:`apply_order_to_moe`);
    with ``mesh`` it runs as the ring all-to-all of
    ``migrate.migrate_sharded`` over each tensor flattened to a
    slot-leading (E, -1) slab, which the strict layout contract and
    capacity-exactness reassemble into the single-device layout bit for
    bit.

    Returns ``(new_layers, new_slot_expert, moved_experts, moved_bytes)``:
    the executed exchange volume (moved slots × resident bytes a slot)."""
    dev = resolve_device(device) if mesh is None else mesh.device
    for layer in moe_layers:
        for k, v in _expert_items(layer):
            if v.device != dev:
                raise ValueError(f"expert tensor {k!r} lies on {v.device}; "
                                 f"execute_placement runs on {dev}")
    slot_expert = torch.as_tensor(slot_expert, device=dev).to(torch.int32)
    E = int(slot_expert.shape[0])
    R = int(num_ranks)
    cap = E // R
    oo = torch.div(torch.arange(E, dtype=torch.int32, device=dev), cap,
                   rounding_mode="floor").to(torch.int32)
    on = torch.as_tensor(new_placement, device=dev).to(
        torch.int32)[slot_expert.long()]
    bpe = expert_param_bytes(moe_layers)
    if mesh is None:
        man = rt_migrate.build_manifest(oo, on, R)
        new_layers = [apply_order_to_moe(layer, man.order,
                                         in_place=in_place)
                      for layer in moe_layers]
        se2 = slot_expert[man.order.long()]
        moved = int(man.moved_count)
        return new_layers, se2, moved, moved * bpe
    D = mesh.num_shards
    if E % D or R % D:
        raise ValueError(
            f"E={E} and num_ranks={R} must divide the {D}-shard mesh")
    # every per-expert tensor as a slot-leading (E, -1) slab; trailing axes
    # ride the exchange unchanged; shared-expert tensors stay put
    keys = [[k for k, _ in _expert_items(layer)] for layer in moe_layers]
    slabs, shapes = [], []
    for layer, ks in zip(moe_layers, keys):
        for k in ks:
            v = layer[k]
            ax = _expert_axis(k, v.ndim)
            lead = torch.movedim(v, ax, 0)
            slabs.append(lead.reshape(E, -1))
            shapes.append((ax, tuple(lead.shape)))
    _, outs, counts = rt_migrate.migrate_sharded(
        on, (slot_expert,) + tuple(slabs), num_nodes=R, mesh=mesh,
        capacity=E // D)
    if not bool((counts == E // D).all()):
        raise ValueError(
            "a capacity-exact placement must fill every shard slab")
    se2 = outs[0].to(torch.int32)
    new_layers, i = [], 1
    for layer, ks in zip(moe_layers, keys):
        out = dict(layer)
        for k in ks:
            ax, lead_shape = shapes[i - 1]
            out[k] = torch.movedim(outs[i].reshape(lead_shape), 0,
                                   ax).contiguous()
            i += 1
        new_layers.append(out)
    moved = int((on != oo).sum())
    return new_layers, se2, moved, moved * bpe


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class EPRebalancer:
    """Trigger-driven live rebalancer for the training loop, on
    ``device``.

    :meth:`step` takes the router's ``counts``/``coact`` statistics
    (``collect_router_stats=True``), keyed by **physical slot**; they are
    converted to logical-expert statistics through the tracked
    ``slot_expert`` permutation and fed to the EMA
    :class:`ep_balance.ExpertStats`; the trigger reads the rank-load skew,
    and a fired step plans through :func:`ep_balance.plan_placement` and
    executes the delta with :func:`execute_placement`, observing the bytes
    it moved."""

    def __init__(self, num_experts: int, num_ranks: int, *,
                 strategy: str = "diff-comm", trigger=None,
                 lb_every: int = 50, ema: float = 0.9, device="cuda"):
        E, R = int(num_experts), int(num_ranks)
        assert E % R == 0
        self.num_experts, self.num_ranks = E, R
        self.strategy = strategy
        self.device = resolve_device(device)
        self.stats = ep_balance.ExpertStats(num_experts=E, ema=ema)
        self.trig = rt_triggers.resolve_for_strategy(
            trigger, lb_every=lb_every, strategy=strategy)
        cost = getattr(self.trig, "cost", None)
        self.bytes_per_load = (float(cost.bytes_per_load)
                               if cost is not None else 1.0)
        self.tstate = self.trig.init_state(self.device)
        self.slot_expert = np.arange(E, dtype=np.int32)
        self.history: list = []

    @property
    def placement(self) -> np.ndarray:
        """(E,) logical expert → rank, derived from ``slot_expert``."""
        cap = self.num_experts // self.num_ranks
        pos = np.empty(self.num_experts, np.int64)
        pos[self.slot_expert] = np.arange(self.num_experts)
        return (pos // cap).astype(np.int32)

    def _to_logical(self, counts, coact):
        """Physical-slot stats → logical-expert stats (a scatter by the
        slot_expert permutation on both axes)."""
        se = self.slot_expert
        E = self.num_experts
        lc = np.zeros(E)
        lc[se] = _host(counts).astype(np.float64)
        co = np.zeros((E, E))
        co[np.ix_(se, se)] = _host(coact).astype(np.float64)
        return lc, co

    def step(self, t: int, counts, coact, moe_layers: Sequence[Dict], *,
             mesh=None, in_place: bool = False):
        """One post-train-step tick.  Returns ``(moe_layers, info)``: the
        (possibly relocated) MoE parameter dicts and a record with the
        trigger decision and the executed exchange volume."""
        lc, co = self._to_logical(counts, coact)
        self.stats.update_from_counts(lc, co)
        placement = self.placement
        mx, av, tot = rt_triggers.load_stats(
            torch.as_tensor(np.maximum(self.stats.tokens, LOAD_FLOOR),
                            dtype=torch.float32, device=self.device),
            torch.as_tensor(placement, device=self.device), self.num_ranks)
        do, self.tstate = self.trig.decide(self.tstate, int(t), mx, av, tot)
        fired = bool(do)
        moved, moved_bytes = 0, 0.0
        info: Dict = dict(t=int(t), fired=fired, max_avg=float(mx / av))
        if fired:
            new, plan_info = ep_balance.plan_placement(
                self.stats, placement, self.num_ranks,
                strategy=self.strategy, device=self.device)
            moe_layers, se2, moved, moved_bytes = execute_placement(
                moe_layers, self.slot_expert, new,
                num_ranks=self.num_ranks, mesh=mesh, device=self.device,
                in_place=in_place)
            self.slot_expert = se2.cpu().numpy().astype(np.int32)
            info.update(moved_experts=int(moved),
                        moved_bytes=float(moved_bytes), plan=plan_info)
        self.tstate = self.trig.observe(
            self.tstate, moved_bytes / self.bytes_per_load, do)
        self.history.append(info)
        return moe_layers, info
