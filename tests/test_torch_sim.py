"""Parity of the PyTorch port's simulator slice (``repro_torch.sim``, the
streaming sweep and ``step_fn`` planning) with the JAX package on the CPU.

Inputs come from numpy seeds or the generators' own numpy draws and go
through both packages.  Integer results (assignments, iteration counts)
must be equal; floats are held to the tolerance each test states.  The
JAX side runs as its own tests run it: jitted, or the Pallas kernel in
interpret mode.
"""
import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import comm_graph as j_cg
from repro.core import engine as j_engine
from repro.core import neighbor_selection as j_ns
from repro.core import virtual_lb as j_vlb
from repro.kernels.diffusion import ops as j_dops
from repro.kernels.diffusion.kernel import diffusion_sweep_pallas
from repro.runtime import cost as j_cost
from repro.sim import scenarios as j_scen
from repro.sim import simulator as j_sim
from repro.sim import stencil as j_stencil
from repro.sim import synthetic as j_syn
from repro.sim import viz as j_viz
from repro_torch import interop
from repro_torch.core import engine as t_engine
from repro_torch.core import virtual_lb as t_vlb
from repro_torch.kernels.diffusion import ops as t_dops
from repro_torch.kernels.diffusion.ref import diffusion_sweep_ref
from repro_torch.runtime import cost as t_cost
from repro_torch.sim import scenarios as t_scen
from repro_torch.sim import simulator as t_sim
from repro_torch.sim import stencil as t_stencil
from repro_torch.sim import synthetic as t_syn
from repro_torch.sim import viz as t_viz

CPU = "cpu"
FIELDS = ("loads", "assignment", "edges_src", "edges_dst", "edges_bytes",
          "coords")


def _np(p):
    """numpy view of either package's ``LBProblem``."""
    d = {}
    for f in FIELDS:
        v = getattr(p, f)
        d[f] = None if v is None else (
            v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
    d["num_nodes"] = p.num_nodes
    return d


def _assert_problems_equal(tp, jp):
    a, b = _np(tp), _np(jp)
    for f in FIELDS + ("num_nodes",):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def _ulps(a, b):
    """max |a - b| in f32 spacings of max |b|."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.spacing(np.abs(b).max()))


# ------------------------------------------------------------- generators --


@pytest.mark.parametrize("mapping", ["tiled", "striped", "ring", "random"])
def test_stencil_2d_exact(mapping):
    kw = dict(mapping=mapping, seed=3, bytes_per_edge=2.5, base_load=1.5)
    _assert_problems_equal(t_stencil.stencil_2d(12, 10, 6, device=CPU, **kw),
                           j_stencil.stencil_2d(12, 10, 6, **kw))
    _assert_problems_equal(
        t_stencil.stencil_2d(7, 9, 4, periodic=False, device=CPU, **kw),
        j_stencil.stencil_2d(7, 9, 4, periodic=False, **kw))


@pytest.mark.parametrize("mapping", ["tiled", "striped", "random"])
def test_stencil_3d_exact(mapping):
    _assert_problems_equal(
        t_stencil.stencil_3d(6, 5, 4, 12, mapping=mapping, seed=2,
                             device=CPU),
        j_stencil.stencil_3d(6, 5, 4, 12, mapping=mapping, seed=2))
    _assert_problems_equal(
        t_stencil.stencil_3d(4, 4, 3, 8, mapping=mapping, periodic=False,
                             device=CPU),
        j_stencil.stencil_3d(4, 4, 3, 8, mapping=mapping, periodic=False))


def test_stencil_unknown_mapping_raises():
    with pytest.raises(ValueError):
        t_stencil.stencil_2d(4, 4, 2, mapping="hex", device=CPU)
    with pytest.raises(ValueError):
        t_stencil.stencil_3d(4, 4, 4, 2, mapping="ring", device=CPU)


def test_synthetic_injectors_exact():
    tp = t_stencil.stencil_2d(16, 16, 16, mapping="striped", device=CPU)
    jp = j_stencil.stencil_2d(16, 16, 16, mapping="striped")
    _assert_problems_equal(t_syn.random_pm(tp, 0.4, seed=5),
                           j_syn.random_pm(jp, 0.4, seed=5))
    _assert_problems_equal(t_syn.mod7(tp), j_syn.mod7(jp))
    _assert_problems_equal(t_syn.mod7(tp, over=1.7, under=0.3),
                           j_syn.mod7(jp, over=1.7, under=0.3))
    _assert_problems_equal(t_syn.hotspot(tp, node=3, factor=7.0),
                           j_syn.hotspot(jp, node=3, factor=7.0))


def test_viz_matches():
    a = np.random.default_rng(0).integers(0, 70, 12 * 9).astype(np.int32)
    assert t_viz.ownership_map(torch.as_tensor(a), 12, 9) == \
        j_viz.ownership_map(a, 12, 9)
    assert t_viz.locality_summary(torch.as_tensor(a), 12, 9) == \
        j_viz.locality_summary(a, 12, 9)


# -------------------------------------------------------------- scenarios --

SMALL = {"stencil-wave": dict(grid=16, num_nodes=8),
         "pic-geometric": dict(num_pes=4),
         "adversarial-hotspot": dict(grid=16, num_nodes=8, dwell=3),
         "bimodal-churn": dict(grid=16, num_nodes=8, churn_every=2)}

# f32 spacings of the largest value that evolved loads and edge bytes may
# be apart: exp/cos/sin differ by about 1 ulp between XLA and PyTorch on
# the CPU (2.5 ulp measured after the Gaussian); pic-geometric normalizes
# by a 144-term sum that XLA adds in another order (5 ulp measured in the
# loads, 9 in the edge bytes that scale them, over 40 steps);
# bimodal-churn is integer arithmetic and exact
EVOLVE_ULPS = {"stencil-wave": 4, "pic-geometric": 12,
               "adversarial-hotspot": 4, "bimodal-churn": 0}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_scenario_evolve_matches(name):
    """12 steps of each evolve, with ``t`` an int32 as in JAX's scanned
    replay: loads and edge bytes within :data:`EVOLVE_ULPS`; the rest of
    the problem exact."""
    tp, tev = t_scen.get(name).instantiate(device=CPU, **SMALL[name])
    jp, jev = j_scen.get(name).instantiate(**SMALL[name])
    n = EVOLVE_ULPS[name]
    for t in range(12):
        a, b = _np(tev(tp, t)), _np(jev(jp, jnp.int32(t)))
        for f in ("loads", "edges_bytes"):
            assert _ulps(a[f], b[f]) <= n, (t, f)
        for f in ("assignment", "edges_src", "edges_dst", "coords"):
            np.testing.assert_array_equal(a[f], b[f])
    a, b = _np(tp), _np(jp)
    assert _ulps(a["loads"], b["loads"]) <= n
    np.testing.assert_array_equal(a["assignment"], b["assignment"])


def test_scenario_registry_and_memo():
    assert set(t_scen.available()) == set(SMALL)
    assert set(t_scen.available()) <= set(j_scen.available())
    with pytest.raises(KeyError):
        t_scen.get("serving-trace")
    s = t_scen.get("stencil-wave")
    p1, e1 = s.instantiate(device=CPU, grid=8, num_nodes=4)
    p2, e2 = s.instantiate(device="cpu", grid=8, num_nodes=4)
    assert p1 is p2 and e1 is e2 and e1.device_resident
    assert s.instantiate(device=CPU, grid=8, num_nodes=2)[1] is not e1
    assert s.pic_config is None
    assert t_scen.get("pic-geometric").pic_config == \
        j_scen.get("pic-geometric").pic_config
    loads = torch.tensor([float("nan"), 0.0, 2.0, float("inf")])
    np.testing.assert_array_equal(
        t_scen.finite_loads(loads).numpy(),
        np.asarray(j_scen.finite_loads(jnp.asarray(loads.numpy()))))


# ---------------------------------------------------- K2: streaming sweep --


def _graph(P, K, seed):
    from tests.conftest import random_symmetric_graph

    nbr, mask = random_symmetric_graph(P, K, seed=seed)
    rng = np.random.default_rng(seed)
    x = (rng.random(P) * 10).astype(np.float32)
    own = (x * rng.random(P)).astype(np.float32)
    rev = np.asarray(j_vlb.reverse_slots(jnp.asarray(nbr), jnp.asarray(mask)))
    return x, own, nbr, mask, rev


@pytest.mark.parametrize("P,K", [(64, 4), (257, 8)])
@pytest.mark.parametrize("single_hop", [True, False])
def test_diffusion_sweep_plain_matches_pallas_and_reference(P, K,
                                                            single_hop):
    """The port's plain sweep (the CPU path of ``ops.diffusion_sweep``)
    against ``diffusion_sweep_pallas`` in interpret mode and JAX's
    ``reference_sweep``: every output within 4 f32 ulp of the largest load
    (row sums over K run in another order)."""
    x, own, nbr, mask, rev = _graph(P, K, seed=P + K)
    alpha = np.float32(1.0 / (K + 1.0))
    tin = [torch.as_tensor(a) for a in (x, own, nbr, mask, rev)]
    got = t_dops.diffusion_sweep(*tin, float(alpha), single_hop)
    ref = diffusion_sweep_ref(*tin, float(alpha), single_hop)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    jin = [jnp.asarray(a) for a in (x, own, nbr, mask, rev)]
    for want in (diffusion_sweep_pallas(*jin, alpha, single_hop,
                                        interpret=True),
                 j_vlb.reference_sweep(*jin, alpha, single_hop)):
        for a, b in zip(got, want):
            assert a.shape == tuple(b.shape)
            assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= \
                4 * np.spacing(np.float32(x.max()))


def test_sweep_impl_on_cpu_is_reference():
    assert t_dops.sweep_impl(8, 4, "cpu") == "reference"
    assert t_dops.sweep_impl(1 << 20, 8, torch.device("cpu")) == "reference"
    # on a card: the fused kernel up to the measured crossover
    assert t_dops.sweep_impl(8, 4, "cuda") == "fused"
    big = t_dops.FUSED_MAX_PK // 8 + 1
    assert t_dops.sweep_impl(big, 8, "cuda") == "streaming"
    assert t_dops.sweep_impl(big, t_dops.MAX_K + 1, "cuda") == "fused"


def test_chunk_wrappers_take_the_plain_chunk_on_cpu():
    """``fused_nsweeps``, ``streaming_nsweeps`` and ``diffusion_nsweeps``
    on CPU tensors equal the plain chunk bit for bit."""
    x, own, nbr, mask, rev = (torch.as_tensor(a)
                              for a in _graph(64, 4, seed=2))
    carry = (x, own, torch.zeros((64, 4)),
             torch.zeros((), dtype=torch.int32),
             t_vlb.neighborhood_residual(x, nbr, mask),
             torch.zeros((), dtype=torch.int32))
    kw = dict(n_sweeps=5, single_hop=True, tol=0.02, max_iters=512)
    want = t_vlb.reference_nsweeps(*carry, nbr, mask, rev, 0.2, **kw)
    for fn in (t_dops.fused_nsweeps, t_dops.streaming_nsweeps,
               t_dops.diffusion_nsweeps):
        for a, b in zip(fn(*carry, nbr, mask, rev, 0.2, **kw), want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("single_hop", [True, False])
def test_virtual_balance_step_fn_matches_chunk_path(single_hop):
    """``virtual_balance(step_fn=ops.diffusion_sweep)`` against the chunk
    path (port and JAX) and JAX's ``step_fn`` path with its Pallas sweep,
    on the stage-1 table of a stencil hotspot: ``iters`` exact; loads and
    flows equal to the port's chunk path and within 64 ulp of the largest
    load of JAX's.  (The loop here ends on ``tol``; where it ends on the
    stall test, ``moved <= 1e-6·mean``, that test compares a sum of
    last-bit rounding noise, and sums in another order can end it a sweep
    apart.)"""
    _, jp = _stencil_hotspot()
    nres = j_ns.select_neighbors(
        j_ns.comm_preference(j_cg.node_comm_matrix(jp)), k=4)
    x = np.asarray(j_cg.node_loads(jp))
    nbr, mask = np.asarray(nres.nbr_idx), np.asarray(nres.nbr_mask)
    tin = [torch.as_tensor(a) for a in (x, nbr, mask)]
    got = t_vlb.virtual_balance(*tin, single_hop=single_hop,
                                step_fn=t_dops.diffusion_sweep)
    chunk = t_vlb.virtual_balance(*tin, single_hop=single_hop,
                                  chunk_fn=t_dops.diffusion_nsweeps)
    for a, b in zip(got, chunk):
        assert torch.equal(a, b)
    assert float(got.residual) <= 0.02
    jin = [jnp.asarray(a) for a in (x, nbr, mask)]
    for want in (j_vlb.virtual_balance(*jin, single_hop=single_hop,
                                       step_fn=j_dops.diffusion_sweep),
                 j_vlb.virtual_balance(*jin, single_hop=single_hop)):
        assert int(got.iters) == int(want.iters)
        for a, b in ((got.target_loads, want.target_loads),
                     (got.flows, want.flows)):
            assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= \
                64 * np.spacing(np.float32(x.max()))


# ------------------------------------------------------ engine and step_fn --


def _stencil_hotspot():
    p = j_syn.hotspot(j_stencil.stencil_2d(12, 12, 9, mapping="tiled"),
                      node=0, factor=6.0)
    return _np(p), p


@pytest.mark.parametrize("kind", ["kernel", "reference"])
@pytest.mark.parametrize("variant", ["comm", "coord"])
def test_engine_step_fn_plan_matches_jax(kind, variant):
    """``LBEngine(step_fn=...)`` against the JAX engine with the same kind
    of ``step_fn`` (the kernel wrappers, or the reference sweeps):
    assignment, rounds and sweeps exact; the plan equals the default
    engine's."""
    d, jp = _stencil_hotspot()
    t_step, j_step = {
        "kernel": (t_dops.diffusion_sweep, j_dops.diffusion_sweep),
        "reference": (t_vlb.reference_sweep, j_vlb.reference_sweep)}[kind]
    eng = t_engine.LBEngine(variant=variant, k=4, step_fn=t_step,
                            device=CPU)
    assert eng.step_fn is t_step and eng.chunk_fn is None
    tp = interop.problem_from_numpy(d, device=CPU)
    a_t, s_t = eng.plan_fn(tp)
    a_j, s_j = j_engine.get_engine(variant=variant, k=4,
                                   step_fn=j_step)._jitted(jp)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    assert int(s_t.diffusion_iters) == int(s_j.diffusion_iters)
    assert int(s_t.protocol_rounds) == int(s_j.protocol_rounds)
    a_d, s_d = t_engine.get_engine(variant=variant, k=4,
                                   device=CPU).plan_fn(tp)
    assert torch.equal(a_t, a_d)
    assert int(s_t.diffusion_iters) == int(s_d.diffusion_iters)


class _UnhashableStep:
    """A callable sweep that cannot be hashed."""
    __hash__ = None

    def __call__(self, *args):
        return t_vlb.reference_sweep(*args)


def test_get_engine_cache_keys():
    """The JAX ``_engine_key`` contract, plus the device: positional and
    keyword, int and float spellings share an entry; an unhashable
    ``step_fn`` is keyed by identity; bad arguments raise TypeError."""
    g = t_engine.get_engine
    e1 = g("comm", 6, 0.02, 512, 64, True, None, 8, CPU)
    assert e1 is g(variant="comm", k=6, device=CPU) is g(k=6.0, device=CPU)
    assert g(k=7, tol=0.02, device=CPU) is g(k=7.0, tol=0.02, device="cpu")
    step = _UnhashableStep()
    with pytest.raises(TypeError):
        hash(step)
    e2 = g(k=3, step_fn=step, device=CPU)
    assert e2 is g(k=3, step_fn=step, device=CPU) and e2.step_fn is step
    assert g(k=3, step_fn=_UnhashableStep(), device=CPU) is not e2
    assert g(k=3, step_fn=t_dops.diffusion_sweep, device=CPU) is not \
        g(k=3, device=CPU)
    with pytest.raises(TypeError, match="unexpected"):
        g(bogus=1)
    with pytest.raises(TypeError, match="multiple values"):
        g("comm", variant="comm")
    assert list(inspect.signature(g).parameters) == list(
        inspect.signature(j_engine.get_engine).parameters)[:-1] + ["device"]


# ------------------------------------------------------- compare / tables --


def test_compare_and_format_table_match():
    d, jp = _stencil_hotspot()
    tp = interop.problem_from_numpy(d, device=CPU)
    names = ["none", "diff-comm", "diff-coord+threshold"]
    kw = {"diff-comm": {"k": 3}}
    got = t_sim.compare(tp, names, kw)
    want = j_sim.compare(jp, names, kw)
    for r_t, r_j in zip(got, want):
        assert r_t.strategy == r_j.strategy
        for side in ("before", "after"):
            a, b = getattr(r_t, side), getattr(r_j, side)
            assert set(a) == set(b)
            for k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6)
        for k in ("migrated_load", "diffusion_iters", "protocol_rounds",
                  "strategy"):
            assert r_t.info.get(k) == r_j.info.get(k), k
    # every column but the measured plan_s
    strip = [line.rsplit(None, 1)[0] for line in
             t_sim.format_table(got).splitlines()[1:]]
    assert strip == [line.rsplit(None, 1)[0] for line in
                     j_sim.format_table(want).splitlines()[1:]]
    assert t_sim.format_table([]).splitlines()[0] == \
        j_sim.format_table([]).splitlines()[0]


# ------------------------------------------------------------ slice edges --


def test_later_slice_knobs_raise():
    p, ev = t_scen.get("stencil-wave").instantiate(device=CPU, grid=8,
                                                   num_nodes=4)
    kw = dict(steps=2, lb_every=1)
    for extra in (dict(threads_per_node=2), dict(telemetry="counters")):
        with pytest.raises(NotImplementedError):
            t_sim.run_series(p, ev, **kw, **extra)
    # the host baselines and the batched replay have been ported: a host
    # planner takes the host loop, and refuses the device-resident one
    assert not t_sim.run_series(p, ev, **kw, strategy="greedy").scanned
    with pytest.raises(ValueError, match="jittable"):
        t_sim.run_series(p, ev, **kw, strategy="metis", scan=True)
    assert t_sim.run_series_batch([(p, ev)], **kw).batch == 1
    with pytest.raises(NotImplementedError):
        t_sim.run_series_sharded(p, ev, **kw)
    with pytest.raises(KeyError):
        t_sim.run_series(p, ev, **kw, strategy="bogus")


def test_series_modeled_seconds_matches():
    model_kw = dict(t_load=2e-3, t_byte=1e-6, bytes_per_load=48.0,
                    lb_overhead=0.01)
    rng = np.random.default_rng(0)
    res = t_sim.SeriesResult(
        max_avg=np.ones(6), ext_int=np.ones(6), migrations=np.zeros(6),
        plan_seconds=0.0, max_load=rng.random(6) * 100,
        migrated_load=rng.random(6) * 5, lb_fired=(rng.random(6) > 0.5) * 1.)
    got = t_cost.series_modeled_seconds(res,
                                        t_cost.RuntimeCostModel(**model_kw))
    want = j_cost.series_modeled_seconds(
        dataclasses.replace(res), j_cost.RuntimeCostModel(**model_kw))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        t_cost.series_modeled_seconds(
            dataclasses.replace(res, lb_fired=None),
            t_cost.RuntimeCostModel())
