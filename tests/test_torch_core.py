"""Parity of the PyTorch port's balancer (``repro_torch.core``) with the JAX
package (``repro.core``) on the CPU.

Every problem is made once with numpy (or the JAX package's numpy-side
generators) and handed to both packages as the same arrays.  Integer
results — neighbor tables, protocol rounds, iteration counts, assignments
— must be equal; floats are held to the tolerance each test states.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as j_api
from repro.core import comm_graph as j_cg
from repro.core import engine as j_engine
from repro.core import metrics as j_metrics
from repro.core import neighbor_selection as j_ns
from repro.core import object_selection as j_osel
from repro.core import virtual_lb as j_vlb
from repro.pic import chares as j_chares
from repro.sim import stencil, synthetic
from repro_torch import interop
from repro_torch.core import api as t_api
from repro_torch.core import comm_graph as t_cg
from repro_torch.core import engine as t_engine
from repro_torch.core import metrics as t_metrics
from repro_torch.core import neighbor_selection as t_ns
from repro_torch.core import object_selection as t_osel
from repro_torch.core import virtual_lb as t_vlb
from repro_torch.pic import chares as t_chares

CPU = "cpu"


def _as_dict(p):
    """numpy view of a JAX ``LBProblem`` (what both packages receive)."""
    d = {f: np.asarray(getattr(p, f)) for f in
         ("loads", "assignment", "edges_src", "edges_dst", "edges_bytes")}
    d["num_nodes"] = p.num_nodes
    d["coords"] = None if p.coords is None else np.asarray(p.coords)
    return d


def _jax_problem(d):
    return j_cg.LBProblem(
        loads=jnp.asarray(d["loads"]), assignment=jnp.asarray(d["assignment"]),
        edges_src=jnp.asarray(d["edges_src"]),
        edges_dst=jnp.asarray(d["edges_dst"]),
        edges_bytes=jnp.asarray(d["edges_bytes"]), num_nodes=d["num_nodes"],
        coords=None if d["coords"] is None else jnp.asarray(d["coords"]))


def _stencil_hotspot():
    return _as_dict(synthetic.hotspot(
        stencil.stencil_2d(12, 12, 9, mapping="tiled"), node=0, factor=6.0))


def _stencil_random_loads():
    p = stencil.stencil_2d(16, 16, 16, mapping="striped")
    d = _as_dict(p)
    rng = np.random.default_rng(7)
    d["loads"] = (rng.random(d["loads"].shape[0]) * 3 + 0.5).astype(
        np.float32)
    d["edges_bytes"] = (rng.random(d["edges_bytes"].shape[0]) * 10).astype(
        np.float32)
    return d


def _pic_problem():
    """The PIC driver's problem: chare loads of a GEOMETRIC particle cloud
    on 8 PEs (12×12 chares, striped)."""
    from repro.pic.particles import initialize

    p = initialize("GEOMETRIC", 100, 20_000, k=2, rho=0.9, seed=3)
    ids = j_chares.chare_of(p.x, p.y, 100, 12, 12)
    loads = np.bincount(ids, minlength=144).astype(np.float32)
    prob = j_chares.build_problem(
        loads, j_chares.initial_mapping(12, 12, 8), L=100, cx=12, cy=12,
        num_pes=8, k=2, vy0=1.0, lb_period=10)
    return _as_dict(prob)


def _pic_sparse_chares():
    """Fig 5's chare problem at 8 PEs (L = 1200, 20×10 chares, GEOMETRIC
    ρ = 0.9, 50k particles): 180 of 200 chares empty (loads clamped to
    1e-3) beside loads in the thousands, so stage 3's running sums round
    and their order decides which empty chares move."""
    from repro.pic.particles import initialize

    p = initialize("GEOMETRIC", 1200, 50_000, k=4, rho=0.9, seed=0)
    ids = j_chares.chare_of(p.x, p.y, 1200, 20, 10)
    loads = np.bincount(ids, minlength=200).astype(np.float32)
    prob = j_chares.build_problem(
        loads, j_chares.initial_mapping(20, 10, 8), L=1200, cx=20, cy=10,
        num_pes=8, k=4, vy0=1.0, lb_period=5)
    return _as_dict(prob)


PROBLEMS = {"stencil-hotspot": _stencil_hotspot,
            "stencil-random": _stencil_random_loads,
            "pic-chares": _pic_problem,
            "pic-sparse-chares": _pic_sparse_chares}


def _ulp_close(a, b, n_ulp):
    """|a - b| within ``n_ulp`` f32 spacings of max |b|."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = np.float32(np.abs(b).max()) if b.size else np.float32(0)
    return np.abs(a - b).max(initial=0) <= n_ulp * np.spacing(scale)


# ---------------------------------------------------------------- problem --


@pytest.mark.parametrize("n", [1, 16, 17, 200, 4097, 65537])
def test_cumsum_adds_in_jax_cpu_order(n):
    """``comm_graph.cumsum`` gives ``jnp.cumsum``'s bits on the CPU (XLA's
    16-element blocked scan), on loads of three magnitudes where another
    order of additions rounds differently."""
    rng = np.random.default_rng(n)
    v = (rng.random(n) * 1000).astype(np.float32) * rng.choice(
        np.array([1e-3, 1.0, 1e3], np.float32), n)
    got = t_cg.cumsum(torch.as_tensor(v)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.cumsum(v)))


@pytest.mark.parametrize("n", [0, 1, 7, 32, 33, 64, 100, 2048, 4097,
                               131072])
def test_ordered_sum_adds_in_jax_cpu_order(n):
    """``comm_graph.ordered_sum`` gives ``x.sum()``'s bits of the JAX
    package on the CPU (XLA's windows of 32, padding split between the
    ends), on values of three magnitudes and both signs, where another
    order of additions rounds differently; so does a masked sum as the
    moved-KV volume takes it."""
    rng = np.random.default_rng(n)
    v = ((rng.random(n) - 0.3) * 1000).astype(np.float32) * rng.choice(
        np.array([1e-3, 1.0, 1e3], np.float32), n)
    got = t_cg.ordered_sum(torch.as_tensor(v))
    assert got.shape == () and got.dtype == torch.float32
    assert float(got) == float(jnp.sum(jnp.asarray(v)))
    m = rng.random(n) < 0.4
    masked = t_cg.ordered_sum(torch.where(torch.as_tensor(m),
                                          torch.as_tensor(v), 0.0))
    assert float(masked) == float(jnp.where(m, v, 0.0).sum())


def test_interop_roundtrip_and_problem_views():
    d = _stencil_random_loads()
    tp = interop.problem_from_numpy(d, device=CPU)
    back = interop.problem_to_numpy(tp)
    for k in ("loads", "assignment", "edges_src", "edges_dst",
              "edges_bytes", "coords"):
        np.testing.assert_array_equal(back[k], d[k])
    assert back["num_nodes"] == d["num_nodes"]
    jp = _jax_problem(d)
    # node loads / comm matrix: f32 sums in the same (index) order — equal
    np.testing.assert_array_equal(t_cg.node_loads(tp).numpy(),
                                  np.asarray(j_cg.node_loads(jp)))
    np.testing.assert_array_equal(t_cg.node_comm_matrix(tp).numpy(),
                                  np.asarray(j_cg.node_comm_matrix(jp)))
    tp.validate()


def test_make_problem_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behavior")
    with pytest.raises(RuntimeError, match="cuda"):
        t_cg.make_problem([1.0], [0], np.zeros((0, 2)), [], 1)
    with pytest.raises(RuntimeError):
        t_engine.get_engine()


# ---------------------------------------------------------------- stage 1 --


@pytest.mark.parametrize("name", sorted(PROBLEMS))
@pytest.mark.parametrize("k", [2, 4, 6])
def test_select_neighbors_exact(name, k):
    """nbr_idx, nbr_mask, degree and rounds equal JAX's (stable sort
    reproduces lax.top_k's lowest-index tie rule)."""
    d = PROBLEMS[name]()
    pref_np = np.asarray(j_ns.comm_preference(
        j_cg.node_comm_matrix(_jax_problem(d))))
    want = j_ns.select_neighbors(jnp.asarray(pref_np), k=k)
    got = t_ns.select_neighbors(torch.as_tensor(pref_np), k=k)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_neighbors_exact_with_ties(seed):
    """Integer-valued preferences with many exact ties."""
    rng = np.random.default_rng(seed)
    P = 24
    m = rng.integers(0, 4, (P, P)).astype(np.float32)
    pref = np.triu(m, 1) + np.triu(m, 1).T
    want = j_ns.select_neighbors(jnp.asarray(pref), k=4)
    got = t_ns.select_neighbors(torch.as_tensor(pref), k=4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_coordinate_preference_matches():
    cent = np.random.default_rng(0).random((9, 2)).astype(np.float32) * 10
    np.testing.assert_allclose(
        t_ns.coordinate_preference(torch.as_tensor(cent)).numpy(),
        np.asarray(j_ns.coordinate_preference(jnp.asarray(cent))),
        rtol=1e-6)


# ---------------------------------------------------------------- stage 2 --


@pytest.mark.parametrize("name", sorted(PROBLEMS))
@pytest.mark.parametrize("single_hop", [True, False])
def test_virtual_balance_iters_exact_floats_close(name, single_hop):
    """``iters`` equal JAX's; target loads, flows and residual within 64
    f32 ulp of their largest magnitude (sums over K and P are taken in
    another order)."""
    d = PROBLEMS[name]()
    jp = _jax_problem(d)
    nres = j_ns.select_neighbors(
        j_ns.comm_preference(j_cg.node_comm_matrix(jp)), k=4)
    nl = np.asarray(j_cg.node_loads(jp))
    nbr, mask = np.asarray(nres.nbr_idx), np.asarray(nres.nbr_mask)
    want = j_vlb.virtual_balance(jnp.asarray(nl), jnp.asarray(nbr),
                                 jnp.asarray(mask), single_hop=single_hop)
    got = t_vlb.virtual_balance(torch.as_tensor(nl), torch.as_tensor(nbr),
                                torch.as_tensor(mask), single_hop=single_hop)
    assert int(got.iters) == int(want.iters)
    for a, b in ((got.target_loads, want.target_loads),
                 (got.flows, want.flows), (got.residual, want.residual)):
        assert _ulp_close(a.numpy(), b, 64)


@pytest.mark.parametrize("chunk", [1, 3, 5, 64])
def test_virtual_balance_independent_of_sweep_chunk(chunk):
    d = _stencil_hotspot()
    tp = interop.problem_from_numpy(d, device=CPU)
    nres = t_ns.select_neighbors(
        t_ns.comm_preference(t_cg.node_comm_matrix(tp)), k=4)
    nl = t_cg.node_loads(tp)
    ref = t_vlb.virtual_balance(nl, nres.nbr_idx, nres.nbr_mask,
                                sweep_chunk=8)
    got = t_vlb.virtual_balance(nl, nres.nbr_idx, nres.nbr_mask,
                                sweep_chunk=chunk)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_reverse_slots_matches():
    from tests.conftest import random_symmetric_graph

    nbr, mask = random_symmetric_graph(40, 5, seed=3)
    np.testing.assert_array_equal(
        t_vlb.reverse_slots(torch.as_tensor(nbr), torch.as_tensor(mask))
        .numpy(),
        np.asarray(j_vlb.reverse_slots(jnp.asarray(nbr), jnp.asarray(mask))))


# ---------------------------------------------------------------- stage 3 --


@pytest.mark.parametrize("name", sorted(PROBLEMS))
@pytest.mark.parametrize("metric", ["comm", "coord"])
def test_select_objects_exact(name, metric):
    """Given the same stage-1 table and stage-2 flows (JAX's), assignment
    and moved are equal; realized/residual within 64 ulp."""
    d = PROBLEMS[name]()
    jp = _jax_problem(d)
    nres = j_ns.select_neighbors(
        j_ns.comm_preference(j_cg.node_comm_matrix(jp)), k=4)
    vres = j_vlb.virtual_balance(j_cg.node_loads(jp), nres.nbr_idx,
                                 nres.nbr_mask)
    want = j_osel.select_objects(jp, nres.nbr_idx, nres.nbr_mask,
                                 vres.flows, metric=metric)
    got = t_osel.select_objects(
        interop.problem_from_numpy(d, device=CPU),
        torch.as_tensor(np.asarray(nres.nbr_idx)),
        torch.as_tensor(np.asarray(nres.nbr_mask)),
        torch.as_tensor(np.asarray(vres.flows)), metric=metric)
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))
    np.testing.assert_array_equal(got.moved.numpy(), np.asarray(want.moved))
    assert _ulp_close(got.realized.numpy(), want.realized, 64)
    assert _ulp_close(got.residual.numpy(), want.residual, 64)


# ----------------------------------------------------------------- engine --


@pytest.mark.parametrize("name", sorted(PROBLEMS))
@pytest.mark.parametrize("variant", ["comm", "coord"])
def test_plan_fn_assignment_exact(name, variant):
    """The fused planner end to end: assignment, rounds and sweeps equal."""
    d = PROBLEMS[name]()
    a_j, s_j = j_engine.get_engine(variant=variant, k=4)._jitted(
        _jax_problem(d))
    a_t, s_t = t_engine.get_engine(variant=variant, k=4, device=CPU).plan_fn(
        interop.problem_from_numpy(d, device=CPU))
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    assert int(s_t.protocol_rounds) == int(s_j.protocol_rounds)
    assert int(s_t.diffusion_iters) == int(s_j.diffusion_iters)
    assert float(s_t.mean_degree) == float(s_j.mean_degree)
    np.testing.assert_allclose(float(s_t.unrealized_flow),
                               float(s_j.unrealized_flow), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("variant", ["comm", "coord"])
def test_engine_plan_matches(variant):
    """The eager ``LBEngine.plan``: the same assignment and integer info
    as JAX's, and a measured ``plan_seconds``."""
    d = _stencil_hotspot()
    want = j_engine.get_engine(variant=variant, k=4).plan(_jax_problem(d))
    got = t_engine.get_engine(variant=variant, k=4, device=CPU).plan(
        interop.problem_from_numpy(d, device=CPU))
    np.testing.assert_array_equal(got.assignment, want.assignment)
    for key in ("strategy", "k", "protocol_rounds", "diffusion_iters"):
        assert got.info[key] == want.info[key], key
    assert got.info["plan_seconds"] > 0


def test_plan_on_pic_driver_problem_from_torch_chares():
    """``repro_torch.pic.chares.build_problem`` builds the problem the JAX
    ``build_problem`` builds, and both plan it alike."""
    rng = np.random.default_rng(5)
    loads = rng.integers(0, 500, 144).astype(np.float32)
    amap = j_chares.initial_mapping(12, 12, 8)
    kw = dict(L=1000, cx=12, cy=12, num_pes=8, k=2, vy0=1.0, lb_period=10)
    jp = j_chares.build_problem(loads, amap, **kw)
    tp = t_chares.build_problem(torch.as_tensor(loads),
                                torch.as_tensor(amap), **kw)
    d = interop.problem_to_numpy(tp)
    for k, v in _as_dict(jp).items():
        np.testing.assert_array_equal(d[k], v)
    a_j, _ = j_engine.get_strategy("diff-comm").plan_fn(jp, k=4)
    a_t, _ = t_engine.get_strategy("diff-comm").plan_fn(tp, k=4)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))


def test_metrics_and_run_strategy_match():
    d = _stencil_hotspot()
    jp = _jax_problem(d)
    tp = interop.problem_from_numpy(d, device=CPU)
    plan_j = j_engine.get_strategy("diff-comm").run(jp)
    plan_t = t_api.run_strategy("diff-comm", tp)
    np.testing.assert_array_equal(plan_t.assignment, plan_j.assignment)
    want = j_metrics.evaluate(jp, jnp.asarray(plan_j.assignment))
    got = t_metrics.evaluate(tp, torch.as_tensor(plan_t.assignment))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
        assert plan_t.info[k] == got[k]
    # all-external mapping: the finite sentinel
    allext = dataclasses.replace(
        tp, assignment=torch.arange(tp.num_objects, dtype=torch.int32)
        % tp.num_nodes)
    assert t_metrics.evaluate(allext)["ext_int_comm"] in (
        t_metrics.EXT_INT_ALL_EXTERNAL,
        float(t_metrics.evaluate_device(allext).ext_int_comm))


def test_strategy_registry_ported_subset():
    """Every strategy of the JAX package's registry is ported, the
    ``-sharded`` planners with importing ``distributed.lb_shard`` as in
    the JAX package; the host baselines are marked as host planners (the
    sharded planners, which the JAX package marks not jittable because
    they carry their own mesh, plan on the device here)."""
    import repro.distributed.lb_shard  # noqa: F401  (registers)
    import repro_torch.distributed.lb_shard  # noqa: F401  (registers)

    names = set(t_engine.available())
    assert {"none", "diff-comm", "diff-coord", "diff-comm+threshold",
            "diff-comm+predictive", "diff-coord+threshold",
            "diff-coord+predictive", "greedy", "ep-greedy", "greedy-refine",
            "metis", "parmetis", "diff-comm-sharded",
            "diff-coord-sharded"} == names
    assert names == set(j_engine.available())
    for n in names:
        assert t_engine.get_strategy(n).trigger == \
            j_engine.get_strategy(n).trigger
        assert t_engine.get_strategy(n).host == \
            (not j_engine.get_strategy(n).jittable
             and not n.endswith("-sharded"))
    tp = interop.problem_from_numpy(_stencil_hotspot(), device=CPU)
    a, stats = t_engine.get_strategy("none").plan_fn(tp)
    assert torch.equal(a, tp.assignment)
    assert int(stats.diffusion_iters) == 0


# ------------------------------------------- public entries of core.api --


@pytest.mark.parametrize("name", sorted(PROBLEMS))
@pytest.mark.parametrize("variant", ["comm", "coord"])
def test_diffusion_lb_is_the_engine_plan_and_matches_jax(name, variant):
    """``api.diffusion_lb`` (the eager single-snapshot entry) returns the
    cached engine's ``plan``: the same assignment and integer info, and
    both equal the JAX package's ``diffusion_lb``."""
    d = PROBLEMS[name]()
    kw = dict(k=3, variant=variant, tol=0.05)
    got = t_api.diffusion_lb(interop.problem_from_numpy(d, device=CPU),
                             device=CPU, **kw)
    via = t_engine.get_engine(device=CPU, **kw).plan(
        interop.problem_from_numpy(d, device=CPU))
    want = j_api.diffusion_lb(_jax_problem(d), **kw)
    np.testing.assert_array_equal(got.assignment, via.assignment)
    np.testing.assert_array_equal(got.assignment, want.assignment)
    for key in ("strategy", "k", "protocol_rounds", "diffusion_iters"):
        assert got.info[key] == via.info[key] == want.info[key], key
    from repro_torch import core

    assert core.diffusion_lb is t_api.diffusion_lb


@pytest.mark.parametrize("name", sorted(PROBLEMS))
@pytest.mark.parametrize("moved", [False, True])
def test_object_node_bytes_matches_jax(name, moved):
    """The §III.C metric: (N, K) bytes each object exchanges with each
    neighbor node of its node, against the JAX package's — exact (each
    entry adds its edges in index order on both sides), with the
    problem's assignment and with one where a quarter of the objects
    moved to another node (the "peers update their patterns" re-call)."""
    d = PROBLEMS[name]()
    pref = np.asarray(j_ns.comm_preference(
        j_cg.node_comm_matrix(_jax_problem(d))))
    nbr = np.array(j_ns.select_neighbors(jnp.asarray(pref), k=4).nbr_idx)
    a = d["assignment"].copy()
    if moved:
        rng = np.random.default_rng(1)
        pick = rng.random(a.shape[0]) < 0.25
        a[pick] = (a[pick] + 1) % d["num_nodes"]
    want = np.asarray(j_cg.object_node_bytes(
        _jax_problem(d), jnp.asarray(nbr), jnp.asarray(a)))
    got = t_cg.object_node_bytes(interop.problem_from_numpy(d, device=CPU),
                                 torch.as_tensor(nbr),
                                 torch.as_tensor(a)).numpy()
    assert got.shape == (a.shape[0], nbr.shape[1])
    np.testing.assert_array_equal(got, want)
    if not moved:       # the default is the problem's own assignment
        from repro_torch import core

        again = core.object_node_bytes(
            interop.problem_from_numpy(d, device=CPU), torch.as_tensor(nbr))
        np.testing.assert_array_equal(again.numpy(), want)
