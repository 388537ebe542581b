"""The port's mesh-sharded planner (``distributed.lb_shard``) and its mesh
(``distributed.mesh``) against the JAX package's single-device engine and
the port's own, on the CPU.

The port holds the D shards as the leading axis of tensors on one device
(``ShardMesh``), so every D runs in this process: each parity test runs
D ∈ {1, 2, 4, 8} where the problem's P allows.  Contracts, as in
``tests/test_lb_shard.py``:

  * ``ShardedLBEngine.plan_fn`` gives the JAX engine's assignment
    exactly, its stats within ``RTOL`` (the JAX package's own tolerance
    for its psum-completed engine), and the port's ``LBEngine.plan_fn``
    bit for bit: the port reduces gathered values, as its replays'
    planner ``plan_step_sharded`` does;
  * the mesh's collectives copy or add exactly.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as j_engine
from repro.sim import stencil as j_stencil
from repro.sim import synthetic as j_synthetic
from repro_torch import interop
from repro_torch.core import api as t_api
from repro_torch.core import engine as t_engine
from repro_torch.distributed import lb_shard
from repro_torch.distributed.mesh import ShardMesh, resolve_mesh
from repro_torch.sim import scenarios as t_scen

CPU = "cpu"
RTOL = 1e-5


def _pair(jprob):
    """(JAX problem, the port's problem on the CPU) from the same arrays."""
    d = {f: np.asarray(getattr(jprob, f)) for f in
         ("loads", "assignment", "edges_src", "edges_dst", "edges_bytes")}
    d.update(num_nodes=jprob.num_nodes,
             coords=None if jprob.coords is None else np.asarray(
                 jprob.coords))
    return jprob, interop.problem_from_numpy(d, device=CPU)


@functools.lru_cache(maxsize=None)
def _hotspot(P=16, grid=16):
    return _pair(j_synthetic.hotspot(j_stencil.stencil_2d(grid, grid, P),
                                     node=3, factor=7.0))


@functools.lru_cache(maxsize=None)
def _jax_plan(variant="comm", k=4, threads=None, problem="hotspot"):
    """The JAX package's single-device plan (compiled once a module)."""
    jp = _hotspot()[0] if problem == "hotspot" else _pic_problem()
    eng = j_engine.get_engine(variant=variant, k=k,
                              threads_per_node=threads)
    if threads:
        a, thr, s = jax.jit(eng.plan_hier_fn)(jp)
        return np.asarray(a), np.asarray(thr), s
    a, s = jax.jit(eng.plan_fn)(jp)
    return np.asarray(a), s


@functools.lru_cache(maxsize=None)
def _pic_problem():
    from repro.sim import scenarios as j_scen

    return j_scen.get("pic-geometric").instantiate(
        cx=8, cy=8, num_pes=8, n_particles=5000.0)[0]


def _assert_stats_close(got, want):
    assert int(got.protocol_rounds) == int(want.protocol_rounds)
    assert int(got.diffusion_iters) == int(want.diffusion_iters)
    for f in ("diffusion_residual", "unrealized_flow", "mean_degree"):
        np.testing.assert_allclose(float(getattr(got, f)),
                                   float(getattr(want, f)), rtol=RTOL,
                                   err_msg=f)


# ------------------------------------------------------------------ mesh --


def test_mesh_collectives_are_exact():
    mesh = ShardMesh(4, CPU)
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    # ppermute [(d, (d-1) % D)]: shard me then holds shard me+1's block
    np.testing.assert_array_equal(mesh.ring_shift(x)[0].numpy(), [3, 4, 5])
    np.testing.assert_array_equal(mesh.ring_shift(x)[3].numpy(), [0, 1, 2])
    np.testing.assert_array_equal(mesh.all_gather(x).numpy(),
                                  np.arange(12))
    np.testing.assert_array_equal(
        mesh.psum(torch.arange(8).reshape(4, 2)).numpy(), [12, 16])
    np.testing.assert_array_equal(mesh.shard(torch.arange(8)).numpy(),
                                  np.arange(8).reshape(4, 2))
    with pytest.raises(ValueError, match="divide"):
        mesh.shard(torch.arange(6))


def test_resolve_mesh_follows_the_jax_rules():
    m = resolve_mesh(None, 4, (16, 8), CPU)
    assert m.num_shards == 4 and m == ShardMesh(4, CPU)
    with pytest.raises(ValueError, match="not both"):
        resolve_mesh(ShardMesh(2, CPU), 2, (8,), CPU)
    with pytest.raises(ValueError, match="divide"):
        resolve_mesh(None, 3, (8,), CPU)
    with pytest.raises(ValueError, match="divide"):
        resolve_mesh(ShardMesh(3, CPU), None, (8,), CPU)
    with pytest.raises(TypeError, match="ShardMesh"):
        resolve_mesh(object(), None, (8,), CPU)
    # None resolves to the real devices: one, as JAX resolves it on one
    assert resolve_mesh(None, None, (16,), CPU).num_shards == \
        len(jax.devices()) == 1
    assert lb_shard.best_shards(12, CPU) == 1


@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_ring_gather_copies_exactly(D):
    mesh = ShardMesh(D, CPU)
    m = 3
    vec = torch.arange(D * m, dtype=torch.float32) * 1.5
    rng = np.random.default_rng(D)
    want = rng.integers(0, D * m, (D, 5, 2))
    got = lb_shard._ring_gather_values(
        mesh, vec.reshape(D, m), torch.as_tensor(want // m),
        torch.as_tensor(want % m))
    np.testing.assert_array_equal(got.numpy(), vec.numpy()[want])


@pytest.mark.parametrize("K", [3, 4, 5, 8])
def test_row_sum_is_the_plain_chunks_sum(K):
    """Each row's sum over K adds in the single-device chunk's order (on
    the CPU: ``sum``, whose order depends on K but not on the rows)."""
    p = torch.rand(64, K) * 10.0 ** torch.randint(-4, 4, (64, K))
    np.testing.assert_array_equal(
        lb_shard._row_sum(p.reshape(8, 8, K)).reshape(-1).numpy(),
        p.sum(1).numpy())


# ------------------------------------------------------ ShardedLBEngine --


@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_sharded_plan_matches_engine(D):
    _, tp = _hotspot()
    ref_a, ref_s = _jax_plan()
    own_a, own_s = t_engine.get_engine(k=4, device=CPU).plan_fn(tp)
    a, s = lb_shard.get_sharded_engine(k=4, num_shards=D,
                                       device=CPU).plan_fn(tp)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ref_a))
    np.testing.assert_array_equal(a.numpy(), own_a.numpy())
    _assert_stats_close(s, ref_s)
    for f, g, w in zip(s._fields, s, own_s):
        assert torch.equal(g, w), f


@pytest.mark.parametrize("D", [1, 4])
def test_sharded_coord_variant_matches_engine(D):
    _, tp = _hotspot()
    ref_a, _ = _jax_plan("coord")
    a, _ = lb_shard.get_sharded_engine(variant="coord", k=4, num_shards=D,
                                       device=CPU).plan_fn(tp)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ref_a))


@pytest.mark.parametrize("D", [1, 2, 8])
def test_sharded_plan_on_float_loads_pic_problem(D):
    """The PIC chare problem (float edge bytes): exact assignments and
    sweeps, as the JAX package's 8-device test asserts."""
    _, tp = _pair(_pic_problem())
    ra, rs = _jax_plan(k=3, problem="pic")
    a, s = lb_shard.get_sharded_engine(k=3, num_shards=D,
                                       device=CPU).plan_fn(tp)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ra))
    assert int(s.diffusion_iters) == int(rs.diffusion_iters)


def test_sharded_strategy_registered_and_runs():
    assert "diff-comm-sharded" in t_engine.available()
    assert "diff-coord-sharded" in t_engine.available()
    _, tp = _hotspot()
    plan = t_api.run_strategy("diff-comm-sharded", tp, k=4)
    ref = t_api.run_strategy("diff-comm", tp, k=4)
    jref = _jax_plan()[0]
    np.testing.assert_array_equal(plan.assignment, ref.assignment)
    np.testing.assert_array_equal(plan.assignment, np.asarray(jref))
    assert plan.info["diffusion_iters"] == ref.info["diffusion_iters"]
    four = t_api.run_strategy("diff-comm-sharded", tp, k=4, num_shards=4)
    np.testing.assert_array_equal(four.assignment, ref.assignment)
    eplan = lb_shard.get_sharded_engine(k=4, num_shards=8,
                                        device=CPU).plan(tp)
    assert eplan.info["num_shards"] == 8
    assert eplan.info["strategy"] == "diff-comm-sharded"
    np.testing.assert_array_equal(eplan.assignment, ref.assignment)


@pytest.mark.parametrize("D", [1, 4])
def test_sharded_hier_plan_two_level_placement(D):
    _, tp = _hotspot()
    sh = lb_shard.get_sharded_engine(k=4, threads_per_node=4, num_shards=D,
                                     device=CPU)
    a, thread, _ = sh.plan_hier_fn(tp)
    a_ref, thr_ref, _ = _jax_plan(threads=4)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_ref))
    np.testing.assert_array_equal(thread.numpy(), np.asarray(thr_ref))
    plan = sh.plan(tp)
    np.testing.assert_array_equal(plan.info["thread"], np.asarray(thr_ref))
    with pytest.raises(ValueError, match="threads_per_node"):
        lb_shard.get_sharded_engine(k=4, device=CPU).plan_hier_fn(tp)


def test_sharded_engine_cache_and_arguments():
    e1 = lb_shard.get_sharded_engine(k=4, tol=0.02, device=CPU)
    e2 = lb_shard.get_sharded_engine(tol=0.02, k=4, device=CPU)
    assert e1 is e2 and e1.num_shards == 1
    assert lb_shard.get_sharded_engine(k=5, device=CPU) is not e1
    with pytest.raises(TypeError, match="unexpected"):
        lb_shard.get_sharded_engine(bogus=1, device=CPU)
    with pytest.raises(ValueError, match="not both"):
        lb_shard.ShardedLBEngine(mesh=ShardMesh(2, CPU), num_shards=2)
    with pytest.raises(ValueError, match="variant"):
        lb_shard.ShardedLBEngine(variant="bogus", device=CPU)
    _, tp = _pair(j_synthetic.hotspot(j_stencil.stencil_2d(6, 6, 12), 0,
                                      2.0))
    with pytest.raises(ValueError, match="divide"):
        lb_shard.get_sharded_engine(k=2, num_shards=8, device=CPU).plan_fn(tp)


@pytest.mark.parametrize("D", [2, 4])
def test_edge_and_object_padding_is_inert(D):
    # N = 70 and E = 123 do not divide the shard count: the zero-load
    # object pad and (-1, -1, 0.0) edge pad must not perturb the plan
    jp, tp = _pair(j_synthetic.hotspot(
        j_stencil.stencil_2d(10, 7, 4, periodic=False), node=1, factor=4.0))
    ref_a, _ = jax.jit(j_engine.get_engine(k=2).plan_fn)(jp)
    a, _ = lb_shard.get_sharded_engine(k=2, num_shards=D,
                                       device=CPU).plan_fn(tp)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ref_a))


def test_apply_is_the_sharded_exchange():
    sh = lb_shard.get_sharded_engine(k=2, num_shards=4, device=CPU)
    owner = torch.as_tensor(np.random.default_rng(0).integers(0, 8, 64),
                            dtype=torch.int32)
    out, (ids,), counts = sh.apply(owner, (torch.arange(64),), num_nodes=8)
    cap = out.shape[0] // 4
    got = torch.cat([ids[d * cap:d * cap + int(c)]
                     for d, c in enumerate(counts)])
    np.testing.assert_array_equal(
        got.numpy(), np.argsort(owner.numpy(), kind="stable"))


# ------------------------------------------------ the replays' planner --


@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("variant", ["comm", "coord"])
def test_plan_step_sharded_is_plan_fn_bit_for_bit(D, variant):
    """The replays' planner reduces gathered values: the same assignment
    and the same stats, bit for bit, as ``LBEngine.plan_fn``."""
    tp, ev = t_scen.get("stencil-wave").instantiate(grid=16, num_nodes=16,
                                                    device=CPU)
    tp = ev(tp, 5)
    eng = t_engine.get_engine(variant=variant, k=4, device=CPU)
    want_a, want_s = eng.plan_fn(tp)
    a, s = lb_shard.plan_step_sharded(
        tp, mesh=ShardMesh(D, CPU), variant=variant, k=4, tol=0.02,
        max_iters=512, max_rounds=64, single_hop=True, sweep_chunk=8)
    np.testing.assert_array_equal(a.numpy(), want_a.numpy())
    for f, g, w in zip(s._fields, s, want_s):
        assert torch.equal(g, w), f
