"""The port's MoE expert placement (``repro_torch.distributed.ep_balance``)
against the JAX package's (``repro.distributed.ep_balance``) on the CPU,
mirroring ``tests/test_ep_balance.py``.

The same routed ids (NumPy, seeded) go through both packages.  Integers
must be equal — placements, repairs, permutations, moved counts; the
float64 host statistics are NumPy on both sides and equal bit for bit;
the MoE layer's output after a permutation is within 2e-4 of before (f32,
the JAX test's tolerance)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import ep_balance as j_eb
from repro_torch.configs import get_arch
from repro_torch.core import engine as t_engine
from repro_torch.distributed import ep_balance as t_eb
from repro_torch.models import moe as t_moe
from repro_torch.models.params import tree_map

CPU = "cpu"


def _ids(E=16, k=2, seed=0, steps=5):
    """``steps`` (512, k) routed id batches with 4 hot experts."""
    rng = np.random.default_rng(seed)
    p = np.r_[np.full(4, 0.6 / 4), np.full(E - 4, 0.4 / (E - 4))]
    return [rng.choice(E, size=(512, k), p=p) for _ in range(steps)]


def _skewed_stats(pkg, E=16, k=2, seed=0, steps=5):
    stats = pkg.ExpertStats(E, ema=0.5)
    for ids in _ids(E, k, seed, steps):
        stats.update(ids)
    return stats


def _plan_both(seed, placement, R, **kw):
    """(port, JAX) ``plan_placement`` of the same statistics."""
    got = t_eb.plan_placement(_skewed_stats(t_eb, seed=seed), placement, R,
                              device=CPU, **kw)
    want = j_eb.plan_placement(_skewed_stats(j_eb, seed=seed), placement, R,
                               **kw)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1]["moved_experts"] == want[1]["moved_experts"]
    return got


def test_stats_update_counts_and_coactivation():
    stats = t_eb.ExpertStats(4, ema=0.0)
    ids = np.array([[0, 1], [0, 1], [2, 3]])
    stats.update(ids)
    assert stats.tokens[0] == 2 and stats.tokens[3] == 1
    assert stats.coact[0, 1] == 2 and stats.coact[1, 0] == 2
    assert stats.coact[2, 3] == 1
    assert stats.coact[0, 2] == 0
    a, b = _skewed_stats(t_eb, seed=4), _skewed_stats(j_eb, seed=4)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.coact, b.coact)


def test_plan_is_capacity_exact():
    placement = (np.arange(16) // 4).astype(np.int32)
    new, info = _plan_both(0, placement, 4)
    assert (np.bincount(new, minlength=4) == 4).all()
    assert new.dtype == np.int32


def test_plan_reduces_imbalance():
    stats = _skewed_stats(t_eb)
    # adversarial initial: the 4 hot experts all on rank 0
    placement = (np.arange(16) // 4).astype(np.int32)
    before = stats.imbalance(placement, 4)
    new, info = _plan_both(0, placement, 4)
    assert stats.imbalance(new, 4) < before
    assert info["moved_experts"] < 16, "diffusion must not move everything"


def test_diffusion_moves_fewer_experts_than_greedy():
    placement = (np.arange(16) // 4).astype(np.int32)
    _, di = _plan_both(3, placement, 4, strategy="diff-comm")
    _, gi = _plan_both(3, placement, 4, strategy="greedy")
    assert di["moved_experts"] <= gi["moved_experts"]


def test_perm_roundtrip():
    placement = np.array([1, 0, 0, 1, 2, 3, 3, 2], np.int32)
    perm = t_eb.placement_to_perm(placement, 4)
    np.testing.assert_array_equal(perm, j_eb.placement_to_perm(placement, 4))
    # slot r*2+i holds a logical expert that placement maps to rank r
    for s, e in enumerate(perm):
        assert placement[e] == s // 2


def test_apply_perm_preserves_moe_semantics():
    """Permuted weights + permuted router columns == identical MoE output;
    the gathered tensors equal the JAX package's exactly."""
    cfg = dataclasses.replace(get_arch("deepseek-v3-671b").reduced,
                              compute_dtype="float32")
    rng = np.random.default_rng(0)
    np_params = tree_map(lambda s: (rng.normal(size=s.shape) * 0.3).astype(
        np.float32), t_moe.moe_specs(cfg))
    params = tree_map(torch.tensor, np_params)
    x = torch.tensor(rng.normal(size=(2, 8, cfg.d_model)).astype(np.float32))
    y0, _ = t_moe.moe_dense(params, cfg, x)
    perm = np.array([3, 1, 0, 2, 7, 6, 5, 4])
    permuted = t_eb.apply_perm_to_params(params, perm)
    y1, _ = t_moe.moe_dense(permuted, cfg, x)
    np.testing.assert_allclose(y0.numpy(), y1.numpy(), rtol=2e-4, atol=2e-4)
    want = j_eb.apply_perm_to_params(
        {k: jnp.asarray(v) for k, v in np_params.items()}, perm)
    for k, v in want.items():
        np.testing.assert_array_equal(permuted[k].numpy(), np.asarray(v),
                                      err_msg=k)


def test_migration_bytes_counts_cross_rank_moves():
    old = np.arange(8)
    new = np.array([1, 0, 2, 3, 4, 5, 6, 7])      # swap within rank 0: free
    assert t_eb.migration_bytes(old, new, 100.0, 4) == 0.0
    new2 = np.array([2, 1, 0, 3, 4, 5, 6, 7])     # 0<->2 crosses ranks 0/1
    assert t_eb.migration_bytes(old, new2, 100.0, 4) == 200.0
    assert t_eb.migration_bytes(old, new2, 100.0, 4) == \
        j_eb.migration_bytes(old, new2, 100.0, 4)


def test_colocation_of_coactivated_experts():
    """Experts that always fire together and are already colocated with
    balanced load: nothing moves (both packages)."""
    E, R = 8, 4
    ids = np.array([[0, 4], [1, 5], [2, 6], [3, 7]] * 64)
    placement = np.array([0, 1, 2, 3, 0, 1, 2, 3], np.int32)
    for pkg, kw in ((t_eb, dict(device=CPU)), (j_eb, {})):
        stats = pkg.ExpertStats(E, ema=0.0)
        stats.update(ids)
        stats.tokens = stats.tokens + np.linspace(0, 1, E)  # break ties
        new, info = pkg.plan_placement(stats, placement, R, **kw)
        assert info["moved_experts"] == 0


# --------------------------------------------------- vectorized statistics --


@pytest.mark.parametrize("E,k,T,seed", [(8, 2, 64, 0), (16, 4, 256, 1),
                                        (32, 3, 128, 2), (4, 4, 512, 3)])
def test_pair_stats_vectorized_matches_loop(E, k, T, seed):
    """The one-shot CᵀC−diag update equals the O(k²) pair loop and the JAX
    package's, duplicate ids in a row included."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, E, size=(T, k))
    c_vec, co_vec = t_eb.pair_stats_np(ids, E)
    c_loop, co_loop = t_eb.pair_stats_loop(ids, E)
    np.testing.assert_array_equal(c_vec, c_loop)
    np.testing.assert_array_equal(co_vec, co_loop)
    np.testing.assert_array_equal(co_vec, co_vec.T)
    c_j, co_j = j_eb.pair_stats_np(ids, E)
    np.testing.assert_array_equal(c_vec, c_j)
    np.testing.assert_array_equal(co_vec, co_j)


def test_pair_stats_device_matches_host():
    """``models.moe.pair_stats`` computes the statistics the host twin
    computes, exactly."""
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 16, size=(128, 4))
    st = t_moe.pair_stats(torch.as_tensor(ids), 16)
    c_np, co_np = t_eb.pair_stats_np(ids, 16)
    np.testing.assert_array_equal(st.counts.numpy(), c_np)
    np.testing.assert_array_equal(st.coact.numpy(), co_np)


def test_update_from_counts_matches_update():
    rng = np.random.default_rng(5)
    a = t_eb.ExpertStats(8, ema=0.7)
    b = t_eb.ExpertStats(8, ema=0.7)
    for _ in range(4):
        ids = rng.integers(0, 8, size=(64, 2))
        a.update(ids)
        c, co = t_eb.pair_stats_np(ids, 8)
        b.update_from_counts(torch.as_tensor(c), co)
    np.testing.assert_allclose(a.tokens, b.tokens)
    np.testing.assert_allclose(a.coact, b.coact)


# ------------------------------------------------------- capacity repair --


@pytest.mark.parametrize("seed", range(4))
def test_repair_capacity_is_exact(seed):
    """Exactly E/R a rank, experts on ranks within the budget stay, and
    the repair equals the JAX package's ``repair_capacity``."""
    E, R = 24, 4
    rng = np.random.default_rng(seed)
    a = rng.integers(0, R, size=E).astype(np.int32)
    loads = rng.uniform(0.1, 5.0, size=E).astype(np.float32)
    out = t_eb.repair_capacity(torch.as_tensor(a), torch.as_tensor(loads),
                               num_ranks=R, cap=E // R)
    assert out.dtype == torch.int32
    out = out.numpy()
    assert (np.bincount(out, minlength=R) == E // R).all()
    counts = np.bincount(a, minlength=R)
    for e in range(E):
        if counts[a[e]] <= E // R:
            assert out[e] == a[e]
    want = np.asarray(j_eb.repair_capacity(a, loads, num_ranks=R,
                                           cap=E // R))
    np.testing.assert_array_equal(out, want)


def test_repair_capacity_evicts_lightest_first():
    # rank 0 holds 5 experts (cap 2); the three lightest must leave
    a = np.array([0, 0, 0, 0, 0, 1, 2, 3], np.int32)
    loads = np.array([5.0, 1.0, 4.0, 2.0, 3.0, 1.0, 1.0, 1.0], np.float32)
    out = t_eb.repair_capacity(a, loads, num_ranks=4, cap=2).numpy()
    assert (np.bincount(out, minlength=4) == 2).all()
    assert out[0] == 0 and out[2] == 0          # heaviest two stay
    assert set(np.nonzero(out != a)[0]) == {1, 3, 4}
    np.testing.assert_array_equal(out, np.asarray(
        j_eb.repair_capacity(a, loads, num_ranks=4, cap=2)))


@pytest.mark.parametrize("seed", range(3))
def test_repair_capacity_ties_and_repeats(seed):
    """Equal loads (ties go to the lowest index, the stable sort's rule)
    and zero loads: the JAX package's repair exactly, the same on a second
    call, and a fixed point on a capacity-exact placement."""
    E, R = 32, 8
    rng = np.random.default_rng(10 + seed)
    a = rng.integers(0, R // 2, size=E).astype(np.int32)   # half the ranks
    loads = rng.integers(0, 3, size=E).astype(np.float32)   # many ties
    want = np.asarray(j_eb.repair_capacity(a, loads, num_ranks=R,
                                           cap=E // R))
    got = t_eb.repair_capacity(torch.as_tensor(a), torch.as_tensor(loads),
                               num_ranks=R, cap=E // R)
    np.testing.assert_array_equal(got.numpy(), want)
    again = t_eb.repair_capacity(torch.as_tensor(a), torch.as_tensor(loads),
                                 num_ranks=R, cap=E // R)
    assert torch.equal(got, again)
    fixed = t_eb.repair_capacity(got, torch.as_tensor(loads), num_ranks=R,
                                 cap=E // R)
    assert torch.equal(fixed, got)


# ------------------------------------------------------ strategy registry --


def test_plan_placement_accepts_registered_strategies():
    """plan_placement routes through the Strategy registry: the ``greedy``
    alias, the registered ``ep-greedy`` and the diff-* names, each equal
    to the JAX package's plan."""
    assert "ep-greedy" in t_engine.available()
    placement = (np.arange(16) // 4).astype(np.int32)
    for name in ("greedy", "ep-greedy", "diff-comm",
                 "diff-comm+predictive"):
        new, _ = _plan_both(11, placement, 4, strategy=name)
        assert (np.bincount(new, minlength=4) == 4).all(), name


def test_greedy_alias_matches_registered_greedy():
    placement = (np.arange(16) // 4).astype(np.int32)
    a, _ = _plan_both(13, placement, 4, strategy="greedy")
    b, _ = _plan_both(13, placement, 4, strategy="ep-greedy")
    np.testing.assert_array_equal(a, b)
    assert t_eb._ALIASES == j_eb._ALIASES
    g = t_eb.greedy_placement(_skewed_stats(t_eb, seed=13), 4)
    np.testing.assert_array_equal(
        g, j_eb.greedy_placement(_skewed_stats(j_eb, seed=13), 4))
    assert (np.bincount(g, minlength=4) == 4).all()
