"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's on the CPU, on the reduced deepseek-v3 (8 experts top-2, one
shared expert) and llama4-scout (4 experts top-1, one shared) configs,
the same weights and inputs on both sides (NumPy, seeded).

Tolerances: routing ids, token counts and co-activations exact (small
integers in f32); outputs and aux within 1e-5 in f32, 2e-2 in bf16."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import moe as j_moe
from repro.models import transformer as jt
from repro_torch.configs import get_arch
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as tt
from repro_torch.models.params import tree_map

ARCHS = ["deepseek-v3-671b", "llama4-scout-17b-a16e"]


def _cfg(arch, dtype="float32"):
    return dataclasses.replace(get_arch(arch).reduced, compute_dtype=dtype)


def _params(cfg, seed, scale=0.3):
    """MoE weights from the port's spec shapes, normal × ``scale`` (NumPy;
    ``None``: each spec's own init scale)."""
    rng = np.random.default_rng(seed)
    return tree_map(lambda s: (rng.normal(size=s.shape) * (
        s.scale if scale is None else scale)).astype(np.float32),
        t_moe.moe_specs(cfg))


def _both(np_tree):
    return (jax.tree.map(jnp.asarray, np_tree),
            tree_map(torch.tensor, np_tree))


@pytest.mark.parametrize("T,k,E", [(64, 8, 32), (100, 2, 8), (7, 1, 4),
                                   (512, 8, 256)])
def test_pair_stats_exact(T, k, E):
    """Counts and co-activations equal the JAX package's and the
    ordered-pair loop over each token's ids, exactly."""
    rng = np.random.default_rng(T + k)
    ids = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(
        np.int32)
    got = t_moe.pair_stats(torch.tensor(ids), E)
    want = j_moe.pair_stats(jnp.asarray(ids), E)
    loop_c = np.zeros(E, np.float32)
    loop_x = np.zeros((E, E), np.float32)
    for row in ids:
        np.add.at(loop_c, row, 1.0)
        for a in row:
            for b in row:
                if a != b:
                    loop_x[a, b] += 1.0
    for g, w, o in ((got.counts, want.counts, loop_c),
                    (got.coact, want.coact, loop_x)):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), o)
    assert float(got.counts.sum()) == T * k
    zero = t_moe.zero_router_stats(E, "cpu")
    assert zero.counts.shape == (E,) and zero.coact.shape == (E, E)


def test_router_breaks_ties_to_the_lowest_index():
    """Equal router probabilities: top-k takes the lowest expert index
    first, as ``lax.top_k`` does; ids equal JAX's, weights and aux within
    1e-6."""
    cfg = dataclasses.replace(_cfg("deepseek-v3-671b"),
                              moe=dataclasses.replace(
                                  get_arch("deepseek-v3-671b").reduced.moe,
                                  top_k=3))
    E, D = cfg.moe.num_experts, cfg.d_model
    rng = np.random.default_rng(0)
    base = rng.normal(size=(D, 3)).astype(np.float32)
    # experts 1, 4 and 6 share a column, 0 and 5 another, 2 and 7 a third
    router = base[:, [1, 0, 2, 2, 0, 1, 0, 2]].copy()
    router[:, 3] = 0.0
    x = rng.normal(size=(40, D)).astype(np.float32)
    x[:5] = 0.0                              # every expert ties
    wj, ij, aj = j_moe._router(dict(router=jnp.asarray(router)), cfg,
                               jnp.asarray(x))
    wt, it, at = t_moe._router(dict(router=torch.tensor(router)), cfg,
                               torch.tensor(x))
    assert it.dtype == torch.int32
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(it[:5].numpy(), [[0, 1, 2]] * 5)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-6)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_matches_jax(arch):
    """``moe_dense`` → (y, aux, RouterStats) against JAX in f32: y within
    1e-5, aux within 1e-6, the stats exact; ``moe_ffn`` with every impl
    (no mesh) computes the same."""
    cfg = _cfg(arch)
    jcfg = dataclasses.replace(j_get_arch(arch).reduced,
                               compute_dtype="float32")
    jp, tp = _both(_params(cfg, 1))
    x = np.random.default_rng(2).normal(size=(3, 11, cfg.d_model)).astype(
        np.float32)
    yj, aj, sj = j_moe.moe_dense(jp, jcfg, jnp.asarray(x),
                                 collect_stats=True)
    yt, at, st = t_moe.moe_dense(tp, cfg, torch.tensor(x),
                                 collect_stats=True)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(at), float(aj), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(st.counts.numpy(), np.asarray(sj.counts))
    np.testing.assert_array_equal(st.coact.numpy(), np.asarray(sj.coact))
    assert float(st.counts.sum()) == 3 * 11 * cfg.moe.top_k
    for impl in ("auto", "a2a", "dense"):
        y, a = t_moe.moe_ffn(tp, cfg, torch.tensor(x), impl=impl)
        assert torch.equal(y, yt) and torch.equal(a, at)
    yj2, _ = j_moe.moe_ffn(jp, jcfg, jnp.asarray(x), impl="a2a")
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj2), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_dense_bf16_matches_jax(arch):
    """bf16 compute with the specs' own init scales, at the JAX model
    test's 2e-2; the f32 router picks the same experts."""
    cfg = _cfg(arch, "bfloat16")
    jcfg = dataclasses.replace(j_get_arch(arch).reduced,
                               compute_dtype="bfloat16")
    jp, tp = _both(_params(cfg, 3, scale=None))
    x = (np.random.default_rng(4).normal(size=(2, 9, cfg.d_model))
         .astype(np.float32))
    yj, _, sj = j_moe.moe_dense(jp, jcfg, jnp.asarray(x, jnp.bfloat16),
                                collect_stats=True)
    yt, _, st = t_moe.moe_dense(tp, cfg, torch.tensor(x).bfloat16(),
                                collect_stats=True)
    assert yt.dtype == torch.bfloat16
    np.testing.assert_allclose(yt.float().numpy(),
                               np.asarray(yj, np.float32), atol=2e-2,
                               rtol=2e-2)
    np.testing.assert_array_equal(st.counts.numpy(), np.asarray(sj.counts))


def test_collect_router_stats_through_the_stack():
    """``forward(collect_router_stats=True)`` sums the aux scalar and the
    routing statistics over every MoE layer, as the JAX package's forward
    does: counts sum to tokens × top_k × MoE layers, exactly equal to
    JAX's; attention-only layers add zeros."""
    from repro.models.params import init_params as j_init
    from repro_torch import interop

    arch = "deepseek-v3-671b"
    cfg = _cfg(arch)
    jcfg = dataclasses.replace(j_get_arch(arch).reduced,
                               compute_dtype="float32")
    jparams = j_init(jt.model_specs(jcfg), 0)
    tparams = interop.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        cfg, "cpu")
    rng = np.random.default_rng(5)
    tok = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10)).copy()
    j_forward = jax.jit(functools.partial(jt.forward,
                                          collect_router_stats=True),
                        static_argnums=1)
    _, _, (aj, sj) = j_forward(jparams, jcfg, dict(
        tokens=jnp.asarray(tok), positions=jnp.asarray(pos)))
    _, _, (at, st) = tt.forward(tparams, cfg, dict(
        tokens=torch.tensor(tok), positions=torch.tensor(pos)),
        collect_router_stats=True, with_aux=True)
    n_moe = sum(k.startswith("moe") for k in cfg.all_layers())
    assert n_moe == 2
    assert float(st.counts.sum()) == 2 * 10 * cfg.moe.top_k * n_moe
    np.testing.assert_array_equal(st.counts.numpy(), np.asarray(sj.counts))
    np.testing.assert_array_equal(st.coact.numpy(), np.asarray(sj.coact))
    np.testing.assert_allclose(float(at), float(aj), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="MoE"):
        tt.zero_aux(get_arch("smollm-135m").reduced, True, "cpu")
