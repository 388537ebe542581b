"""The port's recurrent blocks (``repro_torch.models.ssm``: mamba, mLSTM,
sLSTM) against the JAX package's on the CPU, on the reduced hymba-1.5b
(5 heads of 10, state 4) and xlstm-125m (2 heads of 24) configs, with the
same weights and inputs on both sides (NumPy, seeded).  The weights are
drawn at a larger scale than the model's init (normal × 0.3, gate biases
and ``A_log`` random too), so that gates, decays and the chunked sums are
exercised away from their initial values.

Tolerances (f32): outputs and final states within 1e-5 relative, and
1e-5 of their largest magnitude absolute (at these weights mamba's outputs
reach a few hundred, where f32 rounding in the two packages' different
summation orders is ~1e-5); the stepwise decode against the full-sequence
form within 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import ssm as j_ssm
from repro_torch.configs import get_arch
from repro_torch.models import ssm as t_ssm
from repro_torch.models.params import tree_map

CELLS = {"mamba": "hymba-1.5b", "mlstm": "xlstm-125m", "slstm": "xlstm-125m"}


def _setup(cell, seed=0):
    arch = CELLS[cell]
    jcfg = dataclasses.replace(j_get_arch(arch).reduced,
                               compute_dtype="float32")
    tcfg = dataclasses.replace(get_arch(arch).reduced,
                               compute_dtype="float32")
    rng = np.random.default_rng(seed)
    specs = getattr(t_ssm, f"{cell}_specs")(tcfg)
    p = tree_map(lambda s: ((1.0 if s.init == "ones" else 0.0)
                            + rng.normal(size=s.shape) * 0.3)
                 .astype(np.float32), specs)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, p),
            tree_map(torch.tensor, p))


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def _close(got, want, tol=1e-5):
    got = tree_map(lambda t: t.numpy(), got)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w[np.abs(w) < 1e29]).max(initial=0)))
        np.testing.assert_allclose(g, w, atol=tol * scale, rtol=tol)


def _state(cell, cfg, B):
    return getattr(t_ssm, f"{cell}_init_state")(cfg, B, device="cpu")


@pytest.mark.parametrize("cell", list(CELLS))
def test_specs_and_initial_states_match_jax(cell):
    """The same parameter names and shapes, and the same f32 initial
    states (mLSTM's and sLSTM's stabilizer at -1e30)."""
    from repro.models.params import ParamSpec as JSpec

    jcfg, tcfg, _, _ = _setup(cell)
    want = jax.tree.map(lambda s: s.shape,
                        getattr(j_ssm, f"{cell}_specs")(jcfg),
                        is_leaf=lambda s: isinstance(s, JSpec))
    got = tree_map(lambda s: s.shape, getattr(t_ssm, f"{cell}_specs")(tcfg))
    assert got == want
    js = getattr(j_ssm, f"{cell}_init_state")(jcfg, 3, jnp.bfloat16)
    ts = _state(cell, tcfg, 3)
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(
        tree_map(lambda t: t, ts)))
    _close(ts, js, 0.0)


@pytest.mark.parametrize("S,chunk", [(20, 8), (16, 256), (7, 4)])
def test_mamba_forward_matches_jax(S, chunk):
    """The chunked selective scan (padding the last chunk where S is not
    a multiple), from zeros and from a carried state."""
    jcfg, tcfg, jp, tp = _setup("mamba")
    x = _x(tcfg, 2, S, 1)
    yj, hj = j_ssm.mamba_forward(jp, jcfg, jnp.asarray(x), chunk=chunk)
    yt, ht = t_ssm.mamba_forward(tp, tcfg, torch.tensor(x), chunk=chunk)
    _close((yt, ht), (yj, hj))
    x2 = _x(tcfg, 2, 5, 2)
    yj, hj2 = j_ssm.mamba_forward(jp, jcfg, jnp.asarray(x2), hj, chunk=chunk)
    yt, ht2 = t_ssm.mamba_forward(tp, tcfg, torch.tensor(x2), ht,
                                  chunk=chunk)
    _close((yt, ht2), (yj, hj2))


@pytest.mark.parametrize("cell", list(CELLS))
def test_step_matches_jax_and_the_full_sequence(cell):
    """Single-token steps from a prefill's state: each step against JAX's
    (1e-5), and the steps' outputs and final state against the
    full-sequence form over the whole input (1e-4)."""
    jcfg, tcfg, jp, tp = _setup(cell, 3)
    fwd_j = getattr(j_ssm, f"{cell}_forward")
    step_j = getattr(j_ssm, f"{cell}_step")
    fwd_t = getattr(t_ssm, f"{cell}_forward")
    step_t = getattr(t_ssm, f"{cell}_step")
    B, S, plen = 2, 14, 9
    x = _x(tcfg, B, S, 4)
    _, sj = fwd_j(jp, jcfg, jnp.asarray(x[:, :plen]))
    _, st = fwd_t(tp, tcfg, torch.tensor(x[:, :plen]))
    _close(st, sj)
    ys = []
    for i in range(plen, S):
        yj, sj = step_j(jp, jcfg, jnp.asarray(x[:, i:i + 1]), sj)
        yt, st = step_t(tp, tcfg, torch.tensor(x[:, i:i + 1]), st)
        _close((yt, st), (yj, sj))
        ys.append(yt)
    y_full, s_full = fwd_t(tp, tcfg, torch.tensor(x))
    torch.testing.assert_close(torch.cat(ys, 1), y_full[:, plen:],
                               atol=1e-4, rtol=1e-4)
    for a, b in zip(jax.tree.leaves(tree_map(lambda t: t, st)),
                    jax.tree.leaves(tree_map(lambda t: t, s_full))):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("S,chunk", [(20, 8), (13, 256), (9, 4)])
def test_mlstm_forward_matches_jax(S, chunk):
    """The chunkwise-parallel mLSTM (stabilized log-space gates; the last
    chunk padded with no input and full forget), from zeros and from a
    carried state."""
    jcfg, tcfg, jp, tp = _setup("mlstm", 5)
    x = _x(tcfg, 2, S, 6)
    yj, sj = j_ssm.mlstm_forward(jp, jcfg, jnp.asarray(x), chunk=chunk)
    yt, st = t_ssm.mlstm_forward(tp, tcfg, torch.tensor(x), chunk=chunk)
    _close((yt, st), (yj, sj))
    x2 = _x(tcfg, 2, 6, 7)
    yj, sj = j_ssm.mlstm_forward(jp, jcfg, jnp.asarray(x2), sj, chunk=chunk)
    yt, st = t_ssm.mlstm_forward(tp, tcfg, torch.tensor(x2), st,
                                 chunk=chunk)
    _close((yt, st), (yj, sj))


def test_slstm_forward_matches_jax():
    """The sLSTM step loop over a sequence (the four recurrent products
    fused into one), from zeros and from a carried state."""
    jcfg, tcfg, jp, tp = _setup("slstm", 8)
    x = _x(tcfg, 3, 11, 9)
    yj, sj = j_ssm.slstm_forward(jp, jcfg, jnp.asarray(x))
    yt, st = t_ssm.slstm_forward(tp, tcfg, torch.tensor(x))
    _close((yt, st), (yj, sj))
    yj, sj = j_ssm.slstm_forward(jp, jcfg, jnp.asarray(x[:, :4]), sj)
    yt, st = t_ssm.slstm_forward(tp, tcfg, torch.tensor(x[:, :4]), st)
    _close((yt, st), (yj, sj))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_headwise_rmsnorm_matches_jax(dtype):
    y = np.random.default_rng(10).normal(size=(2, 3, 4, 24)).astype(
        np.float32)
    w = np.random.default_rng(11).normal(size=24).astype(np.float32)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = j_ssm._headwise_rmsnorm(jnp.asarray(y, jd), jnp.asarray(w))
    got = t_ssm._headwise_rmsnorm(torch.tensor(y).to(dtype), torch.tensor(w))
    assert got.dtype == dtype
    tol = 1e-6 if dtype == torch.float32 else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
