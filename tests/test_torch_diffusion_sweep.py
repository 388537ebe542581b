"""What the streaming sweep kernel K2 must reproduce, pinned on the CPU.

The port's plain sweep (the CPU path of ``ops.diffusion_sweep`` and K2's
oracle on the card) against the JAX package's ``reference_sweep`` and
``diffusion_sweep_pallas`` (interpret mode) on tables that are not
symmetric: padded slots, one-way edges (``reverse_slots`` leaves rev = 0,
and the sweep receives push[j, 0], j's push to another node) and masked-in
slots whose reverse slot is masked out.  Then the identity K2 is built on:
every stored push, and every received one, recomputed from the loads, the
row scales and the table pass's words (``sweep_tables_ref``), bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import virtual_lb as j_vlb
from repro.kernels.diffusion.kernel import diffusion_sweep_pallas
from repro_torch.core import virtual_lb as t_vlb
from repro_torch.kernels.diffusion import ops as t_dops
from repro_torch.kernels.diffusion.ref import (diffusion_sweep_ref,
                                               sweep_tables_ref)
from tests.test_torch_cuda_kernels import _skewed_graph

SHAPES = [(64, 5), (256, 8), (64, 32)]


def _case(P, K, seed):
    nbr, mask = _skewed_graph(P, K, seed)
    rng = np.random.default_rng(seed)
    x = (rng.random(P) * 10).astype(np.float32)
    own = (x * rng.random(P)).astype(np.float32)
    return x, own, nbr, mask


@pytest.mark.parametrize("P,K", SHAPES)
def test_skewed_tables_hold_every_case(P, K):
    """The tables hold padded slots, one-way slots with rev = 0 and
    masked-in slots whose reverse slot is masked out; the port's
    ``reverse_slots`` equals the JAX package's."""
    _, _, nbr, mask = _case(P, K, seed=P + K)
    rev = t_vlb.reverse_slots(torch.as_tensor(nbr), torch.as_tensor(mask))
    np.testing.assert_array_equal(
        rev.numpy(), np.asarray(j_vlb.reverse_slots(jnp.asarray(nbr),
                                                    jnp.asarray(mask))))
    rev = rev.numpy()
    j = np.where(mask, nbr, 0)
    back = nbr[j, rev] == np.arange(P)[:, None]
    assert (~mask & (nbr < 0)).any()
    assert (mask & ~back & (rev == 0)).any()
    assert (mask & back & ~mask[j, rev]).any()


@pytest.mark.parametrize("P,K", SHAPES)
@pytest.mark.parametrize("single_hop", [True, False])
def test_plain_sweep_matches_jax_on_skewed_tables(P, K, single_hop):
    """Every output within 4 f32 ulp of the largest load of JAX's
    ``reference_sweep`` and of ``diffusion_sweep_pallas`` in interpret
    mode (the row sums over K run in another order)."""
    x, own, nbr, mask = _case(P, K, seed=P + K)
    rev = np.asarray(j_vlb.reverse_slots(jnp.asarray(nbr),
                                         jnp.asarray(mask)))
    alpha = np.float32(1.0 / (K + 1.0))
    tin = [torch.as_tensor(np.array(a)) for a in (x, own, nbr, mask, rev)]
    got = t_dops.diffusion_sweep(*tin, float(alpha), single_hop)
    for a, b in zip(got, diffusion_sweep_ref(*tin, float(alpha),
                                             single_hop)):
        assert torch.equal(a, b)
    jin = [jnp.asarray(a) for a in (x, own, nbr, mask, rev)]
    tol = 4 * np.spacing(np.float32(x.max()))
    for want in (j_vlb.reference_sweep(*jin, alpha, single_hop),
                 diffusion_sweep_pallas(*jin, alpha, single_hop,
                                        interpret=True)):
        for a, b in zip(got, want):
            assert a.shape == tuple(b.shape)
            assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= tol


@pytest.mark.parametrize("P,K", SHAPES + [(40, 3)])
def test_sweep_tables_ref_matches_a_loop(P, K):
    """The table pass's plain version: bit k of row i's first word is
    mask[i, k]; of its second, mask[i, k] and nbr[j, rev[i, k]] == i and
    mask[j, rev[i, k]] for j = nbr[i, k]."""
    _, _, nbr, mask = _case(P, K, seed=K)
    rev = t_vlb.reverse_slots(torch.as_tensor(nbr),
                              torch.as_tensor(mask)).numpy()
    want = np.zeros((2, P), np.uint32)
    for i in range(P):
        for k in range(K):
            if not mask[i, k]:
                continue
            want[0, i] |= np.uint32(1 << k)
            j, r = nbr[i, k], rev[i, k]
            if nbr[j, r] == i and mask[j, r]:
                want[1, i] |= np.uint32(1 << k)
    got = sweep_tables_ref(torch.as_tensor(nbr), torch.as_tensor(mask),
                           torch.as_tensor(rev))
    assert got.dtype == torch.int32 and got.shape == (2, P)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("P,K", SHAPES)
@pytest.mark.parametrize("single_hop", [True, False])
def test_recomputed_pushes_equal_the_stored_ones(P, K, single_hop):
    """K2 keeps no push matrix: the push of slot (i, k) is recomputed as
    max(alpha (x_i - x_j), 0) sigma_i, and the push it receives as
    max(alpha (x_j - x_i), 0) sigma_j where the reciprocity bit is set,
    else from j's slot rev[i, k] (nbr, mask bit) as stored.  Both equal
    the plain sweep's matrices bit for bit, sigma being the plain row
    scale."""
    x, own, nbr, mask = (torch.as_tensor(a) for a in _case(P, K, P + K))
    rev = t_vlb.reverse_slots(nbr, mask)
    alpha = float(np.float32(1.0 / (K + 1.0)))
    # the plain sweep's push and recv (core/virtual_lb.py reference_sweep)
    safe = torch.where(mask, nbr, 0).long()
    xn = torch.where(mask, x[safe], x[:, None])
    push = torch.clamp(alpha * (x[:, None] - xn), min=0.0) * mask
    sigma = torch.ones(P)
    if single_hop:
        tot = push.sum(dim=1)
        sigma = torch.where(tot > 0,
                            torch.clamp(own / (tot + 1e-30), max=1.0), 1.0)
        push = push * sigma[:, None]
    flat = safe * K + torch.where(mask, rev, 0).long()
    recv = torch.where(mask, push.reshape(-1)[flat], 0.0)

    words = sweep_tables_ref(nbr, mask, rev).long() & 0xffffffff
    bit = torch.arange(K)
    recip = ((words[1][:, None] >> bit) & 1).bool()
    assert torch.equal(((words[0][:, None] >> bit) & 1).bool(), mask)
    xj = x[safe]
    own_push = torch.where(
        mask, torch.clamp(alpha * (x[:, None] - xj), min=0.0), 0.0)
    r = torch.where(mask, rev, 0).long()
    j_mask = ((words[0][safe] >> r) & 1).bool()
    j_nbr = nbr.reshape(-1)[safe * K + r].long()
    back = torch.where(
        recip, torch.clamp(alpha * (xj - x[:, None]), min=0.0),
        torch.where(j_mask, torch.clamp(
            alpha * (xj - x[torch.where(j_mask, j_nbr, 0)]), min=0.0), 0.0))
    back = torch.where(mask, back, 0.0)
    if single_hop:
        own_push = own_push * sigma[:, None]
        back = back * sigma[safe]
    assert (mask & ~recip).any()
    assert torch.equal(own_push, push)
    assert torch.equal(back, recv)


def test_held_tables_follow_the_tensors_and_their_versions():
    """The streaming wrappers skip the table pass (and the chunk its
    copies) only for the last call's tensors, unchanged: not for equal
    values in other tensors, not after an in-place write, and never for
    inference tensors (no version counter)."""
    nbr = torch.arange(12, dtype=torch.int32).reshape(4, 3)
    mask = torch.ones((4, 3), dtype=torch.bool)
    rev = torch.zeros((4, 3), dtype=torch.int32)
    held = t_dops._HeldTables()
    assert not held.same((nbr, mask, rev))
    held.hold((nbr, mask, rev))
    assert held.same((nbr, mask, rev))
    assert not held.same((nbr.clone(), mask, rev))
    assert not held.same((nbr, mask))
    mask[0, 0] = False
    assert not held.same((nbr, mask, rev))
    held.hold((nbr, mask, rev))
    assert held.same((nbr, mask, rev))
    with torch.inference_mode():
        frozen = torch.zeros((4, 3), dtype=torch.int32)
    held.hold((frozen, mask, rev))
    assert not held.same((frozen, mask, rev))
