"""The PyTorch port's plain kernel versions against the JAX package's
Pallas kernels (interpret mode) and their jitted JAX references, on the CPU.

Inputs are made once with numpy from a seed and handed to both packages.
The port's wrappers take these plain versions for CPU tensors; on the card
they launch the CUDA kernels, which ``tests/test_torch_cuda_kernels.py``
holds against the same plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import virtual_lb as j_vlb
from repro.kernels.diffusion.kernel import diffusion_nsweeps_pallas
from repro.kernels.histogram.kernel import histogram_pallas
from repro.kernels.histogram.ref import histogram_ref as j_histogram_ref
from repro.kernels.migrate import ops as j_mig_ops
from repro.kernels.migrate.kernel import scatter_dest_pallas
from repro.kernels.migrate.ref import bucket_ranks_ref as j_bucket_ranks_ref
from repro.kernels.migrate.ref import scatter_dest_ref as j_scatter_dest_ref
from repro.kernels.pic_push.kernel import pic_push_pallas
from repro.kernels.pic_push.ref import pic_push_ref as j_pic_push_ref
from repro.pic.grid import alternating_grid
from repro_torch.core import virtual_lb as t_vlb
from repro_torch.kernels.diffusion import ops as t_dops
from repro_torch.kernels.histogram import ops as t_hops
from repro_torch.kernels.histogram.ref import histogram_ref
from repro_torch.kernels.migrate import ops as t_mops
from repro_torch.kernels.migrate.ref import (bucket_counts_ref,
                                             bucket_ranks_ref,
                                             scatter_dest_ref)
from repro_torch.kernels.pic_push import ops as t_pops
from repro_torch.kernels.pic_push.ref import pic_push_ref
from tests.conftest import random_symmetric_graph


def _spacing_at_max(b):
    b = np.asarray(b, np.float32)
    return np.spacing(np.float32(np.abs(b).max()))


def _carry_close(got, want, x0, n_ulp=16):
    """``it``/``stall`` equal; x, own and flow within ``n_ulp`` f32 ulp of
    the largest initial load, and res — a deviation over the mean load,
    where the deviation cancels — within that over the mean load."""
    assert int(got[3]) == int(want[3])
    assert int(got[5]) == int(want[5])
    tol = n_ulp * _spacing_at_max(x0)
    for i in (0, 1, 2):
        assert np.abs(got[i].numpy() - np.asarray(want[i])).max() <= tol, i
    assert abs(float(got[4]) - float(want[4])) <= tol / float(x0.mean())


# ------------------------------------------------------------- diffusion --

# the JAX reference as the production CPU path runs it: compiled
_j_nsweeps = jax.jit(j_vlb.reference_nsweeps,
                     static_argnames=("n_sweeps", "single_hop", "tol",
                                      "max_iters"))


def _nsweeps_inputs(P, K):
    nbr, mask = random_symmetric_graph(P, K, seed=P + K)
    x = (np.random.default_rng(P).random(P) * 10).astype(np.float32)
    return nbr, mask, x


@pytest.mark.parametrize("P,K", [(64, 4), (100, 4), (257, 8), (100, 8)])
@pytest.mark.parametrize("single_hop", [True, False])
@pytest.mark.parametrize("tol,S", [(0.02, 8), (-1.0, 5)])
def test_diffusion_plain_matches_jitted_reference(P, K, single_hop, tol, S):
    """K1's plain chunk vs the jitted ``reference_nsweeps``: ``it`` and
    ``stall`` exact; floats within 16 f32 ulp of the largest load (row sums
    over K and means over P are taken in another order; see
    :func:`_carry_close`).  ``tol=-1`` keeps all S sweeps active."""
    nbr, mask, x = _nsweeps_inputs(P, K)
    alpha = np.float32(1.0 / (K + 1.0))
    j_rev = j_vlb.reverse_slots(jnp.asarray(nbr), jnp.asarray(mask))
    j_res = j_vlb.neighborhood_residual(jnp.asarray(x), jnp.asarray(nbr),
                                        jnp.asarray(mask))
    kw = dict(n_sweeps=S, single_hop=single_hop, tol=tol, max_iters=512)
    want = _j_nsweeps(jnp.asarray(x), jnp.asarray(x * 0.7),
                      jnp.zeros((P, K), jnp.float32), jnp.int32(0), j_res,
                      jnp.int32(0), jnp.asarray(nbr), jnp.asarray(mask),
                      j_rev, alpha, **kw)
    tn, tm = torch.as_tensor(nbr), torch.as_tensor(mask)
    t_rev = t_vlb.reverse_slots(tn, tm)
    np.testing.assert_array_equal(t_rev.numpy(), np.asarray(j_rev))
    tx = torch.as_tensor(x)
    t_res = t_vlb.neighborhood_residual(tx, tn, tm)
    got = t_dops.diffusion_nsweeps(
        tx, tx * 0.7, torch.zeros((P, K)), torch.tensor(0, dtype=torch.int32),
        t_res, torch.tensor(0, dtype=torch.int32), tn, tm, t_rev,
        float(alpha), **kw)
    _carry_close(got, want, x)


@pytest.mark.parametrize("P,K", [(64, 4), (257, 8)])
def test_diffusion_plain_matches_pallas_interpret(P, K):
    """The same chunk vs the fused Pallas kernel in interpret mode."""
    nbr, mask, x = _nsweeps_inputs(P, K)
    alpha = np.float32(1.0 / (K + 1.0))
    j_rev = j_vlb.reverse_slots(jnp.asarray(nbr), jnp.asarray(mask))
    j_res = j_vlb.neighborhood_residual(jnp.asarray(x), jnp.asarray(nbr),
                                        jnp.asarray(mask))
    kw = dict(n_sweeps=8, single_hop=True, tol=0.02, max_iters=512)
    want = diffusion_nsweeps_pallas(
        jnp.asarray(x), jnp.asarray(x), jnp.zeros((P, K), jnp.float32),
        jnp.int32(0), j_res, jnp.int32(0), jnp.asarray(nbr),
        jnp.asarray(mask), j_rev, alpha, interpret=True, **kw)
    tx, tn, tm = (torch.as_tensor(a) for a in (x, nbr, mask))
    got = t_dops.diffusion_nsweeps(
        tx, tx, torch.zeros((P, K)), torch.tensor(0, dtype=torch.int32),
        t_vlb.neighborhood_residual(tx, tn, tm),
        torch.tensor(0, dtype=torch.int32), tn, tm,
        t_vlb.reverse_slots(tn, tm), float(alpha), **kw)
    _carry_close(got, want, x)


# --------------------------------------------------------------- migrate --


@pytest.mark.parametrize("C", [1, 8, 64])
@pytest.mark.parametrize("n", [1, 700, 5000])
def test_scatter_dest_plain_exact(n, C):
    """dest, counts and ranks equal the JAX kernel (interpret mode) and
    the JAX reference, with padding ids (-1 and >= C) mixed in."""
    rng = np.random.default_rng(n * 100 + C)
    ids = rng.integers(0, C, n).astype(np.int32)
    ids[rng.random(n) < 0.1] = -1
    ids[rng.random(n) < 0.05] = C
    dest, counts = scatter_dest_ref(torch.as_tensor(ids), C=C)
    j_dest, j_counts = j_scatter_dest_ref(jnp.asarray(ids), C=C)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(j_dest))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    k_dest, k_counts = scatter_dest_pallas(
        jnp.asarray(ids), C=C, block_n=j_mig_ops.kernel_block_n(C),
        interpret=True)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(k_dest))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(k_counts))
    rank, _ = bucket_ranks_ref(torch.as_tensor(ids), C=C)
    np.testing.assert_array_equal(
        rank.numpy(), np.asarray(j_bucket_ranks_ref(jnp.asarray(ids), C=C)[0]))
    # the wrapper on CPU tensors is the plain version, offsets included
    d2, c2, off = t_mops.scatter_dest(torch.as_tensor(ids), C=C)
    assert torch.equal(d2, dest) and torch.equal(c2, counts)
    np.testing.assert_array_equal(off.numpy(),
                                  np.concatenate([[0], np.cumsum(counts.numpy())]))
    r2, _ = t_mops.bucket_ranks(torch.as_tensor(ids), C=C)
    assert torch.equal(r2, rank)


def test_scatter_dest_is_inverse_stable_argsort():
    ids = np.random.default_rng(0).integers(0, 8, 3000).astype(np.int32)
    dest, _ = scatter_dest_ref(torch.as_tensor(ids), C=8)
    order = np.argsort(ids, kind="stable")
    np.testing.assert_array_equal(dest.numpy()[order], np.arange(3000))


@pytest.mark.parametrize("P", [33, 40, 65])
@pytest.mark.parametrize("limit", [16, 64, t_mops.SHARED_MAX_C])
def test_scatter_by_digits_exact(P, limit):
    """The radix-digit composition over the plain per-digit primitive
    equals JAX's full-C reference (dest, counts, ranks) at C = P^2, the
    spill's pair buckets, with padding ids (-1 and P^2) mixed in; one,
    two or three digits by ``limit``."""
    C = P * P
    rng = np.random.default_rng(P + limit)
    n = 5000
    ids = rng.integers(0, C, n).astype(np.int32)
    ids[rng.random(n) < 0.1] = -1
    ids[rng.random(n) < 0.05] = C
    ids[:1000] = np.sort(ids[:1000])          # a bucketed stretch too
    bases = t_mops.digit_bases(C, limit)
    prod = int(np.prod(bases[:-1]))
    assert all(b + 1 <= limit for b in bases[:-1]) and bases[-1] <= limit
    assert prod * bases[-1] >= C
    dest, counts = t_mops.scatter_by_digits(
        torch.as_tensor(ids), C, bases, scatter_dest_ref, bucket_counts_ref)
    j_dest, j_counts = j_scatter_dest_ref(jnp.asarray(ids), C=C)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(j_dest))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    offsets = np.concatenate([[0], np.cumsum(counts.numpy())])
    valid = (ids >= 0) & (ids < C)
    rank = np.where(valid, dest.numpy() - offsets[np.clip(ids, 0, C - 1)], -1)
    np.testing.assert_array_equal(
        rank, np.asarray(j_bucket_ranks_ref(jnp.asarray(ids), C=C)[0]))


@pytest.mark.parametrize("C,limit,bases", [
    (8, 4096, (8,)), (4096, 4096, (4096,)), (4097, 4096, (65, 64)),
    (66049, 4096, (257, 257)), (1 << 20, 4096, (1024, 1024)),
    (1 << 24, 4096, (256, 256, 256)), (1089, 16, (11, 11, 9))])
def test_digit_bases(C, limit, bases):
    """The fewest digits whose scatters fit ``limit`` buckets (the lower
    digits one more, for the padding), then the smallest base."""
    assert t_mops.digit_bases(C, limit) == bases


def test_scatter_form_and_limits():
    """small up to SMALL_MAX_C, shared up to SHARED_MAX_C, radix digits up
    to MAX_C (at least 1024^2: a scheduler of 1023 replicas and the park
    node); outside [1, MAX_C] a ValueError naming the limit."""
    assert t_mops.MAX_C >= 1024 ** 2
    assert t_mops.digit_bases(t_mops.MAX_C) is not None
    S1, S = t_mops.SMALL_MAX_C, t_mops.SHARED_MAX_C
    assert [t_mops.scatter_form(10, C) for C in (1, S1, S1 + 1, S, S + 1,
                                                  t_mops.MAX_C)] == \
        ["small", "small", "shared", "shared", "radix", "radix"]
    for C in (0, t_mops.MAX_C + 1):
        with pytest.raises(ValueError, match="MAX_C"):
            t_mops.scatter_form(10, C)


@pytest.mark.parametrize("n,C", [(0, 8), (4097, 8), (1 << 24, 8),
                                 (1 << 20, 1024), (1 << 24, 4096),
                                 (1 << 24, t_mops.SMALL_MAX_C + 1)])
def test_scatter_plan(n, C):
    """Whole tiles a block in input order covering n, a block count that
    is a multiple of 4 (16-byte table loads), no more blocks than four an
    SM or than the (C, blocks) table allows, and shared memory within an
    H100 block's."""
    form, blocks, tpb, smem_count, smem_rank = t_mops.scatter_plan(n, C)
    tiles = max(1, -(-n // t_mops.TILE))
    assert form == t_mops.scatter_form(n, C)
    assert blocks % 4 == 0 and (blocks - 4) * tpb < tiles <= blocks * tpb
    assert blocks <= max(4, 132 * t_mops.BLOCKS_PER_SM)
    assert blocks * C <= max(4 * C, t_mops.TABLE_MAX)
    assert max(smem_count, smem_rank) <= t_mops.SMEM_MAX


def test_preferred_method_on_a_card():
    """CUDA tensors follow the crossover measured on the card (the
    counting scatter up to CUDA_SORT_CROSSOVER_C buckets); CPU tensors and
    no device the JAX package's rule."""
    X = t_mops.CUDA_SORT_CROSSOVER_C
    assert t_mops.preferred_method(1 << 20, X, "cuda") == "scatter"
    assert t_mops.preferred_method(1 << 20, X + 1, "cuda:0") == "sort"
    for dev in (None, "cpu"):
        assert t_mops.preferred_method(1 << 20, 65, dev) == \
            j_mig_ops.preferred_method(1 << 20, 65) == "sort"


def test_preferred_method_resolves_as_jax_off_tpu():
    for C in (1, 8, 64, 65, 4096):
        assert t_mops.preferred_method(1000, C) == \
            j_mig_ops.preferred_method(1000, C)
    assert t_mops.SORT_CROSSOVER_C <= t_mops.MAX_C


# ------------------------------------------------------------- histogram --


@pytest.mark.parametrize("N,C", [(1, 1), (3000, 144), (10_000, 37)])
def test_histogram_plain_matches_jax(N, C):
    """Integer weights exact; float weights equal the JAX reference (same
    index-order sums) and the Pallas kernel within 1e-5 relative."""
    rng = np.random.default_rng(N + C)
    ids = rng.integers(-2, C + 2, N).astype(np.int32)
    for w in (np.ones(N, np.float32),
              rng.integers(0, 5, N).astype(np.float32),
              rng.random(N).astype(np.float32)):
        got = histogram_ref(torch.as_tensor(ids), torch.as_tensor(w), C=C)
        want = np.asarray(j_histogram_ref(jnp.asarray(ids), jnp.asarray(w),
                                          C=C))
        # JAX's reference drops ids >= C only through segment_sum bounds
        np.testing.assert_array_equal(got.numpy(), want)
        kern = np.asarray(histogram_pallas(
            jnp.asarray(ids), jnp.asarray(w), C=C, block_n=512,
            interpret=True))
        np.testing.assert_allclose(got.numpy(), kern, rtol=1e-5, atol=1e-5)
        assert torch.equal(t_hops.histogram(torch.as_tensor(ids),
                                            torch.as_tensor(w), C=C), got)


@pytest.mark.parametrize("N,C", [(1, 1), (3000, 144), (20_000, 8),
                                 (5000, 70_000)])
def test_histogram_ordered_runs_add_in_jax_segment_sum_order(N, C):
    """The ordered form's input (``ordered_runs``: weights stably sorted by
    bin, each bin's run) added one item at a time — what its kernel does,
    one thread a bin — gives the plain version's bits, which are
    ``jax.ops.segment_sum``'s on the CPU, on weights of three magnitudes
    (where another order rounds differently); ids past C are dropped."""
    rng = np.random.default_rng(N + C)
    ids = rng.integers(0, C + 2, N).astype(np.int32)
    w = (rng.random(N) * 1000).astype(np.float32) * rng.choice(
        np.array([1e-3, 1.0, 1e3], np.float32), N)
    ws, bounds = t_hops.ordered_runs(torch.as_tensor(ids),
                                     torch.as_tensor(w), C)
    ws, bounds = ws.numpy(), bounds.numpy()
    seq = np.zeros(C, np.float32)
    for c in np.nonzero(np.diff(bounds))[0]:
        for j in range(bounds[c], bounds[c + 1]):
            seq[c] = np.float32(seq[c] + ws[j])
    plain = t_hops.histogram_ordered(torch.as_tensor(ids),
                                     torch.as_tensor(w), C=C).numpy()
    np.testing.assert_array_equal(seq, plain)
    np.testing.assert_array_equal(plain, np.asarray(jax.ops.segment_sum(
        jnp.asarray(w), jnp.asarray(ids), num_segments=C)))


# -------------------------------------------------------------- pic push --


def _pic_push_both(g, x, y, vx, vy, q, L):
    got = pic_push_ref(*(torch.as_tensor(a) for a in (g, x, y, vx, vy, q)),
                       L=L)
    jin = [jnp.asarray(a) for a in (g, x, y, vx, vy, q)]
    return got, (j_pic_push_ref(*jin, L=L),
                 pic_push_pallas(*jin, L=L, block_n=256, interpret=True))


def test_pic_push_plain_matches_jax_on_prk_particles():
    """PRK particles (the driver's input), advanced 5 steps by each package
    on its own: equal within 2 f32 ulp elementwise, including particles at
    x = L - eps and on cell edges."""
    from repro_torch.pic.particles import initialize

    L, N = 64, 3000
    p = initialize("GEOMETRIC", L, N, k=2, rho=0.9, seed=1)
    edge = np.float32(np.nextafter(np.float32(L), np.float32(0)))
    p.x[:4] = [edge, 0.0, 1.0, 3.0]
    p.y[:4] = [1.0, edge, 0.0, edge]
    g = alternating_grid(L)
    ins = (p.x, p.y, p.vx, p.vy)
    for _ in range(5):
        got, wants = _pic_push_both(g, *ins, p.q, L)
        for want in wants:
            for a, b in zip(got, want):
                a, b = a.numpy(), np.asarray(b)
                assert (np.abs(a - b) <= 2 * np.spacing(np.abs(b))).all()
        ins = tuple(a.numpy() for a in got)


@pytest.mark.parametrize("L,N", [(16, 500), (64, 3000)])
def test_pic_push_plain_matches_jax_random(L, N):
    """Random positions put particles close to a corner charge, where the
    four 1/r² terms nearly cancel and XLA's FMA contraction (the port's
    plain version and its kernel contract nothing) moves results by up to
    ~1e-5 relative: allclose at rtol = atol = 3e-5."""
    rng = np.random.default_rng(L)
    x = (rng.random(N) * L).astype(np.float32)
    y = (rng.random(N) * L).astype(np.float32)
    edge = np.float32(np.nextafter(np.float32(L), np.float32(0)))
    x[:5] = [edge, 0.0, 1.0, L / 2, 3.0]
    y[:5] = [1.0, edge, 0.0, 2.0, edge]
    vx = rng.standard_normal(N).astype(np.float32)
    vy = rng.standard_normal(N).astype(np.float32)
    q = rng.choice([-1.0, 1.0], N).astype(np.float32) * 0.3
    g = alternating_grid(L)
    got, wants = _pic_push_both(g, x, y, vx, vy, q, L)
    for want in wants:
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-5,
                                       atol=3e-5)
    for a, b in zip(t_pops.pic_push(*(torch.as_tensor(a) for a in
                                      (g, x, y, vx, vy, q)), L=L), got):
        assert torch.equal(a, b)


def test_jnp_mod_wrap_matches_jax():
    from repro_torch.kernels.pic_push.ref import jnp_mod

    a = np.array([-1e-8, -0.0, 0.0, 1000.0, 999.99994, -1000.0, 1500.25,
                  -3.5, 2e-38], np.float32)
    np.testing.assert_array_equal(
        jnp_mod(torch.as_tensor(a), 1000.0).numpy(),
        np.asarray(jnp.mod(jnp.asarray(a), jnp.float32(1000.0))))


# ------------------------------------------------- wrappers: launch or raise --


def test_wrappers_raise_off_cpu_without_a_kernel():
    """A wrapper takes its plain version only for CPU tensors; any other
    device goes to the CUDA kernel path, which refuses a non-CUDA tensor
    (it never drops to the plain version)."""
    m = "meta"
    ids = torch.zeros(8, dtype=torch.int32, device=m)
    f = torch.zeros(8, device=m)
    with pytest.raises(ValueError):
        t_hops.histogram(ids, f, C=4)
    with pytest.raises(ValueError):
        t_mops.scatter_dest(ids, C=4)
    with pytest.raises(ValueError):
        t_pops.pic_push(torch.zeros((4, 4), device=m), f, f, f, f, f, L=4)
    nbr = torch.zeros((8, 2), dtype=torch.int32, device=m)
    i0 = torch.zeros((), dtype=torch.int32, device=m)
    with pytest.raises(ValueError):
        t_dops.diffusion_nsweeps(f, f, torch.zeros((8, 2), device=m), i0,
                                 torch.zeros((), device=m), i0, nbr,
                                 nbr.bool(), nbr, 0.3, n_sweeps=2,
                                 single_hop=True, tol=0.02, max_iters=8)
