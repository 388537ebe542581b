"""CUDA kernels of the PyTorch port against their plain PyTorch versions.

These tests need an NVIDIA card (and ``nvcc`` to build the kernels); they
skip elsewhere.  The file imports no JAX, so it runs on a machine that has
only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import virtual_lb as vlb
from repro_torch.kernels.diffusion import ops as dops
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import (POS_SENTINEL,
                                                     chunked_attention)
from repro_torch.kernels.diffusion.ref import (diffusion_nsweeps_ref,
                                               diffusion_sweep_ref)
from repro_torch.kernels.histogram import ops as hops
from repro_torch.kernels.histogram.ref import histogram_ref
from repro_torch.kernels.migrate import ops as mops
from repro_torch.kernels.migrate.ref import bucket_ranks_ref, scatter_dest_ref
from repro_torch.kernels.pic_push import ops as pops
from repro_torch.kernels.pic_push.ref import pic_push_ref
from repro_torch.pic import driver
from repro_torch.pic.grid import alternating_grid
from repro_torch.sim import scenarios, simulator

pytestmark = pytest.mark.cuda


def _ring_graph(P, K, seed):
    """Symmetric (P, K) table: a ring with K/2 hops each side, with a
    random quarter of the pairs dropped from both ends (so some slots are
    masked and the reverse slots are not all alike)."""
    cols = [(np.arange(P) + s) % P
            for h in range(1, K // 2 + 1) for s in (-h, h)]
    nbr = np.stack(cols, 1).astype(np.int32)
    mask = np.ones_like(nbr, bool)
    drop = np.random.default_rng(seed).random((P, K // 2)) < 0.25
    for h in range(K // 2):              # pair (i, i+h+1) ↔ slot 2h+1 / 2h
        i = np.nonzero(drop[:, h])[0]
        mask[i, 2 * h + 1] = False
        mask[(i + h + 1) % P, 2 * h] = False
    return np.where(mask, nbr, -1), mask


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain version)")
    return "cuda"


def _ulp_ok(a, b, n_ulp=1):
    sp = torch.nextafter(b.abs(), torch.full_like(b, float("inf"))) - b.abs()
    return bool(((a - b).abs() <= n_ulp * sp).all())


@pytest.mark.parametrize("L,N", [(16, 1000), (64, 5000), (1000, 100_000)])
def test_pic_push_kernel_matches_plain(dev, L, N):
    """0-1 ulp elementwise (same operation order, no FMA contraction),
    including particles at x = L - eps and on cell edges."""
    rng = np.random.default_rng(L)
    x = rng.random(N).astype(np.float32) * L
    y = rng.random(N).astype(np.float32) * L
    x[:4] = [np.nextafter(np.float32(L), 0), 0.0, 1.0, L / 2]
    y[:4] = [1.0, np.nextafter(np.float32(L), 0), 0.0, 2.0]
    args = [torch.as_tensor(a, device=dev) for a in (
        x, y, rng.standard_normal(N).astype(np.float32),
        rng.standard_normal(N).astype(np.float32),
        rng.choice([-1.0, 1.0], N).astype(np.float32))]
    g = torch.as_tensor(alternating_grid(L), device=dev)
    got = pops.pic_push(g, *args, L=L)
    want = pic_push_ref(g, *args, L=L)
    for a, b in zip(got, want):
        assert _ulp_ok(a, b)


@pytest.mark.parametrize("N,C", [(1, 1), (5000, 144), (70_000, 1000)])
def test_histogram_kernel_matches_plain(dev, N, C):
    """Integer weights exact; float weights within 1e-5 relative (the two
    add in different orders); ids outside [0, C) ignored."""
    rng = np.random.default_rng(N)
    ids = torch.as_tensor(rng.integers(-2, C + 2, N), dtype=torch.int32,
                          device=dev)
    ones = torch.ones(N, device=dev)
    assert torch.equal(hops.histogram(ids, ones, C=C),
                       histogram_ref(ids, ones, C=C))
    w = torch.as_tensor(rng.random(N).astype(np.float32), device=dev)
    want = histogram_ref(ids, w, C=C)
    got = hops.histogram(ids, w, C=C)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max().clamp(min=1.0))


def _hist_ids(n, C, order, seed):
    """ids in [-2, C + 2) (padding below 0 and at or above C): uniform at
    random, or bucketed as after an exchange (sorted by a random owner of
    each id, so long runs of one id)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(-2, C + 2, n)
    if order == "bucketed":
        owner = rng.integers(0, 8, C + 4)
        ids = ids[np.argsort(owner[ids + 2], kind="stable")]
    return ids


@pytest.mark.parametrize("order", ["random", "bucketed"])
@pytest.mark.parametrize("C", [1, 144, hops.PRIVATE_MAX_C,
                               hops.PRIVATE_MAX_C + 1, hops.MAX_C])
def test_histogram_kernel_forms_and_orders(dev, C, order):
    """Both forms, both orders, n not a multiple of 4, padding ids below 0
    and at or above C: exact with ones; f32 weights within 1e-5 of the
    largest bin of the plain version (the two add in different orders),
    and two calls equal bit for bit in the private form."""
    n = 200_003
    ids = torch.as_tensor(_hist_ids(n, C, order, C), dtype=torch.int32,
                          device=dev)
    ones = torch.ones(n, device=dev)
    form = hops.histogram_plan(n, C)[0]
    assert form == ("private" if C <= hops.PRIVATE_MAX_C else "shared")
    assert torch.equal(hops.histogram(ids, ones, C=C),
                       histogram_ref(ids, ones, C=C))
    w = torch.as_tensor(np.random.default_rng(n).random(n).astype(
        np.float32), device=dev)
    got, want = hops.histogram(ids, w, C=C), histogram_ref(ids, w, C=C)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max().clamp(min=1.0))
    if form == "private":
        assert torch.equal(got, hops.histogram(ids, w, C=C))


def test_histogram_kernel_unaligned_and_short_inputs(dev):
    """Views at odd offsets (not 16-byte aligned) and lengths 1..9 take
    the scalar tail; a strided view and int64 ids are converted."""
    ids = torch.as_tensor(_hist_ids(50_001, 144, "bucketed", 1),
                          dtype=torch.int32, device=dev)
    w = torch.as_tensor(np.random.default_rng(2).random(50_001).astype(
        np.float32), device=dev)
    for a, b in ((ids[1:], w[1:]), (ids[3:], w[:-3]), (ids[::2], w[::2]),
                 (ids.long(), w)):
        assert torch.allclose(hops.histogram(a, b, C=144),
                              histogram_ref(a, b, C=144), rtol=1e-5,
                              atol=1e-3)
        ones = torch.ones_like(b)
        assert torch.equal(hops.histogram(a, ones, C=144),
                           histogram_ref(a, ones, C=144))
    for n in range(1, 10):
        assert torch.equal(hops.histogram(ids[:n], w[:n], C=144),
                           histogram_ref(ids[:n], w[:n], C=144))


def test_histogram_kernel_back_to_back_calls(dev):
    """The last-block ticket resets itself: calls of different grids in a
    row on one stream stay exact."""
    outs, wants = [], []
    for n in (5_000_000, 17, 300_000, 5_000_000, 4096 * 132 + 5):
        ids = torch.as_tensor(_hist_ids(n, 144, "random", n),
                              dtype=torch.int32, device=dev)
        ones = torch.ones(n, device=dev)
        outs.append(hops.histogram(ids, ones, C=144))
        wants.append(histogram_ref(ids, ones, C=144))
    for a, b in zip(outs, wants):
        assert torch.equal(a, b)


def test_histogram_kernel_takes_every_c(dev):
    ids = torch.zeros(8, dtype=torch.int32, device=dev)
    w = torch.ones(8, device=dev)
    assert float(hops.histogram(ids, w, C=hops.MAX_C)[0]) == 8.0
    for C in (0, hops.MAX_C + 1):
        with pytest.raises(ValueError):
            hops.histogram(ids, w, C=C)


def _k3_exact(ids, C):
    """dest, counts, offsets and ranks of the kernel equal the plain
    version's, dest inverts a stable argsort of the valid ids, and two
    calls agree bit for bit."""
    d, c, off = mops.scatter_dest(ids, C=C)
    dr, cr = scatter_dest_ref(ids, C=C)
    assert torch.equal(d, dr) and torch.equal(c, cr)
    offr = torch.cat([cr.new_zeros(1), torch.cumsum(cr, 0,
                                                    dtype=torch.int32)])
    assert torch.equal(off, offr)
    valid = (ids >= 0) & (ids < C)
    order = torch.argsort(torch.where(valid, ids, C), stable=True)
    nv = int(valid.sum())
    assert torch.equal(d[order[:nv]], torch.arange(nv, dtype=torch.int32,
                                                   device=ids.device))
    assert all(torch.equal(a, b) for a, b in zip(
        (d, c, off), mops.scatter_dest(ids, C=C)))
    r, c2 = mops.bucket_ranks(ids, C=C)
    rr, _ = bucket_ranks_ref(ids, C=C)
    assert torch.equal(r, rr) and torch.equal(c2, cr)


K3_C = [1, 8, mops.SMALL_MAX_C, mops.SMALL_MAX_C + 1, 64, 1024,
        mops.SHARED_MAX_C, mops.SHARED_MAX_C + 1, 66049]


@pytest.mark.parametrize("n", [0, 1, 4095, 4097, 100_000])
@pytest.mark.parametrize("C", K3_C)
@pytest.mark.parametrize("order", ["random", "bucketed"])
def test_scatter_dest_kernel_matches_plain(dev, n, C, order):
    """Every form and its boundaries (the small form up to SMALL_MAX_C,
    the shared form up to SHARED_MAX_C, radix digits above), in random
    order and bucketed (sorted, as after an exchange), padding ids (-1
    and C) mixed in: all outputs exact.  At the radix sizes n stays at
    2^16 or below (the plain version costs O(n·C))."""
    n = min(n, 1 << 16) if C > mops.SHARED_MAX_C else n
    rng = np.random.default_rng(n + C)
    ids = rng.integers(-1, C + 1, n)
    if order == "bucketed":
        ids = np.sort(ids)
    ids = torch.as_tensor(ids, dtype=torch.int32, device=dev)
    _k3_exact(ids, C)
    if n:
        form = mops.scatter_form(n, C)
        before = mops.form_launches[form]
        mops.scatter_dest(ids, C=C)
        assert mops.form_launches[form] == before + 1


@pytest.mark.parametrize("C", [8, 1024])
def test_scatter_dest_kernel_pic_shape_and_views(dev, C):
    """2^22 ids in the PIC exchange's two orders (random owners, then
    bucketed by a stable sort), the kernel against the plain version; a
    misaligned view (ids[1:]) is taken too."""
    rng = np.random.default_rng(C)
    ids = torch.as_tensor(rng.integers(0, C, 1 << 22), dtype=torch.int32,
                          device=dev)
    _k3_exact(ids, C)
    _k3_exact(ids[torch.argsort(ids, stable=True)], C)
    _k3_exact(ids[1:], C)


def test_scatter_dest_kernel_rejects_large_c(dev):
    """Above MAX_C (and below 1) a card raises ValueError naming the
    limit; one bucket past the shared form (radix digits) answers
    exactly."""
    ids = torch.zeros(4, dtype=torch.int32, device=dev)
    for C in (0, mops.MAX_C + 1):
        with pytest.raises(ValueError, match="MAX_C"):
            mops.scatter_dest(ids, C=C)
    C = mops.SHARED_MAX_C + 1
    assert mops.scatter_form(1000, C) == "radix"
    rng = np.random.default_rng(0)
    _k3_exact(torch.as_tensor(rng.integers(-1, C + 1, 30_000),
                              dtype=torch.int32, device=dev), C)


def test_scatter_dest_kernel_large_c_against_argsort(dev):
    """C = 1024^2 (the scheduler's spill at 1023 replicas and the park
    node): dest against an independent oracle, a stable argsort."""
    C = 1 << 20
    rng = np.random.default_rng(1)
    ids = torch.as_tensor(rng.integers(-1, C + 1, 1 << 20),
                          dtype=torch.int32, device=dev)
    d, c, off = mops.scatter_dest(ids, C=C)
    valid = (ids >= 0) & (ids < C)
    order = torch.argsort(torch.where(valid, ids, C), stable=True)
    nv = int(valid.sum())
    assert torch.equal(d[order[:nv]], torch.arange(nv, dtype=torch.int32,
                                                   device=dev))
    assert bool((d[~valid] == ids.shape[0]).all())
    assert int(c.sum()) == nv and int(off[-1]) == nv


@pytest.mark.parametrize("P,K", [(8, 4), (64, 4), (257, 8), (8192, 8)])
@pytest.mark.parametrize("single_hop", [True, False])
def test_diffusion_kernel_matches_plain(dev, P, K, single_hop):
    """it and stall exact; x, own and flow within 16 f32 ulp of the largest
    load, res within that over the mean load (the kernel sums over P in a
    tree, the plain version in another order), in the form k1_form names:
    warp at P = 8, K = 4 and P = 64, K = 4, block at P = 257, K = 8, grid
    at P = 8192, K = 8."""
    nbr, mask = _ring_graph(P, K, seed=P + K)
    nbr = torch.as_tensor(nbr, dtype=torch.int32, device=dev)
    mask = torch.as_tensor(mask, device=dev)
    x = torch.as_tensor(np.random.default_rng(P).random(P).astype(np.float32)
                        * 10, device=dev)
    rev = vlb.reverse_slots(nbr, mask)
    alpha = float(torch.tensor(1.0 / (K + 1.0), dtype=torch.float32))
    carry = (x, x * 0.7, torch.zeros((P, K), device=dev),
             torch.zeros((), dtype=torch.int32, device=dev),
             vlb.neighborhood_residual(x, nbr, mask),
             torch.zeros((), dtype=torch.int32, device=dev))
    for tol, S in ((0.02, 8), (-1.0, 5)):
        kw = dict(n_sweeps=S, single_hop=single_hop, tol=tol, max_iters=512)
        got = dops.fused_nsweeps(*carry, nbr, mask, rev, alpha, **kw)
        want = diffusion_nsweeps_ref(*carry, nbr, mask, rev, alpha, **kw)
        assert int(got[3]) == int(want[3]) and int(got[5]) == int(want[5])
        scale = x.abs().max()
        tol = 16 * float(torch.nextafter(scale, scale + 1) - scale)
        for i in (0, 1, 2):
            assert float((got[i] - want[i]).abs().max()) <= tol
        assert abs(float(got[4]) - float(want[4])) <= tol / float(x.mean())


def _k1_case(dev, P, K, seed, x=None, single_hop=True):
    nbr, mask = _ring_graph(P, K, seed=seed)
    nbr = torch.as_tensor(nbr, dtype=torch.int32, device=dev)
    mask = torch.as_tensor(mask, device=dev)
    if x is None:
        x = np.random.default_rng(seed).random(P).astype(np.float32) * 10
    x = torch.as_tensor(x, device=dev)
    rev = vlb.reverse_slots(nbr, mask)
    alpha = float(torch.tensor(1.0 / (K + 1.0), dtype=torch.float32))
    carry = (x, x * 0.7, torch.zeros((P, K), device=dev),
             torch.zeros((), dtype=torch.int32, device=dev),
             vlb.neighborhood_residual(x, nbr, mask),
             torch.zeros((), dtype=torch.int32, device=dev))
    return (*carry, nbr, mask, rev, alpha)


def _k1_forms_agree(args, kw):
    """Every K1 form that takes the shape against the plain chunk: it and
    stall exact; x, own and flow within 16 ulp of the largest load, res
    within that over the mean load; each form twice bit for bit.  Returns
    the (it, stall) they share."""
    P, K = args[6].shape
    want = diffusion_nsweeps_ref(*args, **kw)
    x = args[0]
    scale = x.abs().max()
    tol = 16 * float(torch.nextafter(scale, scale + 1) - scale)
    for form in dops.K1_FORMS:
        if not dops.k1_takes(form, P, K):
            continue
        before = dops.form_launches[form]
        got = dops._fused_form(form, *args, **kw)
        assert dops.form_launches[form] == before + 1
        assert (int(got[3]), int(got[5])) == (int(want[3]), int(want[5])), \
            form
        for i in (0, 1, 2):
            assert got[i].shape == want[i].shape
            assert float((got[i] - want[i]).abs().max()) <= tol, form
        assert abs(float(got[4]) - float(want[4])) <= tol / float(x.mean())
        again = dops._fused_form(form, *args, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), form
    return int(want[3]), int(want[5])


@pytest.mark.parametrize("P,K", [(8, 4), (37, 4), (257, 8), (1000, 8),
                                 (3000, 2)])
@pytest.mark.parametrize("single_hop", [True, False])
def test_k1_every_form_matches_plain(dev, P, K, single_hop):
    """Each form on masked ring graphs, P not a multiple of any block."""
    args = _k1_case(dev, P, K, seed=P + K)
    for tol, S in ((0.02, 8), (-1.0, 5)):
        _k1_forms_agree(args, dict(n_sweeps=S, single_hop=single_hop,
                                   tol=tol, max_iters=512))


@pytest.mark.parametrize("stop", ["max_iters", "tol", "stall"])
def test_k1_forms_stop_mid_chunk(dev, stop):
    """A chunk that stops after some of its sweeps, at max_iters, at the
    tolerance or at the stall count: it and stall equal in every form and
    the plain chunk."""
    P, K = 300, 4
    x = None
    kw = dict(n_sweeps=12, single_hop=True, tol=0.02, max_iters=512)
    if stop == "max_iters":
        kw["max_iters"] = 5
    elif stop == "tol":
        kw["tol"] = 0.5
    else:                       # equal loads: nothing moves, a stall a sweep
        x = np.full(P, 3.0, np.float32)
        kw["tol"] = -1.0
    args = _k1_case(dev, P, K, seed=7, x=x)
    it, stall = _k1_forms_agree(args, kw)
    assert it < kw["n_sweeps"]
    if stop == "max_iters":
        assert it == 5
    if stop == "stall":
        assert (it, stall) == (3, 3)


def test_k1_grid_form_past_shared_memory(dev):
    """The grid form where the one-block forms' state exceeds shared
    memory: against the plain chunk, bit for bit over two calls, and the
    form k1_form names."""
    P, K = 20_000, 8
    assert dops.k1_form(P, K) == "grid"
    assert not dops.k1_takes("block", P, K)
    args = _k1_case(dev, P, K, seed=3)
    _k1_forms_agree(args, dict(n_sweeps=8, single_hop=True, tol=0.02,
                               max_iters=512))


def _sweep_case(dev, P, K, seed):
    nbr, mask = _ring_graph(P, K, seed=seed) if K % 2 == 0 else \
        _odd_graph(P, K)
    nbr = torch.as_tensor(nbr, dtype=torch.int32, device=dev)
    mask = torch.as_tensor(mask, device=dev)
    x = torch.as_tensor(np.random.default_rng(seed).random(P).astype(
        np.float32) * 10, device=dev)
    alpha = float(torch.tensor(1.0 / (K + 1.0), dtype=torch.float32))
    return x, nbr, mask, vlb.reverse_slots(nbr, mask), alpha


def _odd_graph(P, K):
    """Symmetric (P, K) table with an odd K: the ring's K - 1 slots plus a
    last slot pairing i with i + P/2 (P even)."""
    nbr, mask = _ring_graph(P, K - 1, seed=P)
    opp = ((np.arange(P) + P // 2) % P).astype(np.int32)
    return (np.concatenate([nbr, opp[:, None]], 1),
            np.concatenate([mask, np.ones((P, 1), bool)], 1))


@pytest.mark.parametrize("P,K", [(8, 4), (64, 4), (257, 8), (8192, 8),
                                 (1000, 5), (96, 32)])
@pytest.mark.parametrize("single_hop", [True, False])
def test_diffusion_sweep_kernel_matches_plain(dev, P, K, single_hop):
    """One sweep: x, own and flow within 8 f32 ulp of the largest load
    (the kernel sums each row in slot order, the plain version in its own
    order; every product and quotient rounds alike under -fmad=false)."""
    x, nbr, mask, rev, alpha = _sweep_case(dev, P, K, seed=P + K)
    own = x * 0.3
    got = dops.diffusion_sweep(x, own, nbr, mask, rev, alpha, single_hop)
    want = diffusion_sweep_ref(x, own, nbr, mask, rev, alpha, single_hop)
    scale = x.abs().max()
    tol = 8 * float(torch.nextafter(scale, scale + 1) - scale)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= tol


def test_diffusion_sweep_kernel_rejects_wide_rows(dev):
    x, nbr, mask, rev, alpha = _sweep_case(dev, 66, 33, seed=1)
    with pytest.raises(ValueError):
        dops.diffusion_sweep(x, x, nbr, mask, rev, alpha)


@pytest.mark.parametrize("P,K", [(4096, 8), (8192, 8), (16384, 4)])
def test_streaming_chunk_matches_fused_and_plain(dev, P, K):
    """The streaming chunk against the fused kernel and the plain chunk:
    it and stall exact; x, own and flow within 16 ulp of the largest load
    (the fused kernel sums rows in the same slot order, the plain chunk in
    its own; the residual and stall sums differ in order)."""
    x, nbr, mask, rev, alpha = _sweep_case(dev, P, K, seed=K)
    carry = (x, x, torch.zeros((P, K), device=dev),
             torch.zeros((), dtype=torch.int32, device=dev),
             vlb.neighborhood_residual(x, nbr, mask),
             torch.zeros((), dtype=torch.int32, device=dev))
    kw = dict(n_sweeps=8, single_hop=True, tol=0.02, max_iters=512)
    args = (*carry, nbr, mask, rev, alpha)
    stream = vlb.reference_nsweeps(*args, **kw, step_fn=dops.diffusion_sweep)
    scale = x.abs().max()
    tol = 16 * float(torch.nextafter(scale, scale + 1) - scale)
    for other in (dops.fused_nsweeps(*args, **kw),
                  diffusion_nsweeps_ref(*args, **kw)):
        assert int(stream[3]) == int(other[3])
        assert int(stream[5]) == int(other[5])
        for i in (0, 1, 2):
            assert float((stream[i] - other[i]).abs().max()) <= tol
    assert dops.sweep_impl(64, 8, dev) == "fused"


@pytest.mark.parametrize("P,K", [(512, 4), (8192, 8)])
def test_streaming_graph_chunk_equals_eager(dev, P, K):
    """The streaming chunk replayed from its CUDA graph equals the same
    chunk issued op by op, bit for bit, over consecutive chunks (the
    graph's buffers are reused), and counts one sweep launch a sweep."""
    from repro_torch import kernels

    x, nbr, mask, rev, alpha = _sweep_case(dev, P, K, seed=P)
    carry = (x, x, torch.zeros((P, K), device=dev),
             torch.zeros((), dtype=torch.int32, device=dev),
             vlb.neighborhood_residual(x, nbr, mask),
             torch.zeros((), dtype=torch.int32, device=dev))
    kw = dict(n_sweeps=4, single_hop=True, tol=0.02, max_iters=512)
    eager = graph = carry
    for _ in range(3):
        eager = vlb.reference_nsweeps(*eager, nbr, mask, rev, alpha, **kw,
                                      step_fn=dops.diffusion_sweep)
        before = kernels.launch_counts()["diffusion_sweep"]
        graph = dops.streaming_nsweeps(*graph, nbr, mask, rev, alpha, **kw)
        assert kernels.launch_counts()["diffusion_sweep"] >= before + 4
        for a, b in zip(graph, eager):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n,C", [(1, 1), (144, 8), (4096, 8), (3000, 70_000),
                                 (4097, 8), (1 << 20, 8192),
                                 (1 << 20, 1 << 22)])
def test_histogram_ordered_equals_cpu_bit_for_bit(dev, n, C):
    """K4's ordered form (the card's f32 segment sums; unsorted walk up to
    4096 items and 65536 bins, sorted runs above) on weights of three
    magnitudes: the plain version's bits, and ``comm_graph.segment_sum``
    on the card equals it on the CPU."""
    from repro_torch.core.comm_graph import segment_sum

    rng = np.random.default_rng(n + C)
    ids = torch.as_tensor(rng.integers(0, C + 2, n).astype(np.int32))
    w = torch.as_tensor((rng.random(n) * 1000).astype(np.float32)
                        * rng.choice(np.array([1e-3, 1, 1e3], np.float32),
                                     n))
    before = dict(hops.form_launches)
    got = hops.histogram_ordered(ids.to(dev), w.to(dev), C=C)
    assert hops.form_launches["ordered"] == before["ordered"] + 1
    assert torch.equal(got.cpu(), histogram_ref(ids, w, C=C))
    assert torch.equal(segment_sum(w.to(dev), ids.to(dev), C).cpu(),
                       segment_sum(w, ids, C))


@pytest.mark.parametrize("n", [1, 32, 33, 64, 2048, 131072, 1 << 20])
def test_ordered_sum_equals_cpu_bit_for_bit(dev, n):
    """``comm_graph.ordered_sum`` on a card (one K4 ordered-form launch a
    level of 32-item windows) gives the CPU's bits, and ``run_sums`` its
    plain version's."""
    from repro_torch.core.comm_graph import ordered_sum

    rng = np.random.default_rng(n)
    v = torch.as_tensor(((rng.random(n) - 0.3) * 1000).astype(np.float32)
                        * rng.choice(np.array([1e-3, 1, 1e3], np.float32),
                                     n))
    assert torch.equal(ordered_sum(v.to(dev)).cpu(), ordered_sum(v))
    bounds = torch.as_tensor(np.unique(np.concatenate(
        [[0, n], rng.integers(0, n + 1, 9)])).astype(np.int64))
    assert torch.equal(hops.run_sums(v.to(dev), bounds.to(dev)).cpu(),
                       hops.run_sums(v, bounds))


def test_cumsum_repeats_bit_for_bit_on_cuda(dev):
    """``comm_graph.cumsum`` on a card: the same bits on every call and as
    on the CPU, and within 1e-5 relative of a float64 prefix sum
    (torch.cumsum's CUDA scan adds floats in a varying order)."""
    from repro_torch.core.comm_graph import cumsum

    v = torch.as_tensor(np.random.default_rng(0).random(1 << 20).astype(
        np.float32) * 8 + 1, device=dev)
    a = cumsum(v)
    for _ in range(3):
        assert torch.equal(cumsum(v), a)
    want = torch.cumsum(v.double(), 0)
    assert float(((a.double() - want).abs() / want).max()) <= 1e-5
    # the order of additions is the CPU's (the JAX package's), bit for bit
    assert torch.equal(a.cpu(), cumsum(v.cpu()))


def test_run_series_cuda_matches_cpu(dev):
    """A small stencil-wave replay on the card (fused chunk) equals the
    same replay on the CPU: fire steps and final assignment exact, max/avg
    within 1e-5 relative, on both loops."""
    kw = dict(steps=24, lb_every=6, strategy="diff-comm")
    cpu = simulator.run_series(
        *scenarios.get("stencil-wave").instantiate(device="cpu", grid=16,
                                                  num_nodes=8), **kw)
    for scan in (True, False):
        got = simulator.run_series(
            *scenarios.get("stencil-wave").instantiate(device=dev, grid=16,
                                                      num_nodes=8),
            scan=scan, **kw)
        np.testing.assert_array_equal(got.lb_fired, cpu.lb_fired)
        np.testing.assert_array_equal(got.final_assignment,
                                      cpu.final_assignment)
        np.testing.assert_allclose(got.max_avg, cpu.max_avg, rtol=1e-5)


@pytest.mark.parametrize("strategy", ["greedy-refine", "metis"])
def test_host_strategy_replay_cuda_matches_cpu(dev, strategy):
    """A host planner's replay on the card (the host loop; plans read from
    and put back on the card) equals the same replay on the CPU."""
    kw = dict(steps=24, lb_every=6, strategy=strategy)
    runs = [simulator.run_series(
        *scenarios.get("stencil-wave").instantiate(device=d, grid=16,
                                                  num_nodes=8), **kw)
        for d in ("cpu", dev)]
    assert not runs[1].scanned
    np.testing.assert_array_equal(runs[1].lb_fired, runs[0].lb_fired)
    np.testing.assert_array_equal(runs[1].final_assignment,
                                  runs[0].final_assignment)


def test_run_series_batch_cuda_matches_cpu(dev):
    """The batched replay of every registered scenario on the card: each
    lane's fire steps and final assignment equal the CPU's."""
    kw = dict(steps=24, lb_every=6, strategy="diff-comm",
              strategy_kwargs=dict(k=3))
    cpu, got = (simulator.run_series_batch(scenarios.batch_instances(
        8, grid=16, num_nodes=8, device=d), **kw) for d in ("cpu", dev))
    for a, b in zip(got.series, cpu.series):
        np.testing.assert_array_equal(a.lb_fired, b.lb_fired)
        np.testing.assert_array_equal(a.final_assignment, b.final_assignment)


def test_pic_driver_cuda_matches_cpu(dev):
    """The whole driver on the card equals the plain-version run on the
    CPU: integer records exact, positions within 1e-3."""
    base = dict(L=100, n_particles=4000, steps=40, cx=8, cy=8, num_pes=4,
                lb_every=10, strategy="diff-comm")
    g = driver.run(driver.PICConfig(**base, device=dev))
    c = driver.run(driver.PICConfig(**base, device="cpu"))
    for f in ("lb_steps", "migrations", "migrated_bytes", "ext_bytes",
              "int_bytes", "max_avg"):
        np.testing.assert_array_equal(getattr(g, f), getattr(c, f))
    np.testing.assert_allclose(g.final_x, c.final_x, atol=1e-3)
    np.testing.assert_allclose(g.final_y, c.final_y, atol=1e-3)


# ------------------------------------------------------- flash attention --


def _flash_inputs(dev, B, Sq, T, KV, G, hd, qdt, kvdt, seed):
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.normal(size=(B, Sq, KV, G, hd)),
                        dtype=torch.float32, device=dev).to(qdt)
    k, v = (torch.as_tensor(rng.normal(size=(B, T, KV, hd)),
                            dtype=torch.float32, device=dev).to(kvdt)
            for _ in range(2))
    qp = (torch.arange(Sq, dtype=torch.int32, device=dev)
          + (T - Sq)).expand(B, Sq).contiguous()
    kp = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    return q, k, v, qp, kp.contiguous()


def _flash_close(got, want, dtype):
    """The JAX kernel test's tolerance: 2e-2 bf16, 2e-3 f32 (abs + rel)."""
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,Sq,T,KV,G,hd,window,prefix,dtype", [
    (2, 64, 64, 2, 3, 16, 0, 0, torch.float32),
    (1, 128, 128, 1, 4, 32, 0, 0, torch.float32),
    (2, 64, 64, 2, 2, 16, 24, 0, torch.float32),
    (1, 48, 48, 2, 2, 16, 0, 16, torch.float32),
    (2, 96, 96, 3, 1, 16, 0, 0, torch.bfloat16),
    (1, 40, 72, 2, 2, 8, 0, 0, torch.float32),     # Sq != T, ragged tile
    (1, 200, 1056, 1, 4, 288, 0, 0, torch.bfloat16),   # gemma3-1b heads
    (1, 130, 300, 1, 4, 288, 0, 0, torch.float32),
    (4, 1, 1056, 1, 4, 288, 0, 0, torch.bfloat16),     # decode
    (3, 1, 50, 2, 3, 16, 16, 0, torch.float32),
    (1, 64, 64, 1, 20, 16, 0, 0, torch.float32),       # G > 16
])
def test_flash_attention_kernel_matches_plain(dev, B, Sq, T, KV, G, hd,
                                              window, prefix, dtype):
    from repro_torch import kernels

    args = _flash_inputs(dev, B, Sq, T, KV, G, hd, dtype, dtype, Sq + T)
    before = kernels.launch_counts()["flash_attention"]
    got = fops.flash_attention(*args, window=window, prefix_len=prefix)
    assert kernels.launch_counts()["flash_attention"] == before + 1
    want = chunked_attention(*args, window=window, prefix_len=prefix)
    _flash_close(got, want, dtype)


@pytest.mark.parametrize("qdt,kvdt", [(torch.bfloat16, torch.float32),
                                      (torch.float32, torch.bfloat16)])
def test_flash_attention_kernel_mixed_types(dev, qdt, kvdt):
    """q and k/v of different types (a bf16 model over an f32 cache)."""
    args = _flash_inputs(dev, 2, 33, 90, 1, 4, 288, qdt, kvdt, 7)
    _flash_close(fops.flash_attention(*args, window=40),
                 chunked_attention(*args, window=40), qdt)


def test_flash_attention_kernel_sentinels_and_wrapped_ring(dev):
    """Unwritten slots (sentinel positions) contribute nothing, and a
    window ring whose slots are out of position order (decode past the
    window) is read whole: every query of a batch row at its own
    position, the ring holding the latest position of each residue."""
    T, W, hd = 64, 64, 288
    q, k, v, _, _ = _flash_inputs(dev, 3, 1, T, 1, 4, hd, torch.bfloat16,
                                  torch.bfloat16, 11)
    last = torch.tensor([[150], [70], [40]], dtype=torch.int32, device=dev)
    s = torch.arange(T, dtype=torch.int32, device=dev)[None]
    kp = torch.where(s <= last, s + torch.div(last - s, T,
                                              rounding_mode="floor") * T,
                     POS_SENTINEL).to(torch.int32)
    for window in (W, 40):
        _flash_close(fops.flash_attention(q, k, v, last, kp, window=window),
                     chunked_attention(q, k, v, last, kp, window=window),
                     torch.bfloat16)
    # prefill into a fresh cache: slots past the prompt hold the sentinel
    q, k, v, qp, kp = _flash_inputs(dev, 1, 16, 64, 1, 2, 16, torch.float32,
                                    torch.float32, 0)
    qp = torch.arange(16, dtype=torch.int32, device=dev)[None]
    kp = torch.where(kp < 16, kp, POS_SENTINEL).to(torch.int32)
    _flash_close(fops.flash_attention(q, k, v, qp, kp),
                 chunked_attention(q[:, :16], k[:, :16], v[:, :16], qp,
                                   kp[:, :16]), torch.float32)


def test_flash_attention_kernel_rejects_what_it_does_not_take(dev):
    args = _flash_inputs(dev, 1, 4, 8, 1, 2, 16, torch.float16,
                         torch.float16, 0)
    with pytest.raises(ValueError):
        fops.flash_attention(*args)
    # past the simt form's hd <= 576 and G <= 128
    args = _flash_inputs(dev, 1, 4, 8, 1, 2, 600, torch.float32,
                         torch.float32, 0)
    with pytest.raises(ValueError):
        fops.flash_attention(*args)
    args = _flash_inputs(dev, 1, 1, 8, 1, 129, 64, torch.float32,
                         torch.float32, 0)
    with pytest.raises(ValueError):
        fops.flash_attention(*args)



# the kernel's forms: split (decode), mma (bf16 prefill), each case taking
# the form flash_form names; two identical calls give equal bits


def _take_form(form, *args, **kw):
    before = fops.form_launches[form]
    got = fops.flash_attention(*args, **kw)
    assert fops.form_launches[form] == before + 1, form
    assert torch.equal(got, fops.flash_attention(*args, **kw))
    return got


def _decode_inputs(dev, B, T, KV, G, hd, qdt, kvdt, last, ring, seed):
    """One query row a batch row at position ``last[b]``; the cache holds
    positions 0..last in slot order, or (ring) position p in slot p mod T;
    unwritten slots hold the sentinel."""
    q, k, v, _, _ = _flash_inputs(dev, B, 1, T, KV, G, hd, qdt, kvdt, seed)
    qp = torch.tensor(last, dtype=torch.int32, device=dev)[:, None]
    s = torch.arange(T, dtype=torch.int32, device=dev)[None]
    kp = (s + torch.div(qp - s, T, rounding_mode="floor") * T if ring
          else s.expand(B, T))
    kp = torch.where(s <= qp, kp, POS_SENTINEL).to(torch.int32)
    return q, k, v, qp, kp.contiguous()


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("B,T,KV,G,hd,window,ring,qdt,kvdt,last", [
    (1, 1056, 1, 4, 288, 0, False, BF16, BF16, [1040]),
    (3, 1056, 1, 4, 288, 0, False, BF16, BF16, [1055, 600, 31]),
    (4, 1056, 1, 4, 288, 0, False, BF16, BF16, [1030, 1026, 543, 607]),
    (4, 1024, 1, 4, 288, 1024, True, BF16, BF16, [1030, 1026, 543, 607]),
    (3, 1024, 1, 20, 64, 512, True, BF16, BF16, [2000, 1500, 700]),
    (1, 50, 1, 1, 64, 0, False, BF16, BF16, [49]),
    (3, 50, 2, 3, 64, 16, False, F32, F32, [49, 20, 3]),
    (4, 1056, 1, 4, 288, 0, False, F32, F32, [1030, 1026, 543, 607]),
    (3, 1056, 2, 1, 288, 0, False, F32, F32, [1055, 300, 64]),
    (2, 300, 1, 3, 20, 0, False, F32, F32, [299, 100]),   # hd % 8 != 0
    (3, 90, 1, 4, 288, 40, False, BF16, F32, [89, 60, 5]),
    (3, 90, 1, 4, 288, 0, False, F32, BF16, [89, 60, 5]),
    # the served decode over an f32 cache (ServeConfig's default type):
    # bf16 q from the bf16 model, global and wrapped window layers
    (4, 1056, 1, 4, 288, 0, False, BF16, F32, [1030, 1026, 543, 607]),
    (4, 1024, 1, 4, 288, 1024, True, BF16, F32, [1030, 1026, 543, 607]),
])
def test_flash_split_form_matches_plain(dev, B, T, KV, G, hd, window, ring,
                                        qdt, kvdt, last):
    args = _decode_inputs(dev, B, T, KV, G, hd, qdt, kvdt, last, ring,
                          B + T + G)
    assert fops.flash_form(B, 1, T, KV, G, hd, qdt, kvdt) == "split"
    # p is rounded to v's type before the PV product, and the oracle's
    # decode branch rounds p after normalizing it: with a bf16 cache the
    # two agree to bf16's tolerance whatever q's type
    _flash_close(_take_form("split", *args, window=window),
                 chunked_attention(*args, window=window),
                 BF16 if BF16 in (qdt, kvdt) else F32)


@pytest.mark.parametrize("tensor_cores", [True, False])
@pytest.mark.parametrize("keys_per_split", [32, 64, 96, 352, 1056])
def test_flash_split_form_any_key_split(dev, keys_per_split, tensor_cores):
    """The served decode's shape cut into 33 down to 1 splits, partials
    from the tensor-core or the FMA kernel: each equals the plain split
    form at the same split, and the chunked attention, and repeats bit for
    bit."""
    from repro_torch.kernels.flash_attention.ref import split_attention

    args = _decode_inputs(dev, 4, 1056, 1, 4, 288, BF16, BF16,
                          [1030, 1026, 543, 20], False, 3)
    kw = dict(keys_per_split=keys_per_split, tensor_cores=tensor_cores)
    got = fops._launch(*args, 0, 0, "split", **kw)
    assert torch.equal(got, fops._launch(*args, 0, 0, "split", **kw))
    _flash_close(got, chunked_attention(*args), BF16)
    _flash_close(got, split_attention(*args, keys_per_split=keys_per_split),
                 BF16)


def _prefill_inputs(dev, B, Sq, T, KV, G, hd, fresh, seed):
    """bf16 q/k/v; query rows at the last Sq positions of T, or (fresh) a
    prompt written into slots 0..Sq-1 of an otherwise unwritten cache."""
    q, k, v, qp, kp = _flash_inputs(dev, B, Sq, T, KV, G, hd, BF16, BF16,
                                    seed)
    if fresh:
        qp = torch.arange(Sq, dtype=torch.int32,
                          device=dev).expand(B, Sq).contiguous()
        kp = torch.where(kp < Sq, kp, POS_SENTINEL).to(torch.int32)
    return q, k, v, qp, kp


@pytest.mark.parametrize("B,Sq,T,KV,G,hd,window,prefix,fresh", [
    (1, 1000, 1056, 1, 4, 288, 0, 0, True),      # served prefill
    (1, 1000, 1024, 1, 4, 288, 1024, 0, True),   # into a window ring
    (2, 37, 100, 2, 3, 64, 0, 0, False),         # 111 pairs: ragged M tile
    (1, 77, 77, 1, 4, 288, 24, 0, False),        # window
    (2, 50, 64, 1, 3, 64, 0, 20, True),          # prefix-LM
    (1, 45, 300, 1, 3, 64, 100, 30, False),      # window and prefix
    (1, 64, 64, 1, 20, 16, 0, 0, False),         # G = 20
    (1, 40, 300, 1, 1, 288, 0, 0, False),        # G = 1
])
def test_flash_mma_form_matches_plain(dev, B, Sq, T, KV, G, hd, window,
                                      prefix, fresh):
    args = _prefill_inputs(dev, B, Sq, T, KV, G, hd, fresh, Sq + T + G)
    assert fops.flash_form(B, Sq, T, KV, G, hd, BF16, BF16) == "mma"
    _flash_close(_take_form("mma", *args, window=window, prefix_len=prefix),
                 chunked_attention(*args, window=window, prefix_len=prefix),
                 BF16)


@pytest.mark.parametrize("warps,keys_per_split", [(2, 0), (4, 0), (2, 256),
                                                  (4, 128)])
def test_flash_mma_form_tiles_and_key_splits(dev, warps, keys_per_split):
    """32- or 64-pair M tiles, with and without a key split merged by the
    combine kernel, at the served prefill's shape and a ragged small one;
    a key split's merge repeats bit for bit."""
    for shape, window in (((1, 1000, 1056, 1, 4, 288), 0),
                          ((2, 37, 100, 2, 3, 64), 24)):
        args = _prefill_inputs(dev, *shape, False, 5)
        kw = dict(keys_per_split=keys_per_split or shape[2], warps=warps)
        got = fops._launch(*args, window, 0, "mma", **kw)
        _flash_close(got, chunked_attention(*args, window=window), BF16)
        assert torch.equal(got, fops._launch(*args, window, 0, "mma", **kw))


def test_served_model_cuda_matches_cpu(dev):
    """The reduced gemma3-1b (f32) on the card against the CPU: forward
    logits within 1e-4 relative to their scale, and a ServeEngine's
    tokens equal (decode past the 16-token window included)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params, tree_to
    from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

    cfg = dataclasses.replace(get_arch("gemma3-1b").reduced,
                              compute_dtype="float32")
    p = init_params(transformer.model_specs(cfg), 0, device="cpu")
    tok = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)))
    pos = torch.arange(24, dtype=torch.int32).expand(2, 24)
    out = {}
    for d in ("cpu", dev):
        pd = tree_to(p, d)
        h, _ = transformer.forward(pd, cfg, dict(tokens=tok.to(d),
                                                 positions=pos.to(d)))
        eng = ServeEngine(cfg, pd, ServeConfig(num_slots=2, max_len=40),
                          device=d)
        for i in range(3):
            eng.submit(Request(uid=i, prompt=tok[0, :8 + 3 * i].numpy(),
                               max_new_tokens=10))
        out[d] = (transformer.logits_head(pd, cfg, h).cpu(),
                  [(r.uid, r.out) for r in eng.run_until_drained()])
    scale = float(out["cpu"][0].abs().max())
    assert float((out["cpu"][0] - out[dev][0]).abs().max()) <= 1e-4 * scale
    assert out["cpu"][1] == out[dev][1]


def test_scheduler_cuda_matches_cpu(dev):
    """The DiffusionScheduler planning and exchanging on the card (K3 for
    the manifest and, under a slot budget, for spill_owner's (R+1)^2 pair
    buckets) equals the same scheduler on the CPU, also at 40 replicas
    with a slot budget (1681 pair buckets, the shared form): heavy
    sessions on half the replicas, the other half full of light ones, so
    the moves into full replicas are deferred."""
    from repro_torch.serve.scheduler import DiffusionScheduler, Session

    def build(d):
        s = DiffusionScheduler(4, k=3, device=d)
        rng = np.random.default_rng(7)
        for i in range(40):
            s.add(Session(uid=100 + i, replica=int(rng.integers(0, 2)),
                          tokens_per_s=float(rng.uniform(0.1, 5.0)),
                          prefix_group=i // 5,
                          kv_bytes=float(rng.uniform(10, 200))))
        return s

    def skewed(d, R=40, heavy=5, light=10):
        s = DiffusionScheduler(R, k=3, device=d)
        rng = np.random.default_rng(7)
        uid = 0
        for r in range(R):
            hot = r < R // 2
            for _ in range(heavy if hot else light):
                s.add(Session(uid=uid, replica=r, tokens_per_s=float(
                    rng.uniform(3, 5) if hot else rng.uniform(0.2, 0.6)),
                    prefix_group=uid // 5,
                    kv_bytes=float(rng.uniform(10, 200))))
                uid += 1
        return s

    for make, cap in ((build, None), (build, 12), (skewed, 10)):
        c, g = make("cpu"), make(dev)
        ic = c.rebalance(slot_capacity=cap)
        ig = g.rebalance(slot_capacity=cap)
        assert g.sessions == c.sessions
        for key in ("moved_sessions", "deferred_sessions", "moved_kv_bytes",
                    "prefix_local", "max_avg_load"):
            assert ig[key] == pytest.approx(ic[key], rel=1e-6), key
        if make is skewed:
            assert ic["deferred_sessions"] > 0


@pytest.mark.parametrize("N,P,T", [(300, 9, 4), (1 << 16, 512, 16)])
def test_lpt_threads_on_cuda_equals_host_oracle(dev, N, P, T):
    """Two-level placement on a card: the LPT threads and thread loads of
    ``core.hierarchical`` equal the host NumPy oracle's, with many ties
    (most loads one idle value)."""
    from repro_torch.core import hierarchical

    rng = np.random.default_rng(N)
    loads = np.where(rng.random(N) < 0.6, np.float32(0.05),
                     rng.random(N).astype(np.float32) * 4)
    a = rng.integers(0, P, N).astype(np.int32)
    thr = hierarchical.lpt_threads(torch.as_tensor(loads, device=dev),
                                   torch.as_tensor(a, device=dev),
                                   num_nodes=P, threads_per_node=T)
    want = hierarchical.within_node_lpt(loads, a, P, T)
    assert np.array_equal(thr.cpu().numpy(), want)
    tl = hierarchical.thread_loads(torch.as_tensor(loads, device=dev),
                                   torch.as_tensor(a, device=dev), thr,
                                   num_nodes=P, threads_per_node=T)
    want_tl = np.zeros(P * T, np.float32)
    np.add.at(want_tl, a * T + want, loads)
    assert np.array_equal(tl.cpu().numpy(), want_tl)


def test_fleet_replay_on_cuda_equals_cpu(dev):
    """The serving fleet replay under the predictive trigger and a slot
    budget: fire steps, placements, moved sessions, deferred counts and
    moved KV on the card equal the CPU's."""
    from repro_torch.runtime.cost import RuntimeCostModel
    from repro_torch.runtime.triggers import PredictiveTrigger
    from repro_torch.serve import replay

    w = replay.ServeWorkload(num_sessions=512, num_replicas=8)
    kw = dict(steps=30, lb_every=10, strategy="diff-comm+predictive",
              slot_capacity=72, trigger=PredictiveTrigger(
                  cost=RuntimeCostModel(t_byte=2e-3, lb_overhead=1.0)))
    g = replay.run_serve_replay(w, device=dev, **kw)
    c = replay.run_serve_replay(w, device="cpu", **kw)
    assert g.lb_fired.sum() > 1
    for f in ("lb_fired", "final_replica_by_uid", "moved_sessions",
              "deferred", "moved_kv_bytes", "occ_max", "max_avg"):
        assert np.array_equal(getattr(g, f), getattr(c, f)), f


# MLA's latent attention: one "kv head" of G = 128 query heads, hd = 576
# (kv_lora_rank 512 + rope 64), values [ckv | 0]; the simt form


def _mla_inputs(dev, B, Sq, T, qdt, kvdt, last, seed):
    """q (B, Sq, 1, 128, 576), keys [ckv | krope], values [ckv | 0];
    query rows ending at ``last[b]``, the cache holding positions
    0..last in slot order and the sentinel past them."""
    G, hd, r = 128, 576, 512
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.normal(size=(B, Sq, 1, G, hd)),
                        dtype=torch.float32, device=dev).to(qdt)
    k = torch.as_tensor(rng.normal(size=(B, T, 1, hd)),
                        dtype=torch.float32, device=dev).to(kvdt)
    v = torch.cat([k[..., :r], torch.zeros_like(k[..., r:])], -1)
    lastt = torch.tensor(last, dtype=torch.int32, device=dev)[:, None]
    qp = (lastt - torch.arange(Sq - 1, -1, -1, dtype=torch.int32,
                               device=dev)).to(torch.int32)
    s = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T)
    kp = torch.where(s <= lastt, s, POS_SENTINEL).to(torch.int32)
    return q, k, v, qp.contiguous(), kp.contiguous()


@pytest.mark.parametrize("B,Sq,T,qdt,kvdt,last,window,prefix", [
    (4, 1, 528, BF16, BF16, [527, 300, 256, 17], 0, 0),     # decode
    (4, 1, 528, BF16, F32, [527, 300, 256, 17], 0, 0),      # f32 cache
    (1, 300, 528, BF16, BF16, [299], 0, 0),                 # prefill
    (1, 96, 160, F32, F32, [95], 0, 0),
    (2, 40, 100, BF16, BF16, [60, 39], 32, 0),              # window
    (2, 40, 100, F32, F32, [60, 39], 0, 24),                # prefix
])
def test_flash_mla_shape_matches_plain(dev, B, Sq, T, qdt, kvdt, last,
                                       window, prefix):
    """K6 at MLA's full-width latent shape against the plain version, in
    the form the rule names (simt), twice bit for bit."""
    args = _mla_inputs(dev, B, Sq, T, qdt, kvdt, last, B + Sq + T)
    assert fops.flash_form(B, Sq, T, 1, 128, 576, qdt, kvdt) == "simt"
    got = _take_form("simt", *args, window=window, prefix_len=prefix)
    assert float(got[..., 512:].abs().max()) == 0.0     # the zero values
    _flash_close(got, chunked_attention(*args, window=window,
                                        prefix_len=prefix),
                 BF16 if BF16 in (qdt, kvdt) else F32)


@pytest.mark.parametrize("G,hd", [(33, 64), (64, 128), (128, 24),
                                  (20, 320), (4, 576)])
def test_flash_simt_past_the_fast_forms(dev, G, hd):
    """The simt form at G > 32 (slices of 16 groups a block) and hd > 288
    (18 columns a lane), decode and prefill."""
    for Sq in (1, 37):
        args = _flash_inputs(dev, 2, Sq, 70, 1, G, hd, F32, F32, G + hd)
        assert fops.flash_form(2, Sq, 70, 1, G, hd, F32, F32) == "simt"
        _flash_close(_take_form("simt", *args), chunked_attention(*args),
                     F32)


@pytest.mark.parametrize("E,R,seed", [(24, 4, 0), (256, 32, 1), (256, 32, 2),
                                      (64, 8, 3)])
def test_repair_capacity_on_cuda_equals_cpu(dev, E, R, seed):
    """The expert repair on the card equals the CPU's: stable sorts of f32
    loads (ties included), integer one-hot sums; capacity-exact."""
    from repro_torch.distributed import ep_balance

    rng = np.random.default_rng(seed)
    a = rng.integers(0, R // 2, size=E).astype(np.int32)
    loads = rng.integers(0, 4, size=E).astype(np.float32)
    loads[: E // 3] = rng.random(E // 3).astype(np.float32)
    kw = dict(num_ranks=R, cap=E // R)
    got = ep_balance.repair_capacity(torch.as_tensor(a, device=dev),
                                     torch.as_tensor(loads, device=dev), **kw)
    want = ep_balance.repair_capacity(torch.as_tensor(a),
                                      torch.as_tensor(loads), **kw)
    assert got.is_cuda and torch.equal(got.cpu(), want)
    assert (torch.bincount(got.long(), minlength=R) == E // R).all()


@pytest.mark.parametrize("strategy,trigger", [("diff-comm", "every"),
                                              ("diff-comm", "threshold"),
                                              ("diff-comm+predictive", None)])
def test_ep_replay_loops_on_cuda_equal_cpu(dev, strategy, trigger):
    """The EP replay's device-resident and host loops on the card are
    equal, and equal the CPU's run: fire steps, placements, slot layout,
    payload signature and moved bytes exactly, max/avg within 2 ulp."""
    from repro_torch.train import ep_runtime as epr

    w = epr.RoutingWorkload(num_experts=64, num_ranks=8, top_k=8,
                            tokens_per_step=512, trace_len=16, seed=1)
    kw = dict(steps=16, strategy=strategy, trigger=trigger, lb_every=4)
    a = epr.run_ep_replay(w, device=dev, **kw)
    b = epr.run_ep_replay(w, device=dev, scan=False, **kw)
    c = epr.run_ep_replay(w, device="cpu", **kw)
    assert a.scanned and not b.scanned and a.lb_fired.sum() > 0
    for f in ("lb_fired", "moved_experts", "moved_bytes", "final_placement",
              "final_slot_expert", "final_wsig", "max_avg"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    for f in ("lb_fired", "moved_experts", "moved_bytes", "final_placement",
              "final_slot_expert", "final_wsig"):
        np.testing.assert_array_equal(getattr(a, f), getattr(c, f),
                                      err_msg=f)
    sp = np.spacing(c.max_avg.astype(np.float32)).astype(np.float64)
    assert (np.abs(a.max_avg - c.max_avg) <= 2 * sp).all()


def _bwd_case(dev, B, S, KV, G, hd, dt, seed):
    g = torch.Generator(dev).manual_seed(seed)
    q = torch.randn((B, S, KV, G, hd), generator=g, device=dev).to(dt)
    k = torch.randn((B, S, KV, hd), generator=g, device=dev).to(dt)
    v = torch.randn((B, S, KV, hd), generator=g, device=dev).to(dt)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(
        B, S).contiguous()
    do = torch.randn((B, S, KV, G, hd), generator=g, device=dev).to(dt)
    return q, k, v, pos, do


@pytest.mark.parametrize("B,S,KV,G,hd,dt,window,prefix,form", [
    (1, 64, 2, 3, 64, torch.float32, 0, 0, "simt"),
    (2, 300, 3, 3, 64, torch.bfloat16, 0, 0, "mma"),   # smollm's heads, B 2
    (1, 70, 2, 3, 64, torch.bfloat16, 0, 0, "mma"),    # ragged S
    (1, 300, 4, 1, 64, torch.bfloat16, 0, 0, "mma"),   # G 1
    (1, 300, 1, 8, 128, torch.bfloat16, 0, 0, "mma"),  # G 8, hd 128
    (1, 200, 1, 32, 16, torch.bfloat16, 0, 0, "mma"),  # G 32, hd 16
    (2, 70, 2, 4, 128, torch.bfloat16, 0, 0, "mma"),
    (1, 130, 2, 2, 48, torch.bfloat16, 0, 0, "mma"),   # hd at run time
    (1, 130, 1, 4, 96, torch.bfloat16, 0, 0, "mma"),
    (1, 300, 2, 3, 64, torch.bfloat16, 64, 0, "mma"),  # window
    (1, 300, 2, 3, 64, torch.bfloat16, 0, 40, "mma"),  # prefix-LM
    (1, 300, 2, 3, 64, torch.float32, 64, 0, "simt"),
    (1, 300, 2, 3, 64, torch.float32, 0, 40, "simt"),
    (2, 200, 1, 4, 24, torch.float32, 0, 0, "simt"),   # reduced MLA latents
    (1, 70, 1, 16, 576, torch.bfloat16, 0, 0, "simt"),  # past hd 128
    (1, 40, 1, 128, 96, torch.float32, 0, 0, "simt"),  # G at its limit
])
def test_flash_attention_bwd_kernel_matches_plain(dev, B, S, KV, G, hd, dt,
                                                  window, prefix, form):
    """K6's backward, in the form ``bwd_form`` names, against the autograd
    of the plain version (f32 inputs, the kernel's own operands upcast):
    f32 within 1e-4 of each gradient's largest magnitude, bf16 within 2e-2
    (bf16 outputs, the forward's output rounded to bf16 in D, and in the
    mma form P and dS rounded to bf16 as tensor-core operands); two calls
    equal bit for bit."""
    q, k, v, pos, do = _bwd_case(dev, B, S, KV, G, hd, dt, 0)
    kw = dict(window=window, prefix_len=prefix)
    o = fops.flash_attention(q, k, v, pos, pos, **kw)
    assert fops.bwd_form(B, S, S, KV, G, hd, dt, dt) == form
    before = fops.bwd_form_launches[form]
    got = fops.flash_attention_bwd(q, k, v, pos, pos, o, do, **kw)
    assert fops.bwd_form_launches[form] == before + 1
    again = fops.flash_attention_bwd(q, k, v, pos, pos, o, do, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    want = attention_bwd_ref(q.float(), k.float(), v.float(), pos, pos,
                             do.float(), **kw)
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    for a, b in zip(got, want):
        assert a.dtype == dt
        assert float((a.float() - b).abs().max()) <= tol * float(
            b.abs().max())


@pytest.mark.parametrize("B,S,KV,G,hd,window,prefix,shift", [
    (2, 2048, 3, 3, 64, 0, 0, 0),      # the training call at B 2
    (2, 300, 2, 3, 64, 0, 0, 40),      # the first 40 rows see no key
    (1, 300, 1, 8, 128, 64, 0, 40),
    (1, 200, 1, 32, 16, 0, 40, 20),
    (2, 70, 2, 4, 128, 0, 0, 0),
])
def test_flash_attention_bwd_mma_form_matches_simt(dev, B, S, KV, G, hd,
                                                   window, prefix, shift):
    """The mma form against the simt form at the same bf16 inputs, within
    2e-2 of each gradient's largest magnitude: both follow the forward's
    visit rule, which the plain version does not, so this holds them to
    each other where rows see no allowed key (keys ``shift`` positions
    ahead of their slots) and where kv slots are unwritten (sentinel
    positions, a tenth of them)."""
    q, k, v, pos, do = _bwd_case(dev, B, S, KV, G, hd, torch.bfloat16, 4)
    kp = pos + shift
    kp[:, S // 3: S // 3 + S // 10] = POS_SENTINEL
    kw = dict(window=window, prefix_len=prefix)
    o = fops.flash_attention(q, k, v, pos, kp, **kw)
    assert fops.bwd_form(B, S, S, KV, G, hd, q.dtype, k.dtype) == "mma"
    got = fops._launch_bwd(q, k, v, pos, kp, o, do, window, prefix, "mma")
    want = fops._launch_bwd(q, k, v, pos, kp, o, do, window, prefix, "simt")
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert float((a.float() - b.float()).abs().max()) <= 2e-2 * float(
            b.float().abs().max())


def test_flash_attention_autograd_launches_both_kernels(dev):
    """Autograd through ``flash_attention`` launches the forward once and
    the backward once, in the mma form at bf16 smollm heads, and gives the
    backward's own gradients bit for bit."""
    q, k, v, pos, do = _bwd_case(dev, 2, 128, 3, 3, 64, torch.bfloat16, 1)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    f0, b0 = fops.KERNEL.launches, fops.BWD_KERNEL.launches
    m0 = fops.bwd_form_launches["mma"]
    o = fops.flash_attention(*leaves, pos, pos)
    grads = torch.autograd.grad(o, leaves, do)
    assert (fops.KERNEL.launches - f0, fops.BWD_KERNEL.launches - b0) == (1, 1)
    assert fops.bwd_form_launches["mma"] == m0 + 1
    want = fops.flash_attention_bwd(q, k, v, pos, pos, o.detach(), do)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))


def test_flash_attention_bwd_rejects_what_it_does_not_take(dev):
    q, k, v, pos, do = _bwd_case(dev, 1, 16, 1, 4, 64, torch.float32, 2)
    o = fops.flash_attention(q, k, v, pos, pos)
    with pytest.raises(ValueError):
        fops.flash_attention_bwd(q, k, v, pos, pos, o, do.to(torch.bfloat16))
    big = torch.zeros((1, 4, 1, 4, 640), device=dev)
    kb = torch.zeros((1, 4, 1, 640), device=dev)
    p4 = pos[:, :4].contiguous()
    with pytest.raises(ValueError):
        fops.flash_attention_bwd(big, kb, kb, p4, p4, big, big)
