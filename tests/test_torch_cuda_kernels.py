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


@pytest.mark.parametrize("n", [0, 1, 4095, 4097, 100_000])
@pytest.mark.parametrize("C", [1, 8, 64, 1024])
def test_scatter_dest_kernel_matches_plain(dev, n, C):
    """dest, counts and ranks exact, padding ids included."""
    rng = np.random.default_rng(n + C)
    ids = torch.as_tensor(rng.integers(-1, C + 1, n), dtype=torch.int32,
                          device=dev)
    d, c, off = mops.scatter_dest(ids, C=C)
    dr, cr = scatter_dest_ref(ids, C=C)
    assert torch.equal(d, dr) and torch.equal(c, cr)
    r, c2 = mops.bucket_ranks(ids, C=C)
    rr, _ = bucket_ranks_ref(ids, C=C)
    assert torch.equal(r, rr) and torch.equal(c2, cr)


def test_scatter_dest_kernel_rejects_large_c(dev):
    with pytest.raises(ValueError):
        mops.scatter_dest(torch.zeros(4, dtype=torch.int32, device=dev),
                          C=mops.MAX_C + 1)


@pytest.mark.parametrize("P,K", [(8, 4), (64, 4), (257, 8), (8192, 8)])
@pytest.mark.parametrize("single_hop", [True, False])
def test_diffusion_kernel_matches_plain(dev, P, K, single_hop):
    """it and stall exact; x, own and flow within 16 f32 ulp of the largest
    load, res within that over the mean load (the kernel sums over P in a
    tree, the plain version in another order).  P = 8192, K = 8 exceeds
    shared memory and takes the global-memory state."""
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


def test_cumsum_repeats_bit_for_bit_on_cuda(dev):
    """``comm_graph.cumsum`` on a card: the same bits on every call, and
    within 1e-5 relative of a float64 prefix sum (torch.cumsum's CUDA scan
    adds floats in a varying order)."""
    from repro_torch.core.comm_graph import cumsum

    v = torch.as_tensor(np.random.default_rng(0).random(1 << 20).astype(
        np.float32) * 8 + 1, device=dev)
    a = cumsum(v)
    for _ in range(3):
        assert torch.equal(cumsum(v), a)
    want = torch.cumsum(v.double(), 0)
    assert float(((a.double() - want).abs() / want).max()) <= 1e-5


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
