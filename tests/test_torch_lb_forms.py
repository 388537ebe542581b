"""The pure rules that pick the forms of K4 (the chare histogram) and K1
(the fused diffusion chunk) in the PyTorch port, at the PIC, simulator
and crossover shapes; and the CPU paths of both wrappers against the JAX
package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import virtual_lb as j_vlb
from repro.kernels.histogram.ref import histogram_ref as j_histogram_ref
from repro_torch.core import virtual_lb as t_vlb
from repro_torch.kernels.diffusion import ops as dops
from repro_torch.kernels.histogram import ops as hops

PIC_N, PIC_C = 1 << 24, 144


# ------------------------------------------------------------------ K4 --


def test_histogram_plan_at_the_pic_shape():
    """2^24 ids over 144 chares: the private form, one block an SM of the
    H100, the columns (144 x 256 f32) the larger shared-memory use."""
    assert hops.histogram_plan(PIC_N, PIC_C) == (
        "private", 132, 4 * 144 * 256)
    assert hops.histogram_plan(PIC_N, PIC_C, sms=114)[1] == 114


@pytest.mark.parametrize("n,blocks", [(0, 1), (1, 1), (4099, 1), (4100, 2),
                                      (4096 * 50, 50), (1 << 30, 132)])
def test_histogram_plan_blocks(n, blocks):
    """No more blocks than stretches of 256 threads x 4 vectors of 4 ids
    (the tail past the last whole vector does not count), and at most one
    private block an SM."""
    assert hops.histogram_plan(n, PIC_C)[1] == blocks


def test_histogram_plan_private_limit():
    """The largest private C fills the shared memory a block may use
    beside the kernel's static variables; one more takes the shared form,
    whose histogram is C floats a block."""
    c = hops.PRIVATE_MAX_C
    form, blocks, smem = hops.histogram_plan(PIC_N, c)
    assert (form, smem) == ("private", 4 * c * hops.THREADS)
    assert smem + 1024 <= hops.SMEM_MAX < smem + 1024 + 4 * hops.THREADS
    assert hops.histogram_plan(PIC_N, c + 1) == ("shared", 264, 4 * (c + 1))
    assert hops.histogram_plan(PIC_N, hops.MAX_C)[2] == 48 * 1024


@pytest.mark.parametrize("C", [1, 2, 3])
def test_histogram_plan_small_c_holds_the_partials(C):
    """The last block copies the blocks' partials (C per block) into the
    columns' shared memory, which holds them for up to THREADS blocks."""
    form, blocks, smem = hops.histogram_plan(PIC_N, C, sms=10_000)
    assert (form, blocks) == ("private", hops.THREADS)
    assert smem == 4 * C * hops.THREADS >= 4 * blocks * C


@pytest.mark.parametrize("C", [0, hops.MAX_C + 1])
def test_histogram_plan_refuses_c_out_of_range(C):
    with pytest.raises(ValueError):
        hops.histogram_plan(10, C)


@pytest.mark.parametrize("C", [1, 144, hops.PRIVATE_MAX_C + 1, hops.MAX_C])
def test_histogram_cpu_takes_every_c_and_matches_jax(C):
    """The CPU path (the plain version) takes every C up to MAX_C and
    equals the JAX package's reference, padding ids included."""
    rng = np.random.default_rng(C)
    ids = rng.integers(-3, C + 3, 5003).astype(np.int32)
    w = rng.random(5003).astype(np.float32)
    got = hops.histogram(torch.as_tensor(ids), torch.as_tensor(w), C=C)
    want = np.asarray(j_histogram_ref(jnp.asarray(ids), jnp.asarray(w),
                                      C=C))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
    ones = np.ones_like(w)
    got1 = hops.histogram(torch.as_tensor(ids), torch.as_tensor(ones), C=C)
    np.testing.assert_array_equal(got1.numpy(), np.asarray(
        j_histogram_ref(jnp.asarray(ids), jnp.asarray(ones), C=C)))


# ------------------------------------------------------------------ K1 --


@pytest.mark.parametrize("P,K,form", [
    (8, 4, "warp"),                 # the PIC path
    (2, 1, "warp"),                 # a two-replica scheduler
    (64, 4, "warp"), (32, 8, "warp"),
    (65, 4, "block"), (128, 4, "block"), (512, 8, "block"),
    (1024, 4, "block"),
    (1025, 4, "grid"), (8192, 8, "grid"),   # the simulator path
    (32768, 8, "grid"), (131072, 4, "grid"), (131072, 8, "grid"),
])
def test_k1_form_rule(P, K, form):
    assert dops.k1_form(P, K) == form


def test_k1_form_limits_are_ordered():
    assert dops.WARP_MAX_PK <= dops.BLOCK_MAX_PK <= dops.FUSED_MAX_PK
    # the one-block forms' limits keep their state in shared memory
    for pk in (dops.WARP_MAX_PK, dops.BLOCK_MAX_PK):
        assert dops.k1_takes("block", pk // 2, 2)


@pytest.mark.parametrize("form", ["warp", "block"])
def test_k1_one_block_forms_need_shared_memory(form):
    """17 P K + 8 P bytes of state: P = 8192, K = 1 fits, K = 2 does not
    (the grid form takes every shape)."""
    assert dops.smem_bytes(8192, 1) <= dops.SMEM_LIMIT
    assert dops.k1_takes(form, 8192, 1)
    assert not dops.k1_takes(form, 8192, 2)
    assert dops.k1_takes("grid", 8192, 2)
    with pytest.raises(ValueError):
        dops.k1_launch_shape(form, 8192, 2)
    with pytest.raises(ValueError):
        dops.k1_takes("cluster", 8, 4)


@pytest.mark.parametrize("form,P,K,shape", [
    ("warp", 8, 4, (32, 1, 17 * 32 + 64)),
    ("block", 512, 8, (512, 1, 17 * 4096 + 8 * 512)),
    ("grid", 8192, 8, (256, 32, 0)),
    ("grid", 32768, 8, (256, 128, 0)),
    ("grid", 1000, 4, (256, 4, 0)),
])
def test_k1_launch_shape(form, P, K, shape):
    """Threads, blocks and dynamic shared memory a launch asks for (the
    grid form one row a thread; the launch caps its blocks at the
    co-resident count)."""
    assert dops.k1_launch_shape(form, P, K) == shape


@pytest.mark.parametrize("P,K", [(8, 4), (8192, 8), (32768, 8),
                                 (131072, 8), (131073, 8), (1 << 20, 2),
                                 (64, 40)])
def test_sweep_impl_agrees_with_fused_max_pk(P, K):
    want = ("fused" if P * K <= dops.FUSED_MAX_PK or K > dops.MAX_K
            else "streaming")
    assert dops.sweep_impl(P, K, "cuda") == want
    assert dops.sweep_impl(P, K, "cpu") == "reference"


def test_simulator_path_takes_k1():
    """Stage 2 of the simulator path (P = 8192, K = 8) takes K1's grid
    form: the crossover table puts it below the streaming chunk."""
    assert dops.sweep_impl(8192, 8, "cuda") == "fused"
    assert dops.k1_form(8192, 8) == "grid"


@pytest.mark.parametrize("single_hop", [True, False])
def test_fused_nsweeps_cpu_matches_jax_chunk(single_hop):
    """On the CPU, K1's wrapper takes the plain chunk: it and stall equal
    to the JAX package's jitted chunk, floats within 16 ulp of the largest
    load."""
    P, K = 40, 4
    rng = np.random.default_rng(5)
    cols = [(np.arange(P) + s) % P for s in (-2, -1, 1, 2)]
    nbr = np.stack(cols, 1).astype(np.int32)
    mask = np.ones_like(nbr, bool)
    mask[::7, 1] = False
    mask[(np.arange(0, P, 7) - 1) % P, 2] = False
    x = (rng.random(P) * 10).astype(np.float32)
    alpha = np.float32(1.0 / (K + 1.0))
    t = [torch.as_tensor(a) for a in (x, nbr, mask)]
    rev = t_vlb.reverse_slots(t[1], t[2])
    carry = (t[0], t[0], torch.zeros((P, K)),
             torch.zeros((), dtype=torch.int32),
             t_vlb.neighborhood_residual(t[0], t[1], t[2]),
             torch.zeros((), dtype=torch.int32))
    kw = dict(n_sweeps=8, single_hop=single_hop, tol=0.02, max_iters=512)
    got = dops.fused_nsweeps(*carry, t[1], t[2], rev, float(alpha), **kw)
    jx = jnp.asarray(x)
    jrev = j_vlb.reverse_slots(jnp.asarray(nbr), jnp.asarray(mask))
    jcarry = (jx, jx, jnp.zeros((P, K), jnp.float32), jnp.int32(0),
              j_vlb.neighborhood_residual(jx, jnp.asarray(nbr),
                                          jnp.asarray(mask)),
              jnp.int32(0))
    chunk = jax.jit(j_vlb.reference_nsweeps,
                    static_argnames=("n_sweeps", "single_hop"))
    want = chunk(*jcarry, jnp.asarray(nbr),
                                   jnp.asarray(mask), jrev, alpha, **kw)
    assert int(got[3]) == int(want[3]) and int(got[5]) == int(want[5])
    ulp = np.spacing(np.float32(x.max()))
    for i in (0, 1, 2):
        assert np.abs(got[i].numpy() - np.asarray(want[i])).max() <= 16 * ulp
