"""Wrappers for the two diffusion kernels, and the rule that picks one.

``diffusion_sweep`` has the per-sweep ``step_fn`` signature of
``core.virtual_lb.virtual_balance`` (the streaming two-pass kernel,
``csrc/diffusion_sweep.cu``); ``diffusion_nsweeps`` has its ``chunk_fn``
signature and is the production stage-2 path.  CPU tensors take the plain
versions (:mod:`.ref`); CUDA tensors a kernel.

Implementation selection (:func:`sweep_impl`):

  * ``"reference"`` — CPU: the plain S-sweep chunk;
  * ``"fused"``     — CUDA, ``P·K <= FUSED_MAX_PK``: the fused S-sweep
                      kernel (``csrc/diffusion.cu``), one thread block with
                      its state in shared memory when :func:`smem_bytes`
                      fits :data:`SMEM_LIMIT`, else in global memory (L2);
  * ``"streaming"`` — CUDA, larger problems: the two-pass sweep kernel once
                      a sweep inside the plain masked chunk body
                      (:func:`streaming_nsweeps`), the chunk captured as one
                      CUDA graph and replayed, so that its forty-odd small
                      launches a sweep cost device time, not host time.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from repro_torch.core.virtual_lb import reference_nsweeps
from repro_torch.kernels import FLOAT, INT, PTR, CudaKernel, check_cuda
from repro_torch.kernels.diffusion.ref import (diffusion_nsweeps_ref,
                                               diffusion_sweep_ref)

KERNEL = CudaKernel("diffusion_nsweeps", "diffusion.cu", {
    "diffusion_nsweeps_launch": [PTR] * 12 + [INT] * 5 + [FLOAT] * 2
                                + [INT],
})

# -fmad=false: no FMA contraction, so the kernel rounds where the plain
# version rounds (only the order of the row sums differs)
SWEEP_KERNEL = CudaKernel("diffusion_sweep", "diffusion_sweep.cu", {
    "diffusion_sweep_launch": [PTR] * 9 + [INT, INT, FLOAT, INT],
}, extra_flags=("-fmad=false",))

# dynamic shared memory a block may use (227 KB) less the kernel's static
# reduction buffers (3 x 512 floats) and scalars
SMEM_LIMIT = 232448 - 8192

# Largest P·K the fused one-block kernel takes; above it one S = 8 chunk of
# the streaming path is faster on an H100 (benchmarks_torch/
# diffusion_crossover.py, table in PERF.md).
FUSED_MAX_PK = 32768

#: the streaming kernel puts a row on a warp segment, so K <= 32
MAX_K = 32


def smem_bytes(P: int, K: int) -> int:
    """Shared-memory working set: x, own (f32) and flow, push (f32), nbr,
    rev (i32), mask (u8) — ``17·P·K + 8·P`` bytes."""
    return 17 * P * K + 8 * P


def sweep_impl(P: int, K: int, device) -> str:
    """Which implementation :func:`diffusion_nsweeps` selects for a (P, K)
    table on ``device``."""
    if torch.device(device).type == "cpu":
        return "reference"
    if P * K <= FUSED_MAX_PK or K > MAX_K:
        return "fused"
    return "streaming"


def _mask_u8(mask: torch.Tensor) -> torch.Tensor:
    """The mask as contiguous uint8; a bool tensor is reinterpreted, not
    copied."""
    mask = mask.contiguous()
    if mask.dtype == torch.bool:
        return mask.view(torch.uint8)
    return mask.to(torch.uint8)


def diffusion_sweep(x, own, nbr_idx, nbr_mask, rev, alpha, single_hop=True):
    """One diffusion sweep (the streaming kernel); returns ``(x_new,
    own_new, flow_step)``."""
    if x.device.type == "cpu":
        return diffusion_sweep_ref(x, own, nbr_idx, nbr_mask, rev, alpha,
                                   single_hop)
    P, K = nbr_idx.shape
    xs = x.to(torch.float32).contiguous()
    ow = own.to(torch.float32).contiguous()
    nbr = nbr_idx.to(torch.int32).contiguous()
    rv = rev.to(torch.int32).contiguous()
    mask = _mask_u8(nbr_mask)
    check_cuda(xs, ow, nbr, rv, mask)
    if xs.shape != (P,) or ow.shape != (P,) or rv.shape != (P, K) \
            or mask.shape != (P, K):
        raise ValueError(f"shape mismatch: x {tuple(xs.shape)}, own "
                         f"{tuple(ow.shape)}, nbr {(P, K)}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"diffusion_sweep takes 1 <= K <= {MAX_K}, got {K}")
    push = torch.empty((P, K), dtype=torch.float32, device=x.device)
    x_out = torch.empty_like(xs)
    own_out = torch.empty_like(ow)
    flow = torch.empty((P, K), dtype=torch.float32, device=x.device)
    SWEEP_KERNEL.launch(
        "diffusion_sweep_launch", xs.data_ptr(), ow.data_ptr(),
        nbr.data_ptr(), rv.data_ptr(), mask.data_ptr(), push.data_ptr(),
        x_out.data_ptr(), own_out.data_ptr(), flow.data_ptr(), P, K,
        float(alpha), int(bool(single_hop)))
    return x_out, own_out, flow


def fused_nsweeps(x, own, flow, it, res, stall, nbr_idx, nbr_mask, rev,
                  alpha, *, n_sweeps: int, single_hop: bool, tol,
                  max_iters):
    """The fused S-sweep kernel, whatever :func:`sweep_impl` would pick
    (CPU tensors take the plain chunk); returns the updated
    ``(x, own, flow, it, res, stall)``."""
    if x.device.type == "cpu":
        return diffusion_nsweeps_ref(
            x, own, flow, it, res, stall, nbr_idx, nbr_mask, rev, alpha,
            n_sweeps=n_sweeps, single_hop=single_hop, tol=tol,
            max_iters=max_iters)
    P, K = nbr_idx.shape
    x_out = x.to(torch.float32).contiguous().clone()
    own_out = own.to(torch.float32).contiguous().clone()
    flow_out = flow.to(torch.float32).contiguous().clone()
    nbr = nbr_idx.to(torch.int32).contiguous()
    rv = rev.to(torch.int32).contiguous()
    mask = _mask_u8(nbr_mask)
    it_in = it.to(torch.int32).reshape(1)
    stall_in = stall.to(torch.int32).reshape(1)
    res_in = res.to(torch.float32).reshape(1)
    check_cuda(x_out, own_out, flow_out, nbr, rv, mask, it_in, stall_in,
               res_in)
    if flow_out.shape != (P, K) or x_out.shape != (P,):
        raise ValueError(f"shape mismatch: x {tuple(x_out.shape)}, flow "
                         f"{tuple(flow_out.shape)}, nbr {(P, K)}")
    use_smem = smem_bytes(P, K) <= SMEM_LIMIT
    push = (torch.empty(0, dtype=torch.float32, device=x.device) if use_smem
            else torch.empty((P, K), dtype=torch.float32, device=x.device))
    istat = torch.empty(2, dtype=torch.int32, device=x.device)  # it, stall
    res_out = torch.empty(1, dtype=torch.float32, device=x.device)
    KERNEL.launch(
        "diffusion_nsweeps_launch",
        x_out.data_ptr(), own_out.data_ptr(), flow_out.data_ptr(),
        nbr.data_ptr(), rv.data_ptr(), mask.data_ptr(), push.data_ptr(),
        it_in.data_ptr(), stall_in.data_ptr(), res_in.data_ptr(),
        istat.data_ptr(), res_out.data_ptr(),
        P, K, int(n_sweeps), int(max_iters), int(bool(single_hop)),
        float(alpha), float(tol), int(use_smem))
    return x_out, own_out, flow_out, istat[0], res_out[0], istat[1]


class _StreamingChunk:
    """``reference_nsweeps(step_fn=diffusion_sweep)`` for one (P, K,
    n_sweeps, single_hop, tol, max_iters, alpha) on one device, captured as
    a CUDA graph over static buffers.  A call copies its carry and tables
    into the buffers, replays the graph and returns copies of the outputs
    (the buffers are overwritten by the next call)."""

    def __init__(self, P, K, device, alpha, kw):
        f32, i32 = torch.float32, torch.int32
        self.n_sweeps = kw["n_sweeps"]
        self.ins = [torch.zeros(P, dtype=f32, device=device),
                    torch.zeros(P, dtype=f32, device=device),
                    torch.zeros((P, K), dtype=f32, device=device),
                    torch.zeros((), dtype=i32, device=device),
                    torch.zeros((), dtype=f32, device=device),
                    torch.zeros((), dtype=i32, device=device),
                    torch.zeros((P, K), dtype=i32, device=device),
                    torch.zeros((P, K), dtype=torch.bool, device=device),
                    torch.zeros((P, K), dtype=i32, device=device)]

        def body():
            return reference_nsweeps(*self.ins, alpha, **kw,
                                     step_fn=diffusion_sweep)

        # warm up on a side stream (real launches), as graph capture asks
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        counted = SWEEP_KERNEL.launches
        with torch.cuda.graph(self.graph):
            self.outs = body()
        SWEEP_KERNEL.launches = counted    # capture launches nothing

    def __call__(self, *carry_and_tables):
        for buf, t in zip(self.ins, carry_and_tables):
            buf.copy_(t)
        self.graph.replay()
        SWEEP_KERNEL.launches += self.n_sweeps   # one sweep kernel a sweep
        return tuple(o.clone() for o in self.outs)


_CHUNKS: "OrderedDict[tuple, _StreamingChunk]" = OrderedDict()
_CHUNKS_MAX = 8


def streaming_nsweeps(x, own, flow, it, res, stall, nbr_idx, nbr_mask, rev,
                      alpha, *, n_sweeps: int, single_hop: bool, tol,
                      max_iters):
    """The streaming S-sweep chunk: the sweep kernel inside the plain
    masked chunk body, replayed from a CUDA graph captured once per
    configuration (equal, launch for launch, to
    ``reference_nsweeps(..., step_fn=diffusion_sweep)``, which CPU tensors
    take)."""
    kw = dict(n_sweeps=int(n_sweeps), single_hop=bool(single_hop),
              tol=float(tol), max_iters=int(max_iters))
    if x.device.type == "cpu":
        return reference_nsweeps(x, own, flow, it, res, stall, nbr_idx,
                                 nbr_mask, rev, alpha, **kw,
                                 step_fn=diffusion_sweep)
    P, K = nbr_idx.shape
    check_cuda(x, nbr_idx, nbr_mask, rev)
    key = (P, K, float(alpha), str(x.device), *kw.values())
    chunk = _CHUNKS.get(key)
    if chunk is None:
        chunk = _CHUNKS[key] = _StreamingChunk(P, K, x.device, float(alpha),
                                               kw)
        while len(_CHUNKS) > _CHUNKS_MAX:               # drop the oldest
            _CHUNKS.popitem(last=False)
    else:
        _CHUNKS.move_to_end(key)
    return chunk(x, own, flow, it, res, stall, nbr_idx, nbr_mask, rev)


def diffusion_nsweeps(x, own, flow, it, res, stall, nbr_idx, nbr_mask, rev,
                      alpha, *, n_sweeps: int, single_hop: bool, tol,
                      max_iters):
    """S-sweep chunk (``chunk_fn`` for ``virtual_balance``) by
    :func:`sweep_impl`; returns the updated
    ``(x, own, flow, it, res, stall)`` carry."""
    impl = sweep_impl(*nbr_idx.shape, x.device)
    kw = dict(n_sweeps=n_sweeps, single_hop=single_hop, tol=tol,
              max_iters=max_iters)
    args = (x, own, flow, it, res, stall, nbr_idx, nbr_mask, rev, alpha)
    if impl == "fused":
        return fused_nsweeps(*args, **kw)
    if impl == "streaming":
        return streaming_nsweeps(*args, **kw)
    return diffusion_nsweeps_ref(*args, **kw)
