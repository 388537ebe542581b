"""Wrappers for the two diffusion kernels, and the rule that picks one.

``diffusion_sweep`` has the per-sweep ``step_fn`` signature of
``core.virtual_lb.virtual_balance`` (the streaming two-pass kernel,
``csrc/diffusion_sweep.cu``); ``diffusion_nsweeps`` has its ``chunk_fn``
signature and is the production stage-2 path.  CPU tensors take the plain
versions (:mod:`.ref`); CUDA tensors a kernel.

Implementation selection (:func:`sweep_impl`):

  * ``"reference"`` — CPU: the plain S-sweep chunk;
  * ``"fused"``     — CUDA, ``P·K <= FUSED_MAX_PK``: the fused S-sweep
                      kernel K1 (``csrc/diffusion.cu``) in the form
                      :func:`k1_form` names:
                        - ``"warp"``  (``P·K <= WARP_MAX_PK``): one warp,
                          the state in shared memory;
                        - ``"block"`` (``P·K <= BLOCK_MAX_PK``): one block
                          of 512 threads, the state in shared memory;
                        - ``"grid"``: a cooperative launch of co-resident
                          blocks, the state in global memory (L2), two grid
                          barriers a sweep;
  * ``"streaming"`` — CUDA, larger problems: the two-pass sweep kernel K2
                      once a sweep inside the plain masked chunk body
                      (:func:`streaming_nsweeps`), the chunk captured as one
                      CUDA graph and replayed.

The limits come from ``benchmarks_torch/diffusion_crossover.py`` on one
H100 (table in ``PERF.md``).  :data:`form_launches` counts K1's calls by
form.
"""
from __future__ import annotations

from collections import OrderedDict

import torch

from repro_torch.core.virtual_lb import reference_nsweeps
from repro_torch.kernels import FLOAT, INT, PTR, CudaKernel, check_cuda
from repro_torch.kernels.diffusion.ref import (diffusion_nsweeps_ref,
                                               diffusion_sweep_ref)

KERNEL = CudaKernel("diffusion_nsweeps", "diffusion.cu", {
    "diffusion_nsweeps_launch": [PTR] * 15 + [INT] * 5 + [FLOAT] * 2
                                + [INT] * 3,
})

# -fmad=false: no FMA contraction, so the kernel rounds where the plain
# version rounds (only the order of the row sums differs)
SWEEP_KERNEL = CudaKernel("diffusion_sweep", "diffusion_sweep.cu", {
    "diffusion_sweep_launch": [PTR] * 9 + [INT, INT, FLOAT, INT],
}, extra_flags=("-fmad=false",))

# dynamic shared memory a block may use (227 KB) less the kernel's static
# reduction stage and the margin the launch keeps
SMEM_LIMIT = 232448 - 1024

# K1's forms by P·K, and the largest P·K that takes K1 at all (above it
# one S = 8 chunk of the streaming path is faster on an H100, or it was not
# measured): benchmarks_torch/diffusion_crossover.py, table in PERF.md.
WARP_MAX_PK = 256
BLOCK_MAX_PK = 4096
FUSED_MAX_PK = 1 << 20

K1_FORMS = ("warp", "block", "grid")
GRID_THREADS = 256      # threads a block of the grid form (csrc GRID_NT)

#: the streaming kernel puts a row on a warp segment, so K <= 32
MAX_K = 32

form_launches = {f: 0 for f in K1_FORMS}


def smem_bytes(P: int, K: int) -> int:
    """Shared-memory working set of the one-block forms: x, own (f32) and
    flow, push (f32), nbr, rev (i32), mask (u8) — ``17·P·K + 8·P``
    bytes."""
    return 17 * P * K + 8 * P


def k1_takes(form: str, P: int, K: int) -> bool:
    """Whether K1's ``form`` takes a (P, K) table: the one-block forms
    while their state fits in shared memory, the grid form always."""
    if form not in K1_FORMS:
        raise ValueError(f"K1 forms are {K1_FORMS}, got {form!r}")
    return form == "grid" or smem_bytes(P, K) <= SMEM_LIMIT


def k1_form(P: int, K: int) -> str:
    """The form of K1 a (P, K) table takes: ``warp`` up to
    :data:`WARP_MAX_PK`, ``block`` up to :data:`BLOCK_MAX_PK`, else
    ``grid``."""
    PK = P * K
    if PK <= WARP_MAX_PK and k1_takes("warp", P, K):
        return "warp"
    if PK <= BLOCK_MAX_PK and k1_takes("block", P, K):
        return "block"
    return "grid"


def k1_launch_shape(form: str, P: int, K: int):
    """``(threads, blocks, smem_bytes)`` of a launch of ``form``; the grid
    form's blocks are those wanted (one row a thread), which the launch
    caps at the co-resident count."""
    if not k1_takes(form, P, K):
        raise ValueError(f"K1 {form} form: P={P}, K={K} needs "
                         f"{smem_bytes(P, K)} B of shared memory, more "
                         f"than {SMEM_LIMIT}")
    if form == "warp":
        return 32, 1, smem_bytes(P, K)
    if form == "block":
        return 512, 1, smem_bytes(P, K)
    return GRID_THREADS, max(1, -(-P // GRID_THREADS)), 0


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
    """The fused S-sweep kernel K1 in the form :func:`k1_form` names,
    whatever :func:`sweep_impl` would pick (CPU tensors take the plain
    chunk); returns the updated ``(x, own, flow, it, res, stall)``."""
    if x.device.type == "cpu":
        return diffusion_nsweeps_ref(
            x, own, flow, it, res, stall, nbr_idx, nbr_mask, rev, alpha,
            n_sweeps=n_sweeps, single_hop=single_hop, tol=tol,
            max_iters=max_iters)
    return _fused_form(k1_form(*nbr_idx.shape), x, own, flow, it, res,
                       stall, nbr_idx, nbr_mask, rev, alpha,
                       n_sweeps=n_sweeps, single_hop=single_hop, tol=tol,
                       max_iters=max_iters)


def _as(t: torch.Tensor, dtype) -> torch.Tensor:
    if t.dtype != dtype:
        t = t.to(dtype)
    return t if t.is_contiguous() else t.contiguous()


def _fused_form(form, x, own, flow, it, res, stall, nbr_idx, nbr_mask, rev,
                alpha, *, n_sweeps: int, single_hop: bool, tol, max_iters):
    """One call of K1 in ``form`` (the path takes :func:`fused_nsweeps`;
    tests and the crossover benchmark name the form).  The outputs are
    fresh tensors; ``it``, ``res`` and ``stall`` are 0-d views of one
    3-word tensor the kernel writes."""
    P, K = nbr_idx.shape
    f32, i32 = torch.float32, torch.int32
    xs, ow, fl = _as(x, f32), _as(own, f32), _as(flow, f32)
    nbr, rv, mask = _as(nbr_idx, i32), _as(rev, i32), _mask_u8(nbr_mask)
    it_in, res_in, stall_in = _as(it, i32), _as(res, f32), _as(stall, i32)
    if not (xs.is_cuda and ow.is_cuda and fl.is_cuda and nbr.is_cuda
            and rv.is_cuda and mask.is_cuda and it_in.is_cuda
            and res_in.is_cuda and stall_in.is_cuda):
        raise ValueError("K1 takes CUDA tensors")
    if fl.shape != (P, K) or xs.shape != (P,) or ow.shape != (P,) \
            or rv.shape != (P, K) or mask.shape != (P, K) \
            or it_in.numel() != 1 or res_in.numel() != 1 \
            or stall_in.numel() != 1:
        raise ValueError(f"shape mismatch: x {tuple(xs.shape)}, flow "
                         f"{tuple(fl.shape)}, nbr {(P, K)}")
    _, blocks, smem = k1_launch_shape(form, P, K)
    dev = xs.device
    x_out = torch.empty(P, dtype=f32, device=dev)
    own_out = torch.empty(P, dtype=f32, device=dev)
    flow_out = torch.empty((P, K), dtype=f32, device=dev)
    stat = torch.empty(3, dtype=i32, device=dev)       # it, res bits, stall
    if form == "grid":
        # push (P·K f32), then one 16-byte partial a block
        pk = -(-P * K // 4) * 4
        scratch = torch.empty(pk + 4 * blocks, dtype=f32, device=dev)
        push, part = scratch.data_ptr(), scratch.data_ptr() + 4 * pk
    else:
        push = part = 0
    KERNEL.launch(
        "diffusion_nsweeps_launch",
        xs.data_ptr(), ow.data_ptr(), fl.data_ptr(), nbr.data_ptr(),
        rv.data_ptr(), mask.data_ptr(), it_in.data_ptr(), res_in.data_ptr(),
        stall_in.data_ptr(), x_out.data_ptr(), own_out.data_ptr(),
        flow_out.data_ptr(), stat.data_ptr(), push, part, P, K,
        int(n_sweeps), int(max_iters), int(bool(single_hop)), float(alpha),
        float(tol), K1_FORMS.index(form), blocks, smem)
    form_launches[form] += 1
    return (x_out, own_out, flow_out, stat[0], stat.view(f32)[1], stat[2])


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
