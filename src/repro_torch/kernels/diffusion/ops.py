"""Wrapper for the fused diffusion S-sweep kernel (``csrc/diffusion.cu``).

``diffusion_nsweeps`` has the ``chunk_fn`` signature of
``core.virtual_lb.virtual_balance``: CPU tensors take the plain chunk
(:mod:`.ref`), CUDA tensors the kernel.  The kernel is one thread block
running the S sweeps; its state sits in shared memory when
:func:`smem_bytes` fits :data:`SMEM_LIMIT`, else in global memory (L2).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import FLOAT, INT, PTR, CudaKernel, check_cuda
from repro_torch.kernels.diffusion.ref import diffusion_nsweeps_ref

KERNEL = CudaKernel("diffusion_nsweeps", "diffusion.cu", {
    "diffusion_nsweeps_launch": [PTR] * 12 + [INT] * 5 + [FLOAT] * 2
                                + [INT],
})

# dynamic shared memory a block may use (227 KB) less the kernel's static
# reduction buffers (3 x 512 floats) and scalars
SMEM_LIMIT = 232448 - 8192


def smem_bytes(P: int, K: int) -> int:
    """Shared-memory working set: x, own (f32) and flow, push (f32), nbr,
    rev (i32), mask (u8) — ``17·P·K + 8·P`` bytes."""
    return 17 * P * K + 8 * P


def diffusion_nsweeps(x, own, flow, it, res, stall, nbr_idx, nbr_mask, rev,
                      alpha, *, n_sweeps: int, single_hop: bool, tol,
                      max_iters):
    """Fused S-sweep chunk; returns the updated
    ``(x, own, flow, it, res, stall)`` carry."""
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
    mask = nbr_mask.to(torch.uint8).contiguous()
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
