"""Wrapper for the particle-push kernel (``csrc/pic_push.cu``): CPU
tensors take the plain version (:mod:`.ref`), CUDA tensors the kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels import FLOAT, INT, PTR, CudaKernel, check_cuda
from repro_torch.kernels.pic_push.ref import pic_push_ref

# -fmad=false: no FMA contraction, so the kernel rounds where the plain
# version rounds (0-1 ulp apart; sqrt and division are IEEE in both)
KERNEL = CudaKernel("pic_push", "pic_push.cu", {
    "pic_push_launch": [PTR] * 10 + [INT, INT, FLOAT, FLOAT],
}, extra_flags=("-fmad=false",))


def pic_push(grid_q, x, y, vx, vy, q, *, L: int, dt: float = 1.0,
             mass: float = 1.0):
    """Advance particles one step.  Returns ``(x, y, vx, vy)``."""
    if x.device.type == "cpu":
        return pic_push_ref(grid_q, x, y, vx, vy, q, L=L, dt=dt, mass=mass)
    g = grid_q.to(torch.float32).contiguous()
    ins = [a.to(torch.float32).contiguous() for a in (x, y, vx, vy, q)]
    check_cuda(g, *ins)
    n = ins[0].shape[0]
    if g.shape != (L, L) or any(a.shape != (n,) for a in ins):
        raise ValueError("pic_push expects grid (L, L) and (N,) particles")
    outs = [torch.empty_like(ins[0]) for _ in range(4)]
    if n:
        KERNEL.launch("pic_push_launch", g.data_ptr(),
                      *(a.data_ptr() for a in ins),
                      *(o.data_ptr() for o in outs), n, L, float(dt),
                      float(mass))
    return tuple(outs)
