"""Plain PyTorch oracle for the PIC PRK particle push.

Same operation order as the kernel (``csrc/pic_push.cu``, built without
FMA contraction) and as ``repro.kernels.pic_push.ref``.  The periodic wrap
is ``jnp.mod``'s: ``fmod``, then ``+L`` where the remainder is non-zero and
its sign differs from L's (``torch.remainder`` computes ``a - b·floor(a/b)``
and can differ in the last bit).
"""
from __future__ import annotations

import torch


def jnp_mod(a: torch.Tensor, b: float) -> torch.Tensor:
    """``jnp.mod`` on floats: result has the sign of ``b``."""
    r = torch.fmod(a, b)
    fix = (r != 0) & ((r < 0) != (b < 0))
    return torch.where(fix, r + b, r)


def pic_push_ref(grid_q, x, y, vx, vy, q, *, L: int, dt: float = 1.0,
                 mass: float = 1.0):
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    i0 = torch.floor(x).to(torch.int32)
    j0 = torch.floor(y).to(torch.int32)
    fx = torch.zeros_like(x)
    fy = torch.zeros_like(y)
    gf = grid_q.to(torch.float32).reshape(-1)
    for di in (0, 1):
        for dj in (0, 1):
            ci = torch.remainder(i0 + di, L)          # integer: exact
            cj = torch.remainder(j0 + dj, L)
            qc = gf[(ci * L + cj).long()]
            dx = x - (i0 + di).to(torch.float32)
            dy = y - (j0 + dj).to(torch.float32)
            r2 = dx * dx + dy * dy
            r = torch.sqrt(r2)
            f = q * qc / torch.clamp(r2, min=1e-12)
            fx = fx + f * dx / torch.clamp(r, min=1e-6)
            fy = fy + f * dy / torch.clamp(r, min=1e-6)
    ax, ay = fx / mass, fy / mass
    xn = jnp_mod(x + vx * dt + 0.5 * ax * dt * dt, float(L))
    yn = jnp_mod(y + vy * dt + 0.5 * ay * dt * dt, float(L))
    return xn, yn, vx + ax * dt, vy + ay * dt
