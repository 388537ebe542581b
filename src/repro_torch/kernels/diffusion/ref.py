"""Plain PyTorch oracles for the diffusion kernels.

They are the balancer's own sweep and chunk (``core/virtual_lb.py``),
re-exported so the kernel tests and ``chip_smoke.py`` have one canonical
oracle path: ``diffusion_sweep_ref`` for the streaming sweep
(``csrc/diffusion_sweep.cu``), ``diffusion_nsweeps_ref`` for the fused
S-sweep chunk (``csrc/diffusion.cu``).
"""
from repro_torch.core.virtual_lb import reference_nsweeps, reference_sweep


def diffusion_sweep_ref(x, own, nbr_idx, nbr_mask, rev, alpha,
                        single_hop: bool = True):
    """One sweep; returns ``(x_new, own_new, flow_step)``."""
    return reference_sweep(x, own, nbr_idx, nbr_mask, rev, alpha, single_hop)


diffusion_nsweeps_ref = reference_nsweeps

__all__ = ["diffusion_nsweeps_ref", "diffusion_sweep_ref"]
