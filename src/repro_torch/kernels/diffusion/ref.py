"""Plain PyTorch oracles for the diffusion kernels.

They are the balancer's own sweep and chunk (``core/virtual_lb.py``),
re-exported so the kernel tests and ``chip_smoke.py`` have one canonical
oracle path: ``diffusion_sweep_ref`` for the streaming sweep
(``csrc/diffusion_sweep.cu``), ``diffusion_nsweeps_ref`` for the fused
S-sweep chunk (``csrc/diffusion.cu``); ``sweep_tables_ref`` is the plain
version of the streaming kernel's table pass.
"""
import torch

from repro_torch.core.virtual_lb import reference_nsweeps, reference_sweep


def diffusion_sweep_ref(x, own, nbr_idx, nbr_mask, rev, alpha,
                        single_hop: bool = True):
    """One sweep; returns ``(x_new, own_new, flow_step)``."""
    return reference_sweep(x, own, nbr_idx, nbr_mask, rev, alpha, single_hop)


def sweep_tables_ref(nbr_idx, nbr_mask, rev):
    """(2, P) int32: row i's mask word (bit k set where slot k is masked
    in) and its reciprocity word (bit k set where, besides, node i sits at
    slot ``rev[i, k]`` of ``j = nbr_idx[i, k]``'s list and that slot is
    masked in too), each the 32 bits of K <= 32 slots."""
    P, K = nbr_idx.shape
    m = nbr_mask.bool()
    back = torch.where(m, nbr_idx, 0).long() * K + torch.where(m, rev, 0)
    recip = m & (nbr_idx.reshape(-1)[back] == torch.arange(
        P, device=nbr_idx.device)[:, None]) & m.reshape(-1)[back]
    bit = torch.ones(K, dtype=torch.int64, device=nbr_idx.device) \
        << torch.arange(K, device=nbr_idx.device)
    words = torch.stack([(m.long() * bit).sum(1), (recip.long() * bit).sum(1)])
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


diffusion_nsweeps_ref = reference_nsweeps

__all__ = ["diffusion_nsweeps_ref", "diffusion_sweep_ref", "sweep_tables_ref"]
