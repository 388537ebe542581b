"""Stage 2 — virtual load balancing (paper §III.B).

First-order diffusion restricted to the stage-1 neighbor graph; only load
magnitudes are exchanged, and the output is the per-edge net transfer each
node should realize with objects in stage 3.  Counterpart of
``repro.core.virtual_lb``.

Single-hop (paper default): load received during the iteration is frozen,
so every unit of transferred load crosses exactly one edge.

Because the graph is symmetric, "receive" is a gather through the
reverse-slot table: ``recv[i, k] = push[nbr[i, k], rev[i, k]]``.

The fixed-point loop runs in chunks of ``sweep_chunk`` masked sweeps
(:func:`reference_nsweeps`, or ``kernels.diffusion.ops.diffusion_nsweeps``,
which picks the fused or the streaming CUDA kernel).  The host reads one
device flag per chunk; the per-sweep activity mask makes the result
independent of the chunk length.  The sweep itself is pluggable
(``step_fn``; default :func:`reference_sweep`, on the card
``ops.diffusion_sweep``).
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch


class VirtualLBResult(NamedTuple):
    target_loads: torch.Tensor  # (P,) converged virtual node loads
    flows: torch.Tensor         # (P, K) net load to send to each neighbor
    iters: torch.Tensor         # scalar i32
    residual: torch.Tensor      # scalar f32 — final neighborhood imbalance


def reverse_slots(nbr_idx: torch.Tensor, nbr_mask: torch.Tensor):
    """(P, K) i32: rev[i, k] = slot of node i in the list of nbr_idx[i, k]
    (the lowest such slot, as ``jnp.argmax`` picks); 0 where masked."""
    P = nbr_idx.shape[0]
    j = torch.where(nbr_mask, nbr_idx, 0).long()
    their_lists = nbr_idx[j]                                  # (P, K, K)
    me = torch.arange(P, device=nbr_idx.device)[:, None, None]
    hit = (their_lists == me).to(torch.uint8)
    # argmax returns the first maximal index (documented), as jnp.argmax
    return torch.where(nbr_mask, hit.argmax(dim=-1), 0).to(torch.int32)


def _gather_nbr(x, nbr_idx, nbr_mask):
    safe = torch.where(nbr_mask, nbr_idx, 0).long()
    return torch.where(nbr_mask, x[safe], x[:, None])


def reference_sweep(x, own, nbr_idx, nbr_mask, rev, alpha, single_hop):
    """One diffusion sweep.  Returns (x_new, own_new, net_flow_step (P,K))."""
    xn = _gather_nbr(x, nbr_idx, nbr_mask)
    push = torch.clamp(alpha * (x[:, None] - xn), min=0.0) * nbr_mask
    if single_hop:
        tot = push.sum(dim=1)
        scale = torch.where(tot > 0,
                            torch.clamp(own / (tot + 1e-30), max=1.0), 1.0)
        push = push * scale[:, None]
    K = nbr_idx.shape[1]
    safe = torch.where(nbr_mask, nbr_idx, 0).long()
    flat = safe * K + torch.where(nbr_mask, rev, 0).long()
    recv = torch.where(nbr_mask, push.reshape(-1)[flat], 0.0)
    sent = push.sum(dim=1)
    return x - sent + recv.sum(dim=1), own - sent, push - recv


def neighborhood_deviation(x, xn, nbr_mask):
    """(P,) max |load - neighborhood mean| over {i}∪N(i), given the
    pre-gathered neighbor loads ``xn`` (P, K)."""
    allx = torch.cat([x[:, None], xn], dim=1)                 # (P, K+1)
    m = torch.cat([torch.ones_like(nbr_mask[:, :1]), nbr_mask], dim=1)
    cnt = m.sum(dim=1)
    mean = torch.where(cnt > 0, (allx * m).sum(dim=1) / cnt, x)
    return torch.where(m, (allx - mean[:, None]).abs(), 0.0).amax(dim=1)


def neighborhood_residual(x, nbr_idx, nbr_mask):
    """max over nodes of (max deviation in {i}∪N(i)) / global mean load."""
    dev = neighborhood_deviation(x, _gather_nbr(x, nbr_idx, nbr_mask),
                                 nbr_mask)
    return (dev / (x.mean() + 1e-30)).amax()


def sweep_chunk_body(sweep, nbr_idx, nbr_mask, rev, alpha, single_hop,
                     tol, max_iters):
    """``carry -> carry`` applying one masked early-exit ``sweep`` (the
    :func:`reference_sweep` signature) to
    ``carry = (x, own, flow, it, res, stall)``.  The activity predicate is
    the outer loop's, checked *before* the sweep; once false, the carry
    passes through unchanged, so S masked sweeps equal S steps of a
    per-sweep loop."""
    def body(carry):
        x, own, flow, it, res, stall = carry
        active = (it < max_iters) & (res > tol) & (stall < 3)
        x2, own2, df = sweep(x, own, nbr_idx, nbr_mask, rev, alpha,
                             single_hop)
        moved = (x2 - x).abs().sum()
        stalled = moved <= 1e-6 * (x2.abs().mean() + 1e-30)
        res2 = neighborhood_residual(x2, nbr_idx, nbr_mask)
        return (torch.where(active, x2, x), torch.where(active, own2, own),
                torch.where(active, flow + df, flow),
                torch.where(active, it + 1, it),
                torch.where(active, res2, res),
                torch.where(active, torch.where(stalled, stall + 1, 0),
                            stall))
    return body


def reference_nsweeps(x, own, flow, it, res, stall, nbr_idx, nbr_mask, rev,
                      alpha, *, n_sweeps: int, single_hop: bool, tol,
                      max_iters, step_fn: Optional[Callable] = None):
    """Plain S-sweep chunk with per-sweep early exit: the CPU path, the
    oracle for the fused CUDA kernel and, with ``step_fn`` the streaming
    kernel, the large-P path on the card.  Returns the updated
    ``(x, own, flow, it, res, stall)`` carry (``it``, ``stall`` i32 and
    ``res`` f32 are 0-d tensors)."""
    body = sweep_chunk_body(step_fn or reference_sweep, nbr_idx, nbr_mask,
                            rev, alpha, single_hop, tol, max_iters)
    carry = (x, own, flow, it, res, stall)
    for _ in range(n_sweeps):
        carry = body(carry)
    return carry


def virtual_balance(node_loads: torch.Tensor, nbr_idx: torch.Tensor,
                    nbr_mask: torch.Tensor, *, alpha: Optional[float] = None,
                    tol: float = 0.02, max_iters: int = 512,
                    single_hop: bool = True,
                    step_fn: Optional[Callable] = None, sweep_chunk: int = 8,
                    chunk_fn: Optional[Callable] = None) -> VirtualLBResult:
    """Iterate diffusion sweeps until every neighborhood is balanced.

    ``alpha`` defaults to 1/(K+1); ``tol`` bounds max neighborhood
    deviation / mean load; the loop also stops at ``max_iters`` sweeps or
    after 3 consecutive stalled sweeps.  ``chunk_fn`` runs one S-sweep
    chunk (default :func:`reference_nsweeps` over ``step_fn``, itself
    defaulting to :func:`reference_sweep`); results do not depend on
    ``sweep_chunk``."""
    P, K = nbr_idx.shape
    dev = node_loads.device
    if alpha is None:
        alpha = 1.0 / (K + 1.0)
    alpha = float(torch.tensor(alpha, dtype=torch.float32))
    rev = reverse_slots(nbr_idx, nbr_mask)
    n_sweeps = max(1, min(int(sweep_chunk), int(max_iters)))
    if chunk_fn is None:
        chunk_fn = functools.partial(reference_nsweeps, step_fn=step_fn)

    x = node_loads.to(torch.float32)
    carry = (x, x, torch.zeros((P, K), dtype=torch.float32, device=dev),
             torch.zeros((), dtype=torch.int32, device=dev),
             neighborhood_residual(x, nbr_idx, nbr_mask),
             torch.zeros((), dtype=torch.int32, device=dev))
    while True:
        _, _, _, it, res, stall = carry
        # one device read per chunk: the loop condition
        if not bool((it < max_iters) & (res > tol) & (stall < 3)):
            break
        carry = chunk_fn(*carry, nbr_idx, nbr_mask, rev, alpha,
                         n_sweeps=n_sweeps, single_hop=single_hop, tol=tol,
                         max_iters=max_iters)
    x, _, flows, it, res, _ = carry
    return VirtualLBResult(x, flows, it, res)
