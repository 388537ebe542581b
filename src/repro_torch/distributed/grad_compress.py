"""Error-feedback int8 gradient compression (counterpart of
``repro.distributed.grad_compress``).

The EF-SGD construction (Karimireddy et al. 2019): each step compresses
``grad + residual`` to per-tensor-scaled int8 and carries the quantization
error into the next step's residual.  Exposed as a gradient transform
between backward and the optimizer
(``train_step.make_train_step(grad_transform=...)``): on a data-parallel
mesh the collective would move the int8 values; on one card it shows the
arithmetic.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models.params import tree_leaves, tree_map


def init_residual(params) -> Any:
    """f32 zeros like ``params``, on each tensor's device."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _compress_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 → (int8, scale): symmetric per-tensor scaling."""
    amax = torch.max(torch.abs(g))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _decompress_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress(grads, residual) -> Tuple[Any, Any]:
    """``(decompressed grads to feed the optimizer, new residual)``."""

    def one(g, r):
        g32 = g.to(torch.float32) + r
        deq = _decompress_leaf(*_compress_leaf(g32))
        return deq, g32 - deq

    out = [one(g, r) for g, r in zip(tree_leaves(grads),
                                     tree_leaves(residual))]
    it0, it1 = iter([o[0] for o in out]), iter([o[1] for o in out])
    return (tree_map(lambda _: next(it0), grads),
            tree_map(lambda _: next(it1), grads))


def compression_error(grads, residual) -> torch.Tensor:
    """Relative L2 error of one compress round (diagnostics)."""
    deq, _ = compress(grads, residual)
    num = torch.sqrt(sum(torch.sum((a.to(torch.float32) - b) ** 2)
                         for a, b in zip(tree_leaves(grads),
                                         tree_leaves(deq))))
    den = torch.sqrt(sum(torch.sum(a.to(torch.float32) ** 2)
                         for a in tree_leaves(grads)))
    return num / torch.clamp(den, min=1e-30)
