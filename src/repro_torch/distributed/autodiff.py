"""Collectives with a gradient, over a ``distributed.mesh`` mesh.

Each is a ``torch.autograd.Function`` over the mesh's own collectives, so
the transport (NCCL, gloo, gloo-host's copies through the host) is the
mesh's, forward and backward.  They are the JAX package's collectives
under ``shard_map`` as autodiff transposes them:

  * :func:`all_to_all` — the exchange of ``jax.lax.all_to_all``; its
    backward is the reverse exchange (the same permutation of blocks);
  * :func:`leave` — this shard's block along ``dim`` of a tensor the
    group over ``axes`` then holds whole (an all-gather, as leaving the
    MoE layer's sequence-split region gathers the sequence over
    ``"model"``).  What follows runs alike on every member, so each
    member's gradient of the whole is the same one: the backward takes
    this shard's block of it and adds no replicas (adding them would
    give G times the gradient);
  * :func:`enter` — the inverse: this shard's block along ``dim`` of a
    tensor the group holds whole (a slice, as entering that region takes
    this shard's sequence block).  Each member's part of the gradient
    flows back through its own block, so the backward gathers the blocks
    and every member gets the whole gradient.

On a ``ShardMesh`` (one process) :func:`all_to_all` is the same
Function; :func:`leave` and :func:`enter` are for a ``ProcessMesh``,
where the replicas are processes: in one process a gather is tensor
operations whose autograd holds one copy.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.mesh import AxesArg, ProcessMesh, ShardMesh


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh.all_to_all(x, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_to_all(g.contiguous(), ctx.axes), None, None


def all_to_all(mesh: ShardMesh, x: torch.Tensor,
               axes: AxesArg = None) -> torch.Tensor:
    """``mesh.all_to_all(x, axes)`` with the reverse exchange as its
    backward."""
    return _AllToAll.apply(x, mesh, axes)


def _gather(mesh: ProcessMesh, x: torch.Tensor, axes, dim: int):
    """The group's blocks of ``x`` concatenated along ``dim``."""
    block = x.movedim(dim, 0).unsqueeze(0)
    whole = mesh.all_gather(block, axes)
    if whole.dim() == block.dim():          # (1, G·m, ...): a group's
        whole = whole[0]
    return whole.movedim(0, dim)


def _block(mesh: ProcessMesh, x: torch.Tensor, axes, dim: int):
    """This rank's block along ``dim`` of ``x``, the group's whole."""
    G = mesh.size(axes)
    if x.shape[dim] % G:
        raise ValueError(f"extent {x.shape[dim]} does not divide over "
                         f"{G} shards")
    n = x.shape[dim] // G
    return x.narrow(dim, mesh.group_rank(axes, mesh.rank) * n, n)


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather(mesh, x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (_block(ctx.mesh, g, ctx.axes, ctx.dim).contiguous(), None,
                None, None)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _block(mesh, x, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(ctx.mesh, g, ctx.axes, ctx.dim), None, None, None


def _process_mesh(mesh) -> ProcessMesh:
    if not isinstance(mesh, ProcessMesh):
        raise TypeError("leave and enter run over a ProcessMesh; in one "
                        "process the shards' tensors are one tensor")
    return mesh


def leave(mesh: ProcessMesh, x: torch.Tensor, axes: AxesArg = None,
          dim: int = 0) -> torch.Tensor:
    """The group over ``axes`` gathers its blocks ``x`` along ``dim``;
    the backward takes this rank's block of the (replicated) gradient."""
    return _Leave.apply(x, _process_mesh(mesh), axes, dim)


def enter(mesh: ProcessMesh, x: torch.Tensor, axes: AxesArg = None,
          dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x``, which every member of the
    group over ``axes`` holds whole; the backward gathers the blocks'
    gradients."""
    return _Enter.apply(x, _process_mesh(mesh), axes, dim)
