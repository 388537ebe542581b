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
    and every member gets the whole gradient;
  * :func:`tp_in` — the input of a column-parallel product over
    ``"model"``: the identity forward; each member's backward holds the
    part of the replicated input's gradient its columns give, so the
    backward is their sum over the group;
  * :func:`tp_out` — the output of a row-parallel product: the sum of the
    members' partial products forward, the identity backward (what
    follows runs alike on every member); :func:`row_parallel` is the
    product and its sum, in a 16-bit type with the partials kept in f32
    so that the sum is rounded once, as one product over the whole rows
    is;
  * :func:`fsdp_gather` — the gather-before-use of a leaf stored as
    blocks over ``axes`` whose members compute with other tokens (the
    ``"data"`` axes of FSDP), or each compute a part of one use: the
    all-gather forward, a reduce-scatter backward (the sum of the
    members' gradients of the whole, then this rank's block).  Unlike
    :func:`leave`, whose members hold the same tokens and so the same
    gradient, it adds them.

Every float sum is gathered and added in member order (``mesh.psum`` and
``mesh.reduce_scatter``), so each rank gets the same bits.

On a ``ShardMesh`` (one process) :func:`all_to_all` is the same
Function; the others are for a ``ProcessMesh``, where the replicas are
processes: in one process a gather is tensor operations whose autograd
holds one copy.
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
        raise TypeError("leave, enter, tp_in, tp_out and fsdp_gather run "
                        "over a ProcessMesh; in one process the shards' "
                        "tensors are one tensor")
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


class _TPIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.psum(g.unsqueeze(0), ctx.axes).reshape(g.shape),
                None, None)


class _TPOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh, axes):
        return mesh.psum(y.unsqueeze(0), axes).reshape(y.shape)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _FSDPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather(mesh, w, axes, dim)

    @staticmethod
    def backward(ctx, g):
        part = g.movedim(ctx.dim, 0).contiguous().unsqueeze(0)
        block = ctx.mesh.reduce_scatter(part, ctx.axes)[0]
        return block.movedim(0, ctx.dim).contiguous(), None, None, None


def tp_in(x: torch.Tensor, mesh: ProcessMesh,
          axes: AxesArg = "model") -> torch.Tensor:
    """``x`` (replicated over ``axes``) entering a column-parallel
    product: the identity forward; the backward sums the members'
    partial gradients over ``axes``."""
    return _TPIn.apply(x, _process_mesh(mesh), axes)


def tp_out(y: torch.Tensor, mesh: ProcessMesh,
           axes: AxesArg = "model") -> torch.Tensor:
    """The sum over ``axes`` of the members' partials ``y`` (a
    row-parallel product's), in member order; the identity backward."""
    return _TPOut.apply(y, _process_mesh(mesh), axes)


def fsdp_gather(w: torch.Tensor, mesh: ProcessMesh, axes: AxesArg,
                dim: int) -> torch.Tensor:
    """The group over ``axes`` gathers its blocks ``w`` along ``dim``; the
    backward is a reduce-scatter: the members' gradients added in member
    order, then this rank's block."""
    return _FSDPGather.apply(w, _process_mesh(mesh), axes, dim)


class _ProductF32(torch.autograd.Function):
    """``a @ b`` of 16-bit (n, k) and (k, m) matrices as f32: on a card
    the tensor cores' f32 accumulator (``torch.mm``'s ``out_dtype``),
    on the CPU an f32 product.  The backward takes the gradient in the
    operands' type, as the backward of their 16-bit product would."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            return torch.mm(a, b, out_dtype=torch.float32)
        return a.float() @ b.float()

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return g @ b.T, a.T @ g


def row_parallel(h: torch.Tensor, w: torch.Tensor, mesh: ProcessMesh,
                 axes: AxesArg = "model") -> torch.Tensor:
    """``tp_out(h @ w)``: a row-parallel product (``h``'s last dim and
    ``w``'s rows this rank's block) summed over ``axes``, in ``h``'s
    type.  In a 16-bit type each member's partial leaves its product in
    f32, the partials are added in f32 and the sum is rounded once, as
    the product over the whole rows is rounded once; rounding each
    partial to 16 bits first would add one rounding a member."""
    if h.dtype not in (torch.bfloat16, torch.float16):
        return tp_out(h @ w, mesh, axes)
    part = _ProductF32.apply(h.reshape(-1, h.shape[-1]), w)
    y = tp_out(part, mesh, axes).to(h.dtype)
    return y.reshape(*h.shape[:-1], w.shape[-1])
