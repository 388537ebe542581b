"""A 1-D mesh of D shards held by one process on one device.

The JAX package runs its sharded planner and replays under ``shard_map``
over a 1-D ``"lb"`` device mesh (virtual CPU devices in its tests).  Here
the D shards live in one process as the **leading axis** of every
per-shard tensor: shard ``d``'s block of a row-sharded (n,) vector is row
``d`` of a (D, n/D) tensor, and a value every shard holds alike
("replicated") is one tensor without that axis.  A per-shard body then
runs once over all D rows, as ``jax.vmap`` would run it, and the
collectives become tensor operations:

  * :meth:`ShardMesh.ring_shift` — ``ppermute`` over ``[(d, (d-1) % D)]``:
    afterwards shard ``me`` holds the block shard ``me+1`` held
    (``torch.roll(buf, -1, 0)``), an exact copy;
  * :meth:`ShardMesh.psum` — the sum of the D partials (exact for integer
    partials; for float partials it reassociates the additions, as a
    ``psum`` does);
  * :meth:`ShardMesh.all_gather` — the D blocks concatenated in shard
    order (``tiled=True``), an exact copy (:meth:`ShardMesh.all_gather_many`
    gathers several blocks at once).

:class:`ProcessMesh` is the same interface with one process a shard: the
D ranks of an initialised ``torch.distributed`` group, rank r holding
shard r.  Its blocks keep the leading axis, of extent 1, so a per-shard
body written for the (D, ...) blocks of a ``ShardMesh`` runs unchanged on
a rank's (1, ...) block: the leading extent is the *local* shard count,
and :meth:`ShardMesh.shard_index` gives the global index of each local
row ("me").  Its collectives move exact copies:

  * ``ring_shift`` is one send/recv pair (send to rank r-1, receive from
    r+1);
  * ``all_gather`` gathers the blocks in rank order (``all_gather_many``
    several blocks of one dtype in one collective);
  * ``psum`` all-gathers the partials and adds them with the
    ``ShardMesh`` expression (``.sum(0)`` of the (D, ...) stack), so a
    float psum has the in-process mesh's bits; no float ``all_reduce``.

The transport follows from the group's backend and the mesh's device:
``"nccl"`` (a card a rank), ``"gloo"`` (CPU tensors) or ``"gloo-host"``
(card blocks over gloo, for several ranks on one card, where NCCL
refuses: each block is copied to the host, moved by gloo, and copied
back).  ``launch.mesh.init_process_mesh`` starts a group over the
transport its caller names; it never picks gloo-host on its own.

:func:`resolve_mesh` derives a mesh from a ``mesh`` / ``num_shards`` spec
with the JAX package's rules (``replay_shard._resolve_mesh``): not both;
every extent must divide D; ``num_shards=None`` resolves to the real
devices: outside a process group the number dividing the extents, which
is 1 (one card, or the CPU); inside a group of W ranks a ``ProcessMesh``
of W (a ``num_shards`` other than W raises).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels import resolve_device

#: the transports of a :class:`ProcessMesh`: (group backend, device type)
TRANSPORTS = {"nccl": ("nccl", "cuda"), "gloo": ("gloo", "cpu"),
              "gloo-host": ("gloo", "cuda")}
_TRANSPORT_OF = {pair: name for name, pair in TRANSPORTS.items()}


class ShardMesh:
    """D shards as the leading axis of tensors on one ``device``."""

    def __init__(self, num_shards: int, device="cuda"):
        D = int(num_shards)
        if D < 1:
            raise ValueError(f"num_shards={num_shards} must be >= 1")
        self.num_shards = D
        self.device = resolve_device(device)

    def __repr__(self) -> str:
        return f"ShardMesh(num_shards={self.num_shards}, device={self.device})"

    def __eq__(self, other) -> bool:
        return (type(other) is ShardMesh
                and other.num_shards == self.num_shards
                and other.device == self.device)

    def __hash__(self) -> int:
        return hash((self.num_shards, str(self.device)))

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """Row-shard a global (n, ...) tensor: (D, n/D, ...)."""
        D = self.num_shards
        if x.shape[0] % D:
            raise ValueError(f"extent {x.shape[0]} does not divide over "
                             f"{D} shards")
        return x.reshape(D, x.shape[0] // D, *x.shape[1:])

    def shard_index(self, device=None) -> torch.Tensor:
        """(local, 1) global indices of the shards this process holds
        ("me"): all D here."""
        dev = self.device if device is None else device
        return torch.arange(self.num_shards, device=dev)[:, None]

    def ring_shift(self, buf: torch.Tensor) -> torch.Tensor:
        """One ring hop: shard ``me`` receives shard ``me+1``'s block."""
        return torch.roll(buf, -1, 0)

    def psum(self, partial: torch.Tensor) -> torch.Tensor:
        """Sum of the D per-shard partials (leading axis), replicated: the
        gathered (D, ...) stack added over its first axis."""
        return self.all_gather(partial.unsqueeze(1)).sum(0)

    def all_gather(self, block: torch.Tensor) -> torch.Tensor:
        """The D blocks of a (D, m, ...) tensor in shard order, (D·m, ...)."""
        return block.reshape(-1, *block.shape[2:])

    def all_gather_many(self, *blocks: torch.Tensor):
        """:meth:`all_gather` of each block, as a tuple."""
        return tuple(self.all_gather(b) for b in blocks)


def in_process_group() -> bool:
    """True inside an initialised ``torch.distributed`` group."""
    return dist.is_available() and dist.is_initialized()


class ProcessMesh(ShardMesh):
    """D shards as the D ranks of the initialised ``torch.distributed``
    group: this process holds shard ``rank`` as a (1, m, ...) block on
    ``device``.

    Its transport (:data:`TRANSPORTS`) follows from the group's backend
    and ``device``: ``"nccl"``, ``"gloo"`` for CPU blocks, or
    ``"gloo-host"`` for card blocks over a gloo group (the backend
    ``launch.mesh.init_process_mesh`` takes for that name).  NCCL with
    CPU blocks raises."""

    def __init__(self, device="cuda"):
        if not in_process_group():
            raise RuntimeError(
                "ProcessMesh needs an initialised torch.distributed group "
                "(launch.mesh.init_process_mesh)")
        self.device = resolve_device(device)
        self.num_shards = dist.get_world_size()
        self.rank = dist.get_rank()
        backend = dist.get_backend()
        transport = _TRANSPORT_OF.get((backend, self.device.type))
        if transport is None:
            raise ValueError(f"a {backend} group cannot move blocks on "
                             f"{self.device}")
        self.transport = transport

    def __repr__(self) -> str:
        return (f"ProcessMesh(num_shards={self.num_shards}, rank="
                f"{self.rank}, device={self.device}, transport="
                f"{self.transport!r})")

    def __eq__(self, other) -> bool:
        return (type(other) is ProcessMesh
                and (other.num_shards, other.rank, other.device,
                     other.transport) == (self.num_shards, self.rank,
                                          self.device, self.transport))

    def __hash__(self) -> int:
        return hash((self.num_shards, self.rank, str(self.device),
                     self.transport))

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's row block of a global (n, ...) tensor: (1, n/D, ...)."""
        D = self.num_shards
        if x.shape[0] % D:
            raise ValueError(f"extent {x.shape[0]} does not divide over "
                             f"{D} shards")
        m = x.shape[0] // D
        return x[self.rank * m:(self.rank + 1) * m].unsqueeze(0)

    def shard_index(self, device=None) -> torch.Tensor:
        """(1, 1): this rank's shard."""
        dev = self.device if device is None else device
        return torch.full((1, 1), self.rank, dtype=torch.int64, device=dev)

    def _send(self, t: torch.Tensor) -> torch.Tensor:
        # gloo-host: the block leaves the card for the host
        t = t.contiguous()
        return t.cpu() if self.transport == "gloo-host" else t

    def _received(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.transport == "gloo-host" else t

    def ring_shift(self, buf: torch.Tensor) -> torch.Tensor:
        """One ring hop: send this block to rank ``rank-1``, receive rank
        ``rank+1``'s."""
        D, r = self.num_shards, self.rank
        if D == 1:
            return buf.clone()
        out = self._send(buf)
        got = torch.empty_like(out)
        ops = [dist.P2POp(dist.isend, out, (r - 1) % D),
               dist.P2POp(dist.irecv, got, (r + 1) % D)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return self._received(got)

    def all_gather(self, block: torch.Tensor) -> torch.Tensor:
        """The D ranks' (1, m, ...) blocks in rank order, (D·m, ...)."""
        out = self._send(block)
        gathered = out.new_empty((self.num_shards * out.shape[0],)
                                 + tuple(out.shape[1:]))
        dist.all_gather_into_tensor(gathered, out)
        return self._received(gathered).reshape(-1, *block.shape[2:])

    def all_gather_many(self, *blocks: torch.Tensor):
        """:meth:`all_gather` of each (1, m_i, ...) block of one dtype, as
        a tuple, in one collective: the blocks go out as one row and each
        comes back as its columns of the (D, sum m_i·...) rows (a copy)."""
        if len({b.dtype for b in blocks}) > 1:
            raise TypeError("all_gather_many takes blocks of one dtype")
        rows = self.all_gather(
            torch.cat([b.reshape(1, 1, -1) for b in blocks], 2))
        out, o = [], 0
        for b in blocks:
            n = b[0].numel()
            out.append(rows[:, o:o + n].reshape(-1, *b.shape[2:]))
            o += n
        return tuple(out)


def num_devices(device) -> int:
    """Real devices the port drives (``len(jax.devices())``): the world
    size inside a process group, else one (a card or the CPU)."""
    resolve_device(device)
    return dist.get_world_size() if in_process_group() else 1


def resolve_mesh(mesh: Optional[ShardMesh], num_shards: Optional[int],
                 must_divide: Tuple[int, ...], device="cuda") -> ShardMesh:
    """A mesh whose shard count divides every extent in ``must_divide``.

    ``mesh`` is taken as given (checked).  Inside a process group of W
    ranks the mesh is the group's :class:`ProcessMesh` (``num_shards``
    None or W).  Outside one, ``num_shards`` builds a ``ShardMesh`` on
    ``device``, and neither resolves to the largest count up to the
    number of real devices that divides the extents (one)."""
    if mesh is None and in_process_group():
        W = dist.get_world_size()
        if num_shards is not None and int(num_shards) != W:
            raise ValueError(
                f"num_shards={num_shards} inside a process group of {W} "
                "ranks: the group's mesh has one shard a rank (pass None "
                f"or {W})")
        bad = [m for m in must_divide if m % W]
        if bad:
            raise ValueError(
                f"extents {bad} do not divide over the {W}-rank mesh")
        return ProcessMesh(device)
    if mesh is not None:
        if num_shards is not None:
            raise ValueError("pass either mesh or num_shards, not both")
        if not isinstance(mesh, ShardMesh):
            raise TypeError("mesh must be a distributed.mesh.ShardMesh")
        D = mesh.num_shards
        bad = [m for m in must_divide if m % D]
        if bad:
            raise ValueError(
                f"extents {bad} do not divide over the {D}-shard mesh")
        return mesh
    if num_shards is not None:
        D = int(num_shards)
        if D < 1:
            raise ValueError(f"num_shards={num_shards} must be >= 1")
        bad = [m for m in must_divide if m % D]
        if bad:
            raise ValueError(
                f"extents {bad} do not divide over num_shards={D}")
    else:
        D = min([num_devices(device)] + [int(m) for m in must_divide])
        while any(m % D for m in must_divide):
            D -= 1
    return ShardMesh(D, device)
