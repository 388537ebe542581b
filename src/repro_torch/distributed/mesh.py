"""A mesh of D shards with named axes, held by one process on one device
or by the D ranks of a process group.

The JAX package runs its sharded planner and replays under ``shard_map``
over a 1-D ``"lb"`` device mesh (virtual CPU devices in its tests), and
its models over a ``("pod", "data", "model")`` mesh.  Here a mesh has
axes drawn from :data:`AXES` in that order, with sizes whose product is
D; shard ``(p, d, m)`` is the row-major index of its coordinates.  A mesh
made from a count alone has the one axis ``"model"`` (the JAX package's
expert-parallel axis); the sharded planner and replays read no axis name.

In one process the D shards live as the **leading axis** of every
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
    gathers several blocks at once);
  * :meth:`ShardMesh.all_to_all` — block j of every shard to member j of
    its group (``all_to_all`` with ``tiled=False``), an exact copy;
  * :meth:`ShardMesh.reduce_scatter` — member j's block of the sum of the
    group's partials (``psum_scatter``): block j of every member, added
    in member order after an ``all_to_all``;
  * :meth:`ShardMesh.pmax` — the elementwise max of the partials (exact).

``all_gather``, ``psum``, ``pmax``, ``reduce_scatter`` and
``all_to_all`` take ``axes=``: the
collective runs within each group of shards that differ only in those
axes (members in the row-major order of their coordinates on them), as a
JAX collective over those axis names does.  Over every axis (the
default) a gather or a sum is replicated and has no leading axis; over
fewer each shard keeps its group's result, (local, ...).

:class:`ProcessMesh` is the same interface with one process a shard: the
D ranks of an initialised ``torch.distributed`` group, rank r holding
shard r.  Its blocks keep the leading axis, of extent 1, so a per-shard
body written for the (D, ...) blocks of a ``ShardMesh`` runs unchanged on
a rank's (1, ...) block: the leading extent is the *local* shard count,
and :meth:`ShardMesh.shard_index` gives the global index of each local
row ("me").  A collective over fewer axes than all runs on a
``dist.new_group`` of its group (made for every such set of axes when
the mesh is built).  Its collectives move exact copies:

  * ``ring_shift`` is one send/recv pair (send to rank r-1, receive from
    r+1);
  * ``all_gather`` gathers the blocks in rank order (``all_gather_many``
    several blocks of one dtype in one collective);
  * ``psum`` all-gathers the partials and adds them with the
    ``ShardMesh`` expression (``.sum(0)`` of the (D, ...) stack), so a
    float psum has the in-process mesh's bits; no float ``all_reduce``;
    ``pmax`` gathers and takes the max alike;
  * ``all_to_all`` is ``dist.all_to_all_single`` on the group;
    ``reduce_scatter`` is that exchange of the blocks, then their sum in
    member order (each rank adds only its own block).

The transport follows from the group's backend and the mesh's device:
``"nccl"`` (a card a rank), ``"gloo"`` (CPU tensors) or ``"gloo-host"``
(card blocks over gloo, for several ranks on one card, where NCCL
refuses: each block is copied to the host, moved by gloo, and copied
back).  ``launch.mesh.init_process_mesh`` starts a group over the
transport its caller names; it never picks gloo-host on its own.

:class:`TraceMesh` is a ``ProcessMesh`` with no process group: rank 0
of named axes of any size (the dry run's 256- and 512-chip meshes).  Its
collectives return tensors of their results' shapes (fake tensors under
``FakeTensorMode``; copies of this rank's blocks on real ones).  Every
``ProcessMesh`` counts the collectives it issues (:meth:`ProcessMesh.census`)
by kind, with the bytes the JAX package's ``launch/hlo.py`` puts on the
wire: an all-gather its result's bytes, an all-to-all and a ring hop
(``collective-permute``) their operand's; no ``ProcessMesh`` collective
is an all-reduce (a ``psum`` is an all-gather and a local sum), so that
kind stays 0.

:func:`resolve_mesh` derives a mesh from a ``mesh`` / ``num_shards`` spec
with the JAX package's rules (``replay_shard._resolve_mesh``): not both;
every extent must divide D; ``num_shards=None`` resolves to the real
devices: outside a process group the number dividing the extents, which
is 1 (one card, or the CPU); inside a group of W ranks a ``ProcessMesh``
of W (a ``num_shards`` other than W raises).
"""
from __future__ import annotations

import collections
import itertools
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.kernels import resolve_device

#: the JAX package's mesh axes, in its order
AXES = ("pod", "data", "model")
#: the collective kinds of the JAX package's ``launch/hlo.py``
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
#: the transports of a :class:`ProcessMesh`: (group backend, device type)
TRANSPORTS = {"nccl": ("nccl", "cuda"), "gloo": ("gloo", "cpu"),
              "gloo-host": ("gloo", "cuda")}
_TRANSPORT_OF = {pair: name for name, pair in TRANSPORTS.items()}

AxesArg = Union[None, str, Sequence[str]]


def named_axes(num_shards: Optional[int] = None,
               axes=None) -> Dict[str, int]:
    """The axes ``{name: size}`` of a mesh, in :data:`AXES` order.

    ``axes`` (a mapping or (name, size) pairs) names them; without it a
    count ``num_shards`` makes the one axis ``"model"``.  Given both, the
    sizes' product must be ``num_shards``."""
    if axes is None:
        if num_shards is None:
            raise ValueError("a mesh needs num_shards or axes")
        D = int(num_shards)
        if D < 1:
            raise ValueError(f"num_shards={num_shards} must be >= 1")
        return {"model": D}
    axes = dict(axes)
    unknown = [a for a in axes if a not in AXES]
    if unknown or not axes:
        raise ValueError(f"mesh axes {list(axes)}: each one of {AXES}")
    out = {a: int(axes[a]) for a in AXES if a in axes}
    if any(s < 1 for s in out.values()):
        raise ValueError(f"mesh axis sizes must be >= 1, got {out}")
    if num_shards is not None and math.prod(out.values()) != int(num_shards):
        raise ValueError(f"mesh axes {out} do not make {num_shards} shards")
    return out


class ShardMesh:
    """D shards as the leading axis of tensors on one ``device``, over the
    named ``axes`` (:func:`named_axes`; default: one axis ``"model"``)."""

    def __init__(self, num_shards: Optional[int] = None, device="cuda", *,
                 axes=None):
        self.axes = named_axes(num_shards, axes)
        self.num_shards = math.prod(self.axes.values())
        self.device = resolve_device(device)

    def _axes_repr(self) -> str:
        return ("" if tuple(self.axes) == ("model",)
                else f", axes={self.axes}")

    def __repr__(self) -> str:
        return (f"ShardMesh(num_shards={self.num_shards}, "
                f"device={self.device}{self._axes_repr()})")

    def __eq__(self, other) -> bool:
        return (type(other) is ShardMesh
                and other.axes == self.axes
                and other.device == self.device)

    def __hash__(self) -> int:
        return hash((tuple(self.axes.items()), str(self.device)))

    # -- axes -------------------------------------------------------------

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.axes)

    @property
    def axis_sizes(self) -> Tuple[int, ...]:
        return tuple(self.axes.values())

    def group_axes(self, axes: AxesArg = None) -> Tuple[str, ...]:
        """``axes`` as the mesh's axis names (None: all); names of
        :data:`AXES` the mesh lacks are dropped, as the JAX package drops
        them.  They must come in the mesh's order."""
        if axes is None:
            return self.axis_names
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in AXES]
        if unknown:
            raise ValueError(f"unknown mesh axes {unknown}; from {AXES}")
        got = tuple(a for a in axes if a in self.axes)
        if got != tuple(a for a in self.axes if a in got):
            raise ValueError(f"axes {axes} are not in the mesh's order "
                             f"{self.axis_names}")
        return got

    def size(self, axes: AxesArg = None) -> int:
        """Shards in one group over ``axes`` (None: every axis)."""
        return math.prod(self.axes[a] for a in self.group_axes(axes))

    def coords(self, index: int) -> Dict[str, int]:
        """The coordinates of shard ``index`` (row-major), by axis."""
        out, i = {}, int(index)
        for a in reversed(self.axis_names):
            out[a] = i % self.axes[a]
            i //= self.axes[a]
        return {a: out[a] for a in self.axis_names}

    def group_rank(self, axes: AxesArg, index: int) -> int:
        """Shard ``index``'s place in its group over ``axes``: the
        row-major index of its coordinates on those axes."""
        c, r = self.coords(index), 0
        for a in self.group_axes(axes):
            r = r * self.axes[a] + c[a]
        return r

    def _whole(self, axes: AxesArg) -> bool:
        return self.size(axes) == self.num_shards

    def _grouped(self, x: torch.Tensor, axes) -> torch.Tensor:
        """(D, ...) → (groups, members, ...): the shards regrouped so that
        dim 1 runs over a group over ``axes``."""
        names, sizes = self.axis_names, self.axis_sizes
        axes = self.group_axes(axes)
        grp = [i for i, a in enumerate(names) if a in axes]
        oth = [i for i in range(len(names)) if i not in grp]
        rest = list(range(len(names), len(names) + x.dim() - 1))
        v = x.reshape(*sizes, *x.shape[1:]).permute(oth + grp + rest)
        return v.reshape(math.prod(sizes[i] for i in oth),
                         math.prod(sizes[i] for i in grp), *x.shape[1:])

    def _ungrouped(self, v: torch.Tensor, axes) -> torch.Tensor:
        """The inverse of :meth:`_grouped`."""
        names, sizes = self.axis_names, self.axis_sizes
        axes = self.group_axes(axes)
        grp = [i for i, a in enumerate(names) if a in axes]
        oth = [i for i in range(len(names)) if i not in grp]
        order = oth + grp
        v = v.reshape(*[sizes[i] for i in order], *v.shape[2:])
        inv = [order.index(i) for i in range(len(names))]
        rest = list(range(len(names), v.dim()))
        return v.permute(inv + rest).reshape(self.num_shards, *v.shape[
            len(names):])

    # -- blocks and collectives ---------------------------------------------

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

    def psum(self, partial: torch.Tensor, axes: AxesArg = None
             ) -> torch.Tensor:
        """Sum of the per-shard partials (leading axis) over ``axes``: the
        gathered (members, ...) stack added over its first axis; over every
        axis one replicated tensor, else (D, ...)."""
        return self._reduced(partial, axes, lambda t: t.sum(0))

    def pmax(self, partial: torch.Tensor, axes: AxesArg = None
             ) -> torch.Tensor:
        """Elementwise max of the per-shard partials over ``axes``, laid
        out as :meth:`psum`'s result."""
        return self._reduced(partial, axes, lambda t: t.amax(0))

    def _reduced(self, partial, axes, op):
        if self._whole(axes):
            return op(self.all_gather(partial.unsqueeze(1)))
        g = self._grouped(partial, axes)
        total = op(g.transpose(0, 1))[:, None]
        return self._ungrouped(total.expand(g.shape), axes)

    def reduce_scatter(self, partial: torch.Tensor, axes: AxesArg = None
                       ) -> torch.Tensor:
        """(D, G·m, ...) → (D, m, ...): each shard's block of the sum of
        its group's partials over ``axes`` (G members; member j keeps
        block j), added in member order as :meth:`psum` adds."""
        G = self.size(axes)
        if partial.shape[1] % G:
            raise ValueError(f"extent {partial.shape[1]} does not divide "
                             f"over {G} members")
        blocks = partial.reshape(partial.shape[0], G, -1,
                                 *partial.shape[2:])
        return self.all_to_all(blocks, axes).sum(1)

    def all_gather(self, block: torch.Tensor, axes: AxesArg = None
                   ) -> torch.Tensor:
        """The blocks of a (D, m, ...) tensor in shard order within each
        group over ``axes``: over every axis (D·m, ...), else (D, G·m,
        ...) with G the group's size."""
        if self._whole(axes):
            return block.reshape(-1, *block.shape[2:])
        g = self._grouped(block, axes)
        G = g.shape[1]
        cat = g.reshape(g.shape[0], 1, G * block.shape[1], *block.shape[2:])
        return self._ungrouped(cat.expand(g.shape[0], G, *cat.shape[2:]),
                               axes)

    def all_gather_many(self, *blocks: torch.Tensor):
        """:meth:`all_gather` of each block, as a tuple."""
        return tuple(self.all_gather(b) for b in blocks)

    def all_to_all(self, x: torch.Tensor, axes: AxesArg = None
                   ) -> torch.Tensor:
        """(D, G, ...) → (D, G, ...): block j of every shard goes to member
        j of its group over ``axes`` (G members), and block j of the
        result is the one member j sent this shard."""
        g = self._grouped(x, axes)                 # (groups, src, dst, ...)
        if x.shape[1] != g.shape[1]:
            raise ValueError(f"all_to_all over {g.shape[1]} members needs "
                             f"that many blocks a shard, got {x.shape[1]}")
        return self._ungrouped(g.transpose(1, 2), axes)


def in_process_group() -> bool:
    """True inside an initialised ``torch.distributed`` group."""
    return dist.is_available() and dist.is_initialized()


class ProcessMesh(ShardMesh):
    """D shards as the D ranks of the initialised ``torch.distributed``
    group, over the named ``axes`` (default: one axis ``"model"`` of the
    world size): this process holds shard ``rank`` as a (1, m, ...) block
    on ``device``.

    Its transport (:data:`TRANSPORTS`) follows from the group's backend
    and ``device``: ``"nccl"``, ``"gloo"`` for CPU blocks, or
    ``"gloo-host"`` for card blocks over a gloo group (the backend
    ``launch.mesh.init_process_mesh`` takes for that name).  NCCL with
    CPU blocks raises.  Every rank must build its mesh with the same
    axes, in the same order of calls: each group of a set of axes is a
    ``dist.new_group``, which every rank of the world joins."""

    def __init__(self, device="cuda", *, axes=None):
        if not in_process_group():
            raise RuntimeError(
                "ProcessMesh needs an initialised torch.distributed group "
                "(launch.mesh.init_process_mesh)")
        self.device = resolve_device(device)
        self.num_shards = dist.get_world_size()
        self.axes = named_axes(self.num_shards, axes)
        self.rank = dist.get_rank()
        backend = dist.get_backend()
        transport = _TRANSPORT_OF.get((backend, self.device.type))
        if transport is None:
            raise ValueError(f"a {backend} group cannot move blocks on "
                             f"{self.device}")
        self.transport = transport
        self._census = collections.Counter()
        # one group a set of axes that is neither one shard nor the world,
        # every group of every set made on every rank, in one order
        self._groups = {}
        for n in range(1, len(self.axes)):
            for sub in itertools.combinations(self.axis_names, n):
                if self.size(sub) in (1, self.num_shards):
                    continue
                for ranks in self._partition(sub):
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[sub] = g

    def _partition(self, axes):
        """The groups over ``axes``: each a list of ranks, in member order."""
        ids = self._grouped(torch.arange(self.num_shards), axes)
        return [row.tolist() for row in ids]

    def __repr__(self) -> str:
        return (f"ProcessMesh(num_shards={self.num_shards}, rank="
                f"{self.rank}, device={self.device}, transport="
                f"{self.transport!r}{self._axes_repr()})")

    def __eq__(self, other) -> bool:
        return (type(other) is ProcessMesh
                and (other.axes, other.rank, other.device,
                     other.transport) == (self.axes, self.rank,
                                          self.device, self.transport))

    def __hash__(self) -> int:
        return hash((tuple(self.axes.items()), self.rank, str(self.device),
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

    def _group(self, axes):
        """(process group, members) of this rank's group over ``axes``;
        the world's group is None."""
        axes = self.group_axes(axes)
        G = self.size(axes)
        if G == self.num_shards:
            return None, G
        return self._groups.get(axes), G

    # -- the collectives this rank issues, and their census ----------------

    def _count(self, kind: str, axes, nbytes: int) -> None:
        self._census[(kind, self.group_axes(axes), "count")] += 1
        self._census[(kind, self.group_axes(axes), "bytes")] += int(nbytes)

    def census(self, by_axes: bool = False) -> Dict:
        """The collectives issued since the mesh was made (or
        :meth:`reset_census`): ``{kind: {"count", "bytes"}}`` for every
        kind of :data:`COLLECTIVES`, bytes on the wire as
        ``launch/hlo.py`` counts them; ``by_axes``: ``{(kind, axes):
        {...}}`` for the kinds and groups issued."""
        if by_axes:
            out: Dict = {}
            for (kind, axes, what), n in self._census.items():
                out.setdefault((kind, axes), dict(count=0, bytes=0))[what] = n
            return out
        out = {k: dict(count=0, bytes=0) for k in COLLECTIVES}
        for (kind, _, what), n in self._census.items():
            out[kind][what] += n
        return out

    def reset_census(self) -> None:
        self._census.clear()

    def _all_gather_into(self, out, t, group, axes) -> None:
        self._count("all-gather", axes, out.numel() * out.element_size())
        dist.all_gather_into_tensor(out, t, group=group)

    def _all_to_all_into(self, out, t, group, axes) -> None:
        self._count("all-to-all", axes, t.numel() * t.element_size())
        dist.all_to_all_single(out, t, group=group)

    def _ring_into(self, got, t) -> None:
        self._count("collective-permute", None, t.numel() * t.element_size())
        D, r = self.num_shards, self.rank
        ops = [dist.P2POp(dist.isend, t, (r - 1) % D),
               dist.P2POp(dist.irecv, got, (r + 1) % D)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()

    def _send(self, t: torch.Tensor) -> torch.Tensor:
        # gloo-host: the block leaves the card for the host
        t = t.contiguous()
        return t.cpu() if self.transport == "gloo-host" else t

    def _received(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.transport == "gloo-host" else t

    def ring_shift(self, buf: torch.Tensor) -> torch.Tensor:
        """One ring hop: send this block to rank ``rank-1``, receive rank
        ``rank+1``'s."""
        if self.num_shards == 1:
            return buf.clone()
        out = self._send(buf)
        got = torch.empty_like(out)
        self._ring_into(got, out)
        return self._received(got)

    def psum(self, partial: torch.Tensor, axes: AxesArg = None
             ) -> torch.Tensor:
        """Sum of the group's (1, ...) partials over ``axes``: gathered in
        rank order and added as :meth:`ShardMesh.psum` adds them."""
        return self._reduced(partial, axes, lambda t: t.sum(0))

    def pmax(self, partial: torch.Tensor, axes: AxesArg = None
             ) -> torch.Tensor:
        """Elementwise max of the group's (1, ...) partials over ``axes``."""
        return self._reduced(partial, axes, lambda t: t.amax(0))

    def _reduced(self, partial, axes, op):
        if self._whole(axes):
            return op(self.all_gather(partial.unsqueeze(1)))
        return op(self.all_gather(partial.unsqueeze(1), axes)[0])[None]

    def all_gather(self, block: torch.Tensor, axes: AxesArg = None
                   ) -> torch.Tensor:
        """The (1, m, ...) blocks of this rank's group over ``axes`` in rank
        order: over every axis (D·m, ...), else (1, G·m, ...)."""
        group, G = self._group(axes)
        if G == 1:
            got = block.clone()
        else:
            out = self._send(block)
            gathered = out.new_empty((G * out.shape[0],)
                                     + tuple(out.shape[1:]))
            self._all_gather_into(gathered, out, group, axes)
            got = self._received(gathered)
        if G == self.num_shards:
            return got.reshape(-1, *block.shape[2:])
        return got.reshape(1, -1, *block.shape[2:])

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

    def all_to_all(self, x: torch.Tensor, axes: AxesArg = None
                   ) -> torch.Tensor:
        """(1, G, ...) → (1, G, ...): block j to member j of this rank's
        group over ``axes``; block j of the result from member j."""
        group, G = self._group(axes)
        if x.shape[1] != G:
            raise ValueError(f"all_to_all over {G} members needs that many "
                             f"blocks a shard, got {x.shape[1]}")
        if G == 1:
            return x.clone()
        out = self._send(x[0])
        got = torch.empty_like(out)
        self._all_to_all_into(got, out, group, axes)
        return self._received(got)[None]


class TraceMesh(ProcessMesh):
    """Rank ``rank`` (default 0) of a mesh of named ``axes`` of any size,
    with no process group: the dry run traces one rank's share of a
    sharded program (its blocks, its collectives) on it.  Each collective
    returns a tensor of its result's shape — under ``FakeTensorMode`` a
    fake one; on real tensors every member's block is a copy of this
    rank's (shapes right, values not a real mesh's) — and is counted
    (:meth:`ProcessMesh.census`) as the ``ProcessMesh`` of the same axes
    would issue it."""

    def __init__(self, axes, device="cpu", *, rank: int = 0):
        self.axes = named_axes(None, axes)
        self.num_shards = math.prod(self.axes.values())
        self.device = resolve_device(device)
        if not 0 <= rank < self.num_shards:
            raise ValueError(f"rank {rank} of {self.num_shards} shards")
        self.rank = rank
        self.transport = "trace"
        self._census = collections.Counter()
        self._groups = {}

    def __repr__(self) -> str:
        return (f"TraceMesh(axes={self.axes}, rank={self.rank}, "
                f"device={self.device})")

    def __eq__(self, other) -> bool:
        return (type(other) is TraceMesh and other.axes == self.axes
                and other.rank == self.rank and other.device == self.device)

    def __hash__(self) -> int:
        return hash((tuple(self.axes.items()), self.rank, str(self.device),
                     "trace"))

    def group_ranks(self, axes) -> list:
        """The ranks of this rank's group over ``axes``, in member order."""
        return next(g for g in self._partition(self.group_axes(axes))
                    if self.rank in g)

    def _all_gather_into(self, out, t, group, axes) -> None:
        self._count("all-gather", axes, out.numel() * out.element_size())
        G = out.shape[0] // t.shape[0]
        out.view(G, *t.shape).copy_(t.unsqueeze(0).expand(G, *t.shape))

    def _all_to_all_into(self, out, t, group, axes) -> None:
        self._count("all-to-all", axes, t.numel() * t.element_size())
        out.copy_(t)

    def _ring_into(self, got, t) -> None:
        self._count("collective-permute", None, t.numel() * t.element_size())
        got.copy_(t)


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
