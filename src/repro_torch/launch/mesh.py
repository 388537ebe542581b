"""Mesh construction (counterpart of ``repro.launch.mesh``).

The JAX package builds ``jax.make_mesh`` device meshes: 16 × 16 (data,
model) for one pod, 2 × 16 × 16 (pod, data, model) for two.  The port has
two meshes with those named axes (``distributed.mesh``):

  * a ``ShardMesh``: the shards of every axis as one leading tensor axis
    on one device — :func:`make_host_mesh` and
    :func:`make_production_mesh`;
  * a ``ProcessMesh``: one process a shard over ``torch.distributed`` —
    :func:`init_process_mesh` joins this process to its group (as
    ``torchrun`` starts it, or with an explicit rank and file store) over
    the axes it is given, and :func:`run_ranks` spawns the ranks of a
    group on this host and collects what each returns (a rank that wants
    named axes builds ``ProcessMesh(mesh.device, axes=...)`` from the
    group it was given).

The JAX package's partition rules are ``distributed.sharding``; its
JAX-version shim (``distributed/compat.py``) has no counterpart.
"""
from __future__ import annotations

import multiprocessing
import os
import pickle
import shutil
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.distributed import mesh as dmesh
from repro_torch.distributed.mesh import ProcessMesh, ShardMesh
from repro_torch.kernels import resolve_device


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> ShardMesh:
    """(data 16, model 16), or (pod 2, data 16, model 16) for two pods."""
    axes = dict(data=16, model=16)
    if multi_pod:
        axes = dict(pod=2, **axes)
    return ShardMesh(device=device, axes=axes)


def make_host_mesh(data: int = 1, model: int = 1,
                   device="cuda") -> ShardMesh:
    """A small (data, model) mesh for tests and examples."""
    if data < 1 or model < 1:
        raise ValueError(f"mesh extents must be >= 1, got {data} x {model}")
    return ShardMesh(device=device, axes=dict(data=data, model=model))


# --------------------------------------------------------- process mesh --


def _rank_device(device, transport: str, local_rank: int) -> torch.device:
    """This rank's device: the CPU for gloo; ``cuda:local_rank`` for NCCL
    (a card a rank); for gloo-host the cards in turn (several ranks on
    one card)."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return resolve_device(dev)
    resolve_device(dev)                     # raises without a card
    n = torch.cuda.device_count()
    if transport == "nccl" and local_rank >= n:
        raise ValueError(
            f"local rank {local_rank} has no card of its own ({n} here): "
            "NCCL takes one card a rank; several ranks on one card need "
            "transport='gloo-host'")
    return resolve_device(torch.device("cuda", local_rank % n))


def init_process_mesh(device="cuda", transport: Optional[str] = None, *,
                      rank: Optional[int] = None,
                      world_size: Optional[int] = None,
                      store: Optional[str] = None,
                      axes=None) -> ProcessMesh:
    """Join this process to its ``torch.distributed`` group and return the
    group's ``ProcessMesh`` (this rank's shard on its device) over
    ``axes`` (``{name: size}``, their product the world size; default one
    axis ``"model"``).

    ``rank`` / ``world_size`` default to ``RANK`` / ``WORLD_SIZE`` as
    ``torchrun`` sets them (``LOCAL_RANK`` picks the card).  ``store`` is
    the path of a file store the ranks share (no port); without it the
    group meets at ``MASTER_ADDR:MASTER_PORT``.  ``transport`` (see
    ``distributed.mesh.TRANSPORTS``): None takes ``"nccl"`` on a card and
    ``"gloo"`` on the CPU; ``"gloo-host"`` — several ranks on one card,
    each block copied to the host and back around every collective — is
    taken only by name."""
    if dist.is_initialized():
        raise RuntimeError("this process already belongs to a process group")
    rank = int(os.environ["RANK"] if rank is None else rank)
    world_size = int(os.environ["WORLD_SIZE"] if world_size is None
                     else world_size)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dmesh.named_axes(world_size, axes)          # raises before the group
    if transport is None:
        transport = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if transport not in dmesh.TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r}; one of "
                         f"{sorted(dmesh.TRANSPORTS)}")
    dev = _rank_device(device, transport, local_rank)
    backend, kind = dmesh.TRANSPORTS[transport]
    if dev.type != kind:
        raise ValueError(f"transport {transport!r} moves {kind} blocks; "
                         f"the device is {dev}")
    if backend == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=(f"file://{store}" if store else "env://"),
        rank=rank, world_size=world_size)
    return ProcessMesh(dev, axes=axes)


def close_process_mesh() -> None:
    """Leave the process group :func:`init_process_mesh` joined."""
    dist.destroy_process_group()


class RanksFailed(RuntimeError):
    """A rank of :func:`run_ranks` raised, died or ran past its time;
    the message holds every rank's traceback."""


def _rank_main(rank: int, world_size: int, device, transport, work: str,
               threads: int) -> None:
    """One spawned rank: join the group, run the payload, leave the group,
    write the result (or the traceback) under ``work``."""
    out = Path(work) / f"rank{rank}"
    torch.set_num_threads(threads)
    try:
        with open(Path(work) / "payload.pkl", "rb") as f:
            fn, args = pickle.load(f)
        mesh = init_process_mesh(device, transport, rank=rank,
                                 world_size=world_size,
                                 store=str(Path(work) / "store"))
        try:
            result = fn(mesh, *args)
        finally:
            close_process_mesh()
        with open(out.with_suffix(".tmp"), "wb") as f:
            pickle.dump(result, f)
        os.replace(out.with_suffix(".tmp"), out.with_suffix(".pkl"))
    except BaseException:
        out.with_suffix(".err").write_text(traceback.format_exc())
        raise


def run_ranks(fn: Callable, world_size: int, *, args: Sequence = (),
              device="cuda", transport: Optional[str] = None,
              timeout: float = 300.0, threads: int = 1,
              workdir: Optional[str] = None) -> List:
    """Run ``fn(mesh, *args)`` on ``world_size`` spawned ranks of one group
    on this host and return each rank's result, in rank order.

    ``fn`` and ``args`` go to the ranks by pickle (``fn`` by its import
    path; CPU tensors and NumPy arrays in ``args``), and so does each
    result.  Each rank joins through :func:`init_process_mesh` (a file
    store under ``workdir``, by default a fresh temporary directory) on
    ``device`` over ``transport`` with ``threads`` intra-op threads.  A
    rank that raises or dies, or a run past ``timeout`` seconds, kills
    every rank and raises :class:`RanksFailed` with the tracebacks."""
    work = Path(tempfile.mkdtemp(prefix="ranks-", dir=workdir))
    with open(work / "payload.pkl", "wb") as f:
        pickle.dump((fn, tuple(args)), f)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, world_size, device, transport, str(work), threads))
        for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    failed = None
    while failed is None:
        codes = [p.exitcode for p in procs]
        if all(c == 0 for c in codes):
            break
        if any(c not in (None, 0) for c in codes):
            failed = f"a rank exited with {codes}"
        elif time.monotonic() > deadline:
            failed = f"the ranks ran past {timeout} s (exit codes {codes})"
        else:
            time.sleep(0.02)
    if failed is not None:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(10)
        errs = [f"rank {r}:\n{(work / f'rank{r}.err').read_text()}"
                for r in range(world_size)
                if (work / f"rank{r}.err").exists()]
        shutil.rmtree(work, ignore_errors=True)
        raise RanksFailed(f"{failed}\n" + "\n".join(errs))
    for p in procs:
        p.join()
    results = []
    for r in range(world_size):
        with open(work / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    shutil.rmtree(work, ignore_errors=True)
    return results
