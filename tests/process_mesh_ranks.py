"""What each rank of ``tests/test_torch_process_mesh.py`` runs.

A module of its own, importing neither JAX nor the JAX package, so that a
spawned rank (``launch.mesh.run_ranks``) imports only the port.  The
parent passes every input as NumPy arrays; each case returns CPU values
(NumPy arrays, result dataclasses) or the message of what it raised.
"""
import dataclasses

import numpy as np
import torch

from repro_torch import interop
from repro_torch.core import api
from repro_torch.distributed import lb_shard
from repro_torch.distributed.mesh import resolve_mesh
from repro_torch.launch.mesh import close_process_mesh, init_process_mesh
from repro_torch.pic import driver
from repro_torch.runtime import resilience as rz
from repro_torch.serve import replay as sr
from repro_torch.sim import simulator, stencil
from repro_torch.train import ep_runtime as epr

CPU = "cpu"


def recorded_evolve(loads, ebytes):
    """A device-resident evolve replaying recorded (T, n) load and edge
    byte tables."""
    t_loads, t_bytes = torch.as_tensor(loads), torch.as_tensor(ebytes)

    def evolve(p, t):
        return dataclasses.replace(p, loads=t_loads[t],
                                   edges_bytes=t_bytes[t])
    evolve.device_resident = True
    return evolve


def _raised(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _collectives(mesh, x, partial):
    """The mesh's collectives on this rank's blocks of ``x`` (D·m, ...)
    and on its row of the float partials ``partial`` (D, ...)."""
    blk = mesh.shard(torch.as_tensor(x))
    return dict(shard=blk.numpy(), ring_shift=mesh.ring_shift(blk).numpy(),
                all_gather=mesh.all_gather(blk).numpy(),
                all_gather_many=[g.numpy() for g in mesh.all_gather_many(
                    blk, blk[:, :, :1] * 3.0)],
                psum=mesh.psum(mesh.shard(torch.as_tensor(partial))[:, 0]
                               ).numpy(),
                shard_index=mesh.shard_index().numpy())


def _plans(problem):
    """The planner-only engine in both variants (the mesh resolved from
    the group), and the registered sharded strategy."""
    problem = interop.problem_from_numpy(problem, device=CPU)
    out = {}
    for variant in ("comm", "coord"):
        eng = lb_shard.ShardedLBEngine(variant=variant, k=4, device=CPU)
        a, stats = eng.plan_fn(problem)
        out[variant] = dict(assignment=a.numpy(), **{
            f: np.asarray(getattr(stats, f)) for f in stats._fields},
            num_shards=eng.num_shards)
    plan = api.run_strategy("diff-comm-sharded", problem, k=4)
    out["strategy"] = np.asarray(plan.assignment)
    # P = D + 1 balancer nodes do not divide over the D ranks
    D = lb_shard.num_devices(CPU)
    out["strategy_odd"] = _raised(lambda: api.run_strategy(
        "diff-comm-sharded", stencil.stencil_2d(6, 6, D + 1, device=CPU),
        k=2))
    return out


def _regrouped(mesh, store):
    """The cached sharded engine's mesh before and after this rank leaves
    the group for a group of its own (world size 1, file store
    ``store`` + rank); the caller's spawn closes that group."""
    before = lb_shard.get_sharded_engine(device=CPU)
    close_process_mesh()
    init_process_mesh(CPU, rank=0, world_size=1,
                      store=f"{store}{mesh.rank}")
    after = lb_shard.get_sharded_engine(device=CPU)
    return dict(before=repr(before.mesh), after=repr(after.mesh),
                same=after is before)


def all_cases(mesh, inputs):
    """Every case of the rank tests on this rank, one spawn for all."""
    D = mesh.num_shards
    out = dict(rank=mesh.rank, num_shards=D, repr=repr(mesh),
               collectives=_collectives(mesh, inputs["x"],
                                        inputs["partial"]),
               plan=_plans(inputs["problem"]))
    s = inputs["series"]
    out["series"] = simulator.run_series_sharded(
        interop.problem_from_numpy(s["problem"], device=CPU),
        recorded_evolve(s["loads"], s["ebytes"]), **s["kw"])
    pic = inputs["pic"]
    out["pic"] = driver.run(driver.PICConfig(**pic, sharded_replay=True,
                                             device=CPU))
    out["pic_overflow"] = _raised(lambda: driver.run(driver.PICConfig(
        **{**pic, **inputs["pic_undersized"]}, sharded_replay=True,
        device=CPU)))
    out["pic_dead"] = driver.run(driver.PICConfig(
        **{**pic, **inputs["pic_dead"]}, sharded_replay=True, device=CPU,
        faults=rz.FaultSchedule(events=inputs["pic_dead_events"])))
    out["pic_spill"] = driver.run(driver.PICConfig(
        **{**pic, **inputs["pic_spill"]}, sharded_replay=True,
        on_overflow="spill", device=CPU))
    out["checkpointed"] = rz.run_series_checkpointed(
        interop.problem_from_numpy(s["problem"], device=CPU),
        recorded_evolve(s["loads"], s["ebytes"]),
        faults=rz.FaultSchedule(events=inputs["series_faults"]),
        **inputs["checkpointed"], **s["kw"])
    out["fleet"] = sr.run_serve_replay(sr.ServeWorkload(**inputs["fleet"]),
                                       num_shards=D, device=CPU,
                                       **inputs["fleet_run"])
    out["ep"] = epr.run_ep_replay(epr.RoutingWorkload(**inputs["ep"]),
                                  num_shards=D, device=CPU,
                                  **inputs["ep_run"])
    moe = {k: torch.as_tensor(v) for k, v in inputs["moe"].items()}
    layers, se, moved, nbytes = epr.execute_placement(
        [moe], inputs["slot_expert"], inputs["placement"],
        num_ranks=inputs["moe_ranks"], mesh=mesh)
    out["placement"] = dict(layers={k: v.numpy() for k, v in
                                    layers[0].items()},
                            slot_expert=se.numpy(), moved=moved,
                            bytes=nbytes)
    out["wrong_shards"] = [
        _raised(lambda: resolve_mesh(None, 2 * D, (8 * D,), CPU)),
        _raised(lambda: simulator.run_series_sharded(
            interop.problem_from_numpy(s["problem"], device=CPU),
            recorded_evolve(s["loads"], s["ebytes"]),
            **{**s["kw"], "num_shards": D + 1}))]
    out["regrouped"] = _regrouped(mesh, inputs["solo_store"])   # last
    return out


def fail_on_last_rank(mesh):
    """The last rank raises; the others wait in a collective it never
    joins (the hang a rank that branches alone would cause)."""
    if mesh.rank == mesh.num_shards - 1:
        raise ValueError("rank failed on purpose")
    return mesh.all_gather(torch.zeros(1, 1)).numpy()


def sleep_past(mesh, seconds):
    import time

    time.sleep(seconds)
    return mesh.rank
