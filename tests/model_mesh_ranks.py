"""What each rank of ``tests/test_torch_model_mesh.py`` runs.

A module of its own, importing neither JAX nor the JAX package, so that a
spawned rank (``launch.mesh.run_ranks``) imports only the port.  The
parent passes every input as NumPy arrays; each case returns NumPy
arrays.
"""
import dataclasses

import numpy as np
import torch

from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding
from repro_torch.distributed.mesh import ProcessMesh
from repro_torch.models import moe
from repro_torch.models.params import tree_leaves
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_step as ts_mod

CPU = "cpu"


def moe_cfg(cf, ep_axes=("model",), **kw):
    """The reduced deepseek-v3 (f32) with the a2a at capacity factor
    ``cf`` over ``ep_axes``."""
    base = dataclasses.replace(get_arch("deepseek-v3-671b").reduced,
                               compute_dtype="float32", ep_axes=ep_axes,
                               **kw)
    return dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=cf, impl="a2a"))


def step_cfg(arch, profile=None, cf=None):
    """The reduced ``arch`` (f32) for a train step; deepseek with the a2a
    at ``cf``."""
    if arch == "deepseek-v3-671b":
        cfg = moe_cfg(cf)
    else:
        cfg = dataclasses.replace(get_arch(arch).reduced,
                                  compute_dtype="float32")
    if profile is not None:
        cfg = dataclasses.replace(cfg, sharding_profile=profile)
    return cfg


def batch_of(tok):
    """Tokens (B, S) → the step's batch (labels shifted, -1 at the end)."""
    B, S = tok.shape
    return dict(tokens=torch.tensor(tok), labels=torch.tensor(
        np.concatenate([tok[:, 1:], np.full((B, 1), -1, np.int32)], 1)),
        positions=torch.arange(S, dtype=torch.int32)[None].expand(
            B, S).contiguous())


def _np(t):
    return t.detach().numpy()


COLLECTIVE_AXES = {"data": ("data",), "model": ("model",),
                   "batch": ("pod", "data"), "all": None}


def _collectives(mesh, x):
    """The mesh's collectives over each set of axes on this rank's row of
    ``x`` (D, G, m): psum, all_gather and all_to_all."""
    blk = torch.tensor(x)[mesh.rank:mesh.rank + 1]
    out = {}
    for name, axes in COLLECTIVE_AXES.items():
        G = mesh.size(axes)
        out[name] = dict(psum=_np(mesh.psum(blk, axes)),
                         all_gather=_np(mesh.all_gather(blk, axes)),
                         all_to_all=_np(mesh.all_to_all(blk[:, :G], axes)))
    return out


def _a2a_case(mesh, case, layer, x):
    """One a2a case on this rank: its rows of ``x``, the experts given
    whole or as this rank's EP block; forward, routing and the gradients
    of ``(y**2).sum() + aux``."""
    cfg = moe_cfg(case["cf"], tuple(case["ep_axes"]))
    place = sharding.data_placements(dict(x=x.shape), mesh)["x"]
    xl = sharding.local_block(torch.tensor(x), place, mesh).clone()
    params = {k: torch.tensor(v) for k, v in layer.items()}
    if case["blocks"]:
        ep = mesh.group_axes(cfg.ep_axes)
        entry = ep if len(ep) > 1 else ep[0]
        for k in ("wi", "wg", "wo"):
            params[k] = sharding.local_block(
                params[k], sharding.Placement((entry, None, None)),
                mesh).clone()
    params = {k: v.requires_grad_() for k, v in params.items()}
    xl.requires_grad_()
    y, aux, st, routing = moe.a2a_with_routing(params, cfg, xl, mesh=mesh)
    g = torch.autograd.grad((y ** 2).sum() + aux, [xl] + list(
        params.values()))
    return dict(y=_np(y), aux=_np(aux), counts=_np(st.counts),
                coact=_np(st.coact), ids=_np(routing.ids),
                slot=_np(routing.slot), keep=_np(routing.keep),
                grads={k: _np(t) for k, t in zip(["x"] + list(params), g)})


def _step_case(mesh, case, params_np, tok):
    """One train step on this rank's trees; its metrics and its trees
    after the step (blocks), and the whole trees gathered back."""
    cfg = step_cfg(case["arch"], case.get("profile"), case.get("cf"))
    params = interop.params_from_numpy(params_np, cfg, device=CPU)
    place = sharding.train_placements(params, mesh, cfg)
    local = sharding.local_tree(params, place, mesh)
    opt = opt_mod.init(local, device=CPU)
    batch = batch_of(tok)
    bplace = sharding.data_placements(batch, mesh, cfg.sharding_profile)
    lbatch = {k: sharding.local_block(v, bplace[k], mesh).contiguous()
              for k, v in batch.items()}
    step = ts_mod.make_train_step(
        cfg, opt_mod.OptConfig(warmup_steps=1, total_steps=10),
        collect_router_stats=cfg.moe is not None, mesh=mesh)
    new, new_opt, m = step(local, opt, lbatch)
    whole = sharding.gather_tree(new, place, mesh)
    return dict(metrics={k: _np(v) for k, v in m.items()},
                local=[_np(t) for t in tree_leaves(new)],
                mu=[_np(t) for t in tree_leaves(new_opt.mu)],
                whole=[_np(t) for t in tree_leaves(whole)],
                places=[tuple(p) for p in _placement_leaves(params, place)])


def _placement_leaves(tree, place):
    """The placements in the order of ``tree``'s leaves."""
    out = []
    sharding.tree_map(lambda _, p: out.append(p), tree, place)
    return out


def all_cases(world, inputs):
    """Every case of the model-mesh tests on this rank, one spawn for
    all: the a2a on each case's mesh, the train steps, the collectives."""
    out = dict(rank=world.rank, a2a={}, steps={})
    meshes = {}

    def mesh_of(axes):
        key = tuple(sorted(axes.items()))
        if key not in meshes:
            meshes[key] = ProcessMesh(world.device, axes=axes)
        return meshes[key]

    for name, case in inputs["a2a"].items():
        out["a2a"][name] = _a2a_case(mesh_of(case["axes"]), case,
                                     inputs["layer"], inputs["x"])
    for name, case in inputs["steps"].items():
        out["steps"][name] = _step_case(
            mesh_of(case["axes"]), case, inputs["params"][case["arch"]],
            inputs["tokens"][case["arch"]])
    out["collectives"] = _collectives(mesh_of(dict(data=2, model=2)),
                                      inputs["blocks"])
    out["repr"] = repr(mesh_of(dict(data=2, model=2)))
    return out
