"""What each rank of ``tests/test_torch_tensor_parallel.py`` runs.

A module of its own, importing neither JAX nor the JAX package, so that a
spawned rank (``launch.mesh.run_ranks``) imports only the port.  The
parent passes every input as NumPy arrays; each case returns NumPy
arrays.
"""
import dataclasses

import numpy as np
import torch

from repro_torch import interop
from repro_torch.distributed import autodiff, sharding
from repro_torch.distributed.mesh import ProcessMesh
from repro_torch.models import moe, transformer
from repro_torch.models.params import ParamSpec, init_blocks, tree_leaves
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_step as ts_mod
from tests.tp_serving_ranks import reduced

CPU = "cpu"
OCFG = dict(warmup_steps=1, total_steps=10)


def step_cfg(arch, profile="2d", cf=8.0):
    """The reduced ``arch`` (or variant, ``tp_serving_ranks.VARIANTS``) in
    f32 under ``profile``; a MoE config with the a2a at capacity factor
    ``cf``."""
    cfg = dataclasses.replace(reduced(arch), compute_dtype="float32",
                              sharding_profile=profile)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf, impl="a2a"))
    return cfg


def batch_of(tok):
    """Tokens (B, S) → the step's batch (labels shifted, -1 at the end)."""
    B, S = tok.shape
    return dict(tokens=torch.tensor(tok), labels=torch.tensor(
        np.concatenate([tok[:, 1:], np.full((B, 1), -1, np.int32)], 1)),
        positions=torch.arange(S, dtype=torch.int32)[None].expand(
            B, S).contiguous())


def local_batch(batch, mesh, cfg):
    place = sharding.data_placements(batch, mesh, cfg.sharding_profile)
    return {k: sharding.local_block(v, place[k], mesh).contiguous()
            for k, v in batch.items()}


def _np(t):
    return t.detach().numpy()


def paths(tree, path=""):
    """{path: leaf} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in paths(sub, f"{path}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in paths(sub, f"{path}/{i}").items()}
    return {path: tree}


def shapes(tree):
    """{path: shape} of a tree of tensors."""
    return {k: tuple(t.shape) for k, t in paths(tree).items()}


def _step_case(mesh, case, params_np, tok):
    """This rank's blocks of the case's weights: the forward's hidden
    states on its rows, then one train step; the metrics, the trees after
    the step (blocks, their shapes, the whole gathered back) and the
    layers' plan."""
    cfg = step_cfg(case["arch"], case["profile"], case["cf"])
    params = interop.params_from_numpy(params_np, cfg, device=CPU, mesh=mesh)
    whole = interop.params_from_numpy(params_np, cfg, device=CPU)
    cut = sharding.local_tree(whole, sharding.train_placements(
        whole, mesh, cfg), mesh)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(cut)))
    # init_blocks draws this rank's blocks with the whole tree's bits
    specs = transformer.model_specs(cfg)
    place = sharding.train_placements(specs, mesh, cfg)
    drawn = init_blocks(specs, 1, place, mesh, CPU)
    drawn_whole = sharding.local_tree(init_blocks(specs, 1, device=CPU),
                                      place, mesh)
    same_draw = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(drawn), tree_leaves(drawn_whole)))
    del whole, cut, drawn, drawn_whole
    lbatch = local_batch(batch_of(tok), mesh, cfg)
    with torch.no_grad(), sharding.use_mesh(mesh):
        h, _ = transformer.forward(params, cfg, lbatch)
    opt = opt_mod.init(params, device=CPU)
    step = ts_mod.make_train_step(cfg, opt_mod.OptConfig(**OCFG),
                                  collect_router_stats=cfg.moe is not None,
                                  mesh=mesh)
    new, new_opt, m = step(params, opt, lbatch)
    place = sharding.train_placements(new, mesh, cfg)
    whole = sharding.gather_tree(new, place, mesh)
    places = []
    sharding.tree_map(lambda _, p: places.append(tuple(p)), new, place)

    return dict(hidden=_np(h), metrics={k: _np(v) for k, v in m.items()},
                local=[_np(t) for t in tree_leaves(new)],
                shapes=dict(params=shapes(params), new=shapes(new),
                            mu=shapes(new_opt.mu), nu=shapes(new_opt.nu)),
                whole=[_np(t) for t in tree_leaves(whole)], places=places,
                plan=sharding.tp_plan(cfg, mesh), interop_is_local_tree=same,
                init_blocks_is_local_tree=same_draw)


def _ce_case(mesh, logits, labels):
    """The vocabulary-parallel CE terms of this rank's block of ``logits``
    (split over "model"), and the gradient of their sums on its block."""
    M = mesh.axes["model"]
    V = logits.shape[-1]
    i = mesh.group_rank("model", mesh.rank)
    blk = torch.tensor(logits[..., i * V // M:(i + 1) * V // M]
                       ).requires_grad_()
    nll, zl, valid = transformer._ce_terms_tp(blk, torch.tensor(labels),
                                              torch.float32, mesh)
    g, = torch.autograd.grad(nll.sum() + zl.sum(), [blk])
    return dict(nll=_np(nll), z=_np(zl), valid=_np(valid), grad=_np(g))


def _dp_a2a_case(mesh, layer, x, cf):
    """deepseek-v3's MoE layer under "dp" at capacity ``cf`` on this
    rank's rows (its block over every axis) with its blocks of the
    weights (experts over "model", FSDP over "data"): output, routing,
    statistics and the gradients of ``(y**2).sum() + aux``."""
    cfg = step_cfg("deepseek-v3-671b", "dp", cf)
    specs = moe.moe_specs(cfg)
    place = sharding.param_placements(specs, mesh, "dp")
    params = {k: sharding.local_block(torch.tensor(v), place[k], mesh)
              .clone().requires_grad_() for k, v in layer.items()}
    xp = sharding.data_placements(dict(x=x.shape), mesh, "dp")["x"]
    xl = sharding.local_block(torch.tensor(x), xp, mesh).clone()
    xl.requires_grad_()
    y, aux, st, routing = moe.a2a_with_routing(params, cfg, xl, mesh=mesh)
    g = torch.autograd.grad((y ** 2).sum() + aux, [xl] + list(
        params.values()))
    return dict(y=_np(y), aux=_np(aux), counts=_np(st.counts),
                coact=_np(st.coact), ids=_np(routing.ids),
                slot=_np(routing.slot), keep=_np(routing.keep),
                grads={k: _np(t) for k, t in zip(["x"] + list(params), g)})


def _autodiff_case(mesh, inp):
    """tp_in / tp_out, fsdp_gather and leave with gradients, and the
    collectives they run on, on this rank's shares of the parent's whole
    tensors; and the global norm of leaves split over "data", over
    "model", over both and over neither."""
    r = mesh.rank
    c = mesh.coords(r)
    M, Dd = mesh.axes["model"], mesh.axes["data"]
    out = {}
    # a column- then a row-parallel product over "model", replicated x
    x = torch.tensor(inp["x"]).requires_grad_()
    A, Bm = torch.tensor(inp["A"]), torch.tensor(inp["B"])
    n = A.shape[1] // M
    a = A[:, c["model"] * n:(c["model"] + 1) * n].clone().requires_grad_()
    b = Bm[c["model"] * n:(c["model"] + 1) * n].clone().requires_grad_()
    h = torch.relu(autodiff.tp_in(x, mesh, "model") @ a)
    y = autodiff.tp_out(h @ b, mesh, "model")
    gx, ga, gb = torch.autograd.grad((y * y).sum(), [x, a, b])
    out["tp"] = dict(y=_np(y), x=_np(gx), a=_np(ga), b=_np(gb))
    # the row-parallel product in bf16: the partials added in f32
    h16 = torch.tensor(inp["h"]).to(torch.bfloat16)
    h16 = h16[:, c["model"] * n:(c["model"] + 1) * n].clone()
    b16 = Bm.to(torch.bfloat16)[c["model"] * n:(c["model"] + 1) * n].clone()
    h16.requires_grad_()
    b16.requires_grad_()
    y16 = autodiff.row_parallel(h16, b16, mesh, "model")
    gh, gb16 = torch.autograd.grad((y16.float() ** 2).sum(), [h16, b16])
    out["row16"] = dict(y=_np(y16.float()), h=_np(gh.float()),
                        b=_np(gb16.float()))
    # a leaf split over "data" on dim 1, gathered; the "data" ranks see
    # other tokens (rows of t), the "model" ranks the same ones
    W = torch.tensor(inp["W"])
    t = torch.tensor(inp["t"])
    k = W.shape[1] // Dd
    w = W[:, c["data"] * k:(c["data"] + 1) * k].clone().requires_grad_()
    tok = t[c["data"]]
    whole = autodiff.fsdp_gather(w, mesh, "data", 1)
    gw, = torch.autograd.grad(((tok @ whole) ** 2).sum(), [w])
    out["fsdp"] = dict(whole=_np(whole), grad=_np(gw))
    # a leaf split over "model" on dim 1, gathered; its ranks see the same
    # tokens: the gradient is this rank's block, not summed
    k = W.shape[1] // M
    w = W[:, c["model"] * k:(c["model"] + 1) * k].clone().requires_grad_()
    whole = autodiff.leave(mesh, w, "model", 1)
    gw, = torch.autograd.grad(((tok @ whole) ** 2).sum(), [w])
    out["leave"] = dict(whole=_np(whole), grad=_np(gw))
    # the collectives under them, on this rank's row of blocks (W, G, m)
    blk = torch.tensor(inp["blocks"])[r:r + 1]
    out["collectives"] = {
        name: dict(pmax=_np(mesh.pmax(blk, axes)),
                   reduce_scatter=_np(mesh.reduce_scatter(blk, axes)))
        for name, axes in (("data", "data"), ("model", "model"),
                           ("all", None))}
    # the global norm of blocks over data, model, both and neither
    leaves = {k: torch.tensor(v) for k, v in inp["norm"].items()}
    places = dict(data=sharding.Placement(("data", None)),
                  model=sharding.Placement((None, "model")),
                  both=sharding.Placement(("data", "model")),
                  neither=sharding.Placement((None, None)))
    blocks = {k: sharding.local_block(v, places[k], mesh)
              for k, v in leaves.items()}
    out["norm"] = _np(opt_mod.global_norm(blocks, mesh, places))
    # sharding.gathered: a dim already whole is left as it is; partial
    # use adds the gradients over "model" even where the leaf is whole
    spec = ParamSpec(tuple(W.shape), (None, "model"))
    wl = W.clone().requires_grad_()
    got = sharding.gathered(wl, spec, mesh, "2d", partial=True)
    g, = torch.autograd.grad((got * (1.0 + c["model"])).sum(), [wl])
    out["partial_whole"] = _np(g)
    return out


def all_cases(world, inputs):
    """Every case on this rank, one spawn for all."""
    meshes = {}

    def mesh_of(axes):
        key = tuple(sorted(axes.items()))
        if key not in meshes:
            meshes[key] = ProcessMesh(world.device, axes=axes)
        return meshes[key]

    out = dict(rank=world.rank, steps={})
    for name, case in inputs["steps"].items():
        out["steps"][name] = _step_case(
            mesh_of(case["axes"]), case, inputs["params"][case["arch"]],
            inputs["tokens"][case["arch"]])
    dm = mesh_of(dict(data=2, model=2))
    out["ce"] = {name: _ce_case(mesh_of(axes), inputs["ce"]["logits"],
                                inputs["ce"]["labels"][name])
                 for name, axes in inputs["ce"]["meshes"].items()}
    out["dp_a2a"] = {str(cf): _dp_a2a_case(dm, inputs["layer"], inputs["x"],
                                           cf) for cf in (1.25, 8.0)}
    out["autodiff"] = _autodiff_case(dm, inputs["autodiff"])
    out["ambient"] = sharding.ambient_mesh() is None
    return out
