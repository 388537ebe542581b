"""What each rank of ``tests/test_torch_tp_serving.py`` runs.

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
from repro_torch.distributed import autodiff, sharding
from repro_torch.distributed.mesh import ProcessMesh
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.models import transformer
from repro_torch.models.params import tree_leaves

CPU = "cpu"
B, PLEN, TICKS, MAX_LEN = 4, 14, 8, 24     # decode passes the 16-slot rings


def serve_cfg(arch):
    """The reduced ``arch`` in f32, as its cache paths run it (the "2d"
    profile where it says "dp")."""
    return transformer.serving_config(dataclasses.replace(
        get_arch(arch).reduced, compute_dtype="float32"))


def greedy_generate(params, cfg, batch, cache, ticks, *, embeds=None):
    """``transformer.prefill`` of ``batch`` (positions from 0), then
    ``ticks`` greedy ``decode_step`` ticks, each fed the argmax of the
    previous logits (the audio frontend: the frame embeddings ``embeds``
    (B, ticks, D) in turn).  Returns the tokens (B, ticks + 1) and the
    logits of the prefill and of every tick, each (B, V).  Under an
    ambient ``ProcessMesh`` the inputs are this rank's blocks, the logits
    and tokens every row's, and each tick feeds this rank's rows."""
    index = batch["positions"].shape[1]
    lg, cache = transformer.prefill(params, cfg, batch, cache)
    logits = [lg[:, -1].float()]
    tokens = [torch.argmax(logits[-1], dim=-1)]
    rows = slice(None)
    mesh = sharding.rank_mesh()
    if mesh is not None:
        place = sharding.data_placements(dict(t=(lg.shape[0], 1)), mesh,
                                         cfg.sharding_profile)["t"]
        rows = sharding.block_slices((lg.shape[0], 1), place, mesh)[0]
    for i in range(ticks):
        if embeds is not None:
            lg, cache = transformer.decode_step(
                params, cfg, None, index + i, cache,
                embeds=embeds[:, i:i + 1])
        else:
            lg, cache = transformer.decode_step(
                params, cfg, tokens[-1][rows, None].to(torch.int32),
                index + i, cache)
        logits.append(lg[:, 0].float())
        tokens.append(torch.argmax(logits[-1], dim=-1))
    return torch.stack(tokens, 1), logits


def local_rows(x, mesh, cfg):
    """This rank's rows of a (B, ...) array under ``cfg``'s profile."""
    place = sharding.data_placements(dict(x=x.shape), mesh,
                                     cfg.sharding_profile)["x"]
    return sharding.local_block(torch.tensor(x), place, mesh).contiguous()


def _serve_case(mesh, arch, params_np, prompt):
    """The reduced ``arch`` served on this rank's blocks: the prefill and
    ``TICKS`` greedy ticks; the tokens, logits, the cache blocks after,
    their shapes, the plan and the launches of K6's partials."""
    cfg = serve_cfg(arch)
    params = interop.params_from_numpy(params_np, cfg, device=CPU,
                                       mesh=mesh)
    batch = {k: local_rows(v, mesh, cfg) for k, v in prompt["batch"].items()}
    embeds = (None if prompt["embeds"] is None
              else local_rows(prompt["embeds"], mesh, cfg))
    cache = transformer.init_cache(cfg, B, MAX_LEN, torch.float32, CPU,
                                   mesh=mesh)
    with torch.no_grad(), sharding.use_mesh(mesh):
        tokens, logits = greedy_generate(params, cfg, batch, cache, TICKS,
                                         embeds=embeds)
    # the whole cache out of the ranks' blocks, and back into them
    whole = interop.cache_to_numpy(cache, cfg, mesh, B, MAX_LEN)
    back = interop.cache_from_numpy(whole, cfg, CPU, mesh=mesh)
    return dict(tokens=tokens.numpy(),
                logits=torch.stack(logits).numpy(),
                cache=[t.numpy() for t in tree_leaves(cache)],
                whole=whole if mesh.rank == 0 else None,
                round_trip=all(torch.equal(a, b) for a, b in zip(
                    tree_leaves(cache), tree_leaves(back))),
                plan=sharding.tp_plan(cfg, mesh))


def _partials_case(mesh, inp):
    """Decode attention over this rank's block of the keys (its
    ``"model"`` block of the slots), K6's partials at the case's key
    split gathered over ``"model"`` and merged."""
    q, k, v, qp, kp = (torch.tensor(inp[n]) for n in
                       ("q", "k", "v", "q_pos", "kv_pos"))
    M = mesh.axes["model"]
    T = k.shape[1]
    n = T // M
    i = mesh.group_rank("model", mesh.rank)
    blk = slice(i * n, (i + 1) * n)
    m, l, o = fops.flash_partials(
        q, k[:, blk].contiguous(), v[:, blk].contiguous(), qp,
        kp[:, blk].contiguous(), offset=i * n, total=T,
        keys_per_split=inp["keys_per_split"])
    m, l, o = (autodiff.leave(mesh, t, "model", 0) for t in (m, l, o))
    return fops.flash_combine(m, l, o, q.dtype).numpy()


def all_cases(world, inputs):
    """Every case on this rank: the serving cases on each mesh of
    ``inputs["meshes"]``, and the partials case on each."""
    out = dict(rank=world.rank, serve={}, partials={})
    for name, axes in inputs["meshes"].items():
        mesh = ProcessMesh(CPU, axes=axes)
        for arch in inputs["archs"]:
            out["serve"][(arch, name)] = _serve_case(
                mesh, arch, inputs["params"][arch], inputs["prompts"][arch])
        with torch.no_grad():
            out["partials"][name] = _partials_case(mesh, inputs["partials"])
    out["ambient"] = sharding.ambient_mesh() is None
    return out


def census_cases(world, arch, axes, train, decode):
    """The collectives this rank issues (``ProcessMesh.census``) in one
    sharded train step and one decode step of the reduced ``arch`` (its
    own types) on its blocks, at the shapes ``train`` and ``decode``
    ((seq_len, global_batch) each), the cells the dry run traces."""
    from repro_torch.configs import Shape, materialize_batch
    from repro_torch.models.params import init_blocks
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts_mod

    mesh = ProcessMesh(CPU, axes=axes)
    out = dict(rank=world.rank)
    cfg = get_arch(arch).reduced
    S, Bt = train
    shape = Shape("census", S, Bt, "train")
    specs = transformer.model_specs(cfg)
    params = init_blocks(specs, 0, sharding.train_placements(
        specs, mesh, cfg), mesh, CPU)
    master = cfg.param_dtype != "float32"
    opt = opt_mod.init(params, master_fp32=master, device=CPU)
    batch = materialize_batch(cfg, shape, device=CPU)["batch"]
    place = sharding.data_placements(batch, mesh, cfg.sharding_profile)
    batch = {k: None if v is None else sharding.local_block(
        v, place[k], mesh).contiguous() for k, v in batch.items()}
    step = ts_mod.make_train_step(cfg, opt_mod.OptConfig(master_fp32=master),
                                  mesh=mesh)
    mesh.reset_census()
    step(params, opt, batch)
    out["train"] = mesh.census()
    scfg, sspecs, splace = transformer.serving_layout(cfg, mesh)
    S, Bd = decode
    params = init_blocks(sspecs, 0, splace, mesh, CPU)
    cdt = transformer.as_dtype(scfg.compute_dtype)
    cache = transformer.init_cache(scfg, Bd, S, cdt, CPU, mesh=mesh)
    tok = materialize_batch(scfg, Shape("census", S, Bd, "decode"),
                            device=CPU)["tokens"]
    tok = local_rows(tok.numpy(), mesh, scfg)
    mesh.reset_census()
    with torch.no_grad(), sharding.use_mesh(mesh):
        transformer.decode_step(params, scfg, tok, S - 1, cache)
    out["decode"] = mesh.census()
    return out
