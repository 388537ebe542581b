"""The port's partition rules (``distributed.sharding``) against the JAX
package's (``repro.distributed.sharding``) on the CPU.

For every architecture's published and reduced configuration, on the
meshes ``(data 2, model 4)``, ``(data 16, model 16)`` and ``(pod 2, data
16, model 16)``, under the ``"2d"`` and ``"dp"`` profiles: every
parameter's placement equals the JAX rules' ``PartitionSpec`` leaf by
leaf, and so do the batch's, the caches' and the optimizer state's.  The
JAX rules are called as they are, with a stand-in mesh carrying
``axis_names`` and ``devices.shape`` (their ``_filter`` reads no more)
and ``NamedSharding`` replaced by its ``PartitionSpec`` for the test: the
test process has one device.  The JAX package's stacked ``unit`` leaves
carry a leading replicated group axis; the port's per-layer leaf is the
JAX leaf without it, mapped onto the port's layers as ``repro_torch.
interop`` maps weights.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.distributed import sharding as j_sharding
from repro.models import transformer as jt
from repro_torch.configs import get_arch, list_archs
from repro_torch.distributed import sharding
from repro_torch.distributed.mesh import ShardMesh
from repro_torch.models import transformer
from repro_torch.models.params import ParamSpec

MESHES = {"2x4": dict(data=2, model=4), "16x16": dict(data=16, model=16),
          "2x16x16": dict(pod=2, data=16, model=16)}
PROFILES = ("2d", "dp")
ARCHS = list_archs()


@pytest.fixture
def jrules(monkeypatch):
    """The JAX rules with ``NamedSharding(mesh, spec)`` giving ``spec``."""
    monkeypatch.setattr(j_sharding, "NamedSharding", lambda mesh, spec: spec)
    return j_sharding


def _jmesh(axes):
    return types.SimpleNamespace(axis_names=tuple(axes),
                                 devices=np.empty(tuple(axes.values())))


def _cfgs(arch, size):
    j, t = j_get_arch(arch), get_arch(arch)
    return (j.config, t.config) if size == "published" else (j.reduced,
                                                             t.reduced)


def _port_layout(tree, cfg, unstack):
    """A JAX-layout tree on the port's layout: its layers prefix, the unit
    repeated over the groups (each leaf ``unstack``ed), suffix."""
    def walk(t, fn):
        if isinstance(t, dict):
            return {k: walk(v, fn) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, fn) for v in t]
        return fn(t)

    layers = list(tree["prefix"])
    for _ in range(cfg.num_groups):
        layers += [walk(u, unstack) for u in tree["unit"]]
    out = {k: v for k, v in tree.items()
           if k not in ("unit", "prefix", "suffix")}
    out["layers"] = layers + list(tree["suffix"])
    return out


def _pairs(port, want, path=""):
    """(path, port leaf, JAX leaf) of two trees of one structure."""
    if isinstance(want, dict):
        assert set(port) == set(want), (path, set(port) ^ set(want))
        for k in want:
            yield from _pairs(port[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(port) == len(want), path
        for i, (a, b) in enumerate(zip(port, want)):
            yield from _pairs(a, b, f"{path}/{i}")
    else:
        yield path, port, want


def _unstack_p(p):
    assert tuple(p)[0] is None
    return jax.sharding.PartitionSpec(*tuple(p)[1:])


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("size", ["published", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_placements_equal_the_jax_rules(jrules, arch, size, mesh,
                                              profile):
    jcfg, tcfg = _cfgs(arch, size)
    jspecs = jt.model_specs(jcfg)
    tspecs = transformer.model_specs(tcfg)
    want = _port_layout(jrules.param_shardings(jspecs, _jmesh(MESHES[mesh]),
                                               profile), jcfg, _unstack_p)
    got = sharding.param_placements(tspecs, MESHES[mesh], profile)
    n = 0
    for path, a, b in _pairs(got, want):
        assert isinstance(a, sharding.Placement), path
        assert a == tuple(b), (path, a, b)
        n += 1
    assert n == len(list(_pairs(tspecs, _port_layout(
        jspecs, jcfg, lambda s: s))))


@pytest.mark.parametrize("size", ["published", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_carry_the_jax_partition_axes(arch, size):
    jcfg, tcfg = _cfgs(arch, size)
    want = _port_layout(jt.model_specs(jcfg), jcfg, lambda s: dataclasses.
                        replace(s, shape=s.shape[1:], spec=s.spec[1:]))
    for path, a, b in _pairs(transformer.model_specs(tcfg), want):
        assert isinstance(a, ParamSpec), path
        assert a.spec == tuple(b.spec), (path, a.spec, b.spec)
        assert a.shape == tuple(b.shape), path
        assert (a.init, a.scale) == (b.init, b.scale), path


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_data_and_opt_placements_equal_the_jax_rules(jrules, mesh,
                                                           profile):
    axes = MESHES[mesh]
    jm = _jmesh(axes)
    assert sharding.batch_axes(axes) == jrules.batch_axes(jm)
    for B in (512, 256, 32, 2, 1):
        shapes = dict(tokens=(B, 64), labels=(B, 64), positions=(B, 64),
                      embeds=(B, 8, 16), scalar=())
        want = jrules.data_shardings(
            {k: jax.ShapeDtypeStruct(v, jnp.int32) for k, v in
             shapes.items()}, jm, profile)
        got = sharding.data_placements(shapes, axes, profile)
        for k in shapes:
            assert got[k] == tuple(want[k]), (B, k, got[k], want[k])
    jcfg, tcfg = _cfgs("smollm-135m", "published")
    jp = jrules.param_shardings(jt.model_specs(jcfg), jm, profile)
    tp = sharding.param_placements(transformer.model_specs(tcfg), axes,
                                   profile)
    for master in (False, True):
        want = jrules.opt_shardings(jp, jm, master=master)
        got = sharding.opt_placements(tp, master=master)
        assert got.step == tuple(want.step) == ()
        assert got.mu is tp and got.nu is tp
        assert (got.master is None) == (want.master is None)


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_placements_equal_the_jax_rules(jrules, arch, mesh, profile):
    jcfg, tcfg = _cfgs(arch, "published")
    B, T = 32, 64
    jcache = jax.eval_shape(lambda: jt.init_cache(jcfg, B, T, jnp.bfloat16))
    want = jrules.cache_shardings(jcache, _jmesh(MESHES[mesh]), profile)
    want = _port_layout(want, jcfg, _unstack_p)["layers"]
    got = sharding.cache_placements(
        transformer.init_cache(tcfg, B, T, torch.bfloat16, device="meta"),
        MESHES[mesh], profile)
    pairs = list(_pairs(got, want))
    assert pairs
    for path, a, b in pairs:
        assert a == tuple(b), (path, a, b)


@pytest.mark.parametrize("placement", [
    (("data", "model"), None), ("model", "data"), (None, ("pod", "data")),
    ("model", None), (None, None)])
def test_local_blocks_make_up_the_tensor(placement):
    """Every shard's block, put back at its place, makes up the tensor;
    ``local_block`` of a ``ShardMesh`` (every shard in this process) is
    the tensor; ``gather_tree`` there is the identity."""
    axes = dict(pod=2, data=2, model=2)
    mesh = ShardMesh(device="cpu", axes=axes)
    p = sharding.Placement(placement)
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    out = torch.full_like(x, -1.0)
    seen = torch.zeros_like(x)
    for s in range(mesh.num_shards):
        blk = sharding.local_block(x, p, mesh, shard=s)
        c = mesh.coords(s)
        idx = []
        for dim, a in enumerate(p):
            names = () if a is None else ((a,) if isinstance(a, str) else a)
            G, i = 1, 0
            for n in names:
                G, i = G * axes[n], i * axes[n] + c[n]
            m = x.shape[dim] // G
            idx.append(slice(i * m, (i + 1) * m))
        assert blk.shape == x[tuple(idx)].shape
        out[tuple(idx)] = blk
        seen[tuple(idx)] += 1
    assert torch.equal(out, x)
    assert int(seen.min()) == int(seen.max()) == mesh.num_shards // (
        1 if not p.axes() else int(np.prod([axes[a] for a in p.axes()])))
    assert sharding.local_block(x, p, mesh) is x
    tree = dict(a=[x])
    assert sharding.gather_tree(tree, dict(a=[p]), mesh) is tree


TRAIN_MESHES = {"2x2": dict(data=2, model=2), "4": dict(model=4)}


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("mesh", list(TRAIN_MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_placements_equal_the_jax_rules(jrules, arch, mesh, profile):
    """The sharded step keeps every leaf of the reduced config where the
    JAX rules place it (``param_shardings``) on the four-rank meshes: the
    expert stacks ``(ep_axes, "data", None)``, the dense layers and the
    vocabulary over "model", the ``"data"`` entries FSDP — on its specs
    and on a tree of tensors alike."""
    jcfg = dataclasses.replace(j_get_arch(arch).reduced,
                               sharding_profile=profile)
    tcfg = dataclasses.replace(get_arch(arch).reduced,
                               sharding_profile=profile)
    axes = TRAIN_MESHES[mesh]
    want = _port_layout(jrules.param_shardings(
        jt.model_specs(jcfg), _jmesh(axes), profile), jcfg, _unstack_p)
    specs = transformer.model_specs(tcfg)
    got = sharding.train_placements(specs, axes, tcfg)
    n = 0
    for path, a, b in _pairs(got, want):
        assert isinstance(a, sharding.Placement), path
        assert a == tuple(b), (path, a, b)
        n += 1
    assert n == len(list(_pairs(specs, specs)))
    tensors = sharding.tree_map(lambda s: torch.empty(s.shape,
                                                      device="meta"), specs)
    assert sharding.train_placements(tensors, axes, tcfg) == got
    if tcfg.moe is not None and profile == "2d" and "data" in axes:
        for layer in got["layers"]:
            if "moe" in layer:
                assert layer["moe"]["wi"] == ("model", "data", None)
                assert layer["moe"]["wo"] == ("model", None, "data")


def test_grad_sum_axes_leave_out_the_split_axes():
    """A leaf's gradient is summed over the batch axes it is not split
    over (its FSDP gather's reduce-scatter has summed those it is split
    over), and the router's over "model" too."""
    dm = dict(data=2, model=2)
    P = sharding.Placement
    assert sharding.grad_sum_axes(P(("model", None)), dm) == ("data",)
    assert sharding.grad_sum_axes(P(("data", None)), dm) == ()
    assert sharding.grad_sum_axes(P(("data", "model")), dm) == ()
    assert sharding.grad_sum_axes(P((None,)), dm, model=True) == (
        "data", "model")
    assert sharding.grad_sum_axes(P((None,)), dm, "dp") == ("data", "model")
    assert sharding.grad_sum_axes(P(("data", None)), dm, "dp") == ("model",)
    assert sharding.grad_sum_axes(P(("model", "data", None)), dm,
                                  "dp") == ()


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_plan_follows_heads_widths_and_the_profile(arch):
    """``tp_plan`` on the reduced configs: under "dp" or without a
    "model" axis everything is gathered; under "2d" GQA takes the plain
    split where the KV heads divide over "model", the head-repeat branch
    where only the query heads do (the JAX gate), else gathers; MLA splits
    where its heads divide; an MLP or the vocabulary is tensor parallel
    where its width divides; hymba's mamba part and the xLSTM cells are
    head parallel where their heads divide, else gathered."""
    cfg = get_arch(arch).reduced
    for axes in (dict(data=2, model=2), dict(model=4), dict(data=4)):
        for profile in PROFILES:
            c = dataclasses.replace(cfg, sharding_profile=profile)
            plan = sharding.tp_plan(c, axes)
            M = axes.get("model", 1) if profile == "2d" else 1
            kinds = set(c.all_layers()) | ({"attn"} if c.mtp else set())
            assert set(plan) == kinds | {"embed"}
            modes = {m for p in plan.values() for m in p.values()}
            if M == 1:
                assert modes == {"gather"}, (arch, axes, profile)
                continue
            H, KV = c.num_heads, c.num_kv_heads
            if c.attention == "mla":
                att = "tp" if H % M == 0 else "gather"
            elif KV % M == 0 and (KV * c.hd) % M == 0:
                att = "tp"
            elif H % M == 0:
                att = "repeat"
            else:
                att = "gather"
            for kind, p in plan.items():
                if "attn" in p:
                    assert p["attn"] == att, (arch, axes, kind, p)
                if "mlp" in p:
                    width = (c.d_ff_dense or c.d_ff) if kind in (
                        "attn", "attn_local") else c.d_ff
                    assert p["mlp"] == ("tp" if width % M == 0
                                        else "gather"), (arch, kind)
                for part in ("mamba", "cell"):
                    assert p.get(part, "gather") == (
                        "tp" if part in p and H % M == 0
                        else "gather"), (arch, axes, kind, p)
            assert plan["embed"]["vocab"] == (
                "tp" if c.vocab_size % M == 0 else "gather")


@pytest.mark.parametrize("arch", ["qwen1.5-110b", "gemma3-27b"])
def test_repeat_gate_reads_a_whole_cache_as_its_slots(arch):
    """The head-repeat gate over (model 4) against the JAX gate, ``T_kv =
    k.shape[1] <= 16384`` of the whole cache JAX makes: a cache whose
    slots do not divide over "model" is whole on the rank (16383 and
    16386 slots), one that divides is a quarter (16384, 16388), and each
    layer's plan is "repeat" exactly where JAX's global slot count passes
    the gate — which no block's shape tells (16383 whole and 65532 split
    are 16383 slots a rank)."""
    from repro_torch.distributed.mesh import TraceMesh
    from repro_torch.models import attention

    cfg = get_arch(arch).reduced
    jcfg = j_get_arch(arch).reduced
    mesh = TraceMesh(dict(model=4))
    assert attention.REPEAT_MAX_KV == 16384
    assert {p["attn"] for k, p in sharding.tp_plan(cfg, mesh).items()
            if k != "embed"} == {"repeat"}
    for T in (16383, 16384, 16386, 16388):
        cache = transformer.init_cache(cfg, 2, T, torch.bfloat16, "meta",
                                       mesh=mesh)
        split = transformer.slots_split(cache, mesh)
        jcache = jax.eval_shape(lambda: jt.init_cache(jcfg, 2, T,
                                                      jnp.bfloat16))
        # JAX's T_kv a layer: its whole k's slots (the unit's leaves carry
        # the group axis first)
        jslots = [c["kv"]["k"].shape[-3] for c in _port_layout(
            jcache, jcfg, lambda t: t)["layers"]]
        assert len(jslots) == len(cache)
        for kind, layer, s, want in zip(cfg.all_layers(), cache, split,
                                        jslots):
            assert s == (want % 4 == 0), (arch, T, kind)
            assert layer["kv"]["pos"].shape[1] == (want // 4 if s
                                                   else want)
            got = transformer.layer_plan(
                cfg, kind, mesh, transformer.kv_slots(layer["kv"], s, mesh))
            assert got["attn"] == ("repeat" if want <= 16384
                                   else "gather"), (arch, T, kind)


def test_a_rank_cache_keeps_its_placements_through_the_tree_maps():
    """``params.tree_map`` (``tree_to``) and ``sharding.tree_map`` rebuild
    a cache over a mesh with the placements it was cut by, so a cache
    moved between devices still tells its whole layers (23 slots over
    (model 4)) from its split rings."""
    from repro_torch.distributed.mesh import TraceMesh
    from repro_torch.models import params as P

    cfg = get_arch("gemma3-27b").reduced
    mesh = TraceMesh(dict(model=4))
    cache = transformer.init_cache(cfg, 2, 23, torch.float32, "cpu",
                                   mesh=mesh)
    want = transformer.slots_split(cache, mesh)
    assert any(want) and not all(want)
    for moved in (P.tree_to(cache, "cpu"),
                  sharding.tree_map(torch.clone, cache)):
        assert type(moved) is transformer.RankCache
        assert moved.placements is cache.placements
        assert transformer.slots_split(moved, mesh) == want


def _variant(arch):
    from tests import tp_serving_ranks as srk

    return srk.reduced(arch)


@pytest.mark.parametrize("arch,size,axes,profile,want", [
    ("xlstm-125m", "published", dict(model=4), "2d", "tp"),
    ("xlstm-125m", "published", dict(data=2, model=2), "2d", "tp"),
    ("xlstm-125m", "reduced", dict(data=2, model=2), "2d", "tp"),
    ("hymba-h4", "reduced", dict(data=2, model=2), "2d", "tp"),
    ("hymba-h4", "reduced", dict(model=4), "2d", "tp"),
    ("hymba-1.5b", "published", dict(model=4), "2d", "gather"),
    ("xlstm-125m", "reduced", dict(model=4), "2d", "gather"),
    ("xlstm-125m", "published", dict(model=4), "dp", "gather"),
    ("hymba-h4", "reduced", dict(data=2, model=2), "dp", "gather"),
    ("xlstm-125m", "published", dict(data=16, model=16), "2d", "gather"),
    ("xlstm-125m", "published", dict(pod=2, data=16, model=16), "2d",
     "gather"),
    ("xlstm-125m", "published", dict(data=4), "2d", "gather"),
])
def test_tp_plan_runs_ssm_heads_parallel_where_they_divide(arch, size, axes,
                                                           profile, want):
    """``tp_plan`` gives hymba's ``"mamba"`` part and the xLSTM ``"cell"``
    ``"tp"`` exactly where "model" is active under the profile, has
    several members and divides the heads (xlstm-125m's 4 over 4 and 2;
    the reduced xlstm's 2 over 2; the 4-head hymba variant over 2 and 4),
    else ``"gather"`` (hymba-1.5b's 25 heads over 4, the reduced xlstm's
    2 over 4, anything under "dp", 4 heads over 16); where "tp", every
    "model" block of their leaves is whole heads under the rules'
    placement."""
    cfg = (get_arch(arch).config if size == "published"
           else _variant(arch))
    cfg = dataclasses.replace(cfg, sharding_profile=profile)
    plan = sharding.tp_plan(cfg, axes)
    parts = {(k, part): p[part] for k, p in plan.items()
             for part in ("mamba", "cell") if part in p}
    assert parts and set(parts.values()) == {want}, (arch, axes, plan)
    if want != "tp":
        return
    M, H = axes["model"], cfg.num_heads
    specs = transformer.model_specs(cfg)
    place = sharding.param_placements(specs, axes, profile)
    for i, kind in enumerate(cfg.all_layers()):
        part = "mamba" if "mamba" in specs["layers"][i] else "cell"
        for name, s in specs["layers"][i][part].items():
            p = place["layers"][i][part][name]
            for dim, a in enumerate(s.spec):
                if a != "model":
                    continue
                assert p[dim] == "model", (kind, name, p)
                n = s.shape[dim]
                assert n % H == 0 and (n // M) % (n // H) == 0, (kind, name)


def test_tp_plan_refuses_ssm_blocks_that_are_not_whole_heads():
    """The plan's check: an SSM leaf whose "model" dim is not whole heads
    in every block (here 6 columns for 4 heads) raises; one of whole
    heads passes."""
    sizes = dict(model=2)
    sharding._check_head_blocks(
        dict(w=ParamSpec((4, 8), ("data", "model"))), 4, 2, sizes, "2d")
    with pytest.raises(ValueError, match="whole heads"):
        sharding._check_head_blocks(
            dict(w=ParamSpec((4, 6), ("data", "model"))), 4, 2, sizes, "2d")
