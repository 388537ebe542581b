"""The port's dry run (``repro_torch.launch.dryrun``) and roofline
(``benchmarks_torch/roofline.py``) on the CPU: parameter and model-FLOP
counts equal the JAX driver's for every arch × shape, a reduced train cell
traces under fake tensors, a lone ``Linear``'s FLOPs and argument bytes
are exact, failures and skips are recorded, and the roofline reads the
artifacts with the H100's peaks."""
import dataclasses
import functools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, Shape, get_arch, list_archs
from repro_torch.distributed.mesh import TraceMesh
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch import dryrun
from repro_torch.models import transformer
from repro_torch.models.params import count_params, shape_dtype_tree, tree_map

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_counts():
    """The JAX driver's ``active_params`` and ``model_flops`` for every
    cell, from a subprocess: importing ``repro.launch.dryrun`` sets
    ``XLA_FLAGS`` to 512 host devices for its process."""
    code = (
        "import json\n"
        "from repro.configs import SHAPES, get_arch, list_archs\n"
        "from repro.launch import dryrun as d\n"
        "out = {a: dict(params=d.active_params(get_arch(a).config),\n"
        "               flops={s: d.model_flops(get_arch(a).config, sh)\n"
        "                      for s, sh in SHAPES.items()})\n"
        "       for a in list_archs()}\n"
        "print(json.dumps(out))\n")
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=str(ROOT),
        env={**__import__("os").environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", list_archs())
def test_active_params_and_model_flops_equal_jax(arch, jax_counts):
    cfg = get_arch(arch).config
    assert dryrun.active_params(cfg) == jax_counts[arch]["params"]
    for s, shape in SHAPES.items():
        assert dryrun.model_flops(cfg, shape) == jax_counts[arch]["flops"][s]


def test_lone_linear_flops_and_argument_bytes_are_exact():
    from torch._subclasses.fake_tensor import FakeTensorMode

    M, K, N = 8, 64, 32
    with FakeTensorMode():
        x = torch.empty((M, K))
        lin = dict(w=torch.empty((N, K)), b=torch.empty((N,)))
        rec = dryrun.measure(
            lambda x, p: torch.nn.functional.linear(x, p["w"], p["b"]),
            x, lin)
    assert rec["cost"]["flops"] == 2 * M * K * N
    assert rec["memory"]["argument_bytes"] == 4 * (M * K + N * K + N)
    assert rec["memory"]["output_bytes"] == 4 * M * N
    assert rec["memory"]["peak_device_bytes"] >= 4 * (M * K + N * K + N
                                                       + M * N)
    assert rec["op_census"]["addmm"] == 1
    # each operation's operands read and results written: one addmm
    assert rec["cost"]["bytes_accessed"] >= 4 * (M * K + N * K + N + M * N)


@pytest.mark.parametrize("Sq,T,window,prefix_len", [
    (40, 40, 0, 0), (40, 40, 7, 0), (40, 40, 0, 5), (40, 40, 7, 12),
    (1, 50, 0, 0), (1, 16, 16, 0), (40, 16, 16, 0), (3, 30, 4, 9),
    (33, 33, 40, 50)])
def test_attended_pairs_equal_the_mask(Sq, T, window, prefix_len):
    """The trace's pair count is what K6's mask allows at the positions it
    stands in for: queries the last Sq, keys the last T of max(Sq, T)."""
    from repro_torch.kernels.flash_attention.ref import mask

    n = max(Sq, T)
    allowed = mask(torch.arange(n - Sq, n)[None], torch.arange(n - T, n)[None],
                   window, prefix_len)
    assert dryrun.attended_pairs(Sq, T, window, prefix_len) == int(
        allowed.sum())


@pytest.mark.parametrize("window,prefix_len", [(0, 0), (7, 0), (0, 9)])
def test_card_attention_is_flash_attention_and_counts_k6(window, prefix_len):
    """``card_flash_attention`` computes ``flash_attention``'s output and
    gradients exactly on real CPU tensors; traced, it is K6's forward and
    backward, FLOPs 4·pairs·hd and 10·pairs·hd, bytes their operands."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.flash_attention.ops import flash_attention

    B, S, KV, G, hd = 2, 40, 2, 3, 16
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, requires_grad=True)
               for shape in [(B, S, KV, G, hd), (B, S, KV, hd),
                             (B, S, KV, hd)])
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    outs = []
    for fn in (flash_attention, dryrun.card_flash_attention):
        o = fn(q, k, v, pos, pos, window=window, prefix_len=prefix_len)
        outs.append((o, *torch.autograd.grad((o * o).sum(), (q, k, v))))
    for a, b in zip(*outs):
        assert torch.equal(a, b)

    pairs = B * KV * G * dryrun.attended_pairs(S, S, window, prefix_len)
    with FakeTensorMode():
        fq, fk, fv = (torch.empty(t.shape, requires_grad=True)
                      for t in (q, k, v))
        fpos = torch.empty((B, S), dtype=torch.int32)
        fwd = dryrun.measure(
            lambda: dryrun.card_flash_attention(
                fq, fk, fv, fpos, fpos, window=window,
                prefix_len=prefix_len).detach())
        both = dryrun.measure(lambda: torch.autograd.grad(
            dryrun.card_flash_attention(
                fq, fk, fv, fpos, fpos, window=window,
                prefix_len=prefix_len).sum(), (fq, fk, fv)))
    assert fwd["cost"]["flops"] == 4 * pairs * hd
    assert both["cost"]["flops"] == 14 * pairs * hd
    assert fwd["op_census"]["flash_attention"] == 1
    assert set(fwd["op_census"]) == {"detach", "flash_attention",
                                     "transpose"}
    assert both["op_census"]["flash_attention_bwd"] == 1
    # q, k, v and the positions read, the output written, once
    assert fwd["cost"]["bytes_accessed"] == 4 * (
        2 * q.numel() + 2 * k.numel() + 2 * B * S)


def test_overrides_are_the_ones_the_port_reads():
    cfg = get_arch("gemma3-1b").config
    assert dryrun.apply_overrides(
        cfg, {"sliding_window": "64"}).sliding_window == 64
    for key in ("sharding", "ep", "remat"):
        with pytest.raises(ValueError, match="unknown override"):
            dryrun.apply_overrides(cfg, {key: "x"})


def test_reduced_train_cell_is_ok():
    """smollm-135m's reduced config through the train step under fake
    tensors: status ok, argument bytes exactly params + AdamW state +
    batch, FLOPs above the 6·N·D model FLOPs (attention), K6's forward
    and backward once a layer (no remat, the training launcher's
    default), nothing allocated."""
    spec = get_arch("smollm-135m")
    B, S = 2, 64
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=S, global_batch=B)
    rec = dryrun.run_cell("smollm-135m", "train_4k", config=spec.reduced,
                          shape=shape, save=False)
    assert rec["status"] == "ok", rec.get("traceback")
    N = count_params(transformer.model_specs(spec.reduced))
    assert rec["memory"]["argument_bytes"] == 12 * N + 4 + 3 * 4 * B * S
    assert rec["remat"] == "none" and rec["chips"] == 1
    L = spec.reduced.num_layers
    assert rec["op_census"]["flash_attention"] == L
    assert rec["op_census"]["flash_attention_bwd"] == L
    assert rec["cost"]["flops"] > rec["model_flops"]
    assert rec["memory"]["peak_device_bytes"] > rec["memory"][
        "argument_bytes"] and rec["memory"]["fits"]
    assert rec["collective_bytes"] == 0.0
    assert set(rec["collectives"]) == set(dryrun.COLLECTIVES)
    r = rec["roofline"]
    assert r["t_compute"] == rec["cost"]["flops"] / 989e12
    assert r["t_memory"] == rec["cost"]["bytes_accessed"] / 3.35e12
    assert r["t_collective"] == 0.0


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
def test_reduced_inference_cells_are_ok(shape_name):
    spec = get_arch("gemma3-1b")
    shape = dataclasses.replace(SHAPES[shape_name], seq_len=48,
                                global_batch=2)
    rec = dryrun.run_cell("gemma3-1b", shape_name, config=spec.reduced,
                          shape=shape, save=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["remat"] == "none" and rec["cost"]["flops"] > 0


def test_skip_fail_and_multi(monkeypatch):
    rec = dryrun.run_cell("smollm-135m", "long_500k", save=False)
    assert rec["status"] == "skip" and "sub-quadratic" in rec["reason"]
    # a reduced config's train cell on the two-pod mesh: rank 0's blocks,
    # its collectives in the JAX record's kinds, their link time
    spec = get_arch("smollm-135m")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=32,
                                global_batch=64)
    rec = dryrun.run_cell("smollm-135m", "train_4k", "multi",
                          config=spec.reduced, shape=shape, save=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["remat"] == "full"            # the JAX dry run's "auto"
    assert rec["chips"] == 512 and rec["mesh_axes"] == dict(
        pod=2, data=16, model=16)
    assert set(rec["collectives"]) == set(dryrun.COLLECTIVES)
    assert rec["collectives"]["all-gather"]["count"] > 0
    assert rec["collectives"]["all-reduce"]["count"] == 0
    assert rec["collective_bytes"] == sum(
        v["bytes"] for v in rec["collectives"].values()) > 0
    assert rec["roofline"]["t_collective"] == rec["t_collective_s"] > 0
    assert rec["memory"]["fits"]
    N = count_params(transformer.model_specs(spec.reduced))
    assert rec["memory"]["argument_bytes"] < 12 * N
    # an explicit remat wins on the pod meshes: fewer recomputed FLOPs
    none = dryrun.run_cell("smollm-135m", "train_4k", "multi",
                           config=spec.reduced, shape=shape, save=False,
                           remat="none")
    assert none["status"] == "ok", none.get("traceback")
    assert none["remat"] == "none"
    assert none["cost"]["flops"] < rec["cost"]["flops"]
    with pytest.raises(ValueError, match="unknown mesh"):
        dryrun.run_cell("smollm-135m", "train_4k", "torus", save=False)

    def data_dependent(cfg, shape, remat):
        return (lambda x: torch.nonzero(x)), (torch.ones(4),)

    monkeypatch.setattr(dryrun, "build_cell", data_dependent)
    rec = dryrun.run_cell("smollm-135m", "train_4k", save=False)
    assert rec["status"] == "fail" and "Dynamic" in rec["error"]


def test_traffic_counts_a_new_storage_under_a_released_key(monkeypatch):
    """A storage that meets the key of a released one is counted afresh,
    the released one's bytes dropped."""
    class Key:
        expired_ = False

        def expired(self):
            return self.expired_

        def __hash__(self):
            return 0

        def __eq__(self, other):
            return True

    keys = iter([Key(), Key()])
    monkeypatch.setattr(dryrun, "_storage_key", lambda t: next(keys))
    tr = dryrun.Traffic()
    first = torch.empty(4)
    tr.hold(first)
    assert tr.current == tr.peak == 16
    next(iter(tr.live)).expired_ = True        # the first one released
    tr.hold(torch.empty(10))
    assert tr.current == 40 and tr.peak == 40 and len(tr.live) == 1


def test_shape_dtype_tree_allocates_nothing():
    specs = transformer.model_specs(get_arch("gemma3-1b").config)
    tree = shape_dtype_tree(specs)
    leaves = []
    tree_map(leaves.append, tree)
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) == count_params(specs)


def test_roofline_reads_the_artifacts(tmp_path, monkeypatch):
    from benchmarks_torch import common, roofline

    monkeypatch.setattr(dryrun, "ARTIFACTS", tmp_path / "dryrun_torch")
    monkeypatch.setattr(roofline, "ARTIFACTS", str(tmp_path / "dryrun_torch"))
    monkeypatch.setattr(common, "ARTIFACTS", tmp_path / "bench_torch")
    spec = get_arch("smollm-135m")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=32,
                                global_batch=2)
    ok = dryrun.run_cell("smollm-135m", "train_4k", config=spec.reduced,
                         shape=shape)
    dryrun.run_cell("smollm-135m", "long_500k")
    dryrun._save(dict(arch="gemma3-1b", shape="train_4k", mesh="single",
                      status="fail", error="x"), "gemma3-1b", "train_4k",
                 "single", "")
    out = roofline.run()
    assert list(out) == ["smollm-135m×train_4k"]
    row = out["smollm-135m×train_4k"]
    assert row["dominant"] == ok["roofline"]["dominant"]
    assert row["note"] == roofline.note_for(ok)
    assert (tmp_path / "bench_torch" / "roofline_single.json").exists()
    assert roofline.NOTES[("memory",)].startswith("fuse/eliminate")


def test_roofline_reads_the_multi_mesh_artifacts(tmp_path, monkeypatch):
    """``roofline.py --mesh multi`` reads the two-pod mesh's records: the
    collective term from the record's link time, the cells that fit."""
    from benchmarks_torch import common, roofline

    monkeypatch.setattr(dryrun, "ARTIFACTS", tmp_path / "dryrun_torch")
    monkeypatch.setattr(roofline, "ARTIFACTS", str(tmp_path / "dryrun_torch"))
    monkeypatch.setattr(common, "ARTIFACTS", tmp_path / "bench_torch")
    spec = get_arch("gemma3-1b")
    shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=64,
                                global_batch=32)
    rec = dryrun.run_cell("gemma3-1b", "decode_32k", "multi",
                          config=spec.reduced, shape=shape)
    assert rec["status"] == "ok", rec.get("traceback")
    out = roofline.main(["--mesh", "multi"])
    row = out["gemma3-1b×decode_32k"]
    assert row["t_collective"] == rec["t_collective_s"] > 0
    assert row["chips"] == 512 and row["fits"]
    assert row["collective_bytes"] == rec["collective_bytes"]
    assert (tmp_path / "bench_torch" / "roofline_multi.json").exists()


CENSUS_AXES = dict(data=2, model=2)
#: the reduced archs the census runs: (seq_len, global batch) of the train
#: and decode cells; xlstm's 2 heads run head parallel over "model"
CENSUS = {"gemma3-27b": dict(train=(16, 4), decode=(24, 4)),
          "xlstm-125m": dict(train=(16, 4), decode=(24, 4))}
CENSUS_CELLS = [(a, k) for a in CENSUS for k in ("train", "decode")]


@pytest.fixture(scope="module")
def census_ranks(tmp_path_factory):
    """Four gloo ranks' collectives in one sharded step and one decode
    step of each reduced config of ``CENSUS``
    (``tests/tp_serving_ranks.census_cases``), in one spawn."""
    from tests import tp_serving_ranks as rk

    cases = [(a, CENSUS_AXES, c["train"], c["decode"])
             for a, c in CENSUS.items()]
    return run_ranks(rk.census_cases, 4, args=(cases,), device="cpu",
                     transport="gloo", timeout=150.0,
                     workdir=str(tmp_path_factory.mktemp("census-ranks")))


def _trace_census(arch, kind):
    """The dry run's trace of rank 0 on a ``TraceMesh`` of CENSUS_AXES:
    its census and its all-gathers' blocks (``gather_log``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from tests import tp_serving_ranks as rk

    cfg = rk.reduced(arch)
    S, B = CENSUS[arch][kind]
    mesh = TraceMesh(CENSUS_AXES)
    gathers = rk.gather_log(mesh)
    with FakeTensorMode(), dryrun.card_attention():
        fn, args = dryrun.build_mesh_cell(cfg, Shape("census", S, B, kind),
                                          mesh)
        dryrun.measure(fn, *args)
    return mesh.census(), gathers


_traced = functools.lru_cache(maxsize=None)(_trace_census)


@pytest.mark.parametrize("arch,kind", CENSUS_CELLS)
def test_trace_mesh_census_equals_the_ranks(census_ranks, arch, kind):
    """The dry run's trace of rank 0 on a ``TraceMesh`` of (data 2, model
    2) counts the collectives — by kind, count and bytes — that four
    gloo ranks issue for the same call on their blocks; every rank
    issues the same ones."""
    want, _ = _traced(arch, kind)
    assert want["all-gather"]["count"] > 0, want
    for o in census_ranks:
        assert o[arch][kind] == want, (arch, kind, o["rank"])
    if kind == "train":
        assert want["all-to-all"]["count"] > 0     # FSDP's reduce-scatter
    got = {k: v["bytes"] for k, v in want.items()}
    assert got["all-reduce"] == 0 and np.isfinite(sum(got.values()))


def _ssm_gather_blocks(kind):
    """The blocks ((shape, dtype) as they go out, ``gather_log``) a rank
    of CENSUS_AXES would all-gather over "model" to compute the reduced
    xlstm's cells with every head: in the train step each cell leaf's
    "model" dim, gathered as ``sharding.gathered`` gathers (its dims in
    order, "data" over FSDP); in decode each recurrent-state leaf's head
    block (dim 1)."""
    from repro_torch.distributed.mesh import ShardMesh
    from repro_torch.distributed import sharding
    from tests import tp_serving_ranks as rk

    cfg = rk.reduced("xlstm-125m")
    mesh = ShardMesh(device="cpu", axes=CENSUS_AXES)
    out = set()

    def moved(shape, dim, dtype):
        rest = shape[:dim] + shape[dim + 1:]
        return (1, shape[dim]) + tuple(rest), dtype

    if kind == "train":
        specs = transformer.model_specs(cfg)
        place = sharding.train_placements(specs, mesh, cfg)
        for layer, lp in zip(specs["layers"], place["layers"]):
            for name, s in layer["cell"].items():
                cur = [sl.stop - sl.start for sl in sharding.block_slices(
                    s.shape, lp["cell"][name], mesh, shard=0)]
                for dim, a in enumerate(lp["cell"][name]):
                    if a == "model":
                        out.add(moved(cur, dim, "torch.float32"))
                    if a is not None:
                        cur[dim] = s.shape[dim]
        return out
    cache = transformer.init_cache(cfg, CENSUS["xlstm-125m"]["decode"][1],
                                   CENSUS["xlstm-125m"]["decode"][0],
                                   torch.bfloat16, "meta",
                                   mesh=TraceMesh(CENSUS_AXES))
    for layer in cache:
        for t in layer["state"].values():
            out.add(moved(list(t.shape), 1, str(t.dtype)))
    return out


def _sent_over_model(gathers):
    return {(tuple(shape), dtype) for axes, shape, dtype in gathers
            if tuple(axes) == ("model",)}


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_head_parallel_cells_gather_no_leaf_or_state(census_ranks, kind,
                                                     monkeypatch):
    """The reduced xlstm over (data 2, model 2), its 2 heads one a rank:
    the train step gathers no cell leaf over "model" and decode gathers
    no recurrent-state leaf, on the ranks and in the dry run's trace —
    every "model" all-gather is a sum's or the logits'.  The blocks
    looked for are the ones such a gather sends: the same train trace
    with the cells' plan forced to "gather" sends each cell leaf's, and
    ``autodiff.leave`` of each state leaf over "model" sends its."""
    from repro_torch.distributed import autodiff, sharding
    from tests import tp_serving_ranks as rk

    ssm = _ssm_gather_blocks(kind)
    assert ssm
    _, traced = _traced("xlstm-125m", kind)
    for gathers in [traced] + [o["xlstm-125m"][f"{kind}_gathers"]
                               for o in census_ranks]:
        over_model = _sent_over_model(gathers)
        assert over_model and not over_model & ssm, (kind, over_model & ssm)
    for o in census_ranks:
        assert {p["cell"] for k, p in o["xlstm-125m"]["plan"].items()
                if k != "embed"} == {"tp"}
    if kind == "train":
        tp_plan = sharding.tp_plan

        def gathered_cells(cfg, mesh):
            plan = tp_plan(cfg, mesh)
            for p in plan.values():
                if "cell" in p:
                    p["cell"] = "gather"
            return plan

        monkeypatch.setattr(sharding, "tp_plan", gathered_cells)
        _, sent = _trace_census("xlstm-125m", kind)
    else:
        mesh = TraceMesh(CENSUS_AXES)
        sent = rk.gather_log(mesh)
        S, B = CENSUS["xlstm-125m"]["decode"]
        cache = transformer.init_cache(rk.reduced("xlstm-125m"), B, S,
                                       torch.bfloat16, "meta", mesh=mesh)
        for layer in cache:
            for t in layer["state"].values():
                autodiff.leave(mesh, t, "model", 1)
    assert _sent_over_model(sent) & ssm == ssm, (
        kind, ssm - _sent_over_model(sent))
