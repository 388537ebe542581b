"""Tensor parallelism over ``"model"``, FSDP over ``"data"`` and the MoE
boundary under ``"dp"`` in the port's sharded step, on the CPU.

Four ``gloo`` ranks are spawned once (``launch.mesh.run_ranks``, one
intra-op thread a rank, a hard time limit; ``tests/tensor_parallel_ranks.py``
imports no JAX).  Each rank holds only its blocks of every parameter and
moment under the JAX rules' placement (``sharding.train_placements``) and
computes as ``sharding.tp_plan`` says.  Its results are held here to the
in-process ``ShardMesh`` of the same axes (whole trees) and to the JAX
package's unsharded step, within ``tests/test_torch_model_mesh.py``'s
tolerances (loss 1e-5 relative, grad norm 1e-4, parameters within 2.5 lr,
router counts exact; the JAX step only where nothing drops, capacity 8):

  * reduced gemma3-27b on ``(data 2, model 2)`` (the plain head split) and
    ``(model 4)`` (the head-repeat branch, asserted taken); qwen1.5-110b
    (``qkv_bias``) on both; deepseek-v3 under ``"2d"`` (MLA, the dense and
    shared MLPs, MTP) and ``"dp"`` (the boundary); hymba-1.5b (its 5
    mamba heads and a mid-head split gathered before use); xlstm-125m
    (its 2 heads a rank each: the cells head parallel); the 4-head hymba
    variant (``tp_serving_ranks.VARIANTS``) on both meshes, its mamba
    heads split, its attention the plain split and the head-repeat
    branch; smollm-135m under ``"dp"`` (FSDP);
  * for each: every rank's parameter and moment tensors have exactly their
    ``block_slices`` shapes; the forward's hidden states equal the
    in-process ones within 1e-5 of the largest magnitude; every rank's
    whole leaves and metrics are equal bit for bit;
  * the vocabulary-parallel CE equals ``_ce_terms`` with labels at each
    vocabulary block's first and last row and labels of -1;
  * deepseek-v3's MoE layer under ``"dp"`` at capacity 1.25 and 8: routing
    ids, slots and keeps exact against the in-process a2a, statistics and
    output against the JAX ``_a2a_local`` under nested named ``vmap``s
    (``tests/test_torch_model_mesh.py``'s), the gradients adding up;
  * ``tp_in``/``tp_out``, ``fsdp_gather`` (a ``"data"``-split leaf whose
    ranks see other tokens: summed) and ``leave`` (a ``"model"``-split
    leaf whose ranks see the same ones: not summed) against autograd of
    the whole, the collectives under them against the in-process mesh,
    and the global norm of leaves split over ``"data"``, ``"model"``,
    both and neither.
"""
import concurrent.futures
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import transformer as jt
from repro.models import params as j_params
from repro.train import optimizer as j_opt
from repro.train import train_step as j_ts
from repro_torch import interop
from repro_torch.distributed import sharding
from repro_torch.distributed.mesh import ShardMesh
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import moe, transformer
from repro_torch.models.params import tree_leaves
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_step as ts_mod
from tests import tensor_parallel_ranks as rk
from tests import tp_serving_ranks as srk
from tests.test_torch_model_mesh import _jax_a2a

CPU = "cpu"
TIMEOUT = 150.0          # seconds the spawn of the ranks may take, whole
REF_THREADS = 3          # threads computing the references meanwhile
W = 4
DM = dict(data=2, model=2)
M4 = dict(model=4)
GEMMA, DEEPSEEK, QWEN = "gemma3-27b", "deepseek-v3-671b", "qwen1.5-110b"
HYMBA4 = "hymba-h4"      # the 4-head hymba (tp_serving_ranks.VARIANTS)
# a case: its mesh, profile, capacity factor, and the modes its plan
# gives attention and the SSM parts (None: the arch has none)
STEPS = {
    "gemma3-dm": dict(arch=GEMMA, axes=DM, profile="2d", cf=8.0, attn="tp",
                      ssm=None),
    "gemma3-m4": dict(arch=GEMMA, axes=M4, profile="2d", cf=8.0,
                      attn="repeat", ssm=None),
    "qwen-dm": dict(arch=QWEN, axes=DM, profile="2d", cf=8.0, attn="tp",
                    ssm=None),
    "qwen-m4": dict(arch=QWEN, axes=M4, profile="2d", cf=8.0,
                    attn="repeat", ssm=None),
    "deepseek-2d": dict(arch=DEEPSEEK, axes=DM, profile="2d", cf=8.0,
                        attn="tp", ssm=None),
    "deepseek-dp": dict(arch=DEEPSEEK, axes=DM, profile="dp", cf=8.0,
                        attn="gather", ssm=None),
    "deepseek-dp-cf1.25": dict(arch=DEEPSEEK, axes=DM, profile="dp",
                               cf=1.25, attn="gather", ssm=None),
    "hymba-dm": dict(arch="hymba-1.5b", axes=DM, profile="2d", cf=8.0,
                     attn="gather", ssm="gather"),
    "xlstm-dm": dict(arch="xlstm-125m", axes=DM, profile="2d", cf=8.0,
                     attn=None, ssm="tp"),
    "hymba-h4-dm": dict(arch=HYMBA4, axes=DM, profile="2d", cf=8.0,
                        attn="tp", ssm="tp"),
    "hymba-h4-m4": dict(arch=HYMBA4, axes=M4, profile="2d", cf=8.0,
                        attn="repeat", ssm="tp"),
    "smollm-dp": dict(arch="smollm-135m", axes=DM, profile="dp", cf=8.0,
                      attn="gather", ssm=None),
}
ARCHS = sorted({c["arch"] for c in STEPS.values()})
#: the archs of the first cases, whose token draws come first from seed 0
BASE_ARCHS = [a for a in ARCHS if a not in srk.VARIANTS]
CE_MESHES = {"dm": DM, "m4": M4}
V = 512                  # the reduced configs' vocabulary
OCFG = dict(warmup_steps=1, total_steps=10)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    """The JAX tree of the reduced ``arch``'s weights, drawn with NumPy
    from seed 0 leaf by leaf (``normal`` leaves at their spec's scale)."""
    jcfg = dataclasses.replace(srk.reduced(arch, j_get_arch),
                               compute_dtype="float32")
    rng = np.random.default_rng(0)

    def draw(s):
        if s.init in ("zeros", "ones"):
            return getattr(np, s.init)(s.shape, np.float32)
        return (rng.standard_normal(s.shape) * s.scale).astype(np.float32)

    return j_params.tree_map_specs(draw, jt.model_specs(jcfg))


def _ce_labels(M):
    """(2, 8) labels: every vocabulary block's first and last row over M
    ranks, then -1."""
    edges = [v for i in range(M) for v in (i * V // M, (i + 1) * V // M - 1)]
    lab = np.full(16, -1, np.int32)
    lab[:len(edges)] = edges
    return lab.reshape(2, 8)


def _autodiff_inputs(rng):
    return dict(
        x=rng.normal(size=(3, 6)).astype(np.float32),
        h=rng.normal(size=(3, 8)).astype(np.float32),
        A=rng.normal(size=(6, 8)).astype(np.float32),
        B=rng.normal(size=(8, 5)).astype(np.float32),
        W=rng.normal(size=(6, 4)).astype(np.float32),
        t=rng.normal(size=(2, 3, 6)).astype(np.float32),
        blocks=(rng.normal(size=(W, 4, 3)) * 10.0 ** rng.integers(
            -3, 4, (W, 4, 3))).astype(np.float32),
        norm={k: rng.normal(size=(4, 6)).astype(np.float32)
              for k in ("data", "model", "both", "neither")})


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(0)
    params = {a: _jax_params(a) for a in ARCHS}
    layer = {k: np.asarray(v)[0]
             for k, v in params[DEEPSEEK]["unit"][0]["moe"].items()}
    variants = np.random.default_rng(1)
    return dict(
        steps=STEPS, params=params, layer=layer,
        x=rng.normal(size=(4, 16, 64)).astype(np.float32),
        tokens={a: (rng if a in BASE_ARCHS else variants).integers(
            1, V, (4, 16)).astype(np.int32)
            for a in BASE_ARCHS + sorted(srk.VARIANTS)},
        ce=dict(logits=(rng.normal(size=(2, 8, V)) * 3).astype(np.float32),
                labels={k: _ce_labels(m["model"])
                        for k, m in CE_MESHES.items()},
                meshes=CE_MESHES),
        autodiff=_autodiff_inputs(rng))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(inputs, every rank's results): one spawn of 4 ranks for all."""
    inputs = _inputs()
    # the references meanwhile: JAX's steps (their compiles) and the
    # in-process steps, a few at a time
    with concurrent.futures.ThreadPoolExecutor(REF_THREADS) as pool:
        refs = [pool.submit(_jax_step, a) for a in ARCHS]
        refs += [pool.submit(_in_process, n) for n in STEPS]
        out = run_ranks(rk.all_cases, W, args=(inputs,), device=CPU,
                        transport="gloo", timeout=TIMEOUT,
                        workdir=str(tmp_path_factory.mktemp("tp-ranks")))
        for f in refs:
            f.result()
    assert [r["rank"] for r in out] == list(range(W))
    assert all(o["ambient"] for o in out)
    return inputs, out


def _mesh(axes):
    return ShardMesh(device=CPU, axes=axes)


def _close(a, b, rel, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max() if a.size else 0.0
    assert err <= rel * max(np.abs(b).max(), 1e-6), f"{what}: {err}"


def _rows(case, r, B):
    """The rows of a (B, ...) batch rank r holds under the case's
    profile."""
    cfg = rk.step_cfg(case["arch"], case["profile"], case["cf"])
    place = sharding.data_placements(dict(t=(B, 1)), case["axes"],
                                     cfg.sharding_profile)["t"]
    return sharding.block_slices((B, 1), place, _mesh(case["axes"]),
                                 shard=r)[0]


@functools.lru_cache(maxsize=None)
def _in_process(name):
    """The in-process mesh's forward (hidden states) and step on the
    whole trees."""
    case = STEPS[name]
    inputs = _inputs()
    cfg = rk.step_cfg(case["arch"], case["profile"], case["cf"])
    mesh = _mesh(case["axes"])
    params = interop.params_from_numpy(inputs["params"][case["arch"]], cfg,
                                       device=CPU)
    batch = rk.batch_of(inputs["tokens"][case["arch"]])
    with torch.no_grad(), sharding.use_mesh(mesh):
        h, _ = transformer.forward(params, cfg, batch)
    step = ts_mod.make_train_step(cfg, opt_mod.OptConfig(**OCFG),
                                  collect_router_stats=cfg.moe is not None,
                                  mesh=mesh)
    new, _, m = step(params, opt_mod.init(params, device=CPU), batch)
    return (h.numpy(), [t.numpy() for t in tree_leaves(new)],
            {k: v.numpy() for k, v in m.items()})


@functools.lru_cache(maxsize=None)
def _jax_step(arch):
    """The JAX package's unsharded step (one device: the dense MoE)."""
    jcfg = dataclasses.replace(srk.reduced(arch, j_get_arch),
                               compute_dtype="float32")
    inputs = _inputs()
    p = jax.tree.map(jnp.asarray, inputs["params"][arch])
    b = {k: jnp.asarray(v.numpy())
         for k, v in rk.batch_of(inputs["tokens"][arch]).items()}
    step = j_ts.make_train_step(jcfg, j_opt.OptConfig(**OCFG),
                                collect_router_stats=jcfg.moe is not None)
    new, _, m = jax.jit(step)(p, j_opt.init(p), b)
    flat = tree_leaves(interop.params_from_numpy(
        jax.tree.map(np.asarray, new), rk.step_cfg(arch), device=CPU))
    return [t.numpy() for t in flat], {k: np.asarray(v) for k, v in m.items()}


def _held(got_p, got_m, want_p, want_m, what):
    assert float(got_m["loss"]) == pytest.approx(float(want_m["loss"]),
                                                 rel=1e-5), what
    assert float(got_m["grad_norm"]) == pytest.approx(
        float(want_m["grad_norm"]), rel=1e-4), what
    if "router_counts" in want_m:
        np.testing.assert_array_equal(got_m["router_counts"],
                                      want_m["router_counts"], err_msg=what)
    lr = float(want_m["lr"])
    assert len(got_p) == len(want_p), what
    for i, (a, b) in enumerate(zip(got_p, want_p)):
        assert a.shape == b.shape, (what, i)
        assert float(np.abs(a - b).max()) <= 2.5 * lr, (what, i)


# ------------------------------------------------------------ the steps --


@pytest.mark.parametrize("name", list(STEPS))
def test_ranks_hold_exactly_their_blocks(ranks, name):
    """Every rank's parameters, updated parameters and both moments have
    the shapes of its blocks under the JAX rules, and a leaf the rules
    split is held whole by no rank; ``params_from_numpy(mesh=)`` and
    ``params.init_blocks`` give the blocks ``local_tree`` cuts from the
    whole tree (the same bits)."""
    inputs, out = ranks
    case = STEPS[name]
    cfg = rk.step_cfg(case["arch"], case["profile"], case["cf"])
    specs = transformer.model_specs(cfg)
    place = sharding.train_placements(specs, case["axes"], cfg)
    mesh = _mesh(case["axes"])
    specs, place = rk.paths(specs), rk.paths(place)
    n_split = 0
    for r, o in enumerate(out):
        want = {k: tuple(b.stop - b.start for b in sharding.block_slices(
            s.shape, place[k], mesh, shard=r)) for k, s in specs.items()}
        for k, got in o["steps"][name]["shapes"].items():
            assert got == want, (name, r, k)
        assert o["steps"][name]["interop_is_local_tree"], (name, r)
        assert o["steps"][name]["init_blocks_is_local_tree"], (name, r)
        split = [k for k, p in place.items() if p.axes()]
        assert all(want[k] != specs[k].shape for k in split), name
        n_split += len(split)
    assert n_split > 0, name


@pytest.mark.parametrize("name", list(STEPS))
def test_layer_plan_is_the_cases(ranks, name):
    """The plan each rank ran: the case's attention mode (the head-repeat
    branch where asserted) and SSM mode (head parallel where the heads
    divide over "model"), MLPs and vocabulary tensor parallel under "2d"
    where their widths split, everything gathered under "dp"."""
    _, out = ranks
    case = STEPS[name]
    for o in out:
        plan = o["steps"][name]["plan"]
        assert plan == out[0]["steps"][name]["plan"]
        attn = {p.get("attn") for k, p in plan.items() if k != "embed"}
        assert attn == {case["attn"]}, (name, plan)
        ssm = {p[part] for p in plan.values() for part in ("mamba", "cell")
               if part in p}
        assert ssm == ({case["ssm"]} if case["ssm"] else set()), (name,
                                                                  plan)
        modes = {m for p in plan.values() for m in p.values()}
        if case["profile"] == "dp":
            assert modes == {"gather"}, (name, plan)
        else:
            assert plan["embed"]["vocab"] == "tp", (name, plan)
            assert all(p.get("mlp", "tp") == "tp"
                       and p.get("shared", "tp") == "tp"
                       for p in plan.values()), (name, plan)


@pytest.mark.parametrize("name", list(STEPS))
def test_forward_hidden_states_equal_the_in_process_mesh(ranks, name):
    _, out = ranks
    case = STEPS[name]
    want, _, _ = _in_process(name)
    for r, o in enumerate(out):
        _close(o["steps"][name]["hidden"],
               want[_rows(case, r, want.shape[0])], 1e-5, (name, r))


@pytest.mark.parametrize("name", list(STEPS))
def test_train_step_over_ranks_equals_the_in_process_mesh(ranks, name):
    _, out = ranks
    _, want_p, want_m = _in_process(name)
    for r, o in enumerate(out):
        s = o["steps"][name]
        _held(s["whole"], s["metrics"], want_p, want_m, (name, r))


@pytest.mark.parametrize("name", [n for n, c in STEPS.items()
                                  if c["cf"] == 8.0])
def test_train_step_over_ranks_equals_jax(ranks, name):
    """Where nothing drops: the ranks' step against the JAX package's
    unsharded step."""
    _, out = ranks
    want_p, want_m = _jax_step(STEPS[name]["arch"])
    for r, o in enumerate(out):
        s = o["steps"][name]
        _held(s["whole"], s["metrics"], want_p, want_m, (name, "jax", r))


@pytest.mark.parametrize("name", list(STEPS))
def test_replicated_leaves_and_metrics_equal_on_every_rank(ranks, name):
    """Every whole leaf and every metric is equal bit for bit on every
    rank; ranks holding one block of a split leaf hold equal bits too."""
    _, out = ranks
    case = STEPS[name]
    mesh = _mesh(case["axes"])
    first = out[0]["steps"][name]
    places = [sharding.Placement(p) for p in first["places"]]
    for r, o in enumerate(out[1:], 1):
        s = o["steps"][name]
        for k, v in first["metrics"].items():
            np.testing.assert_array_equal(s["metrics"][k], v,
                                          err_msg=(name, r, k))
        for i, p in enumerate(places):
            same = all(mesh.coords(r)[a] == 0 for a in p.axes())
            if same:
                np.testing.assert_array_equal(s["local"][i],
                                              first["local"][i],
                                              err_msg=(name, r, i))


# -------------------------------------------------- vocabulary and MoE --


@pytest.mark.parametrize("name", list(CE_MESHES))
def test_vocab_parallel_ce_equals_ce_terms(ranks, name):
    """Labels at every vocabulary block's first and last row and labels
    of -1: each rank's terms equal ``_ce_terms`` of the whole logits,
    and its gradient is its block of the whole's."""
    inputs, out = ranks
    logits = torch.tensor(inputs["ce"]["logits"]).requires_grad_()
    labels = torch.tensor(inputs["ce"]["labels"][name])
    nll, zl, valid = transformer._ce_terms(logits, labels, torch.float32)
    g, = torch.autograd.grad(nll.sum() + zl.sum(), [logits])
    M = CE_MESHES[name]["model"]
    mesh = _mesh(CE_MESHES[name])
    assert (labels < 0).any()
    for r, o in enumerate(out):
        got = o["ce"][name]
        _close(got["nll"], nll.detach().numpy(), 1e-6, (name, r, "nll"))
        _close(got["z"], zl.detach().numpy(), 1e-6, (name, r, "z"))
        np.testing.assert_array_equal(got["valid"], valid.numpy())
        i = mesh.group_rank("model", r)
        _close(got["grad"], g[..., i * V // M:(i + 1) * V // M].numpy(),
               1e-5, (name, r, "grad"))


def _dp_in_process(cf, grads=False):
    cfg = rk.step_cfg(DEEPSEEK, "dp", cf)
    inputs = _inputs()
    params = {k: torch.tensor(v).requires_grad_(grads)
              for k, v in inputs["layer"].items()}
    x = torch.tensor(inputs["x"]).requires_grad_(grads)
    y, aux, st, routing = moe.a2a_with_routing(params, cfg, x,
                                               mesh=_mesh(DM))
    out = dict(y=y, aux=aux, st=st, routing=routing)
    if grads:
        g = torch.autograd.grad((y ** 2).sum() + aux, [x] + list(
            params.values()))
        out["grads"] = dict(zip(["x"] + list(params), g))
    return out


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_dp_boundary_equals_in_process_and_jax(ranks, cf):
    """Under "dp" each rank holds its own rows over "model" too; the
    exchange over "model" makes JAX's token shards: routing ids, slots
    and keeps exact against the in-process a2a of the same axes,
    statistics exact and output within 1e-5 against the JAX
    ``_a2a_local``; pairs drop at 1.25 and not at 8."""
    inputs, out = ranks
    want = _dp_in_process(cf)
    y, aux, counts, coact = _jax_a2a(
        dict(axes=DM, cf=cf, ep_axes=("model",)), inputs["layer"],
        inputs["x"])
    _close(want["y"].detach().numpy(), y, 1e-5, cf)
    np.testing.assert_array_equal(want["st"].counts.numpy(), counts)
    np.testing.assert_array_equal(want["st"].coact.numpy(), coact)
    ymax = float(want["y"].abs().max())
    case = dict(arch=DEEPSEEK, axes=DM, profile="dp", cf=cf)
    for r, o in enumerate(out):
        got = o["dp_a2a"][str(cf)]
        for k in ("ids", "slot", "keep"):
            np.testing.assert_array_equal(
                got[k], getattr(want["routing"], k)[r:r + 1].numpy(),
                err_msg=(cf, r, k))
        np.testing.assert_array_equal(got["counts"], counts)
        np.testing.assert_array_equal(got["coact"], coact)
        yw = want["y"][_rows(case, r, 4)].detach().numpy()
        assert np.abs(got["y"] - yw).max() <= 1e-6 * ymax, (cf, r)
        assert float(got["aux"]) == pytest.approx(aux, rel=1e-6)
    dropped = int((~want["routing"].keep).sum())
    assert (dropped > 0) == (cf < 8), dropped


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_dp_boundary_gradients_add_up_to_the_in_process_ones(ranks, cf):
    """Each rank's gradients of ``(y**2).sum() + aux`` on its blocks
    (experts over "model" with their FSDP reduce-scatter over "data", the
    shared expert FSDP over "data", the router whole), added over the
    ranks into the whole leaves, equal the in-process gradients; the
    input's are each rank's rows."""
    _, out = ranks
    want = _dp_in_process(cf, grads=True)
    mesh = _mesh(DM)
    cfg = rk.step_cfg(DEEPSEEK, "dp", cf)
    place = sharding.param_placements(moe.moe_specs(cfg), DM, "dp")
    case = dict(arch=DEEPSEEK, axes=DM, profile="dp", cf=cf)
    for k, gw in want["grads"].items():
        gw = gw.numpy()
        if k == "x":
            for r, o in enumerate(out):
                _close(o["dp_a2a"][str(cf)]["grads"]["x"],
                       gw[_rows(case, r, 4)], 1e-5, (cf, k, r))
            continue
        total = np.zeros_like(gw, dtype=np.float64)
        for r, o in enumerate(out):
            total[sharding.block_slices(gw.shape, place[k], mesh,
                                        shard=r)] += o["dp_a2a"][str(cf)][
                "grads"][k]
        _close(total, gw, 1e-5, (cf, k))


# ------------------------------------------------------------- autodiff --


def test_tp_in_and_out_equal_autograd_of_the_whole(ranks):
    """A column-parallel product (``tp_in``) then a row-parallel one
    (``tp_out``) over "model": the output and the input's gradient equal
    the whole's on every rank, each weight's gradient its block."""
    inputs, out = ranks
    a = inputs["autodiff"]
    x, A, B = (torch.tensor(a[k]).requires_grad_() for k in ("x", "A", "B"))
    y = torch.relu(x @ A) @ B
    gx, gA, gB = torch.autograd.grad((y * y).sum(), [x, A, B])
    mesh = _mesh(DM)
    n = A.shape[1] // 2
    for r, o in enumerate(out):
        t = o["autodiff"]["tp"]
        m = mesh.coords(r)["model"]
        _close(t["y"], y.detach().numpy(), 1e-6, ("y", r))
        _close(t["x"], gx.numpy(), 1e-5, ("x", r))
        _close(t["a"], gA[:, m * n:(m + 1) * n].numpy(), 1e-5, ("a", r))
        _close(t["b"], gB[m * n:(m + 1) * n].numpy(), 1e-5, ("b", r))


def test_row_parallel_in_bf16_rounds_the_sum_once(ranks):
    """``row_parallel`` of bf16 blocks: each rank's partial product in
    f32, the partials added in f32 and rounded once — the whole f32
    product rounded to bf16, within one bf16 spacing; its gradients the
    bf16 products of the whole's."""
    inputs, out = ranks
    a = inputs["autodiff"]
    h = torch.tensor(a["h"]).to(torch.bfloat16).requires_grad_()
    b = torch.tensor(a["B"]).to(torch.bfloat16).requires_grad_()
    y = (h.float() @ b.float()).to(torch.bfloat16)
    gh, gb = torch.autograd.grad((y.float() ** 2).sum(), [h, b])
    y = y.detach()
    mesh = _mesh(DM)
    n = b.shape[0] // 2
    spacing = 2.0 ** (np.floor(np.log2(np.abs(y.float().numpy()))) - 7)
    for r, o in enumerate(out):
        t = o["autodiff"]["row16"]
        m = mesh.coords(r)["model"]
        assert (np.abs(t["y"] - y.float().numpy()) <= spacing).all(), r
        _close(t["h"], gh.float()[:, m * n:(m + 1) * n].numpy(), 2e-2,
               ("h", r))
        _close(t["b"], gb.float()[m * n:(m + 1) * n].numpy(), 2e-2,
               ("b", r))


def test_fsdp_gather_sums_over_data_and_leave_does_not(ranks):
    """A leaf split over "data", gathered: the "data" ranks see other
    tokens, so its block's gradient is the block of the sum of their
    gradients (the reduce-scatter); split over "model" and gathered by
    ``leave``, the ranks see the same tokens: the block of this rank's
    gradient, not summed."""
    inputs, out = ranks
    a = inputs["autodiff"]
    Wt = torch.tensor(a["W"])
    t = torch.tensor(a["t"])
    per = []
    for d in range(2):
        w = Wt.clone().requires_grad_()
        per.append(torch.autograd.grad(((t[d] @ w) ** 2).sum(), [w])[0])
    mesh = _mesh(DM)
    k = Wt.shape[1] // 2
    for r, o in enumerate(out):
        c = mesh.coords(r)
        f, lv = o["autodiff"]["fsdp"], o["autodiff"]["leave"]
        np.testing.assert_array_equal(f["whole"], a["W"])
        np.testing.assert_array_equal(lv["whole"], a["W"])
        cols = slice(c["data"] * k, (c["data"] + 1) * k)
        _close(f["grad"], (per[0] + per[1])[:, cols].numpy(), 1e-6,
               ("fsdp", r))
        cols = slice(c["model"] * k, (c["model"] + 1) * k)
        _close(lv["grad"], per[c["data"]][:, cols].numpy(), 1e-6,
               ("leave", r))
        # partial use of a leaf whole over "model": summed over it
        np.testing.assert_array_equal(o["autodiff"]["partial_whole"],
                                      np.full(a["W"].shape, 3.0, np.float32))


def test_pmax_and_reduce_scatter_equal_the_in_process_mesh(ranks):
    inputs, out = ranks
    x = torch.tensor(inputs["autodiff"]["blocks"])
    mesh = _mesh(DM)
    for name, axes in (("data", "data"), ("model", "model"), ("all", None)):
        G = mesh.size(axes)
        want = dict(pmax=mesh.pmax(x, axes),
                    reduce_scatter=mesh.reduce_scatter(x, axes))
        for r, o in enumerate(out):
            got = o["autodiff"]["collectives"][name]
            w = want["pmax"] if G == W else want["pmax"][r:r + 1]
            np.testing.assert_array_equal(got["pmax"], w.numpy())
            np.testing.assert_array_equal(got["reduce_scatter"],
                                          want["reduce_scatter"][
                                              r:r + 1].numpy())
            # against plain maxima and sums of the group's rows
            grp = [s for s in range(W) if mesh.size(axes) == W or all(
                mesh.coords(s)[a] == mesh.coords(r)[a]
                for a in mesh.axis_names if a != axes)]
            j = grp.index(r)
            m = x.shape[1] // G
            np.testing.assert_array_equal(
                got["pmax"].reshape(x.shape[1:]),
                x[grp].amax(0).numpy())
            np.testing.assert_allclose(
                got["reduce_scatter"][0],
                x[grp].sum(0)[j * m:(j + 1) * m].numpy(), rtol=1e-6)


def test_global_norm_over_split_leaves_equals_the_whole(ranks):
    """``optimizer.global_norm`` of blocks split over "data", "model",
    both and neither, over the ranks: the whole trees' norm, and the same
    bits on every rank."""
    inputs, out = ranks
    leaves = {k: torch.tensor(v)
              for k, v in inputs["autodiff"]["norm"].items()}
    want = float(opt_mod.global_norm(leaves))
    for o in out:
        assert float(o["autodiff"]["norm"]) == pytest.approx(want, rel=1e-6)
        np.testing.assert_array_equal(o["autodiff"]["norm"],
                                      out[0]["autodiff"]["norm"])
