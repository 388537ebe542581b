"""The model side of the port's mesh on the CPU: a ``(data × model)`` mesh
in one process (``ShardMesh``) and over ranks (``ProcessMesh``), the
expert-parallel a2a by ``cfg.ep_axes`` and the sharded train step, held
to the JAX package (``tests/test_distributed_small_mesh.py``'s cases).

Four ``gloo`` ranks are spawned once (``launch.mesh.run_ranks``, one
intra-op thread a rank, a hard time limit; ``tests/model_mesh_ranks.py``
imports no JAX).  Every rank runs every case on meshes ``(data 2, model
2)`` and ``(model 4)``; its results are held here to the same calls over
the in-process ``ShardMesh`` of the same axes:

  * the collectives over each set of axes, bit for bit;
  * the a2a at capacity 1.25 and 8, over ``ep_axes`` ``("model",)`` and
    ``("data", "model")``: routing ids, slots, keeps and router
    statistics exact; the output and aux within 1e-6 of the largest
    magnitude (a rank's products run over its one shard where the
    in-process mesh batches every shard's: the same sums, in a grouping
    the BLAS may order otherwise); the gradients, added over the ranks
    that hold a leaf alike, within 1e-5 of the largest magnitude;
  * the in-process a2a against the JAX package's ``_a2a_local`` under two
    nested named ``jax.vmap``s (the mesh's axes), as
    ``tests/test_torch_moe_a2a.py`` does for one: statistics exact, the
    output within 1e-5 of its largest magnitude, aux within 1e-6;
  * one train step of the reduced deepseek-v3 (f32, MLA, MTP, the a2a)
    and of the reduced smollm-135m (``"2d"`` and ``"dp"``) against the
    in-process step of the same axes, the single-process port step and
    the JAX unsharded step, within ``test_train_step_over_a_mesh_equals_
    one_device``'s tolerances: loss 1e-5 relative, grad norm 1e-4,
    parameters within 2.5 lr, router counts exact (the one-device steps
    at capacity 8, where nothing drops);
  * every rank's metrics and whole (replicated) leaves equal bit for bit;
  * in process, the ``"dp"`` profile computes what one device (or, with
    experts, the ``"2d"`` profile) computes.

The step's placements are the JAX rules' (``sharding.train_placements``):
the dense layers' tensor parallelism and FSDP and the MoE boundary under
``"dp"`` are held to these references in
``tests/test_torch_tensor_parallel.py``.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import moe as j_moe
from repro.models import transformer as jt
from repro.models.params import init_params as j_init
from repro.train import optimizer as j_opt
from repro.train import train_step as j_ts
from repro_torch import interop
from repro_torch.distributed import sharding
from repro_torch.distributed.mesh import ShardMesh
from repro_torch.launch.mesh import make_host_mesh, run_ranks
from repro_torch.models import moe
from repro_torch.models.params import tree_leaves
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import train_step as ts_mod
from tests import model_mesh_ranks as rk

CPU = "cpu"
TIMEOUT = 120.0          # seconds the spawn of the ranks may take, whole
W = 4
DM = dict(data=2, model=2)
M4 = dict(model=4)
A2A = {
    "dm-cf1.25": dict(axes=DM, cf=1.25, ep_axes=("model",), blocks=False),
    "dm-cf8": dict(axes=DM, cf=8.0, ep_axes=("model",), blocks=True),
    "m4-cf1.25": dict(axes=M4, cf=1.25, ep_axes=("model",), blocks=True),
    "m4-cf8": dict(axes=M4, cf=8.0, ep_axes=("model",), blocks=False),
    "dm-ep-wide": dict(axes=DM, cf=1.25, ep_axes=("data", "model"),
                       blocks=True),
}
STEPS = {
    "deepseek-cf1.25": dict(arch="deepseek-v3-671b", axes=DM, cf=1.25),
    "deepseek-cf8": dict(arch="deepseek-v3-671b", axes=DM, cf=8.0),
    "smollm-2d": dict(arch="smollm-135m", axes=DM, profile="2d"),
    "smollm-dp": dict(arch="smollm-135m", axes=DM, profile="dp"),
}
ARCHS = ("deepseek-v3-671b", "smollm-135m")
OCFG = dict(warmup_steps=1, total_steps=10)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    jcfg = dataclasses.replace(j_get_arch(arch).reduced,
                               compute_dtype="float32")
    return jax.tree.map(np.asarray, j_init(jt.model_specs(jcfg), 0))


def _layer(jp):
    """The first MoE layer's weights (group 0 of the unit)."""
    return {k: np.asarray(v)[0] for k, v in jp["unit"][0]["moe"].items()}


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(0)
    params = {a: _jax_params(a) for a in ARCHS}
    return dict(
        a2a=A2A, steps=STEPS, params=params,
        layer=_layer(params["deepseek-v3-671b"]),
        x=rng.normal(size=(4, 16, 64)).astype(np.float32),
        tokens={a: rng.integers(1, 512, (4, 16)).astype(np.int32)
                for a in ARCHS},
        blocks=(rng.normal(size=(W, 4, 3)) * 10.0 ** rng.integers(
            -3, 4, (W, 4, 3))).astype(np.float32))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(inputs, every rank's results): one spawn of 4 ranks for all."""
    inputs = _inputs()
    out = run_ranks(rk.all_cases, W, args=(inputs,), device=CPU,
                    transport="gloo", timeout=TIMEOUT,
                    workdir=str(tmp_path_factory.mktemp("model-ranks")))
    assert [r["rank"] for r in out] == list(range(W))
    return inputs, out


def _mesh(axes):
    return ShardMesh(device=CPU, axes=axes)


def _close(a, b, rel, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max() if a.size else 0.0
    assert err <= rel * max(np.abs(b).max(), 1e-6), f"{what}: {err}"


def _rows(mesh, r, n):
    """The rows of an (n, ...) batch that shard r holds (its data block)."""
    nb = mesh.size(("pod", "data"))
    i = mesh.group_rank(("pod", "data"), r)
    return slice(i * n // nb, (i + 1) * n // nb)


# ---------------------------------------------------------------- meshes --


def test_host_and_production_meshes_have_the_jax_axes():
    m = make_host_mesh(2, 2, device=CPU)
    assert m.axes == DM and m.num_shards == 4
    assert m.coords(3) == dict(data=1, model=1)
    assert [m.group_rank("model", s) for s in range(4)] == [0, 1, 0, 1]
    assert ShardMesh(4, CPU).axes == dict(model=4)
    from repro_torch.launch.mesh import make_production_mesh
    assert make_production_mesh(device=CPU).axes == dict(data=16, model=16)
    assert make_production_mesh(multi_pod=True, device=CPU).axes == dict(
        pod=2, data=16, model=16)
    with pytest.raises(ValueError, match="order"):
        m.group_axes(("model", "data"))
    with pytest.raises(ValueError, match="shards"):
        ShardMesh(3, CPU, axes=DM)


def test_collectives_over_axes_equal_the_in_process_mesh(ranks):
    inputs, out = ranks
    mesh = _mesh(DM)
    x = torch.tensor(inputs["blocks"])
    for name, axes in rk.COLLECTIVE_AXES.items():
        G = mesh.size(axes)
        want = dict(psum=mesh.psum(x, axes), all_gather=mesh.all_gather(
            x, axes), all_to_all=mesh.all_to_all(x[:, :G], axes))
        for r, o in enumerate(out):
            got = o["collectives"][name]
            for k, w in want.items():
                w = w.numpy()
                if mesh.size(axes) < W:       # a group's: this shard's row
                    w = w[r:r + 1]
                elif k == "all_to_all":
                    w = w[r:r + 1]
                np.testing.assert_array_equal(got[k], w, err_msg=(name, k))
    # against plain sums, gathers and exchanges of the shards' rows
    for r in range(W):
        grp = [s for s in range(W)
               if mesh.coords(s)["data"] == mesh.coords(r)["data"]]
        np.testing.assert_array_equal(
            mesh.psum(x, "model")[r].numpy(), (x[grp[0]] + x[grp[1]]).numpy())
        np.testing.assert_array_equal(
            mesh.all_to_all(x[:, :2], "model")[r].numpy(),
            torch.stack([x[s, mesh.group_rank("model", r)]
                         for s in grp]).numpy())


# ------------------------------------------------------------------- a2a --


def _cfgs(case):
    out = []
    for get in (j_get_arch, None):
        if get is None:
            out.append(rk.moe_cfg(case["cf"], tuple(case["ep_axes"])))
            continue
        c = dataclasses.replace(get("deepseek-v3-671b").reduced,
                                compute_dtype="float32",
                                ep_axes=tuple(case["ep_axes"]))
        out.append(dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=case["cf"], impl="a2a")))
    return out


def _in_process(case, layer, x, grads=False):
    """The in-process a2a of the case's axes on the whole batch: outputs,
    routing, and with ``grads`` the gradients of ``(y**2).sum() + aux``."""
    _, tcfg = _cfgs(case)
    params = {k: torch.tensor(v).requires_grad_(grads)
              for k, v in layer.items()}
    xx = torch.tensor(x).requires_grad_(grads)
    y, aux, st, routing = moe.a2a_with_routing(params, tcfg, xx,
                                               mesh=_mesh(case["axes"]))
    out = dict(y=y, aux=aux, st=st, routing=routing)
    if grads:
        g = torch.autograd.grad((y ** 2).sum() + aux,
                                [xx] + list(params.values()))
        out["grads"] = dict(zip(["x"] + list(params), g))
    return out


def _jax_a2a(case, layer, x):
    """The JAX EP body under nested named vmaps over the case's axes:
    shard (d, m) holds row block d and sequence block m, and the EP block
    its place in ``ep_axes``."""
    jcfg, _ = _cfgs(case)
    axes, ep_axes = case["axes"], tuple(case["ep_axes"])
    mesh = _mesh(axes)
    nb, M = axes.get("data", 1), axes["model"]
    B, S, Dm = x.shape
    E = jcfg.moe.num_experts
    ep = mesh.size(ep_axes)
    xl = x.reshape(nb, B // nb, M, S // M, Dm).transpose(0, 2, 1, 3, 4)
    idx = np.array([mesh.group_rank(ep_axes, s)
                    for s in range(mesh.num_shards)]).reshape(nb, M)

    def blocks(w):
        return jnp.asarray(w.reshape(ep, E // ep, *w.shape[1:])[idx])

    names = tuple(axes)
    body = lambda xr, wi, wg, wo: j_moe._a2a_local(   # noqa: E731
        xr, jnp.asarray(layer["router"]), wi, wg, wo, cfg=jcfg, ep=ep,
        ep_axis=ep_axes if len(ep_axes) > 1 else ep_axes[0],
        tok_axes=names, collect_stats=True)
    args = [jnp.asarray(xl)] + [blocks(layer[k]) for k in ("wi", "wg", "wo")]
    if names == ("model",):
        y, aux, st = jax.jit(jax.vmap(body, axis_name="model"))(
            *[a[0] for a in args])
        y, aux, st = y[None], aux[None], jax.tree.map(lambda t: t[None], st)
    else:
        y, aux, st = jax.jit(jax.vmap(jax.vmap(body, axis_name="model"),
                                      axis_name="data"))(*args)
    y = np.asarray(y).transpose(0, 2, 1, 3, 4).reshape(B, S, Dm)
    y = y + np.asarray(j_moe._shared(layer, jcfg, jnp.asarray(x),
                                     jnp.float32))
    return y, float(np.asarray(aux)[0, 0]), np.asarray(st.counts)[0, 0], \
        np.asarray(st.coact)[0, 0]


@pytest.mark.parametrize("name", list(A2A))
def test_a2a_over_ranks_equals_the_in_process_mesh(ranks, name):
    inputs, out = ranks
    case = A2A[name]
    want = _in_process(case, inputs["layer"], inputs["x"])
    mesh = _mesh(case["axes"])
    ymax = float(want["y"].abs().max())
    for r, o in enumerate(out):
        got = o["a2a"][name]
        for k in ("ids", "slot", "keep"):
            np.testing.assert_array_equal(
                got[k], getattr(want["routing"], k)[r:r + 1].numpy(),
                err_msg=f"{name} rank {r}: {k}")
        np.testing.assert_array_equal(got["counts"],
                                      want["st"].counts.numpy())
        np.testing.assert_array_equal(got["coact"], want["st"].coact.numpy())
        yw = want["y"][_rows(mesh, r, want["y"].shape[0])].detach().numpy()
        assert np.abs(got["y"] - yw).max() <= 1e-6 * ymax, (name, r)
        assert float(got["aux"]) == pytest.approx(float(want["aux"]),
                                                  rel=1e-6)
    # the capacity drops pairs at 1.25 and none at 8
    dropped = (~want["routing"].keep).sum()
    assert (dropped > 0) == (case["cf"] < 8), (name, int(dropped))


@pytest.mark.parametrize("name", list(A2A))
def test_in_process_a2a_equals_jax(name):
    case = A2A[name]
    layer = _layer(_jax_params("deepseek-v3-671b"))
    x = _inputs()["x"]
    want = _in_process(case, layer, x)
    y, aux, counts, coact = _jax_a2a(case, layer, x)
    _close(want["y"].detach().numpy(), y, 1e-5, name)
    assert float(want["aux"]) == pytest.approx(aux, rel=1e-6)
    np.testing.assert_array_equal(want["st"].counts.numpy(), counts)
    np.testing.assert_array_equal(want["st"].coact.numpy(), coact)


def test_host_mesh_a2a_gives_the_jax_drops_and_outputs():
    """``make_host_mesh(2, 2)`` at the config's capacity 1.25: the JAX
    package's routing statistics and outputs, pairs dropped, and not the
    flat 4-shard grouping of the one-axis mesh."""
    case = A2A["dm-cf1.25"]
    layer = _layer(_jax_params("deepseek-v3-671b"))
    x = _inputs()["x"]
    _, tcfg = _cfgs(case)
    params = {k: torch.tensor(v) for k, v in layer.items()}
    y, aux, st = moe.moe_ffn(params, tcfg, torch.tensor(x), collect_stats=True,
                             mesh=make_host_mesh(2, 2, device=CPU))
    jy, jaux, counts, _ = _jax_a2a(case, layer, x)
    _close(y.numpy(), jy, 1e-5, "host mesh (2, 2)")
    np.testing.assert_array_equal(st.counts.numpy(), counts)
    flat, _ = moe.moe_ffn(params, tcfg, torch.tensor(x),
                          mesh=ShardMesh(4, CPU))
    assert np.abs(flat.numpy() - jy).max() > 1e-3


@pytest.mark.parametrize("name", list(A2A))
def test_a2a_gradients_over_ranks_add_up_to_the_in_process_ones(ranks,
                                                                name):
    """Each rank's gradients of ``(y**2).sum() + aux`` over its rows: its
    input's rows; the other leaves added over the ranks (an EP block at
    its experts), the shared expert's over the ranks at "model" 0 only:
    its tokens are every model rank's alike."""
    inputs, out = ranks
    case = A2A[name]
    want = _in_process(case, inputs["layer"], inputs["x"], grads=True)
    mesh = _mesh(case["axes"])
    E = inputs["layer"]["wi"].shape[0]
    ep_axes = tuple(case["ep_axes"])
    n = E // mesh.size(ep_axes)
    for k, gw in want["grads"].items():
        gw = gw.numpy()
        if k == "x":
            for r, o in enumerate(out):
                _close(o["a2a"][name]["grads"]["x"],
                       gw[_rows(mesh, r, gw.shape[0])], 1e-5, (name, k, r))
            continue
        total = np.zeros_like(gw, dtype=np.float64)
        for r, o in enumerate(out):
            if k.startswith("shared") and mesh.coords(r)["model"]:
                continue
            g = o["a2a"][name]["grads"][k]
            if g.shape[0] != gw.shape[0]:          # an EP block
                i = mesh.group_rank(ep_axes, r)
                total[i * n:(i + 1) * n] += g
            else:
                total += g
        _close(total, gw, 1e-5, (name, k))


# ------------------------------------------------------------ train step --


def _step_cfgs(case):
    tcfg = rk.step_cfg(case["arch"], case.get("profile"), case.get("cf"))
    jcfg = dataclasses.replace(j_get_arch(case["arch"]).reduced,
                               compute_dtype="float32")
    if case.get("profile"):
        jcfg = dataclasses.replace(jcfg, sharding_profile=case["profile"])
    return jcfg, tcfg


def _port_step(case, params_np, tok, mesh):
    """The port's step on the whole trees: over the in-process mesh, or
    on one device (``mesh=None``: the dense MoE)."""
    _, tcfg = _step_cfgs(case)
    if mesh is None and tcfg.moe is not None:
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, impl="dense"))
    params = interop.params_from_numpy(params_np, tcfg, device=CPU)
    step = ts_mod.make_train_step(tcfg, opt_mod.OptConfig(**OCFG),
                                  collect_router_stats=tcfg.moe is not None,
                                  mesh=mesh)
    new, _, m = step(params, opt_mod.init(params, device=CPU),
                     rk.batch_of(tok))
    return [t.numpy() for t in tree_leaves(new)], {
        k: v.numpy() for k, v in m.items()}


def _jax_step(case, params_np, tok):
    """The JAX package's unsharded step (one device: the dense MoE)."""
    jcfg, _ = _step_cfgs(case)
    p = jax.tree.map(jnp.asarray, params_np)
    b = {k: jnp.asarray(v.numpy()) for k, v in rk.batch_of(tok).items()}
    step = j_ts.make_train_step(jcfg, j_opt.OptConfig(**OCFG),
                                collect_router_stats=jcfg.moe is not None)
    new, _, m = jax.jit(step)(p, j_opt.init(p), b)
    flat = tree_leaves(interop.params_from_numpy(
        jax.tree.map(np.asarray, new), _step_cfgs(case)[1], device=CPU))
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


@pytest.mark.parametrize("name", list(STEPS))
def test_train_step_over_ranks_equals_the_in_process_mesh(ranks, name):
    inputs, out = ranks
    case = STEPS[name]
    arch = case["arch"]
    want_p, want_m = _port_step(case, inputs["params"][arch],
                                inputs["tokens"][arch], _mesh(case["axes"]))
    for r, o in enumerate(out):
        s = o["steps"][name]
        _held(s["whole"], s["metrics"], want_p, want_m, (name, r))


@pytest.mark.parametrize("name", [n for n, c in STEPS.items()
                                  if c.get("cf", 8.0) == 8.0])
def test_train_step_over_ranks_equals_one_device_and_jax(ranks, name):
    """Where nothing drops (capacity 8; no MoE): the ranks' step against the
    single-process port step and the JAX package's unsharded step."""
    inputs, out = ranks
    case = STEPS[name]
    arch = case["arch"]
    one = _port_step(case, inputs["params"][arch], inputs["tokens"][arch],
                     None)
    jx = _jax_step(case, inputs["params"][arch], inputs["tokens"][arch])
    for want_p, want_m, ref in (one + ("port",), jx + ("jax",)):
        for r, o in enumerate(out):
            s = o["steps"][name]
            _held(s["whole"], s["metrics"], want_p, want_m, (name, ref, r))


@pytest.mark.parametrize("name", list(STEPS))
def test_replicated_leaves_and_metrics_equal_on_every_rank(ranks, name):
    """The clip scale, the gradient sums and the router's model-axis sum
    give every rank the same bits: every metric, every whole leaf and its
    first moment, and every block of a split leaf on the ranks that hold
    that block, are equal across the ranks; the ranks holding another
    block of a split leaf hold other bits."""
    _, out = ranks
    mesh = _mesh(STEPS[name]["axes"])
    first = out[0]["steps"][name]
    places = [sharding.Placement(p) for p in first["places"]]
    assert any(p.axes() for p in places), name
    for r, o in enumerate(out[1:], 1):
        s = o["steps"][name]
        for k, v in first["metrics"].items():
            np.testing.assert_array_equal(s["metrics"][k], v,
                                          err_msg=(name, r, k))
        for i, p in enumerate(places):
            if all(mesh.coords(r)[a] == 0 for a in p.axes()):
                np.testing.assert_array_equal(s["local"][i],
                                              first["local"][i])
                np.testing.assert_array_equal(s["mu"][i], first["mu"][i])
            else:
                assert not np.array_equal(s["local"][i], first["local"][i])


def test_process_mesh_repr_and_the_dp_profile_in_process(ranks):
    """A rank's mesh names its axes; in process the "dp" profile computes
    what one device computes (a model without experts bit for bit; a MoE
    model's "dp" step equal to its "2d" step: the a2a's token shards are
    the same under both profiles)."""
    _, out = ranks
    for o in out:
        assert "axes={'data': 2, 'model': 2}" in o["repr"]
    case = STEPS["smollm-dp"]
    inputs = _inputs()
    arch = case["arch"]
    a = _port_step(case, inputs["params"][arch], inputs["tokens"][arch],
                   _mesh(DM))
    b = _port_step(case, inputs["params"][arch], inputs["tokens"][arch],
                   None)
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(x, y)
    assert math.isfinite(float(a[1]["loss"]))
    arch = "deepseek-v3-671b"
    dp = _port_step(dict(arch=arch, cf=1.25, profile="dp"),
                    inputs["params"][arch], inputs["tokens"][arch],
                    _mesh(DM))
    two = _port_step(dict(arch=arch, cf=1.25), inputs["params"][arch],
                     inputs["tokens"][arch], _mesh(DM))
    for x, y in zip(dp[0], two[0]):
        np.testing.assert_array_equal(x, y)
    for k, v in two[1].items():
        np.testing.assert_array_equal(dp[1][k], v, err_msg=k)
