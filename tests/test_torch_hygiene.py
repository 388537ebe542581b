"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points run on ``cuda`` unless asked for the CPU."""
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    import repro_torch

    mods = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    assert "repro_torch.pic.driver" in mods and len(mods) > 20
    # the sharded slice's modules are among those checked
    assert {"repro_torch.distributed.mesh", "repro_torch.distributed.lb_shard",
            "repro_torch.distributed.replay_shard",
            "repro_torch.runtime.resilience",
            "repro_torch.train.fault_tolerance",
            "repro_torch.distributed.ep_balance",
            "repro_torch.train.ep_runtime",
            # the training slice
            "repro_torch.train.optimizer", "repro_torch.train.train_step",
            "repro_torch.train.checkpoint", "repro_torch.train.data",
            "repro_torch.distributed.data_balance",
            "repro_torch.distributed.grad_compress",
            "repro_torch.launch.train", "repro_torch.launch.mesh"} <= set(
                mods)
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        f"for m in {mods!r} + ['repro_torch', 'chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_sources_have_no_jax_or_repro_imports():
    import re

    pat = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro\b"
                     r"|import repro\.|from repro\.)", re.M)
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", *(ROOT / "benchmarks_torch").glob("*.py")]
    for f in files:
        assert not pat.search(f.read_text()), f


def test_entry_points_default_to_cuda():
    import inspect

    from repro_torch import interop
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.core import engine
    from repro_torch.models import params, transformer
    from repro_torch.pic import driver
    from repro_torch.runtime import triggers
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import DiffusionScheduler
    from repro_torch.sim import scenarios, simulator, stencil

    assert driver.PICConfig().device == "cuda"
    for fn in (stencil.stencil_2d, stencil.stencil_3d,
               scenarios.Scenario.instantiate, params.init_params,
               transformer.init_cache, transformer.init_block_cache,
               ServeEngine, DiffusionScheduler, interop.params_from_numpy,
               triggers.EveryTrigger.init_state,
               triggers.ThresholdTrigger.init_state,
               triggers.PredictiveTrigger.init_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behavior")
    with pytest.raises(RuntimeError, match="cuda"):
        driver.run(driver.PICConfig(L=20, n_particles=100, steps=2, cx=4,
                                    cy=4, num_pes=2))
    with pytest.raises(RuntimeError):
        engine.LBEngine()
    # the serving slice: the scheduler, the model's parameters and caches,
    # the triggers' state and the launcher
    with pytest.raises(RuntimeError, match="cuda"):
        DiffusionScheduler(2)
    with pytest.raises(RuntimeError, match="cuda"):
        triggers.PredictiveTrigger().init_state()
    cfg = get_arch("smollm-135m").reduced
    with pytest.raises(RuntimeError, match="cuda"):
        params.init_params(transformer.model_specs(cfg))
    with pytest.raises(RuntimeError, match="cuda"):
        transformer.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main([])
    with pytest.raises(RuntimeError, match="cuda"):
        stencil.stencil_2d(4, 4, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        scenarios.get("stencil-wave").instantiate(grid=8, num_nodes=4)
    # run_series runs on its problem's device: the user's chain from a
    # scenario with its defaults raises here
    with pytest.raises(RuntimeError, match="cuda"):
        simulator.run_series(*scenarios.get("bimodal-churn").instantiate(
            grid=8, num_nodes=4), steps=2, lb_every=1)


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behavior")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_simulator_phases_rehearse_on_cpu(monkeypatch):
    """chip_smoke's simulator phases (replay against ``none``, the plan of
    one snapshot through K1, the streaming chunk and ``step_fn``, K4's
    ordered form at the snapshot's shapes, Table I, Fig 2, the small
    replay) run end to end on the CPU's plain versions at
    a small size, so a fault in their Python shows here first."""
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.syspath_prepend(str(ROOT / "src"))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "SIM_SCENARIO",
                        dict(grid=32, num_nodes=16, mapping="tiled"))
    monkeypatch.setattr(chip_smoke, "SIM_KERNELS", ())   # none on the CPU
    monkeypatch.setattr(chip_smoke, "STEP_KERNELS", ())
    counts, snap = chip_smoke.sim_path()
    assert counts["diffusion_nsweeps"] == 0      # plain versions on the CPU
    (loads, nbr, mask), step_counts = chip_smoke.sim_engines(snap)
    assert step_counts["diffusion_sweep"] == 0
    assert loads.shape == (16,) and nbr.shape == mask.shape
    chip_smoke.k4_ordered_check(snap)
    chip_smoke.paper_scripts_and_small_replay()


def test_chip_smoke_serving_phases_rehearse_on_cpu(monkeypatch):
    """chip_smoke's serving phases (two engines behind the scheduler,
    decode past the window, the card-against-CPU serve) run end to end on
    the CPU's plain versions with the reduced gemma3-1b."""
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.syspath_prepend(str(ROOT / "src"))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "SERVE_FULL", False)
    monkeypatch.setattr(chip_smoke, "SERVE_KERNELS", ())   # none on the CPU
    monkeypatch.setattr(chip_smoke, "SERVE", dict(
        replicas=2, slots=4, max_len=40, dtype="float32", max_new=6,
        prompt_lens=(16, 13, 5, 6, 7, 8, 9, 10)))
    counts = chip_smoke.serve_path()
    assert counts["flash_attention"] == 0        # plain versions on the CPU
    chip_smoke.serve_cpu_parity()


def test_chip_smoke_host_planner_phases_rehearse_on_cpu(monkeypatch):
    """chip_smoke's host-planner and batched phases (the greedy-refine PIC
    path, the greedy-refine and batched replays against the CPU, Table II,
    Fig 4 and Fig 5 with their assertions) run end to end on the CPU's
    plain versions at reduced sizes."""
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.syspath_prepend(str(ROOT / "src"))
    import chip_smoke
    from repro_torch.pic import driver

    small = dict(L=100, n_particles=8000, steps=21, cx=8, cy=8, num_pes=4,
                 rho=0.9, mode="GEOMETRIC", lb_every=10)
    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "PIC_HOST",
                        dict(small, strategy="greedy-refine",
                             strategy_kwargs={}))
    monkeypatch.setattr(chip_smoke, "PIC_HOST_KERNELS", ())  # CPU: none
    monkeypatch.setattr(chip_smoke, "PAPER_HOST", {
        "table2_strategies": dict(bench=[(32, (16, 16, 8))],
                                  trigger_steps=20),
        "fig4_pic_lb": dict(steps=40, n=20_000),
        "fig5_scaling": dict(n=50_000, steps=50, scales=[4, 8],
                             sweep=dict(batch=4, steps=12))})
    monkeypatch.setattr(chip_smoke, "PAPER_HOST_KERNELS",
                        dict.fromkeys(chip_smoke.PAPER_HOST, ()))
    # many small CPU ops: one intra-op thread, so that beside other test
    # workers the threads do not spin against each other
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        diff = driver.run(driver.PICConfig(**small, device="cpu"))
        none = driver.run(driver.PICConfig(**small, strategy="none",
                                           device="cpu"))
        counts = chip_smoke.host_pic_path(
            dict(steps=small["steps"], wall_seconds=diff.wall_seconds,
                 lb_seconds=diff.lb_seconds), none)
        assert counts["pic_push"] == 0           # plain versions on the CPU
        chip_smoke.host_and_batched_replays()
        chip_smoke.paper_scripts_host()
    finally:
        torch.set_num_threads(threads)


def test_chip_smoke_families_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke's phase 13 (the other model families: two served by a
    ServeEngine with MoE and MLA, hymba and xLSTM served, four through
    prefill and decode_step with the audio and vision frontends, then
    every other reduced config on the card against the CPU) runs end to
    end on the CPU's plain versions with the reduced configs."""
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.syspath_prepend(str(ROOT / "src"))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "FAM_FULL", False)
    monkeypatch.setattr(chip_smoke, "FAM_KERNELS", ())   # none on the CPU
    monkeypatch.setattr(chip_smoke, "FAMILIES", {})
    monkeypatch.setattr(chip_smoke, "FAM_SERVE", {
        arch: dict(spec, prompt_lens=(16, 12, 9, 5), max_new=6)
        for arch, spec in chip_smoke.FAM_SERVE.items()})
    monkeypatch.setattr(chip_smoke, "FAM_STEP_SHAPE",
                        dict(batch=2, prompt=12, steps=3))
    # many small CPU ops: one intra-op thread beside other test workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        counts = chip_smoke.families_path()
    finally:
        torch.set_num_threads(threads)
    assert set(counts) == set(chip_smoke.FAM_SERVE) | set(
        chip_smoke.FAM_STEP)
    assert not any(counts.values())          # plain versions on the CPU
    fam = chip_smoke.FAMILIES
    assert fam["deepseek-v3-671b"]["router"]["counts_sum"] == 5 * 2 * 2
    assert fam["xlstm-125m"]["ticks"] > 0
    assert fam["hymba-1.5b"]["ring_max_pos"] >= 16    # decode past window
    assert len(fam["reduced_cuda_vs_cpu_max_logit_err"]) == 9


def test_model_entry_points_default_to_cuda():
    """The model families' entry points (the shape registry's batches,
    the recurrent states, the latent cache, the router statistics and the
    aux channel) run on the card unless asked for the CPU; without one
    they raise."""
    import inspect

    from repro_torch.configs import SHAPES, base, get_arch
    from repro_torch.models import attention, moe, ssm, transformer

    fns = (base.materialize_batch, ssm.mamba_init_state,
           ssm.mlstm_init_state, ssm.slstm_init_state,
           attention.init_mla_cache, moe.zero_router_stats,
           transformer.zero_aux)
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behavior")
    cfg = get_arch("deepseek-v3-671b").reduced
    with pytest.raises(RuntimeError, match="cuda"):
        transformer.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        attention.init_mla_cache(cfg, 1, 8, torch.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        base.materialize_batch(cfg, SHAPES["train_4k"])
    with pytest.raises(RuntimeError, match="cuda"):
        transformer.zero_aux(cfg, True)
    hymba = get_arch("hymba-1.5b").reduced
    for fn in (ssm.mamba_init_state, ssm.mlstm_init_state,
               ssm.slstm_init_state):
        with pytest.raises(RuntimeError, match="cuda"):
            fn(hymba, 1)
    # the launcher takes all ten architectures, on the CPU when asked
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "xlstm-125m"])
    with pytest.raises(SystemExit):
        serve.main(["--arch", "gpt-2", "--device", "cpu"])
    done = serve.main(["--arch", "deepseek-v3-671b", "--requests", "3",
                       "--max-new", "3", "--device", "cpu"])
    assert len(done) == 3 and all(len(r.out) == 3 for r in done)
    # K6's MLA timing script needs a card and says so
    out = subprocess.run([sys.executable, str(
        ROOT / "benchmarks_torch" / "flash_mla.py")], capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0 and "needs a CUDA device" in out.stderr


def test_fleet_entry_points_default_to_cuda():
    """The fleet replay's entry points (``run_serve_replay``,
    ``record_trace``, ``launch.serve --fleet-replay``, the serve bench)
    run on the card unless asked for the CPU; without one they raise."""
    import inspect
    import sys

    sys.path.insert(0, str(ROOT))
    from benchmarks_torch import serve_bench, serve_replay_profile
    from repro_torch.launch import serve
    from repro_torch.serve import replay

    for fn in (replay.run_serve_replay, replay.record_trace):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for fn in (serve_bench.run, serve_bench.bench_policies,
               serve_bench.bench_scale):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behavior")
    w = replay.ServeWorkload(num_sessions=16, num_replicas=2)
    with pytest.raises(RuntimeError, match="cuda"):
        replay.run_serve_replay(w, steps=2)
    with pytest.raises(RuntimeError, match="cuda"):
        replay.record_trace(w, steps=2)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--fleet-replay", "16", "--replicas", "2",
                    "--ticks", "2"])
    with pytest.raises(RuntimeError, match="cuda"):
        serve_bench.bench_scale({}, num_sessions=16, num_replicas=2,
                                steps=2, repeats=1)
    # the profile script needs a card and says so
    out = subprocess.run([sys.executable, str(
        ROOT / "benchmarks_torch" / "serve_replay_profile.py")],
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and serve_replay_profile.FLEET
    # on the CPU when asked
    r = serve.main(["--fleet-replay", "32", "--replicas", "4", "--ticks",
                    "12", "--strategy", "diff-comm", "--device", "cpu"])
    assert r.lb_fired.sum() == 1


def test_chip_smoke_fleet_phases_rehearse_on_cpu(monkeypatch):
    """chip_smoke's fleet phases (the fleet replay with its invariants,
    its telemetry run and trace, the serve bench's gates, the fleet against
    the CPU, two-level placement) run end to end on the CPU's plain
    versions at a small size (the bench's gates are claims at its own
    sizes, which the card runs; these smaller workloads keep them)."""
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.syspath_prepend(str(ROOT / "src"))
    import chip_smoke
    from repro_torch.sim import scenarios

    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "FLEET",
                        dict(num_sessions=1024, num_replicas=16, seed=1))
    monkeypatch.setattr(chip_smoke, "FLEET_TEL_CAPACITY", 80)
    monkeypatch.setattr(chip_smoke, "FLEET_KERNELS", ())   # none on the CPU
    monkeypatch.setattr(chip_smoke, "SERVE_BENCH", dict(steps=40, workloads={
        "synthetic": (512, 8, dict(seed=0), False),
        "trace": (256, 4, dict(burst_period=18, seed=3), True)}))
    monkeypatch.setattr(chip_smoke, "FLEET_CPU", dict(
        num_sessions=256, num_replicas=8, steps=24, slot_capacity=36))
    monkeypatch.setattr(chip_smoke, "SIM_SCENARIO",
                        dict(grid=16, num_nodes=8, mapping="tiled"))
    monkeypatch.setattr(chip_smoke, "HIER_SIM", dict(
        steps=12, lb_every=10, strategy="diff-comm",
        strategy_kwargs={"k": 4}))
    monkeypatch.setattr(chip_smoke, "HIER_PIC", dict(
        L=100, n_particles=2000, steps=12, cx=8, cy=8, num_pes=4,
        lb_every=5, threads_per_node=2))
    counts = chip_smoke.fleet_path()
    assert counts["scatter_dest"] == 0           # plain versions on the CPU
    chip_smoke.serve_bench_gates()
    chip_smoke.fleet_cpu_parity()
    p, ev = scenarios.get("stencil-wave").instantiate(
        device="cpu", **chip_smoke.SIM_SCENARIO)
    chip_smoke.two_level(ev(p, 10))


def test_sharded_entry_points_default_to_cuda():
    """The sharded slice's entry points run on the card unless asked for
    the CPU; without one they raise."""
    import inspect

    from repro_torch.distributed import lb_shard, mesh
    from repro_torch.train import fault_tolerance as ft

    assert inspect.signature(mesh.ShardMesh).parameters[
        "device"].default == "cuda"
    assert inspect.signature(lb_shard.ShardedLBEngine).parameters[
        "device"].default == "cuda"
    assert lb_shard._DEFAULTS["device"] == "cuda"
    assert ft.StragglerBalancer(num_hosts=2).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behavior")
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.ShardMesh(2)
    with pytest.raises(RuntimeError, match="cuda"):
        lb_shard.ShardedLBEngine(num_shards=2)
    with pytest.raises(RuntimeError, match="cuda"):
        lb_shard.get_sharded_engine(k=2)
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.resolve_mesh(None, 2, (4,))


def test_expert_balancing_entry_points_default_to_cuda():
    """The expert-balancing slice's entry points (``run_ep_replay``,
    ``execute_placement``, ``EPRebalancer``, ``core.diffusion_lb``, the
    routing trace and the expert planner) run on the card unless asked for
    the CPU; without one they raise."""
    import inspect
    import sys

    import numpy as np

    sys.path.insert(0, str(ROOT))
    from benchmarks_torch import ep_balance_bench, moe_bench
    from repro_torch.core import api
    from repro_torch.distributed import ep_balance
    from repro_torch.train import ep_runtime

    for fn in (ep_runtime.run_ep_replay, ep_runtime.execute_placement,
               ep_runtime.EPRebalancer, ep_runtime.record_routing,
               ep_runtime.RoutingWorkload.ids_at, api.diffusion_lb,
               ep_balance.plan_placement, ep_balance.build_problem,
               ep_balance_bench.run, moe_bench.run):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behavior")
    w = ep_runtime.RoutingWorkload(num_experts=8, num_ranks=2,
                                   tokens_per_step=16, trace_len=2)
    with pytest.raises(RuntimeError, match="cuda"):
        ep_runtime.run_ep_replay(w, steps=2)
    with pytest.raises(RuntimeError, match="cuda"):
        ep_runtime.EPRebalancer(8, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        ep_runtime.execute_placement([], np.arange(8), np.arange(8) // 4,
                                     num_ranks=2)
    with pytest.raises(RuntimeError, match="cuda"):
        ep_runtime.record_routing(w, steps=2)
    stats = ep_balance.ExpertStats(8)
    with pytest.raises(RuntimeError, match="cuda"):
        ep_balance.plan_placement(stats, np.arange(8) // 4, 2)
    from repro_torch.core import comm_graph

    p = comm_graph.make_problem([1.0, 2.0], [0, 1], [[0, 1]], [1.0], 2,
                                device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        api.diffusion_lb(p, k=1)
    # the moe bench needs a card unless asked for the CPU, and says so
    out = subprocess.run([sys.executable, str(
        ROOT / "benchmarks_torch" / "moe_bench.py")], capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0 and "cuda" in out.stderr


def test_plan_health_fn_without_health_is_plan_fn_op_for_op():
    """``plan_health_fn(problem, None)`` dispatches exactly the operations
    ``plan_fn`` does (the health masks add nothing when off), with equal
    results."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.core import engine
    from repro_torch.sim import scenarios

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    p, ev = scenarios.get("stencil-wave").instantiate(grid=8, num_nodes=4,
                                                      device="cpu")
    p = ev(p, 3)
    eng = engine.get_engine(k=2, device="cpu")
    eng.plan_fn(p)                                   # warm any caches
    with Ops() as a:
        want = eng.plan_fn(p)
    with Ops() as b:
        got = eng.plan_health_fn(p, None)
    assert a.ops == b.ops and len(a.ops) > 0
    assert torch.equal(got[0], want[0])
    for x, y in zip(got[1], want[1]):
        assert torch.equal(x, y)


def test_chip_smoke_expert_balancing_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke's phase 14 (the EP replay against its host loop and the
    CPU, every fire capacity-exact; the replay over 8 shards; the moe and
    ep_balance benches' gates; a MoE layer's experts relocated in place
    by an ``EPRebalancer`` fed its router statistics) runs end to end on
    the CPU's plain versions at small sizes (the reduced deepseek-v3 over
    2 ranks for the relocation)."""
    import dataclasses

    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.syspath_prepend(str(ROOT / "src"))
    import chip_smoke
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params

    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "EP", dict(
        num_experts=32, num_ranks=8, top_k=4, tokens_per_step=256,
        alpha=0.5, hot_amp=2.0, trace_len=16, seed=1))
    monkeypatch.setattr(chip_smoke, "EP_RUN", dict(
        steps=16, lb_every=4, strategy="diff-comm", trigger="every"))
    monkeypatch.setattr(chip_smoke, "EP_BENCH", dict(
        moe_steps=48, scale=dict(num_experts=64, num_ranks=8, steps=16),
        ep_balance=dict(E=32, R=4, periods=6, T=1024)))
    monkeypatch.setattr(chip_smoke, "EP_RELOCATE_RANKS", 2)
    monkeypatch.setattr(chip_smoke, "EPB", {})
    monkeypatch.setattr(chip_smoke, "EP_LAUNCHES", {})
    monkeypatch.setattr(chip_smoke, "RESULTS", {})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        counts = chip_smoke.ep_replay_phase()
        chip_smoke.ep_sharded_phase()
        chip_smoke.ep_bench_gates()
        cfg = dataclasses.replace(get_arch("deepseek-v3-671b").reduced,
                                  compute_dtype="float32")
        params = init_params(transformer.model_specs(cfg), 0, device="cpu")
        pr = torch.arange(1, 33, dtype=torch.int64)[None] * 7 % 500
        pos = torch.arange(32, dtype=torch.int32)[None]
        h0, _, (_, st) = transformer.forward(
            params, cfg, dict(tokens=pr, positions=pos),
            collect_router_stats=True, with_aux=True)
        reloc = chip_smoke.ep_relocation(cfg, params, pr, pos, h0, st)
    finally:
        torch.set_num_threads(threads)
    assert counts["scatter_dest"] == 0          # plain versions on the CPU
    ep = chip_smoke.EPB
    assert ep["replay"]["fires"] == [4, 8, 12]
    assert ep["replay"]["cpu_max_avg_ulps"] == 0
    assert ep["sharded"]["shards"] == 8
    assert all(ep["benches"]["ep_balance"]["gates"].values())
    assert reloc["moved_experts"] >= 1 and reloc["ranks"] == 2
    assert reloc["logits_max_abs_err"] <= 1e-3


def test_training_entry_points_default_to_cuda():
    """The training slice's entry points (the launcher's build and train,
    the optimizer's state, checkpoint restore, the data pipeline's
    balancing, the meshes) run on the card unless asked for the CPU;
    without one they raise."""
    import inspect

    from repro_torch import interop
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train as lt
    from repro_torch.train import checkpoint, data, optimizer

    assert lt.RunConfig().device == "cuda"
    for fn in (optimizer.init, checkpoint.restore, data.DataPipeline,
               data.balance_shards, data.shard_problem,
               lmesh.make_host_mesh, lmesh.make_production_mesh,
               interop.opt_state_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behavior")
    p = dict(w=torch.ones((2, 2)))
    with pytest.raises(RuntimeError, match="cuda"):
        optimizer.init(p)
    with pytest.raises(RuntimeError, match="cuda"):
        lt.build(lt.RunConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        lt.train(lt.RunConfig(steps=1))
    with pytest.raises(RuntimeError, match="cuda"):
        lt.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        lmesh.make_host_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        lmesh.make_production_mesh()
    pipe = data.DataPipeline(data.DataConfig(vocab_size=100, seq_len=16,
                                             global_batch=4, num_shards=16,
                                             seed=7), num_ranks=4)
    pipe.next_batch()                     # NumPy: no device
    with pytest.raises(RuntimeError, match="cuda"):
        pipe.maybe_rebalance(threshold=1.0)
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 1, p)
        with pytest.raises(RuntimeError, match="cuda"):
            checkpoint.restore(d, p)
        assert torch.equal(checkpoint.restore(d, p, device="cpu")[0]["w"],
                           p["w"])
    # on the CPU when asked
    out = lt.main(["--steps", "2", "--seq-len", "8", "--batch", "2",
                   "--device", "cpu"])
    assert out is None


def test_chip_smoke_training_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke's phase 15 (training through the launcher with
    checkpoints; crash and resume bit for bit; one step of every reduced
    config against the CPU; the reduced deepseek-v3 with the a2a over 4
    shards and expert rebalancing; the data pipeline's rebalance) runs end
    to end on the CPU's plain versions with the reduced configs."""
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.syspath_prepend(str(ROOT / "src"))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "TRAIN_FULL", False)
    monkeypatch.setattr(chip_smoke, "TRAIN", dict(
        arch="smollm-135m", steps=4, seq_len=32, global_batch=2,
        save_every=2))
    monkeypatch.setattr(chip_smoke, "TRAIN_RESUME", dict(
        steps=4, seq_len=16, batch=2, fail_at=2, save_every=2))
    monkeypatch.setattr(chip_smoke, "TRAINING", {})
    monkeypatch.setattr(chip_smoke, "TRAIN_LAUNCHES", {})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        chip_smoke.training_phase()
    finally:
        torch.set_num_threads(threads)
    tr = chip_smoke.TRAINING
    assert tr["full_width"]["checkpoints"] == ["ckpt_00000002",
                                               "ckpt_00000004"]
    assert tr["crash_resume"]["restarts"] == 1
    assert len(tr["cuda_vs_cpu"]) == 10
    assert tr["ep"]["fires"] == [2, 4, 6] and sum(tr["ep"]["moved_experts"])
    assert tr["data"]["moved_shards"] > 0
    assert not any(sum(n.values()) for n in chip_smoke.TRAIN_LAUNCHES.values())
