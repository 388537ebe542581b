"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, and its entry points run on ``cuda`` unless asked for the CPU."""
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
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
            "repro_torch.distributed.autodiff",
            "repro_torch.distributed.sharding",
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
    # the benches, the orchestrator and the examples too
    mods += ["benchmarks_torch." + f.stem for f in sorted(
        (ROOT / "benchmarks_torch").glob("*.py"))]
    assert {"benchmarks_torch.run", "benchmarks_torch.engine_bench",
            "benchmarks_torch.runtime_bench", "benchmarks_torch.obs_bench",
            "benchmarks_torch.replay_shard_bench",
            "benchmarks_torch.roofline", "repro_torch.launch.dryrun"} <= set(
                mods)
    # what a spawned rank of the process- and model-mesh and tensor
    # parallel tests imports
    mods += ["tests.process_mesh_ranks", "tests.model_mesh_ranks",
             "tests.tensor_parallel_ranks"]
    examples = sorted(str(f) for f in (ROOT / "examples_torch").glob("*.py"))
    assert len(examples) == 5
    code = (
        "import importlib, importlib.util, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        f"for m in {mods!r} + ['repro_torch', 'chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        f"for i, f in enumerate({examples!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'ex{i}', f)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
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
    files += [ROOT / "chip_smoke.py", *(ROOT / "benchmarks_torch").glob("*.py"),
              *(ROOT / "examples_torch").glob("*.py"),
              *(ROOT / "tests" / f"{m}_ranks.py" for m in (
                  "process_mesh", "model_mesh", "tensor_parallel"))]
    assert len(list((ROOT / "examples_torch").glob("*.py"))) == 5
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


def test_benches_and_examples_default_to_cuda():
    """The runtime, obs, replay-shard and engine benches (their sections
    and ``run``), the kernel bench's ``run``, the orchestrator and the
    five examples run on the card unless asked for the CPU; without one
    they raise (the orchestrator: exits 1 naming the entry).  The dry run
    traces on the CPU and takes no device."""
    import importlib.util
    import inspect
    import sys

    sys.path.insert(0, str(ROOT))
    from benchmarks_torch import (engine_bench, kernel_bench, obs_bench,
                                  replay_shard_bench, run, runtime_bench)
    from repro_torch.launch import dryrun

    assert "device" not in inspect.signature(dryrun.run_cell).parameters
    fns = [kernel_bench.run]
    for mod in (engine_bench, obs_bench, replay_shard_bench, runtime_bench):
        fns += [getattr(mod, n) for n in dir(mod)
                if (n == "run" or n.startswith("bench_"))
                and getattr(mod, n).__module__ == mod.__name__]
    assert len(fns) == 1 + 5 + 3 + 4 + 3
    for fn in fns:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    mains = {}
    for f in sorted((ROOT / "examples_torch").glob("*.py")):
        spec = importlib.util.spec_from_file_location(f"ex_{f.stem}", f)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mains[f.stem] = mod.main
    assert set(mains) == {"quickstart", "pic_prk_run", "stencil_lb_demo",
                          "serve_lm", "train_lm"}
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behavior")
    for name, main in mains.items():
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--smoke"] if name == "train_lm" else [])
    with pytest.raises(RuntimeError, match="cuda"):
        runtime_bench.bench_pic({}, steps=2, n_particles=800, repeats=1)
    with pytest.raises(RuntimeError, match="cuda"):
        obs_bench.bench_serve({}, sessions=16, replicas=2, ticks=2,
                              repeats=1)
    with pytest.raises(RuntimeError, match="cuda"):
        replay_shard_bench.bench_resilience({}, steps=6)
    with pytest.raises(RuntimeError, match="cuda"):
        engine_bench.bench_series({}, steps=2, repeats=1)
    with pytest.raises(SystemExit) as e:
        run.main(["table1"])
    assert e.value.code == 1


def test_chip_smoke_benches_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke's phase 16 (the runtime, obs, replay-shard and engine
    benches' sections with their deterministic gates asserted, then the
    five examples: the quickstart against the CPU, the PIC, stencil,
    serving and training examples) runs end to end on the CPU's plain
    versions at small sizes."""
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.syspath_prepend(str(ROOT / "src"))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    gated = ["adversarial-hotspot", "bimodal-churn"]
    monkeypatch.setattr(chip_smoke, "BENCH16", dict(
        runtime=dict(scenarios=dict(steps=40, names=gated),
                     pic=dict(steps=12, n_particles=2000)),
        obs=dict(sim=dict(P=16, K=4, grid=16, steps=10),
                 serve=dict(sessions=64, replicas=8, ticks=10)),
        replay=dict(scenarios=dict(steps=20, names=["stencil-wave",
                                                    "pic-geometric"]),
                    pic=dict(steps=12, n_particles=2000),
                    resilience=dict(steps=45, pic_steps=24,
                                    n_particles=2000)),
        engine=dict(series=dict(P=16, K=4, steps=20, grid=16),
                    batch=dict(batch=3, steps=8), scenarios=dict(steps=8),
                    pic=dict(n_particles=2000, steps=8))))
    monkeypatch.setattr(chip_smoke, "EXAMPLES16", dict(
        quickstart=[], pic_prk_run=["--particles", "2000", "--grid", "100",
                                    "--steps", "12"],
        stencil_lb_demo=[], serve_lm=["--requests", "8", "--max-new", "16"],
        train_lm=["--smoke", "--steps", "3"]))
    monkeypatch.setattr(chip_smoke, "BENCHES", {})
    monkeypatch.setattr(chip_smoke, "BENCH_LAUNCHES", {})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        chip_smoke.benches_phase()
    finally:
        torch.set_num_threads(threads)
    b = chip_smoke.BENCHES
    assert all(g["holds"] for g in b["runtime"]["gates"].values())
    assert all(g["holds"] for g in b["replay"]["gates"].values())
    assert set(b["engine"]["parity"]) == {"series parity", "batch parity"}
    assert len(b["obs"]["gates"]) == 4
    assert set(b["examples"]) == set(chip_smoke.EXAMPLES16)
    assert b["examples"]["train_lm"]["steps"] == 3
    assert not any(chip_smoke.BENCH_LAUNCHES.values())   # plain versions


def test_process_mesh_entry_points_default_to_cuda(tmp_path):
    """The process mesh, the helper that starts its group and the rank
    spawner run on the card unless asked for the CPU; without one they
    raise before a group starts."""
    import inspect

    import torch.distributed as dist

    from repro_torch.distributed import mesh
    from repro_torch.launch import mesh as lmesh

    for fn in (mesh.ProcessMesh, lmesh.init_process_mesh, lmesh.run_ranks):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="torch.distributed group"):
        mesh.ProcessMesh(device="cpu")          # no group: no mesh
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-less behavior")
    with pytest.raises(RuntimeError, match="cuda"):
        lmesh.init_process_mesh(rank=0, world_size=1,
                                store=str(tmp_path / "store"))
    assert not dist.is_initialized()


def test_chip_smoke_ranks_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke's phase 17 runs end to end on the CPU's plain versions
    at small sizes, its ranks over gloo at world size 1: (a) the plan and
    the series through one rank equal ShardMesh(1)'s, (b) the series and
    the PIC replay through the ranks equal the in-process mesh's."""
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.syspath_prepend(str(ROOT / "src"))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "RANKS_WORLD", 1)
    monkeypatch.setattr(chip_smoke, "RANKS_KERNELS", {})   # CPU: none
    monkeypatch.setattr(chip_smoke, "SIM_SCENARIO", dict(
        grid=16, num_nodes=8, mapping="tiled"))
    monkeypatch.setattr(chip_smoke, "SIM", dict(
        steps=24, lb_every=10, strategy="diff-comm",
        strategy_kwargs={"k": 4}))
    monkeypatch.setattr(chip_smoke, "RANKS_PIC", dict(
        L=100, n_particles=4000, steps=21, cx=8, cy=8, num_pes=4, rho=0.9,
        mode="GEOMETRIC", lb_every=10, strategy="diff-comm",
        strategy_kwargs={"k": 2}))
    monkeypatch.setattr(chip_smoke, "RANKS", {})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches = chip_smoke.ranks_phase(10)
    finally:
        torch.set_num_threads(threads)
    r = chip_smoke.RANKS
    assert r["one"]["transport"] == "gloo" and r["one"]["fired"] == [10, 20]
    assert r["many"]["world_size"] == 1 and r["many"]["pic_exchanges"] > 0
    assert not any(launches.values())                # plain versions


def test_chip_smoke_model_mesh_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke's phase 18 runs end to end on the CPU's plain versions
    with the reduced deepseek-v3's MoE layer, its ranks over gloo: (a) one
    rank, mesh (model 1), bit for bit the in-process a2a; (b) 4 ranks,
    mesh (model 4), each with its EP block, routing exact; (c) the steps
    over (data 2, model 2) against the in-process and one-device steps."""
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.syspath_prepend(str(ROOT / "src"))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "MESH_FULL", False)
    monkeypatch.setattr(chip_smoke, "MESH_X", (2, 16))
    monkeypatch.setattr(chip_smoke, "MESH", {})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches = chip_smoke.model_mesh_phase()
    finally:
        torch.set_num_threads(threads)
    m = chip_smoke.MESH
    assert m["one"]["transport"] == "gloo" and m["one"]["bit_for_bit"]
    assert m["many"]["world_size"] == 4 and len(m["many"]["exchange_ms"]) == 4
    assert m["many"]["dropped_pairs"] > 0          # capacity 1.25 drops
    assert len(m["steps"]["deepseek_param_err"]) == 4
    assert not any(launches.values())                # plain versions


def test_chip_smoke_tensor_parallel_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke's phase 19 runs end to end on the CPU's plain versions
    at reduced sizes in one spawn of 4 gloo ranks: (a) the reduced
    gemma3-27b over (model 4) (the head-repeat branch), (b) the reduced
    smollm-135m over (data 2, model 2) and (c') the reduced xlstm-125m
    over (model 4), each rank holding only its blocks, held to the
    one-process step through the reference's files in f32 and in bf16
    compute ((c') at its own 2 x 512 tokens: at the reduced width bf16's
    grad norm over 2 x 32 is within its rounding, ~1e-3, of the bound);
    (c) the reduced cases' checks (against the same ranks, the CPU's),
    the head-parallel xlstm and 4-head hymba among them."""
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.syspath_prepend(str(ROOT / "src"))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "TP_FULL", False)
    monkeypatch.setattr(chip_smoke, "TP_GEMMA", dict(
        chip_smoke.TP_GEMMA, seq=32))
    monkeypatch.setattr(chip_smoke, "TP_SMOLLM", dict(
        chip_smoke.TP_SMOLLM, seq=32))
    monkeypatch.setattr(chip_smoke, "TP", {})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches = chip_smoke.tensor_parallel_phase()
    finally:
        torch.set_num_threads(threads)
    t = chip_smoke.TP
    assert t["world_size"] == 4 and t["transport"] == "gloo"
    for w in ("gemma", "smollm", "xlstm"):
        assert all(e < t[w]["whole_elements"] for e in t[w]["elements"])
        assert set(t[w]["runs"]) == {"float32", "bfloat16"}
        for run in t[w]["runs"].values():
            assert max(run["param_err"]) <= 2.5 * run["lr"]
    assert set(t["small"]) == {"gemma3-27b", "deepseek-v3-671b",
                               "qwen1.5-110b", "xlstm-125m", "hymba-h4"}
    for arch in ("xlstm-125m", "hymba-h4"):
        assert chip_smoke._ssm_modes(t["small"][arch]["plan"]) == {"tp"}
    assert chip_smoke._ssm_modes(t["xlstm"]["plan"]) == {"tp"}
    assert t["dropped_pairs"] > 0
    assert not any(launches.values())                # plain versions


def test_serving_ranks_entry_points_default_to_cuda():
    """Serving over ranks runs on the card unless asked for the CPU: the
    cache's blocks and the trace mesh's device default to it; a CPU
    tensor's K6 partials and merge take the plain versions, launching
    nothing."""
    import inspect

    from repro_torch import kernels
    from repro_torch.distributed import mesh
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import transformer

    assert inspect.signature(transformer.init_cache).parameters[
        "device"].default == "cuda"
    assert inspect.signature(mesh.TraceMesh).parameters[
        "device"].default == "cpu"          # it traces: no card needed
    if not torch.cuda.is_available():
        from repro_torch.configs import get_arch

        cfg = get_arch("gemma3-1b").reduced
        with pytest.raises(RuntimeError, match="cuda"):
            transformer.init_cache(cfg, 2, 16, mesh=mesh.TraceMesh(
                dict(model=2)))
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.normal(size=(1, 1, 1, 2, 8)).astype(np.float32))
    k = torch.tensor(rng.normal(size=(1, 8, 1, 8)).astype(np.float32))
    pos = torch.arange(8, dtype=torch.int32)[None]
    before = kernels.launch_counts()["flash_attention"]
    m, l, o = fops.flash_partials(q, k, k, pos[:, -1:], pos, offset=8,
                                  total=16)
    out = fops.flash_combine(m, l, o, torch.float32)
    assert out.shape == q.shape
    assert kernels.launch_counts()["flash_attention"] == before


def test_chip_smoke_serving_ranks_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke's phase 20 runs end to end on the CPU's plain versions
    at reduced sizes in one spawn of 4 gloo ranks: (a) the reduced
    gemma3-27b cut to one local and one global layer and (b) the reduced
    deepseek-v3 cut to two dense MLA layers and (g) the reduced
    xlstm-125m, over (model 4), each rank holding only its blocks of the
    parameters and the cache, held to the one-process run in f32 (greedy
    tokens equal; (g)'s final state blocks too) and bf16 compute; (e)
    and (f) the same with the prompt prefilled in two chunks, (e)'s
    26-slot global cache whole on every rank; (c) every reduced family and
    the 4-head hymba in each case (both meshes, a cache whole on the
    ranks, a chunked prefill) against the same ranks."""
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.syspath_prepend(str(ROOT / "src"))
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEV", "cpu")
    monkeypatch.setattr(chip_smoke, "SV_FULL", False)
    monkeypatch.setattr(chip_smoke, "SV_GEMMA", dict(
        chip_smoke.SV_GEMMA, prompt=12, ticks=8, max_len=24,
        chunked=dict(max_len=26, chunks=(6, 6), ticks=8)))
    monkeypatch.setattr(chip_smoke, "SV_DEEPSEEK", dict(
        chip_smoke.SV_DEEPSEEK, prompt=12, ticks=4, max_len=16,
        chunked=dict(max_len=16, chunks=(6, 6), ticks=4)))
    monkeypatch.setattr(chip_smoke, "SV_XLSTM", dict(
        chip_smoke.SV_XLSTM, prompt=12, ticks=4, max_len=16))
    monkeypatch.setattr(chip_smoke, "SV_SMALL", dict(
        chip_smoke.SV_SMALL, ticks=2))
    monkeypatch.setattr(chip_smoke, "SV", {})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches, partials = chip_smoke.serving_ranks_phase()
    finally:
        torch.set_num_threads(threads)
    s = chip_smoke.SV
    assert s["world_size"] == 4 and s["transport"] == "gloo"
    for w in ("gemma", "deepseek", "xlstm"):
        assert all(g < s[w]["whole_gib"] for g in s[w]["gib"])
        for c, run in s[w]["runs"].items():
            assert max(run["logit_err"]) <= run["tolerance"] * run[
                "largest_logit"]
            assert all(g < s[w]["whole_cache_gib"][c]
                       for g in (x[c] for x in s[w]["cache_gib"]))
    assert set(s["xlstm"]["runs"]) == {"float32", "bfloat16"}
    assert s["xlstm"]["runs"]["float32"]["tokens_agree"] == 1.0
    for st in s["xlstm"]["runs"]["float32"]["state"]:
        assert len(st) == 7 and all(x["err"] <= 1e-5 * x["scale"]
                                    for x in st)
    assert s["xlstm"]["split"]["float32"] == [False, False]
    assert chip_smoke._ssm_modes(s["xlstm"]["plan"]) == {"tp"}
    for w in ("gemma", "deepseek"):
        assert set(s[w]["runs"]) == {"float32", "bfloat16",
                                     "chunked float32", "chunked bfloat16"}
        for c in ("float32", "chunked float32"):
            assert s[w]["runs"][c]["tokens_agree"] == 1.0
        ch = s[w]["one_process_chunks"]
        assert ch["logit_err"] <= ch["tolerance"] * ch["largest_logit"]
    assert s["gemma"]["split"]["chunked float32"] == [True, False]
    assert s["deepseek"]["split"]["chunked float32"] == [True, True]
    assert len(s["small"]["archs"]) == 11 and "hymba-h4" in s["small"][
        "archs"]
    assert [c["case"] for c in s["small"]["cases"]] == ["dm", "m4", "U",
                                                       "C"]
    assert partials == {} and not any(launches.values())   # plain versions
