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
