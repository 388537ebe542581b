"""The port's five examples (``examples_torch/``) on the CPU: the
quickstart's plan and the PIC example's run against the JAX package's, and
the stencil demo, the serving and the training examples run to their
ends."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _one_thread():
    # many small CPU ops: one intra-op thread beside other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_plan_equals_jax():
    from repro.core import api
    from repro.sim import stencil, synthetic

    plan = _example("quickstart").main(["--device", "cpu"])
    problem = synthetic.hotspot(stencil.stencil_2d(8, 8, 4, mapping="tiled"),
                                node=0, factor=5.0)
    want = api.diffusion_lb(problem, k=2, variant="comm")
    np.testing.assert_array_equal(np.asarray(plan.assignment),
                                  np.asarray(want.assignment))
    assert plan.info["diffusion_iters"] == want.info["diffusion_iters"]


def test_pic_prk_run_matches_jax():
    from repro.pic import driver

    r = _example("pic_prk_run").main(["--particles", "2000", "--grid", "100",
                                      "--steps", "20", "--device", "cpu"])
    want = driver.run(driver.PICConfig(
        L=100, n_particles=2000, steps=20, k=2, rho=0.9, cx=12, cy=12,
        num_pes=4, mapping="striped", lb_every=10, strategy="diff-comm",
        strategy_kwargs=dict(k=3)))
    np.testing.assert_array_equal(r.lb_steps, want.lb_steps)
    assert abs(r.summary()["mean_max_avg"]
               - want.summary()["mean_max_avg"]) <= 1e-6


def test_stencil_lb_demo_runs_every_scenario(capsys):
    from repro_torch.sim import scenarios

    rows = _example("stencil_lb_demo").main(["--device", "cpu"])
    names = {n for n, _, _, _ in rows}
    assert names == set(scenarios.available())
    for _, strategy, path, res in rows:
        assert path == ("host" if strategy == "greedy-refine" else "scan")
        assert np.isfinite(res.max_avg).all() and len(res.max_avg) == 60
    assert "path" in capsys.readouterr().out


def test_serve_lm_serves_every_request():
    done = _example("serve_lm").main(["--device", "cpu"])
    assert len(done) == 8 and all(len(r.out) == 16 for r in done)


def test_train_lm_smoke_runs_to_its_end():
    out = _example("train_lm").main(["--smoke", "--device", "cpu"])
    assert len(out["losses"]) == 20 and np.isfinite(out["losses"]).all()
    assert out["final_loss"] < out["losses"][0]
