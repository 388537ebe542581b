"""``benchmarks_torch/runtime_bench.py``'s replays against the JAX
package's on the CPU: for every registered scenario at its default size
under the three trigger policies, the fire steps equal those of
``repro.sim.simulator.run_series`` with the same kwargs and the modeled
seconds match within rtol 1e-5 (at a reduced step count)."""
import numpy as np
import pytest
import torch

from benchmarks import runtime_bench as j_runtime
from benchmarks_torch import runtime_bench as t_runtime
from repro.runtime import cost as j_cost
from repro.sim import scenarios as j_scenarios
from repro.sim import simulator as j_simulator
from repro_torch.sim import scenarios

STEPS = 40


@pytest.mark.parametrize("name", sorted(scenarios.available()))
def test_runtime_bench_fires_and_prices_as_jax(name):
    """Each scenario at its default size under every / threshold /
    predictive: fire steps equal the JAX package's ``run_series`` with the
    same kwargs, modeled seconds within rtol 1e-5."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = t_runtime.bench_scenarios({}, steps=STEPS, device="cpu",
                                        repeats=1, names=[name])
    finally:
        torch.set_num_threads(threads)
    prob, evolve = j_scenarios.get(name).instantiate()
    for policy, spec in j_runtime.POLICIES:
        want = j_simulator.run_series(
            prob, evolve, steps=STEPS, lb_every=10, strategy="diff-comm",
            strategy_kwargs=dict(k=4), trigger=spec, scan=True)
        got = out["scenarios"][name][policy]
        assert got["fire_steps"] == np.flatnonzero(want.lb_fired).tolist()
        modeled = float(j_cost.series_modeled_seconds(
            want, j_runtime.MODEL).sum())
        np.testing.assert_allclose(got["modeled_seconds"], modeled,
                                   rtol=1e-5)
