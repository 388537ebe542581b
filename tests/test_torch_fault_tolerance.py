"""The port's fault tolerance (``train.fault_tolerance``): the supervised
restart loop, heartbeats and the straggler balancer, against the JAX
package on the CPU (``tests/test_fault_tolerance.py`` without the
training test, which needs the training slice)."""
import numpy as np
import pytest

from repro.train import fault_tolerance as j_ft
from repro_torch.train import fault_tolerance as ft

CPU = "cpu"


def _supervised(mod, fail_at, max_restarts=8):
    state = dict(x=0.0, saved=(0, 0.0))
    pending = set(fail_at)

    def step_fn(step):
        if step in pending:
            pending.discard(step)
            raise mod.WorkerFailure(f"injected at {step}")
        state["x"] += 1.0

    def save_fn(step):
        state["saved"] = (step, state["x"])

    def restore_fn():
        step, x = state["saved"]
        state["x"] = x
        return step

    out = mod.run_resilient(step_fn, start_step=0, num_steps=20,
                            save_every=5, save_fn=save_fn,
                            restore_fn=restore_fn, max_restarts=max_restarts)
    return out, state["x"]


def test_run_resilient_recovers_and_completes():
    out, x = _supervised(ft, {7, 13})
    assert out == dict(final_step=20, restarts=2)
    assert x == 20.0, "a recovered run must be exactly-once in effect"
    assert (out, x) == _supervised(j_ft, {7, 13})


def test_run_resilient_gives_up_after_max_restarts():
    seen = []

    def step_fn(step):
        raise ft.WorkerFailure("always")

    with pytest.raises(ft.WorkerFailure):
        ft.run_resilient(step_fn, start_step=0, num_steps=5, save_every=5,
                         save_fn=lambda s: None, restore_fn=lambda: 0,
                         max_restarts=3,
                         on_failure=lambda s, e: seen.append(s))
    assert seen == [0, 0, 0, 0]


def test_heartbeat_detects_dead_hosts():
    mons = [ft.HeartbeatMonitor(num_hosts=8, timeout_steps=2),
            j_ft.HeartbeatMonitor(num_hosts=8, timeout_steps=2)]
    for mon in mons:
        for step in range(6):
            for h in range(8):
                if h == 3 and step >= 2:
                    continue               # host 3 dies at step 2
                mon.beat(h, step)
    assert mons[0].dead_hosts(current_step=5) == [3]
    assert mons[0].healthy_mesh_size(5) == 4   # largest pow2 <= 7
    assert mons[0].dead_hosts(5) == mons[1].dead_hosts(5)


def test_straggler_balancer_sheds_from_slow_host_as_jax():
    bal = ft.StragglerBalancer(num_hosts=4, shards_per_host=8, device=CPU)
    ref = j_ft.StragglerBalancer(num_hosts=4, shards_per_host=8)
    times = np.array([1.0, 1.0, 1.0, 2.0])
    info = None
    for _ in range(30):
        got = bal.observe(times)
        want = ref.observe(times)
        assert (got is None) == (want is None)
        if got is not None:
            assert got["moved_shards"] == want["moved_shards"]
        info = got or info
    assert info is not None, "a persistent straggler must trigger"
    share = bal.host_share()
    assert share[3] < 0.25, f"the slow host keeps {share[3]:.2f} of the data"
    assert abs(share.sum() - 1.0) < 1e-9
    np.testing.assert_array_equal(bal.shard_assignment,
                                  ref.shard_assignment)


def test_straggler_balancer_ignores_noise():
    bal = ft.StragglerBalancer(num_hosts=4, shards_per_host=8, ema=0.9,
                               device=CPU)
    rng = np.random.default_rng(0)
    fired = False
    for _ in range(20):
        fired = fired or (bal.observe(np.ones(4) + rng.normal(0, 0.02, 4))
                          is not None)
    assert not fired, "2% noise must not trigger data movement"
    assert ft.StragglerBalancer(num_hosts=2).device == "cuda"
