"""The port's fault tolerance (``train.fault_tolerance``): the supervised
restart loop, heartbeats and the straggler balancer, against the JAX
package on the CPU, and training that crashes, restores its checkpoint and
ends bit for bit where an uninterrupted run ends
(``tests/test_fault_tolerance.py``)."""
import tempfile

import numpy as np
import pytest
import torch

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


def test_resilient_training_bit_exact_after_crash():
    """Crash at step 6 of 10, restore the step-6 checkpoint from disk, go
    on: the final parameters equal 10 clean steps bit for bit."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer
    from repro_torch.models.params import init_params, tree_leaves
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train import train_step as ts_mod

    cfg = get_arch("smollm-135m").reduced
    params0 = init_params(transformer.model_specs(cfg), 0, CPU)
    opt0 = opt_mod.init(params0, device=CPU)
    step = ts_mod.make_train_step(
        cfg, opt_mod.OptConfig(warmup_steps=2, total_steps=50))
    rngb = np.random.default_rng(0)
    B, S = 2, 16
    batches = []
    for _ in range(10):
        t = rngb.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
        lbl = np.concatenate([t[:, 1:], np.full((B, 1), -1, np.int32)], 1)
        pos = np.ascontiguousarray(
            np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)))
        batches.append(dict(tokens=torch.as_tensor(t),
                            labels=torch.as_tensor(lbl),
                            positions=torch.as_tensor(pos)))

    p, o = params0, opt0
    for b in batches:
        p, o, _ = step(p, o, b)
    truth = tree_leaves(p)

    with tempfile.TemporaryDirectory() as d:
        run = dict(p=params0, o=opt0)
        crashed = dict(left=1)

        def step_fn(s):
            if s == 6 and crashed["left"]:
                crashed["left"] -= 1
                raise ft.WorkerFailure("boom")
            run["p"], run["o"], _ = step(run["p"], run["o"], batches[s])

        def save_fn(s):
            ckpt.save(d, s, run["p"], run["o"])

        def restore_fn():
            run["p"], run["o"], s, _ = ckpt.restore(d, run["p"], run["o"],
                                                    device=CPU)
            return s

        save_fn(0)
        out = ft.run_resilient(step_fn, start_step=0, num_steps=10,
                               save_every=2, save_fn=save_fn,
                               restore_fn=restore_fn)
        assert out == dict(final_step=10, restarts=1)
        for a, b in zip(truth, tree_leaves(run["p"])):
            assert torch.equal(a, b)
