"""The port's serving path against the JAX package on the CPU: the
``ServeEngine`` (continuous batching, EOS at admission) on carried
weights, and the ``DiffusionScheduler`` with its on-device pieces
(``prefix_group_edges``, ``migrate``/``moved_sum``, ``spill_owner``),
mirroring ``tests/test_serve.py``.

Engines compute in f32 (``compute_dtype="float32"``) so that greedy
tokens compare the algorithm, not bf16 rounding in two frameworks;
tokens, tick counts and ``done`` order must be identical.  Scheduler
integers (replicas, fire steps, moved counts) are exact and its floats
within 1e-6 relative."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import comm_graph as j_cg
from repro.models import transformer as jt
from repro.models.params import init_params as j_init
from repro.runtime import migrate as j_mig
from repro.runtime.cost import RuntimeCostModel as JCost
from repro.runtime.triggers import PredictiveTrigger as JPredictive
from repro.serve import engine as j_eng
from repro.serve import scheduler as j_sch
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.core import comm_graph as t_cg
from repro_torch.models import transformer as tt
from repro_torch.runtime import migrate as t_mig
from repro_torch.runtime.cost import RuntimeCostModel as TCost
from repro_torch.runtime.triggers import PredictiveTrigger as TPredictive
from repro_torch.serve import engine as t_eng
from repro_torch.serve import scheduler as t_sch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def models():
    """Reduced smollm-135m and gemma3-1b in f32: JAX weights (seed 0) and
    the same weights as the port's CPU parameters."""
    out = {}
    for arch in ("smollm-135m", "gemma3-1b"):
        jcfg = dataclasses.replace(j_get_arch(arch).reduced,
                                   compute_dtype="float32")
        tcfg = dataclasses.replace(get_arch(arch).reduced,
                                   compute_dtype="float32")
        jp = j_init(jt.model_specs(jcfg), 0)
        out[arch] = (jcfg, jp, tcfg, interop.params_from_numpy(
            jax.tree.map(np.asarray, jp), tcfg, "cpu"))
    return out


def _engines(models, arch, **scfg):
    jcfg, jp, tcfg, tp = models[arch]
    return (j_eng.ServeEngine(jcfg, jp, j_eng.ServeConfig(**scfg)),
            t_eng.ServeEngine(tcfg, tp, t_eng.ServeConfig(**scfg),
                              device="cpu"))


def _submit(engines, uid, prompt, **kw):
    engines[0].submit(j_eng.Request(uid=uid, prompt=prompt, **kw))
    engines[1].submit(t_eng.Request(uid=uid, prompt=prompt, **kw))


def _same(engines):
    je, te = engines
    assert [(r.uid, r.out) for r in te.done] == \
        [(r.uid, r.out) for r in je.done]
    assert te.ticks == je.ticks


def _drain_five(models, eng):
    rng = np.random.default_rng(0)
    for i in range(5):
        _submit(eng, i, rng.integers(1, 512, 4 + i), max_new_tokens=6)
    for e in eng:
        e.run_until_drained()
    assert len(eng[1].done) == 5
    assert all(len(r.out) == 6 for r in eng[1].done)


def _join_mid_flight(models, eng):
    rng = np.random.default_rng(1)
    _submit(eng, 0, rng.integers(1, 512, 4), max_new_tokens=10)
    for e in eng:
        e.tick()
        e.tick()
    # join while request 0 is mid-decode
    _submit(eng, 1, rng.integers(1, 512, 4), max_new_tokens=3)
    for e in eng:
        e.run_until_drained()
    assert {r.uid for r in eng[1].done} == {0, 1}


def _eos_at_admission(models, eng):
    # one-token requests finish at admission and leave the slot to the
    # next queued request in the same pass
    rng = np.random.default_rng(3)
    for i in range(3):
        _submit(eng, i, rng.integers(1, 512, 4), max_new_tokens=1)
    _submit(eng, 3, rng.integers(1, 512, 4), max_new_tokens=4)
    for e in eng:
        e._admit()
    assert {r.uid for r in eng[1].done} == {0, 1, 2}
    assert eng[1].slot_req[0] is not None and eng[1].slot_req[0].uid == 3
    for e in eng:
        e.run_until_drained()
    assert len([r for r in eng[1].done if r.uid == 3][0].out) == 4


def _eos_token_at_prefill(models, eng):
    prompt = np.random.default_rng(4).integers(1, 512, 5)
    probe = _engines(models, "smollm-135m", num_slots=1, max_len=64)[1]
    probe.submit(t_eng.Request(uid=0, prompt=prompt, max_new_tokens=1))
    first = probe.run_until_drained()[0].out[0]
    _submit(eng, 1, prompt, max_new_tokens=16, eos_id=first)
    for e in eng:
        e.run_until_drained()
    assert eng[1].done[0].out == [first] and eng[1].ticks == 0


def _window_ring_wraps(models, eng):
    # gemma's 16-token window: prompts up to the window, decode past it
    rng = np.random.default_rng(5)
    for i, n in enumerate((16, 13, 9)):
        _submit(eng, i, rng.integers(1, 512, n), max_new_tokens=12)
    for e in eng:
        e.run_until_drained()


@pytest.mark.parametrize("scenario,arch,slots", [
    (_drain_five, "smollm-135m", 2),
    (_join_mid_flight, "smollm-135m", 2),
    (_eos_at_admission, "smollm-135m", 1),
    (_eos_token_at_prefill, "smollm-135m", 1),
    (_window_ring_wraps, "gemma3-1b", 2),
], ids=lambda x: getattr(x, "__name__", str(x)).strip("_"))
def test_engine_matches_jax(models, scenario, arch, slots):
    """The same requests on carried weights: identical tokens, tick counts
    and ``done`` order (the scenarios of the JAX engine tests)."""
    eng = _engines(models, arch, num_slots=slots, max_len=64)
    scenario(models, eng)
    _same(eng)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "hymba-1.5b",
                                  "xlstm-125m"])
def test_engine_serves_every_block_kind_as_jax(arch):
    """MLA + MoE, hymba (windowed GQA + mamba state) and xLSTM (mLSTM and
    sLSTM states) under continuous batching: three requests on two slots,
    the third joining mid-flight into a slot another request left, so its
    prefill must overwrite every cache field of the slot (``kv``, ``ssm``,
    ``state``); hymba's prompts fill its 16-token window and decode past
    it.  Identical tokens, tick counts and ``done`` order to the JAX
    engine on carried weights (f32)."""
    jcfg = dataclasses.replace(j_get_arch(arch).reduced,
                               compute_dtype="float32")
    tcfg = dataclasses.replace(get_arch(arch).reduced,
                               compute_dtype="float32")
    jp = j_init(jt.model_specs(jcfg), 0)
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    eng = (j_eng.ServeEngine(jcfg, jp, j_eng.ServeConfig(num_slots=2,
                                                         max_len=40)),
           t_eng.ServeEngine(tcfg, tp, t_eng.ServeConfig(num_slots=2,
                                                         max_len=40),
                             device="cpu"))
    rng = np.random.default_rng(6)
    _submit(eng, 0, rng.integers(1, 512, 16), max_new_tokens=14)
    _submit(eng, 1, rng.integers(1, 512, 9), max_new_tokens=3)
    for e in eng:
        for _ in range(4):
            e.tick()
    _submit(eng, 2, rng.integers(1, 512, 12), max_new_tokens=8)
    for e in eng:
        e.run_until_drained()
    assert [r.uid for r in eng[1].done] == [1, 2, 0]
    _same(eng)


def test_engine_decode_matches_dedicated_decode(models):
    """Engine output for one request == plain prefill + decode_step."""
    _, _, cfg, params = models["smollm-135m"]
    prompt = np.random.default_rng(2).integers(1, cfg.vocab_size, 6)
    eng = t_eng.ServeEngine(cfg, params, t_eng.ServeConfig(num_slots=1,
                                                           max_len=32),
                            device="cpu")
    eng.submit(t_eng.Request(uid=0, prompt=prompt, max_new_tokens=5))
    out = eng.run_until_drained()[0].out
    cache = tt.init_cache(cfg, 1, 32, torch.float32, "cpu")
    logits, cache = tt.prefill(params, cfg, dict(
        tokens=torch.tensor(prompt[None]),
        positions=torch.arange(6, dtype=torch.int32)[None]), cache)
    toks = [int(torch.argmax(logits[0, -1]))]
    for i in range(4):
        lg, cache = tt.decode_step(params, cfg, torch.tensor([[toks[-1]]]),
                                   6 + i, cache)
        toks.append(int(torch.argmax(lg[0, 0])))
    assert out == toks


# ------------------------------------------------------ device pieces --


@pytest.mark.parametrize("S,seed", [(8, 0), (37, 1), (64, 2)])
def test_prefix_group_edges_exact(S, seed):
    rng = np.random.default_rng(seed)
    group = np.where(rng.random(S) < 0.2, -1,
                     rng.integers(0, max(1, S // 4), S)).astype(np.int32)
    loads = (rng.random(S) * 3 + 1e-3).astype(np.float32)
    for active in (None, rng.random(S) < 0.8):
        want = j_cg.prefix_group_edges(
            jnp.asarray(group), jnp.asarray(loads),
            None if active is None else jnp.asarray(active))
        got = t_cg.prefix_group_edges(
            torch.tensor(group), torch.tensor(loads),
            None if active is None else torch.tensor(active))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_migrate_and_moved_sum_exact():
    rng = np.random.default_rng(0)
    n, P = 64, 3
    old = rng.integers(0, P, n).astype(np.int32)
    new = np.where(rng.random(n) < 0.4, rng.integers(0, P, n),
                   old).astype(np.int32)
    kv = (rng.random(n) * 100).astype(np.float32)
    live = rng.random(n) < 0.7
    (jk,), jm = j_mig.migrate(old, new, [kv], num_nodes=P)
    (tk,), tm = t_mig.migrate(torch.tensor(old), torch.tensor(new),
                              [torch.tensor(kv)], num_nodes=P)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tm.order.numpy(), np.asarray(jm.order))
    assert float(tm.moved_sum(torch.tensor(kv), where=torch.tensor(live))) \
        == pytest.approx(float(jm.moved_sum(kv, where=live)), rel=1e-6)
    assert float(tm.moved_bytes(2.5)) == float(jm.moved_bytes(2.5))


@pytest.mark.parametrize("P,cap,seed", [(2, 8, 0), (3, 5, 1), (5, 4, 2),
                                        (6, 9, 3), (33, 6, 4), (40, 5, 5)])
def test_spill_owner_and_admissions_exact(P, cap, seed):
    rng = np.random.default_rng(seed)
    n = P * cap - 2
    old = np.sort(rng.integers(0, P, n)).astype(np.int32)
    occ = np.bincount(old, minlength=P)
    old = np.repeat(np.arange(P, dtype=np.int32), np.minimum(occ, cap))
    new = np.where(rng.random(len(old)) < 0.6, rng.integers(0, P, len(old)),
                   old).astype(np.int32)
    je, jd = j_mig.spill_owner(old, new, num_nodes=P, capacity=cap)
    te, td = t_mig.spill_owner(torch.tensor(old), torch.tensor(new),
                               num_nodes=P, capacity=cap)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    flow = rng.integers(0, 4, (P, P)).astype(np.int32)
    occ = rng.integers(0, cap + 1, P).astype(np.int32)
    np.testing.assert_array_equal(
        t_mig.spill_admissions(torch.tensor(flow), torch.tensor(occ),
                               cap).numpy(),
        np.asarray(j_mig.spill_admissions(flow, occ, cap)))


# -------------------------------------------------------- scheduler --


def _both_schedulers(R, **kw):
    return j_sch.DiffusionScheduler(R, **kw), \
        t_sch.DiffusionScheduler(R, device="cpu", **kw)


def _add(scheds, **kw):
    for s, mod in zip(scheds, (j_sch, t_sch)):
        s.add(mod.Session(**kw))


def _same_store(scheds):
    js, ts = scheds
    assert ts.sessions == {u: t_sch.Session(**dataclasses.asdict(x))
                           for u, x in js.sessions.items()}
    np.testing.assert_array_equal(ts._uid, js._uid)
    np.testing.assert_array_equal(ts._replica, js._replica)


INFO_INTS = ("moved_sessions", "deferred_sessions", "protocol_rounds",
             "diffusion_iters")
INFO_FLOATS = ("moved_kv_bytes", "prefix_local", "max_avg_load",
               "ext_int_comm", "pct_migrations")


def _same_info(got, want):
    for key in INFO_INTS:
        assert got[key] == want[key], key
    for key in INFO_FLOATS:
        assert got[key] == pytest.approx(want[key], rel=1e-6, abs=1e-9), key


def test_place_new_matches_jax():
    """Prefix affinity (a group lands on one replica) and the least-loaded
    peer rule, replica for replica."""
    scheds = _both_schedulers(4)
    for i in range(8):
        got = [s.place_new(mod.Session(uid=i, replica=0, tokens_per_s=1.0,
                                       prefix_group=i % 2))
               for s, mod in zip(scheds, (j_sch, t_sch))]
        assert got[0] == got[1]
    _add(scheds, uid=20, replica=0, tokens_per_s=9.0, prefix_group=7)
    _add(scheds, uid=21, replica=2, tokens_per_s=1.0, prefix_group=7)
    for uid, g in ((22, 7), (23, 99)):
        got = [s.place_new(mod.Session(uid=uid, replica=-1,
                                       tokens_per_s=1.0, prefix_group=g))
               for s, mod in zip(scheds, (j_sch, t_sch))]
        assert got[0] == got[1]
    _same_store(scheds)
    np.testing.assert_array_equal(scheds[1].replica_loads(),
                                  scheds[0].replica_loads())


@pytest.mark.parametrize("case", ["all-on-one", "kv-sizes", "two-halves"])
def test_rebalance_matches_jax(case):
    """The executed rebalance: every session's replica and slot, the
    moved sessions and KV bytes, prefix locality and the plan's metrics
    equal JAX's."""
    rng = np.random.default_rng(7)
    if case == "all-on-one":       # adversarial: everything on replica 0
        scheds = _both_schedulers(4, k=3)
        for i in range(24):
            _add(scheds, uid=i, replica=0,
                 tokens_per_s=float(rng.integers(1, 4)), prefix_group=i // 3)
    elif case == "kv-sizes":
        scheds = _both_schedulers(4, k=3)
        for i in range(40):
            _add(scheds, uid=100 + i, replica=int(rng.integers(0, 2)),
                 tokens_per_s=float(rng.uniform(0.1, 5.0)),
                 prefix_group=i // 5, kv_bytes=float(rng.uniform(10, 200)))
    else:
        scheds = _both_schedulers(4, k=3)
        for i in range(32):
            _add(scheds, uid=i, replica=i % 2, tokens_per_s=1.0 + (i % 5),
                 prefix_group=i // 4)
    before = scheds[1].replica_loads()
    want, got = (s.rebalance(strategy="diff-comm") for s in scheds)
    _same_info(got, want)
    _same_store(scheds)
    after = scheds[1].replica_loads()
    assert after.max() / after.mean() < before.max() / before.mean()


def test_rebalance_slot_capacity_matches_jax():
    """Moves past the per-replica budget are deferred, never dropped."""
    scheds = _both_schedulers(2)
    for i in range(12):
        _add(scheds, uid=i, replica=0, tokens_per_s=1.0)
    want, got = (s.rebalance(strategy="diff-comm", slot_capacity=8)
                 for s in scheds)
    _same_info(got, want)
    _same_store(scheds)
    occ = np.bincount([x.replica for x in scheds[1].sessions.values()],
                      minlength=2)
    assert occ.max() <= 8 and len(scheds[1].sessions) == 12


def test_rebalance_slot_capacity_40_replicas_matches_jax():
    """A slot budget at 40 replicas (41^2 pair buckets in the spill):
    heavy sessions on the first half of the replicas, the second half full
    of light ones, so the moves into full replicas are deferred; every
    record equals JAX's."""
    R, cap = 40, 10
    scheds = _both_schedulers(R, k=3)
    rng = np.random.default_rng(7)
    uid = 0
    for r in range(R):
        for _ in range(5 if r < R // 2 else cap):
            _add(scheds, uid=uid, replica=r, prefix_group=uid // 5,
                 tokens_per_s=float(rng.uniform(3, 5) if r < R // 2
                                    else rng.uniform(0.2, 0.6)),
                 kv_bytes=float(rng.uniform(10, 200)))
            uid += 1
    want, got = (s.rebalance(strategy="diff-comm", slot_capacity=cap)
                 for s in scheds)
    _same_info(got, want)
    _same_store(scheds)
    assert got["deferred_sessions"] > 0
    occ = np.bincount([x.replica for x in scheds[1].sessions.values()],
                      minlength=R)
    assert occ.max() <= cap and len(scheds[1].sessions) == uid


def test_maybe_rebalance_fire_steps_match_jax():
    """The predictive trigger on executed KV: the fire steps of both
    gates (measured and estimate-only) equal JAX's, and the measured one
    fires less often."""
    def drive(sched, mod, trig, cost):
        rng = np.random.default_rng(11)
        for i in range(24):
            sched.add(mod.Session(uid=i, replica=0,
                                  tokens_per_s=float(rng.uniform(0.5, 4.0)),
                                  prefix_group=i // 3,
                                  kv_bytes=float(rng.uniform(50.0, 100.0))))
        fires = []
        for _ in range(12):
            info = sched.maybe_rebalance(trigger=trig, lb_every=2, cost=cost)
            fires.append(info["fired"])
            for uid, sess in sched.sessions.items():
                if sess.replica == 0:
                    sched.add(mod.Session(
                        uid=uid, replica=0,
                        tokens_per_s=sess.tokens_per_s + 2.0,
                        prefix_group=sess.prefix_group,
                        kv_bytes=sess.kv_bytes))
        return fires

    kw = dict(t_load=1.0, t_byte=50.0, bytes_per_load=1e-4,
              moved_frac_est=1e-6)
    out = {}
    for measured in (True, False):
        js, ts = _both_schedulers(4, k=3)
        want = drive(js, j_sch, JPredictive(cost=JCost(**kw),
                                            measured_gate=measured),
                     JCost(**kw))
        got = drive(ts, t_sch, TPredictive(cost=TCost(**kw),
                                           measured_gate=measured),
                    TCost(**kw))
        assert got == want
        out[measured] = sum(got)
    assert 1 <= out[True] < out[False]


def test_fleet_problem_and_prefix_locality_match_jax():
    """The fleet slabs, the problem built on them (floored edge weights),
    and prefix locality, against JAX; the store survives a grow/remove."""
    scheds = _both_schedulers(3, capacity=4)   # forces a _grow
    for i in range(9):
        _add(scheds, uid=i * 10, replica=i % 3, tokens_per_s=float(i),
             prefix_group=i % 2, kv_bytes=2.0 * i)
    for s in scheds:
        s.remove(30)
    _same_store(scheds)
    jp, tp = scheds[0].problem(), scheds[1].problem()
    for f in ("loads", "assignment", "edges_src", "edges_dst",
              "edges_bytes"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)))
    assert float(tp.loads.min()) >= 1e-3
    jf, tf = scheds[0].fleet(), scheds[1].fleet()
    np.testing.assert_array_equal(tf.group.numpy(), np.asarray(jf.group))
    assert float(t_sch.prefix_locality(tf)) == pytest.approx(
        float(j_sch.prefix_locality(jf)), rel=1e-6)
    split = torch.where(tf.uid < 40, 0, 1)
    assert float(t_sch.prefix_locality(tf, assignment=split)) == \
        pytest.approx(float(j_sch.prefix_locality(
            jf, assignment=jnp.asarray(split.numpy()))), rel=1e-6)


def test_launcher_runs_on_cpu():
    """``python -m repro_torch.launch.serve --device cpu`` serves the
    reduced model through the scheduler to its end."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "6", "--max-new", "5"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "served 6 requests, 30 tokens" in out.stdout
