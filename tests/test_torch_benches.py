"""The port's runtime, replay-shard, obs and engine benches and its bench
orchestrator (``benchmarks_torch/``) on the CPU: their constants against
the JAX scripts', the runtime bench's PIC section and gates, the
replay-shard bench's parity and resilience gates over ShardMesh(8), the
obs bench's ``off`` level bit for bit a run without telemetry, the engine
bench's loop parity, and ``run.py``'s failure handling — at reduced
step counts.  The runtime bench's replays against the JAX package's are
in ``test_torch_runtime_bench.py``."""
import json

import numpy as np
import pytest
import torch

from benchmarks import engine_bench as j_engine
from benchmarks import obs_bench as j_obs
from benchmarks import replay_shard_bench as j_replay
from benchmarks import runtime_bench as j_runtime
from benchmarks_torch import common
from benchmarks_torch import engine_bench as t_engine
from benchmarks_torch import obs_bench as t_obs
from benchmarks_torch import replay_shard_bench as t_replay
from benchmarks_torch import run as t_run
from benchmarks_torch import runtime_bench as t_runtime
from repro_torch.sim import scenarios, simulator

STEPS = 40


@pytest.fixture(autouse=True)
def _artifacts(tmp_path, monkeypatch):
    """Bench results go to a temporary directory."""
    monkeypatch.setattr(common, "ARTIFACTS", tmp_path)


@pytest.fixture(autouse=True)
def _one_thread():
    # many small CPU ops: one intra-op thread beside other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_constants_are_the_jax_scripts():
    """Cost model, policies, gated scenarios, gates, sizes and schema
    strings copied unchanged."""
    for f in ("t_load", "t_byte", "bytes_per_load", "lb_overhead"):
        assert getattr(t_runtime.MODEL, f) == getattr(j_runtime.MODEL, f)
    assert [p for p, _ in t_runtime.POLICIES] == [
        p for p, _ in j_runtime.POLICIES]
    pred = dict(t_runtime.POLICIES)["predictive"]
    assert pred.cost == t_runtime.MODEL
    assert t_runtime.GATED == j_runtime.GATED
    assert t_runtime.SCHEMA == j_runtime.SCHEMA
    assert t_obs.GATES == j_obs.GATES and t_obs.LEVELS == j_obs.LEVELS
    assert t_obs.REPEATS == j_obs.REPEATS == 9
    assert t_obs.SCHEMA == j_obs.SCHEMA
    assert t_replay.SERIES_FIELDS == j_replay.SERIES_FIELDS
    assert t_replay.PIC_FIELDS == j_replay.PIC_FIELDS
    assert t_replay.SCHEMA == j_replay.SCHEMA
    assert t_replay.DEGRADE_BOUND == 3.0
    assert t_engine.SCHEMA == j_engine.SCHEMA
    assert (t_engine.SPEEDUP_GATE, t_engine.BATCH_SPEEDUP_GATE) == (5.0, 4.0)
    assert t_engine.SMALL == {
        "stencil-wave": dict(grid=16, num_nodes=16),
        "pic-geometric": dict(cx=8, cy=8, num_pes=8, n_particles=10_000.0),
        "adversarial-hotspot": dict(grid=16, num_nodes=16),
        "bimodal-churn": dict(grid=16, num_nodes=16)}


def test_runtime_bench_gates_and_pic_section():
    """The PIC section conserves particles under the three policies and
    reports its manifest method; the gates name each gated pair and fail
    where a policy does not beat the fixed cadence."""
    out = t_runtime.bench_pic({}, steps=20, n_particles=4000, device="cpu",
                              repeats=1)
    assert out["pic"]["manifest_method"] in ("sort", "scatter")
    assert [k for k in out["pic"] if k != "manifest_method"] == [
        "every", "threshold", "predictive"]
    out["scenarios"] = {n: {p: dict(modeled_seconds=m) for p, m in zip(
        ("every", "threshold", "predictive"), (10.0, 9.0, 10.0))}
        for n in t_runtime.GATED}
    g = t_runtime.gates(out)
    assert g["bimodal-churn: threshold < every"][0]
    assert not g["bimodal-churn: predictive < every"][0]
    assert all(g[f"pic {p}: particles conserved"][0]
               for p in ("every", "threshold", "predictive"))
    with pytest.raises(AssertionError, match="must beat the fixed cadence"):
        t_runtime.check(out)


def test_replay_shard_bench_gates_hold_over_eight_shards():
    """Every scenario bit for bit over ShardMesh(8) (4 for pic-geometric's
    4 nodes), the PIC run and the resilience section: their gates hold."""
    out = {}
    t_replay.bench_scenarios(out, steps=STEPS, device="cpu", repeats=1)
    t_replay.bench_pic(out, steps=20, n_particles=4000, device="cpu",
                       repeats=1)
    t_replay.bench_resilience(out, steps=60, pic_steps=30, n_particles=4000,
                              device="cpu")
    assert {n: r["num_shards"] for n, r in out["scenarios"].items()} == {
        n: (4 if n == "pic-geometric" else 8) for n in scenarios.available()}
    assert out["pic"]["num_shards"] == 8
    assert out["resilience"]["num_shards"] == 8
    gates = t_replay.gates(out)
    assert len(gates) == len(out["scenarios"]) + 2 + 5
    assert all(h for h, _ in gates.values()), {
        k: m for k, (h, m) in gates.items() if not h}
    assert out["resilience"]["peak_inflation"] < t_replay.DEGRADE_BOUND


def test_num_shards_is_the_jax_rule_for_eight_devices():
    assert [t_replay.num_shards(m) for m in (16, 8, 4, 6, 12, 1)] == [
        8, 8, 4, 6, 6, 1]
    assert t_replay.num_shards(20_000, 8) == 8
    assert t_replay.num_shards(4000, 6) == 2


def test_obs_off_is_a_run_without_telemetry():
    """``telemetry="off"`` gives the bits of a run without the argument on
    both paths the obs bench times; the bench's sections report each
    level's seconds and overhead."""
    from repro_torch.serve import replay as sr

    prob, ev = scenarios.get("stencil-wave").instantiate(
        grid=16, num_nodes=16, device="cpu")
    kw = dict(steps=24, lb_every=10, strategy="diff-comm",
              strategy_kwargs=dict(k=8), scan=True)
    a = simulator.run_series(prob, ev, telemetry="off", **kw)
    b = simulator.run_series(prob, ev, **kw)
    for f in ("max_avg", "ext_int", "migrations", "lb_fired", "max_load",
              "migrated_load", "final_assignment"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.telemetry is None
    w = sr.ServeWorkload(num_sessions=64, num_replicas=8)
    skw = dict(steps=30, lb_every=10, strategy="diff-comm+predictive",
               device="cpu")
    a = sr.run_serve_replay(w, telemetry="off", **skw)
    b = sr.run_serve_replay(w, **skw)
    for f in ("lb_fired", "max_avg", "moved_kv_bytes", "final_replica"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    out = {}
    t_obs.bench_sim(out, P=16, K=4, grid=16, steps=12, device="cpu",
                    repeats=1)
    t_obs.bench_serve(out, sessions=64, replicas=8, ticks=12, device="cpu",
                      repeats=1)
    assert set(out) == {"sim-scan", "serve-scan"}
    for r in out.values():
        assert set(r["seconds"]) == set(t_obs.LEVELS)
        assert r["gates"] == {"counters": 0.05, "full": 0.15}
    assert len(t_obs.gates(out)) == 4
    for r in out.values():
        r["overhead"] = {"counters": 0.0, "full": 0.15}
    t_obs.check(out)                    # at the bounds: holds
    out["sim-scan"]["overhead"]["full"] = 0.16
    with pytest.raises(AssertionError, match="full"):
        t_obs.check(out)


def test_engine_bench_loops_agree():
    """The host loop and the device-resident loop plan alike, and every
    batched lane equals its single replay; the speed gates are the JAX
    script's 5x and 4x."""
    out = {}
    t_engine.bench_series(out, P=16, K=4, steps=24, grid=16, lb_every=10,
                          device="cpu", repeats=1)
    t_engine.bench_batch(out, batch=6, steps=10, device="cpu", repeats=1)
    assert out["series"]["parity"] and out["batch"]["parity"]
    assert out["batch"]["scenarios"] == sorted(scenarios.available())
    g = t_engine.gates(out)
    assert list(g) == ["series parity", "series speedup >= 5.0",
                       "batch parity", "batch speedup >= 4.0"]
    assert g["series speedup >= 5.0"][0] == (out["series"]["speedup"] >= 5)
    out["series"]["speedup"] = 4.99
    with pytest.raises(AssertionError, match=">=5x"):
        t_engine.check(out)


def test_engine_bench_pic_section_times_the_one_loop():
    out = t_engine.bench_pic({}, n_particles=2000, steps=12, device="cpu",
                             repeats=1)
    assert out["pic"]["host_seconds"] is None
    assert out["pic"]["scanned_seconds"] > 0


def test_write_bench_json_stays_under_artifacts(tmp_path):
    path = common.write_bench_json(
        "runtime", schema="runtime-bench/v3", generated_by="x",
        env=common.environment("cpu"), repeats=1, scenarios={})
    rec = json.loads(open(path).read())
    assert path == str(tmp_path / "BENCH_runtime.json")
    assert rec["schema"] == "runtime-bench/v3" and rec["repeats"] == 1
    assert rec["environment"]["device"] == "cpu"


def test_finish_writes_both_payloads_then_checks(tmp_path):
    """A bench's ending: the legacy and stable-schema payloads under
    artifacts (and ``--out``), then its gates, which fail loud."""
    def check(out):
        assert out["holds"], "gate failed"

    out_path = tmp_path / "o" / "out.json"
    common.finish("x_bench", dict(holds=True), bench="x", schema="x/v1",
                  device="cpu", repeats=2, check=check, out_path=out_path,
                  cost_model=dict(t=1.0))
    rec = json.loads((tmp_path / "BENCH_x.json").read_text())
    assert rec["schema"] == "x/v1" and rec["repeats"] == 2
    assert rec["generated_by"] == "benchmarks_torch/x_bench.py"
    assert rec["cost_model"] == dict(t=1.0) and rec["holds"] is True
    assert json.loads((tmp_path / "x_bench.json").read_text()) == dict(
        holds=True)
    assert json.loads(out_path.read_text()) == dict(holds=True)
    with pytest.raises(AssertionError, match="gate failed"):
        common.finish("x_bench", dict(holds=False), bench="x",
                      schema="x/v1", device="cpu", repeats=1, check=check)
    assert json.loads((tmp_path / "x_bench.json").read_text()) == dict(
        holds=False)


def test_bench_main_passes_its_arguments():
    calls = []

    def run(device, *, repeats, out_path):
        calls.append((device, repeats, out_path))

    common.bench_main(run, "doc", 9, ["--device", "cpu"])
    common.bench_main(run, "doc", 9, ["--repeats", "1", "--out", "f"])
    assert calls == [("cpu", 9, None), ("cuda", 1, "f")]


def test_run_has_the_jax_entries_and_fails_loud(monkeypatch, capsys):
    """The orchestrator's entries are the JAX script's; a failing entry
    prints its traceback and the run exits 1 naming it."""
    from benchmarks import run as j_run

    assert list(t_run.ALL) == list(j_run.ALL)
    calls = []

    def ok(device):
        calls.append(device)

    def bad(device):
        raise RuntimeError("boom")

    monkeypatch.setattr(t_run, "ALL", {"ok": ok, "bad": bad})
    t_run.main(["ok", "--device", "cpu"])
    assert calls == ["cpu"]
    with pytest.raises(SystemExit) as e:
        t_run.main(["bad", "ok", "--device", "cpu"])
    assert e.value.code == 1
    err = capsys.readouterr()
    assert "RuntimeError: boom" in err.err
    assert "FAILED: ['bad']" in err.out and calls == ["cpu", "cpu"]
