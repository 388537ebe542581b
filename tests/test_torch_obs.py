"""Observability of the port (``obs.telemetry``, ``obs.trace_export``,
``obs.metrics``) against the JAX package on the CPU.

The contracts, as in ``tests/test_obs.py``:

  * **off is free**: ``telemetry="off"`` or ``None`` leaves every replay
    loop (``run_series``' two, the PIC driver's, the fleet replay's two)
    bit for bit a run without the argument, issues the same sequence of
    PyTorch operations (so the same launches on a card) and attaches no
    snapshot;
  * **recording is passive**: ``counters`` and ``full`` change no output;
  * the records equal the JAX package's on the same run: integer fields
    (step, fired, trigger kind, sweeps, moved items, deferred) exactly,
    float fields within ``RTOL`` (p95 interpolates in each framework's
    own order of operations);
  * the ring keeps the last ``ring`` records in order and counts drops,
    as the JAX package's does on the same rows;
  * an exported trace passes both packages' ``validate_chrome_trace``.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tests._hyp import given, settings, st

from repro.obs import telemetry as j_obs
from repro.obs import trace_export as j_trace
from repro.pic import driver as j_driver
from repro.serve import replay as j_sr
from repro.sim import scenarios as j_scen
from repro.sim import simulator as j_sim
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs import telemetry as t_obs
from repro_torch.obs import trace_export as t_trace
from repro_torch.pic import driver as t_driver
from repro_torch.serve import replay as t_sr
from repro_torch.sim import scenarios as t_scen
from repro_torch.sim import simulator as t_sim

CPU = "cpu"
RTOL = 1e-5
#: StepRecord fields that hold counts and ids: equal to the JAX package's
EXACT = ("t", "fired", "trigger_kind", "plan_rejected", "sweeps",
         "moved_items", "deferred", "health_changed")

SERIES_FIELDS = ("max_avg", "ext_int", "migrations", "lb_fired",
                 "max_load", "migrated_load", "final_assignment")
PIC_FIELDS = ("max_avg", "ext_bytes", "int_bytes", "migrations",
              "migrated_bytes", "lb_steps", "final_x", "final_y")
SERVE_FIELDS = ("max_avg", "lb_fired", "moved_sessions", "moved_kv_bytes",
                "prefix_local", "deferred", "occ_max", "final_uid",
                "final_replica", "final_kv")


class _Ops(TorchDispatchMode):
    """Records every PyTorch operation dispatched under it, in order (on a
    card each is a launch or a copy)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _traced(fn):
    with _Ops() as rec:
        out = fn()
    return out, rec.ops


def _assert_bitwise(ref, got, fields):
    for f in fields:
        a, b = getattr(ref, f), getattr(got, f)
        if a is None and b is None:
            continue
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b),
            err_msg=f"telemetry changed replay output {f}")


def _assert_same_run(fn, fields):
    """``fn(telemetry)`` with no argument, ``"off"`` and ``None``: equal
    outputs, equal operation sequences, no snapshot (after a first run
    that fills the caches: workload tables, window bounds)."""
    fn({})
    base, ops = _traced(lambda: fn({}))
    for kw in (dict(telemetry="off"), dict(telemetry=None)):
        got, got_ops = _traced(lambda: fn(kw))
        assert got.telemetry is None
        _assert_bitwise(base, got, fields)
        assert got_ops == ops, "telemetry off issued other operations"
    assert len(ops) > 0


def _assert_records_match(got, want):
    """Port and JAX snapshots of the same run."""
    assert got.steps_total == want.steps_total
    assert got.dropped == want.dropped
    assert got.records.shape == want.records.shape
    for f in t_obs.FIELDS:
        if f in EXACT:
            np.testing.assert_array_equal(got.column(f), want.column(f),
                                          err_msg=f)
        else:
            np.testing.assert_allclose(got.column(f), want.column(f),
                                       rtol=RTOL, err_msg=f)
    if want.node_loads is None:
        assert got.node_loads is None
    else:
        np.testing.assert_allclose(got.node_loads, want.node_loads,
                                   rtol=RTOL)


def _sim_case():
    kw = dict(steps=14, lb_every=4, strategy="diff-comm",
              strategy_kwargs=dict(k=2))
    tp, tev = t_scen.get("stencil-wave").instantiate(device=CPU, grid=8,
                                                     num_nodes=4)
    jp, jev = j_scen.get("stencil-wave").instantiate(grid=8, num_nodes=4)
    return (tp, tev), (jp, jev), kw


def _pic_kw(**kw):
    base = dict(L=100, n_particles=2000, steps=12, k=1, rho=0.9, cx=10,
                cy=10, num_pes=4, mapping="striped", lb_every=4,
                strategy="diff-comm", strategy_kwargs=dict(k=2), seed=0)
    base.update(kw)
    return base


def _serve_wl(pkg):
    return pkg.ServeWorkload(num_sessions=32, num_replicas=4)


# --------------------------------------- off-parity: every replay loop --


@pytest.mark.parametrize("scan", [True, False])
def test_sim_off_parity(scan):
    (tp, tev), _, kw = _sim_case()
    _assert_same_run(
        lambda extra: t_sim.run_series(tp, tev, scan=scan, **kw, **extra),
        SERIES_FIELDS)


def test_sim_host_loop_full_matches_device_loop_records():
    """The two loops record the same rows: counts exactly, loads within
    ``RTOL`` (the JAX package holds its scanned and sharded records
    equal)."""
    (tp, tev), _, kw = _sim_case()
    dev = t_sim.run_series(tp, tev, scan=True, telemetry="full", **kw)
    host = t_sim.run_series(tp, tev, scan=False, telemetry="full", **kw)
    _assert_records_match(host.telemetry, dev.telemetry)


def test_pic_off_parity():
    _assert_same_run(
        lambda extra: t_driver.run(t_driver.PICConfig(
            **_pic_kw(**extra), device=CPU)), PIC_FIELDS)


@pytest.mark.parametrize("scan", [True, False])
def test_serve_off_parity(scan):
    w = _serve_wl(t_sr)
    _assert_same_run(
        lambda extra: t_sr.run_serve_replay(
            w, steps=16, lb_every=4, scan=scan, device=CPU, **extra),
        SERVE_FIELDS)


# ------------------------------------ recording is passive + complete --


@pytest.mark.parametrize("level", ["counters", "full"])
def test_sim_full_recording_is_passive(level):
    (tp, tev), (jp, jev), kw = _sim_case()
    base = t_sim.run_series(tp, tev, scan=True, **kw)
    rec = t_sim.run_series(tp, tev, scan=True, telemetry=level, **kw)
    _assert_bitwise(base, rec, SERIES_FIELDS)
    snap = rec.telemetry
    assert snap is not None and snap.config.level == level
    assert snap.steps_total == kw["steps"] and snap.dropped == 0
    assert snap.records.shape == (kw["steps"], len(t_obs.FIELDS))
    np.testing.assert_array_equal(snap.column("t"), np.arange(kw["steps"]))
    np.testing.assert_array_equal(snap.column("fired"),
                                  np.asarray(base.lb_fired, np.float32))
    if level == "full":
        assert snap.node_loads.shape == (kw["steps"], tp.num_nodes)
        np.testing.assert_allclose(snap.node_loads.mean(axis=1),
                                   snap.column("avg_load"), rtol=1e-5)
    else:
        assert snap.node_loads is None
    want = j_sim.run_series(jp, jev, scan=True, telemetry=level, **kw)
    _assert_records_match(snap, want.telemetry)


@pytest.mark.parametrize("path", ["serve", "serve-predictive", "pic"])
def test_full_snapshot_on_other_paths(path):
    """Full records of the fleet replay and the PIC driver equal the JAX
    replays' (``EXACT`` fields exactly, loads within ``RTOL``)."""
    if path == "pic":
        res = t_driver.run(t_driver.PICConfig(
            **_pic_kw(telemetry="full"), device=CPU))
        want = j_driver.run(j_driver.PICConfig(**_pic_kw(
            telemetry="full"), scan=True))
        fired = res.lb_steps
    else:
        kw = dict(steps=16, lb_every=4, telemetry="full")
        if path == "serve-predictive":
            kw.update(strategy="diff-comm+predictive", steps=24,
                      slot_capacity=10)
        res = t_sr.run_serve_replay(_serve_wl(t_sr), device=CPU, **kw)
        want = j_sr.run_serve_replay(_serve_wl(j_sr), **kw)
        fired = res.lb_fired
    snap = res.telemetry
    assert snap is not None and snap.dropped == 0
    assert snap.column("fired").sum() == np.asarray(fired).sum() > 0
    assert (snap.column("moved_items") > 0).any()
    _assert_records_match(snap, want.telemetry)


# ------------------------------------------------- config resolution --


def test_resolve_levels():
    assert not t_obs.resolve(None).enabled
    assert not t_obs.resolve("off").enabled
    assert t_obs.enabled_or_none("off") is None
    c = t_obs.resolve("counters")
    assert c.enabled and not c.full
    f = t_obs.resolve("full")
    assert f.enabled and f.full
    cfg = t_obs.TelemetryConfig(level="full", ring=7)
    assert t_obs.resolve(cfg) is cfg
    with pytest.raises(ValueError):
        t_obs.resolve("verbose")
    with pytest.raises(ValueError):
        t_obs.TelemetryConfig(level="full", ring=0)
    assert t_obs.FIELDS == j_obs.FIELDS
    assert t_obs.TRIGGER_KINDS == j_obs.TRIGGER_KINDS


# --------------------------------------------- ring wraparound (prop) --


@settings(max_examples=20, deadline=None)
@given(steps=st.integers(min_value=1, max_value=30),
       ring=st.integers(min_value=1, max_value=13))
def test_ring_keeps_last_records_chronologically(steps, ring):
    P = 3
    cfg = t_obs.TelemetryConfig(level="full", ring=ring)
    state = t_obs.init_state(cfg, P)
    for t in range(steps):
        state = t_obs.record(
            state, cfg, t=t,
            node_loads=torch.arange(P, dtype=torch.float32) + t,
            fired=float(t % 2), sweeps=torch.tensor(float(t)))
    snap = t_obs.snapshot(state, cfg)
    kept = min(steps, ring)
    assert snap.steps_total == steps
    assert snap.dropped == max(0, steps - ring)
    assert snap.records.shape == (kept, len(t_obs.FIELDS))
    expect_t = np.arange(steps)[-kept:]
    np.testing.assert_array_equal(snap.column("t"), expect_t)
    np.testing.assert_array_equal(snap.column("sweeps"), expect_t)
    np.testing.assert_array_equal(snap.node_loads[:, 0],
                                  expect_t.astype(np.float32))


def test_record_and_snapshot_match_jax():
    """``record`` and ``snapshot`` on the same rows (random loads, a ring
    that wraps) give the JAX package's snapshot."""
    rng = np.random.default_rng(0)
    P, steps = 7, 11
    rows = rng.random((steps, P)).astype(np.float32) * 50
    for level in ("counters", "full"):
        tcfg = t_obs.TelemetryConfig(level=level, ring=8)
        jcfg = j_obs.TelemetryConfig(level=level, ring=8)
        ts, js = t_obs.init_state(tcfg, P), j_obs.init_state(jcfg, P)
        for t in range(steps):
            kw = dict(fired=float(t % 3 == 0), trigger_kind=2,
                      sweeps=float(t), moved_items=float(2 * t),
                      moved_bytes=float(t) * 1.5, deferred=float(t % 2))
            ts = t_obs.record(ts, tcfg, t=t,
                              node_loads=torch.as_tensor(rows[t]), **kw)
            js = j_obs.record(js, jcfg, t=jnp.int32(t),
                              node_loads=jnp.asarray(rows[t]), **kw)
        _assert_records_match(t_obs.snapshot(ts, tcfg),
                              j_obs.snapshot(js, jcfg))


# ------------------------------------------------- metrics registry --


@settings(max_examples=20, deadline=None)
@given(n=st.integers(min_value=1, max_value=50),
       inc=st.integers(min_value=0, max_value=9))
def test_counter_monotone(n, inc):
    reg = t_metrics.MetricsRegistry()
    c = reg.counter("x")
    prev = c.value
    assert prev == 0
    for _ in range(n):
        c.inc(inc)
        assert c.value >= prev
        prev = c.value
    assert c.value == n * inc


def test_counter_rejects_negative_and_gauge_does_not():
    reg = t_metrics.MetricsRegistry()
    with pytest.raises(ValueError):
        reg.counter("x").inc(-1)
    reg.gauge("g").set(-5.0)
    assert reg.snapshot()["g"] == -5.0


def test_registry_snapshot_and_reset():
    reg = t_metrics.MetricsRegistry()
    reg.counter("a").inc()
    reg.counter("a").inc(2)
    reg.gauge("b").set(1.5)
    assert reg.snapshot() == {"a": 3, "b": 1.5}
    reg.reset()
    assert reg.snapshot() == {}


def test_default_registry_helpers():
    t_metrics.reset()
    t_metrics.counter("t/c").inc(4)
    t_metrics.gauge("t/g").set(2.0)
    snap = t_metrics.snapshot()
    assert snap["t/c"] == 4 and snap["t/g"] == 2.0
    t_metrics.reset()
    assert "t/c" not in t_metrics.snapshot()


# ----------------------------------------------------- trace export --


def _full_snapshot():
    (tp, tev), _, kw = _sim_case()
    res = t_sim.run_series(tp, tev, scan=True, telemetry="full", **kw)
    assert res.lb_fired.sum() > 0
    return res


def test_chrome_trace_valid_and_complete(tmp_path):
    res = _full_snapshot()
    path = tmp_path / "trace.json"
    trace = t_trace.export_chrome_trace(res.telemetry, path=str(path),
                                        label="test-replay")
    reread = json.loads(path.read_text())
    for tr in (trace, reread):
        assert t_trace.validate_chrome_trace(tr) == []
        assert j_trace.validate_chrome_trace(tr) == []
    ev = trace["traceEvents"]
    names = [e["name"] for e in ev]
    assert "node/000 load" in names and "node/003 load" in names
    fires = [e for e in ev if e["name"] == "lb-fire"]
    assert len(fires) == int(res.lb_fired.sum())
    slices = [e for e in ev if e["ph"] == "X" and
              e["name"].startswith("step ")]
    assert len(slices) == len(res.telemetry.records)
    starts = [e for e in ev if e["ph"] == "s"]
    finishes = [e for e in ev if e["ph"] == "f"]
    assert len(starts) == len(finishes) > 0
    assert trace["otherData"]["telemetry_level"] == "full"
    assert trace["otherData"]["dropped"] == 0
    # the JAX exporter given the same records writes the same trace
    s = res.telemetry
    jsnap = j_obs.TelemetrySnapshot(
        config=j_obs.TelemetryConfig(level="full", ring=s.config.ring),
        records=s.records, node_loads=s.node_loads,
        steps_total=s.steps_total)
    assert j_trace.export_chrome_trace(jsnap, label="test-replay") == trace


def test_counters_level_trace_uses_aggregate_lanes():
    (tp, tev), _, kw = _sim_case()
    res = t_sim.run_series(tp, tev, scan=True, telemetry="counters", **kw)
    trace = t_trace.export_chrome_trace(res.telemetry)
    assert t_trace.validate_chrome_trace(trace) == []
    assert j_trace.validate_chrome_trace(trace) == []
    names = {e["name"] for e in trace["traceEvents"]}
    assert "max_load" in names and "p95_load" in names
    assert not any(n.startswith("node/") for n in names)


def test_validator_flags_corruption():
    res = _full_snapshot()
    trace = t_trace.export_chrome_trace(res.telemetry)

    bad = json.loads(json.dumps(trace))
    del [e for e in bad["traceEvents"] if e["ph"] != "M"][0]["ts"]
    assert any("missing 'ts'" in e for e in
               t_trace.validate_chrome_trace(bad))

    bad = json.loads(json.dumps(trace))
    bad["traceEvents"].append({"name": "migration", "ph": "s",
                               "id": 999_999, "pid": 0, "tid": 1,
                               "ts": bad["traceEvents"][-1]["ts"]})
    assert any("flow id 999999" in e for e in
               t_trace.validate_chrome_trace(bad))

    assert t_trace.validate_chrome_trace({}) != []
    assert t_trace.validate_chrome_trace({"traceEvents": []}) != []
