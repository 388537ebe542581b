"""Chrome-trace / Perfetto export of a recorded replay (counterpart of
``repro.obs.trace_export``; host NumPy, no device work).

``export_chrome_trace`` turns a
:class:`~repro_torch.obs.telemetry.TelemetrySnapshot` into a Chrome Trace
Event JSON object (openable at ``ui.perfetto.dev`` or
``chrome://tracing``):

  * one counter lane per node/shard with its load over time (full level;
    at ``counters`` level the max/avg/p95 aggregate lanes stand in),
  * LB fires, plan rejections and fault injections as instant events,
  * executed migrations as flow events between the sender and receiver
    node lanes (derived from the per-node load deltas at fired steps),
  * one duration slice per replay step on a dedicated "steps" lane.

``validate_chrome_trace`` is the format checker the tests and
``chip_smoke.py`` share: required keys per event phase, non-decreasing timestamps,
and matched flow-event ids.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs import telemetry

#: Wall-time scale of the synthetic timeline: one replay step = 1 ms.
US_PER_STEP = 1000

_PID = 0
_TID_STEPS = 0      # per-step duration slices
_TID_EVENTS = 1     # fires / rejections / faults
_TID_NODE0 = 10     # node lanes start here (tid = _TID_NODE0 + node)


def _meta(name: str, pid: int, tid: Optional[int], value: str) -> Dict:
    ev = {"name": name, "ph": "M", "pid": pid, "ts": 0,
          "args": {"name": value}}
    if tid is not None:
        ev["tid"] = tid
    return ev


def export_chrome_trace(
    snap: telemetry.TelemetrySnapshot,
    *,
    path: Optional[str] = None,
    label: str = "lb-replay",
    us_per_step: int = US_PER_STEP,
) -> Dict:
    """Build (and optionally write) the Chrome Trace Event JSON object."""
    t_col = snap.column("t").astype(np.int64)
    fired = snap.column("fired") > 0.5
    rejected = snap.column("plan_rejected") > 0.5
    faults = snap.column("health_changed") > 0.5
    moved_items = snap.column("moved_items")
    moved_bytes = snap.column("moved_bytes")
    nl = snap.node_loads   # (N, P) or None

    events: List[Dict] = [_meta("process_name", _PID, None, label),
                          _meta("thread_name", _PID, _TID_STEPS, "steps"),
                          _meta("thread_name", _PID, _TID_EVENTS, "lb-events")]
    if nl is not None:
        for p in range(nl.shape[1]):
            events.append(_meta("thread_name", _PID, _TID_NODE0 + p,
                                f"node/{p:03d}"))

    flow_id = 0
    body: List[Dict] = []
    for i, t in enumerate(t_col):
        ts = int(t) * us_per_step
        body.append({"name": f"step {int(t)}", "ph": "X", "pid": _PID,
                     "tid": _TID_STEPS, "ts": ts, "dur": us_per_step,
                     "args": {"fired": bool(fired[i]),
                              "sweeps": float(snap.records[i][
                                  telemetry.FIELDS.index("sweeps")])}})
        # load lanes: per node at level="full", aggregates otherwise
        if nl is not None:
            for p in range(nl.shape[1]):
                body.append({"name": f"node/{p:03d} load", "ph": "C",
                             "pid": _PID, "tid": _TID_NODE0 + p, "ts": ts,
                             "args": {"load": float(nl[i, p])}})
        for field in ("max_load", "avg_load", "p95_load"):
            body.append({"name": field, "ph": "C", "pid": _PID,
                         "tid": _TID_EVENTS, "ts": ts,
                         "args": {field: float(snap.column(field)[i])}})
        if fired[i]:
            body.append({"name": "lb-fire", "ph": "i", "s": "p",
                         "pid": _PID, "tid": _TID_EVENTS, "ts": ts,
                         "args": {"moved_items": float(moved_items[i]),
                                  "moved_bytes": float(moved_bytes[i])}})
        if rejected[i]:
            body.append({"name": "plan-rejected", "ph": "i", "s": "p",
                         "pid": _PID, "tid": _TID_EVENTS, "ts": ts,
                         "args": {}})
        if faults[i]:
            body.append({"name": "fault-injection", "ph": "i", "s": "p",
                         "pid": _PID, "tid": _TID_EVENTS, "ts": ts,
                         "args": {"transitions": float(
                             snap.column("health_changed")[i])}})
        # executed migrations as flows between node lanes: at a fired
        # step, load leaving one lane and arriving at another is the
        # migration the exchange executed
        if nl is not None and fired[i] and i > 0:
            delta = nl[i] - nl[i - 1]
            eps = 1e-6 * max(1.0, float(np.abs(nl[i]).max()))
            senders = np.where(delta < -eps)[0]
            receivers = np.where(delta > eps)[0]
            if len(senders) and len(receivers):
                top_rx = int(receivers[np.argmax(delta[receivers])])
                half = max(1, us_per_step // 2)
                for s in senders:
                    # anchor slices on both lanes so the flow arrows have
                    # something to bind to in Perfetto
                    body.append({"name": "migrate-out", "ph": "X",
                                 "pid": _PID, "tid": _TID_NODE0 + int(s),
                                 "ts": ts, "dur": half,
                                 "args": {"load_delta": float(delta[s])}})
                    body.append({"name": "migrate-in", "ph": "X",
                                 "pid": _PID, "tid": _TID_NODE0 + top_rx,
                                 "ts": ts + half, "dur": half,
                                 "args": {"load_delta": float(
                                     delta[top_rx])}})
                    body.append({"name": "migration", "ph": "s",
                                 "id": flow_id, "pid": _PID,
                                 "tid": _TID_NODE0 + int(s), "ts": ts,
                                 "args": {}})
                    body.append({"name": "migration", "ph": "f",
                                 "bp": "e", "id": flow_id, "pid": _PID,
                                 "tid": _TID_NODE0 + top_rx,
                                 "ts": ts + half, "args": {}})
                    flow_id += 1

    body.sort(key=lambda e: (e["ts"], 0 if e["ph"] != "f" else 1))
    trace = {
        "traceEvents": events + body,
        "displayTimeUnit": "ms",
        "otherData": {
            "telemetry_level": snap.config.level,
            "steps_recorded": int(len(snap.records)),
            "steps_total": int(snap.steps_total),
            "dropped": int(snap.dropped),
        },
    }
    if path:
        with open(path, "w") as f:
            json.dump(trace, f, indent=None, separators=(",", ":"))
            f.write("\n")
    return trace


def validate_chrome_trace(trace: Dict) -> List[str]:
    """Check a trace object against the Chrome Trace Event format.

    Returns a list of human-readable violations (empty == valid):
    required keys per event, non-decreasing timestamps over the
    non-metadata stream, and flow ids appearing as exactly one matched
    ``s``/``f`` pair with start ≤ finish.
    """
    errors: List[str] = []
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        return ["trace must be a dict with a 'traceEvents' list"]
    events = trace["traceEvents"]
    if not isinstance(events, list) or not events:
        return ["'traceEvents' must be a non-empty list"]

    last_ts = None
    flows: Dict[int, Dict[str, List[int]]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i} is not an object")
            continue
        for key in ("name", "ph", "pid", "ts"):
            if key not in ev:
                errors.append(f"event {i} ({ev.get('name')!r}) missing {key!r}")
        ph = ev.get("ph")
        if ph == "M":
            continue
        if "tid" not in ev:
            errors.append(f"event {i} ({ev.get('name')!r}) missing 'tid'")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"event {i} has bad ts {ts!r}")
            continue
        if last_ts is not None and ts < last_ts:
            errors.append(
                f"event {i} ts {ts} decreases (previous {last_ts})")
        last_ts = ts
        if ph == "C" and not isinstance(ev.get("args"), dict):
            errors.append(f"counter event {i} missing args dict")
        if ph == "X" and ev.get("dur", -1) < 0:
            errors.append(f"slice event {i} missing non-negative dur")
        if ph == "i" and ev.get("s") not in ("g", "p", "t"):
            errors.append(f"instant event {i} has bad scope {ev.get('s')!r}")
        if ph in ("s", "f"):
            if "id" not in ev:
                errors.append(f"flow event {i} missing id")
            else:
                flows.setdefault(ev["id"], {"s": [], "f": []}).setdefault(
                    ph, []).append(int(ts))

    for fid, ends in sorted(flows.items()):
        if len(ends["s"]) != 1 or len(ends["f"]) != 1:
            errors.append(
                f"flow id {fid} has {len(ends['s'])} starts / "
                f"{len(ends['f'])} finishes (want exactly 1 of each)")
        elif ends["s"][0] > ends["f"][0]:
            errors.append(
                f"flow id {fid} finishes (ts {ends['f'][0]}) before it "
                f"starts (ts {ends['s'][0]})")
    return errors
