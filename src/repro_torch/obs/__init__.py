"""Observability (counterpart of ``repro.obs``):

  * :mod:`repro_torch.obs.telemetry` — the StepRecord ring written by
    every replay loop behind a ``TelemetryConfig(level=off|counters|full)``
    knob, where ``off`` (the default) changes nothing;
  * :mod:`repro_torch.obs.trace_export` — a recorded run as Chrome-trace /
    Perfetto JSON (load lanes per node, LB fires as instant events,
    executed migrations as flow events) and its format checker;
  * :mod:`repro_torch.obs.metrics` — the host-side counters/gauges
    registry the launchers report through.
"""
from repro_torch.obs.telemetry import (  # noqa: F401
    FIELDS,
    TelemetryConfig,
    TelemetrySnapshot,
    TelemetryState,
    init_state,
    node_loads,
    record,
    snapshot,
    trigger_kind,
)
from repro_torch.obs import metrics  # noqa: F401
from repro_torch.obs.trace_export import (  # noqa: F401
    export_chrome_trace,
    validate_chrome_trace,
)
