"""repro_torch.obs: runtime observability for the memory engine.

Counterpart of ``repro/obs``, whose code this is, with its imports pointed
into ``repro_torch``; ``tests/test_torch_obs.py`` holds the two equal.
Left out: ``diffing`` (``load_run``/``diff_runs``/``format_diff``/``RunView``),
which waits with the reference's ``launch/obsdiff.py`` and
``launch/analyze.py`` for ROADMAP queue A9.

Pieces, all pure observers of ``runtime.MemoryRuntime``:

  metrics      — ``MetricsRegistry``: named counters/gauges with a JSONL
                 sink, cheap enough to leave attached on long horizons.
  recorder     — ``ObsRecorder``: the hook sink the engine calls when an
                 ``obs=`` recorder is attached (op spans, swap transfers,
                 stalls by cause, link blackouts, admissions,
                 renegotiations, HBM occupancy samples).  Detached
                 (``obs=None``, the default) the engine hot path pays one
                 predicate per event site — gated exactly like
                 ``record_events``.
  sketch       — ``QuantileSketch``: deterministic compacting-buffer
                 streaming quantiles with a self-reported rank-error bound
                 (``ExactDistribution`` is the post-hoc oracle).
  windows      — tumbling/sliding window counters and the hysteresis-banded
                 ``AsymmetryWindow`` over simulated time.
  monitor      — ``MonitoredRecorder``/``SLOMonitor``: streaming telemetry
                 over the hook path (per-class queue-wait, per-cause stall,
                 per-direction link-wait, HBM-headroom streams) plus
                 declarative SLOs (``parse_slo``) emitting typed ``Alert``
                 events.
  trace_export — ``chrome_trace``/``write_trace``: render a recorder into a
                 Chrome-trace-event JSON object that loads directly in
                 Perfetto (https://ui.perfetto.dev) with per-tenant op
                 slices, per-DMA-channel swap slices, host-link lane and
                 blackout tracks, renegotiation flow events, HBM occupancy
                 counter tracks, and an instant-event alerts track when a
                 monitored recorder carried SLO alerts.

The stall-attribution ledger itself (overhead seconds decomposed into named
causes, summing to each tenant's total overhead) is *always on* — it rides
in ``TenantReport.attribution``/``RuntimeReport.attribution`` whether or not
a recorder is attached; ``simulated_report_dict`` strips it alongside the
other non-reference fields.
"""

from .cli import add_obs_args, export_monitor, export_trace, recorder_for
from .metrics import Counter, Gauge, MetricsRegistry
from .monitor import (
    Alert,
    MonitoredRecorder,
    SLOMonitor,
    SLOSpec,
    parse_slo,
    priority_class,
)
from .recorder import ObsRecorder
from .sketch import ExactDistribution, QuantileSketch
from .trace_export import TRACE_SCHEMA_VERSION, chrome_trace, write_trace
from .windows import AsymmetryWindow, HysteresisBand, SlidingWindow, TumblingWindow

__all__ = [
    "Alert",
    "AsymmetryWindow",
    "Counter",
    "ExactDistribution",
    "Gauge",
    "HysteresisBand",
    "MetricsRegistry",
    "MonitoredRecorder",
    "ObsRecorder",
    "QuantileSketch",
    "SLOMonitor",
    "SLOSpec",
    "SlidingWindow",
    "TRACE_SCHEMA_VERSION",
    "TumblingWindow",
    "add_obs_args",
    "chrome_trace",
    "export_monitor",
    "export_trace",
    "parse_slo",
    "priority_class",
    "recorder_for",
    "write_trace",
]
