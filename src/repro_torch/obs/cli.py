"""Uniform observability flags for the launch CLIs.

Counterpart of ``repro/obs/cli.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_obs.py``
holds the two equal.

Every launcher that executes the runtime takes the same pair:

  --record-events / --no-record-events   the engine's per-transfer event
                                         logs (on by default; turn off for
                                         fleet-scale horizons)
  --trace-out PATH                       attach an ObsRecorder and write a
                                         Perfetto-loadable trace JSON here

``add_obs_args`` installs them, ``recorder_for`` builds the recorder (or
None) from the parsed args, and ``export_trace`` writes + announces the
file.  Keeping this in one place is what makes the flags *uniform* —
colocate and serve call these three helpers (the reference's shardplan and
train too).
"""

from __future__ import annotations

import argparse


def add_obs_args(ap: argparse.ArgumentParser, default_record: bool = True) -> None:
    ap.add_argument(
        "--record-events", action=argparse.BooleanOptionalAction,
        default=default_record,
        help="runtime per-transfer event logs (disable for long horizons)",
    )
    ap.add_argument(
        "--trace-out", default=None, metavar="PATH",
        help="write a Perfetto-loadable .trace.json of the runtime here",
    )
    ap.add_argument(
        "--verify", action="store_true",
        help="statically verify the run: sweep the solved plans "
             "(repro_torch.analyze.plan_check) and the recorded schedule "
             "(repro_torch.analyze.schedule_check); exit nonzero on any violation",
    )
    ap.add_argument(
        "--slo", action="append", default=None, metavar="SPEC",
        help="arm the streaming SLO monitor with this spec (repeatable), "
             "e.g. 'queue_wait.p99<0.005,prio=1' or "
             "'link.out_in_wait_ratio>3,low=1.5'; alerts print at exit and "
             "land in the trace's alerts track",
    )
    ap.add_argument(
        "--monitor-out", default=None, metavar="PATH",
        help="append the streaming-monitor summary (metrics + per-stream "
             "quantiles + alerts) as one JSONL record here",
    )


def recorder_for(args):
    """An ObsRecorder when ``--trace-out`` or ``--verify`` was given, else
    None.  ``--verify`` attaches one even without an output path: the
    recorder is a pure observer (reports stay bit-identical) and its streams
    are the race detector's richest input.  ``--slo`` / ``--monitor-out``
    upgrade it to a ``MonitoredRecorder`` with the streaming SLO monitor
    armed (still a pure observer)."""
    slos = getattr(args, "slo", None)
    if slos is not None or getattr(args, "monitor_out", None):
        from .monitor import MonitoredRecorder

        return MonitoredRecorder(slos=slos or ())
    if getattr(args, "trace_out", None) or getattr(args, "verify", False):
        from .recorder import ObsRecorder

        return ObsRecorder()
    return None


def export_trace(args, recorder, report) -> None:
    """Write the recorder to ``args.trace_out`` with ``report`` embedded."""
    if recorder is None or not getattr(args, "trace_out", None):
        return
    from .trace_export import write_trace

    trace = write_trace(args.trace_out, recorder, report)
    print(
        f"[obs] wrote {args.trace_out} ({len(trace['traceEvents'])} events; "
        f"open at https://ui.perfetto.dev)"
    )


def export_monitor(args, recorder, extra: dict | None = None) -> None:
    """Announce alerts and write the ``--monitor-out`` JSONL record for a
    ``MonitoredRecorder`` (no-op for a plain recorder or when the monitor
    was never armed)."""
    if recorder is None or not hasattr(recorder, "finalize"):
        return
    summary = recorder.finalize()
    alerts = summary["alerts"]
    if getattr(args, "slo", None):
        if alerts:
            print(f"[obs] {len(alerts)} SLO alert(s):")
            for a in alerts:
                print(f"[obs]   t={a['t']:.6f}s {a['slo']} {a['kind']} "
                      f"value={a['value']:.4g} threshold={a['threshold']:.4g}")
        else:
            print(f"[obs] SLO monitor: {len(summary['slos'])} spec(s) armed, "
                  "no alerts")
    out = getattr(args, "monitor_out", None)
    if out:
        record = {"monitor": summary}
        if extra:
            record.update(extra)
        recorder.metrics.append_jsonl(out, record)
        print(f"[obs] wrote monitor summary to {out}")
