"""Render an ``ObsRecorder`` into Perfetto-loadable Chrome trace JSON.

Counterpart of ``repro/obs/trace_export.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_obs.py``
holds the two equal.

Output is the Trace Event Format's JSON *object* flavor — an object with a
``traceEvents`` array plus ``otherData`` — which https://ui.perfetto.dev
and chrome://tracing both open directly.  Times are simulated seconds
scaled to microseconds (the format's native unit).

Track layout (process / thread rows in the viewer):

  pid 1 "tenants"       one row per tenant: ``queued`` admission-wait slice,
                        ``stall:<cause>`` slices, ``op<i>`` compute slices,
                        ``collective@<i>`` slices, and instant events for
                        admission / finish / unschedulable plus
                        renegotiation staged→applied flow arrows.
  pid 2 "dma channels"  one row per (device, channel): ``in:v<var>`` /
                        ``out:v<var>`` swap-transfer slices, plus a
                        ``dma busy [<device>]`` counter of concurrently
                        busy channels per device.
  pid 3 "host link"     one row per lane with the same transfers as seen by
                        the shared link, a merged ``blackout`` row for
                        collective occupancy, and a ``lanes busy`` counter.
  pid 4 "hbm"           counter tracks: ``HBM [<device>]`` total pool
                        occupancy and ``resident [<tenant>]`` per tenant,
                        sampled once per executed op.

Every slice on one row is non-overlapping by construction (tenant time is
sequential; channels and lanes are serialized by the engine's ``free_at``
bookkeeping; blackout windows are merged here) — the reference's
``tools/check_trace.py`` validates exactly that, plus the attribution-ledger
sum, on the embedded report.
"""

from __future__ import annotations

import json

from .recorder import ObsRecorder

TRACE_SCHEMA_VERSION = 1

_US = 1e6  # simulated seconds -> trace microseconds

PID_TENANTS = 1
PID_DMA = 2
PID_LINK = 3
PID_MEM = 4
PID_ALERTS = 5

LEGEND = {
    "tracks": {
        "tenants": "per-tenant rows: queued | stall:<cause> | op<i> | collective@<i>",
        "dma channels": "per-(device, channel) swap transfers: in:v<var> / out:v<var>",
        "host link": "per-lane transfers + merged collective 'blackout' row",
        "hbm": "counters: HBM [<device>] pool totals, resident [<tenant>]",
        "alerts": "per-SLO rows of instant events from the streaming monitor "
                  "(burn-rate and asymmetry crossings; args carry slo/kind/value)",
    },
    "stall_causes": {
        "swap_in_wait": "compute blocked on an in-flight (or late) swap-in",
        "swap_out_drain": "malloc delayed until a pending swap-out freed headroom",
        "barrier_drain": "iteration barrier draining this tenant's in-flight transfers",
    },
    "attribution": {
        "swap_in_transfer_s": "stall seconds covered by the swap-in moving bytes",
        "link_blackout_s": "stall seconds the transfer was shifted past collective blackouts",
        "channel_contention_s": "stall seconds the transfer queued for a DMA channel/link lane",
        "swap_out_pending_s": "stall seconds waiting for the variable's own swap-out first",
        "swap_out_drain_s": "malloc-delay seconds waiting on pending swap-outs",
        "barrier_drain_s": "iteration-barrier drain seconds",
        "collective_excess_s": "collective seconds charged beyond the baseline-folded windows",
        "residual_s": "float-closure term; the ledger sums exactly to overhead seconds",
    },
}


def _dev(device) -> str:
    return "default" if device is None else str(device)


def _merged(intervals: list) -> list:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _busy_counter(spans, pid: int, name: str, series: str) -> list:
    """Counter samples from +1/-1 edges of possibly-concurrent spans."""
    edges: list[tuple[float, int]] = []
    for s, e in spans:
        edges.append((s, 1))
        edges.append((e, -1))
    edges.sort()
    events, busy, prev_t = [], 0, None
    for t, d in edges:
        if prev_t is not None and t != prev_t:
            events.append({"ph": "C", "pid": pid, "name": name,
                           "ts": prev_t * _US, "args": {series: busy}})
        busy += d
        prev_t = t
    if prev_t is not None:
        events.append({"ph": "C", "pid": pid, "name": name,
                       "ts": prev_t * _US, "args": {series: busy}})
    return events


def chrome_trace(recorder: ObsRecorder, report=None) -> dict:
    """Build the trace object.  ``report`` (a ``RuntimeReport``, or its
    ``as_dict()``) embeds under ``otherData.report`` so one file carries the
    timeline *and* the attribution ledger ``check_trace`` validates."""
    ev: list[dict] = []
    meta: list[dict] = []

    def proc(pid: int, name: str) -> None:
        meta.append({"ph": "M", "pid": pid, "name": "process_name",
                     "args": {"name": name}})
        meta.append({"ph": "M", "pid": pid, "name": "process_sort_index",
                     "args": {"sort_index": pid}})

    def thread(pid: int, tid: int, name: str) -> None:
        meta.append({"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                     "args": {"name": name}})
        meta.append({"ph": "M", "pid": pid, "tid": tid,
                     "name": "thread_sort_index", "args": {"sort_index": tid}})

    proc(PID_TENANTS, "tenants")
    proc(PID_DMA, "dma channels")
    proc(PID_LINK, "host link")
    proc(PID_MEM, "hbm")

    # ------------------------------------------------------------- tenants
    tids = {name: i + 1 for i, name in enumerate(recorder.tenant_names())}
    for name, tid in tids.items():
        thread(PID_TENANTS, tid, name)

    for name, device, arrival_t, admit_t in recorder.admissions:
        tid = tids[name]
        if admit_t > arrival_t:
            ev.append({"ph": "X", "pid": PID_TENANTS, "tid": tid, "name": "queued",
                       "ts": arrival_t * _US, "dur": (admit_t - arrival_t) * _US,
                       "args": {"device": _dev(device)}})
        ev.append({"ph": "i", "s": "t", "pid": PID_TENANTS, "tid": tid,
                   "name": "admitted", "ts": admit_t * _US,
                   "args": {"device": _dev(device)}})
    for name, arrival_t in recorder.unschedulables:
        ev.append({"ph": "i", "s": "t", "pid": PID_TENANTS, "tid": tids[name],
                   "name": "unschedulable", "ts": arrival_t * _US})
    for name, device, t in recorder.finishes:
        if name in tids:
            ev.append({"ph": "i", "s": "t", "pid": PID_TENANTS, "tid": tids[name],
                       "name": "finished", "ts": t * _US})

    for name, device, i, t0, t1, resident, total in recorder.ops:
        ev.append({"ph": "X", "pid": PID_TENANTS, "tid": tids[name],
                   "name": f"op{i}", "ts": t0 * _US, "dur": (t1 - t0) * _US})
    for name, device, i, t0, seconds in recorder.collectives:
        ev.append({"ph": "X", "pid": PID_TENANTS, "tid": tids[name],
                   "name": f"collective@{i}", "ts": t0 * _US,
                   "dur": seconds * _US})
    for name, device, cause, t0, seconds, var in recorder.stalls:
        ev.append({"ph": "X", "pid": PID_TENANTS, "tid": tids[name],
                   "name": f"stall:{cause}", "ts": t0 * _US,
                   "dur": seconds * _US, "args": {"var": var}})

    # Renegotiation lifecycle: instants on the victim's row plus a flow
    # arrow from each staged event to the barrier where it applied.
    flow_id = 0
    pending: dict[str, int] = {}
    for kind, victim, t, value in recorder.renegotiations:
        tid = tids.get(victim)
        if tid is None:
            continue
        args = {"staged": {"new_limit": value}, "applied": {"freed_bytes": value},
                "cancelled": {}}[kind]
        ev.append({"ph": "i", "s": "t", "pid": PID_TENANTS, "tid": tid,
                   "name": f"renegotiation {kind}", "ts": t * _US, "args": args})
        if kind == "staged":
            flow_id += 1
            pending[victim] = flow_id
            ev.append({"ph": "s", "id": flow_id, "pid": PID_TENANTS, "tid": tid,
                       "name": "renegotiation", "ts": t * _US})
        elif victim in pending:
            ev.append({"ph": "f", "bp": "e", "id": pending.pop(victim),
                       "pid": PID_TENANTS, "tid": tid,
                       "name": "renegotiation", "ts": t * _US})

    # ------------------------------------------------- dma channels + link
    chan_tids: dict[tuple, int] = {}
    for rec in recorder.transfers:
        key = (_dev(rec[1]), rec[6])
        if key not in chan_tids:
            chan_tids[key] = len(chan_tids) + 1
    for (dev, ch), tid in sorted(chan_tids.items(), key=lambda kv: kv[1]):
        thread(PID_DMA, tid, f"{dev}/ch{ch}")

    lane_tids: dict[int, int] = {}
    dev_spans: dict[str, list] = {}
    lane_spans: list = []
    for name, device, direction, var, start, end, ch, lane, ready_t, size in recorder.transfers:
        dev = _dev(device)
        ev.append({"ph": "X", "pid": PID_DMA, "tid": chan_tids[(dev, ch)],
                   "name": f"{direction}:v{var}", "ts": start * _US,
                   "dur": (end - start) * _US,
                   "args": {"tenant": name, "bytes": size,
                            "queued_us": (start - ready_t) * _US}})
        dev_spans.setdefault(dev, []).append((start, end))
        if lane is not None:
            if lane not in lane_tids:
                lane_tids[lane] = lane + 2  # tid 1 is the blackout row
            ev.append({"ph": "X", "pid": PID_LINK, "tid": lane_tids[lane],
                       "name": f"{direction}:v{var}", "ts": start * _US,
                       "dur": (end - start) * _US,
                       "args": {"tenant": name, "device": dev, "bytes": size}})
            lane_spans.append((start, end))
    for dev, spans in sorted(dev_spans.items()):
        ev.extend(_busy_counter(spans, PID_DMA, f"dma busy [{dev}]", "channels"))
    if recorder.blackouts or lane_spans:
        thread(PID_LINK, 1, "blackouts")
        for lane, tid in sorted(lane_tids.items()):
            thread(PID_LINK, tid, f"lane{lane}")
        for s, e in _merged(recorder.blackouts):
            ev.append({"ph": "X", "pid": PID_LINK, "tid": 1, "name": "blackout",
                       "ts": s * _US, "dur": (e - s) * _US})
        if lane_spans:
            ev.extend(_busy_counter(lane_spans, PID_LINK, "lanes busy", "lanes"))

    # -------------------------------------------------------- hbm counters
    last_dev: dict[str, int] = {}
    last_res: dict[str, int] = {}
    for name, device, i, t0, t1, resident, total in recorder.ops:
        dev = _dev(device)
        if last_dev.get(dev) != total:
            last_dev[dev] = total
            ev.append({"ph": "C", "pid": PID_MEM, "name": f"HBM [{dev}]",
                       "ts": t1 * _US, "args": {"bytes": total}})
        if last_res.get(name) != resident:
            last_res[name] = resident
            ev.append({"ph": "C", "pid": PID_MEM, "name": f"resident [{name}]",
                       "ts": t1 * _US, "args": {"bytes": resident}})

    # ------------------------------------------------------- alerts (pid 5)
    # Present only for monitored recorders (repro.obs.monitor); a plain
    # ObsRecorder has no ``alerts`` and the track is simply absent.
    alerts = getattr(recorder, "alerts", ())
    slo_specs = getattr(recorder, "slo_specs", None)
    if alerts:
        proc(PID_ALERTS, "alerts")
        slo_tids: dict[str, int] = {}
        for a in alerts:
            if a.slo not in slo_tids:
                slo_tids[a.slo] = len(slo_tids) + 1
                thread(PID_ALERTS, slo_tids[a.slo], a.slo)
            ev.append({"ph": "i", "s": "p", "pid": PID_ALERTS,
                       "tid": slo_tids[a.slo], "name": f"alert:{a.kind}",
                       "ts": a.t * _US,
                       "args": {"slo": a.slo, "kind": a.kind, "value": a.value,
                                "threshold": a.threshold}})

    ev.sort(key=lambda e: (e["ts"], e.get("dur", 0.0)))
    if hasattr(recorder, "finalize"):
        recorder.finalize()  # idempotent: folds monitor gauges into metrics
    other = {
        "schema_version": TRACE_SCHEMA_VERSION,
        "legend": LEGEND,
        "metrics": recorder.metrics.snapshot(),
    }
    if slo_specs is not None:
        other["slos"] = [s.as_dict() for s in slo_specs]
    monitor = getattr(recorder, "monitor", None)
    if monitor is not None:
        other["monitor"] = {"quantiles": monitor.quantile_summary(),
                            "alerts": [a.as_dict() for a in alerts]}
    if report is not None:
        other["report"] = report if isinstance(report, dict) else report.as_dict()
    return {
        "traceEvents": meta + ev,
        "displayTimeUnit": "ms",
        "otherData": other,
    }


def write_trace(path: str, recorder: ObsRecorder, report=None) -> dict:
    """Write ``chrome_trace(recorder, report)`` to ``path`` (compact JSON —
    these files are meant for Perfetto and ``check_trace``, not for eyes).
    Returns the trace object."""
    trace = chrome_trace(recorder, report)
    with open(path, "w") as f:
        json.dump(trace, f, separators=(",", ":"))
    return trace
