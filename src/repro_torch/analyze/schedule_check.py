"""Event-log race detector: happens-before checks over simulated schedules.

Counterpart of ``repro/analyze/schedule_check.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_obs.py``
holds the two equal.

Input is any of the three event surfaces the runtime produces — a live
``ObsRecorder``, an exported Chrome trace file, or a finished runtime's
``record_events`` transfer logs — normalized into one ``ScheduleView`` and
swept by ``check_view``:

  channel_exclusive      transfers on one (device, channel) DMA queue never
                         overlap — the engine's ``free_at`` serialization
  lane_exclusive         transfers on one host-link lane never overlap
  blackout_exclusion     a swap-out transfer never overlaps a collective
                         blackout that was registered before the transfer
                         was acquired.  Observable registration order: a
                         swap-out's ``ready_t`` equals the acquiring
                         tenant's clock, and the event heap pops in
                         nondecreasing clock order, so ``blackout.start <
                         ready_t`` proves the blackout was already on the
                         link when ``next_clear`` placed the transfer.
                         Blackouts registered *after* acquisition may
                         legitimately overlap ("lagging tenants may still
                         schedule into earlier windows"), and swap-ins have
                         ``ready_t >= clock`` (they also wait on their own
                         swap-out), so only outs are checked.
  budget_monotone        when the accountant reported zero overflow events,
                         every sampled pool total respects the budget; all
                         samples respect the reported peaks unconditionally
  reservation_isolation  per-device admission floors — reconstructed from
                         admissions, finishes and applied renegotiations —
                         never sum past the budget, and no tenant is
                         admitted twice or before it arrived
  ledger_closure         every completed tenant's stall-attribution buckets
                         sum to its ``overhead_s``, and the aggregate
                         ledger is the per-key sum of the tenant ledgers

Everything is stdlib-only and duck-typed, so the sweep runs without
torch (``python -m repro_torch.launch.analyze``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from .certificate import Certificate, Violation

SCHEDULE_INVARIANTS = (
    "channel_exclusive",
    "lane_exclusive",
    "blackout_exclusion",
    "budget_monotone",
    "reservation_isolation",
    "ledger_closure",
)

# Attribution keys outside the sums-to-overhead closure (mirrors
# tools/check_trace.py): the total itself, admission queueing (precedes the
# overhead window) and host wall-clock.
LEDGER_INFORMATIONAL = {"overhead_s", "queue_wait_s", "renegotiation_solve_s"}

_US = 1e6


def _tol(x: float) -> float:
    return 1e-6 + 1e-9 * abs(x)


def _dev(device) -> str:
    return "default" if device is None else str(device)


@dataclass(frozen=True)
class Transfer:
    """One swap transfer as scheduled: ``ready`` is the instant the engine
    asked for the channel (None when the source log did not record it)."""

    tenant: str
    device: str
    direction: str                 # "in" | "out"
    var: int
    start: float
    end: float
    channel: "int | None"
    lane: "int | None" = None
    ready: "float | None" = None
    size: int = 0


@dataclass
class ScheduleView:
    """Normalized event log: the one shape every checker consumes."""

    source: str = "?"
    transfers: list = field(default_factory=list)        # [Transfer]
    blackouts: list = field(default_factory=list)        # [(start, end)]
    admissions: list = field(default_factory=list)       # [(name, device, arrival, admit)]
    finishes: list = field(default_factory=list)         # [(name, device, t)]
    renegotiations: list = field(default_factory=list)   # [(kind, victim, t, value)]
    hbm_samples: dict = field(default_factory=dict)      # device -> [total bytes]
    report: "dict | None" = None                         # RuntimeReport.as_dict()


# ------------------------------------------------------------- view builders
def _report_dict(report):
    if report is None or isinstance(report, dict):
        return report
    return report.as_dict()


def view_from_recorder(recorder, report=None) -> ScheduleView:
    """Richest view: the ``ObsRecorder`` streams carry channel, lane and
    ``ready_t`` for every transfer and unmerged blackout windows."""
    view = ScheduleView(source="recorder", report=_report_dict(report))
    for name, device, direction, var, start, end, ch, lane, ready, size in recorder.transfers:
        view.transfers.append(Transfer(
            name, _dev(device), direction, var, start, end, ch, lane, ready, size
        ))
    view.blackouts = list(recorder.blackouts)
    view.admissions = [(n, _dev(d), a, t) for n, d, a, t in recorder.admissions]
    view.finishes = [(n, _dev(d), t) for n, d, t in recorder.finishes]
    view.renegotiations = list(recorder.renegotiations)
    for name, device, _i, _t0, _t1, _resident, total in recorder.ops:
        view.hbm_samples.setdefault(_dev(device), []).append(total)
    return view


def view_from_runtime(rt, report=None) -> ScheduleView:
    """Fallback view from a finished runtime's ``record_events`` logs:
    per-run ``out_events`` / ``in_events`` are ``(var, start, end, ch)`` —
    no lanes, no ``ready_t``, so only channel exclusivity has subjects."""
    view = ScheduleView(source="runtime", report=_report_dict(report))
    for run in getattr(rt, "runs", []):
        dev = _dev(getattr(run, "device", None))
        for direction, events in (("out", getattr(run, "out_events", ())),
                                  ("in", getattr(run, "in_events", ()))):
            for ev in events:
                var, start, end = ev[0], ev[1], ev[2]
                ch = ev[3] if len(ev) > 3 else None
                view.transfers.append(Transfer(
                    run.name, dev, direction, int(var), float(start),
                    float(end), ch,
                ))
    return view


def view_from_trace(trace: dict, source: str = "trace") -> ScheduleView:
    """Rebuild a view from exported Chrome trace JSON (``trace_export``
    layout): DMA rows give channel + ``queued_us`` (hence ``ready``), link
    lane rows are matched back to their DMA slice by (tenant, direction,
    var, ts, dur) — the exporter writes both from the same floats.  The
    trace's blackout row is merged; merging only widens window starts, so
    ``blackout_exclusion`` stays sound for the committed deterministic
    traces but the recorder view is the authoritative surface."""
    view = ScheduleView(source=source)
    events = trace.get("traceEvents", [])
    other = trace.get("otherData", {})
    view.report = other.get("report")

    thread_names: dict[tuple, str] = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            thread_names[(e["pid"], e.get("tid", 0))] = e["args"]["name"]

    lane_of: dict[tuple, int] = {}
    dma: list[tuple] = []
    for e in events:
        ph, pid = e.get("ph"), e.get("pid")
        name = e.get("name", "")
        tname = thread_names.get((pid, e.get("tid", 0)), "")
        if ph == "X" and pid == 2 and ":v" in name:
            direction, var = name.split(":v", 1)
            dev, _, ch = tname.rpartition("/ch")
            args = e.get("args", {})
            dma.append((args.get("tenant", "?"), dev or "default", direction,
                        int(var), e["ts"], e["dur"],
                        int(ch) if ch.isdigit() else None,
                        args.get("queued_us", 0.0), args.get("bytes", 0)))
        elif ph == "X" and pid == 3 and name == "blackout":
            view.blackouts.append((e["ts"] / _US, (e["ts"] + e["dur"]) / _US))
        elif ph == "X" and pid == 3 and ":v" in name and tname.startswith("lane"):
            direction, var = name.split(":v", 1)
            key = (e.get("args", {}).get("tenant", "?"), direction,
                   int(var), e["ts"], e["dur"])
            lane_of[key] = int(tname[4:])
        elif ph == "C" and pid == 4 and name.startswith("HBM ["):
            dev = name[5:-1]
            view.hbm_samples.setdefault(dev, []).append(
                e.get("args", {}).get("bytes", 0))
        elif ph == "i" and pid == 1:
            tenant = tname or "?"
            if name == "admitted":
                dev = e.get("args", {}).get("device", "default")
                view.admissions.append((tenant, dev, None, e["ts"] / _US))
            elif name == "finished":
                view.finishes.append((tenant, None, e["ts"] / _US))
            elif name.startswith("renegotiation "):
                kind = name.split(" ", 1)[1]
                args = e.get("args", {})
                value = args.get("freed_bytes", args.get("new_limit", 0))
                view.renegotiations.append((kind, tenant, e["ts"] / _US, value))

    arrivals: dict[str, float] = {}
    for e in events:
        if (e.get("ph") == "X" and e.get("pid") == 1
                and e.get("name") == "queued"):
            tenant = thread_names.get((1, e.get("tid", 0)), "?")
            arrivals[tenant] = e["ts"] / _US
    view.admissions = [
        (n, d, arrivals.get(n, t), t) for n, d, _a, t in view.admissions
    ]
    for tenant, dev, direction, var, ts, dur, ch, queued_us, size in dma:
        lane = lane_of.get((tenant, direction, var, ts, dur))
        view.transfers.append(Transfer(
            tenant, dev, direction, var, ts / _US, (ts + dur) / _US, ch,
            lane, (ts - queued_us) / _US, size,
        ))
    return view


# ------------------------------------------------------------------- checks
def _exclusive(groups: dict, invariant: str, what: str) -> list[Violation]:
    out = []
    for key, ts in sorted(groups.items()):
        ts.sort(key=lambda t: (t.start, t.end))
        prev = None
        for t in ts:
            if prev is not None and t.start < prev.end - _tol(prev.end):
                out.append(Violation(
                    invariant, f"{what}:{key}",
                    f"{t.direction}:v{t.var} ({t.tenant}) starts at "
                    f"{t.start:.6f}s before {prev.direction}:v{prev.var} "
                    f"({prev.tenant}) ends at {prev.end:.6f}s on {what} {key}",
                    vars=(t.var, prev.var),
                ))
            if prev is None or t.end > prev.end:
                prev = t
    return out


def check_view(view: ScheduleView) -> Certificate:
    cert = Certificate()
    for name in SCHEDULE_INVARIANTS:
        cert.add(name, 0, [])
    report = view.report

    # -- channel / lane exclusivity
    by_ch: dict = {}
    by_lane: dict = {}
    for t in view.transfers:
        if t.channel is not None:
            by_ch.setdefault(f"{t.device}/ch{t.channel}", []).append(t)
        if t.lane is not None:
            by_lane.setdefault(t.lane, []).append(t)
    cert.add("channel_exclusive", len(by_ch),
             _exclusive(by_ch, "channel_exclusive", "channel"))
    cert.add("lane_exclusive", len(by_lane),
             _exclusive(by_lane, "lane_exclusive", "lane"))

    # -- blackout exclusion (swap-outs with a recorded ready instant only)
    blackouts = sorted(view.blackouts)
    outs = [t for t in view.transfers
            if t.direction == "out" and t.ready is not None and t.lane is not None]
    violations = []
    for t in outs:
        for bs, be in blackouts:
            if bs >= t.end:
                break
            overlaps = bs < t.end - _tol(t.end) and t.start < be - _tol(be)
            if overlaps and bs < t.ready - _tol(t.ready):
                violations.append(Violation(
                    "blackout_exclusion", f"lane:{t.lane}",
                    f"out:v{t.var} ({t.tenant}) on lane {t.lane} spans "
                    f"[{t.start:.6f}, {t.end:.6f})s across a blackout "
                    f"[{bs:.6f}, {be:.6f})s that was already registered at "
                    f"its ready instant {t.ready:.6f}s",
                    vars=(t.var,),
                ))
    cert.add("blackout_exclusion", len(outs), violations)

    # -- accountant monotonicity over the sampled pool totals
    violations = []
    samples = sum(len(v) for v in view.hbm_samples.values())
    if report is None:
        if samples:
            cert.note("budget_monotone: no report attached; "
                      "budget/peak bounds unchecked")
        cert.add("budget_monotone", 0, [])
    else:
        budget = report.get("budget")
        overflow = report.get("overflow_events", 0)
        device_peaks = report.get("device_peaks")
        for dev, totals in sorted(view.hbm_samples.items()):
            top = max(totals)
            if budget is not None and overflow == 0 and top > budget:
                violations.append(Violation(
                    "budget_monotone", f"device:{dev}",
                    f"pool total {top} exceeds budget {budget} on {dev} but "
                    "the accountant reported zero overflow events",
                ))
            peak = (device_peaks or {}).get(dev) if device_peaks else \
                report.get("aggregate_peak")
            if peak is not None and top > peak:
                violations.append(Violation(
                    "budget_monotone", f"device:{dev}",
                    f"sampled pool total {top} on {dev} exceeds the "
                    f"reported peak {peak}",
                ))
        cert.add("budget_monotone", samples, violations)

    # -- reservation isolation: rebuilt admission-floor timeline
    violations = []
    if report is None:
        cert.add("reservation_isolation", 0, [])
        if view.admissions:
            cert.note("reservation_isolation: no report attached; "
                      "floor timeline unchecked")
    else:
        budget = report.get("budget")
        tenants = {t["name"]: t for t in report.get("tenants", ())}
        freed: dict[str, int] = {}
        for kind, victim, _t, value in view.renegotiations:
            if kind == "applied":
                freed[victim] = freed.get(victim, 0) + value

        seen_admit: dict[str, float] = {}
        timeline: list[tuple[float, int, str, str, int]] = []
        for name, device, arrival, admit in view.admissions:
            if name in seen_admit:
                violations.append(Violation(
                    "reservation_isolation", f"tenant:{name}",
                    f"{name} admitted twice (at {seen_admit[name]:.6f}s and "
                    f"{admit:.6f}s) — double-admit double-charges its floor",
                ))
                continue
            seen_admit[name] = admit
            if arrival is not None and admit < arrival - _tol(arrival):
                violations.append(Violation(
                    "reservation_isolation", f"tenant:{name}",
                    f"{name} admitted at {admit:.6f}s before its arrival "
                    f"{arrival:.6f}s",
                ))
            rep = tenants.get(name)
            if rep is None:
                continue
            floor0 = rep.get("floor", 0) + freed.get(name, 0)
            timeline.append((admit, 1, "admit", name, floor0))
        for kind, victim, t, value in view.renegotiations:
            if kind == "applied":
                timeline.append((t, 0, "renegotiate", victim, -value))
        for name, _device, t in view.finishes:
            rep = tenants.get(name)
            if rep is not None and name in seen_admit:
                timeline.append((t, 0, "finish", name, -rep.get("floor", 0)))

        if budget is not None and timeline:
            # Floors live on the tenant's device pool; ties at one instant
            # release (finish/renegotiate, sort key 0) before they admit.
            dev_of = {n: _dev(tenants.get(n, {}).get("device"))
                      for n in set(x[3] for x in timeline)}
            level: dict[str, int] = {}
            for t, _k, what, name, delta in sorted(
                    timeline, key=lambda x: (x[0], x[1])):
                dev = dev_of[name]
                level[dev] = level.get(dev, 0) + delta
                if level[dev] > budget:
                    violations.append(Violation(
                        "reservation_isolation", f"device:{dev}",
                        f"admission floors sum to {level[dev]} > budget "
                        f"{budget} on {dev} after {what} of {name} at "
                        f"{t:.6f}s",
                    ))
        cert.add("reservation_isolation", len(view.admissions), violations)

    # -- ledger closure
    violations = []
    checked = 0
    if report is not None:
        sums: dict[str, float] = {}
        for t in report.get("tenants", ()):
            if t.get("status") != "completed":
                continue
            ledger = t.get("attribution")
            if not isinstance(ledger, dict):
                continue
            checked += 1
            total = ledger.get("overhead_s", 0.0)
            summed = sum(v for k, v in ledger.items()
                         if k not in LEDGER_INFORMATIONAL)
            if abs(summed - total) > _tol(total):
                violations.append(Violation(
                    "ledger_closure", f"tenant:{t.get('name')}",
                    f"attribution buckets sum to {summed!r} but overhead_s "
                    f"is {total!r}",
                ))
            for k, v in ledger.items():
                if isinstance(v, (int, float)):
                    sums[k] = sums.get(k, 0.0) + v
        agg = report.get("attribution")
        if isinstance(agg, dict) and checked:
            for k, v in agg.items():
                if not isinstance(v, (int, float)):
                    continue
                got = sums.get(k, 0.0)
                if abs(got - v) > _tol(v):
                    violations.append(Violation(
                        "ledger_closure", "aggregate",
                        f"aggregate ledger {k}={v!r} but tenant ledgers "
                        f"sum to {got!r}",
                    ))
    cert.add("ledger_closure", checked, violations)
    cert.note(f"source: {view.source}; {len(view.transfers)} transfer(s), "
              f"{len(view.blackouts)} blackout(s), "
              f"{len(view.admissions)} admission(s)")
    return cert


# ------------------------------------------------------------- entry points
def verify_recorder(recorder, report=None) -> Certificate:
    return check_view(view_from_recorder(recorder, report))


def verify_trace_file(path: str) -> Certificate:
    with open(path) as f:
        trace = json.load(f)
    return check_view(view_from_trace(trace, source=path))
