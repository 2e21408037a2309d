"""The port's observability layer (``repro_torch.obs``) and schedule
verifier (``repro_torch.analyze.schedule_check``, ``verify_launch``)
against the JAX package's, on the CPU.

Both are the reference's code with their imports pointed into the port,
and import no torch.  Each test feeds the same seeded stream to the two
and compares with ``==``: sketch quantiles and state, window transitions,
SLO specs and monitor alerts, the recorders of a churn and a mesh run
(their Chrome-trace JSON, metrics and monitor summaries), and the
schedule certificates of the reference's clean view, its mutations and
its committed example traces.
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import random
from contextlib import redirect_stdout
from pathlib import Path

import pytest

import repro.analyze as R_analyze
import repro.analyze.schedule_check as R_sched
import repro.obs as R_obs
import repro.runtime.engine as R_engine
import repro.runtime.workload as R_workload
import repro_torch.analyze as P_analyze
import repro_torch.analyze.schedule_check as P_sched
import repro_torch.obs as P_obs
import repro_torch.runtime.engine as P_engine
import repro_torch.runtime.workload as P_workload
from repro.core.autoswap import AutoSwapPlanner as R_AutoSwap
from repro.core.simulator import GTX_1080TI as R_GTX
from repro_torch.core.autoswap import AutoSwapPlanner as P_AutoSwap
from repro_torch.core.simulator import GTX_1080TI as P_GTX

ROOT = Path(__file__).resolve().parents[1]
SIZE_THRESHOLD = 1 << 20  # tests/test_obs.py's
MiB = 1 << 20
# tests/test_obs_monitor.py's SLOs: a tight one that fires, a guard that
# never does, and the link asymmetry band.
MONITOR_SLOS = (
    "queue_wait.p99<0.001,short=0.02,long=0.08,min=2,name=tight",
    "queue_wait.p99<100,name=guard",
    "link.out_in_wait_ratio>2,low=1.2,window=0.05,name=asym",
)
SIDES = {"ref": (R_engine, R_workload, R_AutoSwap, R_GTX, R_obs),
         "port": (P_engine, P_workload, P_AutoSwap, P_GTX, P_obs)}


# ------------------------------------------------------------- sketches
def _values(shape: str, n: int = 6000) -> list[float]:
    """tests/test_obs_monitor.py's adversarial streams."""
    rng = random.Random(7)
    if shape == "constant":
        return [2.5] * n
    if shape == "heavy":
        return [rng.paretovariate(1.1) for _ in range(n)]
    values = [rng.random() for _ in range(n)]
    if shape == "sorted":
        values.sort()
    elif shape == "reversed":
        values.sort(reverse=True)
    return values


def _sketch_state(mod, shape: str, buffer_size: int, exact: bool):
    sk = mod.QuantileSketch(buffer_size, exact=exact)
    if shape == "merged":
        xs = _values("random", 1500)
        for part in (xs[:500], xs[500:1000], xs[1000:]):
            piece = mod.QuantileSketch(buffer_size, exact=exact)
            piece.extend(part)
            sk.merge(piece)
    else:
        sk.extend(_values(shape))
    qs = (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0)
    return (sk.to_dict(), sk.levels, sk.compactions, sk.quantiles(qs), sk.rank_error_bound(),
            sk.min, sk.max)


@pytest.mark.parametrize("shape,buffer_size,exact", [
    ("sorted", 64, False), ("reversed", 64, False), ("constant", 64, False),
    ("heavy", 64, False), ("random", 64, False), ("random", 16, True), ("merged", 32, False),
])
def test_sketch_quantiles_equal(shape, buffer_size, exact):
    assert _sketch_state(P_obs, shape, buffer_size, exact) == \
        _sketch_state(R_obs, shape, buffer_size, exact)


# --------------------------------------------------------------- windows
def _window_transitions(mod):
    rng = random.Random(9)
    tumbling, sliding = mod.TumblingWindow(0.25), mod.SlidingWindow(0.5, resolution=10)
    band, asym = mod.HysteresisBand(1.5, 3.0), mod.AsymmetryWindow(0.1, 1.2, 2.0)
    out, t = [], 0.0
    for i in range(400):
        t += rng.expovariate(40.0)
        v = rng.random()
        tumbling.observe(t, v)
        sliding.add(t, v)
        out.append((sliding.total(), sliding.count(), band.update(4 * v)))
        asym.observe(t, "out" if i < 200 else "in", v * (4.0 if i < 200 else 1.0))
        asym.observe(t, "in" if i < 200 else "out", v * 0.5)
        if i % 25 == 24:
            out.append(("asym", asym.ratio(t), asym.evaluate(t)))
    return out, tumbling.flush()


def test_window_transitions_equal():
    got, want = _window_transitions(P_obs), _window_transitions(R_obs)
    assert got == want
    assert any(x[-1] == "enter" for x in want[0] if len(x) == 3 and x[0] != "asym")


# ------------------------------------------------------------- SLO specs
@pytest.mark.parametrize("spec", [
    "queue_wait.p99<0.005,prio=1.0,short=0.01,long=0.04,burn=2,min=5",
    "stall.p95<0.01,cause=swap_in_wait",
    "link.out_in_wait_ratio>3,low=1.5",
    "headroom.p01>0.1,name=room",
    "queue_wait<1", "bogus.p99<1", "queue_wait.p99", "queue_wait.p99<x",
])
def test_parse_slo_equal(spec):
    def parse(mod):
        try:
            return ("ok", dataclasses.asdict(mod.parse_slo(spec)))
        except ValueError as e:
            return ("ValueError", str(e))

    assert parse(P_obs) == parse(R_obs)


def _burn_alerts(mod):
    mon = mod.SLOMonitor(["queue_wait.p99<0.001,short=0.01,long=0.05,min=4,name=s",
                          "link.out_in_wait_ratio>2,low=1.2,window=0.1,name=asym"])
    t = 0.0
    for i in range(240):
        t += 0.0005
        mon.observe_queue_wait(t, "prio1", 0.01 if 20 <= i < 40 else 0.0)
        mon.observe_transfer(t, "out", 0.004 if i < 120 else 0.0005)
        mon.observe_transfer(t, "in", 0.0005 if i < 120 else 0.004)
        if i % 40 == 39:
            mon.on_blackout_boundary(t)
    return [a.as_dict() for a in mon.alerts], mon.summary()


def test_monitor_alerts_equal():
    got, want = _burn_alerts(P_obs), _burn_alerts(R_obs)
    assert got == want and want[0]


def test_metrics_registry_equal(tmp_path):
    def run(mod, path):
        reg = mod.MetricsRegistry()
        reg.counter("a.b").inc()
        reg.counter("a.b").inc(2.5)
        reg.gauge("g").set(3.0)
        reg.gauge("g").set_max(1.0)
        errors = []
        for make in (lambda: reg.gauge("a.b"), lambda: reg.counter("g")):
            try:
                make()
            except ValueError as e:
                errors.append(str(e))
        rec = reg.append_jsonl(str(path), extra={"cell": "t1"})
        rec.pop("written_at", None)
        return reg.snapshot(), errors, rec

    assert run(P_obs, tmp_path / "p.jsonl") == run(R_obs, tmp_path / "r.jsonl")


# -------------------------------------------------- recorded runtime runs
def _solve(A, hw, trace, frac=0.7):
    pl = A(trace, hw, size_threshold=SIZE_THRESHOLD)
    limit = int(pl.peak_load * frac)
    return limit, pl.select(limit, "swdoa")


def _run(side: str, kind: str, recorder: str, record_events: bool = True):
    """tests/test_obs_monitor.py's churn (with renegotiation through the
    engine's default replanner, or FIFO) or mesh run on one side, observed
    by a plain or a monitored recorder -> (report, recorder)."""
    E, W, A, hw, obs = SIDES[side]
    templates = {"small": W.synthetic_train_trace(4), "medium": W.synthetic_train_trace(6),
                 "base": W.synthetic_train_trace(10)}
    plans = {n: _solve(A, hw, tr) for n, tr in templates.items()}
    rec = obs.MonitoredRecorder(slos=MONITOR_SLOS) if recorder == "monitored" \
        else obs.ObsRecorder()
    if kind == "mesh":
        tenants = []
        for i in range(4):
            name = "small" if i % 2 else "medium"
            trace = templates[name]
            limit, decisions = plans[name]
            tenants.append(E.Tenant(f"shard{i}", trace, list(decisions), limit=limit,
                                    iterations=3, device=f"d{i}",
                                    collectives={2: 0.004, trace.num_indices - 2: 0.006},
                                    collective_owner=(i == 0)))
        rt = E.MemoryRuntime(hw, channels=2, link=E.HostLink.make(hw.link_bw, 2), obs=rec,
                             record_events=record_events)
        return rt.run(tenants), rec
    floors = {n: E.planned_peak(templates[n], plans[n][1]) for n in templates}
    budget = floors["base"] + (floors["small"] + floors["medium"]) // 2
    items = W.poisson_workload(["small", "medium"], 6, 50.0, seed=11, iterations=(1, 3),
                               priorities=(0.5, 1.0, 2.0))
    tenants = [E.Tenant("base", templates["base"], list(plans["base"][1]),
                        limit=plans["base"][0], iterations=6, priority=0.5)]
    for it in items:
        limit, decisions = plans[it.template]
        tenants.append(E.Tenant(it.name, templates[it.template], list(decisions), limit=limit,
                                iterations=it.iterations, arrival_t=it.arrival_t,
                                priority=it.priority))
    rt = E.MemoryRuntime(hw, budget=budget, channels=2, renegotiate=(kind == "churn"),
                         replan_size_threshold=SIZE_THRESHOLD, obs=rec,
                         record_events=record_events)
    return rt.run(tenants), rec


def _strip_wall_clock(obj):
    """The recorder's renegotiation records carry the re-solve's wall ms."""
    if isinstance(obj, dict):
        return {k: 0.0 if k.endswith("solve_ms") or k.endswith("solve_s") else
                _strip_wall_clock(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_strip_wall_clock(v) for v in obj]
    return obj


def _observed(side: str, kind: str, recorder: str):
    E, obs = SIDES[side][0], SIDES[side][4]
    report, rec = _run(side, kind, recorder)
    simulated = E.simulated_report_dict(report)
    trace = obs.chrome_trace(rec, simulated)
    out = {"report": simulated,
           "trace": _strip_wall_clock(json.loads(json.dumps(trace, sort_keys=True))),
           "metrics": rec.metrics.snapshot(),
           "certificate": (P_sched if side == "port" else R_sched).verify_recorder(
               rec, report).to_dict()}
    if recorder == "monitored":
        out["monitor"] = _strip_wall_clock(rec.finalize())
        out["alerts"] = [a.as_dict() for a in rec.alerts]
    return out, report


@pytest.mark.parametrize("kind", ["churn", "fifo", "mesh"])
@pytest.mark.parametrize("recorder", ["plain", "monitored"])
def test_recorded_run_equal(kind, recorder):
    got, report = _observed("port", kind, recorder)
    want, _ = _observed("ref", kind, recorder)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["trace"]["traceEvents"]
    # The reference's mesh run fails its own blackout check (a transfer
    # that acquired its lane after a collective's blackout was registered
    # spans it, ROADMAP queue C); the port's fails it alike.
    failed = [k for k, c in got["certificate"]["checks"].items() if not c["ok"]]
    assert failed == (["blackout_exclusion"] if kind == "mesh" else []), failed
    if kind == "churn":
        assert report.renegotiations > 0  # through the default replanner
    if recorder == "monitored" and kind == "churn":
        assert got["alerts"]


def test_written_trace_file_verifies_equal(tmp_path):
    report, rec = _run("port", "churn", "plain")
    path = tmp_path / "port.trace.json"
    P_obs.write_trace(str(path), rec, report)
    want = R_sched.verify_trace_file(str(path)).to_dict()
    got = P_sched.verify_trace_file(str(path)).to_dict()
    assert got == want and got["ok"]


# ------------------------------------------------------ schedule mutations
def _clean_view(S):
    """tests/test_analyze.py's clean view: two tenants, one device."""
    report = {
        "budget": 10 * MiB, "overflow_events": 0, "aggregate_peak": 9 * MiB,
        "tenants": [
            {"name": "a", "status": "completed", "device": None, "floor": 4 * MiB,
             "renegotiation_freed_bytes": 0,
             "attribution": {"overhead_s": 0.5, "swap_in_transfer_s": 0.3,
                             "residual_s": 0.2, "queue_wait_s": 0.1}},
            {"name": "b", "status": "completed", "device": None, "floor": 5 * MiB,
             "renegotiation_freed_bytes": 0,
             "attribution": {"overhead_s": 0.1, "swap_in_transfer_s": 0.1,
                             "residual_s": 0.0, "queue_wait_s": 0.0}},
        ],
        "attribution": {"overhead_s": 0.6, "swap_in_transfer_s": 0.4, "residual_s": 0.2,
                        "queue_wait_s": 0.1},
    }
    view = S.ScheduleView(source="unit", report=report)
    T = S.Transfer
    view.transfers = [
        T("a", "default", "out", 0, 1.0, 2.0, 0, lane=0, ready=1.0, size=MiB),
        T("a", "default", "in", 0, 4.0, 5.0, 0, lane=0, ready=3.5, size=MiB),
        T("b", "default", "out", 1, 2.5, 3.5, 1, lane=1, ready=2.5, size=MiB),
    ]
    view.blackouts = [(2.1, 2.4)]
    view.admissions = [("a", "default", 0.0, 0.0), ("b", "default", 0.0, 0.1)]
    view.finishes = [("a", "default", 6.0), ("b", "default", 7.0)]
    view.hbm_samples = {"default": [3 * MiB, 9 * MiB, 5 * MiB]}
    return view


def _mutate(S, view, mutation: str):
    T, tr = S.Transfer, view.transfers
    if mutation == "channel_overlap":
        t = tr[1]
        tr.append(dataclasses.replace(t, var=7, lane=None, start=t.start + 0.2, end=t.end + 0.2))
    elif mutation == "lane_overlap":
        t = tr[2]
        tr.append(dataclasses.replace(t, var=8, channel=None, start=t.start + 0.2,
                                      end=t.end + 0.2))
    elif mutation in ("blackout", "late_blackout"):
        tr.append(T("b", "default", "out", 9, 4.0, 5.5, 1, lane=1,
                    ready=3.0 if mutation == "blackout" else 4.0, size=MiB))
        view.blackouts.append((2.8, 4.6) if mutation == "blackout" else (4.5, 5.0))
    elif mutation == "over_budget":
        view.hbm_samples["default"].append(11 * MiB)
    elif mutation == "double_admit":
        view.admissions.append(("a", "default", 0.0, 0.2))
    elif mutation == "floor_oversubscribed":
        view.report["tenants"][1]["floor"] = 7 * MiB
    elif mutation == "leaky_ledger":
        view.report["tenants"][0]["attribution"]["swap_in_transfer_s"] = 0.4
    elif mutation.startswith("shift"):
        idx, shift = int(mutation[5]), float(mutation[7:])
        tr[idx] = dataclasses.replace(tr[idx], start=tr[idx].start - shift, ready=None)
    return view


@pytest.mark.parametrize("mutation", [
    "clean", "channel_overlap", "lane_overlap", "blackout", "late_blackout", "over_budget",
    "double_admit", "floor_oversubscribed", "leaky_ledger", "shift0_0.8", "shift1_2.5",
    "shift2_0.3",
])
def test_schedule_certificates_equal(mutation):
    got = P_sched.check_view(_mutate(P_sched, _clean_view(P_sched), mutation)).to_dict()
    want = R_sched.check_view(_mutate(R_sched, _clean_view(R_sched), mutation)).to_dict()
    assert got == want
    assert got["ok"] == (mutation in ("clean", "late_blackout", "shift0_0.8", "shift2_0.3"))


@pytest.mark.parametrize("name", ["churn", "mesh_data4"])
def test_committed_example_traces_certify_equal(name):
    path = str(ROOT / "examples" / "traces" / f"{name}.trace.json")
    got, want = P_sched.verify_trace_file(path), R_sched.verify_trace_file(path)
    assert got.to_dict() == want.to_dict() and got.ok
    trace = json.loads(Path(path).read_text())
    assert [dataclasses.astuple(t) for t in P_sched.view_from_trace(trace).transfers] == \
        [dataclasses.astuple(t) for t in R_sched.view_from_trace(trace).transfers]


# ---------------------------------------------------------- launcher glue
def test_cli_obs_args_and_verify_launch_equal(tmp_path):
    """The launchers' flags parse alike, ``recorder_for`` builds the same
    kind of recorder, and ``verify_launch`` prints the same certificates
    for a solved program and a recorded run."""
    def run(side):
        E, obs = SIDES[side][0], SIDES[side][4]
        analyze = P_analyze if side == "port" else R_analyze
        ap = argparse.ArgumentParser()
        obs.add_obs_args(ap)
        kinds = []
        for argv in ([], ["--trace-out", "x"], ["--verify"], ["--slo", MONITOR_SLOS[1]],
                     ["--monitor-out", "m"]):
            args = ap.parse_args(argv)
            kinds.append((vars(args), type(obs.recorder_for(args)).__name__))
        args = ap.parse_args(["--verify", "--slo", MONITOR_SLOS[1],
                              "--monitor-out", str(tmp_path / f"{side}.jsonl")])
        report, rec = _run(side, "churn", "monitored")
        plan = _plan_program(side)
        out = io.StringIO()
        with redirect_stdout(out):
            analyze.verify_launch(args, programs={"p": plan}, recorder=rec, report=report)
            obs.export_monitor(args, rec)
        return kinds, out.getvalue().replace(str(tmp_path / side), "X")

    assert run("port") == run("ref")


def _plan_program(side):
    """A program solved at 80% of its peak through each side's pipeline."""
    import repro.plan as R_plan
    import repro_torch.plan as P_plan

    E, W, _, hw, _ = SIDES[side]
    plan = P_plan if side == "port" else R_plan
    prog = plan.MemoryProgram.from_trace(W.synthetic_train_trace(6))
    ctx = plan.PassContext(hw=hw, size_threshold=SIZE_THRESHOLD)
    limit = int(prog.require_trace().peak_load() * 0.8)
    return plan.Pipeline([plan.TimingAssign(), plan.PoolPlacement(),
                          plan.SwapSelection(limit=limit)]).run(prog, ctx)
