"""The port's run diffing (``repro_torch.obs.diffing``) and its two offline
CLIs (``repro_torch.launch.obsdiff``, ``repro_torch.launch.analyze``)
against the JAX package's, on the CPU.

All three are the reference's code with their imports pointed into the
port, and import no torch.  Their inputs are files: runtime reports,
Chrome traces, metrics JSONL, ``BENCH_*.json`` and plan artifacts.  Each
test writes them once, from the reference's runtime and planner on
``tests/test_obs_monitor.py``'s runs, and gives the same files to both
sides; views, diffs, rendered tables, CLI output and exit codes compare
with ``==``.
"""

from __future__ import annotations

import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import pytest

import repro.launch.analyze as R_analyze_cli
import repro.launch.obsdiff as R_obsdiff
import repro.obs.diffing as R_diff
import repro_torch.launch.analyze as P_analyze_cli
import repro_torch.launch.obsdiff as P_obsdiff
import repro_torch.obs.diffing as P_diff
from repro.core.autoswap import AutoSwapPlanner
from repro.core.simulator import GTX_1080TI
from repro.obs import MonitoredRecorder, chrome_trace
from repro.plan import MemoryProgram, PassContext, Pipeline, PoolPlacement, SwapSelection, \
    TimingAssign
from repro.plan.artifact import program_to_json
from repro.runtime import engine
from repro.runtime.workload import poisson_workload, synthetic_train_trace

ROOT = Path(__file__).resolve().parents[1]
SIZE_THRESHOLD = 1 << 20  # tests/test_obs_monitor.py's
# tests/test_obs_monitor.py's SLOs: a tight one that fires, a guard that
# never does, and the link asymmetry band.
MONITOR_SLOS = (
    "queue_wait.p99<0.001,short=0.02,long=0.08,min=2,name=tight",
    "queue_wait.p99<100,name=guard",
    "link.out_in_wait_ratio>2,low=1.2,window=0.05,name=asym",
)
SIDES = {"ref": R_diff, "port": P_diff}


def _report_payload(extra_stall=0.0):
    """tests/test_obs_monitor.py's report with one growing stall cause."""
    return {
        "makespan_s": 1.0 + extra_stall,
        "tenants": [
            {"name": "a", "status": "completed", "overhead": 0.1,
             "attribution": {"overhead_s": 0.1 + extra_stall,
                             "swap_in_transfer_s": 0.06 + extra_stall,
                             "channel_contention_s": 0.04,
                             "residual_s": 0.0}},
        ],
    }


def _monitored_churn(budget_scale: float = 1.0):
    """tests/test_obs_monitor.py's churn run under a monitored recorder ->
    (report, recorder)."""
    templates = {"small": synthetic_train_trace(4), "medium": synthetic_train_trace(6),
                 "base": synthetic_train_trace(10)}
    plans = {}
    for name, tr in templates.items():
        pl = AutoSwapPlanner(tr, GTX_1080TI, size_threshold=SIZE_THRESHOLD)
        limit = int(pl.peak_load * 0.7)
        plans[name] = (limit, pl.select(limit, "swdoa"))
    floors = {n: engine.planned_peak(templates[n], plans[n][1]) for n in templates}
    budget = floors["base"] + (floors["small"] + floors["medium"]) // 2
    items = poisson_workload(["small", "medium"], 6, 50.0, seed=11, iterations=(1, 3),
                             priorities=(0.5, 1.0, 2.0))
    tenants = [engine.Tenant("base", templates["base"], list(plans["base"][1]),
                             limit=plans["base"][0], iterations=6, priority=0.5)]
    for it in items:
        limit, decisions = plans[it.template]
        tenants.append(engine.Tenant(it.name, templates[it.template], list(decisions),
                                     limit=limit, iterations=it.iterations,
                                     arrival_t=it.arrival_t, priority=it.priority))
    rec = MonitoredRecorder(slos=MONITOR_SLOS)
    rt = engine.MemoryRuntime(GTX_1080TI, budget=int(budget * budget_scale), channels=2,
                              renegotiate=True, replan_size_threshold=SIZE_THRESHOLD, obs=rec)
    return rt.run(tenants), rec


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """One file of every shape ``load_run`` reads, written once."""
    d = tmp_path_factory.mktemp("runs")
    (d / "report_a.json").write_text(json.dumps(_report_payload(0.0)))
    (d / "report_b.json").write_text(json.dumps(_report_payload(0.05)))
    (d / "BENCH_x.json").write_text(json.dumps(
        {"mode": "full", "cell": {"events_per_s": 5.0, "p99_s": 0.25},
         "_meta": {"schema_version": 1}}))
    (d / "BENCH_y.json").write_text(json.dumps(
        {"mode": "full", "cell": {"events_per_s": 4.0, "p99_s": 0.3},
         "_meta": {"schema_version": 1}}))
    report, rec = _monitored_churn()
    (d / "t.trace.json").write_text(json.dumps(chrome_trace(rec, report)))
    rec.metrics.append_jsonl(str(d / "m.jsonl"), {"monitor": rec.finalize()})
    report, rec = _monitored_churn(4.0)
    (d / "loose.trace.json").write_text(json.dumps(chrome_trace(rec, report)))
    return d


RUNS = ["report_a.json", "BENCH_x.json", "t.trace.json", "m.jsonl", "loose.trace.json"]


@pytest.mark.parametrize("name", RUNS)
def test_load_run_equal(artifacts, name):
    views = {side: mod.load_run(str(artifacts / name)) for side, mod in SIDES.items()}
    assert views["port"].as_dict() == views["ref"].as_dict()
    assert isinstance(views["port"], P_diff.RunView)
    if name in ("t.trace.json", "m.jsonl"):  # the monitor's quantile summary came along
        assert "queue_wait.all" in views["port"].quantiles


PAIRS = [("report_a.json", "report_b.json"), ("BENCH_x.json", "BENCH_y.json"),
         ("t.trace.json", "m.jsonl"), ("loose.trace.json", "t.trace.json")]


@pytest.mark.parametrize("a,b", PAIRS)
def test_diff_runs_and_format_diff_equal(artifacts, a, b):
    out = {}
    for side, mod in SIDES.items():
        diff = mod.diff_runs(mod.load_run(str(artifacts / a)), mod.load_run(str(artifacts / b)),
                             top_k=6)
        out[side] = (json.dumps(diff, sort_keys=True), mod.format_diff(diff))
    assert out["port"] == out["ref"]
    assert out["port"][1].strip()


def test_view_from_payload_diff_equal():
    """tests/test_obs_monitor.py's ledger-sign case, through payloads."""
    got = [json.dumps(mod.diff_runs(mod.view_from_payload("a", _report_payload(0.0)),
                                    mod.view_from_payload("b", _report_payload(0.05))),
                      sort_keys=True) for mod in (P_diff, R_diff)]
    assert got[0] == got[1]
    assert json.loads(got[0])["top_regressions"][0]["metric"] == "makespan_s"


def _cli(main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.mark.parametrize("a,b", PAIRS)
def test_obsdiff_cli_equal(artifacts, tmp_path, a, b):
    outs = {}
    for side, mod in (("ref", R_obsdiff), ("port", P_obsdiff)):
        path = tmp_path / f"{side}.diff.json"
        rc, text = _cli(mod.main, [str(artifacts / a), str(artifacts / b), "--top", "5",
                                   "--json", str(path)])
        outs[side] = (rc, text.replace(str(path), "X"), path.read_text())
        outs[side + " match"] = _cli(mod.main, [str(artifacts / a), str(artifacts / b),
                                                "--match", "p99"])
    assert outs["port"] == outs["ref"] and outs["port"][0] == 0
    assert outs["port match"] == outs["ref match"]


def _solved_program():
    """A plan solved at 80% of its peak (tests/test_analyze.py's shape of
    pipeline, on a synthetic training trace)."""
    prog = MemoryProgram.from_trace(synthetic_train_trace(6))
    ctx = PassContext(hw=GTX_1080TI, size_threshold=SIZE_THRESHOLD)
    limit = int(prog.require_trace().peak_load() * 0.8)
    return Pipeline([TimingAssign(), PoolPlacement(("best_fit", "first_fit")),
                     SwapSelection(limit=limit, scorer="swdoa")]).run(prog, ctx)


@pytest.mark.parametrize("quiet", [True, False])
def test_analyze_cli_equal(tmp_path, quiet):
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps(program_to_json(_solved_program())))
    broken = tmp_path / "broken.json"
    broken.write_text(json.dumps({"pool_plans": {}, "swap_summaries": "x"}))
    paths = [str(plan), str(ROOT / "examples" / "traces" / "mesh_data4.trace.json"),
             str(ROOT / "examples" / "traces" / "churn.trace.json"),
             str(tmp_path / "missing.json"), str(broken)]
    argv = (["-q"] if quiet else []) + paths
    got, want = _cli(P_analyze_cli.main, argv), _cli(R_analyze_cli.main, argv)
    assert got == want
    assert got[0] == 1 and "FAIL" in got[1] and f"ok   {plan} [plan]" in got[1]
