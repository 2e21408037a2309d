"""The port's tenants, tuners and colocate launcher (``repro_torch.runtime.
tenants``, ``repro_torch.tune``, ``repro_torch.launch.colocate``) against
the JAX package's, on the CPU.

``tenants`` and ``tune`` are the reference's code with their imports
pointed into the port, and import no torch: on the programs and scenarios
of ``tests/test_runtime.py``, ``test_churn.py`` and ``test_tune.py`` their
results are ``==`` to the reference's (``ColocationResult.as_dict()`` with
the runtime's simulated report, the cache's canonical artifact bytes, tuner records,
victim decision logs).  The launcher traces the port's own steps on fake
tensors and simulates, so it runs nothing on a device; a train tenant
restores the plan ``train --plan-cache`` wrote.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.core.events as R_events
import repro.plan as R_plan
import repro.runtime as R_runtime
import repro.runtime.engine as R_engine
import repro.runtime.workload as R_workload
import repro.tune as R_tune
import repro_torch.core.events as P_events
import repro_torch.plan as P_plan
import repro_torch.runtime as P_runtime
import repro_torch.runtime.engine as P_engine
import repro_torch.runtime.workload as P_workload
import repro_torch.tune as P_tune
from repro.core.autoswap import AutoSwapPlanner as R_AutoSwap
from repro.core.simulator import HardwareSpec as R_HardwareSpec
from repro_torch.core.autoswap import AutoSwapPlanner as P_AutoSwap
from repro_torch.core.simulator import HardwareSpec as P_HardwareSpec

ROOT = Path(__file__).resolve().parents[1]
MB = 1 << 20
ST = 1 << 20
SPEC = dict(peak_flops=1e12, hbm_bw=1e12, link_bw=1e10, efficiency=1.0)  # the tests' "test" HW
SIDES = {
    "ref": dict(events=R_events, plan=R_plan, runtime=R_runtime, engine=R_engine,
                workload=R_workload, tune=R_tune, autoswap=R_AutoSwap,
                hw=R_HardwareSpec("test", **SPEC)),
    "port": dict(events=P_events, plan=P_plan, runtime=P_runtime, engine=P_engine,
                 workload=P_workload, tune=P_tune, autoswap=P_AutoSwap,
                 hw=P_HardwareSpec("test", **SPEC)),
}


def synth_trace(E, n_layers=8, act_bytes=8 << 20, weight_bytes=4 << 20):
    """tests/test_runtime.py's forward/backward-shaped trace, built with the
    events module ``E``."""
    vs, fwd_w, fwd_a, var = [], [], [], 0
    n_ops = 4 * n_layers + 2
    for layer in range(n_layers):
        w = E.VariableInfo(var, weight_bytes, 0, n_ops, [2 * layer], [False])
        a = E.VariableInfo(var + 1, act_bytes, 2 * layer, 0, [2 * layer + 1], [True])
        var += 2
        vs += [w, a]
        fwd_w.append(w)
        fwd_a.append(a)
    for layer in reversed(range(n_layers)):
        bwd = 2 * n_layers + 2 * (n_layers - 1 - layer) + 1
        for v in (fwd_w[layer], fwd_a[layer]):
            v.accesses.append(bwd)
            v.access_is_write.append(False)
        fwd_a[layer].free_index = bwd + 1
    tr = E.IterationTrace(vs, n_ops)
    tr.op_costs = {i: (1e9, 1e6) for i in range(n_ops)}
    return tr


def _cache_files(plan, directory: Path) -> dict[str, str]:
    """The cache's artifacts by file name, each as its canonical bytes (the
    artifact without its wall-clock solve times)."""
    return {p.name: plan.dumps_canonical(plan.program_from_json(json.loads(p.read_text())))
            for p in sorted(directory.iterdir())}


def _programs(s, scenario):
    P, W = s["plan"].MemoryProgram, s["workload"]
    if scenario in ("runtime", "runtime_cached"):          # test_runtime.py:273
        return {"a": P.from_trace(synth_trace(s["events"], 8)),
                "b": P.from_trace(synth_trace(s["events"], 6))}
    if scenario == "shares":                               # test_churn.py:281
        return {n: P.from_trace(W.synthetic_train_trace(k))
                for n, k in (("a", 8), ("b", 6), ("c", 4))}
    if scenario in ("churn", "churn_ledger"):              # test_churn.py:296
        return {"victim": P.from_trace(W.synthetic_train_trace(12)),
                "newcomer": P.from_trace(W.synthetic_train_trace(6))}
    return {"big": P.from_trace(W.synthetic_train_trace(12)),   # test_tune.py:295
            "small": P.from_trace(W.synthetic_train_trace(4))}


def _colocate(side, scenario, tmp_path=None):
    """One scenario's ``colocate_programs`` on one side -> (comparable
    dict, result, the cache's files {name: bytes})."""
    s = SIDES[side]
    progs = _programs(s, scenario)
    kw = dict(channels=2, size_threshold=ST)
    cache = None
    if scenario == "runtime":
        kw.update(budget_frac=0.75)
    elif scenario == "runtime_cached":
        cache = s["plan"].PlanCache(tmp_path / side)
        progs = {n: p.__class__.from_trace(p.require_trace(),
                                           s["plan"].PlanKey("synthetic", f"colocate-{n}",
                                                             s["hw"].name))
                 for n, p in progs.items()}
        kw.update(budget_frac=0.75, cache=cache)
    elif scenario == "shares":
        peaks = {n: p.require_trace().peak_load() for n, p in progs.items()}
        kw.update(budget=sum(peaks.values()) * 2 // 3 + 1)  # indivisible on purpose
    elif scenario in ("churn", "churn_ledger"):
        kw.update(budget_frac=0.75, iterations=5, arrivals={"newcomer": 0.02},
                  priorities={"victim": 0.5, "newcomer": 1.0}, renegotiate=True)
        if scenario == "churn_ledger":
            kw.update(victim_policy=s["tune"].LedgerVictimPolicy())
    else:
        kw.update(budget_frac=0.7, iterations=2, priorities={"big": 2.0, "small": 0.5},
                  budget_split="tuned" if scenario == "tuned" else "proportional")
    result = s["runtime"].colocate_programs(progs, s["hw"], **kw)
    d = result.as_dict()
    assert sorted(d.pop("plan_solve_ms")) == sorted(progs)  # wall clock
    d["runtime"] = s["engine"].simulated_report_dict(result.report)
    if "victim_policy" in kw:
        d["decisions"] = kw["victim_policy"].decision_log
    files = _cache_files(s["plan"], tmp_path / side) if cache is not None else {}
    return json.dumps(d, sort_keys=True), result, files


@pytest.mark.parametrize("scenario", ["runtime", "runtime_cached", "shares", "churn",
                                      "churn_ledger", "proportional", "tuned"])
def test_colocate_programs_equal(scenario, tmp_path):
    got, result, got_files = _colocate("port", scenario, tmp_path)
    want, _, want_files = _colocate("ref", scenario, tmp_path)
    assert got == want
    assert got_files == want_files
    rep = result.report
    assert all(t.status == "completed" for t in rep.tenants)
    if scenario.startswith("runtime"):
        assert rep.aggregate_peak <= result.budget
        assert 0.0 < result.sharing_gain < 1.0
    if scenario == "runtime_cached":
        assert got_files
    if scenario == "shares":
        assert sum(result.shares.values()) == result.budget
    if scenario.startswith("churn"):
        assert rep.policy == "renegotiate"
    if scenario == "tuned":
        assert result.split_tuning["tuned_stall_s"] <= result.split_tuning["initial_stall_s"]


def test_bad_budget_split_raises_alike():
    def err(side):
        s = SIDES[side]
        with pytest.raises(ValueError) as e:
            s["runtime"].colocate_programs(_programs(s, "tuned"), s["hw"],
                                           budget_split="bogus")
        return str(e.value)

    assert err("port") == err("ref")


def test_tenant_from_program_and_replanner_equal(tmp_path):
    """``tenant_from_program`` persists its schedule to the cache and reuses
    it; ``pipeline_replanner`` re-solves at a lower limit; both equal the
    reference's, canonical artifact bytes included."""
    def run(side):
        s = SIDES[side]
        plan, rt = s["plan"], s["runtime"]
        tr = synth_trace(s["events"], 6)
        key = plan.PlanKey("synthetic", "runtime-unit", s["hw"].name)
        prog = plan.MemoryProgram.from_trace(tr, key)
        limit = int(s["autoswap"](tr, s["hw"], size_threshold=ST).peak_load * 0.7)
        cache = plan.PlanCache(tmp_path / side)
        tenant = rt.tenant_from_program("t", prog, s["hw"], limit, cache=cache)
        again = rt.tenant_from_program("t", cache.load(key), s["hw"], limit, cache=cache)
        replan = rt.pipeline_replanner(s["hw"], size_threshold=ST, cache=cache,
                                       programs={"t": prog})
        decisions, _solve_ms = replan(tenant, int(limit * 0.8))
        files = _cache_files(plan, tmp_path / side)
        return ([tuple(d.__dict__.values()) for d in tenant.decisions],
                [tuple(d.__dict__.values()) for d in again.decisions],
                [tuple(d.__dict__.values()) for d in decisions], files)

    got, want = run("port"), run("ref")
    assert got == want
    assert got[0] and got[0] == got[1] and got[3]


@pytest.mark.parametrize("peaks,budget", [
    ({"a": 5, "b": 3, "c": 2}, 101), ({"a": 7, "b": 7, "c": 7}, 20), ({"a": 0}, 9), ({}, 4),
])
def test_proportional_shares_equal(peaks, budget):
    got = P_runtime.proportional_shares(peaks, budget)
    assert got == R_runtime.proportional_shares(peaks, budget)
    if peaks and sum(peaks.values()):
        assert sum(got.values()) == budget


@pytest.mark.parametrize("target", [None, 90 * MB])
def test_tuned_shares_equal(target):
    """test_tune.py's descent toward a target share, and its flat objective."""
    def run(tune):
        peaks = {"a": 100 * MB, "b": 100 * MB}

        def evaluate(shares):
            return 1.0 if target is None else abs(shares["a"] - target) / MB

        return tune.tuned_shares(peaks, 120 * MB, evaluate, min_delta=MB,
                                 max_evals=40).as_dict()

    got = run(P_tune)
    assert got == run(R_tune)
    assert (got["tuned_stall_s"] < got["initial_stall_s"]) == (target is not None)


def test_objective_and_lanes_equal():
    """``slo_weighted_stall`` and ``binding_constraint`` of the churn
    scenario's report, and ``lane_split_from_waits`` over test_tune.py's
    cases."""
    def run(side):
        s = SIDES[side]
        tune = s["tune"]
        rep = _colocate(side, "churn")[1].report
        ledgers = [rep.attribution, None, {"overhead_s": 1.0, "queue_wait_s": 2.0},
                   {"swap_in_transfer_s": 1.0, "channel_contention_s": 0.2},
                   {"link_blackout_s": 3.0, "swap_in_transfer_s": 1.0}]
        lanes = [tune.lane_split_from_waits(o, i, k, **kw) for o, i, k, kw in (
            (1.0, 1.0, 1, {}), (0.0, 0.0, 4, {}), (1.0, 1.0, 4, {}), (3.0, 1.0, 4, {}),
            (1.0, 3.0, 8, {}), (10.0, 0.0, 4, {}), (0.0, 0.0, 4, {"bytes_in": 3, "bytes_out": 1}))]
        return tune.slo_weighted_stall(rep), [tune.binding_constraint(x) for x in ledgers], lanes

    assert run("port") == run("ref")


# ------------------------------------------------------------ the launcher
def _run_module(module: str, *argv: str, cwd: Path) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", module, *argv], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_colocate_launcher_restores_the_train_launchers_plan(tmp_path):
    """``train --plan-cache`` solves the train step; ``colocate`` with
    ``prefill,decode@2.0,train`` restores it (the same key, planned at the
    reference's 256 KiB threshold) and solves the two serving steps, which
    a second ``colocate`` restores; ``--verify`` certifies every plan and
    the schedule, and ``--json`` writes the report."""
    plans = tmp_path / "plans"
    shape = ("--batch", "2", "--seq", "32")
    out = _run_module("repro_torch.launch.train", "--smoke", "--device", "cpu", "--steps", "1",
                      *shape, "--plan-cache", str(plans), cwd=tmp_path)
    assert "(restored from cache)" not in out
    argv = ("--smoke", "--tenants", "prefill,decode@2.0,train", *shape, "--prompt-len", "16",
            "--gen", "4", "--plan-cache", str(plans), "--verify", "--renegotiate",
            "--json", str(tmp_path / "colocate.json"))
    first = _run_module("repro_torch.launch.colocate", *argv, cwd=tmp_path)
    assert "[plan] qwen3-4b:train: restored from cache" in first
    assert "[plan] qwen3-4b:prefill: solved" in first
    assert "[plan] qwen3-4b:decode: solved" in first
    for name in ("plan qwen3-4b:train", "plan qwen3-4b:prefill", "plan qwen3-4b:decode",
                 "schedule"):
        assert f"[verify] {name}: ok" in first
    second = _run_module("repro_torch.launch.colocate", *argv, cwd=tmp_path)
    assert all(f"[plan] qwen3-4b:{r}: restored from cache" in second
               for r in ("prefill", "decode", "train"))
    report = json.loads((tmp_path / "colocate.json").read_text())
    assert sorted(report["shares"]) == ["qwen3-4b:decode", "qwen3-4b:prefill",
                                        "qwen3-4b:train"]
    assert report["runtime"]["tenants"] and report["aggregate_peak"] <= report["budget"]
    assert [ln for ln in first.splitlines() if ln.startswith("[runtime] aggregate")] == \
        [ln for ln in second.splitlines() if ln.startswith("[runtime] aggregate")]


def test_parse_tenants_equal():
    from repro.launch.colocate import _parse_tenants as R_parse
    from repro_torch.launch.colocate import _parse_tenants as P_parse

    for spec in ("prefill,decode@2.0,train", "mamba2-370m:decode@0.5, qwen3-4b:prefill,",
                 "decode,decode"):
        assert P_parse(spec, "qwen3-4b") == R_parse(spec, "qwen3-4b")
    for bad in ("", "prefill@x", "serve"):
        with pytest.raises(SystemExit) as p:
            P_parse(bad, "qwen3-4b")
        with pytest.raises(SystemExit) as r:
            R_parse(bad, "qwen3-4b")
        assert str(p.value) == str(r.value)
