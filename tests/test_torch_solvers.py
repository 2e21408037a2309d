"""The port's planner core (``repro_torch.core``, ``repro_torch.runtime``)
against the JAX package's production modules, on the same inputs.

The solvers are framework-free, so every comparison is ``==``: SmartPool
placements and footprints, the baseline pools' stats, AutoSwap's
candidates, scores and selections (in order, including the WDOA tie order
at ``n_layers=6, frac=0.5`` where ``repro.core.autoswap`` differs from its
frozen oracle), every ``SimResult`` field, the runtime engine's reports,
``tune_swap_weights`` at a fixed seed and ``RecordingDevice``'s events and
detected iteration.  Inputs are drawn from seeded numpy generators; the
reference's traces are carried into the port field by field.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from repro.core import autoswap as R_autoswap
from repro.core import baseline_pools as R_baseline
from repro.core import bayesopt as R_bayesopt
from repro.core import events as R_events
from repro.core import simulator as R_sim
from repro.core import smartpool as R_smartpool
from repro.core.trace import RecordingDevice as R_RecordingDevice
from repro.runtime import engine as R_engine
from repro.runtime import workload as R_workload
from repro.runtime.tenants import pipeline_replanner as R_pipeline_replanner
from repro_torch.core import autoswap as P_autoswap
from repro_torch.core import baseline_pools as P_baseline
from repro_torch.core import bayesopt as P_bayesopt
from repro_torch.core import events as P_events
from repro_torch.core import simulator as P_sim
from repro_torch.core import smartpool as P_smartpool
from repro_torch.core.trace import RecordingDevice as P_RecordingDevice
from repro_torch.runtime import engine as P_engine
from repro_torch.runtime import workload as P_workload
from repro_torch.runtime.tenants import pipeline_replanner as P_pipeline_replanner
from tests.test_solvetime import HW as R_HW_TEST
from tests.test_solvetime import make_trace, synth_trace

THRESHOLD = 1 << 20
SCORERS = ("swdoa", "wdoa", "aoa", "doa")


def to_port(tr: R_events.IterationTrace) -> P_events.IterationTrace:
    """The reference trace as the port's objects, field by field."""
    vs = [P_events.VariableInfo(v.var, v.size, v.alloc_index, v.free_index,
                                list(v.accesses), list(v.access_is_write), v.name)
          for v in tr.variables]
    return P_events.IterationTrace(
        vs, tr.num_indices,
        op_times=None if tr.op_times is None else list(tr.op_times),
        op_costs=None if tr.op_costs is None else dict(tr.op_costs),
        op_extra_s=None if tr.op_extra_s is None else dict(tr.op_extra_s),
    )


def port_hw(hw) -> P_sim.HardwareSpec:
    return P_sim.HardwareSpec(**dataclasses.asdict(hw))


def ref_hw(hw) -> R_sim.HardwareSpec:
    return R_sim.HardwareSpec(**dataclasses.asdict(hw))


# (reference spec, port spec) for each named card: the port's H100 is held
# to the reference's code under the same figures.
SPECS = {
    "test": (R_HW_TEST, port_hw(R_HW_TEST)),
    "gtx1080ti": (R_sim.GTX_1080TI, P_sim.GTX_1080TI),
    "tpu_v5e": (R_sim.TPU_V5E, P_sim.TPU_V5E),
    "h100_sxm": (ref_hw(P_sim.H100_SXM), P_sim.H100_SXM),
}


def random_intervals(seed: int, n_max: int = 40) -> list[tuple[int, int, int]]:
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, n_max + 1))
    sizes = rng.integers(1, 100_001, n)
    allocs = rng.integers(0, 41, n)
    durs = rng.integers(1, 41, n)
    return [(int(s), int(a), int(a + d)) for s, a, d in zip(sizes, allocs, durs)]


def degenerate_trace() -> R_events.IterationTrace:
    """Zero-length and inverted lifetimes (tests/test_solvetime.py's case)."""
    intervals = [
        (1000, 0, 10), (2000, 0, 10), (500, 2, 8), (266, 3, 3),
        (1536, 4, 9), (266, 5, 1), (700, 1, 0), (4096, 0, 12), (128, 6, 7),
    ]
    vs = [R_events.VariableInfo(i, s, a, f) for i, (s, a, f) in enumerate(intervals)]
    return R_events.IterationTrace(vs, 12)


POOL_TRACES = {
    **{f"random{seed}": (lambda seed=seed: make_trace(random_intervals(seed)))
       for seed in range(6)},
    "duplicate_allocs": lambda: make_trace(
        [(4096, 0, 100)] * 3 + [(1000 + 13 * i, 5, 5 + i + 1) for i in range(20)]
        + [(777, 30, 60), (512, 59, 61), (2048, 60, 90)]),
    "dense": lambda: make_trace([(1024 * (i + 1), 0, 50) for i in range(30)]),
    "degenerate": degenerate_trace,
}


# ------------------------------------------------------------------ SmartPool
@pytest.mark.parametrize("method", ["best_fit", "first_fit"])
@pytest.mark.parametrize("case", sorted(POOL_TRACES))
def test_smartpool_placements_equal(case, method):
    tr = POOL_TRACES[case]()
    for engine in ("event", "bulk", "auto"):
        want = R_smartpool.solve(tr, method, engine=engine)
        got = P_smartpool.solve(to_port(tr), method, engine=engine)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), engine
        assert got.competitive_ratio == want.competitive_ratio


@pytest.mark.parametrize("seed", range(4))
def test_brute_force_optimal_equal(seed):
    tr = make_trace(random_intervals(100 + seed, n_max=6))
    for alignment in (1, 256):
        assert (P_smartpool.brute_force_optimal(to_port(tr), alignment)
                == R_smartpool.brute_force_optimal(tr, alignment))


# -------------------------------------------------------------- baseline pools
@pytest.mark.parametrize("case", sorted(POOL_TRACES))
def test_baseline_pools_equal(case):
    tr = POOL_TRACES[case]()
    got, want = P_baseline.CnMemPool().run(to_port(tr)), R_baseline.CnMemPool().run(tr)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    got, want = P_baseline.exact_allocator(to_port(tr)), R_baseline.exact_allocator(tr)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# -------------------------------------------------------------------- AutoSwap
def planners(n_layers: int, hw: str = "test"):
    tr = synth_trace(n_layers=n_layers)
    r_hw, p_hw = SPECS[hw]
    return (R_autoswap.AutoSwapPlanner(tr, r_hw, size_threshold=THRESHOLD),
            P_autoswap.AutoSwapPlanner(to_port(tr), p_hw, size_threshold=THRESHOLD))


def decision_key(ds):
    return [(d.var, d.size, d.out_after, d.in_before, d.wraps) for d in ds]


# (6, 0.5) is the example at which repro.core.autoswap's WDOA order differs
# from its frozen oracle's (var 10 and var 2 tie): the port follows autoswap.
@pytest.mark.parametrize("n_layers,frac", [(6, 0.5), (2, 0.45), (4, 0.7), (10, 0.55), (12, 0.95)])
def test_autoswap_candidates_scores_selections_equal(n_layers, frac):
    ref, port = planners(n_layers)
    assert [dataclasses.asdict(c) for c in port.candidates] == \
        [dataclasses.asdict(c) for c in ref.candidates]
    assert (port.peak_load, port.peak_time) == (ref.peak_load, ref.peak_time)
    limit = int(port.peak_load * frac)
    for scorer in SCORERS:
        assert decision_key(port.select(limit, scorer)) == decision_key(ref.select(limit, scorer))
        assert [c.var for c in port.ranked(scorer)] == [c.var for c in ref.ranked(scorer)]
    w = [0.4, 0.1, 0.2, 0.3]
    assert decision_key(port.select(limit, None, w)) == decision_key(ref.select(limit, None, w))
    assert port.load_min() == ref.load_min()
    assert port.updated_load(port.select(limit, "swdoa")).tolist() == \
        ref.updated_load(ref.select(limit, "swdoa")).tolist()
    for key, arr in ref.standardized().items():
        assert port.standardized()[key].tolist() == arr.tolist()


def test_autoswap_max_zero_overhead_reduction_equal():
    ref, port = planners(6)
    assert port.max_zero_overhead_reduction(method="swdoa", grid=8) == \
        ref.max_zero_overhead_reduction(method="swdoa", grid=8)


# ------------------------------------------------------------------ simulator
def sim_fields(res) -> dict:
    d = dataclasses.asdict(res)
    d["overhead"] = res.overhead
    return d


@pytest.mark.parametrize("hw", ["gtx1080ti", "tpu_v5e", "h100_sxm"])
@pytest.mark.parametrize("scorer", SCORERS)
def test_simulate_swap_schedule_equal(hw, scorer):
    ref, port = planners(8, hw)
    assert port.trace.op_times == ref.trace.op_times
    assert P_sim.iteration_time(port.trace, SPECS[hw][1], P_sim.CUDA_MALLOC_COST_S) == \
        R_sim.iteration_time(ref.trace, SPECS[hw][0], R_sim.CUDA_MALLOC_COST_S)
    for frac in (0.5, 0.7, 0.9):
        limit = int(port.peak_load * frac)
        want = R_sim.simulate_swap_schedule(ref.trace, ref.select(limit, scorer), SPECS[hw][0], limit)
        got = P_sim.simulate_swap_schedule(port.trace, port.select(limit, scorer), SPECS[hw][1], limit)
        assert sim_fields(got) == sim_fields(want), frac
        assert sim_fields(port.evaluate(limit, scorer)) == sim_fields(ref.evaluate(limit, scorer))


@pytest.mark.parametrize("channels", [1, 2, 4])
@pytest.mark.parametrize("prefetch", ["eager", "backsched"])
def test_simulate_program_equal(channels, prefetch):
    ref, port = planners(6, "gtx1080ti")
    limit = int(port.peak_load * 0.7)
    want = R_engine.simulate_program(ref.trace, ref.select(limit, "swdoa"), SPECS["gtx1080ti"][0],
                                     limit, channels=channels, prefetch=prefetch)
    got = P_engine.simulate_program(port.trace, port.select(limit, "swdoa"), SPECS["gtx1080ti"][1],
                                    limit, channels=channels, prefetch=prefetch)
    assert sim_fields(got) == sim_fields(want)


def churn_run(E, W, A, hw, renegotiate: bool, replanner=None):
    """A seeded Poisson churn of tenants beside a long-running base tenant,
    under a budget that fits the base's floor and half of a newcomer's
    (tests/test_engine_equiv.py's shape), run by engine module ``E``."""
    templates = {"small": W.synthetic_train_trace(4), "medium": W.synthetic_train_trace(6),
                 "base": W.synthetic_train_trace(10)}
    plans = {}
    for name, tr in templates.items():
        pl = A.AutoSwapPlanner(tr, hw, size_threshold=THRESHOLD)
        limit = int(pl.peak_load * 0.7)
        plans[name] = (limit, pl.select(limit, "swdoa"))
    floors = {n: E.planned_peak(templates[n], plans[n][1]) for n in templates}
    budget = floors["base"] + (floors["small"] + floors["medium"]) // 2
    items = W.poisson_workload(["small", "medium"], 6, 50.0, seed=7, iterations=(1, 3))
    tenants = [E.Tenant("base", templates["base"], list(plans["base"][1]),
                        limit=plans["base"][0], iterations=6, priority=0.5)]
    for it in items:
        limit, decisions = plans[it.template]
        tenants.append(E.Tenant(it.name, templates[it.template], list(decisions), limit=limit,
                                iterations=it.iterations, arrival_t=it.arrival_t,
                                priority=it.priority))
    rt = E.MemoryRuntime(hw, budget=budget, channels=2, renegotiate=renegotiate,
                         replan_size_threshold=THRESHOLD, replanner=replanner)
    return rt.run(tenants)


@pytest.mark.parametrize("renegotiate", [False, True])
def test_multi_tenant_runtime_equal(renegotiate):
    r_hw, p_hw = SPECS["gtx1080ti"]
    want = churn_run(R_engine, R_workload, R_autoswap, r_hw, renegotiate,
                     R_pipeline_replanner(r_hw, size_threshold=THRESHOLD) if renegotiate else None)
    got = churn_run(P_engine, P_workload, P_autoswap, p_hw, renegotiate,
                    P_pipeline_replanner(p_hw, size_threshold=THRESHOLD) if renegotiate else None)
    assert json.dumps(P_engine.simulated_report_dict(got), sort_keys=True) == \
        json.dumps(R_engine.simulated_report_dict(want), sort_keys=True)
    assert (got.renegotiations > 0) == renegotiate


def test_renegotiation_without_replanner_names_its_queue():
    """Without ``replanner=``, renegotiation re-solves through the default,
    the plan pipeline's ``pipeline_replanner`` (``runtime/tenants.py``), as
    the reference's does.  Until the tenants module was ported this test
    checked that the engine raised an error naming ROADMAP queue A item 9;
    it keeps that name."""
    r_hw, p_hw = SPECS["gtx1080ti"]
    want = churn_run(R_engine, R_workload, R_autoswap, r_hw, renegotiate=True)
    got = churn_run(P_engine, P_workload, P_autoswap, p_hw, renegotiate=True)
    assert json.dumps(P_engine.simulated_report_dict(got), sort_keys=True) == \
        json.dumps(R_engine.simulated_report_dict(want), sort_keys=True)
    assert got.renegotiations > 0


@pytest.mark.parametrize("n_layers", [4, 8])
def test_synthetic_train_trace_equal(n_layers):
    kw = dict(n_layers=n_layers, act_bytes=10_485_760, weight_bytes=201_850_880,
              flops_per_op=4.13e11, bytes_per_op=201_850_880)
    want, got = R_workload.synthetic_train_trace(**kw), P_workload.synthetic_train_trace(**kw)
    assert [dataclasses.asdict(v) for v in got.variables] == \
        [dataclasses.asdict(v) for v in want.variables]
    assert (got.num_indices, got.op_costs) == (want.num_indices, want.op_costs)
    assert P_workload.parse_arrivals("poisson:rate=20,seed=3", 5) == \
        R_workload.parse_arrivals("poisson:rate=20,seed=3", 5)


# ------------------------------------------------------------------- bayesopt
def test_tune_swap_weights_equal():
    ref, port = planners(6)
    limit = int(port.peak_load * 0.55)
    want = R_bayesopt.tune_swap_weights(ref, limit, n_iter=6, seed=3)
    got = P_bayesopt.tune_swap_weights(port, limit, n_iter=6, seed=3)
    assert got.best_y == want.best_y
    assert got.best_x.tolist() == want.best_x.tolist()
    assert got.history_x.tolist() == want.history_x.tolist()
    assert got.history_y.tolist() == want.history_y.tolist()


# ------------------------------------------------------------ RecordingDevice
def drive(dev, seed: int, n_iters: int = 3) -> None:
    """The same seeded Malloc/Exec/Free stream: each iteration allocates
    blocks of drawn sizes, runs ops over drawn read/write sets, frees them."""
    rng = np.random.default_rng(seed)
    sizes = [int(s) for s in rng.integers(1, 1 << 22, int(rng.integers(3, 8)))]
    ops = [(rng.permutation(len(sizes))[: int(rng.integers(1, 3))],
            rng.permutation(len(sizes))[: int(rng.integers(1, 3))]) for _ in range(5)]
    for _ in range(n_iters):
        blocks = [dev.malloc(s) for s in sizes]
        for reads, writes in ops:
            dev.exec(None, [blocks[i] for i in reads], [blocks[i] for i in writes])
        for b in reversed(blocks):
            dev.free(b)


@pytest.mark.parametrize("seed", range(3))
def test_recording_device_equal(seed):
    ref, port = R_RecordingDevice(min_period=4), P_RecordingDevice(min_period=4)
    drive(ref, seed)
    drive(port, seed)
    assert [(int(e.kind), e.var, e.size, e.index) for e in port.events] == \
        [(int(e.kind), e.var, e.size, e.index) for e in ref.events]
    want, got = ref.iteration_trace(), port.iteration_trace()
    assert port._detector.period == ref._detector.period
    assert port.iteration_detected == ref.iteration_detected
    assert [dataclasses.asdict(v) for v in got.variables] == \
        [dataclasses.asdict(v) for v in want.variables]
    assert got.num_indices == want.num_indices
    assert got.load_curve() == want.load_curve()
