"""Build runtime tenants from solved MemoryPrograms and the plan cache.

Counterpart of ``repro/runtime/tenants.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_colocate.py``
holds the two equal.

A tenant is one (trace, swap schedule) pair drawn from the ``repro.plan``
pipeline.  ``tenant_from_program`` solves (or reuses) a SwapSelection at the
tenant's HBM share; ``colocate_programs`` splits one shared budget across N
programs proportionally to their isolated peaks, solves each tenant's plan
at its share, and runs them together through the ``MemoryRuntime`` — the
serving-fleet shape from TENSILE: several dynamic workloads, one device.

Plans load through ``PlanCache`` warm-start exactly like the launchers: a
program restored from disk contributes its cached schedule without
re-tracing or re-solving.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..core.simulator import HardwareSpec, SimResult
from ..plan.passes import ArtifactSave, PassContext, Pipeline, SwapSelection, TimingAssign
from ..plan.program import MemoryProgram, swap_key
from .engine import MemoryRuntime, RuntimeReport, Tenant, simulate_program


def tenant_from_program(
    name: str,
    program: MemoryProgram,
    hw: HardwareSpec,
    limit: int,
    scorer: str = "swdoa",
    size_threshold: int = 1 << 20,
    cache=None,
    iterations: int = 1,
    arrival_t: float = 0.0,
    priority: float = 1.0,
    departure_t: float | None = None,
) -> Tenant:
    """Solve (or restore) the program's swap schedule at `limit` and wrap it
    as a runtime tenant.  Newly-solved results persist when `cache` is set."""
    ctx = PassContext(hw=hw, cache=cache, key=program.key, size_threshold=size_threshold)
    passes = [TimingAssign(), SwapSelection(limit=limit, scorer=scorer)]
    if cache is not None and program.key is not None:
        passes.append(ArtifactSave())
    program = Pipeline(passes).run(program, ctx)
    summary = program.swap_summaries[swap_key(scorer, limit)]
    return Tenant(
        name=name,
        trace=program.require_trace(),
        decisions=list(summary.decisions),
        limit=limit,
        iterations=iterations,
        arrival_t=arrival_t,
        priority=priority,
        departure_t=departure_t,
    )


def pipeline_replanner(
    hw: HardwareSpec,
    scorer: str = "swdoa",
    size_threshold: int = 1 << 20,
    cache=None,
    programs: "dict[str, MemoryProgram] | None" = None,
):
    """Online re-solve hook for ``MemoryRuntime(renegotiate=True)``.

    Returns ``replan(tenant, new_limit) -> (decisions, solve_wall_ms)``
    running the plan pipeline's SwapSelection pass — the near-linear solve
    path, so renegotiating at admission time is cheap.  When ``programs``
    maps tenant names to their ``MemoryProgram``s (as in
    ``colocate_programs``), re-solves reuse each program's memoized planner
    (rankings are shared across limits) and persist to ``cache``; otherwise
    a program is wrapped around the tenant's trace on first use.
    """
    progs: dict[str, MemoryProgram] = dict(programs or {})

    def replan(tenant: Tenant, new_limit: int) -> tuple[list, float]:
        program = progs.get(tenant.name)
        if program is None:
            program = MemoryProgram.from_trace(tenant.trace)
            progs[tenant.name] = program
        ctx = PassContext(
            hw=hw, cache=cache, key=program.key, size_threshold=size_threshold
        )
        passes = [TimingAssign(), SwapSelection(limit=new_limit, scorer=scorer)]
        if cache is not None and program.key is not None:
            passes.append(ArtifactSave())
        # Time this call, not program.solve_ms[...]: when SwapSelection hits
        # its memoized summary (same limit re-staged after a cancelled
        # renegotiation) the stored figure is the *original* solve's wall
        # time, which this replan did not spend.
        t0 = time.perf_counter()
        program = Pipeline(passes).run(program, ctx)
        ms = (time.perf_counter() - t0) * 1e3
        k = swap_key(scorer, new_limit)
        return list(program.swap_summaries[k].decisions), ms

    return replan


@dataclass
class ColocationResult:
    """A co-located run next to each tenant's isolated baselines.

    Two isolation baselines bracket the comparison: ``natural_peaks`` is what
    static per-tenant provisioning must reserve (the unswapped peak load of
    each program), ``isolated`` is each tenant run alone under its own share
    with its swap schedule.  Co-location wins when ``aggregate_peak`` lands
    below the sum of the natural peaks at acceptable per-tenant overhead.
    """

    report: RuntimeReport
    budget: int
    isolated: dict[str, SimResult] = field(default_factory=dict)
    natural_peaks: dict[str, int] = field(default_factory=dict)
    # Wall ms spent solving each tenant's plan at admission (cache hits are
    # ~0): plans are solved online when a tenant is admitted, so solve
    # latency is part of the serving path and reported next to overhead.
    plan_solve_ms: dict[str, float] = field(default_factory=dict)
    # Budget share each tenant's plan was solved at (largest-remainder
    # proportional split: shares sum to the budget before peak clamping).
    shares: dict[str, int] = field(default_factory=dict)
    # Which split policy produced ``shares`` ("proportional" | "tuned") and,
    # for tuned splits, the ``repro.tune`` descent record (as_dict form).
    budget_split: str = "proportional"
    split_tuning: dict | None = None

    @property
    def sum_isolated_peaks(self) -> int:
        return sum(r.peak_resident for r in self.isolated.values())

    @property
    def sum_natural_peaks(self) -> int:
        return sum(self.natural_peaks.values())

    @property
    def sharing_gain(self) -> float:
        """Fraction of HBM saved by pooling vs statically provisioning each
        tenant its natural peak: 1 - aggregate_peak / sum(natural peaks)."""
        s = self.sum_natural_peaks
        return 1.0 - self.report.aggregate_peak / s if s else 0.0

    def as_dict(self) -> dict:
        return {
            "budget": self.budget,
            "sum_natural_peaks": self.sum_natural_peaks,
            "sum_isolated_peaks": self.sum_isolated_peaks,
            "aggregate_peak": self.report.aggregate_peak,
            "sharing_gain": self.sharing_gain,
            "natural_peaks": dict(self.natural_peaks),
            "shares": dict(self.shares),
            "budget_split": self.budget_split,
            **({"split_tuning": dict(self.split_tuning)}
               if self.split_tuning is not None else {}),
            "plan_solve_ms": {n: round(v, 3) for n, v in self.plan_solve_ms.items()},
            "runtime": self.report.as_dict(),
            "isolated": {
                n: {
                    "peak_resident": r.peak_resident,
                    "overhead": r.overhead,
                    "stalls": r.stalls,
                }
                for n, r in self.isolated.items()
            },
        }


def proportional_shares(peaks: dict[str, int], budget: int) -> dict[str, int]:
    """Split ``budget`` proportionally to ``peaks`` with largest-remainder
    rounding, so the granted shares sum exactly to the budget (plain integer
    truncation silently withholds up to N-1 bytes)."""
    names = list(peaks)
    total = sum(peaks.values())
    if not names or total <= 0:
        return {n: budget for n in names}
    shares = {n: budget * peaks[n] // total for n in names}
    leftover = budget - sum(shares.values())
    by_remainder = sorted(names, key=lambda n: (-((budget * peaks[n]) % total), n))
    for n in by_remainder[:leftover]:
        shares[n] += 1
    return shares


def colocate_programs(
    named_programs: dict[str, MemoryProgram],
    hw: HardwareSpec,
    budget_frac: float = 0.8,
    budget: int | None = None,
    channels: int = 2,
    scorer: str = "swdoa",
    size_threshold: int = 1 << 20,
    cache=None,
    iterations: int = 1,
    arrivals: "dict[str, float] | None" = None,
    priorities: "dict[str, float] | None" = None,
    departures: "dict[str, float] | None" = None,
    renegotiate: bool = False,
    record_events: bool = True,
    obs=None,
    budget_split: str = "proportional",
    split_evals: int = 24,
    victim_policy=None,
) -> ColocationResult:
    """Co-schedule N solved programs under one shared HBM budget.

    The budget defaults to ``budget_frac`` of the sum of isolated peak loads;
    each tenant's swap schedule is solved at its proportional share (clamped
    to its trace peak so an under-committed tenant gets a no-op schedule).
    ``budget_split="tuned"`` instead coordinate-descends the split with
    ``repro.tune.tuned_shares`` (up to ``split_evals`` trial colocations),
    keeping only moves that strictly reduce SLO-weighted total stall; the
    descent record lands in ``ColocationResult.split_tuning``.

    ``victim_policy`` overrides the engine's renegotiation victim policy
    (default floor-greedy; ``repro.tune.LedgerVictimPolicy`` scores
    candidates by simulated marginal ledger).

    Churn: ``arrivals``/``priorities``/``departures`` map tenant names to
    their arrival time, SLO weight, and optional open-ended departure event;
    ``renegotiate=True`` lets the runtime shrink a running victim's plan (an
    online SwapSelection re-solve through this same pipeline and ``cache``)
    instead of only queueing a newcomer that doesn't fit.

    ``record_events=False`` disables the runtime's per-transfer event logs
    for fleet-scale horizons (the report's simulated figures are unchanged).
    ``obs`` attaches a ``repro.obs.ObsRecorder`` to the shared runtime (the
    isolated baselines are never observed): pure observer, identical report.
    """
    arrivals = arrivals or {}
    priorities = priorities or {}
    departures = departures or {}
    peaks = {n: p.require_trace().peak_load() for n, p in named_programs.items()}
    total = sum(peaks.values())
    if budget is None:
        budget = int(total * budget_frac)
    if budget_split not in ("proportional", "tuned"):
        raise ValueError(f"unknown budget_split {budget_split!r}")
    shares = proportional_shares(peaks, budget)
    replanner = pipeline_replanner(
        hw, scorer=scorer, size_threshold=size_threshold, cache=cache,
        programs=named_programs,
    )

    def build_tenants(shs, solve_ms: "dict[str, float] | None" = None):
        tenants = []
        for n, p in named_programs.items():
            share = min(shs[n], peaks[n])
            t0 = time.perf_counter()
            tenants.append(
                tenant_from_program(
                    n, p, hw, share, scorer=scorer,
                    size_threshold=size_threshold, cache=cache,
                    iterations=iterations,
                    arrival_t=arrivals.get(n, 0.0),
                    priority=priorities.get(n, 1.0),
                    departure_t=departures.get(n),
                )
            )
            if solve_ms is not None:
                solve_ms[n] = (time.perf_counter() - t0) * 1e3
        return tenants

    split_tuning = None
    if budget_split == "tuned":
        from ..tune import slo_weighted_stall, tuned_shares

        def evaluate(shs):
            # Trial colocations: no event logs, no observer — only the
            # simulated report matters, and it is unchanged by either.
            rt = MemoryRuntime(
                hw, budget=budget, channels=channels, renegotiate=renegotiate,
                replanner=replanner, record_events=False,
                victim_policy=victim_policy,
            )
            return slo_weighted_stall(rt.run(build_tenants(shs)))

        tuning = tuned_shares(peaks, budget, evaluate,
                              start=shares, max_evals=split_evals)
        shares, split_tuning = tuning.shares, tuning.as_dict()

    plan_solve_ms: dict[str, float] = {}
    tenants = build_tenants(shares, plan_solve_ms)
    isolated = {
        t.name: simulate_program(t.trace, t.decisions, hw, t.limit, channels=channels)
        for t in tenants
    }
    rt = MemoryRuntime(
        hw, budget=budget, channels=channels, renegotiate=renegotiate,
        replanner=replanner, record_events=record_events, obs=obs,
        victim_policy=victim_policy,
    )
    report = rt.run(tenants)
    return ColocationResult(
        report=report, budget=budget, isolated=isolated, natural_peaks=peaks,
        plan_solve_ms=plan_solve_ms, shares=shares,
        budget_split=budget_split, split_tuning=split_tuning,
    )
