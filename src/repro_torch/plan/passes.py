"""Pass pipeline: trace -> plan -> execute as explicit, composable stages.

Counterpart of ``repro/plan/passes.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_plan.py``
holds the two equal.  One change: ``PassContext.hw`` defaults to the
port's card, ``H100_SXM``.  ``TraceCapture`` traces a ``step_fn`` with the
port's graph tracer (``core.trace.trace_step_fn``: a torch step on fake
tensors) where the reference traces a jaxpr.

Canonical order (each pass is idempotent and skips work already present):

    TraceCapture      acquire the event stream (the paper's
                      RecordingDevice), or restore a cached program
    IterationDetect   fold raw device events into the canonical iteration
                      (no-op on a program that already holds its trace)
    TimingAssign      give every op index a wall-clock time (hardware model)
    PoolPlacement     offline-DSA placements + baseline pool footprints
    SwapSelection     AutoSwap schedule + simulated cost at an HBM limit
    OffloadLowering   coarsen the selection to checkpoint_name classes
    ArtifactSave      persist newly-solved results to the plan cache

``Pipeline([...]).run(program, ctx)`` threads one ``MemoryProgram`` through
the stages.  Strategy names resolve through plan/registry.py, so a pipeline
is configured entirely by data — the property that lets launchers, the
planner facade, and serialized artifacts all describe the same computation.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Protocol, Sequence, runtime_checkable

from ..core.baseline_pools import PoolStats
from ..core.events import Event, build_trace
from ..core.iteration import IterationDetector
from ..core.offload import KNOWN_NAMES, OffloadPlan
from ..core.simulator import H100_SXM, HardwareSpec, assign_times, simulate_swap_schedule
from ..core.smartpool import AllocationPlan
from .program import MemoryProgram, PlanKey, SwapSummary, swap_key
from .registry import get_pool, get_scorer


class PlanCacheMiss(LookupError):
    """Raised when a cache-only pipeline finds no artifact for its key."""


@dataclass
class PassContext:
    """Ambient state shared by every pass in one pipeline run."""

    hw: HardwareSpec = H100_SXM
    cache: "object | None" = None          # plan.artifact.PlanCache
    key: PlanKey | None = None
    size_threshold: int = 1 << 20          # AutoSwap candidate floor (paper §IV-A)
    log: Callable[[str], None] | None = None

    def note(self, msg: str) -> None:
        if self.log:
            self.log(msg)


@runtime_checkable
class Pass(Protocol):
    name: str

    def run(self, program: MemoryProgram | None, ctx: PassContext) -> MemoryProgram: ...


class Pipeline:
    def __init__(self, passes: Sequence[Pass]):
        self.passes = list(passes)

    def run(
        self, program: MemoryProgram | None = None, ctx: PassContext | None = None
    ) -> MemoryProgram:
        ctx = ctx or PassContext()
        for p in self.passes:
            program = p.run(program, ctx)
            ctx.note(f"[plan] pass {p.name}: done")
        assert program is not None, "pipeline produced no program (no front-end pass?)"
        return program


# ----------------------------------------------------------------- front-ends
@dataclass
class TraceCapture:
    """Front-end: cached artifact > raw device events > a step_fn trace.

    Exactly one source is used per run.  When ``ctx.cache`` holds an artifact
    for ``ctx.key`` the program is restored as-is and *nothing* is re-traced —
    the paper's solve-once contract across processes.
    """

    step_fn: Callable | None = None
    example_args: tuple = ()
    arg_names: Sequence[str] | None = None
    # Must match MemoryPlanner's default: programs cached under the same
    # PlanKey have to come from identical tracer settings (anything that
    # changes the trace belongs in the key's step_signature).  The port's
    # steps have no scans, so it has no effect; it is kept so callers match.
    max_scan_unroll: int = 16
    events: Sequence[Event] | None = None
    name: str = "TraceCapture"

    def run(self, program: MemoryProgram | None, ctx: PassContext) -> MemoryProgram:
        if program is not None:
            return program
        if ctx.cache is not None and ctx.key is not None:
            cached = ctx.cache.load(ctx.key)
            if cached is not None:
                ctx.note(f"[plan] {ctx.key.cache_name()}: restored from cache")
                return cached
        if self.events is not None:
            return MemoryProgram(trace=None, raw_events=list(self.events), key=ctx.key)
        if self.step_fn is None:
            raise PlanCacheMiss(
                f"no step_fn given and no cached plan for key {ctx.key!r}"
            )
        from ..core.trace import trace_step_fn

        trace = trace_step_fn(
            self.step_fn,
            *self.example_args,
            arg_names=self.arg_names,
            max_scan_unroll=self.max_scan_unroll,
        )
        prog = MemoryProgram(trace=trace, key=ctx.key)
        prog.dirty = True
        return prog


@dataclass
class IterationDetect:
    """Fold raw device events into the canonical one-iteration trace (§V).

    No-op for graph-captured programs: one traced step IS the iteration.
    """

    min_period: int = 4
    name: str = "IterationDetect"

    def run(self, program: MemoryProgram | None, ctx: PassContext) -> MemoryProgram:
        assert program is not None
        if program.trace is not None or program.raw_events is None:
            return program
        det = IterationDetector(min_period=self.min_period)
        for ev in program.raw_events:
            det.feed(ev)
        det.finalize()
        events = det.iteration_events()
        program.trace = build_trace(events)
        program.raw_events = None
        program.dirty = True
        return program


# ----------------------------------------------------------------- middle-ends
@dataclass
class TimingAssign:
    """Attach the hardware timing model (op_times) to the trace."""

    name: str = "TimingAssign"

    def run(self, program: MemoryProgram | None, ctx: PassContext) -> MemoryProgram:
        assert program is not None
        trace = program.require_trace()
        if trace.op_times is None:
            assign_times(trace, ctx.hw)
            program.dirty = True
        return program


@dataclass
class PoolPlacement:
    """Solve pool placements for each named method (registry-dispatched).

    ``AllocationPlan`` results land in ``program.pool_plans``; baseline
    ``PoolStats`` (cnmem/exact) land in ``program.baselines``.
    """

    methods: Sequence[str] = ("best_fit",)
    name: str = "PoolPlacement"

    def run(self, program: MemoryProgram | None, ctx: PassContext) -> MemoryProgram:
        assert program is not None
        trace = program.require_trace()
        for m in self.methods:
            if m in program.pool_plans or m in program.baselines:
                continue
            t0 = time.perf_counter()
            result = get_pool(m)(trace)
            ms = (time.perf_counter() - t0) * 1e3
            if isinstance(result, AllocationPlan):
                program.pool_plans[m] = result
            elif isinstance(result, PoolStats):
                program.baselines[m] = result
            else:
                raise TypeError(f"pool {m!r} returned {type(result).__name__}")
            program.solve_ms[f"pool:{m}"] = ms
            ctx.note(f"[plan] pool {m}: solved in {ms:.1f} ms")
            program.dirty = True
        return program


@dataclass
class SwapSelection:
    """Select a swap schedule at an HBM limit and simulate its cost (§IV)."""

    limit: int = 0
    scorer: str = "swdoa"
    weights: Sequence[float] | None = None
    name: str = "SwapSelection"

    def key(self) -> str:
        return swap_key(self.scorer, self.limit, self.weights)

    def run(self, program: MemoryProgram | None, ctx: PassContext) -> MemoryProgram:
        assert program is not None
        k = self.key()
        prior = program.swap_summaries.get(k)
        if prior is not None and (prior.size_threshold, prior.hardware) == (
            ctx.size_threshold,
            ctx.hw.name,
        ):
            return program
        t0 = time.perf_counter()
        planner = program.swap_planner(ctx.hw, ctx.size_threshold)
        if self.weights is not None:
            decisions = planner.select(self.limit, None, list(self.weights))
        else:
            decisions = get_scorer(self.scorer)(planner, self.limit)
        sim = simulate_swap_schedule(program.require_trace(), decisions, ctx.hw, self.limit)
        ms = (time.perf_counter() - t0) * 1e3
        program.solve_ms[f"swap:{k}"] = ms
        ctx.note(f"[plan] swap {k}: solved in {ms:.1f} ms")
        by_id = program.require_trace().by_id()
        per_name: dict[str, int] = {}
        for d in decisions:
            nm = by_id[d.var].name or "?"
            per_name[nm] = per_name.get(nm, 0) + d.size
        from ..analyze.plan_check import resident_floor

        program.swap_summaries[k] = SwapSummary(
            scorer=self.scorer,
            limit=self.limit,
            decisions=decisions,
            peak_load=planner.peak_load,
            load_min=planner.load_min(),
            overhead=sim.overhead,
            stalls=sim.stalls,
            per_name_bytes=per_name,
            size_threshold=ctx.size_threshold,
            hardware=ctx.hw.name,
            planned_floor=resident_floor(program.require_trace(), decisions)[0],
        )
        program.dirty = True
        return program


@dataclass
class OffloadLowering:
    """Coarsen a per-variable selection to checkpoint_name classes.

    A name class is offloaded when the planner selected a majority of its
    candidate bytes — the scan-uniformity coarsening documented in
    DESIGN.md §2.  Requires the matching SwapSelection result (it is solved
    here if missing).
    """

    limit: int = 0
    scorer: str = "swdoa"
    weights: Sequence[float] | None = None
    name: str = "OffloadLowering"

    def key(self) -> str:
        return swap_key(self.scorer, self.limit, self.weights)

    def run(self, program: MemoryProgram | None, ctx: PassContext) -> MemoryProgram:
        assert program is not None
        k = self.key()
        prior = program.swap_summaries.get(k)
        if k in program.offload_plans and (
            prior is not None
            and (prior.size_threshold, prior.hardware)
            == (ctx.size_threshold, ctx.hw.name)
        ):
            return program
        program = SwapSelection(self.limit, self.scorer, self.weights).run(program, ctx)
        decisions = program.swap_summaries[k].decisions
        planner = program.swap_planner(ctx.hw, ctx.size_threshold)
        by_id = program.require_trace().by_id()
        selected: dict[str, int] = {}
        total: dict[str, int] = {}
        chosen_vars = {d.var for d in decisions}
        for c in planner.candidates:
            nm = by_id[c.var].name or ""
            if nm not in KNOWN_NAMES:
                continue
            total[nm] = total.get(nm, 0) + c.size
            if c.var in chosen_vars:
                selected[nm] = selected.get(nm, 0) + c.size
        names = [n for n, b in selected.items() if b >= 0.5 * total.get(n, 1)]
        plan = OffloadPlan(offload_names=sorted(names))
        plan.predicted_savings = sum(selected.values())
        plan.transfer_bytes = 2 * plan.predicted_savings
        program.offload_plans[k] = plan
        program.dirty = True
        return program


# ------------------------------------------------------------------ back-end
@dataclass
class ArtifactSave:
    """Persist the program when it gained results and a cache is configured.

    Before writing, the solved plan is swept by the static verifier and the
    resulting certificate embedded in the artifact (outside the canonical
    plan-identity bytes).  The artifact is stored either way — a failing
    certificate is surfaced as a note here and demoted to a cache miss on
    every future ``PlanCache.load``."""

    name: str = "ArtifactSave"

    def run(self, program: MemoryProgram | None, ctx: PassContext) -> MemoryProgram:
        assert program is not None
        if ctx.cache is not None and program.key is not None and program.dirty:
            from ..analyze.plan_check import verify_program

            cert = verify_program(program)
            program.certificate = cert.to_dict()
            if not cert.ok:
                ctx.note(
                    f"[plan] certificate FAILED: {', '.join(cert.failed())}"
                )
            path = ctx.cache.store(program)
            program.dirty = False
            ctx.note(f"[plan] saved artifact {path}")
        return program
