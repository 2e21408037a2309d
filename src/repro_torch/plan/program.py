"""MemoryProgram: the staged IR between trace capture and plan execution.

Counterpart of ``repro/plan/program.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_plan.py``
holds the two equal.

The paper's contract is "observe one iteration, solve once, reuse forever"
(§III solve, §V lookup).  ``MemoryProgram`` is that contract made first-class:
one object that carries

  * the normalized iteration semantics (variables, lifetimes, access order,
    timing) as an ``IterationTrace``,
  * provenance — which (arch, step signature, hardware) instance this is the
    solution of, so solved plans can be cached and shared across processes,
  * every solved artifact attached so far: SmartPool placements per method,
    baseline pool footprints, AutoSwap schedules + simulated cost per
    (scorer, limit), and lowered offload plans.

Passes (plan/passes.py) consume and extend a program; plan/artifact.py
persists it.  A program restored from disk answers every already-solved
query without re-tracing or re-solving.
"""

from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass, field

from ..core.autoswap import AutoSwapPlanner
from ..core.baseline_pools import PoolStats
from ..core.events import Event, IterationTrace
from ..core.offload import OffloadPlan
from ..core.simulator import SwapDecision
from ..core.smartpool import AllocationPlan


@dataclass(frozen=True)
class PlanKey:
    """Identity of a solved-plan artifact: (arch, step signature, hardware,
    topology).

    ``step_signature`` is a caller-chosen string naming the step instance
    (e.g. ``train:b8s128`` or ``prefill:b4p32``) — it must be computable
    *without* tracing, otherwise a cache hit could never skip the trace.
    Anything that changes the captured event stream (batch/seq shape, model
    config, tracer settings like max_scan_unroll) belongs in the signature.

    ``topology`` names the device topology the trace was captured for: the
    mesh shape plus the PartitionSpec signature of the step's inputs
    (``repro.dist.MeshSpec.plan_topology``).  Empty string means
    single-device — the legacy key shape, so existing artifacts keep their
    cache names — and a sharded capture always sets it non-empty, so a plan
    solved on a 1-device trace is never served to a sharded step (or a
    2-device plan to an 8-device mesh) from the same ``PlanCache``.
    """

    arch: str
    step_signature: str
    hardware: str
    topology: str = ""

    def cache_name(self) -> str:
        """Filesystem-safe artifact name, collision-guarded by a short hash."""
        raw = f"{self.arch}|{self.step_signature}|{self.hardware}"
        if self.topology:
            raw += f"|{self.topology}"
        slug = re.sub(r"[^A-Za-z0-9_.-]+", "_", raw).strip("_")
        digest = hashlib.sha256(raw.encode()).hexdigest()[:10]
        return f"{slug}-{digest}"


def swap_key(scorer: str, limit: int, weights=None) -> str:
    """Artifact-dict key for one solved swap schedule."""
    if weights is not None:
        wsig = hashlib.sha256(
            ",".join(f"{float(w):.12g}" for w in weights).encode()
        ).hexdigest()[:8]
        return f"{scorer}@{limit}#{wsig}"
    return f"{scorer}@{limit}"


@dataclass
class SwapSummary:
    """One solved swap schedule plus its simulated cost (paper Fig 9 row)."""

    scorer: str
    limit: int
    decisions: list[SwapDecision]
    peak_load: int
    load_min: int
    overhead: float
    stalls: int
    per_name_bytes: dict[str, int] = field(default_factory=dict)
    # Solve-context parameters the schedule depends on; a query under a
    # different threshold or hardware model invalidates the cached summary
    # (re-solve).  Cross-process reuse is already hw-safe via PlanKey.
    size_threshold: int = 0
    hardware: str = ""
    # The resident floor (load curve minus absence windows) the solver
    # committed to — the runtime's admission reservation (planned_peak).
    # Greedy selection is best-effort, so the floor may legitimately exceed
    # ``limit``; the static verifier (repro.analyze) proves the decisions
    # reproduce exactly this claim, which catches any dropped or tampered
    # decision.  None on hand-built or legacy summaries (pre-floor format).
    planned_floor: int | None = None

    @property
    def selected_bytes(self) -> int:
        return sum(d.size for d in self.decisions)


@dataclass
class MemoryProgram:
    """The IR.  ``trace`` is None only between TraceCapture (device-event
    source) and IterationDetect; every later pass requires it."""

    trace: IterationTrace | None = None
    key: PlanKey | None = None
    # Raw device events awaiting iteration detection (RecordingDevice path).
    raw_events: list[Event] | None = None
    # Solved artifacts, keyed by strategy name / swap_key().
    pool_plans: dict[str, AllocationPlan] = field(default_factory=dict)
    baselines: dict[str, PoolStats] = field(default_factory=dict)
    swap_summaries: dict[str, SwapSummary] = field(default_factory=dict)
    offload_plans: dict[str, OffloadPlan] = field(default_factory=dict)
    # Solve-time provenance: pass-stage name ("pool:best_fit",
    # "swap:swdoa@<limit>") -> wall milliseconds the stage took to solve.
    # Persisted with the artifact, so a cache-restored program reports the
    # *original* solving process's timings (from_cache distinguishes them).
    # Excluded from the canonical plan bytes (timing is not plan identity),
    # so two solves of the same instance still compare byte-equal.
    solve_ms: dict[str, float] = field(default_factory=dict)
    # Static-verification certificate (repro.analyze Certificate.to_dict()),
    # stamped by ArtifactSave and re-derived on every cache load.  Like
    # solve_ms it is provenance, not identity: excluded from the canonical
    # plan bytes so stamping a certificate never changes plan equality.
    certificate: dict | None = None
    from_cache: bool = False          # True when restored by plan/artifact.py
    dirty: bool = False               # True when a pass added new results
    _swap_planner: AutoSwapPlanner | None = field(default=None, repr=False)
    _swap_planner_sig: tuple | None = field(default=None, repr=False)

    @classmethod
    def from_trace(cls, trace: IterationTrace, key: PlanKey | None = None) -> "MemoryProgram":
        return cls(trace=trace, key=key)

    # ------------------------------------------------------------ accessors
    @property
    def variables(self):
        assert self.trace is not None, "program has no trace yet (run IterationDetect)"
        return self.trace.variables

    @property
    def num_indices(self) -> int:
        assert self.trace is not None
        return self.trace.num_indices

    def require_trace(self) -> IterationTrace:
        if self.trace is None:
            raise ValueError(
                "MemoryProgram has raw events but no trace; run IterationDetect first"
            )
        return self.trace

    def swap_planner(self, hw, size_threshold: int) -> AutoSwapPlanner:
        """Memoized AutoSwapPlanner over this program's trace (scoring is
        deterministic, so one instance serves every selection query)."""
        sig = (hw.name, size_threshold)
        if self._swap_planner is None or self._swap_planner_sig != sig:
            self._swap_planner = AutoSwapPlanner(
                self.require_trace(), hw, size_threshold=size_threshold
            )
            self._swap_planner_sig = sig
        return self._swap_planner
