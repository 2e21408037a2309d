"""MemoryPlanner: facade over the repro_torch.plan pass pipeline.

Counterpart of ``repro/core/planner.py``, whose code this is with its
imports pointed into the port; two changes: ``hw`` defaults to the port's
card, ``H100_SXM``, and the step function is a torch one, traced on fake
tensors by ``core.trace.trace_step_fn`` (``max_scan_unroll`` has no effect:
the port's steps have no scans).  ``offload_plan`` returns the
``OffloadPlan``, which ``OffloadPlan.policy()`` executes in the train
step (``core/offload_exec.py``).  ``tests/test_torch_planner.py`` holds
the reports equal to the reference's on one cached program.

    step_fn --TraceCapture--> MemoryProgram --PoolPlacement--> allocation plan
                                           \\--SwapSelection--> swap schedule
                                                            \\--> OffloadLowering

This is the model-transparent entry point: it needs only the step function
and example shapes (exactly like the paper's Device needs only the event
stream).  Every stage is a pass over a
``repro_torch.plan.MemoryProgram`` and the solved results can be cached on disk
(``cache=PlanCache(dir), key=PlanKey(arch, step_sig, hw)``): a second
process with the same key reloads the artifact and never re-traces.

Outputs:

  * ``report()``     — peak load omega(G), SmartPool chi(G) + competitive
                       ratio vs the CnMem-style online pool and the exact
                       allocator (paper Table I quantities);
  * ``swap_report(limit)`` — AutoSwap selection + simulated overhead at an
                       HBM budget (paper Fig 9 / Table II quantities);
  * ``offload_plan(limit)`` — the name-level offload set (core/offload.py)
                       that AutoSwap's selection lowers to.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from ..plan.artifact import PlanCache
from ..plan.passes import (
    ArtifactSave,
    IterationDetect,
    OffloadLowering,
    PassContext,
    Pipeline,
    PoolPlacement,
    SwapSelection,
    TimingAssign,
    TraceCapture,
)
from ..plan.program import MemoryProgram, PlanKey, swap_key
from .autoswap import AutoSwapPlanner, ScoreName
from .events import IterationTrace
from .offload import OffloadPlan
from .simulator import H100_SXM, HardwareSpec


@dataclass
class PoolReport:
    peak_load: int
    smartpool_footprint: int
    smartpool_ratio: float
    cnmem_footprint: int
    cnmem_ratio: float
    exact_footprint: int
    num_variables: int

    def as_dict(self) -> dict:
        return self.__dict__.copy()


@dataclass
class SwapReport:
    limit: int
    peak_load: int
    load_min: int
    selected_bytes: int
    num_selected: int
    overhead: float
    stalls: int
    per_name_bytes: dict[str, int] = field(default_factory=dict)


class MemoryPlanner:
    """Thin facade: builds the front-end pipeline once, then answers report
    queries by running the matching middle-end passes over the program."""

    def __init__(
        self,
        step_fn: Callable | None = None,
        *example_args,
        hw: HardwareSpec = H100_SXM,
        max_scan_unroll: int = 16,
        size_threshold: int = 1 << 20,
        cache: PlanCache | str | None = None,
        key: PlanKey | None = None,
    ):
        self.hw = hw
        if isinstance(cache, str):
            cache = PlanCache(cache)
        if cache is not None and key is None:
            raise ValueError("a plan cache requires an explicit PlanKey")
        self.ctx = PassContext(
            hw=hw, cache=cache, key=key, size_threshold=size_threshold
        )
        self.program: MemoryProgram = Pipeline(
            [
                TraceCapture(step_fn, example_args, max_scan_unroll=max_scan_unroll),
                IterationDetect(),
                TimingAssign(),
            ]
        ).run(None, self.ctx)

    # ---------------------------------------------------------- IR accessors
    @property
    def trace(self) -> IterationTrace:
        return self.program.require_trace()

    @property
    def swap(self) -> AutoSwapPlanner:
        return self.program.swap_planner(self.hw, self.ctx.size_threshold)

    @property
    def from_cache(self) -> bool:
        return self.program.from_cache

    @property
    def solve_stats(self) -> dict[str, float]:
        """Wall ms per solved stage ("pool:<method>", "swap:<key>").  For a
        program restored from the plan cache these are the *solving*
        process's timings (persisted provenance) — this process paid only
        the cache read; check ``from_cache`` to tell the two apart."""
        return dict(self.program.solve_ms)

    def save(self) -> None:
        """Persist the program's solved artifacts now (also done per-query)."""
        self.program.dirty = True
        ArtifactSave().run(self.program, self.ctx)

    def _run(self, *passes) -> MemoryProgram:
        return Pipeline([*passes, ArtifactSave()]).run(self.program, self.ctx)

    # ------------------------------------------------------------- pooling
    def report(self, method: str = "best_fit") -> PoolReport:
        self._run(PoolPlacement((method, "cnmem", "exact")))
        if method not in self.program.pool_plans:
            raise ValueError(
                f"{method!r} is a baseline pool, not a placement method; "
                f"placement methods produce an AllocationPlan (e.g. best_fit, first_fit)"
            )
        plan = self.program.pool_plans[method]
        cn = self.program.baselines["cnmem"]
        ex = self.program.baselines["exact"]
        return PoolReport(
            peak_load=plan.peak_load,
            smartpool_footprint=plan.footprint,
            smartpool_ratio=plan.competitive_ratio,
            cnmem_footprint=cn.footprint,
            cnmem_ratio=cn.footprint / plan.peak_load if plan.peak_load else 1.0,
            exact_footprint=ex.footprint,
            num_variables=len([v for v in self.trace.variables if v.size > 0]),
        )

    # ------------------------------------------------------------ swapping
    def swap_report(
        self, limit: int, method: ScoreName | None = "swdoa", weights=None
    ) -> SwapReport:
        scorer = method or "swdoa"
        self._run(SwapSelection(limit, scorer, weights))
        s = self.program.swap_summaries[swap_key(scorer, limit, weights)]
        return SwapReport(
            limit=s.limit,
            peak_load=s.peak_load,
            load_min=s.load_min,
            selected_bytes=s.selected_bytes,
            num_selected=len(s.decisions),
            overhead=s.overhead,
            stalls=s.stalls,
            per_name_bytes=dict(s.per_name_bytes),
        )

    # ------------------------------------------------------------- offload
    def offload_plan(
        self, limit: int, method: ScoreName | None = "swdoa", weights=None
    ) -> OffloadPlan:
        """Coarsen the per-variable selection to checkpoint_name classes
        (the OffloadLowering pass; see repro_torch/plan/passes.py)."""
        scorer = method or "swdoa"
        self._run(OffloadLowering(limit, scorer, weights))
        return self.program.offload_plans[swap_key(scorer, limit, weights)]
