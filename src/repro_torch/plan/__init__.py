"""repro_torch.plan: the trace -> plan -> execute pipeline as a staged artifact.

Counterpart of ``repro/plan`` with the same public surface; artifacts are
the reference's format (``PLAN_FORMAT_VERSION`` 1), read and written by both.

  program   — MemoryProgram IR + PlanKey identity + SwapSummary results
  passes    — Pass protocol, Pipeline runner, canonical stages
              (TraceCapture, IterationDetect, TimingAssign, PoolPlacement,
               SwapSelection, OffloadLowering, ArtifactSave)
  registry  — pool methods and swap scorers addressable by name
  artifact  — canonical JSON persistence + on-disk PlanCache

The reference's MemoryPlanner facade over this package is ROADMAP queue A6.
"""

from .artifact import PLAN_FORMAT_VERSION, PlanCache, dumps_canonical, program_from_json, program_to_json
from .passes import (
    ArtifactSave,
    IterationDetect,
    OffloadLowering,
    Pass,
    PassContext,
    Pipeline,
    PlanCacheMiss,
    PoolPlacement,
    SwapSelection,
    TimingAssign,
    TraceCapture,
)
from .program import MemoryProgram, PlanKey, SwapSummary, swap_key
from .registry import get_pool, get_scorer, pool_names, register_pool, register_scorer, scorer_names

__all__ = [
    "PLAN_FORMAT_VERSION",
    "PlanCache",
    "dumps_canonical",
    "program_from_json",
    "program_to_json",
    "ArtifactSave",
    "IterationDetect",
    "OffloadLowering",
    "Pass",
    "PassContext",
    "Pipeline",
    "PlanCacheMiss",
    "PoolPlacement",
    "SwapSelection",
    "TimingAssign",
    "TraceCapture",
    "MemoryProgram",
    "PlanKey",
    "SwapSummary",
    "swap_key",
    "get_pool",
    "get_scorer",
    "pool_names",
    "register_pool",
    "register_scorer",
    "scorer_names",
]
