"""Core library: SmartPool + AutoSwap (Zhang et al., 2019), the paper's planner.

Counterpart of ``repro/core`` (its public surface, ``repro/core/__init__.py``),
with the port's card, ``H100_SXM``, and a torch graph tracer where the
reference walks a jaxpr:
  events      — Event/VariableInfo/IterationTrace, load curves, omega(G)
  iteration   — repeated-subsequence iteration detection
  trace       — RecordingDevice (paper §V) + the graph tracer of torch steps
  smartpool   — offline-DSA weighted-interval-coloring pool
  baseline_pools — CnMem-style online pool + cudaMalloc-style exact allocator
  autoswap    — candidates, DOA/AOA/WDOA/SWDOA priority scores, selection
  simulator   — timing model + discrete-event swap-schedule simulator
  bayesopt    — GP+EI tuner for the combined priority score
  costmodel   — analytic FLOPs and bytes of a traced step
  planner     — MemoryPlanner: facade over the repro_torch.plan pass pipeline
  offload     — the offload plan AutoSwap's selection lowers to

The staged pipeline itself (MemoryProgram IR, passes, strategy registry,
on-disk plan artifacts) lives in repro_torch.plan.  Nothing here imports
torch until a step is traced.
"""

from . import autoswap, baseline_pools, bayesopt, events, iteration, simulator, smartpool, trace  # noqa: F401
from .autoswap import AutoSwapPlanner
from .events import Event, EventKind, IterationTrace, build_trace
from .simulator import GTX_1080TI, H100_SXM, TPU_V5E, HardwareSpec, SwapDecision, simulate_swap_schedule
from .smartpool import AllocationPlan, solve as smartpool_solve
from .trace import RecordingDevice, trace_graph, trace_step_fn

__all__ = [
    "AutoSwapPlanner",
    "Event",
    "EventKind",
    "IterationTrace",
    "build_trace",
    "GTX_1080TI",
    "H100_SXM",
    "TPU_V5E",
    "HardwareSpec",
    "SwapDecision",
    "simulate_swap_schedule",
    "AllocationPlan",
    "smartpool_solve",
    "RecordingDevice",
    "trace_graph",
    "trace_step_fn",
    "MemoryPlanner",
    "PoolReport",
    "SwapReport",
]


def __getattr__(name):
    # The facade imports repro_torch.plan, which imports this package's
    # modules: loaded on first use, so either package may be imported first.
    if name in ("MemoryPlanner", "PoolReport", "SwapReport"):
        from . import planner

        return getattr(planner, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
