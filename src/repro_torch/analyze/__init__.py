"""repro_torch.analyze: static verification of solved plans.

Counterpart of ``repro/analyze``, so far its plan layer:

  * ``plan_check`` — interval-sweep verifier over a solved ``MemoryProgram``:
    proves pool placements sharing addresses have disjoint lifetimes, swap
    windows contain no reads/writes, no variable is double-resident, and the
    resident floor respects the plan's HBM limit.  Emits a ``Certificate``
    that ``plan.artifact`` embeds in artifacts and re-checks on cache load.

The schedule race detector (``schedule_check``) and ``verify_launch``
check the observability layer's recorders and come with it (ROADMAP
queue A9).
Everything here is stdlib only; the checked objects come in duck-typed.
"""

from .certificate import Certificate, Violation
from .plan_check import verify_pool_plan, verify_program, verify_swap_summary

__all__ = [
    "Certificate",
    "Violation",
    "verify_program",
    "verify_pool_plan",
    "verify_swap_summary",
]
