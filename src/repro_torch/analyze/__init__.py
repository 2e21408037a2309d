"""repro_torch.analyze: static verification of solved plans and simulated schedules.

Counterpart of ``repro/analyze``, whose code this is, with its imports
pointed into ``repro_torch``:

  * ``plan_check`` — interval-sweep verifier over a solved ``MemoryProgram``:
    proves pool placements sharing addresses have disjoint lifetimes, swap
    windows contain no reads/writes, no variable is double-resident, and the
    resident floor respects the plan's HBM limit.  Emits a ``Certificate``
    that ``plan.artifact`` embeds in artifacts and re-checks on cache load.

  * ``schedule_check`` — happens-before race detector over runtime event
    logs (``ObsRecorder`` streams, ``record_events`` channel logs, exported
    Chrome traces): channel/lane exclusivity, blackout exclusion,
    accountant monotonicity, reservation isolation, ledger closure.
  * ``driver`` — ``verify_launch``, the launchers' ``--verify``.

The reference's ``launch/analyze.py`` front end is still to be ported
(ROADMAP queue A9).  Everything here is stdlib only; the checked objects
come in duck-typed.
"""

from .certificate import Certificate, Violation
from .driver import verify_launch
from .plan_check import verify_pool_plan, verify_program, verify_swap_summary
from .schedule_check import (
    ScheduleView,
    check_view,
    verify_recorder,
    verify_trace_file,
    view_from_recorder,
    view_from_runtime,
    view_from_trace,
)

__all__ = [
    "Certificate",
    "Violation",
    "verify_launch",
    "verify_program",
    "verify_pool_plan",
    "verify_swap_summary",
    "ScheduleView",
    "check_view",
    "verify_recorder",
    "verify_trace_file",
    "view_from_recorder",
    "view_from_runtime",
    "view_from_trace",
]
