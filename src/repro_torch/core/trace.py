"""Trace acquisition: the paper's §V Device abstraction.

Counterpart of ``Block`` and ``RecordingDevice`` in ``repro/core/trace.py``
(:54-118), whose code this is; ``tests/test_torch_solvers.py`` holds the two
equal.  ``RecordingDevice`` records ``Malloc``/``Free``/``Exec(fn,
read_blocks, write_blocks)`` into an event list that undergoes the
repeatability test (core/iteration.py): the runtime path, model-transparent,
no graph needed.  The reference's second path, a walk over a step
function's graph, becomes a torch graph walk in ROADMAP queue A5.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Sequence

from .events import Event, EventKind, IterationTrace, build_trace
from .iteration import IterationDetector


@dataclass(frozen=True)
class Block:
    """Handle for a device memory block (the paper's ``Block*``)."""

    var: int
    size: int


class RecordingDevice:
    """Paper §V ``Device``: records Malloc/Free/Exec and detects the iteration.

    In the paper this object fronts cudaMalloc/cudaFree until the pool is
    built.  Here it fronts nothing (we are planning, not allocating) but the
    recorded stream and the repeatability test are identical.
    """

    def __init__(self, min_period: int = 4):
        self._next_var = 0
        self._index = 0
        self._detector = IterationDetector(min_period=min_period)
        self.events: list[Event] = []

    # -- paper API ----------------------------------------------------------
    def malloc(self, size: int) -> Block:
        blk = Block(self._next_var, int(size))
        self._next_var += 1
        self._emit(EventKind.MALLOC, blk)
        return blk

    def free(self, blk: Block) -> None:
        self._emit(EventKind.FREE, blk)

    def exec(
        self,
        fn: Callable[..., Any] | None,
        read_blocks: Sequence[Block],
        write_blocks: Sequence[Block],
        *args: Any,
    ) -> Any:
        """Run an operation, recording its read/write sets (paper's ``Exec``)."""
        for blk in read_blocks:
            self._emit(EventKind.READ, blk)
        for blk in write_blocks:
            self._emit(EventKind.WRITE, blk)
        return fn(*args) if fn is not None else None

    # -- stream plumbing -----------------------------------------------------
    def _emit(self, kind: EventKind, blk: Block) -> None:
        ev = Event(kind, blk.var, blk.size, self._index)
        self._index += 1
        self.events.append(ev)
        self._detector.feed(ev)

    @property
    def iteration_detected(self) -> bool:
        return self._detector.period is not None

    def iteration_trace(self) -> IterationTrace:
        """The canonical one-iteration trace (PoolOpt's input)."""
        self._detector.finalize()
        return build_trace(self._detector.iteration_events())
