"""Iteration detection: the paper's repeatability test (§V).

Counterpart of ``repro/core/iteration.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_solvers.py``
holds the two equal.

The Device records malloc/free/read/write requests into a list. "Once two
consecutive subsequences are detected to be repeating, the subsequence is fed
into PoolOpt" — i.e. we look for the smallest period ``p`` such that the last
``2p`` event signatures split into two identical halves.

Signatures are (kind, size) tuples (variable ids are fresh every iteration).
The scan is O(L * P) worst case for stream length L and max period P, run
incrementally as events arrive; in practice DNN iterations are found on the
second iteration exactly as the paper describes.
"""

from __future__ import annotations

from typing import Sequence

from .events import Event, EventKind


def detect_repeating_suffix(
    signatures: Sequence[tuple],
    min_period: int = 4,
    max_period: int | None = None,
) -> int | None:
    """Return the smallest period ``p`` with signatures[-2p:-p] == signatures[-p:].

    Returns None when no repetition is present yet.  ``min_period`` filters out
    degenerate micro-loops (e.g. a single op repeated); the paper's iterations
    contain thousands of events.  A valid training iteration must allocate and
    release memory, so candidate windows lacking a MALLOC or a FREE signature
    are rejected (guards against read/write micro-loops inside one layer).
    """
    n = len(signatures)
    limit = max_period if max_period is not None else n // 2
    for p in range(min_period, limit + 1):
        if 2 * p > n:
            break
        window = list(signatures[n - p :])
        if signatures[n - 2 * p : n - p] != window:
            continue
        kinds = {sig[0] for sig in window}
        if int(EventKind.MALLOC) in kinds and int(EventKind.FREE) in kinds:
            return p
    return None


class IterationDetector:
    """Incremental wrapper used by the recording Device (core/trace.py).

    Feed events one at a time; ``period`` becomes non-None once two full
    consecutive iterations have been observed, and ``iteration_events()``
    returns the canonical single-iteration event list (re-indexed to 0).
    """

    def __init__(self, min_period: int = 4, check_every: int = 64):
        self._events: list[Event] = []
        self._sigs: list[tuple] = []
        self.period: int | None = None
        self._min_period = min_period
        self._check_every = max(1, check_every)

    def feed(self, ev: Event) -> None:
        if self.period is not None:
            return
        self._events.append(ev)
        self._sigs.append(ev.signature())
        if len(self._sigs) % self._check_every == 0:
            self.period = detect_repeating_suffix(self._sigs, self._min_period)

    def finalize(self) -> None:
        if self.period is None:
            self.period = detect_repeating_suffix(self._sigs, self._min_period)

    def iteration_events(self) -> list[Event]:
        if self.period is None:
            raise ValueError("no repeating iteration detected yet")
        p = self.period
        tail = self._events[len(self._events) - p :]
        base = tail[0].index
        return [Event(e.kind, e.var, e.size, e.index - base) for e in tail]
