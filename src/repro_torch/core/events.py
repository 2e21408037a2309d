"""Event model for the paper's unified abstraction (paper §V).

Counterpart of ``repro/core/events.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_solvers.py``
holds the two equal.

A training process is observed as a flat stream of events over *variables*
(device memory blocks):

    MALLOC(var, size) -> WRITE/READ(var)* -> FREE(var)

Every event carries an *operation index* (the paper's logical time) and an
optional wall-clock timestamp supplied by a timing model (core/simulator.py).

From one detected iteration of this stream we derive the semantics the paper
exploits:
  * lifetime of every variable (malloc index .. free index),
  * read/write order (per-variable access indices),
  * the memory-load curve, its peak value omega(G) and the peak time.
"""

from __future__ import annotations

import bisect
import enum
from dataclasses import dataclass, field
from typing import Iterable, Sequence


class EventKind(enum.IntEnum):
    MALLOC = 0
    FREE = 1
    READ = 2
    WRITE = 3


@dataclass(frozen=True)
class Event:
    kind: EventKind
    var: int          # variable id
    size: int         # bytes; identical for every event of the same var
    index: int        # operation index (logical time within the stream)

    def signature(self) -> tuple:
        """Shape-only signature used by the iteration repeatability test.

        Variable ids differ across iterations (fresh tensors are allocated
        each step) so the signature deliberately excludes ``var``: two
        iterations "repeat" when their (kind, size) sequences match.
        """
        return (int(self.kind), self.size)


@dataclass
class VariableInfo:
    """Lifetime + access semantics of a single variable within one iteration."""

    var: int
    size: int
    alloc_index: int
    free_index: int                       # exclusive end of lifetime
    accesses: list[int] = field(default_factory=list)  # sorted op indices
    # True for entries of `accesses` that are writes (parallel list).
    access_is_write: list[bool] = field(default_factory=list)
    name: str = ""

    @property
    def lifetime(self) -> tuple[int, int]:
        return (self.alloc_index, self.free_index)

    def overlaps(self, other: "VariableInfo") -> bool:
        """Lifetime overlap — the edge predicate of the WIC graph (paper §III-B)."""
        return self.alloc_index < other.free_index and other.alloc_index < self.free_index

    def crosses(self, index: int) -> bool:
        return self.alloc_index <= index < self.free_index


@dataclass
class IterationTrace:
    """One detected training iteration: the offline-DSA problem instance."""

    variables: list[VariableInfo]
    num_indices: int                      # logical-time horizon of the iteration
    # Optional map op index -> wall-clock seconds from a timing model. Entry i
    # is the *start* time of op i; entry num_indices is the iteration end.
    op_times: list[float] | None = None
    # Optional op index -> (flops, bytes_touched): compute-cost estimates from
    # the graph tracer, consumed by core/simulator.py to build op_times.
    op_costs: dict[int, tuple[float, float]] | None = None
    # Optional op index -> seconds of wall time the roofline model cannot
    # derive from (flops, bytes) — collective communication durations tagged
    # by the sharded tracer (repro.dist).  Folded into op_times by
    # ``assign_times``; never serialized (op_times carries the result).
    op_extra_s: dict[int, float] | None = None
    # Memoized load curve: (guard, int64 ndarray).  The guard catches the
    # structural mutations that occur in practice (adding/removing variables,
    # re-detecting the horizon); in-place edits of an existing VariableInfo's
    # lifetime must call ``invalidate_cache()``.
    _load_cache: "tuple | None" = field(default=None, repr=False, compare=False)

    def by_id(self) -> dict[int, VariableInfo]:
        return {v.var: v for v in self.variables}

    # ---------------------------------------------------------------- loads
    def invalidate_cache(self) -> None:
        """Drop the memoized load curve after mutating variable lifetimes."""
        self._load_cache = None

    def _cache_guard(self) -> tuple:
        return (len(self.variables), self.num_indices)

    def load_curve_array(self) -> "object":
        """Memoized load curve as an int64 cumsum over alloc/free deltas.

        One O(n + T) numpy pass, shared by every consumer (AutoSwap scoring,
        the planner facade, the runtime's resident-floor accounting) that
        previously each re-derived it from a pure-Python loop.  Callers must
        treat the returned array as read-only; copy before mutating.
        """
        import numpy as np

        guard = self._cache_guard()
        if self._load_cache is not None and self._load_cache[0] == guard:
            return self._load_cache[1]
        deltas = np.zeros(self.num_indices + 1, dtype=np.int64)
        n = len(self.variables)
        if n:
            alloc = np.fromiter((v.alloc_index for v in self.variables), np.int64, n)
            free = np.fromiter((v.free_index for v in self.variables), np.int64, n)
            size = np.fromiter((v.size for v in self.variables), np.int64, n)
            np.add.at(deltas, alloc, size)
            inb = free <= self.num_indices
            np.subtract.at(deltas, free[inb], size[inb])
        curve = np.cumsum(deltas[: self.num_indices])
        curve.flags.writeable = False
        self._load_cache = (guard, curve)
        return curve

    def load_curve(self) -> list[int]:
        """Memory load (bytes) at every operation index (paper Definition 2).

        Returns a fresh list (callers mutate it, e.g. the runtime's
        ``planned_peak``); the underlying curve is memoized."""
        return self.load_curve_array().tolist()

    def peak_load(self) -> int:
        """omega(G): the largest-clique weight == peak memory load (paper Eq. 1)."""
        curve = self.load_curve_array()
        return int(curve.max()) if curve.size else 0

    def peak_time(self) -> int:
        curve = self.load_curve_array()
        if not curve.size:
            return 0
        return int(curve.argmax())

    def total_bytes(self) -> int:
        return sum(v.size for v in self.variables)

    def time_of(self, index: int) -> float:
        """Wall-clock time of an op index (identity when no timing model)."""
        if self.op_times is None:
            return float(index)
        index = max(0, min(index, len(self.op_times) - 1))
        return self.op_times[index]

    @property
    def duration(self) -> float:
        return self.time_of(self.num_indices)


def build_trace(events: Sequence[Event]) -> IterationTrace:
    """Fold a flat event stream into per-variable lifetime/access semantics.

    Variables seen without a MALLOC (pre-existing, e.g. weights) get lifetime
    starting at index 0; variables never FREEd extend to the stream end —
    matching the paper's treatment of weights, which live across iterations.
    """
    infos: dict[int, VariableInfo] = {}
    end = 0
    for ev in events:
        end = max(end, ev.index + 1)
        info = infos.get(ev.var)
        if info is None:
            start = ev.index if ev.kind == EventKind.MALLOC else 0
            info = VariableInfo(ev.var, ev.size, start, -1)
            infos[ev.var] = info
        if ev.kind == EventKind.FREE:
            info.free_index = ev.index
        elif ev.kind in (EventKind.READ, EventKind.WRITE):
            info.accesses.append(ev.index)
            info.access_is_write.append(ev.kind == EventKind.WRITE)
    for info in infos.values():
        if info.free_index < 0:
            info.free_index = end
    return IterationTrace(sorted(infos.values(), key=lambda v: v.var), end)


def interval_point_loads(
    variables: Iterable[VariableInfo], points: Sequence[int]
) -> list[int]:
    """Memory load restricted to given op indices (sweep-line, O(n log n))."""
    starts = sorted(v.alloc_index for v in variables)
    ends = sorted(v.free_index for v in variables)
    sizes_by_start: dict[int, int] = {}
    # A simple prefix-sum over sorted boundaries keyed by the query points.
    events: list[tuple[int, int]] = []
    for v in variables:
        events.append((v.alloc_index, v.size))
        events.append((v.free_index, -v.size))
    events.sort()
    boundary = [e[0] for e in events]
    prefix, cur = [], 0
    for _, delta in events:
        cur += delta
        prefix.append(cur)
    out = []
    for p in points:
        # load *at* p includes vars with alloc<=p<free: apply all events with
        # boundary <= p (free at p removes the var, matching VariableInfo.crosses).
        k = bisect.bisect_right(boundary, p)
        out.append(prefix[k - 1] if k else 0)
    return out
