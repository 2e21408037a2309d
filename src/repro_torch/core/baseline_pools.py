"""Baseline allocators the paper compares against (Table I).

Counterpart of ``repro/core/baseline_pools.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_solvers.py``
holds the two equal.

* ``CnMemPool`` — Nvidia's CnMem-style *online* pool: a linked list of free
  holes searched first-fit at every malloc, coalescing on free, growing the
  arena when nothing fits.  No lifetime knowledge (it allocates as requests
  arrive), which is exactly why SmartPool's offline plan beats it.
* ``ExactAllocator`` — cudaMalloc-style: every variable gets its own exact
  allocation, footprint equals peak load (competitive ratio 1.0 by
  construction) but each malloc/free pays the driver round-trip, modelled by
  ``malloc_cost_s`` in the simulator's timing (paper Table I's ~1.8x speedup
  of pools over cudaMalloc).
"""

from __future__ import annotations

from dataclasses import dataclass

from .events import Event, EventKind, IterationTrace


@dataclass
class PoolStats:
    footprint: int
    peak_load: int
    num_mallocs: int

    @property
    def competitive_ratio(self) -> float:
        return self.footprint / self.peak_load if self.peak_load else 1.0


class CnMemPool:
    """Online first-fit arena with hole coalescing (CnMem analog)."""

    def __init__(self, alignment: int = 256):
        self.alignment = alignment
        # Free holes as sorted [offset, end) pairs; arena grows monotonically.
        self.holes: list[list[int]] = []
        self.arena_end = 0
        self.live: dict[int, tuple[int, int]] = {}  # var -> (offset, size)
        self.num_mallocs = 0

    def _align(self, x: int) -> int:
        a = self.alignment
        return (x + a - 1) // a * a

    def malloc(self, var: int, size: int) -> int:
        size = self._align(size)
        self.num_mallocs += 1
        for i, (off, end) in enumerate(self.holes):
            if end - off >= size:
                self.live[var] = (off, size)
                if end - off == size:
                    self.holes.pop(i)
                else:
                    self.holes[i][0] = off + size
                return off
        # Grow the arena. If the last hole touches the arena end, extend it.
        if self.holes and self.holes[-1][1] == self.arena_end:
            off = self.holes[-1][0]
            self.holes.pop()
        else:
            off = self.arena_end
        self.arena_end = off + size
        self.live[var] = (off, size)
        return off

    def free(self, var: int) -> None:
        if var not in self.live:
            return
        off, size = self.live.pop(var)
        end = off + size
        # Insert + coalesce (holes kept sorted by offset).
        import bisect

        idx = bisect.bisect_left([h[0] for h in self.holes], off)
        self.holes.insert(idx, [off, end])
        # Coalesce with neighbours.
        merged = []
        for h in self.holes:
            if merged and h[0] <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], h[1])
            else:
                merged.append(h)
        self.holes = merged

    def run(self, trace: IterationTrace) -> PoolStats:
        """Replay one iteration's malloc/free sequence through the pool."""
        events: list[tuple[int, EventKind, int, int]] = []
        for v in trace.variables:
            if v.size <= 0:
                continue
            events.append((v.alloc_index, EventKind.MALLOC, v.var, v.size))
            events.append((v.free_index, EventKind.FREE, v.var, v.size))
        events.sort(key=lambda e: (e[0], e[1] != EventKind.FREE))  # frees first
        for _, kind, var, size in events:
            if kind == EventKind.MALLOC:
                self.malloc(var, size)
            else:
                self.free(var)
        return PoolStats(self.arena_end, trace.peak_load(), self.num_mallocs)


def exact_allocator(trace: IterationTrace) -> PoolStats:
    """cudaMalloc analog: footprint == peak load, one driver call per malloc."""
    n = sum(1 for v in trace.variables if v.size > 0)
    return PoolStats(trace.peak_load(), trace.peak_load(), n)
