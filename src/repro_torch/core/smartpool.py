"""SmartPool: offline Dynamic Storage Allocation (paper §III).

Counterpart of ``repro/core/smartpool.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_solvers.py``
holds the two equal.

Weighted-interval-coloring heuristic (Kierstead's WIC without power-of-two
rounding, paper §III-C):

  1. sort variables in descending order of size;
  2. for each variable, collect the already-placed variables whose *lifetime*
     overlaps it (the WIC neighbourhood), merge their occupied address
     intervals, and place the variable into a hole by best-fit (default) or
     first-fit; extend the pool when no hole fits.

The resulting footprint chi(G) is compared against the peak load omega(G)
(paper Eq. 1-2); chi/omega is the competitive ratio.  Sharing is many-to-many:
a large block's address range can host any number of small, pairwise
non-overlapping-in-lifetime variables and vice versa — strictly more general
than the one-to-one sharing of prior work.

The solve runs once per detected iteration; runtime allocation is then a hash
lookup ``op_index -> offset`` (paper §V), modelled by ``AllocationPlan.lookup``.

Solve-time fast path (paper: "equal time complexity" to the default pool).
The original solve (frozen in core/_solver_reference.py) materialized an
O(n^2) pairwise lifetime-overlap mask and re-sorted the neighbour intervals
from scratch per placement.  The rewrite is event-indexed: a variable's true
WIC neighbours are exactly

    {placed j alive at alloc_i}  ∪  {placed j with alloc_j in (alloc_i, free_i)}

so each placement queries (a) a segment tree over the alloc-event coordinate
— every placed lifetime is bucketed into O(log n) canonical nodes, and one
root-to-leaf walk reports the intervals stabbing alloc_i — and (b) one slice
of the alloc-sorted event order for the starts inside the lifetime.  Total
work is O((n + E) log n) for E true lifetime overlaps instead of O(n^2 + E);
production LM/MoE traces are sparse (E ~ 13n on the 20k-variable qwen3
trace), which makes placement near-linear.  Dense instances (E approaching
n^2) auto-fall back to the bulk vectorized path, which keeps the reference's
prefix masks but replaces its per-placement Python hole scan with a
vectorized skyline (running-max of merged interval ends).  Both paths choose
placements bit-for-bit identically to the reference — the hole scan visits
merged intervals in the same (offset, placement-rank) order and applies the
same first-fit/best-fit tie-breaks — which tests/test_solvetime.py pins on
randomized traces.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal

import numpy as np

from .events import IterationTrace, VariableInfo

Engine = Literal["auto", "event", "bulk"]


@dataclass
class AllocationPlan:
    """Output of the offline DSA solve."""

    offsets: dict[int, int]              # var id -> byte offset in the pool
    footprint: int                       # chi(G): pool bytes actually needed
    peak_load: int                       # omega(G): lower bound
    method: str = "best_fit"
    # op index of the MALLOC -> offset: the paper's runtime hash table.
    lookup: dict[int, int] = field(default_factory=dict)

    @property
    def competitive_ratio(self) -> float:
        return self.footprint / self.peak_load if self.peak_load else 1.0


def solve(
    trace: IterationTrace,
    method: Literal["best_fit", "first_fit"] = "best_fit",
    alignment: int = 256,
    engine: Engine = "auto",
) -> AllocationPlan:
    """Run the SmartPool heuristic over one iteration's lifetimes.

    ``alignment`` mirrors real allocator granularity (cudaMalloc aligns to
    256 B; XLA to 64 B) — sizes are rounded up before packing so that the
    reported footprint is achievable on hardware.

    ``engine`` selects the neighbour-query structure: ``"event"`` (segment
    tree + alloc-order slices, near-linear on sparse lifetime graphs),
    ``"bulk"`` (vectorized prefix masks + vectorized skyline, better when
    nearly everything overlaps), or ``"auto"`` (pick by the measured overlap
    density).  All engines return bit-identical plans.
    """
    variables = [v for v in trace.variables if v.size > 0]
    order = sorted(variables, key=lambda v: (-v.size, v.alloc_index))

    n = len(order)
    alloc_t = np.fromiter((v.alloc_index for v in order), np.int64, n)
    free_t = np.fromiter((v.free_index for v in order), np.int64, n)
    a1 = alignment - 1
    sizes = np.fromiter(
        ((v.size + a1) // alignment * alignment for v in order), np.int64, n
    )

    if method not in ("best_fit", "first_fit"):
        raise ValueError(f"unknown placement method {method!r}")
    if engine == "auto":
        engine = _pick_engine(alloc_t, free_t)
    if engine == "event":
        offsets, footprint = _solve_event(alloc_t, free_t, sizes, method)
    elif engine == "bulk":
        offsets, footprint = _solve_bulk(alloc_t, free_t, sizes, method)
    else:
        raise ValueError(f"unknown solve engine {engine!r}")

    plan_offsets = {v.var: int(offsets[i]) for i, v in enumerate(order)}
    lookup = {v.alloc_index: plan_offsets[v.var] for v in order}
    return AllocationPlan(
        offsets=plan_offsets,
        footprint=int(footprint),
        peak_load=_aligned_peak(variables, alignment),
        method=method,
        lookup=lookup,
    )


def _pick_engine(alloc_t: np.ndarray, free_t: np.ndarray) -> Engine:
    """Estimate the lifetime-overlap density from the event structure.

    ``starts``: pairs (i, j) with alloc_j strictly inside i's lifetime (the
    exact element count the event path's slice scan touches). ``stabs``: sum
    over i of variables alive at alloc_i (bounds the segment-tree reports).
    Both are O(n log n) to count.  The event path does O(starts + stabs)
    Python-level work; the bulk path does O(n^2 / 2) vectorized work — pick
    event unless the instance is dense enough that numpy's constant wins.
    """
    n = len(alloc_t)
    if n <= 512:
        return "event"
    asort = np.sort(alloc_t)
    starts = int(
        (np.searchsorted(asort, free_t, "left") - np.searchsorted(asort, alloc_t, "right"))
        .clip(min=0)
        .sum()
    )
    # variables alive at each alloc event: #(alloc_j <= t) - #(free_j <= t)
    stabs = int(
        (
            np.searchsorted(asort, alloc_t, "right")
            - np.searchsorted(np.sort(free_t), alloc_t, "right")
        ).sum()
    )
    return "event" if (starts + stabs) <= 64 * n + n * n // 64 else "bulk"


# ------------------------------------------------------------- event engine
def _solve_event(
    alloc_t: np.ndarray, free_t: np.ndarray, sizes: np.ndarray, method: str
) -> tuple[np.ndarray, int]:
    """Placement with event-indexed neighbour queries (module docstring)."""
    n = len(alloc_t)
    offsets = np.zeros(n, np.int64)
    if n == 0:
        return offsets, 0

    # Alloc-sorted event order: position p holds placement rank pos_rank[p].
    pos_rank = np.argsort(alloc_t, kind="stable")
    alloc_sorted = alloc_t[pos_rank]
    # Window bounds per rank, batched: positions with alloc in (alloc_i, free_i).
    win_lo = np.searchsorted(alloc_sorted, alloc_t, side="right")
    win_hi = np.searchsorted(alloc_sorted, free_t, side="left")

    # Segment tree over the distinct alloc coordinates; a placed lifetime
    # [alloc_j, free_j) is bucketed into O(log) canonical nodes, and the
    # stabbing set of alloc_i is read off the leaf-to-root path.
    uniq = np.unique(alloc_t)
    leaf = np.searchsorted(uniq, alloc_t)
    ins_hi = np.searchsorted(uniq, free_t, side="left")
    base = 1
    while base < len(uniq):
        base <<= 1
    buckets: list[list[int] | None] = [None] * (2 * base)

    pos_rank_l = pos_rank.tolist()
    alloc_l = alloc_t.tolist()
    free_l = free_t.tolist()
    sizes_l = sizes.tolist()
    win_lo_l = win_lo.tolist()
    win_hi_l = win_hi.tolist()
    leaf_l = leaf.tolist()
    ins_hi_l = ins_hi.tolist()

    off_r = [-1] * n       # placement-rank -> offset (-1: not yet placed)
    end_r = [0] * n
    first_fit = method == "first_fit"  # validated by solve()
    footprint = 0

    for i in range(n):
        a_i = alloc_l[i]
        f_i = free_l[i]
        size = sizes_l[i]

        # (a) placed lifetimes stabbing alloc_i: leaf-to-root bucket walk.
        occ: list[tuple[int, int, int]] = []
        idx = leaf_l[i] + base
        while idx:
            b = buckets[idx]
            if b:
                for r in b:
                    occ.append((off_r[r], r, end_r[r]))
            idx >>= 1
        if f_i <= a_i and occ:
            # Zero-length or inverted lifetime: the reference mask requires
            # alloc_j < free_i, which the stab set (alloc_j <= a_i) only
            # implies when f_i > a_i — filter the degenerate cases exactly.
            occ = [t for t in occ if alloc_l[t[1]] < f_i]
        # (b) placed variables whose alloc falls strictly inside (a_i, f_i).
        # The free_j > a_i check is implied for well-formed lifetimes; it
        # guards inverted (free < alloc) records to match the reference mask.
        for p in range(win_lo_l[i], win_hi_l[i]):
            r = pos_rank_l[p]
            o = off_r[r]
            if o >= 0 and free_l[r] > a_i:
                occ.append((o, r, end_r[r]))

        # Hole scan over neighbours merged in (offset, placement-rank) order
        # — exactly the reference's stable sort + running-max cursor.
        if not occ:
            offset = 0
        else:
            occ.sort()
            cursor = 0
            best_off = -1
            best_waste = -1
            offset = -1
            for o, _r, e in occ:
                if o > cursor:
                    hole = o - cursor
                    if hole >= size:
                        if first_fit:
                            offset = cursor
                            break
                        waste = hole - size
                        if best_waste < 0 or waste < best_waste:
                            best_off, best_waste = cursor, waste
                if e > cursor:
                    cursor = e
            if offset < 0:
                offset = best_off if best_off >= 0 else cursor

        off_r[i] = offset
        end = offset + size
        end_r[i] = end
        if end > footprint:
            footprint = end

        # Insert i's lifetime into its canonical segment-tree nodes.
        l = leaf_l[i] + base
        r_ = ins_hi_l[i] + base
        while l < r_:
            if l & 1:
                if buckets[l] is None:
                    buckets[l] = []
                buckets[l].append(i)
                l += 1
            if r_ & 1:
                r_ -= 1
                if buckets[r_] is None:
                    buckets[r_] = []
                buckets[r_].append(i)
            l >>= 1
            r_ >>= 1

    offsets[:] = off_r
    return offsets, footprint


# -------------------------------------------------------------- bulk engine
def _solve_bulk(
    alloc_t: np.ndarray, free_t: np.ndarray, sizes: np.ndarray, method: str
) -> tuple[np.ndarray, int]:
    """Reference-shaped prefix masks with a vectorized skyline placement."""
    n = len(alloc_t)
    offsets = np.zeros(n, np.int64)
    footprint = 0
    for i in range(n):
        if i == 0:
            footprint = int(sizes[0]) if n else 0
            continue
        mask = (alloc_t[:i] < free_t[i]) & (free_t[:i] > alloc_t[i])
        occ_off = offsets[:i][mask]
        occ_end = occ_off + sizes[:i][mask]
        offset = _place_vectorized(occ_off, occ_end, int(sizes[i]), method)
        offsets[i] = offset
        footprint = max(footprint, offset + int(sizes[i]))
    return offsets, footprint


def _place_vectorized(
    occ_off: np.ndarray, occ_end: np.ndarray, size: int, method: str
) -> int:
    """The reference hole scan as numpy: sort neighbours by offset (stable =
    placement order on ties), build the skyline cursor as a shifted running
    max of interval ends, and pick the first/best hole exactly as the
    reference's scalar loop does."""
    if occ_off.size == 0:
        return 0
    order = np.argsort(occ_off, kind="stable")
    off_s = occ_off[order]
    end_s = occ_end[order]
    cur = np.empty(len(off_s), np.int64)
    cur[0] = 0
    if len(off_s) > 1:
        np.maximum.accumulate(end_s[:-1], out=cur[1:])
        np.maximum(cur[1:], 0, out=cur[1:])
    holes = off_s - cur
    fits = holes >= size
    if fits.any():
        if method == "first_fit":
            return int(cur[int(np.argmax(fits))])
        waste = np.where(fits, holes - size, np.iinfo(np.int64).max)
        return int(cur[int(np.argmin(waste))])
    return int(max(0, int(end_s.max())))


def _align(x: int, a: int) -> int:
    return (x + a - 1) // a * a


def _aligned_peak(variables: list[VariableInfo], alignment: int) -> int:
    """omega(G) with allocator-granularity sizes (fair ratio denominator)."""
    n = len(variables)
    if not n:
        return 0
    alloc = np.fromiter((v.alloc_index for v in variables), np.int64, n)
    free = np.fromiter((v.free_index for v in variables), np.int64, n)
    sz = np.fromiter((_align(v.size, alignment) for v in variables), np.int64, n)
    bounds = np.concatenate([alloc, free])
    deltas = np.concatenate([sz, -sz])
    order = np.argsort(bounds, kind="stable")
    # Events at the same index must net out before the peak is read, exactly
    # like the reference's per-index delta dict: segment the sorted events by
    # boundary and take the running max at segment ends only.
    b = bounds[order]
    cum = np.cumsum(deltas[order])
    last_of_index = np.append(b[1:] != b[:-1], True)
    peak = int(cum[last_of_index].max())
    return max(peak, 0)


def brute_force_optimal(trace: IterationTrace, alignment: int = 1) -> int:
    """Exhaustive-permutation offline DSA for tiny instances (tests only).

    Tries every placement order under first-fit; for <= 7 variables this
    covers enough of the search space to certify optimality gaps in tests.
    """
    import itertools

    variables = [v for v in trace.variables if v.size > 0]
    if len(variables) > 7:
        raise ValueError("brute force is for tiny test instances only")
    best = None
    for perm in itertools.permutations(range(len(variables))):
        placed: list[tuple[VariableInfo, int]] = []
        fp = 0
        for idx in perm:
            v = variables[idx]
            occ = sorted(
                (off, off + _align(u.size, alignment))
                for (u, off) in placed
                if u.overlaps(v)
            )
            cursor, chosen = 0, None
            for o, e in occ:
                if o - cursor >= _align(v.size, alignment):
                    chosen = cursor
                    break
                cursor = max(cursor, e)
            if chosen is None:
                chosen = cursor
            placed.append((v, chosen))
            fp = max(fp, chosen + _align(v.size, alignment))
        best = fp if best is None else min(best, fp)
    return int(best or 0)
