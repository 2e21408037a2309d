"""Static plan verifier: prove a solved ``MemoryProgram`` safe by sweep.

Counterpart of ``repro/analyze/plan_check.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_plan.py``
holds the two equal.

No simulation, no solver re-run — every invariant is an interval sweep over
the trace's exact lifetime/access semantics (the paper's core premise: the
iterative process makes these known and fixed):

  pool_disjoint_lifetimes  placements whose [offset, offset+size) byte
                           ranges intersect have disjoint lifetimes
  pool_bounds              every placement fits the claimed footprint and
                           chi >= omega (footprint >= aligned peak load)
  pool_lookup              the runtime malloc lookup table agrees with the
                           placement offsets
  swap_well_formed         decisions reference real variables at their real
                           sizes, with window endpoints on real accesses
  swap_in_before_read      no read falls strictly inside an absence window:
                           the swap-in at ``in_before`` precedes the first
                           post-swap-out read by construction
  swap_out_after_write     no write falls strictly inside an absence window:
                           the swap-out at ``out_after`` captures the last
                           write before the gap (no lost update)
  swap_single_residency    at most one absence window per variable — two
                           would double-install transfer events and make the
                           variable transiently double-resident
  swap_budget              the resident floor (load curve minus absence
                           windows, the engine's admission reservation)
                           equals the floor the solver committed to
                           (``planned_floor``) — any dropped or tampered
                           decision changes the recomputed floor and breaks
                           the claim.  Greedy selection is best-effort, so
                           a committed floor above the limit is a legitimate
                           solver outcome (noted, not a violation).  Legacy
                           summaries without a committed floor fall back to
                           floor <= limit, vacuous when the limit is
                           declared infeasible (limit < load_min)

Absence-window accounting matches ``runtime.engine.planned_peak`` exactly:
a non-wrap decision is absent on [out_after, in_before), a wrap decision on
[0, in_before) and [out_after, num_indices).  Hazard windows are strictly
interior — the accesses *at* ``out_after``/``in_before`` are the transfer
triggers, not hazards.
"""

from __future__ import annotations

from .certificate import Certificate, Violation

POOL_INVARIANTS = ("pool_disjoint_lifetimes", "pool_bounds", "pool_lookup")
SWAP_INVARIANTS = (
    "swap_well_formed",
    "swap_in_before_read",
    "swap_out_after_write",
    "swap_single_residency",
    "swap_budget",
)
ALL_INVARIANTS = POOL_INVARIANTS + SWAP_INVARIANTS

DEFAULT_ALIGNMENT = 256  # smartpool.solve's default packing granularity


def _aligned(size: int, alignment: int) -> int:
    a1 = alignment - 1
    return (size + a1) // alignment * alignment


# --------------------------------------------------------------- pool checks
def verify_pool_plan(trace, plan, alignment: int = DEFAULT_ALIGNMENT,
                     subject: str = "pool") -> list[Violation]:
    """Sweep one ``AllocationPlan`` against the trace lifetimes."""
    out: list[Violation] = []
    placed = [v for v in trace.variables if v.size > 0]

    # -- bounds + completeness
    for v in placed:
        off = plan.offsets.get(v.var)
        if off is None:
            out.append(Violation(
                "pool_bounds", subject,
                f"variable v{v.var} ({v.size}B) has no placement",
                ops=(v.alloc_index,), vars=(v.var,),
            ))
            continue
        end = off + _aligned(v.size, alignment)
        if off < 0 or end > plan.footprint:
            out.append(Violation(
                "pool_bounds", subject,
                f"v{v.var} at [{off}, {end}) exceeds footprint {plan.footprint}",
                ops=(v.alloc_index,), vars=(v.var,),
            ))
    if plan.footprint < plan.peak_load:
        out.append(Violation(
            "pool_bounds", subject,
            f"footprint {plan.footprint} < peak load {plan.peak_load} "
            "(chi < omega is impossible)",
        ))

    # -- lookup table agrees with offsets (skip alloc indices two variables
    #    share: the table is keyed by malloc op and cannot represent both)
    alloc_count: dict[int, int] = {}
    for v in placed:
        alloc_count[v.alloc_index] = alloc_count.get(v.alloc_index, 0) + 1
    for v in placed:
        if v.var not in plan.offsets or alloc_count[v.alloc_index] > 1:
            continue
        got = plan.lookup.get(v.alloc_index)
        if got is not None and got != plan.offsets[v.var]:
            out.append(Violation(
                "pool_lookup", subject,
                f"lookup[{v.alloc_index}] = {got} but v{v.var} is placed "
                f"at {plan.offsets[v.var]}",
                ops=(v.alloc_index,), vars=(v.var,),
            ))

    # -- disjointness: interval sweep over (alloc, free) events.  At each
    #    alloc the new byte range is probed against the active set (sorted
    #    by offset); frees at an index precede allocs at the same index
    #    (free_index is exclusive, VariableInfo.overlaps is strict).
    import bisect

    events: list[tuple[int, int, object]] = []  # (index, kind 0=free 1=alloc, var)
    for v in placed:
        if v.var not in plan.offsets:
            continue
        events.append((v.alloc_index, 1, v))
        events.append((v.free_index, 0, v))
    events.sort(key=lambda e: (e[0], e[1], e[2].var))

    active_offs: list[int] = []        # sorted offsets of live placements
    active: dict[int, tuple[int, object]] = {}  # offset -> (end, VariableInfo)
    for _idx, kind, v in events:
        off = plan.offsets[v.var]
        end = off + _aligned(v.size, alignment)
        if kind == 0:
            if active.get(off, (None, None))[1] is v:
                del active[off]
                active_offs.pop(bisect.bisect_left(active_offs, off))
            continue
        i = bisect.bisect_left(active_offs, off)
        for j in (i - 1, i):
            if 0 <= j < len(active_offs):
                o_off = active_offs[j]
                o_end, other = active[o_off]
                if o_off < end and off < o_end:
                    out.append(Violation(
                        "pool_disjoint_lifetimes", subject,
                        f"v{v.var} [{off}, {end}) overlaps v{other.var} "
                        f"[{o_off}, {o_end}) while both are live "
                        f"(lifetimes [{v.alloc_index}, {v.free_index}) and "
                        f"[{other.alloc_index}, {other.free_index}))",
                        ops=(v.alloc_index, other.alloc_index),
                        vars=(v.var, other.var),
                    ))
        # Insert even after a violation (keeps later overlaps detectable);
        # identical offsets would clobber — only keep the first, the
        # violation above already witnessed the clash.
        if off not in active:
            bisect.insort(active_offs, off)
            active[off] = (end, v)
    return out


# --------------------------------------------------------------- swap checks
def _absence_spans(d, n: int) -> tuple[tuple[int, int], ...]:
    """Half-open [a, b) absence spans, matching engine.planned_peak."""
    if d.wraps:
        return ((0, min(d.in_before, n)), (min(d.out_after, n), n))
    return ((min(d.out_after, n), min(d.in_before, n)),)


def resident_floor(trace, decisions) -> tuple[int, int]:
    """(peak, argmax op index) of the load curve minus absence windows —
    an independent pure-Python sweep with ``planned_peak`` semantics."""
    n = trace.num_indices
    if n == 0:
        return 0, 0
    delta = [0] * (n + 1)
    for v in trace.variables:
        a, b = v.alloc_index, min(v.free_index, n)
        if a < b:
            delta[a] += v.size
            delta[b] -= v.size
    for d in decisions:
        for a, b in _absence_spans(d, n):
            if a < b:
                delta[a] -= d.size
                delta[b] += d.size
    peak, at, cur = 0, 0, 0
    for i in range(n):
        cur += delta[i]
        if cur > peak:
            peak, at = cur, i
    return peak, at


def verify_swap_summary(trace, summary, subject: str = "swap") -> list[Violation]:
    """Sweep one ``SwapSummary``'s decisions against the trace accesses."""
    out: list[Violation] = []
    by_id = {v.var: v for v in trace.variables}
    n = trace.num_indices

    seen: dict[int, object] = {}
    valid: list = []  # shape-valid decisions only: the floor sweep's input
    malformed = False  # any well-formedness break leaves the floor unattestable
    for d in summary.decisions:
        v = by_id.get(d.var)
        if v is None:
            out.append(Violation(
                "swap_well_formed", subject,
                f"decision names unknown variable v{d.var}", vars=(d.var,),
            ))
            malformed = True
            continue
        prev = seen.get(d.var)
        if prev is not None:
            out.append(Violation(
                "swap_single_residency", subject,
                f"v{d.var} has two absence windows "
                f"(out_after {prev.out_after} and {d.out_after}) — the swap "
                "events would double-install and double-charge residency",
                ops=(prev.out_after, d.out_after), vars=(d.var,),
            ))
            continue
        seen[d.var] = d

        ok_shape = (
            d.size == v.size
            and 0 <= d.in_before < n
            and 0 <= d.out_after < n
            and (d.in_before <= d.out_after if d.wraps else d.out_after < d.in_before)
            and d.out_after in v.accesses
            and d.in_before in v.accesses
        )
        if not ok_shape:
            out.append(Violation(
                "swap_well_formed", subject,
                f"v{d.var} window (out_after={d.out_after}, "
                f"in_before={d.in_before}, wraps={d.wraps}, size={d.size}) is "
                f"inconsistent with the variable (size={v.size}, "
                f"accesses={v.accesses})",
                ops=(d.out_after, d.in_before), vars=(d.var,),
            ))
            malformed = True
            continue
        valid.append(d)

        # Accesses strictly inside the absence window: the variable is on
        # host there, so a read has nothing resident to read (use before
        # swap-in) and a write is lost when the stale copy swaps back.
        for a, is_write in zip(v.accesses, v.access_is_write):
            if d.wraps:
                inside = a < d.in_before or a > d.out_after
            else:
                inside = d.out_after < a < d.in_before
            if not inside:
                continue
            if is_write:
                out.append(Violation(
                    "swap_out_after_write", subject,
                    f"v{d.var} is written at op {a} inside its absence "
                    f"window — the swap-out at {d.out_after} precedes the "
                    "variable's last write (lost update)",
                    ops=(a, d.out_after), vars=(d.var,),
                ))
            else:
                out.append(Violation(
                    "swap_in_before_read", subject,
                    f"v{d.var} is read at op {a} inside its absence window "
                    f"— the swap-in completes at {d.in_before}, after the "
                    "read (use of non-resident data)",
                    ops=(a, d.in_before), vars=(d.var,),
                ))

    # Resident floor vs the solver's commitment.  The engine's admission
    # reserves the *floor* (planned_peak), not the limit, so the safety
    # obligation is that the decisions reproduce exactly the floor the
    # schedule was solved with: a dropped/tampered decision changes it.
    # Greedy selection is best-effort — it may exhaust its one-window-per-
    # variable candidates with the floor still above the limit (and above
    # ``load_min``, which picks a *different* window combination) — so a
    # committed floor over the limit is not a violation by itself.
    floor, at = resident_floor(trace, valid)
    claimed = getattr(summary, "planned_floor", None)
    if malformed:
        # A malformed decision set already failed well-formedness; the floor
        # cannot be attested either way, so don't stack a budget verdict.
        return out
    if claimed is not None:
        if floor != claimed:
            out.append(Violation(
                "swap_budget", subject,
                f"decisions yield resident floor {floor} (peak at op {at}) "
                f"but the schedule committed to planned_floor {claimed} — "
                "the decision set was dropped or tampered with after solve",
                ops=(at,),
            ))
    elif floor > summary.limit and summary.limit >= summary.load_min:
        # Legacy summary without a committed floor: fall back to the limit,
        # vacuous when the limit is declared infeasible (limit < load_min).
        out.append(Violation(
            "swap_budget", subject,
            f"resident floor {floor} exceeds the schedule's limit "
            f"{summary.limit} at op {at} (load_min {summary.load_min}: the "
            "limit was feasible, so the selection under-covers the peak)",
            ops=(at,),
        ))
    return out


# ------------------------------------------------------------------ program
def verify_program(program, alignment: int = DEFAULT_ALIGNMENT) -> Certificate:
    """Full sweep over every solved artifact a ``MemoryProgram`` carries.

    Every invariant appears in the certificate even with zero subjects, so
    "proved over N placements" and "nothing of that kind to prove" are both
    explicit verdicts.
    """
    cert = Certificate()
    for name in ALL_INVARIANTS:
        cert.add(name, 0, [])
    trace = program.require_trace()

    for method, plan in sorted(program.pool_plans.items()):
        subject = f"pool:{method}"
        by_inv: dict[str, list[Violation]] = {n: [] for n in POOL_INVARIANTS}
        for v in verify_pool_plan(trace, plan, alignment, subject=subject):
            by_inv[v.invariant].append(v)
        for n in POOL_INVARIANTS:
            cert.add(n, 1, by_inv[n])

    for key, summary in sorted(program.swap_summaries.items()):
        subject = f"swap:{key}"
        by_inv = {n: [] for n in SWAP_INVARIANTS}
        for v in verify_swap_summary(trace, summary, subject=subject):
            by_inv[v.invariant].append(v)
        for n in SWAP_INVARIANTS:
            cert.add(n, 1, by_inv[n])
        if summary.limit < summary.load_min:
            cert.note(
                f"{subject}: limit {summary.limit} < load_min "
                f"{summary.load_min}; budget obligation vacuous"
            )
        claimed = getattr(summary, "planned_floor", None)
        if claimed is not None and claimed > summary.limit:
            cert.note(
                f"{subject}: best-effort schedule — committed floor "
                f"{claimed} > limit {summary.limit}; admission reserves "
                "the floor"
            )
    return cert
