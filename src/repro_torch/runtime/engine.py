"""Discrete-event memory runtime: N tenant programs, K DMA channels, one HBM.

Counterpart of ``repro/runtime/engine.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_solvers.py``
holds the two equal.

This is the execution layer on top of the ``repro.plan`` IR.  The paper's
simulator (formerly the event loop inside ``core/simulator.py``) replayed ONE
iteration of ONE program with one serialized swap-out stream and one
serialized swap-in stream.  This module generalizes that loop along two axes:

* **Channels** — ``ChannelPool`` models K serialized DMA channels,
  direction-partitioned (K=1: a single shared bidirectional channel; K>=2:
  ceil(K/2) out + floor(K/2) in).  K=2 reproduces the paper's
  one-out/one-in streams exactly, which is how
  ``core.simulator.simulate_swap_schedule`` now delegates here.

* **Tenants** — ``MemoryRuntime`` admits N tenant programs (e.g. a prefill
  worker, a decode worker and a training job) against one shared HBM budget.
  Compute is per-tenant (each tenant owns its cores); HBM residency and DMA
  channels are shared.  Tenants are interleaved in global-time order: at each
  step the tenant with the smallest local clock executes its next op using
  the original simulator's per-op semantics (swap-in stall, delayed malloc,
  swap-out launch, deadline-ordered prefetch).

Shared-pool accounting (``PoolAccountant``) charges swap-in bytes at
*schedule* time, so the admission guard sees in-flight transfers on every
channel — with K in-channels two prefetches can no longer both be admitted
into headroom that only fits one (the double-admission hazard a single
serialized in-stream never exposed).

Admission control: a tenant whose resident floor (planned peak under its
swap schedule) does not fit in the unreserved budget is queued FIFO, not
OOM-killed; it starts when a finishing tenant releases its reservation.

* **Devices** — tenants carry an optional ``device``: tenants on distinct
  devices get distinct HBM accountants and DMA channel pools (the mesh
  execution shape ``repro.dist`` builds), while every device's channels
  contend on one shared ``HostLink`` bandwidth pool when configured —
  modeling the paper's swap bandwidth as a genuinely shared host resource,
  with tagged collectives blacking the link out and the contention-aware
  prefetch back-scheduling around them.  ``device=None`` (default) keeps
  the legacy single-pool behavior bit-for-bit.

Dynamic churn: tenants carry an ``arrival_t`` (and optionally an open-ended
iteration count bounded by a ``departure_t`` event), and the run loop is
event-driven — arrivals are interleaved with execution in global-time order
instead of being admitted from a fixed list at t=0.  With
``renegotiate=True`` the runtime does not only queue a newcomer whose floor
does not fit: it picks a running victim (lowest priority first, then the
largest floor), re-solves the victim's swap plan at a lower HBM limit (the
near-linear SwapSelection solve path, so this is cheap enough to do online),
applies the shrunken plan at the victim's next iteration barrier, and admits
the newcomer into the freed reservation.  When no victim can free enough
bytes the newcomer falls back to plain FIFO queueing.

**Vectorized event core**: the hot paths run on precomputed,
array-structured state, which the reference package pins bit-for-bit
against its frozen per-event engine (``repro/runtime/_engine_reference.py``):

  * the per-step ``sorted(upcoming)`` prefetch scan is a per-op *prefetch
    index* built once in ``_install_decisions`` (decisions stably pre-sorted
    by deadline, walked with in-place compaction as variables swap back in);
  * the O(P) ``pending.remove`` / ``min(pending, ...)`` walks over in-flight
    swap-outs are a lazy-deletion *done-time heap* (``_PendingQueue``);
  * the ``_planned_blackout_s`` linear collective-window walk is
    bisect-bounded by prefix indexes over ``_coll_windows``;
  * the ``run()`` min-over-running-tenants scan is a heapq *event frontier*
    keyed (clock, admission order), so picking the next event is O(log N)
    instead of O(N) — the term that dominated thousand-tenant horizons.

Renegotiation replay is *suffix-only*: with ``capture_snapshots=True`` the
engine snapshots its whole state (accountants, channels, pending heaps,
tenant runs) at every barrier where a re-plan applies, and ``resume()`` on a
snapshot re-simulates only the horizon after that barrier — byte-identical
to replaying the full horizon from t=0 (``benchmarks/bench_engine.py``
gates this).
"""

from __future__ import annotations

import bisect
import copy
import heapq
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Sequence

from ..core.events import IterationTrace
from ..core.simulator import HardwareSpec, SimResult, SwapDecision, assign_times

# A replanner re-solves one tenant's swap schedule at a new (lower) HBM
# limit: (tenant, new_limit) -> (decisions, solve_wall_ms).
Replanner = Callable[["Tenant", int], "tuple[list[SwapDecision], float]"]


# ----------------------------------------------------------------- channels
@dataclass
class ChannelPool:
    """K serialized DMA channels, direction-partitioned.

    K=1 degrades to a single bidirectional channel (out and in transfers
    contend); K>=2 splits ceil(K/2) channels for swap-out and the rest for
    swap-in, each direction load-balanced onto its earliest-free channel.
    """

    num_channels: int
    free_at: list[float]
    out_ids: tuple[int, ...]
    in_ids: tuple[int, ...]

    @classmethod
    def make(cls, k: int) -> "ChannelPool":
        k = max(1, int(k))
        if k == 1:
            out_ids = in_ids = (0,)
        else:
            split = (k + 1) // 2
            out_ids = tuple(range(split))
            in_ids = tuple(range(split, k))
        return cls(k, [0.0] * k, out_ids, in_ids)

    def acquire(self, direction: str, ready_t: float, duration: float) -> tuple[float, float, int]:
        """Reserve the earliest-free channel of `direction`; returns (start, end, channel)."""
        ids = self.out_ids if direction == "out" else self.in_ids
        if len(ids) == 1:
            ch = ids[0]
        else:
            ch = min(ids, key=lambda c: self.free_at[c])
        start = max(ready_t, self.free_at[ch])
        end = start + duration
        self.free_at[ch] = end
        return start, end, ch

    def drain_time(self, direction: str) -> float:
        ids = self.out_ids if direction == "out" else self.in_ids
        return max(self.free_at[c] for c in ids)


@dataclass
class HostLink:
    """Shared host-interconnect bandwidth pool every device's DMA contends on.

    One host typically fronts several accelerators through one PCIe root
    complex (or one NVLink/ICI bridge to host memory): per-device DMA
    channels do not each get the full link.  ``total_bw`` bytes/s of
    aggregate host-link bandwidth is carved into ``lanes`` serialized lanes
    of ``total_bw / lanes`` each; a swap transfer must hold its device's
    directional DMA channel AND a free lane, and moves at
    ``min(device link_bw, lane_bw)``.  With enough lanes for every channel
    the pool is contention-free; fewer lanes model the paper's swap
    bandwidth as a genuinely shared resource (SuperNeurons' observation that
    co-resident jobs fight for the same PCIe).

    Collectives occupy the interconnect with priority (XLA schedules them;
    swaps are opportunistic): ``add_blackout`` reserves an interval on every
    lane, and a transfer scheduled into a blackout is shifted past its end.
    """

    total_bw: float
    lanes: int
    free_at: list[float] = field(default_factory=list)
    blackouts: list[tuple[float, float]] = field(default_factory=list)
    # Observability counters, surfaced in RuntimeReport.link.
    bytes_moved: int = 0
    transfers: int = 0
    blackout_s: float = 0.0
    # Directional lane carving (``repro.tune.lanes``): ``None`` keeps the
    # legacy work-conserving shared pool — any transfer grabs any free lane —
    # bit-identical to the frozen reference.  When set, swap-outs may only
    # use ``out_lane_ids`` and swap-ins ``in_lane_ids``, so bulk swap-out
    # traffic can never queue a latency-critical swap-in behind it.
    out_lane_ids: tuple[int, ...] | None = None
    in_lane_ids: tuple[int, ...] | None = None
    # Per-direction contention decomposition: how long transfers of each
    # direction queued before starting (channel/lane wait plus blackout
    # shift) and the bytes they moved.  Pure accumulators — they never feed
    # back into scheduling — read by ``repro.tune.lanes`` probe runs to pick
    # a directional split; only emitted in reports when a split is active.
    wait_in_s: float = 0.0
    wait_out_s: float = 0.0
    bytes_in: int = 0
    bytes_out: int = 0

    @classmethod
    def make(cls, total_bw: float, lanes: int,
             out_lanes: int | None = None) -> "HostLink":
        lanes = max(1, int(lanes))
        link = cls(float(total_bw), lanes, [0.0] * lanes)
        if out_lanes is not None and lanes > 1:
            out_lanes = max(1, min(int(out_lanes), lanes - 1))
            link.out_lane_ids = tuple(range(out_lanes))
            link.in_lane_ids = tuple(range(out_lanes, lanes))
        return link

    @property
    def lane_bw(self) -> float:
        return self.total_bw / self.lanes

    def lane_ids(self, direction: str):
        """Lanes a transfer of ``direction`` may use (all, when unsplit)."""
        if self.out_lane_ids is None:
            return range(self.lanes)
        return self.out_lane_ids if direction == "out" else self.in_lane_ids

    def add_blackout(self, start: float, end: float,
                     prune_before: float | None = None) -> None:
        """Register a collective's occupancy.  The list stays sorted by
        start (next_clear early-exits on it) and, so long runs don't
        accumulate dead intervals, is pruned below ``prune_before`` — the
        caller's simulation frontier (the minimum running-tenant clock; no
        future transfer can be scheduled to start before it, and
        later-admitted tenants start at or after the admitting event's
        clock).  The registering tenant's own post-op clock is NOT a safe
        frontier: lagging tenants may still schedule into earlier windows."""
        if end > start:
            bisect.insort(self.blackouts, (start, end))
            self.blackout_s += end - start
            if prune_before is not None and len(self.blackouts) > 256:
                self.blackouts = [
                    (s, e) for s, e in self.blackouts if e > prune_before
                ]

    def next_clear(self, start: float, duration: float) -> float:
        """Earliest start >= ``start`` whose [start, start+duration) window
        overlaps no collective blackout."""
        moved = True
        while moved:
            moved = False
            for s, e in self.blackouts:
                if s >= start + duration:
                    break  # sorted by start: nothing later can overlap
                if start < e:
                    start = e
                    moved = True
        return start


# --------------------------------------------------------------- accounting
@dataclass
class PoolAccountant:
    """Shared-HBM accountant: per-tenant resident bytes against one budget.

    Swap-in bytes are charged when the transfer is *scheduled* (reservation),
    not when it completes, so ``fits()`` sees in-flight swap-ins on all
    channels and the engine cannot double-admit into the same headroom.
    ``overflow_events`` counts forced over-budget charges (late swap-ins at
    an access deadline, mallocs with no pending swap-out to wait for) — zero
    on a well-provisioned tenant set.
    """

    budget: int | None = None
    resident: dict[str, int] = field(default_factory=dict)
    peak: dict[str, int] = field(default_factory=dict)
    total: int = 0
    aggregate_peak: int = 0
    overflow_events: int = 0

    def add(self, tenant: str, nbytes: int) -> None:
        self.resident[tenant] = self.resident.get(tenant, 0) + nbytes
        self.total += nbytes
        if nbytes > 0 and self.budget is not None and self.total > self.budget:
            self.overflow_events += 1

    def fits(self, nbytes: int) -> bool:
        return self.budget is None or self.total + nbytes <= self.budget

    def mark_peak(self, tenant: str) -> None:
        r = self.resident.get(tenant, 0)
        if r > self.peak.get(tenant, 0):
            self.peak[tenant] = r
        if self.total > self.aggregate_peak:
            self.aggregate_peak = self.total


# ------------------------------------------------------------------ tenants
@dataclass
class Tenant:
    """One program admitted to the runtime: a trace + its swap schedule.

    ``limit`` is the HBM target the schedule was solved for (used for
    isolated-baseline comparisons; the shared budget governs execution).
    ``floor`` is the admission-control reservation — the planned peak
    resident bytes under the schedule; computed from the trace when None.
    """

    name: str
    trace: IterationTrace
    decisions: list[SwapDecision] = field(default_factory=list)
    limit: int | None = None
    floor: int | None = None
    iterations: int = 1
    # Churn model: when this tenant enters the system (simulated seconds) and
    # its SLO weight (victim selection prefers renegotiating lower-priority
    # tenants first).  ``departure_t`` makes the iteration count open-ended:
    # the tenant keeps iterating until its clock passes the departure event
    # at an iteration barrier (``iterations`` is then ignored).
    arrival_t: float = 0.0
    priority: float = 1.0
    departure_t: float | None = None
    # Mesh execution: which device pool this tenant's residency and DMA
    # channels belong to.  ``None`` is the default single shared device (the
    # legacy runtime shape); tenants with distinct devices get distinct HBM
    # accountants and channel pools but contend on the engine's HostLink.
    device: str | None = None
    # Collective communication tagged by the sharded tracer: op index ->
    # seconds the interconnect is occupied at that op (repro.dist capture).
    # The engine advances the tenant clock through each collective and, when
    # a HostLink is configured, blacks the link out for its duration.
    collectives: dict[int, float] = field(default_factory=dict)
    # A collective is ONE mesh-wide synchronized operation that every
    # participating tenant executes: exactly one tenant per group (the
    # group's first device) should register the link blackout, or the same
    # logical collective is blacked out once per device.  All tenants still
    # advance their clocks through it.
    collective_owner: bool = True

    def resident_floor(self) -> int:
        if self.floor is None:
            self.floor = planned_peak(self.trace, self.decisions)
        return self.floor


def planned_peak(trace: IterationTrace, decisions: Sequence[SwapDecision]) -> int:
    """Peak of the load curve with the schedule's absence windows subtracted —
    the minimum HBM a tenant needs resident if every transfer lands on time.

    Runs on the admission path (and renegotiation recomputes floors online),
    so the absence windows are subtracted as a delta array folded into one
    cumulative sum off the trace's memoized load curve — O(n + decisions)
    instead of the former O(decisions x span) pure-Python walk.
    """
    import numpy as np

    base = trace.load_curve_array()
    n = int(base.shape[0])
    if n == 0:
        return 0
    delta = np.zeros(n + 1, dtype=np.int64)
    for d in decisions:
        if d.wraps:
            spans = ((0, min(d.in_before, n)), (min(d.out_after, n), n))
        else:
            spans = ((min(d.out_after, n), min(d.in_before, n)),)
        for a, b in spans:
            if a < b:
                delta[a] -= d.size
                delta[b] += d.size
    curve = base + np.cumsum(delta[:n])
    return int(curve.max())


@dataclass
class _PendingOut:
    done_t: float
    owner: "_TenantRun"
    var: int
    size: int
    seq: int = 0          # global append order, the heap tie-break
    retired: bool = False


class _PendingQueue:
    """Done-time-ordered in-flight swap-outs for one device pool.

    The reference engine kept a plain list and ran ``min(pending, key=...)``
    plus ``pending.remove(rec)`` on every budget wait and retirement — O(P)
    per event.  This is a lazy-deletion heap keyed (done_t, seq): ``seq`` is
    the append order, so ties pop exactly the record ``min`` returned (first
    occurrence), and retiring a record marks it dead in place instead of
    scanning the list.  Owners keep their own (done_t, seq) heaps over the
    same records for the per-tenant drains (iteration barriers, finishes).
    """

    __slots__ = ("_heap", "_live")

    def __init__(self) -> None:
        self._heap: list[tuple[float, int, _PendingOut]] = []
        self._live = 0

    def __bool__(self) -> bool:
        return self._live > 0

    def push(self, rec: _PendingOut) -> None:
        heapq.heappush(self._heap, (rec.done_t, rec.seq, rec))
        self._live += 1

    def pop_min(self) -> _PendingOut:
        """Remove and return the earliest-completing live record."""
        heap = self._heap
        while heap:
            rec = heapq.heappop(heap)[2]
            if not rec.retired:
                rec.retired = True
                self._live -= 1
                return rec
        raise IndexError("pop from empty pending queue")

    def retire(self, rec: _PendingOut) -> None:
        """Mark a live record dead; its heap entry is skipped when reached."""
        rec.retired = True
        self._live -= 1


class _TenantRun:
    """Per-tenant replay state: the original simulator loop, one op at a time,
    against the shared channel pool / accountant."""

    def __init__(self, tenant: Tenant, hw: HardwareSpec, engine: "MemoryRuntime", admit_t: float):
        self.tenant = tenant
        self.name = tenant.name
        self.hw = hw
        self.engine = engine
        self.device = tenant.device
        # Per-device shared state: tenants on the same device share one HBM
        # accountant, one DMA channel pool and one pending-swap-out queue;
        # the default device (None) keeps the legacy single-pool shape.
        self.acct = engine.acct_for(tenant.device)
        self.chans = engine.channels_for(tenant.device)
        self.pending = engine.pending_for(tenant.device)
        trace = tenant.trace
        if trace.op_times is None:
            assign_times(trace, hw)
        self.trace = trace
        self.costs = trace.op_costs or {}
        self.baseline_s = trace.op_times[-1]
        self.iterations = max(1, tenant.iterations)
        self.floor = tenant.resident_floor()
        self.arrival_t = tenant.arrival_t
        self.priority = tenant.priority
        self.departure_t = tenant.departure_t
        # Renegotiation: a (decisions, new_floor, solve_ms) triple staged by
        # the engine, applied (or cancelled) at the next iteration barrier.
        self.replan_pending: tuple[list[SwapDecision], int, float] | None = None
        self.renegotiations = 0
        self.reneg_freed_bytes = 0
        self.reneg_solve_ms = 0.0
        self._record = engine.record_events
        self._obs = engine.obs
        # Engine knobs are fixed for the life of a run: cache the attribute
        # chains the per-step hot loop would otherwise chase every event.
        self._budget_guard = engine.budget is not None
        self._backsched = engine.prefetch == "backsched"
        # Stall-attribution ledger (always on; the hooks above are the
        # optional part).  Each accumulator is a named cause of overhead
        # seconds; ``MemoryRuntime._finish`` closes them into
        # ``TenantReport.attribution`` with an exact-sum residual.
        self.attr_xfer_s = 0.0        # swap-in stall: transfer was moving bytes
        self.attr_chan_s = 0.0        # swap-in stall: queued for channel/lane
        self.attr_black_s = 0.0       # swap-in stall: shifted past blackouts
        self.attr_outpend_s = 0.0     # swap-in stall: own swap-out not done
        self.stall_alloc_s = 0.0      # malloc delayed on pending swap-outs
        self.stall_drain_s = 0.0      # iteration-barrier transfer drains
        self.coll_s = 0.0             # collective seconds charged to the clock
        # Collective seconds the baseline already carries per iteration
        # (assign_times folds op_extra_s into op_times): the ledger only
        # attributes the excess the engine charges beyond that.
        self._extra_iter_s = float(sum((trace.op_extra_s or {}).values()))
        # Per-variable swap-in timing detail for the stall decomposition:
        # var -> (transfer seconds, queue wait, blackout shift), written by
        # ``acquire_transfer`` for this iteration's "in" transfers.
        self._in_detail: dict[int, tuple[float, float, float]] = {}

        n = trace.num_indices
        self.delta = [0] * (n + 1)
        self.malloc_size_at: dict[int, int] = {}
        for v in trace.variables:
            self.delta[v.alloc_index] += v.size
            self.malloc_size_at[v.alloc_index] = v.size
            if v.free_index <= n:
                self.delta[v.free_index] -= v.size

        self.bt = trace.op_times  # baseline schedule, for prefetch back-scheduling
        # Op durations are pure functions of the (immutable) cost table:
        # evaluate the roofline expression once per index instead of on
        # every step/_due call.  Same expression, same floats.
        costs = self.costs
        durs = []
        for j in range(len(self.bt)):
            flops, nbytes = costs.get(j, (0.0, 0.0))
            if flops or nbytes:
                durs.append(max(flops / hw.eff_flops, nbytes / hw.hbm_bw) + hw.op_overhead_s)
            else:
                durs.append(0.0)
        self._op_durs = durs
        self._install_decisions(tenant.decisions)

        # Collective windows on the baseline timeline (for contention-aware
        # back-scheduling): the collective at op i occupies the interconnect
        # for the tail of op i's span (its roofline compute runs first).
        self.collectives = dict(tenant.collectives)
        n_bt = len(self.bt) - 1
        self._coll_windows = sorted(
            (max(0.0, self.bt[min(i + 1, n_bt)] - d), self.bt[min(i + 1, n_bt)])
            for i, d in self.collectives.items()
            if d > 0.0
        )
        # Window index for _planned_blackout_s: starts are sorted, and the
        # running max of ends is monotone, so both scan bounds bisect instead
        # of walking every earlier window on every back-scheduling query.
        self._coll_starts = [s for s, _ in self._coll_windows]
        self._coll_maxend: list[float] = []
        m = float("-inf")
        for _, e in self._coll_windows:
            if e > m:
                m = e
            self._coll_maxend.append(m)

        self.admit_t = admit_t
        self.t = admit_t
        self.i = 0
        self.iter_no = 0
        self.stalls = 0
        self.delayed = 0
        self.events = 0                      # simulated op-steps executed
        self.out_events: list[tuple[int, float, float, int]] = []
        self.in_events: list[tuple[int, float, float, int]] = []
        # Tail-spill tracking survives ``record_events=False``: the latest
        # completion among this tenant's own swap-outs, across iterations.
        self._own_out_end = 0.0
        self._has_out = False
        self._own_pending: list[tuple[float, int, _PendingOut]] = []
        self.in_done: dict[int, float] = {}
        self.out_done: dict[int, float] = {}
        self.finished = False
        self._begin_iteration()

    # ------------------------------------------------------------ plumbing
    def _install_decisions(self, decisions: Sequence[SwapDecision]) -> None:
        self.decisions = list(decisions)
        self.out_at: dict[int, list[SwapDecision]] = {}
        self.in_at: dict[int, list[SwapDecision]] = {}
        for d in self.decisions:
            self.out_at.setdefault(d.out_after, []).append(d)
            self.in_at.setdefault(d.in_before, []).append(d)
        # Prefetch index: the reference engine re-filtered and re-sorted the
        # whole decision list on EVERY step.  Deadline order is fixed at
        # install time, so sort once (stably — same-deadline decisions keep
        # install order, exactly what the per-step stable sort produced) and
        # let each iteration walk a compacting copy (``_pf_active``).
        #
        # Each entry carries the decision's precomputed due-check constants:
        # its deadline time on the baseline schedule and its transfer-time
        # budget ``need``.  Without a HostLink (or contention-blind) the
        # reference's ``need`` is ``size / link_bw`` — a per-decision
        # constant; only the contention-aware-link path keeps a dynamic term
        # (the planned collective blackout inside the shrinking window).
        engine = self.engine
        self._pf_dynamic = engine.link is not None and engine.contention_aware
        bt = self.trace.op_times
        order = sorted(self.decisions, key=lambda d: d.in_before)
        if self._pf_dynamic:
            needs = [engine.xfer_seconds(d.size) for d in order]
        else:
            needs = [d.size / self.hw.link_bw for d in order]
        self._pf_order = [
            (d.var, d.in_before, d.size, bt[d.in_before], need)
            for d, need in zip(order, needs)
        ]
        self._pf_active: list[tuple[int, int, int, float, float]] = []

    def _iterations_done(self) -> bool:
        """Called at an iteration barrier, after ``iter_no`` was bumped."""
        if self.departure_t is not None:
            # Zero-duration iterations can never reach a future departure:
            # treat the first barrier as the departure to guarantee progress.
            return self.t >= self.departure_t or self.baseline_s <= 0.0
        return self.iter_no >= self.iterations

    def has_future_barrier(self) -> bool:
        """Will another iteration start after the current one finishes?  A
        renegotiated plan can only take effect at such a barrier."""
        if self.departure_t is not None:
            return self.t < self.departure_t and self.baseline_s > 0.0
        return self.iter_no + 1 < self.iterations

    def _transfer(self, size: int) -> float:
        return self.engine.xfer_seconds(size)

    def _op_dur(self, i: int) -> float:
        return self._op_durs[i]

    def _due(self, d: SwapDecision, i: int) -> bool:
        """Back-scheduling: is it time to start this swap-in?

        The transfer is due at the last op boundary where the baseline compute
        remaining before its deadline access still covers the transfer time —
        deferring one more op would make it late.  Actual compute only runs
        slower than baseline (stalls, delayed mallocs), so a transfer started
        on the baseline schedule never misses an on-time deadline; only
        channel contention can push it late.

        Under a shared HostLink the contention-aware scheduler (default)
        budgets the *effective* lane bandwidth plus the collective blackouts
        inside the window; the contention-blind baseline schedules as if the
        link were private — systematically late on a contended link, which
        is exactly the gap benchmarks measure.
        """
        bt = self.bt
        nxt = min(i + 1, len(bt) - 1)
        slack = bt[d.in_before] - bt[nxt]
        if self.engine.link is not None and not self.engine.contention_aware:
            need = d.size / self.hw.link_bw   # assumes a private, clear link
        else:
            need = self._transfer(d.size)
            if self.engine.link is not None:
                # Collectives black the link out inside the window: the
                # transfer needs that much extra slack to land on time.
                need += self._planned_blackout_s(bt[nxt], bt[d.in_before])
        return slack - self._op_dur(nxt) < need

    def _planned_blackout_s(self, a: float, b: float) -> float:
        """Seconds of [a, b) the baseline schedule spends in collectives.

        Bisect-bounded: windows before ``lo`` all end at or before ``a`` (the
        running-max-of-ends index is monotone) and windows from ``hi`` on
        start at or after ``b`` — exactly the entries the reference walk
        skipped via continue/break.  The surviving overlaps are summed
        left-to-right in the same order with the same float ops, so the
        result is bit-for-bit the reference's.
        """
        windows = self._coll_windows
        if not windows:
            return 0.0
        lo = bisect.bisect_right(self._coll_maxend, a)
        hi = bisect.bisect_left(self._coll_starts, b, lo)
        total = 0.0
        for j in range(lo, hi):
            s, e = windows[j]
            if e <= a:
                continue
            total += min(e, b) - max(s, a)
        return total

    def _begin_iteration(self) -> None:
        self.in_done = {}
        self.out_done = {}
        self._in_detail = {}
        # Wrap decisions: in steady state the variable is already on the host
        # when the iteration starts (swapped out during the previous tail).
        for d in self.decisions:
            if d.wraps:
                self.acct.add(self.name, -d.size)
                self.out_done[d.var] = self.t
        self.i = 0
        self._pf_active = list(self._pf_order)

    def _end_iteration(self) -> bool:
        """Close one iteration; True when the whole tenant is finished."""
        self.iter_no += 1
        if self._iterations_done():
            return True
        # Iteration barrier for multi-iteration replay: drain this tenant's
        # in-flight transfers and reset its residency to zero so the next
        # iteration's deltas (which re-count persistent variables at index 0)
        # don't double-charge the accountant.
        acct = self.acct
        own = self._own_pending
        while own:
            done_t, _, rec = heapq.heappop(own)
            if rec.retired:
                continue
            if done_t > self.t:
                self.stall_drain_s += done_t - self.t
                if self._obs is not None:
                    self._obs.stall(self, "barrier_drain", self.t,
                                    done_t - self.t, rec.var)
                self.t = done_t
            self.pending.retire(rec)
            acct.add(self.name, -rec.size)
        if self.in_done:
            in_max = max(self.in_done.values())
            if in_max > self.t:
                self.stall_drain_s += in_max - self.t
                if self._obs is not None:
                    self._obs.stall(self, "barrier_drain", self.t,
                                    in_max - self.t, -1)
                self.t = in_max
        acct.add(self.name, -acct.resident.get(self.name, 0))
        # The barrier is the only point where the resident set is empty, so a
        # staged renegotiation (shrunken swap plan) swaps in here.
        if self.replan_pending is not None:
            self.engine._on_barrier(self)
        self._begin_iteration()
        return False

    # ---------------------------------------------------------------- step
    def step(self) -> bool:
        """Execute the next op; returns True when the tenant has finished."""
        self.events += 1
        if self.i >= self.trace.num_indices:
            # Degenerate empty trace.
            self.finished = self._end_iteration()
            return self.finished
        i = self.i
        acct = self.acct
        record = self._record

        # 1. If this op needs a swapped variable back, wait for its swap-in.
        for d in self.in_at.get(i, ()):
            if d.var not in self.in_done:
                # Should have been prefetched; schedule now (late prefetch).
                # Still charged at schedule time so concurrent channels see it.
                ready = max(self.t, self.out_done.get(d.var, 0.0))
                start, end, ch = self.engine.acquire_transfer(
                    self, "in", ready, d.size, d.var)
                self.in_done[d.var] = end
                acct.add(self.name, d.size)
                if record:
                    self.in_events.append((d.var, start, end, ch))
            if self.in_done[d.var] > self.t:
                self.stalls += 1
                # Attribute the wait backwards from its components: bytes in
                # flight first, then blackout shift, then channel/lane queue;
                # whatever the transfer timing can't explain is time spent
                # waiting on the variable's own swap-out (the transfer could
                # not even be scheduled until the bytes were host-side).
                wait = self.in_done[d.var] - self.t
                xfer_s, chan_w, black_s = self._in_detail.get(
                    d.var, (0.0, 0.0, 0.0))
                part = min(wait, xfer_s)
                self.attr_xfer_s += part
                rem = wait - part
                part = min(rem, black_s)
                self.attr_black_s += part
                rem -= part
                part = min(rem, chan_w)
                self.attr_chan_s += part
                self.attr_outpend_s += rem - part
                if self._obs is not None:
                    self._obs.stall(self, "swap_in_wait", self.t, wait, d.var)
                self.t = self.in_done[d.var]

        # 2. Budget enforcement on mallocs (paper: delay the Malloc).  Any
        # same-device tenant's pending swap-out frees shared headroom, so the
        # wait is on this device's earliest completion.
        if self._budget_guard and self.delta[i] > 0 and i in self.malloc_size_at:
            while not acct.fits(self.delta[i]) and self.pending:
                rec = self.pending.pop_min()
                if rec.done_t > self.t:
                    self.delayed += 1
                    self.stall_alloc_s += rec.done_t - self.t
                    if self._obs is not None:
                        self._obs.stall(self, "swap_out_drain", self.t,
                                        rec.done_t - self.t, rec.var)
                    self.t = rec.done_t
                acct.add(rec.owner.name, -rec.size)
        acct.add(self.name, self.delta[i])
        acct.mark_peak(self.name)

        # 3. Execute the op (compute is per-tenant; only memory is shared).
        t_op0 = self.t
        self.t += self._op_durs[i]
        # 3b. Collective tagged at this op: it occupies the interconnect for
        # its duration (the tenant's clock advances through it, matching the
        # baseline op_times the sharded tracer folded the duration into),
        # and when a HostLink is configured the link is blacked out — swap
        # transfers of EVERY device route around it.  Only the group's
        # collective owner registers the blackout: the collective is one
        # mesh-wide synchronized op, not one per participating device.
        cdur = self.collectives.get(i)
        if cdur:
            if self.engine.link is not None and self.tenant.collective_owner:
                frontier = min(r.t for r in self.engine._running) if self.engine._running else self.t
                self.engine.link.add_blackout(self.t, self.t + cdur,
                                              prune_before=frontier)
                if self._obs is not None:
                    self._obs.blackout(self.t, self.t + cdur)
            if self._obs is not None:
                self._obs.collective(self, i, self.t, cdur)
            self.coll_s += cdur
            self.t += cdur

        # 4. Launch swap-outs whose trigger access just completed.
        for d in self.out_at.get(i, ()):
            start, end, ch = self.engine.acquire_transfer(
                self, "out", self.t, d.size, d.var)
            self.out_done[d.var] = end
            rec = _PendingOut(end, self, d.var, d.size, self.engine._next_seq())
            self.pending.push(rec)
            heapq.heappush(self._own_pending, (end, rec.seq, rec))
            self._has_out = True
            if end > self._own_out_end:
                self._own_out_end = end
            if record:
                self.out_events.append((d.var, start, end, ch))

        # 5. Retire this tenant's completed swap-outs (frees resident bytes).
        own = self._own_pending
        while own and own[0][0] <= self.t:
            rec = heapq.heappop(own)[2]
            if rec.retired:
                continue
            self.pending.retire(rec)
            acct.add(self.name, -rec.size)

        # 6. Prefetch swapped-out variables back, nearest deadline first.
        # Policy "eager" (the legacy simulator): keep the in-channels busy as
        # soon as data is out and the budget allows it back.  Policy
        # "backsched" (runtime default): start each swap-in just-in-time from
        # its deadline, so readmitted bytes don't crowd the budget that
        # compute mallocs need in the meantime — eager prefetch over fast
        # channels otherwise *increases* malloc delays (scheduling anomaly).
        # Either way a budget-blocked head-of-line transfer stops this
        # tenant's prefetching until room appears — and because bytes are
        # reserved at schedule time in steps 1/6, a second in-channel can
        # never admit into the same headroom.
        #
        # The walk runs over the prefetch index (deadline-ordered at install
        # time) with in-place compaction: entries already swapped back in, or
        # whose deadline has passed, drop permanently; entries not yet
        # swapped out (or not yet due) stay for the next step.
        active = self._pf_active
        if active:
            out_done = self.out_done
            in_done = self.in_done
            guard = self._budget_guard
            backsched = self._backsched
            dynamic = self._pf_dynamic
            # The due check's step-dependent terms are shared by every
            # candidate at this op: hoist them out of the walk.
            bt = self.bt
            nxt = i + 1
            if nxt >= len(bt):
                nxt = len(bt) - 1
            bt_nxt = bt[nxt]
            od_nxt = self._op_durs[nxt]
            n_active = len(active)
            w = r = 0
            while r < n_active:
                ent = active[r]
                var = ent[0]
                if var in in_done or ent[1] <= i:
                    r += 1                      # permanently dead: drop
                    continue
                if var not in out_done:
                    active[w] = ent; w += 1; r += 1   # not swapped out yet: keep
                    continue
                size = ent[2]
                if guard and not acct.fits(size):
                    break                       # head-of-line blocked: stop
                if backsched:
                    # Inlined _due: slack minus the next op's compute,
                    # against the precomputed (plus planned-blackout, on a
                    # contended link) transfer budget — same float ops as
                    # the reference's per-call recomputation.
                    in_t = ent[3]
                    need = ent[4]
                    if dynamic:
                        need = need + self._planned_blackout_s(bt_nxt, in_t)
                    if not ((in_t - bt_nxt) - od_nxt < need):
                        active[w] = ent; w += 1; r += 1   # not due yet: keep
                        continue
                start, end, ch = self.engine.acquire_transfer(
                    self, "in", max(self.t, out_done[var]), size, var
                )
                in_done[var] = end
                acct.add(self.name, size)
                acct.mark_peak(self.name)
                if record:
                    self.in_events.append((var, start, end, ch))
                r += 1                          # now in in_done: drop
            if w != r:
                while r < n_active:             # keep the unexamined tail
                    active[w] = active[r]; w += 1; r += 1
                del active[w:]

        if self._obs is not None:
            # The compute span alone; swap-outs/prefetches launched this
            # step have already settled, so the occupancy sample is the
            # end-of-step state.
            self._obs.op_step(self, i, t_op0, t_op0 + self._op_durs[i], acct)
        self.i += 1
        if self.i >= self.trace.num_indices:
            self.finished = self._end_iteration()
        return self.finished

    def release_residency(self) -> None:
        """Free everything this tenant still has charged to the accountant.

        Called when the tenant finishes: persistent variables (freed at
        ``delta[num_indices]``, which the op loop never applies) and any
        in-flight tail swap-outs would otherwise stay charged to the shared
        pool forever, starving later-admitted tenants.
        """
        acct = self.acct
        own = self._own_pending
        while own:
            rec = heapq.heappop(own)[2]
            if rec.retired:
                continue
            self.pending.retire(rec)
            acct.add(self.name, -rec.size)
        acct.add(self.name, -acct.resident.get(self.name, 0))

    # ------------------------------------------------------------- results
    def sim_result(self) -> SimResult:
        # Tail spill is *this tenant's* swap-out traffic draining past its
        # compute end — tracked as a running max over its own out transfers
        # (so it survives ``record_events=False``).  The shared
        # ``channels.drain_time("out")`` would charge other tenants'
        # in-flight swap-outs to this tenant.
        own_out_end = self._own_out_end if self._has_out else self.t
        res = SimResult(
            baseline_s=self.baseline_s * self.completed_iterations(),
            duration_s=self.t - self.admit_t,
            peak_resident=self.acct.peak.get(self.name, 0),
            stalls=self.stalls,
            delayed_mallocs=self.delayed,
            tail_spill_s=max(0.0, own_out_end - self.t),
            out_events=[(v, s, e) for v, s, e, _ in self.out_events],
            in_events=[(v, s, e) for v, s, e, _ in self.in_events],
        )
        return res

    def completed_iterations(self) -> int:
        return max(1, self.iter_no if self.finished else self.iterations)


# ------------------------------------------------------------------ reports
@dataclass
class TenantReport:
    name: str
    status: str                     # "completed" | "unschedulable"
    baseline_s: float
    duration_s: float               # compute span, excluding queue wait
    overhead: float
    peak_resident: int
    floor: int                      # reservation at finish (after any shrink)
    stalls: int
    delayed_mallocs: int
    admitted_at: float
    finished_at: float
    queue_wait_s: float             # admitted_at - arrival_t
    arrival_t: float = 0.0
    priority: float = 1.0
    iterations: int = 1
    # Times this tenant was the renegotiation victim (plan re-solved at a
    # lower limit and applied at a barrier), the reservation bytes it gave
    # up, and the wall-clock spent in those online re-solves.
    renegotiations: int = 0
    renegotiation_freed_bytes: int = 0
    renegotiation_solve_ms: float = 0.0
    # Device pool this tenant ran against (None = the default shared device).
    device: str | None = None
    # Engine throughput: simulated op-steps this tenant executed.
    events: int = 0
    # Stall-attribution ledger: overhead seconds (duration - baseline)
    # decomposed into named causes.  Every key except ``overhead_s``,
    # ``queue_wait_s`` and ``renegotiation_solve_s`` is a bucket; the
    # buckets (including the float-closure ``residual_s``) sum to
    # ``overhead_s``.  None for unschedulable tenants; stripped by
    # ``simulated_report_dict`` (absent from the frozen reference engine).
    attribution: dict | None = None

    def as_dict(self) -> dict:
        return self.__dict__.copy()


@dataclass
class RuntimeReport:
    hardware: str
    budget: int | None
    channels: int
    tenants: list[TenantReport]
    aggregate_peak: int
    overflow_events: int
    makespan_s: float
    policy: str = "fifo"            # "fifo" | "renegotiate"
    renegotiations: int = 0         # applied victim re-plans
    renegotiations_cancelled: int = 0   # staged but nobody waited at barrier
    renegotiation_freed_bytes: int = 0
    renegotiation_solve_ms: float = 0.0
    # Mesh execution only (None on the legacy single-device shape, so the
    # serialized report is unchanged for existing consumers): per-device
    # aggregate peaks, and the shared HostLink's contention counters.
    device_peaks: dict[str, int] | None = None
    link: dict | None = None
    # Engine throughput counters (simulated events, wall-clock run and
    # renegotiation-solve seconds, events/sec).  Wall clock varies run to
    # run; ``simulated_report_dict`` strips this for equivalence checks.
    engine: dict | None = None
    # Sum of the per-tenant attribution ledgers (completed tenants only);
    # stripped by ``simulated_report_dict`` like the per-tenant ledgers.
    attribution: dict | None = None

    def tenant(self, name: str) -> TenantReport:
        for t in self.tenants:
            if t.name == name:
                return t
        raise KeyError(name)

    def as_dict(self) -> dict:
        d = {
            "hardware": self.hardware,
            "budget": self.budget,
            "channels": self.channels,
            "tenants": [t.as_dict() for t in self.tenants],
            "aggregate_peak": self.aggregate_peak,
            "overflow_events": self.overflow_events,
            "makespan_s": self.makespan_s,
            "policy": self.policy,
            "renegotiations": self.renegotiations,
            "renegotiations_cancelled": self.renegotiations_cancelled,
            "renegotiation_freed_bytes": self.renegotiation_freed_bytes,
            "renegotiation_solve_ms": self.renegotiation_solve_ms,
        }
        if self.device_peaks is not None:
            d["device_peaks"] = dict(self.device_peaks)
        if self.link is not None:
            d["link"] = dict(self.link)
        if self.engine is not None:
            d["engine"] = dict(self.engine)
        if self.attribution is not None:
            d["attribution"] = dict(self.attribution)
        return d


def simulated_report_dict(report: "RuntimeReport") -> dict:
    """``report.as_dict()`` reduced to the *simulated* quantities.

    Drops the wall-clock engine counters (different every run), the
    per-tenant event counts and the attribution ledgers (absent from the
    frozen reference engine's reports; the ledgers also carry the
    wall-clock ``renegotiation_solve_s``), leaving exactly the fields two
    engines must agree on bit-for-bit.  Works on fast and reference
    reports alike.
    """
    d = report.as_dict()
    d.pop("engine", None)
    d.pop("attribution", None)
    d["renegotiation_solve_ms"] = 0.0
    d["tenants"] = [dict(t) for t in d["tenants"]]
    for t in d["tenants"]:
        t.pop("events", None)
        t.pop("attribution", None)
        t["renegotiation_solve_ms"] = 0.0
    return d


# ----------------------------------------------------------- victim policies
class VictimPolicy:
    """Strategy for picking which running tenant a renegotiation shrinks.

    ``choose`` receives the engine, the head-of-line waiter, the bytes its
    admission still ``needed`` on its device pool, and the eligible victims
    in floor-greedy order (lowest priority, then largest floor, then name).
    It returns ``(run, new_limit, decisions, new_floor, solve_ms)`` for the
    staged re-plan, or ``None`` to fall back to plain FIFO queueing.

    ``deferred=False`` policies run synchronously inside the admission path
    (the legacy behavior).  ``deferred=True`` policies are invoked at the
    next event-loop top instead — the only point where the engine state is a
    consistent between-events snapshot, which simulation-probing policies
    (``repro.tune.LedgerVictimPolicy``) need to ``resume()`` candidate
    suffixes.  Deferral costs at most one simulated event of staging delay
    and never changes what the staged plan can observe (re-plans only apply
    at the victim's next iteration barrier either way).
    """

    name = "greedy"
    deferred = False

    def choose(self, engine: "MemoryRuntime", head: "Tenant", needed: int,
               victims: "list[_TenantRun]"):
        raise NotImplementedError


class FloorGreedyVictim(VictimPolicy):
    """The default: first eligible victim, shrunk by exactly ``needed``.

    Byte-for-byte the pre-policy engine loop (and the frozen reference's):
    walk victims in (priority, -floor, name) order, re-solve at
    ``floor - needed``, take the first solve whose new floor actually fits
    the shrunken limit."""

    def choose(self, engine, head, needed, victims):
        for v in victims:
            new_limit = v.floor - needed
            if new_limit <= 0:
                continue
            decisions, solve_ms = engine._replan(v.tenant, new_limit)
            new_floor = planned_peak(v.trace, decisions)
            if new_floor > new_limit:
                continue  # solver could not push the floor low enough
            return v, new_limit, decisions, new_floor, solve_ms
        return None


# ------------------------------------------------------------------- engine
class MemoryRuntime:
    """Co-schedules N tenant programs over K DMA channels under one budget.

    The run loop is event-driven: tenants enter at their ``arrival_t`` and
    are admitted when their resident floor fits the unreserved budget; the
    rest wait FIFO.  With ``renegotiate=True`` a waiting newcomer triggers
    preemptive floor renegotiation of a running victim (see ``Tenant``):
    ``replanner(tenant, new_limit)`` re-solves the victim's swap schedule,
    and the shrunken plan takes effect at the victim's next iteration
    barrier.  ``replanner`` defaults to the plan pipeline's SwapSelection
    pass (``repro_torch.runtime.tenants.pipeline_replanner``).

    ``record_events=False`` turns off per-transfer event logging (the
    ``in_events``/``out_events`` tuples grow unbounded across iterations) —
    keep the default for tests and schedule inspection, turn it off for
    fleet-scale horizons.  ``capture_snapshots=True`` snapshots the full
    engine state at every barrier where a renegotiated plan applies
    (``barrier_snapshots``); ``resume()`` on a snapshot replays only the
    suffix after that barrier, byte-identical to the full horizon.
    """

    def __init__(
        self,
        hw: HardwareSpec,
        budget: int | None = None,
        channels: int = 2,
        prefetch: str = "backsched",
        renegotiate: bool = False,
        replanner: Replanner | None = None,
        replan_scorer: str = "swdoa",
        replan_size_threshold: int = 1 << 20,
        link: HostLink | None = None,
        contention_aware: bool = True,
        record_events: bool = True,
        capture_snapshots: bool = False,
        max_snapshots: int | None = None,
        victim_policy: VictimPolicy | None = None,
        obs=None,
    ):
        if prefetch not in ("backsched", "eager"):
            raise ValueError(f"unknown prefetch policy {prefetch!r}")
        self.hw = hw
        self.budget = budget                 # per device pool
        self.num_channels = channels         # per device pool
        self.prefetch = prefetch
        self.renegotiate = renegotiate
        self.replanner = replanner
        self.replan_scorer = replan_scorer
        self.replan_size_threshold = replan_size_threshold
        # Mesh execution: the shared host-link bandwidth pool every device's
        # channels contend on (None = contention-free, the legacy model).
        # ``contention_aware`` lets prefetch back-scheduling budget the
        # effective lane bandwidth and the planned collective blackouts;
        # with False the link still constrains the physics but transfers are
        # scheduled as if it were private (the contention-blind baseline
        # benchmarks compare against).
        self.link = link
        self.contention_aware = contention_aware
        self.record_events = record_events
        self.capture_snapshots = capture_snapshots
        # Snapshot ring buffer: with churn storms every applied renegotiation
        # barrier deep-copies the whole engine, which grows without bound on
        # long horizons.  ``max_snapshots=N`` keeps only the N most recent —
        # ``resume()`` then replays suffixes from those barriers only;
        # earlier barriers are no longer resumable (the full run's report is
        # unaffected either way).  ``None`` keeps every snapshot.
        self.max_snapshots = max_snapshots
        # Victim selection is pluggable: the default reproduces the frozen
        # reference's floor-greedy loop bit for bit; ``repro.tune`` supplies
        # a ledger-driven policy that probes candidate (victim, limit) pairs
        # by re-simulating the suffix.
        self.victim_policy = (
            victim_policy if victim_policy is not None else FloorGreedyVictim()
        )
        # Optional observer (``repro.obs.ObsRecorder`` or anything with its
        # hook surface).  The engine only *calls* it — never reads from it —
        # so simulated reports are bit-identical obs-on vs obs-off; with
        # ``obs=None`` (default) each hook site costs one predicate, gated
        # exactly like ``record_events``.  Duck-typed on purpose: the engine
        # stays import-free of ``repro.obs``.
        self.obs = obs
        # Default (None) device pool, plus one pool per named Tenant.device.
        # The attribute names acct/channels/pending_outs keep the legacy
        # single-device surface tests and callers rely on.
        self.channels = ChannelPool.make(channels)
        self.acct = PoolAccountant(budget)
        self.pending_outs = _PendingQueue()
        self._accts: dict[str | None, PoolAccountant] = {None: self.acct}
        self._chans: dict[str | None, ChannelPool] = {None: self.channels}
        self._pending: dict[str | None, _PendingQueue] = {None: self.pending_outs}
        self.runs: dict[str, _TenantRun] = {}
        # Run-loop state (owned by run(); instance-level so _TenantRun
        # barrier callbacks can reach it).  Reservation accounting is per
        # device pool.
        self._arrivals: deque[Tenant] = deque()
        self._waiting: deque[Tenant] = deque()
        self._running: list[_TenantRun] = []
        self._reports: dict[str, TenantReport] = {}
        self._reserved: dict[str | None, int] = {}
        self._promised: dict[str | None, int] = {}  # bytes staged replans will free
        self._now = 0.0
        self._reneg_applied = 0
        self._reneg_cancelled = 0
        self._reneg_freed = 0
        self._reneg_solve_ms = 0.0
        # Event frontier: one (clock, admission seq, run) heap entry per
        # running tenant — the next event pops in O(log N) instead of the
        # reference engine's O(N) min-scan.  Ties resolve in admission order,
        # exactly the first-in-list element ``min`` used to return.
        self._event_heap: list[tuple[float, int, _TenantRun]] = []
        self._admit_seq = 0
        self._pending_seq = 0
        self._events = 0
        self.barrier_snapshots: list["MemoryRuntime"] = []
        self._snapshot_due = False
        self._tune_due = False

    # ----------------------------------------------------- device pools
    def acct_for(self, device: str | None) -> PoolAccountant:
        acct = self._accts.get(device)
        if acct is None:
            acct = self._accts[device] = PoolAccountant(self.budget)
        return acct

    def channels_for(self, device: str | None) -> ChannelPool:
        chans = self._chans.get(device)
        if chans is None:
            chans = self._chans[device] = ChannelPool.make(self.num_channels)
        return chans

    def pending_for(self, device: str | None) -> _PendingQueue:
        pending = self._pending.get(device)
        if pending is None:
            pending = self._pending[device] = _PendingQueue()
        return pending

    def _next_seq(self) -> int:
        seq = self._pending_seq
        self._pending_seq = seq + 1
        return seq

    # ------------------------------------------------------- transfers
    def xfer_seconds(self, size: int) -> float:
        """Duration of one swap transfer: the device link, further capped by
        the shared host-link lane bandwidth when a HostLink is configured."""
        if self.link is None:
            return size / self.hw.link_bw
        return size / min(self.hw.link_bw, self.link.lane_bw)

    def acquire_transfer(
        self, run: "_TenantRun", direction: str, ready_t: float, size: int,
        var: int = -1,
    ) -> tuple[float, float, int]:
        """Schedule one swap transfer for ``run``: it must hold the device's
        directional DMA channel and (when a HostLink is configured) a global
        link lane, and is shifted past any collective blackout.  ``var`` is
        the swapped variable, carried for the stall-attribution detail and
        the obs transfer hook (``-1``: unattributed legacy callers)."""
        chans = run.chans
        if self.link is None:
            duration = size / self.hw.link_bw
            start, end, ch = chans.acquire(direction, ready_t, duration)
            if direction == "in":
                run._in_detail[var] = (duration, start - ready_t, 0.0)
            if self.obs is not None:
                self.obs.transfer(run, direction, var, start, end, ch,
                                  None, ready_t, size)
            return start, end, ch
        ids = chans.out_ids if direction == "out" else chans.in_ids
        ch = min(ids, key=lambda c: chans.free_at[c])
        lane = min(self.link.lane_ids(direction),
                   key=lambda l: self.link.free_at[l])
        duration = self.xfer_seconds(size)
        queued = max(ready_t, chans.free_at[ch], self.link.free_at[lane])
        start = self.link.next_clear(queued, duration)
        end = start + duration
        chans.free_at[ch] = end
        self.link.free_at[lane] = end
        self.link.bytes_moved += size
        self.link.transfers += 1
        if direction == "in":
            self.link.wait_in_s += start - ready_t
            self.link.bytes_in += size
        else:
            self.link.wait_out_s += start - ready_t
            self.link.bytes_out += size
        if direction == "in":
            run._in_detail[var] = (duration, queued - ready_t, start - queued)
        if self.obs is not None:
            self.obs.transfer(run, direction, var, start, end, ch,
                              lane, ready_t, size)
        return start, end, ch

    # -------------------------------------------------------- admission path
    def _unschedulable(self, cand: Tenant, floor: int) -> None:
        self._reports[cand.name] = TenantReport(
            name=cand.name, status="unschedulable", baseline_s=0.0,
            duration_s=0.0, overhead=0.0, peak_resident=0, floor=floor,
            stalls=0, delayed_mallocs=0, admitted_at=-1.0,
            finished_at=-1.0, queue_wait_s=0.0, arrival_t=cand.arrival_t,
            priority=cand.priority, iterations=cand.iterations,
            device=cand.device,
        )
        if self.obs is not None:
            self.obs.unschedulable(cand.name, cand.arrival_t)

    def _try_admit(self, clock: float) -> None:
        """Admit waiting tenants FIFO while their floors fit the budget of
        their device pool; ``clock`` is the simulated time of the event that
        may have freed reservation.  The queue stays globally FIFO: a
        head-of-line tenant whose device is full blocks later arrivals even
        to other devices (admission order is part of the contract)."""
        while self._waiting:
            cand = self._waiting[0]
            floor = cand.resident_floor()
            if self.budget is not None and floor > self.budget:
                # Can never fit, even alone: report, do not OOM-kill others.
                self._waiting.popleft()
                self._unschedulable(cand, floor)
                continue
            reserved = self._reserved.get(cand.device, 0)
            if self.budget is not None and reserved + floor > self.budget:
                return  # FIFO: head-of-line waits for floor to free up
            self._waiting.popleft()
            self._reserved[cand.device] = reserved + floor
            run = _TenantRun(cand, self.hw, self, admit_t=max(clock, cand.arrival_t))
            self.runs[cand.name] = run
            self._running.append(run)
            run._admit_seq = self._admit_seq
            self._admit_seq += 1
            heapq.heappush(self._event_heap, (run.t, run._admit_seq, run))
            if self.obs is not None:
                self.obs.admitted(cand.name, cand.device,
                                  cand.arrival_t, run.admit_t,
                                  getattr(cand, "priority", 1.0))

    def _drain_arrivals(self, upto: float) -> None:
        """Move arrivals with ``arrival_t <= upto`` into the admission queue,
        in arrival order, admitting (or staging renegotiation) as they land."""
        while self._arrivals and self._arrivals[0].arrival_t <= upto:
            cand = self._arrivals.popleft()
            self._waiting.append(cand)
            self._try_admit(cand.arrival_t)
            self._maybe_renegotiate()

    # --------------------------------------------------------- renegotiation
    def _replan(self, tenant: Tenant, new_limit: int) -> tuple[list[SwapDecision], float]:
        if self.replanner is None:
            from .tenants import pipeline_replanner  # deferred: tenants imports engine

            self.replanner = pipeline_replanner(
                self.hw, scorer=self.replan_scorer,
                size_threshold=self.replan_size_threshold,
            )
        return self.replanner(tenant, new_limit)

    def _maybe_renegotiate(self) -> None:
        """If the head-of-line waiter doesn't fit, stage a victim re-plan.

        Victim order: lowest priority first, then largest floor (most bytes
        to reclaim).  A victim must have a future iteration barrier — the
        only point a shrunken plan can take effect — and only one staged
        re-plan at a time.  Falls back to FIFO queueing when no single
        victim can free enough.  The actual (victim, limit) pick is the
        ``victim_policy``'s; deferred policies run at the next loop top
        (see ``VictimPolicy``) instead of inside the admission path.
        """
        if not self.renegotiate or self.budget is None or not self._waiting:
            return
        if self.victim_policy.deferred:
            self._tune_due = True
            return
        self._stage_victim()

    def _stage_victim(self) -> None:
        """Ask the victim policy for a (victim, limit) and stage its re-plan.

        Re-validates the waiting state first: by the time a deferred policy
        runs, the head may already have been admitted (or departed victims
        may have freed enough reservation)."""
        if not self._waiting:
            return
        head = self._waiting[0]
        floor = head.resident_floor()
        if floor > self.budget:
            return  # unschedulable; _try_admit reports it
        needed = (
            self._reserved.get(head.device, 0)
            - self._promised.get(head.device, 0)
            + floor
            - self.budget
        )
        if needed <= 0:
            return  # staged re-plans already free enough; wait for barriers
        victims = [
            r for r in self._running
            if r.replan_pending is None and r.has_future_barrier()
            and r.device == head.device  # only same-pool bytes can help
        ]
        victims.sort(key=lambda r: (r.priority, -r.floor, r.name))
        choice = self.victim_policy.choose(self, head, needed, victims)
        if choice is None:
            return
        v, new_limit, decisions, new_floor, solve_ms = choice
        v.replan_pending = (list(decisions), new_floor, solve_ms)
        self._promised[v.device] = (
            self._promised.get(v.device, 0) + v.floor - new_floor
        )
        if self.obs is not None:
            self.obs.renegotiation("staged", v.name, v.t, new_limit)

    def _on_barrier(self, run: _TenantRun) -> None:
        """Iteration barrier of a victim with a staged re-plan (called from
        ``_end_iteration`` with the victim's residency already drained)."""
        # Arrivals up to the barrier precede it; process them first so the
        # apply-or-cancel decision sees the true waiting queue at this time.
        self._drain_arrivals(run.t)
        staged = run.replan_pending
        if staged is None:  # applied recursively while draining
            return
        decisions, new_floor, solve_ms = staged
        run.replan_pending = None
        freed = run.floor - new_floor
        self._promised[run.device] = self._promised.get(run.device, 0) - freed
        if not self._waiting:
            # Nobody waits anymore (a finish admitted them): keep the
            # better plan, don't shrink for no one.
            self._reneg_cancelled += 1
            if self.obs is not None:
                self.obs.renegotiation("cancelled", run.name, run.t, 0)
            return
        run._install_decisions(decisions)
        run.floor = new_floor
        self._reserved[run.device] = self._reserved.get(run.device, 0) - freed
        run.renegotiations += 1
        run.reneg_freed_bytes += freed
        run.reneg_solve_ms += solve_ms
        self._reneg_applied += 1
        self._reneg_freed += freed
        self._reneg_solve_ms += solve_ms
        if self.obs is not None:
            self.obs.renegotiation("applied", run.name, run.t, freed)
        self._try_admit(run.t)
        self._maybe_renegotiate()
        if self.capture_snapshots:
            # Applied at this barrier: snapshot at the next loop-top (a
            # clean between-events point) so resume() replays the suffix.
            self._snapshot_due = True

    # -------------------------------------------------------------- run loop
    def _finish(self, run: _TenantRun) -> None:
        self._running.remove(run)
        self._reserved[run.device] = self._reserved.get(run.device, 0) - run.floor
        if run.replan_pending is not None:
            # Departure beat the barrier: the staged shrink never applied.
            _, new_floor, _ = run.replan_pending
            self._promised[run.device] = (
                self._promised.get(run.device, 0) - (run.floor - new_floor)
            )
            run.replan_pending = None
            self._reneg_cancelled += 1
            if self.obs is not None:
                self.obs.renegotiation("cancelled", run.name, run.t, 0)
        run.release_residency()
        self._now = max(self._now, run.t)
        dur = run.t - run.admit_t
        base = run.baseline_s * run.completed_iterations()
        # Close the stall-attribution ledger: the named buckets plus a
        # float-closure residual sum to the tenant's overhead seconds.
        # ``collective_excess_s`` is only what the engine charged beyond the
        # collective time assign_times already folded into the baseline.
        overhead_s = max(0.0, dur - base)
        coll_excess = run.coll_s - run._extra_iter_s * run.completed_iterations()
        named = (run.attr_xfer_s + run.attr_black_s + run.attr_chan_s
                 + run.attr_outpend_s + run.stall_alloc_s + run.stall_drain_s
                 + coll_excess)
        attribution = {
            "overhead_s": overhead_s,
            "swap_in_transfer_s": run.attr_xfer_s,
            "link_blackout_s": run.attr_black_s,
            "channel_contention_s": run.attr_chan_s,
            "swap_out_pending_s": run.attr_outpend_s,
            "swap_out_drain_s": run.stall_alloc_s,
            "barrier_drain_s": run.stall_drain_s,
            "collective_excess_s": coll_excess,
            "residual_s": overhead_s - named,
            # Informational (outside the overhead sum): admission queueing
            # precedes ``admitted_at`` and the re-solve is host wall-clock.
            "queue_wait_s": run.admit_t - run.arrival_t,
            "renegotiation_solve_s": run.reneg_solve_ms / 1e3,
        }
        self._reports[run.name] = TenantReport(
            name=run.name, status="completed", baseline_s=base,
            duration_s=dur,
            overhead=max(0.0, (dur - base) / base) if base > 0 else 0.0,
            peak_resident=run.acct.peak.get(run.name, 0),
            floor=run.floor, stalls=run.stalls,
            delayed_mallocs=run.delayed, admitted_at=run.admit_t,
            finished_at=run.t, queue_wait_s=run.admit_t - run.arrival_t,
            arrival_t=run.arrival_t, priority=run.priority,
            iterations=run.completed_iterations(),
            renegotiations=run.renegotiations,
            renegotiation_freed_bytes=run.reneg_freed_bytes,
            renegotiation_solve_ms=run.reneg_solve_ms,
            device=run.device,
            events=run.events,
            attribution=attribution,
        )
        if self.obs is not None:
            self.obs.finished(run.name, run.device, run.t)
        self._try_admit(run.t)
        self._maybe_renegotiate()

    def _snapshot(self) -> "MemoryRuntime":
        """Deep-copy the engine mid-run, sharing the immutable heavy state.

        Traces (op times/costs/variables are read-only once assigned), the
        hardware spec and the replanner hook are shared between the live
        engine and the snapshot; everything mutable — accountants, channel
        pools, pending heaps, tenant runs, the event frontier — is copied,
        so ``resume()`` on the snapshot replays the suffix independently.
        """
        memo: dict[int, object] = {id(self.hw): self.hw}
        # The policy is config (plus an optional decision log), not simulated
        # state; prior barrier snapshots are themselves whole engines — both
        # are shared/elided rather than recursively deep-copied.
        memo[id(self.victim_policy)] = self.victim_policy
        memo[id(self.barrier_snapshots)] = []
        if self.replanner is not None:
            memo[id(self.replanner)] = self.replanner
        if self.obs is not None:
            # Shared, not copied: ``resume()`` on a snapshot appends its
            # suffix events to the same recorder (so replayed spans appear
            # twice if the original run also completed — detach obs before
            # resuming when that matters).
            memo[id(self.obs)] = self.obs
        traces = [t.trace for t in self._arrivals]
        traces += [t.trace for t in self._waiting]
        traces += [r.trace for r in self._running]
        for tr in traces:
            memo[id(tr)] = tr
            if tr.op_times is not None:
                memo[id(tr.op_times)] = tr.op_times
            if tr.op_costs is not None:
                memo[id(tr.op_costs)] = tr.op_costs
        snap = copy.deepcopy(self, memo)
        snap.barrier_snapshots = []
        snap.capture_snapshots = False
        snap._snapshot_due = False
        return snap

    def _probe_clone(self) -> "MemoryRuntime":
        """A what-if copy for candidate probing (``repro.tune``).

        Like ``_snapshot`` but detached from everything a probe must not
        touch: no observer (the live recorder would otherwise collect the
        probe's phantom events through the runs' cached ``_obs`` hooks), the
        *default* victim policy (a simulation-probing policy re-probing
        inside its own probes would recurse), and no event recording for
        tenants admitted during the probe.  Each call clones the live
        engine's pristine state, so sibling candidate probes at the same
        decision point can never observe each other's staged reservations.
        """
        snap = self._snapshot()
        snap.obs = None
        for r in snap._running:
            r._obs = None
        snap.victim_policy = FloorGreedyVictim()
        snap._tune_due = False
        snap.record_events = False
        return snap

    def _loop(self) -> None:
        heap = self._event_heap
        while self._arrivals or self._waiting or self._running:
            if self._snapshot_due:
                self._snapshot_due = False
                self.barrier_snapshots.append(self._snapshot())
                if (self.max_snapshots is not None
                        and len(self.barrier_snapshots) > self.max_snapshots):
                    # Ring buffer: drop the oldest barrier.  resume() can
                    # then only replay suffixes from the newest N barriers.
                    del self.barrier_snapshots[0]
            if self._tune_due:
                # Deferred victim staging: the loop top is a consistent
                # between-events point (every unfinished running tenant has a
                # frontier entry), so a probing policy can snapshot + resume
                # candidate suffixes here.
                self._tune_due = False
                self._stage_victim()
            if not self._running:
                if self._arrivals:
                    # Idle gap: jump the clock to the next arrival.
                    self._drain_arrivals(self._arrivals[0].arrival_t)
                else:
                    # Waiting only: nothing is reserved, so the head either
                    # admits now or is unschedulable outright.
                    self._try_admit(self._now)
                continue
            t_event, seq, run = heapq.heappop(heap)
            if run.finished:
                continue  # stale entry: the tenant finished meanwhile
            if run.t != t_event:
                heapq.heappush(heap, (run.t, seq, run))
                continue  # stale entry: the tenant's clock moved
            # Arrivals at or before this run's clock strictly precede its
            # next op (and may admit a tenant with an earlier clock).
            before = len(self._running)
            self._drain_arrivals(run.t)
            if len(self._running) != before:
                heapq.heappush(heap, (run.t, seq, run))
                continue  # the time frontier changed; re-pick the next event
            self._events += 1
            if run.step():
                # Process arrivals that landed inside the op the step just
                # executed *before* exposing the freed reservation: the
                # release happens at run.t, after those arrivals.
                self._drain_arrivals(run.t)
                self._finish(run)
            else:
                heapq.heappush(heap, (run.t, seq, run))

    def _link_dict(self) -> dict | None:
        if self.link is None:
            return None
        d = {
            "total_bw": self.link.total_bw,
            "lanes": self.link.lanes,
            "lane_bw": self.link.lane_bw,
            "bytes_moved": self.link.bytes_moved,
            "transfers": self.link.transfers,
            "blackout_s": self.link.blackout_s,
        }
        if self.link.out_lane_ids is not None:
            # Extra keys only on directionally-partitioned links: the default
            # shared-pool report must stay bit-identical to the frozen
            # reference engine's.
            d["out_lanes"] = len(self.link.out_lane_ids)
            d["in_lanes"] = len(self.link.in_lane_ids)
            d["wait_in_s"] = self.link.wait_in_s
            d["wait_out_s"] = self.link.wait_out_s
            d["bytes_in"] = self.link.bytes_in
            d["bytes_out"] = self.link.bytes_out
        return d

    def _final_report(self, order: list[str], wall_s: float) -> RuntimeReport:
        ordered = [self._reports[n] for n in order if n in self._reports]
        named_devices = sorted(d for d in self._accts if d is not None)
        attr_totals: dict[str, float] = {}
        for t in ordered:
            if t.attribution:
                for k, v in t.attribution.items():
                    attr_totals[k] = attr_totals.get(k, 0.0) + v
        return RuntimeReport(
            hardware=self.hw.name,
            budget=self.budget,
            channels=self.num_channels,
            tenants=ordered,
            # Sum of per-device-pool peaks: on the legacy single-pool shape
            # this is exactly the shared pool's aggregate peak.
            aggregate_peak=sum(a.aggregate_peak for a in self._accts.values()),
            overflow_events=sum(a.overflow_events for a in self._accts.values()),
            makespan_s=self._now,
            policy="renegotiate" if self.renegotiate else "fifo",
            renegotiations=self._reneg_applied,
            renegotiations_cancelled=self._reneg_cancelled,
            renegotiation_freed_bytes=self._reneg_freed,
            renegotiation_solve_ms=self._reneg_solve_ms,
            device_peaks=(
                {d: self._accts[d].aggregate_peak for d in named_devices}
                if named_devices
                else None
            ),
            link=self._link_dict(),
            engine={
                "events": self._events,
                "run_wall_s": wall_s,
                "events_per_s": self._events / wall_s if wall_s > 0 else 0.0,
                "solve_wall_s": self._reneg_solve_ms / 1e3,
            },
            attribution=attr_totals,
        )

    def run(self, tenants: Sequence[Tenant]) -> RuntimeReport:
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            # The accountant, runs map and reports are keyed by name; two
            # tenants sharing one would silently merge their residency.
            raise ValueError(f"tenant names must be unique, got {names}")
        self._order = names
        # Stable sort: same-instant arrivals keep submission (FIFO) order.
        self._arrivals = deque(sorted(tenants, key=lambda t: t.arrival_t))
        self._waiting.clear()
        self._running = []
        self._reports = {}
        self._reserved = {}
        self._promised = {}
        self._now = 0.0
        self._event_heap = []
        self._events = 0
        self.barrier_snapshots = []
        self._snapshot_due = False
        self._tune_due = False
        t0 = time.perf_counter()
        self._loop()
        return self._final_report(self._order, time.perf_counter() - t0)

    def resume(self) -> RuntimeReport:
        """Finish the horizon from a barrier snapshot — suffix-only replay.

        Call on an element of a completed run's ``barrier_snapshots``: the
        snapshot holds the full engine state at the barrier where a
        renegotiated plan applied, so only the events *after* that barrier
        are re-simulated.  The returned report is byte-identical (modulo the
        wall-clock ``engine`` counters) to the full-horizon run's.
        """
        t0 = time.perf_counter()
        self._loop()
        return self._final_report(self._order, time.perf_counter() - t0)


# ------------------------------------------------------- single-tenant path
def simulate_program(
    trace: IterationTrace,
    decisions: Sequence[SwapDecision],
    hw: HardwareSpec,
    limit: int | None = None,
    channels: int = 2,
    prefetch: str = "backsched",
    record_events: bool = True,
) -> SimResult:
    """Replay one iteration of one program — the paper's simulator, now as a
    1-tenant run of the runtime engine.  ``channels=2, prefetch="eager"``
    reproduces ``core.simulator.simulate_swap_schedule`` exactly; other K
    values model narrower/wider DMA engines and ``backsched`` (default) is
    the runtime's just-in-time prefetch policy.

    ``floor=0`` disables admission control to match the legacy contract: an
    over-limit schedule runs (with delays), it is not queued.
    """
    rt = MemoryRuntime(hw, budget=limit, channels=channels, prefetch=prefetch,
                       record_events=record_events)
    tenant = Tenant("t0", trace, list(decisions), limit=limit, floor=0)
    rt.run([tenant])
    return rt.runs["t0"].sim_result()
