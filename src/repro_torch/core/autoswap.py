"""AutoSwap: automatic variable swapping (paper §IV).

Counterpart of ``repro/core/autoswap.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_solvers.py``
holds the two equal.

Pipeline:
  candidates (§IV-A)  ->  priority scores (§IV-B)  ->  selection (§IV-D)
  ->  schedule + overhead (§IV-E, simulated in core/simulator.py)

Candidates: size >= threshold (default 1 MB) and an access gap that spans the
peak-load time.  Weights/optimizer state additionally contribute a *wrap*
candidate (absence across the iteration boundary, paper §VI-B3).

Priority scores per candidate (higher = swap first):
  DOA    duration of absence: (t_next - t_prev) - transfer_out - transfer_in
  AOA    DOA * size  (or DOA / size when DOA < 0, per the paper)
  WDOA   integral of the original load curve over (t_prev, t_next)
  SWDOA  WDOA recomputed submodularly against the progressively-updated curve
  BO     a*AOA + b*DOA + c*WDOA + d*SWDOA on standardized scores, with the
         weights tuned by core/bayesopt.py against simulated overhead

Solve-time fast path (vs core/_solver_reference.ReferenceAutoSwapPlanner):

  * the load curve comes from the trace's memoized numpy cumsum and every
    window integral is O(1) off a prefix sum of ``load * dt`` (the reference
    re-ran ``np.diff`` over the full time axis per window, O(T) each);
  * the SWDOA re-ranking applies O(1) *delta* updates — subtracting the
    chosen candidate's ``size x overlap-seconds`` from exactly the scores its
    absence window intersects — instead of re-integrating every remaining
    candidate against the updated curve, turning O(k^2 T) into O(k^2) flat
    numpy work (a lazy max-heap degenerates to argmax over a k-vector here,
    which is both simpler and faster at numpy speed);
  * rankings, selections, the active test (via per-candidate window peaks)
    and ``load_min`` are memoized, so the limit-grid scan in
    ``max_zero_overhead_reduction`` never re-ranks or re-scores; only the
    per-limit simulation still runs per grid point (its result genuinely
    depends on the limit through malloc-delay accounting, so skipping it
    would change answers).

SWDOA/WDOA values agree with the reference to float tolerance (the delta
form accumulates O(k*eps) rounding); DOA/AOA are exact.  Selections are
pinned exactly against the reference on every tested and benchmarked trace
— in principle two candidates whose reference scores differ by less than
the O(k*eps) drift could rank in either order, but the comparison is
deterministic (same floats every run), so the CI pin can only trip when a
newly added trace genuinely near-ties, never flakily.
tests/test_solvetime.py pins scores and decisions against the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal, Sequence

import numpy as np

from .events import IterationTrace, VariableInfo
from .simulator import HardwareSpec, SimResult, SwapDecision, assign_times, simulate_swap_schedule

ScoreName = Literal["doa", "aoa", "wdoa", "swdoa"]
DEFAULT_SIZE_THRESHOLD = 1 << 20  # 1 MB (paper §IV-A)


@dataclass
class Candidate:
    var: int
    size: int
    out_after: int          # op index: access completing before the gap
    in_before: int          # op index: access needing the variable back
    wraps: bool = False
    scores: dict[str, float] = field(default_factory=dict)

    def decision(self) -> SwapDecision:
        return SwapDecision(self.var, self.size, self.out_after, self.in_before, self.wraps)


class AutoSwapPlanner:
    """Computes candidates, scores, selections and schedules for one trace."""

    def __init__(
        self,
        trace: IterationTrace,
        hw: HardwareSpec,
        size_threshold: int = DEFAULT_SIZE_THRESHOLD,
        include_wrap: bool = True,
    ):
        self.trace = trace
        self.hw = hw
        if trace.op_times is None:
            assign_times(trace, hw)
        self.times = np.asarray(trace.op_times)
        self.load = np.asarray(trace.load_curve_array(), dtype=np.float64)
        self.peak_load = int(self.load.max()) if self.load.size else 0
        self.peak_time = int(self.load.argmax()) if self.load.size else 0
        self.size_threshold = size_threshold
        self.candidates = self._find_candidates(include_wrap)
        # Prefix sums: _area_prefix[x] = integral of load*dt over ops [0, x),
        # so any window integral is one subtraction (O(1) per window).
        dt = np.diff(self.times) if self.times.size > 1 else np.zeros(0)
        self._dt = dt
        self._area_prefix = np.zeros(len(self.load) + 1, dtype=np.float64)
        if self.load.size:
            np.cumsum(self.load * dt[: len(self.load)], out=self._area_prefix[1:])
        self._score_all()
        # Memoized query state (scores are fixed after init, so every ranking
        # and selection is a pure function of its arguments).
        self._ranked_cache: dict = {}
        self._select_cache: dict = {}
        self._load_min: int | None = None
        self._win_peak = self._window_peaks()

    # ---------------------------------------------------------- candidates
    def _find_candidates(self, include_wrap: bool) -> list[Candidate]:
        """Candidate = (variable, canonical absence window).

        The paper filters to gaps spanning *the* peak index (§IV-A).  That
        works for CNNs (the peak sits on the broad end-of-forward shoulder)
        but collapses for LM steps whose instantaneous peak is a narrow
        CE-chunk spike: almost nothing crosses that single index.  We keep
        each variable's LARGEST access gap as its canonical window and defer
        peak-relevance to selection time (``_active``): a candidate is
        usable at a given limit iff its absence overlaps the over-limit
        region.  The paper's filter is the special case limit -> peak.
        """
        out: list[Candidate] = []
        for v in self.trace.variables:
            if v.size < self.size_threshold:
                continue
            acc = sorted(v.accesses)  # sorted once, shared by both gap scans
            gap = self._largest_gap(acc)
            if gap is not None:
                # prefer the gap spanning the global peak when one exists
                span = self._gap_spanning_peak(acc)
                a, b = span if span is not None else gap
                out.append(Candidate(v.var, v.size, a, b))
            if include_wrap and v.free_index >= self.trace.num_indices and acc:
                # Persists across iterations (weights/optimizer state/inputs):
                # absence across the iteration boundary (paper §VI-B3).
                out.append(Candidate(v.var, v.size, acc[-1], acc[0], wraps=True))
        return out

    @staticmethod
    def _largest_gap(acc: list[int]) -> tuple[int, int] | None:
        best = None
        for a, b in zip(acc, acc[1:]):
            if b - a > 1 and (best is None or b - a > best[1] - best[0]):
                best = (a, b)
        return best

    def _gap_spanning_peak(self, acc: list[int]) -> tuple[int, int] | None:
        """The consecutive-access pair (a, b) with a <= peak_time < b."""
        for a, b in zip(acc, acc[1:]):
            if a <= self.peak_time < b:
                return (a, b)
        return None

    def _window_peaks(self) -> np.ndarray:
        """Max original load inside each candidate's absence window.

        ``_active(limit)`` reduces to ``win_peak > limit``: the window
        overlaps the over-limit region iff its load maximum exceeds the
        limit.  Replaces the per-query O(k*T) mask construction."""
        peaks = np.zeros(len(self.candidates), dtype=np.float64)
        for i, c in enumerate(self.candidates):
            if not c.wraps:
                seg = self.load[c.out_after : c.in_before]
                peaks[i] = seg.max() if seg.size else -np.inf
            else:
                head = self.load[: c.in_before]
                tail = self.load[c.out_after :]
                m = -np.inf
                if head.size:
                    m = float(head.max())
                if tail.size:
                    m = max(m, float(tail.max()))
                peaks[i] = m
        return peaks

    def _active(self, limit: int) -> list[Candidate]:
        """Candidates whose absence overlaps the over-limit load region."""
        return [
            c
            for i, c in enumerate(self.candidates)
            if self._win_peak[i] > limit
        ]

    # ---------------------------------------------------------- scoring
    def _interval_seconds(self, c: Candidate) -> float:
        if not c.wraps:
            return float(self.times[c.in_before] - self.times[c.out_after])
        # Wrap: tail-of-iteration + head-of-next (same shape in steady state).
        total = float(self.times[-1])
        return (total - float(self.times[c.out_after])) + float(self.times[c.in_before])

    def _load_area(self, load: np.ndarray, c: Candidate) -> float:
        """Integral of `load` over the candidate's absence window (seconds*bytes)."""
        dt = self._dt
        if not c.wraps:
            sl = slice(c.out_after, c.in_before)
            return float((load[sl] * dt[sl]).sum())
        head = slice(0, c.in_before)
        tail = slice(c.out_after, len(load))
        return float((load[head] * dt[head]).sum() + (load[tail] * dt[tail]).sum())

    def _prefix_area(self, c: Candidate) -> float:
        """O(1) window integral of the *original* curve off the prefix sum."""
        P = self._area_prefix
        if not c.wraps:
            return float(P[c.in_before] - P[c.out_after])
        return float(P[c.in_before] - P[0] + P[-1] - P[c.out_after])

    def _absence_mask(self, c: Candidate) -> np.ndarray:
        m = np.zeros(len(self.load), dtype=bool)
        if not c.wraps:
            m[c.out_after : c.in_before] = True
        else:
            m[: c.in_before] = True
            m[c.out_after :] = True
        return m

    def _segments(self) -> tuple[np.ndarray, ...]:
        """Each candidate's absence window as up to two [s, e) op-index
        segments ((0, in)+(out, T) for wrap candidates; second segment empty
        otherwise), as four parallel int arrays."""
        k = len(self.candidates)
        T = len(self.load)
        out = np.fromiter((c.out_after for c in self.candidates), np.int64, k)
        inb = np.fromiter((c.in_before for c in self.candidates), np.int64, k)
        wraps = np.fromiter((c.wraps for c in self.candidates), bool, k)
        s1 = np.where(wraps, 0, out)
        e1 = inb
        s2 = np.where(wraps, out, 0)
        e2 = np.where(wraps, T, 0)
        return s1, e1, s2, e2

    def _overlap_seconds(self, i: int, segs: tuple[np.ndarray, ...]) -> np.ndarray:
        """Seconds of overlap between candidate i's absence window and every
        candidate's window (vectorized; the SWDOA delta kernel)."""
        s1, e1, s2, e2 = segs
        t = self.times
        out = np.zeros(len(self.candidates), dtype=np.float64)
        for ps, pe in ((int(s1[i]), int(e1[i])), (int(s2[i]), int(e2[i]))):
            if pe <= ps:
                continue
            for qs, qe in ((s1, e1), (s2, e2)):
                lo = np.maximum(qs, ps)
                hi = np.minimum(qe, pe)
                valid = hi > lo
                out += np.where(valid, t[hi] - t[lo], 0.0)
        return out

    def _score_all(self) -> None:
        transfer = lambda c: 2.0 * c.size / self.hw.link_bw  # out + in
        for c in self.candidates:
            doa = self._interval_seconds(c) - transfer(c)
            aoa = doa * c.size if doa >= 0 else doa / c.size
            wdoa = self._prefix_area(c)
            c.scores.update(doa=doa, aoa=aoa, wdoa=wdoa)
        # SWDOA: re-rank against the progressively-updated load curve (§IV-B
        # iv).  The integral is linear in the curve, so the score of c after
        # applying b is  area(c) - b.size * overlap_seconds(b, c)  — an O(1)
        # delta per (chosen, remaining) pair instead of re-integrating the
        # full curve.  Each round applies the delta vector and takes the
        # argmax of still-unscored candidates (ties resolve to the earliest
        # candidate, matching the reference's first-max semantics).
        k = len(self.candidates)
        if not k:
            return
        segs = self._segments()
        area = np.fromiter((c.scores["wdoa"] for c in self.candidates), np.float64, k)
        alive = np.ones(k, dtype=bool)
        for _ in range(k):
            i = int(np.argmax(np.where(alive, area, -np.inf)))
            c = self.candidates[i]
            c.scores["swdoa"] = float(area[i])
            alive[i] = False
            if alive.any():
                area -= c.size * self._overlap_seconds(i, segs)

    def standardized(self) -> dict[str, np.ndarray]:
        """Z-scored score vectors aligned with ``self.candidates`` (paper §IV-C)."""
        out = {}
        for k in ("doa", "aoa", "wdoa", "swdoa"):
            x = np.array([c.scores[k] for c in self.candidates], dtype=np.float64)
            std = x.std()
            out[k] = (x - x.mean()) / std if std > 0 else np.zeros_like(x)
        return out

    # ---------------------------------------------------------- selection
    def ranked(
        self,
        method: ScoreName | None = None,
        weights: Sequence[float] | None = None,
    ) -> list[Candidate]:
        key = (method, tuple(weights) if weights is not None else None)
        hit = self._ranked_cache.get(key)
        if hit is not None:
            return list(hit)
        if weights is not None:
            z = self.standardized()
            combo = (
                weights[0] * z["aoa"] + weights[1] * z["doa"]
                + weights[2] * z["wdoa"] + weights[3] * z["swdoa"]
            )
            order = np.argsort(-combo, kind="stable")
            out = [self.candidates[i] for i in order]
        else:
            assert method is not None
            out = sorted(self.candidates, key=lambda c: -c.scores[method])
        self._ranked_cache[key] = out
        return list(out)

    def select(
        self,
        limit: int,
        method: ScoreName | None = "swdoa",
        weights: Sequence[float] | None = None,
    ) -> list[SwapDecision]:
        """Greedy selection until the synchronously-updated peak <= limit (§IV-D)."""
        key = (limit, method, tuple(weights) if weights is not None else None)
        hit = self._select_cache.get(key)
        if hit is not None:
            return list(hit)
        active_set = {(c.var, c.wraps) for c in self._active(limit)}
        work = self.load.copy()
        peak = work.max() if work.size else 0
        chosen: list[SwapDecision] = []
        seen: set[int] = set()
        for c in self.ranked(method, weights):
            if peak <= limit:
                break
            if (c.var, c.wraps) not in active_set:
                continue
            if c.var in seen:
                continue  # one absence window per variable
            seen.add(c.var)
            work -= c.size * self._absence_mask(c)
            peak = work.max()
            chosen.append(c.decision())
        self._select_cache[key] = chosen
        return list(chosen)

    def updated_load(self, decisions: Sequence[SwapDecision]) -> np.ndarray:
        work = self.load.copy()
        for d in decisions:
            c = Candidate(d.var, d.size, d.out_after, d.in_before, d.wraps)
            work = work - d.size * self._absence_mask(c)
        return work

    def load_min(self) -> int:
        """Peak load with *all* candidates absent (paper §VI-B1 load_min)."""
        if self._load_min is not None:
            return self._load_min
        work = self.load.copy()
        seen: set[int] = set()
        for c in self.candidates:
            if c.var in seen:
                continue
            seen.add(c.var)
            work -= c.size * self._absence_mask(c)
        self._load_min = int(work.max()) if work.size else 0
        return self._load_min

    # ---------------------------------------------------------- evaluation
    def evaluate(
        self,
        limit: int,
        method: ScoreName | None = "swdoa",
        weights: Sequence[float] | None = None,
    ) -> SimResult:
        decisions = self.select(limit, method, weights)
        return simulate_swap_schedule(self.trace, decisions, self.hw, limit)

    def max_zero_overhead_reduction(
        self,
        method: ScoreName | None = "swdoa",
        weights: Sequence[float] | None = None,
        tol: float = 0.005,
        grid: int = 32,
    ) -> tuple[int, float]:
        """Lowest achievable load with ~zero overhead (paper Table II).

        Scans a limit grid from peak down to load_min (overhead is not
        monotone in the limit — paper Fig 9 — so no bisection).  The scan
        reuses one ranking and the memoized active/selection state across
        every grid point; only the discrete-event simulation runs per point,
        because its malloc-delay accounting genuinely depends on the limit
        (two identical selections at different limits can cost differently),
        so skipping it would change the reported reduction."""
        lo, hi = self.load_min(), self.peak_load
        if hi <= lo:
            return hi, 0.0
        best_limit, best_ov = hi, 0.0
        for k in range(1, grid + 1):
            limit = int(hi - (hi - lo) * k / grid)
            r = self.evaluate(limit, method, weights)
            if r.overhead <= tol:
                best_limit, best_ov = limit, r.overhead
            elif r.overhead > 5 * tol and k > grid // 2:
                break
        return best_limit, best_ov
