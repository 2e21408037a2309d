"""Deterministic streaming quantile sketch (compacting-buffer family).

Counterpart of ``repro/obs/sketch.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_obs.py``
holds the two equal.

``QuantileSketch`` is a stdlib-only, merge-able sketch in the MRL/KLL
compacting-buffer style: level ``l`` holds a buffer of items each standing
for ``2**l`` original samples.  When a level fills past ``buffer_size`` it
is *compacted* — sorted, then every second element promoted one level up
with doubled weight.  Unlike randomized KLL, the parity of the surviving
elements is not a coin flip: each level keeps a parity bit that alternates
per compaction, so the same input stream always yields the same sketch
state bit-for-bit (the determinism lint covers this module) while the
alternation cancels the one-sided rank bias a fixed parity would build up.

Error accounting is *self-reported rather than probabilistic*: every
compaction at level ``l`` can shift any rank by at most ``2**l`` (the
weight of one discarded element), so the sketch tracks its compaction
counts and exposes

    rank_error_bound() = sum over levels of  count[l] * 2**l

an absolute worst-case rank error for any quantile query on this specific
stream.  For a buffer of size ``b`` and ``n`` samples this grows as
``O(n/b * log(n/b))`` ranks — with the default ``b=512``, under 1% relative
rank error out past 10^5 samples — and tests assert the *actual* error
against the *reported* bound, adversarial stream orders included.

``exact=True`` keeps every sample (no compaction, bound 0): the oracle
mode tests and benchmarks compare against.
"""

from __future__ import annotations

from bisect import insort

DEFAULT_BUFFER_SIZE = 512


class QuantileSketch:
    """Streaming quantile estimates with a self-reported rank-error bound.

    Parameters
    ----------
    buffer_size:
        Per-level buffer capacity ``b``; memory is ``O(b log(n/b))``.
        Must be >= 2 (and even buffers compact cleanly; odd sizes work,
        the leftover element just stays behind).
    exact:
        Keep all samples and answer exactly (testing / post-hoc oracle).
    """

    __slots__ = ("buffer_size", "exact", "levels", "parity", "compactions", "count",
                 "_min", "_max")

    def __init__(self, buffer_size: int = DEFAULT_BUFFER_SIZE, exact: bool = False):
        if buffer_size < 2:
            raise ValueError("buffer_size must be >= 2")
        self.buffer_size = int(buffer_size)
        self.exact = bool(exact)
        self.levels: list[list[float]] = [[]]  # levels[l]: weight 2**l each
        self.parity: list[int] = [0]
        self.compactions: list[int] = [0]
        self.count = 0
        self._min: float | None = None
        self._max: float | None = None

    # ------------------------------------------------------------------ feed
    def add(self, x: float) -> None:
        x = float(x)
        self.count += 1
        if self._min is None or x < self._min:
            self._min = x
        if self._max is None or x > self._max:
            self._max = x
        self.levels[0].append(x)
        if not self.exact:
            self._compact_cascade()

    def extend(self, xs) -> None:
        for x in xs:
            self.add(x)

    def _grow_to(self, level: int) -> None:
        while len(self.levels) <= level:
            self.levels.append([])
            self.parity.append(0)
            self.compactions.append(0)

    def _compact_cascade(self) -> None:
        level = 0
        while level < len(self.levels) and len(self.levels[level]) >= self.buffer_size:
            buf = sorted(self.levels[level])
            keep = self.parity[level]  # alternate survivor parity per compaction
            self.parity[level] ^= 1
            self.compactions[level] += 1
            promoted = buf[keep::2]
            self._grow_to(level + 1)
            self.levels[level] = []
            self.levels[level + 1].extend(promoted)
            level += 1

    def merge(self, other: "QuantileSketch") -> None:
        """Fold ``other`` into self, level by level (deterministic: the
        merged state depends only on the two operand states and their
        order — ``a.merge(b)`` and ``b.merge(a)`` may differ, so callers
        merge in a fixed, documented order such as sorted stream keys)."""
        self._grow_to(len(other.levels) - 1)
        for l, buf in enumerate(other.levels):
            self.levels[l].extend(buf)
            self.compactions[l] += other.compactions[l]
        self.count += other.count
        for m in (other._min, other._max):
            if m is None:
                continue
            if self._min is None or m < self._min:
                self._min = m
            if self._max is None or m > self._max:
                self._max = m
        if not self.exact:
            self._compact_cascade()

    # ---------------------------------------------------------------- queries
    def _weighted(self) -> list[tuple[float, int]]:
        pairs: list[tuple[float, int]] = []
        for l, buf in enumerate(self.levels):
            w = 1 << l
            for x in buf:
                pairs.append((x, w))
        pairs.sort()
        return pairs

    def quantile(self, q: float) -> float:
        """The value at rank ``q * (count - 1)`` of the sketched stream
        (nearest-rank on the weighted sample; exact when ``exact=True``)."""
        if self.count == 0:
            raise ValueError("quantile() of an empty sketch")
        q = min(1.0, max(0.0, float(q)))
        pairs = self._weighted()
        total = 0
        for _, w in pairs:
            total += w
        target = q * (total - 1)
        cum = 0
        for x, w in pairs:
            cum += w
            if cum - 1 >= target:
                return x
        return pairs[-1][0]

    def quantiles(self, qs) -> list[float]:
        return [self.quantile(q) for q in qs]

    @property
    def min(self) -> float | None:
        return self._min

    @property
    def max(self) -> float | None:
        return self._max

    def rank_error_bound(self) -> int:
        """Worst-case absolute rank error of any ``quantile()`` answer on
        this stream: each compaction at level ``l`` moved any cut rank by
        at most ``2**l``.  0 in exact mode or before the first compaction."""
        bound = 0
        for l, c in enumerate(self.compactions):
            bound += c * (1 << l)
        return bound

    # ------------------------------------------------------------- serialize
    def to_dict(self) -> dict:
        return {
            "buffer_size": self.buffer_size,
            "exact": self.exact,
            "count": self.count,
            "min": self._min,
            "max": self._max,
            "rank_error_bound": self.rank_error_bound(),
        }


class ExactDistribution:
    """Sorted-insert exact order statistics — the post-hoc oracle the sketch
    is validated against (and the ``exact`` backend for small cells)."""

    __slots__ = ("values",)

    def __init__(self):
        self.values: list[float] = []

    def add(self, x: float) -> None:
        insort(self.values, float(x))

    def extend(self, xs) -> None:
        for x in xs:
            self.add(x)

    @property
    def count(self) -> int:
        return len(self.values)

    def quantile(self, q: float) -> float:
        if not self.values:
            raise ValueError("quantile() of an empty distribution")
        q = min(1.0, max(0.0, float(q)))
        idx = round(q * (len(self.values) - 1))
        return self.values[idx]

    def rank_of(self, x: float) -> int:
        """Number of stored values <= x (for rank-error assertions)."""
        lo, hi = 0, len(self.values)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.values[mid] <= x:
                lo = mid + 1
            else:
                hi = mid
        return lo
