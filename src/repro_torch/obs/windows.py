"""Windowed counters over simulated time: tumbling, sliding, hysteresis.

Counterpart of ``repro/obs/windows.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_obs.py``
holds the two equal.

All state advances on the *observation* timestamps the engine hooks carry
(simulated seconds), never wall clock, so windows are as deterministic as
the event stream that feeds them.  Three shapes:

  TumblingWindow      fixed-width consecutive windows; each closes with its
                      (start, count, sum, min, max) tuple once an
                      observation lands past its end.  A sample exactly on
                      a boundary ``k*width`` opens window ``k`` (half-open
                      ``[k*width, (k+1)*width)`` intervals).  Empty windows
                      emit nothing.
  SlidingWindow       sum/count over the trailing ``width`` seconds,
                      bucketed into ``resolution`` sub-windows (a ring, so
                      memory is O(resolution) regardless of horizon).
                      The trailing edge is bucket-quantized: the window
                      covers between ``width`` and ``width * (1 + 1/res)``
                      seconds, which is the standard rate-limiter
                      approximation and keeps updates O(1).
  HysteresisBand      a two-threshold comparator: ``update(t, value)``
                      returns "enter" when value first rises >= hi,
                      "exit" when an entered signal falls <= lo, else
                      None.  The dead band [lo, hi] suppresses chatter.

``AsymmetryWindow`` composes two SlidingWindows (in-wait vs out-wait) into
the windowed out/in wait ratio the adaptive-lane ROADMAP item gates on.
"""

from __future__ import annotations


class TumblingWindow:
    """Fixed-width window aggregator keyed on observation time."""

    __slots__ = ("width", "closed", "_idx", "_count", "_sum", "_min", "_max")

    def __init__(self, width: float):
        if width <= 0:
            raise ValueError("window width must be positive")
        self.width = float(width)
        # closed windows: (window_start, count, sum, min, max)
        self.closed: list[tuple] = []
        self._idx: int | None = None
        self._count = 0
        self._sum = 0.0
        self._min = 0.0
        self._max = 0.0

    def observe(self, t: float, value: float) -> None:
        idx = int(t // self.width)
        if self._idx is None:
            self._idx = idx
        elif idx != self._idx:
            self._close()
            self._idx = idx
        self._count += 1
        self._sum += value
        if self._count == 1:
            self._min = self._max = value
        else:
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value

    def _close(self) -> None:
        if self._count:
            self.closed.append(
                (self._idx * self.width, self._count, self._sum, self._min, self._max)
            )
        self._count = 0
        self._sum = 0.0

    def flush(self) -> list[tuple]:
        """Close the in-flight window (end of run) and return all closed."""
        if self._idx is not None:
            self._close()
            self._idx = None
        return self.closed


class SlidingWindow:
    """Trailing-``width`` sum/count with an O(resolution) bucket ring."""

    __slots__ = ("width", "resolution", "_bucket_w", "_sums", "_counts", "_head")

    def __init__(self, width: float, resolution: int = 16):
        if width <= 0:
            raise ValueError("window width must be positive")
        if resolution < 1:
            raise ValueError("resolution must be >= 1")
        self.width = float(width)
        self.resolution = int(resolution)
        self._bucket_w = self.width / self.resolution
        self._sums = [0.0] * (self.resolution + 1)
        self._counts = [0] * (self.resolution + 1)
        self._head: int | None = None  # absolute bucket index of newest bucket

    def _advance(self, t: float) -> None:
        idx = int(t // self._bucket_w)
        if self._head is None:
            self._head = idx
            return
        # Zero every ring slot between the old head and the new one; a jump
        # past a full revolution clears the whole ring.
        steps = idx - self._head
        if steps <= 0:
            return
        n = len(self._sums)
        if steps >= n:
            for i in range(n):
                self._sums[i] = 0.0
                self._counts[i] = 0
        else:
            for k in range(1, steps + 1):
                slot = (self._head + k) % n
                self._sums[slot] = 0.0
                self._counts[slot] = 0
        self._head = idx

    def add(self, t: float, value: float, count: int = 1) -> None:
        self._advance(t)
        slot = self._head % len(self._sums)
        self._sums[slot] += value
        self._counts[slot] += count

    def total(self, t: float | None = None) -> float:
        if t is not None:
            self._advance(t)
        return sum(self._sums)

    def count(self, t: float | None = None) -> int:
        if t is not None:
            self._advance(t)
        return sum(self._counts)


class HysteresisBand:
    """Two-threshold comparator with a dead band against chatter."""

    __slots__ = ("lo", "hi", "engaged")

    def __init__(self, lo: float, hi: float):
        if lo > hi:
            raise ValueError("hysteresis band needs lo <= hi")
        self.lo = float(lo)
        self.hi = float(hi)
        self.engaged = False

    def update(self, value: float) -> str | None:
        if not self.engaged and value >= self.hi:
            self.engaged = True
            return "enter"
        if self.engaged and value <= self.lo:
            self.engaged = False
            return "exit"
        return None


class AsymmetryWindow:
    """Windowed out/in link-wait ratio with a hysteresis band.

    Feed per-transfer queue waits via ``observe``; evaluate at blackout
    boundaries via ``evaluate(t)``, which returns (ratio, crossing) where
    crossing is "enter"/"exit"/None from the hysteresis band.  The ratio is
    ``(out_wait + eps) / (in_wait + eps)`` over the trailing window, so an
    idle direction reads as extreme rather than dividing by zero.
    """

    __slots__ = ("wait_in", "wait_out", "band", "eps", "last_ratio")

    def __init__(self, width: float, lo: float, hi: float,
                 resolution: int = 16, eps: float = 1e-9):
        self.wait_in = SlidingWindow(width, resolution)
        self.wait_out = SlidingWindow(width, resolution)
        self.band = HysteresisBand(lo, hi)
        self.eps = float(eps)
        self.last_ratio = 1.0

    def observe(self, t: float, direction: str, wait_s: float) -> None:
        if direction == "out":
            self.wait_out.add(t, wait_s)
        else:
            self.wait_in.add(t, wait_s)

    def ratio(self, t: float) -> float:
        w_in = self.wait_in.total(t)
        w_out = self.wait_out.total(t)
        return (w_out + self.eps) / (w_in + self.eps)

    def evaluate(self, t: float) -> tuple[float, str | None]:
        r = self.ratio(t)
        self.last_ratio = r
        return r, self.band.update(r)
