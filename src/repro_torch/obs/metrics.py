"""Lightweight metrics registry: named counters/gauges + a JSONL sink.

Counterpart of ``repro/obs/metrics.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_obs.py``
holds the two equal.

No dependencies, no background threads, no label cardinality machinery —
just enough structure that every subsystem increments the same named series
and one ``append_jsonl`` call lands a machine-readable sample on disk.
Names are dotted paths (``engine.transfers.in``); the snapshot is a flat
``{name: value}`` dict, so a run's JSONL history diffs and plots trivially.

The registry is deliberately *not* wired into the engine hot path directly:
``ObsRecorder`` owns one and folds its event hooks into counter updates, so
with no recorder attached the hot path never touches a metric.
"""

from __future__ import annotations

import json
import time


class Counter:
    """Monotone accumulator.  ``inc`` only; resets come from a new registry."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-written value, with a convenience running max."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def set_max(self, v: float) -> None:
        if v > self.value:
            self.value = v


class MetricsRegistry:
    """Get-or-create registry of counters and gauges.

    A name is either a counter or a gauge for the registry's lifetime;
    asking for the other kind under the same name raises, which catches the
    typo before it silently forks the series.
    """

    def __init__(self) -> None:
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            if name in self._gauges:
                raise ValueError(f"{name!r} is already registered as a gauge")
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            if name in self._counters:
                raise ValueError(f"{name!r} is already registered as a counter")
            g = self._gauges[name] = Gauge(name)
        return g

    def snapshot(self) -> dict:
        """Flat ``{name: value}`` over both kinds, sorted by name."""
        out = {n: c.value for n, c in self._counters.items()}
        out.update({n: g.value for n, g in self._gauges.items()})
        return dict(sorted(out.items()))

    def append_jsonl(self, path: str, extra: dict | None = None) -> dict:
        """Append one ``{"written_at": ..., "metrics": {...}}`` line to
        ``path`` (created if missing).  ``extra`` merges into the record
        top-level — run identifiers, bench cell names, and so on.  Returns
        the record written."""
        record = {
            "written_at": time.strftime("%Y-%m-%dT%H:%M:%S%z", time.localtime()),
            "metrics": self.snapshot(),
        }
        if extra:
            record.update(extra)
        with open(path, "a") as f:
            f.write(json.dumps(record, sort_keys=True) + "\n")
        return record
