"""Streaming SLO monitor riding the pure-observer recorder hook path.

Counterpart of ``repro/obs/monitor.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_obs.py``
holds the two equal.

``MonitoredRecorder`` subclasses ``ObsRecorder``: every engine hook first
records exactly as before, then feeds the streaming layer — quantile
sketches (``repro.obs.sketch``) and sliding windows (``repro.obs.windows``)
over four streams:

  queue_wait   per-tenant admission wait, keyed by SLO priority class
  stall        per-op stall seconds, keyed by cause
  link         per-direction transfer queue wait (in vs out), plus the
               windowed out/in wait-ratio asymmetry signal
  hbm          per-device headroom (budget - pool total) sampled per op

Nothing here writes engine state: the monitor only observes hook
arguments, so simulated reports stay bit-identical with a monitor armed
(tests pin this against ``runtime/_engine_reference.py``).

SLOs are declarative specs parsed from compact strings (the ``--slo`` CLI
surface)::

    queue_wait.p99<0.005                      overall p99 queue wait SLO
    queue_wait.p95<0.002,prio=2               one priority class only
    stall.p99<0.01,cause=swap_in_wait         per-cause stall SLO
    link.out_in_wait_ratio>3,low=1.5,window=0.02   asymmetry alarm

Quantile SLOs alert on *burn rate* over two window lengths: with error
budget ``1 - q``, burn = (violating fraction in window) / budget; the SLO
fires when burn >= ``burn`` (default 1.0) in BOTH the short and the long
window with at least ``min`` samples in the short one, and re-arms once
the short-window burn falls to half the trigger — classic multi-window
multi-burn alerting, evaluated online at each sample, in event order, so
alert emission is exactly as deterministic as the engine's event stream.
Asymmetry SLOs evaluate the windowed out/in wait ratio at collective-
blackout boundaries through a hysteresis band (enter at >= threshold,
exit at <= ``low``).

Alerts are typed (``Alert``) and land in three sinks: the recorder's
``alerts`` list (consumed by ``trace_export`` as a pid-5 instant track),
the metrics registry (``monitor.alerts.<slo>`` counters), and the monitor
summary embedded in ``--monitor-out`` JSONL records.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .recorder import ObsRecorder
from .sketch import QuantileSketch
from .windows import AsymmetryWindow, SlidingWindow

PUBLISH_QUANTILES = (0.5, 0.95, 0.99)
REARM_FRACTION = 0.5  # short-window burn must fall to this * burn to re-arm


def priority_class(priority: float) -> str:
    """Stable label for an SLO priority class: 1.0 -> 'prio1'."""
    return "prio" + format(float(priority), "g")


@dataclass(frozen=True)
class SLOSpec:
    """One declarative SLO.  ``stream`` is 'queue_wait', 'stall' or
    'asymmetry'; quantile streams use threshold/quantile/burn windows,
    asymmetry uses threshold (enter) / low (exit) / window_s."""

    name: str
    stream: str
    threshold: float
    quantile: float | None = None
    cls: str | None = None        # priority class label, queue_wait only
    cause: str | None = None      # stall cause filter, stall only
    short_s: float = 0.05
    long_s: float = 0.25
    burn: float = 1.0
    min_count: int = 8
    low: float | None = None      # asymmetry exit threshold
    window_s: float = 0.05        # asymmetry window width

    def as_dict(self) -> dict:
        d = {"name": self.name, "stream": self.stream, "threshold": self.threshold}
        if self.quantile is not None:
            d.update(quantile=self.quantile, short_s=self.short_s,
                     long_s=self.long_s, burn=self.burn, min_count=self.min_count)
            if self.cls is not None:
                d["cls"] = self.cls
            if self.cause is not None:
                d["cause"] = self.cause
        else:
            d.update(low=self.low, window_s=self.window_s)
        return d


@dataclass(frozen=True)
class Alert:
    """One typed alert event (simulated time ``t``)."""

    t: float
    slo: str
    kind: str        # burn_rate | asymmetry_enter | asymmetry_exit
    value: float
    threshold: float
    detail: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {"t": self.t, "slo": self.slo, "kind": self.kind,
                "value": self.value, "threshold": self.threshold,
                "detail": dict(self.detail)}


def parse_slo(spec: str) -> SLOSpec:
    """Parse the compact ``--slo`` string form (see module docstring)."""
    text = spec.strip()
    head, _, tail = text.partition(",")
    opts: dict[str, str] = {}
    if tail:
        for part in tail.split(","):
            k, eq, v = part.partition("=")
            if not eq:
                raise ValueError(f"bad SLO option {part!r} in {spec!r}")
            opts[k.strip()] = v.strip()

    if "<" in head:
        metric, _, thr = head.partition("<")
        metric, thr = metric.strip(), float(thr)
        base, _, qpart = metric.rpartition(".")
        if not base or not qpart.startswith("p"):
            raise ValueError(f"quantile SLO must look like 'stream.pNN<thr': {spec!r}")
        q = float(qpart[1:]) / 100.0
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile out of range in {spec!r}")
        if base not in ("queue_wait", "stall"):
            raise ValueError(f"unknown SLO stream {base!r} in {spec!r}")
        cls = priority_class(float(opts["prio"])) if "prio" in opts else None
        cause = opts.get("cause")
        name = opts.get("name") or ".".join(
            x for x in (base, cause, cls, qpart) if x)
        return SLOSpec(
            name=name, stream=base, threshold=thr, quantile=q, cls=cls,
            cause=cause,
            short_s=float(opts.get("short", SLOSpec.short_s)),
            long_s=float(opts.get("long", SLOSpec.long_s)),
            burn=float(opts.get("burn", SLOSpec.burn)),
            min_count=int(opts.get("min", SLOSpec.min_count)),
        )
    if ">" in head:
        metric, _, thr = head.partition(">")
        if metric.strip() != "link.out_in_wait_ratio":
            raise ValueError(f"only link.out_in_wait_ratio takes '>': {spec!r}")
        hi = float(thr)
        low = float(opts.get("low", hi / 2.0))
        return SLOSpec(
            name=opts.get("name") or "link.out_in_wait_ratio",
            stream="asymmetry", threshold=hi, low=low,
            window_s=float(opts.get("window", SLOSpec.window_s)),
        )
    raise ValueError(f"SLO spec needs '<' or '>': {spec!r}")


class _BurnState:
    """Two-window burn-rate evaluator for one quantile SLO."""

    __slots__ = ("spec", "short", "long", "firing")

    def __init__(self, spec: SLOSpec):
        self.spec = spec
        self.short = SlidingWindow(spec.short_s)
        self.long = SlidingWindow(spec.long_s)
        self.firing = False

    def observe(self, t: float, value: float) -> "tuple[float, float] | None":
        v = 1.0 if value > self.spec.threshold else 0.0
        self.short.add(t, v)
        self.long.add(t, v)
        budget = 1.0 - self.spec.quantile
        ns, nl = self.short.count(), self.long.count()
        burn_s = (self.short.total() / ns) / budget if ns else 0.0
        burn_l = (self.long.total() / nl) / budget if nl else 0.0
        if not self.firing:
            if (ns >= self.spec.min_count and burn_s >= self.spec.burn
                    and burn_l >= self.spec.burn):
                self.firing = True
                return burn_s, burn_l
        elif burn_s <= self.spec.burn * REARM_FRACTION:
            self.firing = False
        return None


class SLOMonitor:
    """The streaming layer itself: sketches + windows + SLO evaluation.

    Kept separate from the recorder so tests (and future online consumers
    like adaptive lane reassignment) can feed it synthetic streams.
    """

    def __init__(self, slos=(), sketch_buffer: int = 512, exact: bool = False,
                 asymmetry_window_s: float = 0.05):
        self.specs: list[SLOSpec] = [
            parse_slo(s) if isinstance(s, str) else s for s in slos]
        names = [s.name for s in self.specs]
        if len(names) != len(dict.fromkeys(names)):
            raise ValueError(f"duplicate SLO names: {sorted(names)}")
        self.alerts: list[Alert] = []
        self._sketch_buffer = int(sketch_buffer)
        self._exact = bool(exact)
        self.sketches: dict[str, QuantileSketch] = {}
        self._burn: list[_BurnState] = [
            _BurnState(s) for s in self.specs if s.quantile is not None]
        self._asym_specs = [s for s in self.specs if s.stream == "asymmetry"]
        self._asym = {
            s.name: AsymmetryWindow(s.window_s, lo=s.low, hi=s.threshold)
            for s in self._asym_specs}
        # Always-on ratio window backing monitor.link.out_in_wait_ratio.
        self._ratio = AsymmetryWindow(asymmetry_window_s, lo=0.0, hi=float("inf"))
        self._headroom_min: dict[str, float] = {}

    # ------------------------------------------------------------ plumbing
    def sketch(self, key: str) -> QuantileSketch:
        sk = self.sketches.get(key)
        if sk is None:
            sk = self.sketches[key] = QuantileSketch(
                self._sketch_buffer, exact=self._exact)
        return sk

    def _emit(self, alert: Alert) -> None:
        self.alerts.append(alert)

    # --------------------------------------------------------------- feeds
    def observe_queue_wait(self, t: float, cls: str, wait_s: float) -> None:
        self.sketch("queue_wait.all").add(wait_s)
        self.sketch(f"queue_wait.{cls}").add(wait_s)
        for b in self._burn:
            s = b.spec
            if s.stream != "queue_wait" or (s.cls is not None and s.cls != cls):
                continue
            hit = b.observe(t, wait_s)
            if hit is not None:
                self._emit(Alert(
                    t=t, slo=s.name, kind="burn_rate", value=hit[0],
                    threshold=s.burn,
                    detail={"burn_long": hit[1], "cls": cls,
                            "threshold_s": s.threshold}))

    def observe_stall(self, t: float, cause: str, seconds: float) -> None:
        self.sketch(f"stall.{cause}").add(seconds)
        for b in self._burn:
            s = b.spec
            if s.stream != "stall" or (s.cause is not None and s.cause != cause):
                continue
            hit = b.observe(t, seconds)
            if hit is not None:
                self._emit(Alert(
                    t=t, slo=s.name, kind="burn_rate", value=hit[0],
                    threshold=s.burn,
                    detail={"burn_long": hit[1], "cause": cause,
                            "threshold_s": s.threshold}))

    def observe_transfer(self, t: float, direction: str, wait_s: float) -> None:
        self.sketch(f"link.wait_{direction}").add(wait_s)
        self._ratio.observe(t, direction, wait_s)
        for s in self._asym_specs:
            self._asym[s.name].observe(t, direction, wait_s)

    def observe_headroom(self, t: float, dev: str, headroom: float) -> None:
        self.sketch(f"hbm.{dev}.headroom").add(headroom)
        prev = self._headroom_min.get(dev)
        if prev is None or headroom < prev:
            self._headroom_min[dev] = headroom

    def on_blackout_boundary(self, t: float) -> None:
        self._ratio.evaluate(t)
        for s in self._asym_specs:
            ratio, crossing = self._asym[s.name].evaluate(t)
            if crossing is not None:
                self._emit(Alert(
                    t=t, slo=s.name, kind=f"asymmetry_{crossing}", value=ratio,
                    threshold=s.threshold if crossing == "enter" else s.low,
                    detail={"window_s": s.window_s}))

    # ------------------------------------------------------------- publish
    def quantile_summary(self) -> dict:
        """``{stream_key: {count, bound, p50, p95, p99, min, max}}``."""
        out: dict[str, dict] = {}
        for key in sorted(self.sketches):
            sk = self.sketches[key]
            if sk.count == 0:
                continue
            entry = {"count": sk.count, "rank_error_bound": sk.rank_error_bound(),
                     "min": sk.min, "max": sk.max}
            for q in PUBLISH_QUANTILES:
                entry[f"p{format(q * 100, 'g')}"] = sk.quantile(q)
            out[key] = entry
        return out

    def publish(self, metrics) -> None:
        """Fold the streaming state into a ``MetricsRegistry``."""
        for key, entry in self.quantile_summary().items():
            for stat in sorted(entry):
                if stat in ("min", "max"):
                    continue
                metrics.gauge(f"monitor.{key}.{stat}").set(entry[stat])
        metrics.gauge("monitor.link.out_in_wait_ratio").set(self._ratio.last_ratio)
        for dev in sorted(self._headroom_min):
            metrics.gauge(f"monitor.hbm.{dev}.headroom_min").set(
                self._headroom_min[dev])
        for a in self.alerts:
            metrics.counter(f"monitor.alerts.{a.slo}").inc()

    def summary(self) -> dict:
        """JSON-ready digest for ``--monitor-out`` / obsdiff."""
        return {
            "slos": [s.as_dict() for s in self.specs],
            "quantiles": self.quantile_summary(),
            "alerts": [a.as_dict() for a in self.alerts],
        }


class MonitoredRecorder(ObsRecorder):
    """An ``ObsRecorder`` that additionally feeds an ``SLOMonitor``.

    Drop-in wherever ``obs=`` takes a recorder; still a pure observer.
    ``priorities`` maps tenant name -> SLO priority as reported at
    admission (kept out of the ``admissions`` tuples, whose 4-wide shape
    ``trace_export`` and ``schedule_check`` both unpack).
    """

    def __init__(self, slos=(), metrics=None, op_slices: bool = True,
                 sketch_buffer: int = 512, exact: bool = False):
        super().__init__(metrics=metrics, op_slices=op_slices)
        self.monitor = SLOMonitor(slos, sketch_buffer=sketch_buffer, exact=exact)
        self._finalized = False

    @property
    def alerts(self) -> list[Alert]:
        return self.monitor.alerts

    @property
    def slo_specs(self) -> list[SLOSpec]:
        return self.monitor.specs

    # ------------------------------------------------------- hook overrides
    def admitted(self, name, device, arrival_t, admit_t, priority=1.0) -> None:
        super().admitted(name, device, arrival_t, admit_t, priority)
        self.monitor.observe_queue_wait(
            admit_t, priority_class(priority), admit_t - arrival_t)

    def stall(self, run, cause, t0, seconds, var) -> None:
        super().stall(run, cause, t0, seconds, var)
        self.monitor.observe_stall(t0, cause, seconds)

    def transfer(self, run, direction, var, start, end, ch, lane,
                 ready_t, size) -> None:
        super().transfer(run, direction, var, start, end, ch, lane, ready_t, size)
        self.monitor.observe_transfer(start, direction, max(0.0, start - ready_t))

    def op_step(self, run, i, t0, t1, acct) -> None:
        super().op_step(run, i, t0, t1, acct)
        budget = getattr(acct, "budget", None)
        if budget is not None:
            dev = "default" if run.device is None else str(run.device)
            self.monitor.observe_headroom(t1, dev, budget - acct.total)

    def blackout(self, start, end) -> None:
        super().blackout(start, end)
        self.monitor.on_blackout_boundary(end)

    # --------------------------------------------------------------- output
    def finalize(self) -> dict:
        """Publish streaming state into the metrics registry (idempotent)
        and return the monitor summary."""
        if not self._finalized:
            self.monitor.publish(self.metrics)
            self._finalized = True
        return self.monitor.summary()
