"""ObsRecorder: the event sink ``runtime.MemoryRuntime(obs=...)`` feeds.

Counterpart of ``repro/obs/recorder.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_obs.py``
holds the two equal.

The engine calls one hook per observable event — op execution, swap
transfer, stall (by named cause), host-link blackout, admission, tenant
finish, renegotiation lifecycle — passing simulated times and the tenant
run objects it already holds.  The recorder is a *pure observer*: it reads
engine state, never writes it, so simulated reports are bit-identical with
a recorder attached or not (tests/test_obs.py pins this).

Storage is flat tuple lists (cheap appends; the export layer does all the
shaping) plus a ``MetricsRegistry`` the hooks fold into, so one run yields
both the full Perfetto timeline and the aggregate counter snapshot.

``op_slices=False`` keeps the per-op span/occupancy stream off for very
long horizons (transfers, stalls, admissions and metrics still record) —
the lists are the only unbounded state here.

Duck-typing note: hooks taking ``run`` only read ``run.name`` and
``run.device`` — any object with those attributes works, which is what
keeps this module import-free of the engine (and the engine import-free of
``repro.obs`` except for the ``obs=`` parameter it never introspects).
"""

from __future__ import annotations

from .metrics import MetricsRegistry


class ObsRecorder:
    def __init__(self, metrics: MetricsRegistry | None = None, op_slices: bool = True):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.op_slices = op_slices
        # (name, device, op index, t0, t1, resident bytes, device total bytes)
        self.ops: list[tuple] = []
        # (name, device, op index, t0, seconds)
        self.collectives: list[tuple] = []
        # (name, device, cause, t0, seconds, var)
        self.stalls: list[tuple] = []
        # (name, device, direction, var, start, end, channel, lane|None, ready_t, size)
        self.transfers: list[tuple] = []
        # (start, end) on the shared host link
        self.blackouts: list[tuple] = []
        # (name, device, arrival_t, admit_t) — 4-wide on purpose: both
        # trace_export and analyze.schedule_check unpack this shape.
        self.admissions: list[tuple] = []
        # tenant name -> SLO priority as reported at admission
        self.priorities: dict[str, float] = {}
        # (name, arrival_t)
        self.unschedulables: list[tuple] = []
        # (kind: staged|applied|cancelled, victim, t, value: new_limit|freed bytes|0)
        self.renegotiations: list[tuple] = []
        # (name, device, finish_t)
        self.finishes: list[tuple] = []

    # ------------------------------------------------------------ engine hooks
    def op_step(self, run, i: int, t0: float, t1: float, acct) -> None:
        """One executed op: its compute span plus an HBM occupancy sample
        (this tenant's resident bytes and its device pool's total) taken at
        the end of the step, after swap-out launches/retirements and
        prefetches settled."""
        if self.op_slices:
            self.ops.append(
                (run.name, run.device, i, t0, t1,
                 acct.resident.get(run.name, 0), acct.total)
            )
        self.metrics.counter("engine.ops").inc()

    def collective(self, run, i: int, t0: float, seconds: float) -> None:
        if self.op_slices:
            self.collectives.append((run.name, run.device, i, t0, seconds))
        self.metrics.counter("engine.collectives").inc()
        self.metrics.counter("engine.collective_s").inc(seconds)

    def stall(self, run, cause: str, t0: float, seconds: float, var: int) -> None:
        self.stalls.append((run.name, run.device, cause, t0, seconds, var))
        self.metrics.counter(f"engine.stalls.{cause}").inc()
        self.metrics.counter(f"engine.stall_s.{cause}").inc(seconds)

    def transfer(self, run, direction: str, var: int, start: float, end: float,
                 ch: int, lane: "int | None", ready_t: float, size: int) -> None:
        self.transfers.append(
            (run.name, run.device, direction, var, start, end, ch, lane, ready_t, size)
        )
        self.metrics.counter(f"engine.transfers.{direction}").inc()
        self.metrics.counter(f"engine.transfer_bytes.{direction}").inc(size)
        self.metrics.counter("engine.transfer_queue_s").inc(max(0.0, start - ready_t))

    def blackout(self, start: float, end: float) -> None:
        self.blackouts.append((start, end))
        self.metrics.counter("link.blackouts").inc()
        self.metrics.counter("link.blackout_s").inc(end - start)

    def admitted(self, name: str, device: "str | None",
                 arrival_t: float, admit_t: float, priority: float = 1.0) -> None:
        self.admissions.append((name, device, arrival_t, admit_t))
        self.priorities[name] = priority
        self.metrics.counter("admission.admitted").inc()
        self.metrics.counter("admission.queue_wait_s").inc(admit_t - arrival_t)

    def unschedulable(self, name: str, arrival_t: float) -> None:
        self.unschedulables.append((name, arrival_t))
        self.metrics.counter("admission.unschedulable").inc()

    def renegotiation(self, kind: str, victim: str, t: float, value: int) -> None:
        self.renegotiations.append((kind, victim, t, value))
        self.metrics.counter(f"renegotiation.{kind}").inc()
        if kind == "applied":
            self.metrics.counter("renegotiation.freed_bytes").inc(value)

    def finished(self, name: str, device: "str | None", t: float) -> None:
        self.finishes.append((name, device, t))
        self.metrics.counter("admission.finished").inc()
        self.metrics.gauge("engine.makespan_s").set_max(t)

    # --------------------------------------------------------------- shaping
    def tenant_names(self) -> list[str]:
        """Every tenant seen, in first-admission order (then first-event)."""
        seen: dict[str, None] = {}
        for name, *_ in self.admissions:
            seen.setdefault(name)
        for rec in self.ops:
            seen.setdefault(rec[0])
        for rec in self.stalls:
            seen.setdefault(rec[0])
        for rec in self.transfers:
            seen.setdefault(rec[0])
        for name, _ in self.unschedulables:
            seen.setdefault(name)
        return list(seen)
