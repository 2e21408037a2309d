"""Mesh-wide execution: N per-device tenant groups over one shared host link.

Counterpart of ``repro/dist/execute.py``, whose code this is, with its
imports pointed into ``repro_torch``; ``tests/test_torch_dist.py`` holds
the two equal.

Builds one runtime tenant per device from a solved ``ShardedProgram`` and
runs them through ``runtime.MemoryRuntime`` with

  * a *per-device* HBM pool (each device gets its own accountant and DMA
    channel pool — the engine's ``Tenant.device`` machinery), and
  * a shared ``HostLink`` bandwidth pool: every device's channels contend on
    one PCIe/NVLink budget, and the collectives tagged by the sharded
    tracer black the link out so swap-ins back-schedule around them.

The contention-blind baseline (``contention_aware=False``) keeps the same
physical link but schedules transfers without looking at the collective
windows — the comparison the reference's ``bench_dist.py`` gates on and
``chip_smoke.py``'s phase 22 prints.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..core.simulator import HardwareSpec
from ..runtime.engine import HostLink, MemoryRuntime, RuntimeReport, Tenant
from .program import ShardedProgram, solved_decisions


@dataclass
class MeshRunResult:
    """One mesh-wide run plus the per-device schedule for comparisons."""

    report: RuntimeReport
    contended: bool
    contention_aware: bool
    # Per-tenant swap schedules as (var, start, end) triples — the observable
    # the contention acceptance compares across model variants.
    schedules: dict[str, dict[str, list[tuple[int, float, float]]]] = field(
        default_factory=dict
    )
    # HostLink lane policy: "static" (shared pool, the default) or
    # "directional" (lanes carved between swap-out and swap-in from a probe
    # run's per-direction queue-wait split — ``repro_torch.tune.lanes``).
    # ``lane_info`` records the probe evidence and the chosen carve.
    lane_split: str = "static"
    lane_info: dict | None = None

    @property
    def makespan_s(self) -> float:
        return self.report.makespan_s

    def max_overhead(self) -> float:
        return max((t.overhead for t in self.report.tenants), default=0.0)

    def mean_overhead(self) -> float:
        ts = self.report.tenants
        return sum(t.overhead for t in ts) / len(ts) if ts else 0.0


def mesh_tenants(
    solved: ShardedProgram,
    iterations: int = 1,
) -> list[Tenant]:
    """One tenant per device; devices of the same group share the solved
    trace/schedule objects (fan-out, not re-solve)."""
    tenants = []
    owned: set[str] = set()
    for device, group in sorted(solved.capture.device_group.items()):
        program = solved.programs[group]
        limit, decisions = solved_decisions(solved, group)
        sharded = solved.capture.groups[group]
        tenants.append(
            Tenant(
                name=f"{group}.d{device}",
                trace=program.require_trace(),
                decisions=list(decisions),
                limit=limit,
                iterations=iterations,
                device=f"d{device}",
                collectives=sharded.collective_map(),
                # One blackout per mesh-wide collective: the group's first
                # device owns registering it on the shared link.
                collective_owner=group not in owned,
            )
        )
        owned.add(group)
    return tenants


def run_mesh(
    solved: ShardedProgram,
    hw: HardwareSpec,
    budget_per_device: int | None = None,
    channels: int = 2,
    iterations: int = 1,
    link_bw: float | None = None,
    link_lanes: int | None = None,
    contended: bool = True,
    contention_aware: bool = True,
    prefetch: str = "backsched",
    record_events: bool = True,
    obs=None,
    lane_split: str = "static",
) -> MeshRunResult:
    """Execute the solved per-device plans mesh-wide.

    ``link_bw`` defaults to the device link bandwidth — i.e. ONE device's
    worth of host bandwidth shared by all of them, the typical one-root-
    complex host.  ``link_lanes`` defaults to 2 (one out + one in lane
    globally).  ``contended=False`` removes the shared link entirely
    (every device gets its full private bandwidth — the upper bound).

    ``lane_split="directional"`` first runs an unlogged probe over the same
    configuration with the default shared lane pool, reads the link's
    per-direction queue-wait decomposition, and carves the lanes between
    swap-out and swap-in proportionally (``repro_torch.tune.lane_split_from_waits``)
    for the reported run.  Falls back to the shared pool when the probe
    shows no directional evidence (or ``link_lanes < 2``); the chosen carve
    and the probe evidence land in ``MeshRunResult.lane_info``.

    ``record_events=False`` drops the per-transfer logs for long-horizon
    runs; ``schedules`` is then empty (``schedules_differ`` needs the logs,
    so keep the default when comparing schedule variants).

    ``obs`` attaches a ``repro_torch.obs.ObsRecorder`` for Perfetto trace export
    (pure observer: the report is bit-identical with or without it).
    """
    if lane_split not in ("static", "directional"):
        raise ValueError(f"unknown lane_split {lane_split!r}")
    total_bw = link_bw if link_bw is not None else hw.link_bw
    lanes = link_lanes if link_lanes is not None else 2
    out_lanes = None
    lane_info = None
    if lane_split == "directional" and contended:
        from ..tune.lanes import lane_split_from_waits

        probe = MemoryRuntime(
            hw, budget=budget_per_device, channels=channels, prefetch=prefetch,
            link=HostLink.make(total_bw=total_bw, lanes=lanes),
            contention_aware=contention_aware, record_events=False,
        )
        probe.run(mesh_tenants(solved, iterations=iterations))
        out_lanes = lane_split_from_waits(
            probe.link.wait_in_s, probe.link.wait_out_s, lanes,
            bytes_in=probe.link.bytes_in, bytes_out=probe.link.bytes_out,
        )
        lane_info = {
            "probe_wait_in_s": probe.link.wait_in_s,
            "probe_wait_out_s": probe.link.wait_out_s,
            "probe_bytes_in": probe.link.bytes_in,
            "probe_bytes_out": probe.link.bytes_out,
            "lanes": lanes,
            "out_lanes": out_lanes,
        }
    link = None
    if contended:
        link = HostLink.make(total_bw=total_bw, lanes=lanes, out_lanes=out_lanes)
    rt = MemoryRuntime(
        hw,
        budget=budget_per_device,
        channels=channels,
        prefetch=prefetch,
        link=link,
        contention_aware=contention_aware,
        record_events=record_events,
        obs=obs,
    )
    report = rt.run(mesh_tenants(solved, iterations=iterations))
    schedules = (
        {
            name: {
                "out": [(v, s, e) for v, s, e, _ in run.out_events],
                "in": [(v, s, e) for v, s, e, _ in run.in_events],
            }
            for name, run in rt.runs.items()
        }
        if record_events
        else {}
    )
    return MeshRunResult(
        report=report,
        contended=contended,
        contention_aware=contention_aware,
        schedules=schedules,
        lane_split=lane_split,
        lane_info=lane_info,
    )


def schedules_differ(a: MeshRunResult, b: MeshRunResult) -> bool:
    """True when any tenant's swap schedule (transfer start/end times or
    transfer set) differs between two runs — the observable the contention
    acceptance criterion is stated over."""
    if set(a.schedules) != set(b.schedules):
        return True
    for name, sched in a.schedules.items():
        if sched != b.schedules[name]:
            return True
    return False
