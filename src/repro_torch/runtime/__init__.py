"""repro_torch.runtime: the execution layer on top of the repro_torch.plan IR.

Counterpart of ``repro/runtime``:

  engine   — ChannelPool (K DMA channels), PoolAccountant (shared budget),
             HostLink (shared host-interconnect bandwidth pool with
             collective blackouts), Tenant, MemoryRuntime (N-tenant
             event-driven co-scheduler with arrival churn, preemptive floor
             renegotiation and per-device pools for mesh execution),
             simulate_program (the paper's simulator as a 1-tenant run)
  workload — seeded Poisson / trace-driven workload generation for churn
             experiments, and a synthetic forward/backward training trace
  tenants  — tenant_from_program / colocate_programs: plan-pipeline +
             PlanCache warm-start into the runtime; pipeline_replanner is
             the online re-solve hook renegotiation uses

``core.simulator.simulate_swap_schedule`` is a thin 1-tenant/2-channel call
into this engine; ``python -m repro_torch.launch.colocate`` drives it from
the command line.
"""

from .engine import (
    ChannelPool,
    FloorGreedyVictim,
    HostLink,
    MemoryRuntime,
    PoolAccountant,
    RuntimeReport,
    Tenant,
    TenantReport,
    VictimPolicy,
    planned_peak,
    simulate_program,
    simulated_report_dict,
)
from .tenants import (
    ColocationResult,
    colocate_programs,
    pipeline_replanner,
    proportional_shares,
    tenant_from_program,
)
from .workload import WorkloadItem, parse_arrivals, poisson_workload, synthetic_train_trace

__all__ = [
    "ChannelPool",
    "FloorGreedyVictim",
    "HostLink",
    "VictimPolicy",
    "MemoryRuntime",
    "PoolAccountant",
    "RuntimeReport",
    "Tenant",
    "TenantReport",
    "planned_peak",
    "simulate_program",
    "simulated_report_dict",
    "ColocationResult",
    "colocate_programs",
    "pipeline_replanner",
    "proportional_shares",
    "tenant_from_program",
    "WorkloadItem",
    "parse_arrivals",
    "poisson_workload",
    "synthetic_train_trace",
]
