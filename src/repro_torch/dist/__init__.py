"""repro_torch.dist: mesh-aware trace capture, per-device planning, execution.

Counterpart of ``repro/dist``, with the same public surface.

  capture  — MeshSpec (mesh shape as data), sharded graph walking (sizes
             divided by PartitionSpec-derived shard divisors), collective
             tagging with interconnect cost-model durations; ``shard_graph``
             shards a graph already captured
  program  — ShardedProgram: the repro_torch.plan Pipeline once per device
             group (identical SPMD shards solve once and fan out), artifacts
             keyed by mesh topology so per-shard plans never collide with
             single-device plans in one PlanCache
  execute  — run_mesh: one runtime tenant per device, per-device HBM pools,
             all DMA channels contending on a shared HostLink with
             collective blackouts

Driven by ``python -m repro_torch.launch.shardplan`` (and
``launch/train.py --dist-plan``); on the card by ``chip_smoke.py``'s
phase 22.
"""

from .capture import (
    COLLECTIVE_PRIMS,
    Collective,
    MeshSpec,
    ShardedCapture,
    ShardedTrace,
    capture_sharded_trace,
    collective_seconds,
    divisors_from_specs,
    gradient_sync_collective,
    shard_divisor,
    shard_existing_trace,
    sharded_param_bytes,
)
from .execute import MeshRunResult, mesh_tenants, run_mesh, schedules_differ
from .program import ShardedProgram, group_key, solve_sharded, solved_decisions

__all__ = [
    "COLLECTIVE_PRIMS",
    "Collective",
    "MeshSpec",
    "ShardedCapture",
    "ShardedTrace",
    "capture_sharded_trace",
    "collective_seconds",
    "divisors_from_specs",
    "gradient_sync_collective",
    "shard_divisor",
    "shard_existing_trace",
    "sharded_param_bytes",
    "MeshRunResult",
    "mesh_tenants",
    "run_mesh",
    "schedules_differ",
    "ShardedProgram",
    "group_key",
    "solve_sharded",
    "solved_decisions",
]
