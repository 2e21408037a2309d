"""Per-device plan solving over a sharded capture.

Counterpart of ``repro/dist/program.py``, whose code this is, with its
imports pointed into ``repro_torch``; ``tests/test_torch_dist.py`` holds
the two equal.

``ShardedProgram`` runs the existing ``repro_torch.plan`` pipeline once per
*device group* — SPMD shards are identical, so the solve happens once and
fans out to every device in the group — and keys each group's artifact with
the mesh topology (``PlanKey.topology``), so cached per-shard plans never
collide with single-device plans of the same step (or with other meshes /
other PartitionSpec layouts of the same mesh).

On a 1x1 mesh the topology is empty and the single group's program is
byte-identical (``plan.artifact.dumps_canonical``) to what the single-device
pipeline produces for the same step — the dist layer degrades to exactly the
existing path.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..core.simulator import HardwareSpec
from ..plan.artifact import PlanCache
from ..plan.passes import (
    ArtifactSave,
    PassContext,
    Pipeline,
    PoolPlacement,
    SwapSelection,
    TimingAssign,
)
from ..plan.program import MemoryProgram, PlanKey, swap_key
from .capture import ShardedCapture


def group_key(base: PlanKey | None, capture: ShardedCapture, group: str) -> PlanKey | None:
    """PlanKey for one device group: the base key + mesh/spec topology.

    The group name rides in the topology (not the signature) so the solved
    artifact stays addressable from the step identity alone; the single
    SPMD group keeps the bare topology so 1-group captures need no suffix.
    """
    if base is None:
        return None
    topology = capture.plan_topology()
    if topology and group != "spmd":
        topology = f"{topology}/{group}"
    return PlanKey(base.arch, base.step_signature, base.hardware, topology)


@dataclass
class ShardedProgram:
    """Per-group solved programs over one sharded capture."""

    capture: ShardedCapture
    programs: dict[str, MemoryProgram] = field(default_factory=dict)
    solve_ms: dict[str, float] = field(default_factory=dict)
    cache_hits: dict[str, bool] = field(default_factory=dict)
    # Group -> (swap_summaries key, limit) of the schedule solve_sharded
    # solved, so execution picks the right one off a cache-restored program
    # that may hold summaries at several limits.
    swap_keys: dict[str, tuple[str, int]] = field(default_factory=dict)

    def program_for_device(self, device: int) -> MemoryProgram:
        return self.programs[self.capture.device_group[device]]

    def per_device_peak(self) -> dict[str, int]:
        return {g: p.require_trace().peak_load() for g, p in self.programs.items()}


def solve_sharded(
    capture: ShardedCapture,
    hw: HardwareSpec,
    base_key: PlanKey | None = None,
    cache: PlanCache | None = None,
    methods=("best_fit",),
    limit: int | None = None,
    limit_frac: float | None = None,
    scorer: str = "swdoa",
    size_threshold: int = 1 << 20,
    log=None,
) -> ShardedProgram:
    """Solve every distinct device group of ``capture`` through the plan
    pipeline (placement always; a swap schedule when ``limit`` or
    ``limit_frac`` is given), restoring from / persisting to ``cache`` under
    topology-extended keys.

    Identical groups solve once: the pipeline runs per *group*, and every
    device of the group shares the solved ``MemoryProgram``.
    """
    solved = ShardedProgram(capture=capture)
    for name, sharded in capture.groups.items():
        key = group_key(base_key, capture, name)
        ctx = PassContext(hw=hw, cache=cache, key=key,
                         size_threshold=size_threshold, log=log)
        program = None
        if cache is not None and key is not None:
            program = cache.load(key)
        if program is None:
            program = MemoryProgram.from_trace(sharded.trace, key)
            program.dirty = True
        passes = [TimingAssign(), PoolPlacement(methods=methods)]
        group_limit = limit
        if group_limit is None and limit_frac is not None:
            group_limit = int(sharded.trace.peak_load() * limit_frac)
        if group_limit is not None:
            passes.append(SwapSelection(limit=group_limit, scorer=scorer))
            solved.swap_keys[name] = (swap_key(scorer, group_limit), group_limit)
        if cache is not None and key is not None:
            passes.append(ArtifactSave())
        t0 = time.perf_counter()
        program = Pipeline(passes).run(program, ctx)
        solved.solve_ms[name] = (time.perf_counter() - t0) * 1e3
        solved.cache_hits[name] = program.from_cache
        solved.programs[name] = program
    return solved


def solved_decisions(solved: ShardedProgram, group: str):
    """The (limit, decisions) solve_sharded produced for ``group``, or
    (None, []) when only placement was solved."""
    entry = solved.swap_keys.get(group)
    if entry is None:
        return None, []
    k, limit = entry
    summary = solved.programs[group].swap_summaries[k]
    return limit, list(summary.decisions)
