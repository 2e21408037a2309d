"""Plan artifacts: JSON persistence of solved MemoryPrograms.

Counterpart of ``repro/plan/artifact.py``, whose code this is, with
its imports pointed into ``repro_torch``; ``tests/test_torch_plan.py``
holds the two equal.

The one-time solve (SmartPool placement, AutoSwap schedules, offload
lowering) is serialized keyed by (arch, step signature, hardware) so a
second process — the next training run, or the decode server next to the
prefill server — reloads the solution instead of re-tracing and re-solving.

Serialization is *canonical* (sorted keys, fixed separators) so equality of
plans is equality of bytes; tests round-trip on that property.  Writes are
atomic (tmp file + rename) so concurrent processes sharing one cache
directory never observe a torn artifact.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path

from ..core.baseline_pools import PoolStats
from ..core.events import IterationTrace, VariableInfo
from ..core.offload import OffloadPlan
from ..core.simulator import SwapDecision
from ..core.smartpool import AllocationPlan
from .program import MemoryProgram, PlanKey, SwapSummary

PLAN_FORMAT_VERSION = 1


# ------------------------------------------------------------- to JSON dicts
def _trace_to_json(trace: IterationTrace) -> dict:
    return {
        "num_indices": trace.num_indices,
        "variables": [
            [
                v.var,
                v.size,
                v.alloc_index,
                v.free_index,
                list(v.accesses),
                [1 if w else 0 for w in v.access_is_write],
                v.name,
            ]
            for v in trace.variables
        ],
        "op_times": trace.op_times,
        "op_costs": (
            {str(i): [f, b] for i, (f, b) in sorted(trace.op_costs.items())}
            if trace.op_costs is not None
            else None
        ),
    }


def _trace_from_json(d: dict) -> IterationTrace:
    variables = [
        VariableInfo(
            var=var,
            size=size,
            alloc_index=alloc,
            free_index=free,
            accesses=list(acc),
            access_is_write=[bool(w) for w in wr],
            name=name,
        )
        for var, size, alloc, free, acc, wr, name in d["variables"]
    ]
    trace = IterationTrace(variables, d["num_indices"])
    trace.op_times = d["op_times"]
    if d["op_costs"] is not None:
        trace.op_costs = {int(i): (fb[0], fb[1]) for i, fb in d["op_costs"].items()}
    return trace


def _alloc_plan_to_json(p: AllocationPlan) -> dict:
    return {
        "offsets": {str(k): v for k, v in p.offsets.items()},
        "footprint": p.footprint,
        "peak_load": p.peak_load,
        "method": p.method,
        "lookup": {str(k): v for k, v in p.lookup.items()},
    }


def _alloc_plan_from_json(d: dict) -> AllocationPlan:
    return AllocationPlan(
        offsets={int(k): v for k, v in d["offsets"].items()},
        footprint=d["footprint"],
        peak_load=d["peak_load"],
        method=d["method"],
        lookup={int(k): v for k, v in d["lookup"].items()},
    )


def _summary_to_json(s: SwapSummary) -> dict:
    return {
        "scorer": s.scorer,
        "limit": s.limit,
        "decisions": [
            [d.var, d.size, d.out_after, d.in_before, 1 if d.wraps else 0]
            for d in s.decisions
        ],
        "peak_load": s.peak_load,
        "load_min": s.load_min,
        "overhead": s.overhead,
        "stalls": s.stalls,
        "per_name_bytes": dict(sorted(s.per_name_bytes.items())),
        "size_threshold": s.size_threshold,
        "hardware": s.hardware,
        "planned_floor": s.planned_floor,
    }


def _summary_from_json(d: dict) -> SwapSummary:
    return SwapSummary(
        scorer=d["scorer"],
        limit=d["limit"],
        decisions=[
            SwapDecision(var, size, out_after, in_before, bool(wraps))
            for var, size, out_after, in_before, wraps in d["decisions"]
        ],
        peak_load=d["peak_load"],
        load_min=d["load_min"],
        overhead=d["overhead"],
        stalls=d["stalls"],
        per_name_bytes=dict(d["per_name_bytes"]),
        size_threshold=d["size_threshold"],
        hardware=d["hardware"],
        planned_floor=d.get("planned_floor"),
    )


def _offload_to_json(p: OffloadPlan) -> dict:
    return {
        "offload_names": list(p.offload_names),
        "save_names": list(p.save_names),
        "predicted_savings": p.predicted_savings,
        "transfer_bytes": p.transfer_bytes,
    }


def _offload_from_json(d: dict) -> OffloadPlan:
    plan = OffloadPlan(
        offload_names=list(d["offload_names"]), save_names=list(d["save_names"])
    )
    plan.predicted_savings = d["predicted_savings"]
    plan.transfer_bytes = d["transfer_bytes"]
    return plan


def program_to_json(program: MemoryProgram) -> dict:
    trace = program.require_trace()
    payload = {
        "version": PLAN_FORMAT_VERSION,
        "key": (
            {
                "arch": program.key.arch,
                "step_signature": program.key.step_signature,
                "hardware": program.key.hardware,
                "topology": program.key.topology,
            }
            if program.key
            else None
        ),
        "trace": _trace_to_json(trace),
        "pool_plans": {m: _alloc_plan_to_json(p) for m, p in sorted(program.pool_plans.items())},
        "baselines": {
            m: {"footprint": s.footprint, "peak_load": s.peak_load, "num_mallocs": s.num_mallocs}
            for m, s in sorted(program.baselines.items())
        },
        "swap_summaries": {k: _summary_to_json(s) for k, s in sorted(program.swap_summaries.items())},
        "offload_plans": {k: _offload_to_json(p) for k, p in sorted(program.offload_plans.items())},
        # Solve-time provenance (ms per solved stage).  Stored for
        # observability; dumps_canonical() strips it, because wall-time is
        # process state, not plan identity.
        "solve_ms": {k: round(v, 3) for k, v in sorted(program.solve_ms.items())},
    }
    # Verification provenance (repro.analyze certificate).  Like solve_ms,
    # stripped from the canonical bytes: a certificate describes the plan,
    # it is not part of the plan.
    if program.certificate is not None:
        payload["certificate"] = program.certificate
    return payload


def program_from_json(d: dict) -> MemoryProgram:
    if d.get("version") != PLAN_FORMAT_VERSION:
        raise ValueError(f"unsupported plan artifact version {d.get('version')!r}")
    key = PlanKey(**d["key"]) if d.get("key") else None
    program = MemoryProgram(trace=_trace_from_json(d["trace"]), key=key)
    program.pool_plans = {m: _alloc_plan_from_json(p) for m, p in d["pool_plans"].items()}
    program.baselines = {
        m: PoolStats(s["footprint"], s["peak_load"], s["num_mallocs"])
        for m, s in d["baselines"].items()
    }
    program.swap_summaries = {k: _summary_from_json(s) for k, s in d["swap_summaries"].items()}
    program.offload_plans = {k: _offload_from_json(p) for k, p in d["offload_plans"].items()}
    program.solve_ms = {k: float(v) for k, v in d.get("solve_ms", {}).items()}
    program.certificate = d.get("certificate")
    return program


def dumps_canonical(program: MemoryProgram) -> str:
    """Canonical byte form: plans are equal iff their dumps are equal.

    Solve-time provenance is excluded — two byte-equal plans may have been
    solved at different speeds."""
    payload = program_to_json(program)
    payload.pop("solve_ms", None)
    payload.pop("certificate", None)
    return json.dumps(payload, sort_keys=True, separators=(",", ":"))


class PlanCache:
    """Directory of solved-plan artifacts, one JSON file per PlanKey.

    ``max_bytes`` bounds the cache for long-lived serving fleets with many
    tenant models: after each store, least-recently-used artifacts (by file
    mtime — a hit touches the file) are evicted until the directory fits.
    A schema-version mismatch is an expected upgrade-path event and degrades
    to a silent cache miss (the caller re-solves and overwrites); corrupt
    artifacts additionally warn.  Every load re-derives the static
    verification certificate (``repro.analyze``) over the restored plan —
    an artifact whose invariants no longer prove out (bit-rot, hand edits,
    a stale solver bug) is demoted to a miss and counted in
    ``certificate_misses`` rather than admitted to the runtime.
    """

    def __init__(self, root: "str | Path", max_bytes: int | None = None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.max_bytes = max_bytes
        self.version_misses = 0
        self.certificate_misses = 0

    def path_for(self, key: PlanKey) -> Path:
        return self.root / f"{key.cache_name()}.json"

    def load(self, key: PlanKey) -> MemoryProgram | None:
        path = self.path_for(key)
        if not path.exists():
            return None
        try:
            with path.open() as f:
                payload = json.load(f)
            if not isinstance(payload, dict):
                raise ValueError("artifact is not a JSON object")  # corrupt: warn below
            if payload.get("version") != PLAN_FORMAT_VERSION:
                # Artifact written by an older/newer schema: a plain miss.
                self.version_misses += 1
                return None
            program = program_from_json(payload)
        except (OSError, json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
            # A corrupt/stale artifact is a cache miss, not a crash: the
            # caller re-solves and overwrites it.
            import warnings

            warnings.warn(f"ignoring unreadable plan artifact {path}: {e}")
            return None
        program.key = key
        program.from_cache = True
        # Re-prove the invariants on the restored bytes; never trust the
        # stored verdict.  A failing plan is a miss — the caller re-solves.
        from ..analyze.plan_check import verify_program

        cert = verify_program(program)
        if not cert.ok:
            self.certificate_misses += 1
            import warnings

            warnings.warn(
                f"plan artifact {path} failed re-verification "
                f"({', '.join(cert.failed())}); treating as a cache miss"
            )
            return None
        program.certificate = cert.to_dict()
        # LRU touch: a hit keeps the artifact at the back of the evict queue.
        try:
            os.utime(path)
        except OSError:
            pass
        return program

    def store(self, program: MemoryProgram) -> Path:
        if program.key is None:
            raise ValueError("cannot store a MemoryProgram without a PlanKey")
        path = self.path_for(program.key)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            # mkstemp creates 0600; artifacts are shared between processes
            # (prefill/decode workers may run as different users).
            os.fchmod(fd, 0o644)
            with os.fdopen(fd, "w") as f:
                # Full payload (canonical plan + solve-time provenance).
                f.write(
                    json.dumps(
                        program_to_json(program), sort_keys=True, separators=(",", ":")
                    )
                )
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        self._evict(keep=path)
        return path

    def _evict(self, keep: Path | None = None) -> list[Path]:
        """Drop least-recently-used artifacts until the directory fits
        ``max_bytes``.  The just-written artifact is never evicted, so one
        oversized plan degrades to a one-entry cache rather than none."""
        if self.max_bytes is None:
            return []
        entries = []
        for p in self.root.glob("*.json"):
            try:
                st = p.stat()
            except OSError:
                continue
            entries.append((st.st_mtime, st.st_size, p))
        total = sum(size for _, size, _ in entries)
        evicted: list[Path] = []
        for _, size, p in sorted(entries):
            if total <= self.max_bytes:
                break
            if keep is not None and p == keep:
                continue
            try:
                p.unlink()
            except OSError:
                continue
            total -= size
            evicted.append(p)
        return evicted

    def total_bytes(self) -> int:
        return sum(p.stat().st_size for p in self.root.glob("*.json"))

    def keys(self) -> list[str]:
        return sorted(p.stem for p in self.root.glob("*.json"))
