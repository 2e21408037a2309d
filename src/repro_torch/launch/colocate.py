"""Multi-tenant colocation launcher: N workloads, one device, one HBM budget.

Counterpart of ``repro/launch/colocate.py``, on the port's card
(``H100_SXM``, where the reference plans for ``TPU_V5E``).  Admits several
tenant steps — e.g. a prefill worker, a decode worker and a training job —
to the ``repro_torch.runtime`` memory runtime: each tenant's plan is solved
(or restored from ``--plan-cache``) through the ``repro_torch.plan``
pipeline, given a proportional share of the shared budget as its AutoSwap
limit, and the tenants are co-scheduled over ``--channels`` DMA channels.
Each step is traced on fake tensors and the runtime is a simulation, so
nothing runs on a device and there is no ``--device``.

Tenant specs are ``role`` or ``arch:role`` with roles ``train``, ``prefill``
and ``decode``, optionally suffixed ``@PRIORITY`` (SLO weight; renegotiation
victims are picked lowest-priority first).  Each tenant's planner is its
launcher's own (``train.step_planner``, ``serve.serve_step_planner``), so
plan-cache keys match the train/serve launchers exactly: a plan solved by
``python -m repro_torch.launch.serve --plan-cache DIR`` or
``python -m repro_torch.launch.train --plan-cache DIR`` warm-starts
colocation in this process and vice versa.  Every tenant plans at the
reference's ``SIZE_THRESHOLD`` (``serve.SIZE_THRESHOLD``), the train tenant
included (the train launcher plans at the default 1 MiB), as the reference
does.

Churn: ``--arrivals`` staggers tenant entry ("0,0.002,0.005" positional, or
"poisson:rate=500,seed=0"), ``--iterations`` runs each tenant N steps, and
``--renegotiate`` lets the runtime shrink a running victim's plan (online
SwapSelection re-solve) instead of only queueing a newcomer that doesn't fit.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.colocate --arch qwen3-4b --smoke \\
      --tenants prefill,decode@2.0 --budget-frac 0.8 --channels 2 \\
      [--arrivals poisson:rate=500] [--renegotiate] [--iterations 4] \\
      [--plan-cache /tmp/plans] [--json colocate.json]
"""

from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core.planner import MemoryPlanner
from repro_torch.core.simulator import H100_SXM
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.obs import add_obs_args, export_monitor, export_trace, recorder_for
from repro_torch.plan import PlanCache
from repro_torch.runtime import ColocationResult, colocate_programs


def _parse_tenants(spec: str, default_arch: str) -> list[tuple[str, str, float]]:
    """``role`` | ``arch:role``, optional ``@PRIORITY`` suffix per tenant."""
    out = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        item, _, prio = item.partition("@")
        try:
            priority = float(prio) if prio else 1.0
        except ValueError:
            raise SystemExit(f"bad tenant priority {prio!r} in {item!r}")
        arch, _, role = item.rpartition(":")
        out.append((arch or default_arch, role, priority))
    if not out:
        raise SystemExit("--tenants needs at least one role")
    for arch, role, _ in out:
        if role not in ("train", "prefill", "decode"):
            raise SystemExit(f"unknown tenant role {role!r} (train|prefill|decode)")
    return out


def build_tenant_program(arch: str, role: str, args, cache: PlanCache | None) -> MemoryPlanner:
    """Trace/restore one tenant step as a MemoryProgram behind a planner.

    Step signatures are byte-identical to the train/serve launchers so all
    three share one artifact per (arch, step, hardware): each role's
    planner is its launcher's.  The model lives on the meta device: its
    parameters are shapes, and nothing is launched.
    """
    from repro_torch.launch.train import step_planner

    cfg = get_smoke_config(arch) if args.smoke else get_config(arch)
    model = build_model(cfg, "meta")
    if role == "train":
        return step_planner(model, arch, args.batch, args.seq, args.smoke, cache,
                            size_threshold=serve.SIZE_THRESHOLD)
    B, P = args.batch, args.prompt_len
    return serve.serve_step_planner(model, arch, role, B, P, P + args.gen, args.smoke, cache)


def print_colocation(result: ColocationResult) -> None:
    rep = result.report
    print(
        f"[runtime] budget {result.budget/2**20:.1f}MiB over {rep.channels} DMA "
        f"channels on {rep.hardware} ({rep.policy}); "
        f"makespan {rep.makespan_s*1000:.2f}ms"
    )
    for t in rep.tenants:
        if t.status != "completed":
            print(f"[runtime]   {t.name}: {t.status} (floor {t.floor/2**20:.1f}MiB)")
            continue
        iso = result.isolated.get(t.name)
        iso_oh = f" (isolated {iso.overhead*100:.2f}%)" if iso else ""
        solve = result.plan_solve_ms.get(t.name)
        solve_s = f"  plan solve {solve:.1f}ms" if solve is not None else ""
        arr = f"  arrived {t.arrival_t*1000:.2f}ms" if t.arrival_t else ""
        reneg = (
            f"  renegotiated x{t.renegotiations} "
            f"(-{t.renegotiation_freed_bytes/2**20:.1f}MiB, "
            f"re-solve {t.renegotiation_solve_ms:.1f}ms)"
            if t.renegotiations else ""
        )
        print(
            f"[runtime]   {t.name}: overhead {t.overhead*100:.2f}%{iso_oh}  "
            f"peak {t.peak_resident/2**20:.1f}MiB  stalls {t.stalls}  "
            f"delayed mallocs {t.delayed_mallocs}  "
            f"queue wait {t.queue_wait_s*1000:.2f}ms{arr}{solve_s}{reneg}"
        )
    print(
        f"[runtime] aggregate peak {rep.aggregate_peak/2**20:.1f}MiB vs "
        f"{result.sum_natural_peaks/2**20:.1f}MiB summed isolated provisioning "
        f"(sharing gain {result.sharing_gain*100:.1f}%); "
        f"over-budget events {rep.overflow_events}"
    )
    if rep.renegotiations or rep.renegotiations_cancelled:
        print(
            f"[runtime] renegotiations: {rep.renegotiations} applied "
            f"({rep.renegotiation_freed_bytes/2**20:.1f}MiB freed, "
            f"{rep.renegotiation_solve_ms:.1f}ms re-solve), "
            f"{rep.renegotiations_cancelled} cancelled"
        )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--tenants", default="prefill,decode",
                    help="comma list of role or arch:role (train|prefill|decode)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128, help="train tenant sequence length")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--channels", type=int, default=2, help="DMA channels shared by all tenants")
    ap.add_argument("--budget-frac", type=float, default=0.8,
                    help="shared HBM budget as a fraction of summed tenant peaks")
    ap.add_argument("--budget-gb", type=float, default=None,
                    help="absolute shared HBM budget (overrides --budget-frac)")
    ap.add_argument("--scorer", default="swdoa")
    ap.add_argument("--iterations", type=int, default=1,
                    help="iterations each tenant runs (renegotiation applies at barriers)")
    ap.add_argument("--arrivals", default=None,
                    help='tenant arrival times: "0,0.002,0.005" (positional) '
                         'or "poisson:rate=500[,seed=0][,start=0]"')
    ap.add_argument("--renegotiate", action="store_true",
                    help="shrink a running victim's plan (online re-solve at its next "
                         "iteration barrier) instead of only queueing a newcomer")
    ap.add_argument("--budget-split", choices=("proportional", "tuned"),
                    default="proportional",
                    help="how the shared budget splits across tenants: "
                         "proportional to isolated peaks, or coordinate-descent "
                         "tuned to equalize SLO-weighted marginal stall "
                         "(repro_torch.tune)")
    ap.add_argument("--victim-policy", choices=("greedy", "ledger"),
                    default="greedy",
                    help="renegotiation victim selection: floor-greedy (the "
                         "reference default) or ledger-driven (probe candidate "
                         "(victim, limit) pairs by simulated marginal "
                         "SLO-weighted stall)")
    ap.add_argument("--plan-cache", default=None,
                    help="plan artifact directory shared with the train/serve launchers")
    ap.add_argument("--cache-max-mb", type=float, default=None,
                    help="LRU size bound for --plan-cache")
    ap.add_argument("--json", default=None, help="write the machine-readable report here")
    add_obs_args(ap)
    args = ap.parse_args(argv)

    cache = None
    if args.plan_cache:
        max_bytes = int(args.cache_max_mb * 2**20) if args.cache_max_mb else None
        cache = PlanCache(args.plan_cache, max_bytes=max_bytes)

    programs = {}
    priorities: dict[str, float] = {}
    planners: dict[tuple[str, str], MemoryPlanner] = {}
    for arch, role, priority in _parse_tenants(args.tenants, args.arch):
        # Duplicate specs are distinct tenants (two decode workers on one
        # device) sharing one solved program — trace once, admit N times.
        if (arch, role) not in planners:
            planners[(arch, role)] = build_tenant_program(arch, role, args, cache)
        planner = planners[(arch, role)]
        name = f"{arch}:{role}"
        k = 0
        while name in programs:
            k += 1
            name = f"{arch}:{role}#{k}"
        src = "restored from cache" if planner.from_cache else "solved"
        print(f"[plan] {name}: {src}  peak={planner.trace.peak_load()/2**20:.1f}MiB")
        programs[name] = planner.program
        priorities[name] = priority

    arrivals = None
    if args.arrivals:
        from repro_torch.runtime.workload import parse_arrivals

        times = parse_arrivals(args.arrivals, len(programs))
        arrivals = dict(zip(programs, times))
        for n, t in arrivals.items():
            print(f"[churn] {n}: arrives at {t*1000:.2f}ms")

    victim_policy = None
    if args.victim_policy == "ledger":
        from repro_torch.tune import LedgerVictimPolicy

        victim_policy = LedgerVictimPolicy()

    recorder = recorder_for(args)
    result = colocate_programs(
        programs, H100_SXM,
        budget_frac=args.budget_frac,
        budget=int(args.budget_gb * 2**30) if args.budget_gb else None,
        channels=args.channels,
        scorer=args.scorer,
        size_threshold=serve.SIZE_THRESHOLD,
        cache=cache,
        iterations=args.iterations,
        arrivals=arrivals,
        priorities=priorities,
        renegotiate=args.renegotiate,
        record_events=args.record_events,
        obs=recorder,
        budget_split=args.budget_split,
        victim_policy=victim_policy,
    )
    print_colocation(result)
    if result.split_tuning is not None:
        st = result.split_tuning
        print(
            f"[tune] budget split tuned: SLO-weighted stall "
            f"{st['initial_stall_s']*1000:.2f}ms -> {st['tuned_stall_s']*1000:.2f}ms "
            f"({st['evals']} trial colocations, {len(st['moves'])} moves kept)"
        )
    if victim_policy is not None and victim_policy.staged:
        for d in victim_policy.decision_log:
            print(
                f"[tune] victim {d['victim']} @ {d['t']*1000:.2f}ms: "
                f"{d['candidates']} candidates probed, staged limit "
                f"{d['new_limit']/2**20:.1f}MiB, binding constraint "
                f"{d['binding_constraint']}"
            )
    export_trace(args, recorder, result.report)
    export_monitor(args, recorder)
    if args.verify:
        from repro_torch.analyze import verify_launch

        verify_launch(args, programs=programs, recorder=recorder,
                      report=result.report)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result.as_dict(), f, indent=2, sort_keys=True)
        print(f"[runtime] wrote {args.json}")
    return result


if __name__ == "__main__":
    main()
