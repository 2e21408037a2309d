"""Mesh-aware planning launcher: shard a step, solve per-device, execute.

Counterpart of ``repro/launch/shardplan.py``, with its flags, on the
port's card (``H100_SXM``, where the reference plans for ``TPU_V5E``).
The end-to-end ``repro_torch.dist`` pipeline for one architecture's loss
step, the step ``train --plan`` plans (fp32 masters, cast at each use):

  1. **capture** — trace the step once on fake tensors of ``--device``
     (``cuda`` by default; without a card that raises, it never falls back
     to the CPU) and walk the graph twice: unsharded (1x1, the replicated
     baseline) and with the launch/steps.py PartitionSpecs for ``--mesh``
     (sizes divided per shard, the data-parallel gradient all-reduce
     tagged from the sharded param bytes);
  2. **solve** — the repro_torch.plan pipeline once per device group,
     artifacts keyed by mesh topology in ``--plan-cache`` (never colliding
     with single-device plans of the same step);
  3. **execute** — one runtime tenant per device over per-device HBM pools
     with every DMA channel contending on a shared host link, compared
     contended vs contention-free and collective-aware vs blind.

Nothing runs on a device: the capture is on fake tensors and the runtime
a simulation, so a ``data=4`` mesh plans on one host.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.shardplan --arch qwen3-4b --smoke \\
      --device cpu --mesh data=4 --batch 8 --seq 128 --limit-frac 0.6 \\
      [--plan-cache /tmp/plans] [--json shardplan.json]
  PYTHONPATH=src python -m repro_torch.launch.shardplan --arch qwen3-4b \\
      --mesh data=2,model=2 --batch 4 --seq 512
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core.simulator import H100_SXM
from repro_torch.core.trace import capture_graph
from repro_torch.dist import (
    MeshSpec,
    gradient_sync_collective,
    run_mesh,
    schedules_differ,
    solve_sharded,
)
from repro_torch.dist.capture import shard_graph
from repro_torch.launch.steps import batch_specs, param_specs
from repro_torch.launch.train import check_device, frontend_inputs, step_key
from repro_torch.models import build_model
from repro_torch.obs import add_obs_args, export_monitor, export_trace, recorder_for
from repro_torch.plan import PlanCache


class SpecMesh:
    """What the launch/steps.py spec rules read of a mesh (axis_names +
    shape), without devices, which is all planning needs."""

    def __init__(self, mesh: MeshSpec):
        self.axis_names = tuple(n for n, _ in mesh.axes)
        self.shape = dict(mesh.axes)


def probe_from_model(model, batch: int, seq: int):
    """(step_fn, example_args) for an already-built model: its loss step at
    fp32 masters and a batch of ``batch`` x ``seq`` tokens (with the stub
    frontends' inputs), all meta tensors — the step train.py plans."""
    probe = {k: torch.empty(batch, seq, dtype=torch.long, device="meta")
             for k in ("tokens", "labels")}
    probe.update(frontend_inputs(model.cfg, batch, seq, "meta"))
    pshapes = model.init_shapes(torch.float32)

    def step_probe(params, b):
        return model.loss(params, b)[0]

    return step_probe, (pshapes, probe)


def build_probe(arch: str, smoke: bool, batch: int, seq: int, device="cuda"):
    """Standalone probe builder: (cfg, model, step_fn, args)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    model = build_model(cfg, device)
    step_probe, example_args = probe_from_model(model, batch, seq)
    return cfg, model, step_probe, example_args


def capture_for_mesh(cfg, step_probe, example_args, mesh: MeshSpec, hw, graph=None,
                     device=None):
    """Capture ``step_probe`` under the launch/steps.py specs for ``mesh``,
    tagging the data-parallel gradient all-reduce with the per-device
    sharded parameter bytes.  ``graph``, the step's graph already captured
    at ``example_args`` (``core.trace.capture_graph``), is sharded as it
    is; otherwise the step is traced on fake tensors of ``device``."""
    pshapes, probe = example_args
    spec_mesh = SpecMesh(mesh)
    pspecs = param_specs(cfg, pshapes, spec_mesh)
    bspecs = batch_specs(cfg, probe, spec_mesh)
    # Per-device gradient payload: every param shard this device owns is
    # all-reduced across the data axes once per step.
    sync = gradient_sync_collective(pshapes, pspecs, mesh)
    if graph is None:
        graph = capture_graph(step_probe, *example_args, device=device)
    return shard_graph(
        graph, example_args, mesh=mesh, hw=hw, in_specs=(pspecs, bspecs),
        arg_names=["params", "batch"], extra_collectives=[sync] if sync else [],
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-runnable)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="data=4", help='e.g. "data=4" or "data=4,model=2"')
    ap.add_argument("--limit-frac", type=float, default=0.6,
                    help="per-device AutoSwap limit as a fraction of the shard peak")
    ap.add_argument("--budget-frac", type=float, default=0.7,
                    help="per-device HBM budget as a fraction of the shard peak")
    ap.add_argument("--channels", type=int, default=2)
    ap.add_argument("--iterations", type=int, default=2)
    ap.add_argument("--link-lanes", type=int, default=2,
                    help="global host-link DMA lanes shared by all devices")
    ap.add_argument("--link-bw-frac", type=float, default=1.0,
                    help="shared host-link bandwidth as a fraction of one device link")
    ap.add_argument("--lane-split", choices=("static", "directional"),
                    default="static",
                    help="host-link lane policy for the contended run: shared "
                         "pool, or lanes carved between swap directions from a "
                         "probe run's queue-wait split (repro_torch.tune)")
    ap.add_argument("--size-threshold", type=int, default=1 << 18)
    ap.add_argument("--plan-cache", default=None)
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors the step is traced on: cuda (default) "
                         "or cpu")
    add_obs_args(ap)
    args = ap.parse_args(argv)

    check_device(args.device)
    hw = H100_SXM
    mesh = MeshSpec.parse(args.mesh)
    cfg, model, step_probe, example_args = build_probe(
        args.arch, args.smoke, args.batch, args.seq, args.device
    )
    base_key = step_key(args.arch, args.batch, args.seq, args.smoke, hw)
    cache = PlanCache(args.plan_cache) if args.plan_cache else None

    # 1. capture (the single-device capture doubles as the replicated baseline)
    graph = capture_graph(step_probe, *example_args, device=args.device)
    single = capture_for_mesh(cfg, step_probe, example_args, MeshSpec.make(d=1), hw, graph)
    sharded = capture_for_mesh(cfg, step_probe, example_args, mesh, hw, graph)
    single_peak = single.groups["spmd"].trace.peak_load()
    group = sharded.groups["spmd"]
    shard_peak = group.trace.peak_load()
    print(
        f"[dist] mesh {mesh.signature() or '1'}: per-device peak "
        f"{shard_peak / 2**20:.1f}MiB vs replicated {single_peak / 2**20:.1f}MiB "
        f"(x{shard_peak / single_peak:.3f}), {len(group.collectives)} collectives "
        f"({sum(c.seconds for c in group.collectives) * 1e3:.3f} ms/iter)"
    )

    # 2. per-device solve (once per group, fanned out to every device)
    solved = solve_sharded(
        sharded, hw, base_key=base_key, cache=cache,
        limit_frac=args.limit_frac, size_threshold=args.size_threshold,
    )
    for g, program in solved.programs.items():
        src = " (cache)" if solved.cache_hits[g] else ""
        print(
            f"[dist] group {g}: key {program.key.cache_name() if program.key else '-'} "
            f"solved in {solved.solve_ms[g]:.1f} ms{src}"
        )

    # 3. mesh-wide execution: shared-link contention on/off
    budget = int(shard_peak * args.budget_frac)
    kw = dict(
        budget_per_device=budget, channels=args.channels,
        iterations=args.iterations,
        link_bw=hw.link_bw * args.link_bw_frac, link_lanes=args.link_lanes,
        record_events=args.record_events,
    )
    uncontended = run_mesh(solved, hw, contended=False,
                           budget_per_device=budget, channels=args.channels,
                           iterations=args.iterations,
                           record_events=args.record_events)
    # The trace observes the headline cell: contended + contention-aware.
    recorder = recorder_for(args)
    contended = run_mesh(solved, hw, contended=True, contention_aware=True,
                         obs=recorder, lane_split=args.lane_split, **kw)
    blind = run_mesh(solved, hw, contended=True, contention_aware=False, **kw)
    export_trace(args, recorder, contended.report)
    export_monitor(args, recorder)
    if args.verify:
        from repro_torch.analyze import verify_launch

        verify_launch(args, programs=solved.programs, recorder=recorder,
                      report=contended.report)
    if contended.lane_info is not None:
        info = contended.lane_info
        carve = (
            f"{info['out_lanes']} out / {info['lanes'] - info['out_lanes']} in"
            if info["out_lanes"] is not None else "no carve (no evidence)"
        )
        print(
            f"[tune] directional lanes: probe waited "
            f"in {info['probe_wait_in_s']*1e3:.3f}ms / "
            f"out {info['probe_wait_out_s']*1e3:.3f}ms -> {carve}"
        )
    print(
        f"[dist] mean overhead: uncontended {uncontended.mean_overhead()*100:.2f}% | "
        f"shared link {contended.mean_overhead()*100:.2f}% "
        f"(collective-blind {blind.mean_overhead()*100:.2f}%)"
    )
    print(
        f"[dist] contention changes schedules: {schedules_differ(uncontended, contended)}; "
        f"link moved {contended.report.link['bytes_moved']/2**20:.1f}MiB over "
        f"{contended.report.link['lanes']} lanes, "
        f"blackout {contended.report.link['blackout_s']*1e3:.3f} ms"
    )

    if args.json:
        payload = {
            "arch": args.arch,
            "mesh": dict(mesh.axes),
            "topology": sharded.plan_topology(),
            "single_device_peak": single_peak,
            "per_device_peak": shard_peak,
            "collectives": [c.__dict__ for c in group.collectives],
            "budget_per_device": budget,
            "uncontended": uncontended.report.as_dict(),
            "contended": contended.report.as_dict(),
            "contention_blind": blind.report.as_dict(),
            "schedules_changed_by_contention": schedules_differ(uncontended, contended),
            "lane_split": contended.lane_split,
            **({"lane_info": contended.lane_info}
               if contended.lane_info is not None else {}),
        }
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        print(f"[dist] wrote {args.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
