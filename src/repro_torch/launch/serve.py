"""Batched serving entry point: prefill a batch of prompts, then greedy decode.

Counterpart of ``repro/launch/serve.py``.  Serves a smoke or full model with
random parameters drawn from ``torch.Generator(device)`` seeded with
``--seed``.  Prompt tokens come from ``numpy.random.default_rng(seed + 1)``:
the reference draws them with ``jax.random``, whose bits PyTorch cannot
reproduce, so the two entry points serve different prompts from the same
seed.  Runs on CUDA unless ``--device cpu`` is given, and raises on a host
without CUDA rather than falling back.  On the card, RMSNorm, prefill
attention and the SSD scan run through the port's Hopper kernels; matrix
products stay in full fp32 for fp32 models (TF32 off).  Each decode step
takes its position as a 0-d tensor on the device, a slice of one
``arange``: the loop reads nothing back to the host.

The paper's memory planner, as in the reference, on the port's card
(``H100_SXM``, where the reference plans for ``TPU_V5E``):

  * ``--plan``        print the SmartPool and AutoSwap@80% reports of the
                      prefill and decode steps (``build_prefill_step``'s and
                      ``build_serve_step``'s computations at this run's
                      shapes), traced on fake tensors: nothing is launched;
  * ``--plan-cache``  directory of solved plan artifacts keyed by (arch, step
                      signature, hardware): a second serving process (a
                      decode worker beside a prefill worker, or the next
                      restart) restores both plans and does not trace;
  * ``--colocate``    co-schedule the two steps as two tenants of one HBM
                      budget in the memory runtime and print its
                      per-tenant overhead and aggregate peak report, with
                      the observability flags (``--trace-out``, ``--slo``,
                      ``--monitor-out``, ``--record-events``) and
                      ``--verify``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
      --batch 4 --prompt-len 512 --gen 32 [--plan] [--plan-cache build/plans]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
      --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --batch 2 --prompt-len 16 --gen 4 --plan-cache /tmp/plans --colocate
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.models import build_model

SIZE_THRESHOLD = 1 << 18  # the reference's: smoke models are far below 1 MiB


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_batch_struct(cfg, B: int, P: int) -> dict:
    """Shape and dtype of one serving batch as meta tensors: the single
    source of truth shared by the planner (fake-tensor trace) and ``main``
    (real tensors).  The ported archs take tokens only."""
    if cfg.frontend is not None or cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}'s serving inputs ({cfg.frontend or 'encoder frames'}) are not yet "
            f"ported: see ROADMAP.md queue A item 10")
    return {"tokens": torch.empty((B, P), dtype=torch.long, device="meta")}


def serve_step_planner(model, arch: str, role: str, B: int, P: int, max_seq: int,
                       smoke: bool, cache=None):
    """The ``MemoryPlanner`` of the ``role`` ("prefill" or "decode") step at
    these shapes under ``H100_SXM``, keyed as the reference keys it: traced
    on fake tensors, or restored from ``cache`` (a ``PlanCache`` or a
    directory) without tracing.  The decode step's cache is
    ``init_program_cache``'s on meta tensors, the shapes prefill fills;
    its position a 0-d int64 tensor."""
    from repro_torch.core.planner import MemoryPlanner
    from repro_torch.core.simulator import H100_SXM
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.transformer import init_program_cache
    from repro_torch.plan import PlanKey

    cfg = model.cfg
    pshapes = model.init_shapes()
    if role == "prefill":
        def fn(params, batch):
            return model.prefill(params, batch, max_seq=max_seq)

        fargs = (pshapes, serve_batch_struct(cfg, B, P))
    elif role == "decode":
        fn = build_serve_step(model, cfg)
        kv = init_program_cache(cfg, cfg.program, B, max_seq, dtype_of(cfg), "meta")
        fargs = (pshapes, kv, torch.empty((B, 1), dtype=torch.long, device="meta"),
                 torch.empty((), dtype=torch.long, device="meta"))
    else:
        raise ValueError(f"unknown serving step {role!r} (prefill|decode)")
    key = PlanKey(arch, f"{role}:b{B}p{P}s{max_seq}{':smoke' if smoke else ''}", H100_SXM.name)
    return MemoryPlanner(fn, *fargs, hw=H100_SXM, cache=cache or None, key=key,
                         size_threshold=SIZE_THRESHOLD)


def plan_serve_steps(model, cfg, args, max_seq: int, plan_cache=None):
    """Solve (or restore) the memory plans for the prefill and decode steps.

    Returns {role: (planner, PoolReport)} for "prefill" and "decode".
    """
    from repro_torch.plan import PlanCache

    if plan_cache is None and args.plan_cache:
        plan_cache = PlanCache(args.plan_cache)
    out = {}
    for role in ("prefill", "decode"):
        planner = serve_step_planner(model, args.arch, role, args.batch, args.prompt_len,
                                     max_seq, args.smoke, plan_cache)
        rep = planner.report()
        src = "restored from cache" if planner.from_cache else "solved"
        print(
            f"[plan] {role}: {src}  vars={rep.num_variables} "
            f"peak={rep.peak_load/2**20:.1f}MiB smartpool x{rep.smartpool_ratio:.4f} "
            f"cnmem x{rep.cnmem_ratio:.4f}"
        )
        # AutoSwap at 80% of peak: the weights and the KV cache dominate a
        # dense model's steps, so little or nothing under the threshold is
        # swappable (the reference's documented behaviour).
        sw = planner.swap_report(int(rep.peak_load * 0.8))
        print(
            f"[plan] {role}: AutoSwap@80%: {sw.num_selected} vars "
            f"({sw.selected_bytes/2**20:.1f}MiB) swappable, "
            f"simulated overhead {sw.overhead*100:.2f}%"
        )
        out[role] = (planner, rep)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--plan", action="store_true",
                    help="print SmartPool/AutoSwap reports for prefill + decode steps")
    ap.add_argument("--plan-cache", default=None,
                    help="directory of solved plan artifacts shared across "
                         "prefill/decode processes (solve once, reload after)")
    ap.add_argument("--colocate", action="store_true",
                    help="co-schedule the prefill and decode steps as two "
                         "tenants of the shared-HBM memory runtime and print "
                         "the per-tenant overhead / aggregate peak report")
    ap.add_argument("--colocate-budget-frac", type=float, default=0.8,
                    help="shared budget as a fraction of summed step peaks")
    ap.add_argument("--channels", type=int, default=2,
                    help="DMA channels for the --colocate runtime")
    from repro_torch.obs import add_obs_args

    add_obs_args(ap)
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to serve on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device)
    B, P = args.batch, args.prompt_len
    max_seq = P + args.gen
    spec = serve_batch_struct(cfg, B, P)

    if args.plan or args.plan_cache or args.colocate:
        from repro_torch.plan import PlanCache

        plan_cache = PlanCache(args.plan_cache) if args.plan_cache else None
        planned = plan_serve_steps(model, cfg, args, max_seq, plan_cache=plan_cache)
        if args.colocate:
            # The serving colocation case: prefill + decode as two tenants of
            # one shared HBM budget, driven by the same solved programs the
            # planner just produced or restored.
            from repro_torch.core.simulator import H100_SXM
            from repro_torch.launch.colocate import print_colocation
            from repro_torch.obs import export_monitor, export_trace, recorder_for
            from repro_torch.runtime import colocate_programs

            programs = {f"{args.arch}:{role}": planner.program
                        for role, (planner, _rep) in planned.items()}
            recorder = recorder_for(args)
            result = colocate_programs(
                programs, H100_SXM,
                budget_frac=args.colocate_budget_frac,
                channels=args.channels,
                size_threshold=SIZE_THRESHOLD,
                cache=plan_cache,
                record_events=args.record_events,
                obs=recorder,
            )
            print_colocation(result)
            export_trace(args, recorder, result.report)
            export_monitor(args, recorder)
            if args.verify:
                from repro_torch.analyze import verify_launch

                verify_launch(args, programs=programs, recorder=recorder,
                              report=result.report)

    params = model.init(torch.Generator(device).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed + 1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, tuple(spec["tokens"].shape)))
    tokens = tokens.to(device)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": tokens}, max_seq=max_seq)
    finite = torch.isfinite(logits).all()
    next_tok = logits[:, -1].argmax(-1, keepdim=True)
    _sync(device)
    print(f"prefill: {B}x{P} in {time.perf_counter() - t0:.4f}s")

    positions = torch.arange(P, P + args.gen, device=device)
    out_tokens = [next_tok]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        logits, cache = model.decode_step(params, cache, next_tok, positions[i])
        finite &= torch.isfinite(logits).all()
        next_tok = logits[:, -1].argmax(-1, keepdim=True)
        out_tokens.append(next_tok)
    _sync(device)
    dt = time.perf_counter() - t0
    if not bool(finite):
        raise FloatingPointError("non-finite logits while serving")
    gen = torch.cat(out_tokens, dim=1).cpu()
    print(f"decode: {args.gen} tokens x {B} seqs in {dt:.4f}s "
          f"({B * (args.gen - 1) / max(dt, 1e-9):.1f} tok/s)")
    print("sample:", gen[0, :12].tolist())
    return gen


if __name__ == "__main__":
    main()
