"""Training driver (counterpart of ``repro/launch/train.py:main``).

Builds the model from ``--arch`` (full, or ``--smoke`` reduced), draws
random fp32 master parameters from ``torch.Generator(device)`` seeded with
``--seed``, and trains with AdamW on the synthetic token pipeline
(``repro_torch.data``, batches equal to the reference's for the same seed),
per-layer remat and the chunked cross-entropy.  Computation runs in
``cfg.dtype`` (bf16 for the full configs): each use casts the masters, as
the reference's ``.astype`` does.  Runs on CUDA unless ``--device cpu`` is
given, and raises on a host without CUDA rather than falling back.  On the
card, RMSNorm and attention run through the port's Hopper kernels forward
and backward; matrix products stay in full fp32 for fp32 models (TF32 off).

Kept from the reference: the per-step and ``done:`` lines, the injected
failure (``--fail-at``), the straggler watchdog (``--step-timeout``) and
the paper's memory planner:

  * ``--plan``         print the SmartPool report of the step the reference
                       plans, ``model.loss(params, batch)[0]``, traced on
                       fake tensors at the params ``main`` trains (fp32
                       masters, cast to ``cfg.dtype`` at each use) under
                       ``H100_SXM``;
  * ``--plan-cache``   directory of solved plan artifacts, keyed by (arch,
                       step signature, hardware): a second run restores the
                       plan, and the offload plan below, and does not trace;
  * ``--hbm-limit-gb`` AutoSwap's budget, in GiB, for that traced loss step,
                       as in the reference: ``offload_plan`` and
                       ``swap_report`` at it, the ``[plan] AutoSwap@...``
                       line, and the step built with the plan's policy
                       (``OffloadPlan.policy()``), which copies the named
                       activations of each layer to pinned host memory
                       after its forward and back before its backward.  The
                       limit is not the card's: the traced loss frees each
                       master at its last use, so its peak load is 15.0 GiB
                       for qwen3-4b at B4 S512, where the real step peaks at
                       67.95 GB with masters, gradients and AdamW's moments
                       resident.  At that shape, labels are named only at
                       about half of it or less (about 7.5 GiB); above, the
                       selection is masters, which no label covers, and the
                       step runs as plain remat.  The simulated overhead
                       prices AutoSwap's per-variable selection, masters
                       included; only the label classes execute.  Each
                       step's bytes moved each way are printed.

Left out, each waiting for its ROADMAP queue A item: checkpointing
``--ckpt-dir``/``--ckpt-every`` (item 11), ``--dist-plan`` (item 12) and
the observability flags (item 9).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 2 \
      --batch 2 --seq 32 --plan --plan-cache /tmp/plans
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 2 \
      --batch 4 --seq 1024 --hbm-limit-gb 0.003
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --batch 4 --seq 512 \\
      --steps 5 --log-every 1 [--hbm-limit-gb 7.5]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.data import SyntheticTokens
from repro_torch.launch.steps import build_train_step
from repro_torch.models import build_model
from repro_torch.optim import adamw_init


def make_batch_fn(cfg, batch: int, seq: int, seed: int, device):
    """step -> {"tokens", "labels"} [batch, seq] int64 on ``device``."""
    ds = SyntheticTokens(cfg.vocab_size, seq, batch, seed=seed)

    def at(step: int) -> dict:
        return {k: torch.from_numpy(v).to(device=device, dtype=torch.long)
                for k, v in ds.batch_at(step).items()}

    return at


def step_planner(model, arch: str, batch: int, seq: int, smoke: bool, plan_cache=None,
                 size_threshold: int = 1 << 20):
    """The ``MemoryPlanner`` of the loss step at these shapes, under
    ``H100_SXM``, keyed as the reference keys it: traced on fake tensors,
    or restored from ``plan_cache`` (a directory or a ``PlanCache``)
    without tracing.  The colocate launcher's train tenant is this planner
    at its own ``size_threshold``."""
    from repro_torch.core.planner import MemoryPlanner
    from repro_torch.core.simulator import H100_SXM
    from repro_torch.plan import PlanKey

    probe = {k: torch.empty(batch, seq, dtype=torch.long, device="meta")
             for k in ("tokens", "labels")}
    pshapes = model.init_shapes(torch.float32)

    def step_probe(params, batch):
        return model.loss(params, batch)[0]

    key = PlanKey(arch, f"train:b{batch}s{seq}{':smoke' if smoke else ''}", H100_SXM.name)
    return MemoryPlanner(step_probe, pshapes, probe, hw=H100_SXM, cache=plan_cache or None,
                         key=key, size_threshold=size_threshold)


def plan_report(model, args):
    """Plan the loss step at this run's shapes (or restore its plan from
    ``--plan-cache``) and print the reference's ``[plan]`` line; with
    ``--hbm-limit-gb``, also its ``[plan] AutoSwap@`` line.  -> the offload
    policy to train with, or None."""
    planner = step_planner(model, args.arch, args.batch, args.seq, args.smoke, args.plan_cache)
    rep = planner.report()
    src = " (restored from cache)" if planner.from_cache else ""
    print(
        f"[plan] vars={rep.num_variables} peak={rep.peak_load/2**20:.1f}MiB "
        f"smartpool x{rep.smartpool_ratio:.4f} cnmem x{rep.cnmem_ratio:.4f}{src}"
    )
    if args.hbm_limit_gb is None:
        return None
    limit = int(args.hbm_limit_gb * 2**30)
    plan = planner.offload_plan(limit)
    sw = planner.swap_report(limit)
    print(
        f"[plan] AutoSwap@{args.hbm_limit_gb}GB: offload {plan.offload_names} "
        f"(~{plan.predicted_savings/2**20:.1f}MiB relief, "
        f"simulated overhead {sw.overhead*100:.2f}%)"
    )
    return plan.policy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-at", type=int, default=-1, help="inject a crash at step N (tests)")
    ap.add_argument("--step-timeout", type=float, default=10.0, help="straggler factor vs median")
    ap.add_argument("--plan", action="store_true", help="print the SmartPool report")
    ap.add_argument("--plan-cache", default=None,
                    help="directory of solved plan artifacts (reused across runs)")
    ap.add_argument("--hbm-limit-gb", type=float, default=None,
                    help="AutoSwap budget (GiB) for the traced loss step: execute its offload "
                         "plan")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to train on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device)
    batch_fn = make_batch_fn(cfg, args.batch, args.seq, args.seed, device)
    policy = None
    if args.plan or args.plan_cache or args.hbm_limit_gb is not None:
        policy = plan_report(model, args)
    train_step = build_train_step(model, cfg, lr=args.lr, remat_policy=policy)
    params = model.init(torch.Generator(device).manual_seed(args.seed), dtype=torch.float32)
    opt = adamw_init(params)

    losses = []
    times: list[float] = []
    moved: list[tuple[int, int]] = []  # bytes offloaded and fetched back, a step
    stragglers = 0
    for step in range(args.steps):
        if step == args.fail_at:
            raise RuntimeError(f"injected failure at step {step}")
        t0 = time.time()
        batch = batch_fn(step)
        before = (policy.bytes_d2h, policy.bytes_h2d) if policy else (0, 0)
        params, opt, metrics = train_step(params, opt, batch, step)
        loss = float(metrics["loss"])  # waits for the step's device work
        dt = time.time() - t0
        if policy:
            moved.append((policy.bytes_d2h - before[0], policy.bytes_h2d - before[1]))
        if len(times) >= 5 and dt > args.step_timeout * float(np.median(times)):
            stragglers += 1
            print(f"[watchdog] step {step} took {dt:.2f}s (median {np.median(times):.2f}s)")
        times.append(dt)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {loss:.4f}  {dt*1000:.0f} ms")
    if policy:
        print(f"[offload] bytes a step to host {[d for d, _ in moved]}, "
              f"back {[h for _, h in moved]}")
    print(
        f"done: first-loss {losses[0]:.4f} last-loss {losses[-1]:.4f} "
        f"stragglers={stragglers}"
    )
    return losses


if __name__ == "__main__":
    main()
