"""Training driver (counterpart of ``repro/launch/train.py:main``).

Builds the model from ``--arch`` (full, or ``--smoke`` reduced), draws
random fp32 master parameters from ``torch.Generator(device)`` seeded with
``--seed``, and trains with AdamW on the synthetic token pipeline
(``repro_torch.data``, batches equal to the reference's for the same seed),
per-layer remat and the chunked cross-entropy.  Any model whose layers
``Model.loss`` trains: full-attention dense models (qwen3-4b, starcoder2-7b,
qwen2-vl-7b, ...), the MoE models (deepseek-v2-lite-16b with MLA,
llama4-maverick), whose loss adds 0.01 times the layers' summed aux loss
(the reference's), Mamba-2 (mamba2-370m) and hybrid layers with a window
(hymba-1.5b), and the encoder-decoder (whisper-large-v3, through
``EncDecModel.loss``, its batch holding zero frames as the reference's);
a head dim above 128 or a softcap in attention's gradient (the gemmas)
raises, naming the ROADMAP item it waits for.  Computation runs in
``cfg.dtype`` (bf16 for the full configs): each use casts the masters, as
the reference's ``.astype`` does.  Runs on CUDA unless ``--device cpu`` is
given, and raises on a host without CUDA rather than falling back.  On the
card, RMSNorm and attention run through the port's Hopper kernels forward
and backward (MLA's attention is the reference's dense softmax, as the MoE
dispatch is PyTorch's indexing ops); matrix products stay in full fp32 for
fp32 models (TF32 off).  ``main`` parses the flags and runs ``train``, the
loop itself, which takes any config: a depth cut of a full model
(``cfg.reduced(...)``, named apart) trains through it unchanged.

Kept from the reference: the per-step and ``done:`` lines, fault
tolerance, the straggler watchdog (``--step-timeout``) and the paper's
memory planner:

  * ``--ckpt-dir``     atomic keep-3 checkpoints of (params, AdamW state)
                       through ``repro_torch.checkpoint``, in the
                       reference's layout: ``async_save`` every
                       ``--ckpt-every`` steps (default 50; not at step 0),
                       then a synchronous save at the last step.  A run
                       that finds a complete checkpoint there restores the
                       latest, prints ``[resume] restored checkpoint,
                       continuing at step N`` and trains on from N with the
                       batches of steps N, N + 1, ... (``batch_fn(step)``),
                       so it replays none;
  * ``--fail-at``      an injected failure (``InjectedFailure``, a
                       ``RuntimeError``) raised at the start of step N; any
                       exception that leaves the loop first joins the save
                       in flight, so a relaunch never meets a half-written
                       step;
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
                       master at its last use, so its peak load (15.0 GiB
                       for qwen3-4b at B4 S512) lies far below the real
                       step's, which holds masters, gradients and AdamW's
                       moments resident (67.95 GB there).  Labels are named
                       only at about half of it or less; above, the
                       selection is masters, which no label covers, and the
                       step runs as plain remat.  The simulated overhead
                       prices AutoSwap's per-variable selection, masters
                       included; only the label classes execute.  Each
                       step's bytes moved each way are printed.

Left out, waiting for ROADMAP queue A item 12: ``--dist-plan`` with the
observability flags that watch its mesh run.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 24 \\
      --batch 2 --seq 32 --ckpt-dir /tmp/ckpt --ckpt-every 10 [--fail-at 15]
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-v2-lite-16b --smoke \\
      --device cpu --steps 5 [--plan --plan-cache /tmp/plans]
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama4-maverick-400b-a17b --smoke \\
      --device cpu --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-large-v3 --smoke \\
      --device cpu --steps 2 --batch 2 --seq 16
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 2 \\
      --batch 2 --seq 32 --plan --plan-cache /tmp/plans
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 2 \\
      --batch 4 --seq 1024 --hbm-limit-gb 0.003
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --batch 4 --seq 512 \\
      --steps 5 --log-every 1 [--hbm-limit-gb 7.5]
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.data import SyntheticTokens
from repro_torch.launch.steps import build_train_step
from repro_torch.models import build_model
from repro_torch.optim import adamw_init


def frontend_inputs(cfg, batch: int, seq: int, device) -> dict:
    """The stub frontends' inputs of a training batch, as the reference's
    ``make_batch_fn`` (its ``:53-61``): for the vision stub, zero patch
    embeddings [batch, min(num_patch_tokens, 8), d_model] fp32 and the
    arange over the patches and the text in all three channels [3, batch,
    npatch + seq] int64; for an encoder-decoder, zero frames [batch,
    enc_seq, d_model] fp32; nothing for another model."""
    if cfg.is_encoder_decoder:
        return {"frames": torch.zeros(batch, cfg.enc_seq, cfg.d_model, device=device)}
    if cfg.frontend != "vision_stub":
        return {}
    npatch = min(cfg.num_patch_tokens, 8)
    S = npatch + seq
    return {"patch_embeds": torch.zeros(batch, npatch, cfg.d_model, device=device),
            "positions": torch.arange(S, device=device).expand(3, batch, S)}


def make_batch_fn(cfg, batch: int, seq: int, seed: int, device):
    """step -> {"tokens", "labels"} [batch, seq] int64 on ``device``, with
    ``frontend_inputs`` where the config has a stub frontend (the same
    tensors every step, as the reference's are zeros)."""
    ds = SyntheticTokens(cfg.vocab_size, seq, batch, seed=seed)
    extra = frontend_inputs(cfg, batch, seq, device)

    def at(step: int) -> dict:
        b = {k: torch.from_numpy(v).to(device=device, dtype=torch.long)
             for k, v in ds.batch_at(step).items()}
        return dict(b, **extra)

    return at


def step_planner(model, arch: str, batch: int, seq: int, smoke: bool, plan_cache=None,
                 size_threshold: int = 1 << 20):
    """The ``MemoryPlanner`` of the loss step at these shapes, under
    ``H100_SXM``, keyed as the reference keys it, by ``arch`` (the name the
    plan is filed under: the registry's arch, or a cut config's own name):
    traced on fake tensors, or restored from ``plan_cache`` (a directory or
    a ``PlanCache``) without tracing.  The colocate launcher's train tenant
    is this planner at its own ``size_threshold``."""
    from repro_torch.core.planner import MemoryPlanner
    from repro_torch.core.simulator import H100_SXM
    from repro_torch.plan import PlanKey

    probe = {k: torch.empty(batch, seq, dtype=torch.long, device="meta")
             for k in ("tokens", "labels")}
    probe.update(frontend_inputs(model.cfg, batch, seq, "meta"))
    pshapes = model.init_shapes(torch.float32)

    def step_probe(params, batch):
        return model.loss(params, batch)[0]

    key = PlanKey(arch, f"train:b{batch}s{seq}{':smoke' if smoke else ''}", H100_SXM.name)
    return MemoryPlanner(step_probe, pshapes, probe, hw=H100_SXM, cache=plan_cache or None,
                         key=key, size_threshold=size_threshold)


def plan_report(model, name: str, batch: int, seq: int, smoke: bool, plan_cache=None,
                hbm_limit_gb: float | None = None):
    """Plan the loss step at these shapes (or restore its plan from
    ``plan_cache``) and print the reference's ``[plan]`` line; with
    ``hbm_limit_gb``, also its ``[plan] AutoSwap@`` line.  -> the offload
    policy to train with, or None."""
    planner = step_planner(model, name, batch, seq, smoke, plan_cache)
    rep = planner.report()
    src = " (restored from cache)" if planner.from_cache else ""
    print(
        f"[plan] vars={rep.num_variables} peak={rep.peak_load/2**20:.1f}MiB "
        f"smartpool x{rep.smartpool_ratio:.4f} cnmem x{rep.cnmem_ratio:.4f}{src}"
    )
    if hbm_limit_gb is None:
        return None
    limit = int(hbm_limit_gb * 2**30)
    plan = planner.offload_plan(limit)
    sw = planner.swap_report(limit)
    print(
        f"[plan] AutoSwap@{hbm_limit_gb}GB: offload {plan.offload_names} "
        f"(~{plan.predicted_savings/2**20:.1f}MiB relief, "
        f"simulated overhead {sw.overhead*100:.2f}%)"
    )
    return plan.policy()


@dataclass
class TrainRun:
    """What ``train`` returns: per step run, the loss, the model's metrics
    (``ce``, ``aux``) and ``grad_norm``, the host ms around the synchronised
    step, and the bytes the offload policy moved to host and back (empty
    without one); the checkpoint manager's record of its saves
    (``CheckpointManager.saves``) and the seconds a resume took to restore
    (None without one); and the final params and AdamW state."""

    losses: list[float] = field(default_factory=list)
    metrics: list[dict[str, float]] = field(default_factory=list)
    step_ms: list[float] = field(default_factory=list)
    moved: list[tuple[int, int]] = field(default_factory=list)
    saves: list[dict] = field(default_factory=list)
    restore_s: float | None = None
    params: Any = None
    opt: Any = None


class InjectedFailure(RuntimeError):
    """The failure ``fail_at`` injects; ``run`` holds the steps run before it."""

    def __init__(self, step: int, run: TrainRun):
        super().__init__(f"injected failure at step {step}")
        self.run = run


def train(cfg, *, steps: int, batch: int, seq: int, lr: float = 3e-4, seed: int = 0,
          device="cuda", plan: bool = False, plan_cache=None,
          hbm_limit_gb: float | None = None, plan_name: str | None = None, smoke: bool = False,
          fail_at: int = -1, step_timeout: float = 10.0, log_every: int = 10,
          ckpt_dir: str | None = None, ckpt_every: int = 50) -> TrainRun:
    """The training loop for any config ``cfg``: ``main``'s for the registry's
    configs, and a depth cut's (``cfg.reduced(...)``) for a caller that
    trains one.  Plans are filed under ``plan_name`` (``main`` gives the
    arch), by default under ``cfg.name``, so a cut config, named apart from
    its full model, never restores or overwrites the full model's plan.
    With ``ckpt_dir``, resumes from its latest checkpoint and saves as the
    module's docstring says; a resume restores straight onto ``device``
    (the template is the model's meta shapes), so the state is never held
    twice."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to train on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False

    model = build_model(cfg, device)
    batch_fn = make_batch_fn(cfg, batch, seq, seed, device)
    policy = None
    if plan or plan_cache or hbm_limit_gb is not None:
        policy = plan_report(model, plan_name or cfg.name, batch, seq, smoke, plan_cache,
                             hbm_limit_gb)
    train_step = build_train_step(model, cfg, lr=lr, remat_policy=policy)
    run = TrainRun()
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if mgr and mgr.latest_step() is not None:
        t0 = time.perf_counter()
        shapes = model.init_shapes(torch.float32)
        (params, opt), start = mgr.restore((shapes, adamw_init(shapes)), device=device)
        run.restore_s = time.perf_counter() - t0
        start += 1
        print(f"[resume] restored checkpoint, continuing at step {start}")
    else:
        params = model.init(torch.Generator(device).manual_seed(seed), dtype=torch.float32)
        opt = adamw_init(params)

    stragglers = 0
    try:
        for step in range(start, steps):
            if step == fail_at:
                raise InjectedFailure(step, run)
            t0 = time.time()
            before = (policy.bytes_d2h, policy.bytes_h2d) if policy else (0, 0)
            params, opt, metrics = train_step(params, opt, batch_fn(step), step)
            loss = float(metrics["loss"])  # waits for the step's device work
            dt = time.time() - t0
            if policy:
                run.moved.append((policy.bytes_d2h - before[0], policy.bytes_h2d - before[1]))
            times = run.step_ms
            if len(times) >= 5 and dt * 1e3 > step_timeout * float(np.median(times)):
                stragglers += 1
                print(f"[watchdog] step {step} took {dt:.2f}s "
                      f"(median {np.median(times) / 1e3:.2f}s)")
            times.append(dt * 1e3)
            run.losses.append(loss)
            run.metrics.append({k: float(metrics[k]) for k in ("ce", "aux", "grad_norm")})
            if step % log_every == 0 or step == steps - 1:
                print(f"step {step:5d}  loss {loss:.4f}  {dt*1000:.0f} ms")
            if mgr and ckpt_every and step and step % ckpt_every == 0:
                mgr.async_save((params, opt), step)
        if mgr:
            mgr.wait()
            mgr.save((params, opt), steps - 1)
    except BaseException as e:
        if mgr:  # join the save in flight before the error leaves, then raise the error
            try:
                mgr.wait()
            except Exception as err:
                e.add_note(f"the checkpoint save in flight failed too: {err!r}")
        raise
    finally:
        if mgr:
            run.saves = list(mgr.saves)
    run.params, run.opt = params, opt
    if policy:
        print(f"[offload] bytes a step to host {[d for d, _ in run.moved]}, "
              f"back {[h for _, h in run.moved]}")
    print(
        f"done: first-loss {run.losses[0]:.4f} last-loss {run.losses[-1]:.4f} "
        f"stragglers={stragglers}"
    )
    return run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
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

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    run = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
                seed=args.seed, device=args.device, plan=args.plan, plan_cache=args.plan_cache,
                hbm_limit_gb=args.hbm_limit_gb, plan_name=args.arch, smoke=args.smoke,
                fail_at=args.fail_at, step_timeout=args.step_timeout,
                log_every=args.log_every, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    return run.losses


if __name__ == "__main__":
    main()
