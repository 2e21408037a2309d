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
failure (``--fail-at``) and the straggler watchdog (``--step-timeout``).
Left out, each waiting for its ROADMAP queue A item: the planner flags
``--plan``, ``--plan-cache`` and ``--hbm-limit-gb`` (item 6),
checkpointing ``--ckpt-dir``/``--ckpt-every`` (item 11), ``--dist-plan``
(item 12) and the observability flags (item 9).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --batch 4 --seq 512 \\
      --steps 5 --log-every 1
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
    train_step = build_train_step(model, cfg, lr=args.lr)
    params = model.init(torch.Generator(device).manual_seed(args.seed), dtype=torch.float32)
    opt = adamw_init(params)

    losses = []
    times: list[float] = []
    stragglers = 0
    for step in range(args.steps):
        if step == args.fail_at:
            raise RuntimeError(f"injected failure at step {step}")
        t0 = time.time()
        batch = batch_fn(step)
        params, opt, metrics = train_step(params, opt, batch, step)
        loss = float(metrics["loss"])  # waits for the step's device work
        dt = time.time() - t0
        if len(times) >= 5 and dt > args.step_timeout * float(np.median(times)):
            stragglers += 1
            print(f"[watchdog] step {step} took {dt:.2f}s (median {np.median(times):.2f}s)")
        times.append(dt)
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {loss:.4f}  {dt*1000:.0f} ms")
    print(
        f"done: first-loss {losses[0]:.4f} last-loss {losses[-1]:.4f} "
        f"stragglers={stragglers}"
    )
    return losses


if __name__ == "__main__":
    main()
