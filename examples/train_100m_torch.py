"""End to end on the PyTorch port: train a ~100M-parameter qwen3-family model
with checkpoints and resume (the counterpart of
``examples/train_100m.py``).

    PYTHONPATH=src python examples/train_100m_torch.py [--steps 200] [--device cpu]

config -> model -> synthetic data behind a ``Prefetcher`` (depth 2) ->
AdamW -> ``CheckpointManager(keep=2)``: ``async_save`` every 50 steps, a
synchronous save at the last step, and a resume from the latest checkpoint
when ``--ckpt-dir`` holds one.  The model is fp32 (masters and compute).
Runs on CUDA unless ``--device cpu`` is given, and raises on a host without
CUDA rather than falling back.

Two differences from the reference, both about its faults (ROADMAP queue
C).  After a resume the reference's prefetcher starts again at batch 0;
this one feeds the batches of steps ``start``, ``start + 1``, ..., so a
resumed run sees the batches an uninterrupted one would.  The reference
computes a warmup-cosine schedule and never uses it, training at a constant
3e-4; this one trains at the constant 3e-4 too, and computes no schedule.
"""

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import LayerSpec, ModelConfig, uniform_program
from repro_torch.data import Prefetcher, SyntheticTokens
from repro_torch.launch.steps import build_train_step
from repro_torch.models import build_model
from repro_torch.optim import adamw_init
from repro_torch.tree import tree_leaves

LR = 3e-4


def config_100m() -> ModelConfig:
    # 93,454,720 params (the reference says ~97M): 10L x d640 x ff2560, vocab 50k (tied)
    return ModelConfig(
        name="qwen3-100m",
        family="dense",
        num_layers=10,
        d_model=640,
        num_heads=10,
        num_kv_heads=5,
        head_dim=64,
        d_ff=2560,
        vocab_size=50_000,
        program=uniform_program(LayerSpec(attn="full", ffn="dense"), 10),
        qk_norm=True,
        rope_theta=10_000.0,
        dtype="float32",
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "ckpt_100m"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = config_100m()
    model = build_model(cfg, device)
    shapes = model.init_shapes(torch.float32)
    n = sum(t.numel() for t in tree_leaves(shapes))
    print(f"model: {cfg.name}  params={n/1e6:.1f}M")

    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    start = 0
    if mgr.latest_step() is not None:
        (params, opt), start = mgr.restore((shapes, adamw_init(shapes)), device=device)
        start += 1
        print(f"resumed at step {start}")
    else:
        params = model.init(torch.Generator(device).manual_seed(0), dtype=torch.float32)
        opt = adamw_init(params)

    train_step = build_train_step(model, cfg, lr=LR)
    ds = SyntheticTokens(cfg.vocab_size, args.seq, args.batch, seed=0)
    pf = Prefetcher((ds.batch_at(s) for s in range(start, args.steps)), depth=2)

    t0 = time.time()
    losses = []
    try:
        for step in range(start, args.steps):
            batch = {k: torch.from_numpy(v).to(device=device, dtype=torch.long)
                     for k, v in next(pf).items()}
            params, opt, metrics = train_step(params, opt, batch, step)
            losses.append(float(metrics["loss"]))
            if step % 10 == 0:
                dt = (time.time() - t0) / max(1, step - start + 1)
                print(f"step {step:4d}  loss {losses[-1]:.4f}  {dt*1000:.0f} ms/step", flush=True)
            if step and step % 50 == 0:
                mgr.async_save((params, opt), step)
        mgr.wait()
        mgr.save((params, opt), args.steps - 1)
    finally:
        pf.close()
    print(f"done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({(time.time()-t0)/60:.1f} min)")
    return losses


if __name__ == "__main__":
    main()
