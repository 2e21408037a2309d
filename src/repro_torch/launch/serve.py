"""Batched serving entry point: prefill a batch of prompts, then greedy decode.

Counterpart of ``repro/launch/serve.py:98 main``.  Serves a smoke or full
model with random parameters drawn from ``torch.Generator(device)`` seeded
with ``--seed``.  Prompt tokens come from ``numpy.random.default_rng(seed +
1)``: the reference draws them with ``jax.random``, whose bits PyTorch cannot
reproduce, so the two entry points serve different prompts from the same seed.
Runs on CUDA unless ``--device cpu`` is given, and raises on a host without
CUDA rather than falling back.  On the card, RMSNorm, prefill attention
and the SSD scan run through the port's Hopper kernels; matrix products
stay in full fp32 for fp32 models (TF32 off).

The planner flags of the reference (``--plan``, ``--plan-cache``,
``--colocate``) and its observability flags wait for ROADMAP queue A items
8 (with the prefill and decode step builders) and 9.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
      --batch 4 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
      --batch 4 --prompt-len 2048 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.models import build_model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to serve on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device)
    params = model.init(torch.Generator(device).manual_seed(args.seed))

    B, P = args.batch, args.prompt_len
    max_seq = P + args.gen
    rng = np.random.default_rng(args.seed + 1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P))).to(device)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": tokens}, max_seq=max_seq)
    finite = torch.isfinite(logits).all()
    next_tok = logits[:, -1].argmax(-1, keepdim=True)
    _sync(device)
    print(f"prefill: {B}x{P} in {time.perf_counter() - t0:.4f}s")

    out_tokens = [next_tok]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        logits, cache = model.decode_step(params, cache, next_tok, P + i)
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
