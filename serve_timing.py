#!/usr/bin/env python3
"""Time the port's qwen3-4b serving steps on one CUDA card.

    python3 serve_timing.py [--src DIR] [--rounds N]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src/``), so
that the ports of two checkouts can be timed by the same code, one process
each, in turns.  It builds the kernels, draws random bf16 qwen3-4b weights
(seed 0) and a prompt of B4 P512, warms up with one prefill and 16 decode
steps, then takes ``--rounds`` rounds of one prefill and 16 decode steps,
each timed on the host's clock between two synchronisations: the steps are
bound by the host's dispatch (``PERF.md`` §5), so the host's clock is the
measure.  Each round also times 2,000 calls of ``ops.fused_rmsnorm`` at
the decode step's shape ([4, 1, 2560] bf16, 145 calls a step), on the
host's clock without synchronising between calls: the kernel takes a few
µs, so this is the host's cost of one call, the part of a decode step
that changes with how the kernel is dispatched.  Prints the card's name
and power limit, and one JSON line with each round's warm prefill ms,
decode ms a step and µs a RMSNorm call.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent / "src"))
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("serve_timing: CUDA is not available; this script needs one GPU")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    B, P, steps = 4, 512, 16
    cfg = get_config("qwen3-4b")
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator("cuda").manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, P))).cuda()

    def timed(fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def prefill():
        logits, cache = model.prefill(params, {"tokens": tokens}, max_seq=P + steps)
        return logits[:, -1].argmax(-1, keepdim=True), cache

    def decode(tok, cache):
        for i in range(steps):
            logits, cache = model.decode_step(params, cache, tok, P + i)
            tok = logits[:, -1].argmax(-1, keepdim=True)
        return tok

    x = torch.randn(B, 1, cfg.d_model, device="cuda").to(torch.bfloat16)
    scale = torch.ones(cfg.d_model, device="cuda")

    def rmsnorm_calls(n=2000):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            ops.fused_rmsnorm(x, scale, eps=cfg.norm_eps)
        us = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return us

    decode(*prefill())  # warm: lazily loaded libraries, the allocator
    rmsnorm_calls(200)
    prefill_ms, decode_ms, rms_us = [], [], []
    for _ in range(args.rounds):
        (tok, cache), ms = timed(prefill)
        prefill_ms.append(round(ms, 3))
        _, ms = timed(decode, tok, cache)
        decode_ms.append(round(ms / steps, 3))
        rms_us.append(round(rmsnorm_calls(), 3))
    print(smi)
    print(json.dumps({"src": args.src, "device": torch.cuda.get_device_name(0),
                      "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
                      "rmsnorm_call_us": rms_us}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
