#!/usr/bin/env python3
"""Time the port's flash attention backward kernel on one CUDA card.

    python3 flash_bwd_timing.py [--src DIR]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src/``), so
that the kernels of two checkouts can be timed by the same code, one
process each, in turns (parent, change, change, parent).  It times the
``wgmma`` backward (``flash_attention._launch_bwd``, the wrapper's own
launcher) on causal attention at qwen3-4b's training layout (B4 S512 H32
KV8 hd128), at hymba-1.5b's global layers' (B4 S2048 H25 KV5 hd64) and
window layers' (the same with a window of 1024), on unmasked attention at
whisper-large-v3's encoder layout (B4 S1500 H20 KV20 hd64) and its cross
attention's (448 queries against 1500 keys), and at head dim 256 at
gemma3-4b's layouts (B4 S2048 H8 KV4, causal and with its window of 1024)
and gemma2-9b's (B1 S8192 H16 KV8, softcap 50, scale 224^-0.5, causal and
with its window of 4096), bf16 from seed 0: 10 calls captured in a CUDA
graph and replayed between two events, cycling through copies of the
inputs that exceed the L2 cache, as ``chip_smoke.py``'s ``time_ms`` does.
A checkout whose backward takes no unmasked attention (its ``_launch_bwd``
has no ``causal``) times the causal layouts only, and one whose backward
takes no softcap (no ``softcap``: nor head dim 256) times no hd-256
layout.  Prints the card's name and power limit and one JSON line of
device ms a call by layout.
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

# name -> (B, Sq, Sk, H, KV, hd, causal, window, softcap, scale)
GEMMA2 = (50.0, 224.0**-0.5)
LAYOUTS = {"qwen3-4b B4 S512 H32 KV8 hd128": (4, 512, 512, 32, 8, 128, True, None, None, None),
           "hymba-1.5b global B4 S2048 H25 KV5 hd64": (4, 2048, 2048, 25, 5, 64, True, None,
                                                       None, None),
           "hymba-1.5b window B4 S2048 H25 KV5 hd64 window 1024": (4, 2048, 2048, 25, 5, 64, True,
                                                                   1024, None, None),
           "whisper-large-v3 encoder B4 S1500 H20 KV20 hd64 unmasked": (4, 1500, 1500, 20, 20, 64,
                                                                        False, None, None, None),
           "whisper-large-v3 cross B4 Sq448 Sk1500 H20 KV20 hd64 unmasked": (4, 448, 1500, 20,
                                                                             20, 64, False, None,
                                                                             None, None),
           "gemma3-4b global B4 S2048 H8 KV4 hd256": (4, 2048, 2048, 8, 4, 256, True, None, None,
                                                      None),
           "gemma3-4b window B4 S2048 H8 KV4 hd256 window 1024": (4, 2048, 2048, 8, 4, 256, True,
                                                                  1024, None, None),
           "gemma2-9b global B1 S8192 H16 KV8 hd256 softcap 50": (1, 8192, 8192, 16, 8, 256, True,
                                                                  None, *GEMMA2),
           "gemma2-9b window B1 S8192 H16 KV8 hd256 window 4096 softcap 50": (1, 8192, 8192, 16, 8,
                                                                              256, True, 4096,
                                                                              *GEMMA2)}
L2_BYTES = 50 * 2**20


def graph_ms(fn, arg_sets, iters: int = 10) -> float:
    """Device ms a call of ``fn``, cycling through ``arg_sets``, replayed
    from a CUDA graph between two events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent / "src"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_timing: CUDA is not available; this script needs one GPU")
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels.flash_attention import _launch_bwd, flash_attention

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    params = inspect.signature(_launch_bwd).parameters
    takes_causal, takes_softcap = "causal" in params, "softcap" in params
    gen = torch.Generator("cuda").manual_seed(0)
    out = {}
    for name, (B, Sq, Sk, H, KV, hd, causal, window, softcap, scale) in LAYOUTS.items():
        if (not causal and not takes_causal) or (hd > 128 and not takes_softcap):
            continue

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").bfloat16()

        q, k, v, do = randn(B, Sq, H, hd), randn(B, Sk, KV, hd), randn(B, Sk, KV, hd), \
            randn(B, Sq, H, hd)
        o, lse = flash_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                                 scale=scale, return_lse=True)
        inputs = (q, k, v, o, do, lse)
        nbytes = sum(t.numel() * t.element_size() for t in inputs)
        sets = [inputs] + [tuple(t.clone() for t in inputs)
                           for _ in range(max(1, min(15, math.ceil(2 * L2_BYTES / nbytes) - 1)))]
        kw = {"causal": causal} if takes_causal else {}
        if softcap:
            kw["softcap"] = softcap
        sc = scale or hd**-0.5
        out[name] = graph_ms(lambda *a: _launch_bwd("wgmma", *a, sc, window, **kw), sets)
    print(smi)
    print(json.dumps({"src": args.src, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
