#!/usr/bin/env python3
"""Drive the PyTorch port (``repro_torch``) on one NVIDIA GPU and check it.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one CUDA
card and nvcc (CUDA_HOME or PATH); it imports the port from ``src/`` and
nothing of JAX or of the JAX package.  Phases, each fatal on failure:

  1. device   the card's name and power limit (nvidia-smi);
  2. build    the five kernel libraries compiled from
              ``src/repro_torch/kernels/csrc``, one nvcc each, in parallel,
              and the count of tensor-core instructions in the SASS of the
              two tensor-core libraries, neither of which may be 0: HGMMA
              (warpgroup MMA) in the wgmma flash library, HMMA or HGMMA in
              the tc SSD library;
  3. kernels  each CUDA kernel against its plain PyTorch version on the card,
              at the main paths' shapes and a few edge cases, timed beside
              its bound and a library call that computes the same function
              (none computes the SSD scan); each case names the variant
              that ran and checks that it was that one (rmsnorm:
              ``vector``, or ``scalar`` where D or alignment rules out
              16-byte vectors; flash: ``wgmma`` for bf16 at head dim 64 or
              128, ``simt`` the rest; SSD: ``tc`` for bf16 with P and N
              multiples of 8 and 16-byte aligned rows, ``simt`` for fp32
              and the other bf16 inputs).  Beside the tc SSD cases the
              simt kernel is timed on the same inputs, and beside the
              rmsnorm cases the scalar one, as yardsticks of the redesign
              (through each module's ``_launch``, the wrapper's own
              launcher, counting no launch);
  4. parity   qwen3-4b's and mamba2-370m's widths at depth 2 in fp32: prefill
              + 4 decode steps through the kernels on the card against the
              plain path on the CPU, logits and every layer's cache;
  5. serve    ``repro_torch.launch.serve.main`` on the full qwen3-4b (36
              layers, bf16, random weights) at batch 4, prompt 512, 32 tokens,
              and on the full mamba2-370m (48 layers) at batch 4, prompt 2048,
              32 tokens, with the kernels' launch counts set to 0 just before
              each run and read just after it, exactly, by variant (every
              flash launch ``wgmma``, every SSD launch ``tc``, every
              RMSNorm launch ``vector``); the memory that earlier phases
              hold is dropped first, and what is still held is printed, so
              the peak is the serve's own;
  6. profile  where the time goes: each served model's prefill and decode
              steps, warm, timed untraced and then traced with torch.profiler
              (the top kernels, and each of the port's own kernels by name:
              the tc SSD is two, its C B^T prepass and the scan).

The last lines are a ``kernels`` summary, a JSON object of per-kernel
numbers (``launches`` summed over the serve runs, whose own counts the
summary prints), the nvidia-smi line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

SRC = Path(__file__).resolve().parent / "src"
HBM_BYTES_PER_S = 3.35e12                              # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # tensor core bf16; fp32 CUDA cores
L2_BYTES = 50 * 2**20
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}      # tests/test_kernels.py
RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# Relative to max|want|, for y and the final state: tests/test_kernels.py's
# SSD tolerance in fp32; one bf16 rounding of y, and room for it, in bf16.
SSD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# Phase 4: both sides run fp32 with TF32 off, so they differ only by the
# order of fp32 sums (over D = 2560, F = 9728 or d_inner = 2048, two layers,
# five forwards): about 1e-6 relative.  A wrong mask, GQA index, cache slot,
# decay or carried state moves logits by O(1); 1e-4 separates the two.
PARITY_TOL = 1e-4


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(fn, arg_sets, iters: int) -> float:
    """Device ms per call of ``fn``, cycling through ``arg_sets`` (copies whose
    total exceeds L2, so each call reads its inputs cold).  The ``iters`` calls
    are captured in one CUDA graph and replayed between two events, so the
    host's cost of launching from Python is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capturing stream, as capture needs
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


def n_copies(nbytes: int) -> int:
    """How many copies of a call's inputs exceed twice the L2 cache."""
    return max(2, min(16, math.ceil(2 * L2_BYTES / nbytes)))


def copies(tensors, nbytes: int):
    """Enough copies of ``tensors`` to exceed twice the L2 cache."""
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors)
                               for _ in range(n_copies(nbytes) - 1)]


def bound(nbytes: int, flops: int, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rmsnorm_case(shape, dtype, gen, want_variant, misaligned=False):
    """``misaligned``: x is a contiguous view that starts one element into its
    storage, so not 16-byte aligned."""
    from repro_torch.kernels.rmsnorm import _launch, rmsnorm, rmsnorm_plain, variant

    def alloc():  # keeps the case's alignment in every copy
        n = math.prod(shape) + misaligned
        return torch.empty(n, dtype=dtype, device="cuda")[misaligned:].view(shape)

    x = alloc().copy_(torch.randn(shape, generator=gen, device="cuda"))
    scale = (torch.rand(shape[-1], generator=gen, device="cuda") + 0.5).contiguous()
    var = variant(x, scale)
    require(var == want_variant, f"rmsnorm {list(shape)} routes to {var}, want {want_variant}")
    before = rmsnorm.variant_launches[var]
    got, want = rmsnorm(x, scale), rmsnorm_plain(x, scale)
    torch.cuda.synchronize()
    require(rmsnorm.variant_launches[var] == before + 1,
            f"rmsnorm {list(shape)} did not launch the {var} kernel")
    err = (got.float() - want.float()).abs().max().item()
    tol = RMS_TOL[dtype]
    ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    nbytes = 2 * x.numel() * x.element_size() + 4 * shape[-1]
    sets = [(x, scale)] + [(alloc().copy_(x), scale.clone()) for _ in range(n_copies(nbytes) - 1)]
    w = scale.to(dtype)
    lib_sets = [(a, w) for a, _ in sets]
    b_ms, b_by = bound(nbytes, 4 * x.numel(), torch.float32)

    def scalar_kernel(a, s):  # the scalar variant on any input, counting no launch
        return _launch("scalar", a, s, 1e-6)

    return {
        "case": f"rmsnorm [{var}] {list(shape)} {str(dtype)[6:]}"
                f"{' (misaligned view)' if misaligned else ''}",
        "variant": var, "max_abs_err": err, "tol": tol,
        "ok": ok, "ms": time_ms(rmsnorm, sets, 50), "plain_ms": time_ms(rmsnorm_plain, sets, 20),
        "library_ms": time_ms(lambda a, s: F.rms_norm(a, (shape[-1],), s, 1e-6), lib_sets, 50),
        "bound_ms": b_ms, "bound_by": b_by, "other": ("scalar", time_ms(scalar_kernel, sets, 50)),
    }


def live_pairs(Sq, Sk, causal, window) -> int:
    q = np.arange(Sq)[:, None]
    k = np.arange(Sk)[None, :]
    keep = np.ones((Sq, Sk), bool)
    if causal:
        keep &= q >= k
    if window is not None:
        keep &= q - k < window
    return int(keep.sum())


def flash_case(B, Sq, Sk, H, KV, hd, dtype, gen, causal=True, window=None, softcap=None):
    """bf16 cases hold the wgmma variant, which rounds P to bf16 before P.V,
    to the plain version, which keeps P in fp32, at the bf16 tolerance."""
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_plain,
                                                     variant)

    q = torch.randn((B, Sq, H, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Sk, KV, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Sk, KV, hd), generator=gen, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    var = variant(dtype, hd)
    before = flash_attention.variant_launches[var]
    got, want = flash_attention(q, k, v, **kw), flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    require(flash_attention.variant_launches[var] == before + 1,
            f"flash B{B} Sq{Sq} hd{hd} {dtype} did not launch the {var} kernel")
    err = (got.float() - want.float()).abs().max().item()
    rel = err / want.float().abs().max().item()
    tol = TOL[dtype]
    ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    sets = copies((q, k, v), nbytes)
    flops = 4 * hd * B * H * live_pairs(Sq, Sk, causal, window)
    b_ms, b_by = bound(nbytes, flops, dtype)
    lib_ms = None
    if window is None and not softcap:  # one library call computes the same function
        def sdpa(q, k, v):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=causal,
                enable_gqa=True)
        lib_ms = time_ms(sdpa, sets, 20)
    name = (f"flash [{var}] B{B} Sq{Sq} Sk{Sk} H{H} KV{KV} hd{hd} {str(dtype)[6:]}"
            f"{' causal' if causal else ''}{f' window={window}' if window else ''}"
            f"{f' softcap={softcap}' if softcap else ''} "
            f"(error relative to max|want|: {rel:.2e})")
    return {
        "case": name, "variant": var, "max_abs_err": err, "tol": tol, "ok": ok,
        "ms": time_ms(lambda *a: flash_attention(*a, **kw), sets, 20),
        "plain_ms": time_ms(lambda *a: flash_attention_plain(*a, **kw), sets, 3),
        "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
    }


def ssd_flops(b, s, h, p, n) -> int:
    """Flops of the kernel's chunking on these shapes: for a chunk of c steps,
    the lower triangle of C B^T and of its product with x dt, c (c + 1) / 2
    (N + P) multiply-adds, and the inter-chunk term and the state update,
    2 c P N."""
    from repro_torch.kernels.ssd_scan import CHUNK

    steps = 0
    for c0 in range(0, s, CHUNK):
        c = min(CHUNK, s - c0)
        steps += c * (c + 1) // 2 * (n + p) + 2 * c * p * n
    return 2 * b * h * steps


def ssd_case(b, s, h, p, g, n, dtype, gen, want_variant, layout="dense"):
    """``layout``: ``"views"``, x, B and C are views into one [b, s, h p + 2 g n]
    tensor, as the model hands them over from its conv output (strided batch
    and sequence axes); ``"offset"``, views into such a tensor one element
    wider that start one element in (not 16-byte aligned, odd sequence
    stride); ``"dense"``, each is contiguous."""
    from repro_torch.kernels.ssd_scan import _launch, ssd_scan, ssd_scan_plain, variant

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def make():
        if layout != "dense":
            offset = int(layout == "offset")
            xbc = randn(b, s, offset + h * p + 2 * g * n)[..., offset:]
            x, Bm, Cm = (t.unflatten(-1, (k, d)) for t, k, d in zip(
                xbc.split([h * p, g * n, g * n], dim=-1), (h, g, g), (p, n, n)))
        else:
            x, Bm, Cm = randn(b, s, h, p), randn(b, s, g, n), randn(b, s, g, n)
        # dt about 0.02 (softplus(N(0, 1) - 4)) with init_mamba's A from -1 to
        # -16: the slow heads carry their state across many 64-step chunks, so
        # the inter-chunk term and the final state are checked, not only the
        # diagonal blocks.
        dt = F.softplus(randn(b, s, h).float() - 4.0).to(dtype)
        A = (-torch.linspace(1.0, 16.0, h, device="cuda")).to(dtype)
        return x, dt, A, Bm, Cm

    args = make()
    var = variant(args[0], args[3], args[4])
    require(var == want_variant, f"ssd p{p} n{n} {dtype} {layout} routes to {var}, "
                                 f"want {want_variant}")
    before = ssd_scan.variant_launches[var]
    (y, state), (y_want, state_want) = ssd_scan(*args), ssd_scan_plain(*args)
    torch.cuda.synchronize()
    require(ssd_scan.variant_launches[var] == before + 1,
            f"ssd p{p} n{n} {dtype} did not launch the {var} kernel")

    def rel(got, want):
        return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()

    tol = SSD_TOL[dtype]
    rel_y, rel_state = rel(y, y_want), rel(state, state_want)
    nbytes = sum(t.numel() * t.element_size() for t in (*args, y, state))
    b_ms, b_by = bound(nbytes, ssd_flops(b, s, h, p, n), dtype)
    sets = [args] + [make() for _ in range(n_copies(nbytes) - 1)]
    other = None
    if var == "tc":  # the simt kernel on the same inputs, counting no launch
        other = ("simt", time_ms(lambda *a: _launch("simt", *a), sets, 10))
    return {
        "case": f"ssd [{var}] x[{b},{s},{h},{p}] B/C[{b},{s},{g},{n}] {str(dtype)[6:]}"
                f"{LAYOUT_NOTE[layout]} "
                f"(error relative to max|want|: y {rel_y:.2e}, state {rel_state:.2e})",
        "variant": var, "max_abs_err": (y.float() - y_want.float()).abs().max().item(),
        "tol": tol, "relative": True,
        "ok": rel_y < tol and rel_state < tol,
        "ms": time_ms(ssd_scan, sets, 10), "plain_ms": time_ms(ssd_scan_plain, sets, 3),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "other": other,
    }


LAYOUT_NOTE = {"dense": "", "views": " (views of one tensor)",
               "offset": " (views starting one element in: not 16-byte aligned)"}


def print_case(c) -> None:
    lib = f"{c['library_ms']:.4f}ms" if c["library_ms"] is not None else "none"
    tol = f"relative tol={c['tol']:g}" if c.get("relative") else f"tol={c['tol']:g}"
    other = f" {c['other'][0]}={c['other'][1]:.4f}ms" if c.get("other") else ""
    print(f"  {c['case']}: max_abs_err={c['max_abs_err']:.3e} {tol} "
          f"{'ok' if c['ok'] else 'DISAGREES'}  kernel={c['ms']:.4f}ms{other} "
          f"plain={c['plain_ms']:.4f}ms library={lib} "
          f"bound={c['bound_ms'] * 1e3:.2f}us ({c['bound_by']}, "
          f"kernel at {c['bound_ms'] / c['ms']:.0%} of it)")


def phase_kernels():
    gen = torch.Generator("cuda").manual_seed(0)
    print("[3] kernels vs plain versions on the card")
    bf16 = torch.bfloat16
    rms = [
        rmsnorm_case((2048, 2560), bf16, gen, "vector"),   # ln1/ln2 at prefill B4 S512
        rmsnorm_case((65536, 128), bf16, gen, "vector"),   # q-norm at prefill B4 S512 H32
        rmsnorm_case((37, 1024), torch.float32, gen, "vector"),
        rmsnorm_case((8192, 2048), bf16, gen, "vector"),   # mamba2 gated norm, B4 S2048
        rmsnorm_case((8192, 1024), bf16, gen, "vector"),   # mamba2 ln1, B4 S2048
        rmsnorm_case((4, 2560), bf16, gen, "vector"),      # qwen3-4b ln1/ln2 at decode B4
        rmsnorm_case((128, 128), bf16, gen, "vector"),     # q-norm at decode B4 H32
        rmsnorm_case((37, 1020), bf16, gen, "scalar"),     # D not a multiple of 8
        rmsnorm_case((64, 2560), bf16, gen, "scalar", misaligned=True),
        rmsnorm_case((8, 6144), torch.float32, gen, "vector"),  # rows wider than a warp
        rmsnorm_case((37, 1022), torch.float32, gen, "scalar"),  # D not a multiple of 4
    ]
    flash = [
        flash_case(4, 512, 512, 32, 8, 128, bf16, gen),            # qwen3-4b prefill
        # the wgmma variant (bf16, hd 64 and 128) at its edges
        flash_case(1, 300, 300, 32, 8, 128, bf16, gen),            # ragged tiles, GQA
        flash_case(1, 256, 256, 4, 2, 64, bf16, gen, window=100),
        flash_case(1, 384, 128, 2, 1, 64, bf16, gen, window=32),   # rows, no live key; MQA
        flash_case(2, 128, 128, 2, 2, 64, bf16, gen, causal=False, softcap=30.0),
        flash_case(1, 128, 256, 4, 4, 64, bf16, gen, causal=False),  # Sq < Sk
        flash_case(1, 256, 512, 4, 2, 128, bf16, gen),             # Sq < Sk, causal
        flash_case(2, 512, 512, 8, 2, 64, bf16, gen),              # GQA at hd 64
        flash_case(1, 256, 256, 8, 1, 128, bf16, gen),             # MQA at hd 128
        # the simt variant: fp32, and bf16 at other head dims
        flash_case(1, 300, 300, 32, 8, 128, torch.float32, gen),   # ragged tiles
        flash_case(1, 256, 256, 4, 2, 64, torch.float32, gen, window=100),
        flash_case(2, 128, 128, 2, 2, 64, torch.float32, gen, causal=False, softcap=30.0),
        flash_case(1, 128, 256, 4, 4, 64, torch.float32, gen, causal=False),
        flash_case(1, 200, 200, 4, 1, 256, torch.bfloat16, gen),   # hd 256 tiles, MQA
        flash_case(1, 192, 64, 2, 1, 256, torch.float32, gen, window=32),  # rows, no live key
    ]
    f32 = torch.float32
    ssd = [
        ssd_case(4, 2048, 32, 64, 1, 128, bf16, gen, "tc", "views"),  # mamba2 prefill
        ssd_case(1, 300, 4, 16, 2, 8, bf16, gen, "tc"),            # narrow tiles, ragged
        ssd_case(2, 320, 4, 128, 2, 128, bf16, gen, "tc", "views"),  # the largest P and N
        ssd_case(2, 256, 8, 64, 2, 64, bf16, gen, "tc", "views"),  # two groups
        # the simt variant: fp32, and bf16 that the tc kernel's 16-byte rows rule out
        ssd_case(1, 300, 4, 12, 2, 100, bf16, gen, "simt"),        # P, N not multiples of 8
        ssd_case(2, 256, 8, 64, 2, 64, bf16, gen, "simt", "offset"),
        ssd_case(1, 512, 32, 64, 1, 128, f32, gen, "simt"),
        ssd_case(2, 256, 8, 64, 2, 64, f32, gen, "simt", "views"),  # two groups
        ssd_case(1, 300, 4, 64, 1, 128, f32, gen, "simt"),         # ragged last chunk
    ]
    for c in rms + flash + ssd:
        print_case(c)
    for c in rms + flash + ssd:
        require(c["ok"], f"{c['case']} disagrees with its plain version "
                         f"(max abs err {c['max_abs_err']:.3e}, tol {c['tol']:g})")
    return {"rmsnorm": rms, "flash_attention": flash, "ssd_scan": ssd}


def phase_parity(arch: str, P: int):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.convert import to_device

    full = get_config(arch)
    unit, _ = full.program[0]
    cfg = full.reduced(num_layers=2, program=((unit, 2),), dtype="float32")
    cpu, gpu = build_model(cfg, "cpu"), build_model(cfg, "cuda")
    t0 = time.perf_counter()
    p_cpu = cpu.init(torch.Generator("cpu").manual_seed(0))
    p_gpu = to_device(p_cpu, "cuda")
    steps = 4
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, P)))
    l_cpu, c_cpu = cpu.prefill(p_cpu, {"tokens": tokens}, max_seq=P + steps)
    l_gpu, c_gpu = gpu.prefill(p_gpu, {"tokens": tokens.cuda()}, max_seq=P + steps)

    def rel(a, b):
        return ((a.cpu().float() - b.float()).abs().max() / b.float().abs().max()).item()

    worst, same = rel(l_gpu, l_cpu), 0
    for i in range(steps):
        tok_cpu = l_cpu[:, -1].argmax(-1, keepdim=True)
        same += int(torch.equal(l_gpu[:, -1].argmax(-1, keepdim=True).cpu(), tok_cpu))
        l_cpu, c_cpu = cpu.decode_step(p_cpu, c_cpu, tok_cpu, P + i)
        l_gpu, c_gpu = gpu.decode_step(p_gpu, c_gpu, tok_cpu.cuda(), P + i)
        worst = max(worst, rel(l_gpu, l_cpu))
    # every leaf of every layer's cache: kv {k, v} or ssm {state, conv}
    cache_err = max(rel(g[kind][n], c[kind][n])
                    for g, c in zip(c_gpu, c_cpu) for kind in c for n in c[kind])
    print(f"[4] parity {arch} widths, 2 layers, fp32, B1 P{P} + {steps} decode steps: "
          f"max rel logit diff {worst:.3e}, max rel cache diff {cache_err:.3e} "
          f"(tol {PARITY_TOL:g}), greedy tokens equal {same}/{steps}, "
          f"{time.perf_counter() - t0:.1f}s")
    require(worst < PARITY_TOL,
            f"{arch}: kernel path logits differ from the plain path by {worst:.3e}")
    require(cache_err < PARITY_TOL, f"{arch}: kernel path cache differs by {cache_err:.3e}")
    require(torch.isfinite(l_gpu).all().item(), f"{arch}: non-finite logits in the parity run")


def release_memory() -> int:
    """Drop what earlier phases hold on the card and reset the peak; return
    the bytes still allocated, which the next peak includes.  The timing
    phase leaves cuBLAS workspaces behind, one for each stream that ran a
    matrix product (each case's capture stream): PyTorch allocates them
    through its caching allocator and keeps them, so they count as
    allocated memory until they are cleared."""
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    print(f"[5] memory: {before / 2**20:.1f} MiB allocated after the earlier phases, "
          f"{(before - held) / 2**20:.1f} MiB of it cuBLAS workspaces (cleared); "
          f"{held / 2**20:.1f} MiB still held")
    return held


def phase_serve(arch: str, B: int, P: int, G: int, want: dict[str, int]):
    """Serve the full model through ``serve.main`` (a prefill and G - 1 decode
    steps); each kernel must have been launched ``want[name]`` times."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    cfg = get_config(arch)
    held = release_memory()
    out = io.StringIO()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        gen = serve.main(["--arch", arch, "--batch", str(B), "--prompt-len", str(P),
                          "--gen", str(G)])
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    text = out.getvalue()
    prefill_s = float(re.search(r"prefill: \S+ in ([0-9.]+)s", text).group(1))
    decode_tps = float(re.search(r"\(([0-9.]+) tok/s\)", text).group(1))
    print(f"[5] serve {arch} ({cfg.num_layers} layers, bf16) B{B} P{P} gen {G}:")
    for line in text.strip().splitlines():
        print(f"  {line}")
    print(f"  logits finite (serve raises otherwise), "
          f"prefill {prefill_s * 1e3:.1f} ms, decode {decode_tps:.1f} tok/s, "
          f"peak memory {peak / 2**30:.2f} GiB ({held / 2**30:.3f} GiB of it held before "
          f"the run), launches {counts}, "
          f"main() wall {wall:.1f}s (init included)")
    require(counts == want, f"{arch}: launch counts {counts}, want {want}")
    require(tuple(gen.shape) == (B, G), f"generated shape {tuple(gen.shape)}")
    require(int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab_size, "token out of range")
    return counts


# The __global__ functions of csrc/*.cu, as a trace names them.
PORT_KERNELS = ("rmsnorm_vec_kernel", "rmsnorm_scalar_kernel", "flash_fwd_wgmma_kernel",
                "flash_fwd_kernel", "ssd_cb_kernel", "ssd_scan_tc_kernel", "ssd_scan_kernel")


def device_breakdown(prof, wall_ms: float, top: int = 6) -> str:
    """Device busy time by kernel name from a torch.profiler trace, the idle
    share, and the time and calls of each of the port's own kernels."""
    by_name: dict[str, float] = {}
    mine: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            by_name[e.name] = by_name.get(e.name, 0.0) + ms
            kernel = next((k for k in PORT_KERNELS if re.search(rf"\b{k}\b", e.name)), None)
            if kernel:
                mine.setdefault(kernel, [0.0, 0])
                mine[kernel][0] += ms
                mine[kernel][1] += 1
    busy = sum(by_name.values())
    if busy == 0.0:
        return "device time not measured (the profiler recorded no kernel)"
    rows = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    names = "; ".join(f"{n[:60]} {ms:.2f}ms ({ms / busy:.0%})" for n, ms in rows)
    own = "; ".join(f"{k} {ms:.2f}ms ({ms / busy:.1%}, {calls} calls)"
                    for k, (ms, calls) in mine.items())
    return (f"device busy {busy:.2f} of {wall_ms:.2f} ms wall, idle {1 - busy / wall_ms:.1%}; "
            f"top: {names}; the port's kernels: {own or 'none'}")


def op_breakdown(prof, top: int = 6) -> str:
    """Device time by the PyTorch op that launched it, with its input shapes
    (the port's own kernels, launched through ctypes, belong to no op)."""
    rows = [e for e in prof.key_averages(group_by_input_shape=True)
            if e.key.startswith("aten::") and e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows)
    if busy == 0:
        return "no op launched device work"
    return f"ops' device time {busy / 1e3:.2f} ms; top: " + "; ".join(
        f"{e.key} {str(e.input_shapes)[:70]} {e.self_device_time_total / 1e3:.2f}ms "
        f"({e.self_device_time_total / busy:.0%})" for e in rows[:top])


def phase_profile(arch: str, B: int, P: int, G: int):
    """Where the time goes in the served model: a warm prefill and warm decode
    steps at the serve phase's shapes, timed untraced, then traced once each."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch)
    steps = 16
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator("cuda").manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, P))).cuda()

    def prefill():
        logits, cache = model.prefill(params, {"tokens": tokens}, max_seq=P + G)
        return logits[:, -1].argmax(-1, keepdim=True), cache

    def decode(tok, cache):
        for i in range(steps):
            logits, cache = model.decode_step(params, cache, tok, P + i)
            tok = logits[:, -1].argmax(-1, keepdim=True)
        return tok

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    decode(*prefill())  # warm: lazily loaded library kernels, allocator
    (tok, cache), prefill_ms = timed(prefill)
    _, decode_ms = timed(decode, tok, cache)
    print(f"[6] profile {arch} B{B} P{P}, warm, untraced: prefill {prefill_ms:.2f} ms, "
          f"decode {decode_ms / steps:.2f} ms/step ({B * steps / decode_ms * 1e3:.1f} tok/s)")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts, record_shapes=True) as prof:
        (tok, cache), wall = timed(prefill)
    print(f"  prefill traced: {device_breakdown(prof, wall)}")
    print(f"  prefill by op: {op_breakdown(prof)}")
    with profile(activities=acts, record_shapes=True) as prof:
        _, wall = timed(decode, tok, cache)
    print(f"  decode ({steps} steps) traced: {device_breakdown(prof, wall)}")
    print(f"  decode by op: {op_breakdown(prof)}")


def mma_count(build, lib: str, ops: tuple[str, ...]) -> int:
    """Instructions of the SASS of library ``lib`` whose opcode is one of
    ``ops`` (HGMMA: warpgroup MMA; HMMA: warp MMA), by the cuobjdump of the
    toolkit whose nvcc built it."""
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(build.lib_path(lib))],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    return sum(any(re.search(rf"\b{op}\.", line) for op in ops) for line in sass.splitlines())


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs one GPU")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[1] device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    print(smi)

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"[2] build: {time.perf_counter() - t0:.1f}s "
          f"({', '.join(logs) or 'all cached'}) for sm_90a")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "wgmma" in line.lower():
                print(f"  {name}: {line.strip()}")
    for lib, ops in (("flash_attention_wgmma", ("HGMMA",)), ("ssd_scan_tc", ("HMMA", "HGMMA"))):
        count = mma_count(_build, lib, ops)
        print(f"  {'/'.join(ops)} instructions in {_build.lib_path(lib).name}: {count}")
        require(count > 0, f"the {lib} library holds no {'/'.join(ops)} instruction")

    cases = phase_kernels()
    phase_parity("qwen3-4b", 256)
    phase_parity("mamba2-370m", 300)  # pads to 512: two chunks of 256, the second ragged
    # Launches over 32 forwards (prefill and 31 decode steps): qwen3-4b runs
    # flash once a layer in prefill, RMSNorm 4 times a layer (ln1, ln2,
    # q-norm, k-norm) plus the final norm in every forward; mamba2-370m runs
    # the SSD once a layer in prefill, RMSNorm twice a layer (ln1, the gated
    # norm) plus the final norm in every forward.  Everything is bf16 with
    # widths that take 16-byte vectors: flash at head dim 128 is the wgmma
    # variant, the SSD the tc variant, RMSNorm the vector variant.
    def want(rms, flash, ssd):
        return {"rmsnorm": rms, "rmsnorm/vector": rms, "rmsnorm/scalar": 0,
                "flash_attention": flash, "flash_attention/wgmma": flash,
                "flash_attention/simt": 0, "ssd_scan": ssd, "ssd_scan/tc": ssd,
                "ssd_scan/simt": 0}

    serves = {
        "qwen3-4b": phase_serve("qwen3-4b", 4, 512, 32, want((4 * 36 + 1) * 32, 36, 0)),
        "mamba2-370m": phase_serve("mamba2-370m", 4, 2048, 32, want((2 * 48 + 1) * 32, 0, 48)),
    }
    phase_profile("qwen3-4b", 4, 512, 32)
    phase_profile("mamba2-370m", 4, 2048, 32)

    srcs = {"rmsnorm": "src/repro/kernels/rmsnorm.py:25",
            "flash_attention": "src/repro/kernels/flash_attention.py:99",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:65"}
    kernels = []
    for name, main_case in ((n, cases[n][0]) for n in srcs):
        launches = sum(counts[name] for counts in serves.values())
        require(launches > 0, f"{name} was not launched on a main path")
        var = main_case["variant"]
        source = {"wgmma": "flash_attention_wgmma", "tc": "ssd_scan_tc"}.get(var, name)
        entry = {
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{source}.cu",
            "replaces": srcs[name], "launches": launches,
            "max_abs_err": main_case["max_abs_err"], "ms": main_case["ms"],
            "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"], "library_ms": main_case["library_ms"],
            "variant": var,
        }
        kernels.append(entry)
    summary = []
    for k in kernels:
        per_path = ", ".join(f"{arch} {counts[k['name']]}" for arch, counts in serves.items())
        summary.append(f"{k['name']} launches={k['launches']} ({per_path}) "
                       f"parity=ok ({len(cases[k['name']])} cases)")
    print("kernels: " + "; ".join(summary))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
