#!/usr/bin/env python3
"""Drive the PyTorch port (``repro_torch``) on one NVIDIA GPU and check it.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one CUDA
card and nvcc (CUDA_HOME or PATH); it imports the port from ``src/`` and
nothing of JAX or of the JAX package.  Phases, each fatal on failure:

  1. device   the card's name and power limit (nvidia-smi);
  2. build    the eight kernel libraries compiled from
              ``src/repro_torch/kernels/csrc``, one nvcc each, in parallel,
              with ptxas's register and spill report by kernel, and the
              count of tensor-core instructions in the SASS of the three
              tensor-core libraries, none of which may be 0: HGMMA
              (warpgroup MMA) in the wgmma flash forward and backward
              libraries, HMMA or HGMMA in the tc SSD library;
  3. kernels  ``torch.library.opcheck`` of the five ``repro_torch``
              operators on CUDA tensors at a small shape (schema, autograd
              registration, the fake implementation against the kernel's
              outputs, AOT dispatch); then each CUDA kernel, called
              through its operator, against its plain PyTorch version on
              the card, at the main paths' shapes and a few edge cases, timed beside
              its bound and a library call that computes the same function
              (none computes the SSD scan); each case names the variant
              that ran and checks that it was that one (rmsnorm:
              ``vector``, or ``scalar`` where D or alignment rules out
              16-byte vectors; flash: ``wgmma`` for bf16 at head dim 64 or
              128, ``simt`` the rest; SSD: ``tc`` for bf16 with P and N
              multiples of 8 and 16-byte aligned rows, ``simt`` for fp32
              and the other bf16 inputs).  Beside the tc SSD cases the
              simt kernel is timed on the same inputs, and beside the
              rmsnorm cases, forward and backward, the scalar one, as
              yardsticks of the redesigns (through each module's
              ``_launch`` or ``_launch_bwd``, the wrapper's own launcher,
              counting no launch).  The training path's kernels
              too: the RMSNorm backward (dx, and dscale bit-equal across
              two runs) and the flash backward (dq, dk, dv; ``wgmma`` for
              bf16 at head dim 64 or 128, bit-equal across two runs, with
              the ``mma`` kernel it replaced timed beside it; ``simt`` the
              rest), each beside the library
              call's backward (``torch.autograd.grad`` through
              ``F.rms_norm`` or SDPA, its forward subtracted), and both
              flash forwards with the LSE written;
  4. parity   qwen3-4b's and mamba2-370m's widths at depth 2 in fp32: prefill
              + 4 decode steps through the kernels on the card against the
              plain path on the CPU, logits and every layer's cache;
  5. serve    ``repro_torch.launch.serve.main`` on the full qwen3-4b (36
              layers, bf16, random weights) at batch 4, prompt 512, 32 tokens,
              and on the full mamba2-370m (48 layers) at batch 4, prompt 2048,
              32 tokens, with the kernels' launch counts set to 0 just before
              each run and read just after it, exactly, by variant (every
              flash launch ``wgmma``, every SSD launch ``tc``, every
              RMSNorm launch ``vector``), and the decode ms a step; the
              memory that earlier phases hold is dropped first, and what is
              still held is printed, so the peak is the serve's own;
  6. profile  where the time goes: each served model's prefill and decode
              steps, warm, timed untraced and then traced with torch.profiler
              (the top kernels, and each of the port's own kernels by name:
              the tc SSD is two, its C B^T prepass and the scan; the device
              time by op, the port's ``repro_torch`` operators among them);
  7. planner  the figures the port's ``H100_SXM`` HardwareSpec prices swaps
              with, measured: pinned host<->device copy rates of 256 MiB,
              one direction at a time and both at once on two streams (the
              paper's two swap streams), and one qwen3-4b activation's copy;
              the bf16 GEMM rate at qwen3-4b's FFN shape (its MFU) alone and
              beside both copies; a tiny op's launch cost; cudaMalloc and
              cudaFree through libcudart.  Then the port's plan pipeline
              (SmartPool, the baseline pools, AutoSwap's four scores at 90,
              70 and 50% of the peak load, OffloadLowering) on a synthetic
              trace of qwen3-4b's layer structure under ``H100_SXM`` and
              under ``TPU_V5E``; then the full qwen3-4b train step (B4
              S512, fp32 masters) captured by the port's graph tracer on
              fake tensors, (a) the loss and (b) the loss with its
              gradient under remat, each planned under ``H100_SXM`` and run
              for real, its peak beside the trace's peak load w ((a)'s w
              above its peak fails), with the graph's 0-byte nodes (which
              the tracer gives no variable) listed by target and (a)'s
              variables and selections beside the CPU run's; every program
              must pass the static verifier and round-trip through its
              artifact byte for byte.
              A rate above its data-sheet figure is an impossible reading
              and fails;
  8. train parity  one train step of qwen3-4b's widths at depth 2 in fp32
              (B1 S128; ``Model.loss``, its gradients, ``adamw_step``) on
              the card against the CPU from the same masters and batch: the
              loss, every gradient, and the parameters after the card's
              AdamW against the CPU's AdamW run on the card's gradients,
              each under PARITY_TOL (the two whole steps' parameters are
              printed beside them, held to no limit: AdamW's first update
              is nearly lr sign(g), so gradients near 0 that the two sums
              round apart may move 2 lr apart, the whole range of the
              update);
  9. train    ``repro_torch.launch.train.main`` on the full qwen3-4b (36
              layers, fp32 masters, bf16 compute, per-layer remat, chunked
              loss, AdamW) at batch 4, seq 512, 5 steps, after the memory
              of earlier phases is dropped: finite losses, step times,
              tokens/s, the peak beside the 64.36 GB of fp32 state and
              under the card's memory, and exact launch counts by variant;
 10. profile  a warm train step timed, then traced (top kernels, the port's
              kernels by name, the device's idle share);
 11. offload  AutoSwap's plan executed: the loss step of phase 9's shape
              traced and planned under ``H100_SXM`` at half its peak load w
              (rounded down to 0.01 GiB), where ``OffloadLowering`` must
              name block_in; then ``train.main`` with ``--hbm-limit-gb`` at
              that limit (the plan restored from its cache) for phase 9's
              steps, seed and batches: losses within 1e-6 relative of phase
              9's, launch counts by variant equal to phase 9's, and the bytes
              moved each way a step exactly 36 x (names offloaded) x one
              activation; device memory between the forward and the backward
              with the plan and without, at the same resident params and
              batch (the drop must be at least 90% of the 36 layer inputs);
              and a warm step traced with the plan, beside phase 10's: the
              copies' time each way and how much of it lies beside compute;
 12. serve plans  ``serve.main --plan --plan-cache`` on phase 5's two cells:
              launch counts by variant and greedy tokens equal to phase 5's
              (planning launches nothing; decode takes 0-d device positions),
              each step's vars, w, chi/w and AutoSwap@80%; w against the
              card's real peak around one warm call with the params resident
              (w above it fails), the traced decode step's events at two
              positions (equal), the verifier and the artifact's round trip,
              and a second run that restores both plans; then
              ``launch.colocate`` with prefill, decode@2.0 and train tenants
              of qwen3-4b, every plan restored (train's from phase 11),
              with its per-tenant report and ``--verify`` certificates.

The last lines are a ``kernels`` summary, a JSON object of per-kernel
numbers (``launches`` summed over the main paths, the serve runs, plain
and planned, and the train runs, plain and with the offload plan, with each
path's own count in ``launches_by_path``), the nvidia-smi line,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import io
import json
import math
import re
import subprocess
import sys
import time
from collections import Counter
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
# The RMSNorm backward's dscale, relative to max|dscale|, whatever x's type:
# both sides sum fp32 products of the same inputs and differ only in the
# order of fp32 sums (under 5e-7 on sound runs), while one row dropped from
# the sum moves it by about 1 / sqrt(rows) of max|dscale| (0.4% at 65536).
DSCALE_TOL = 1e-5
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


def close(got, want, tol: float) -> tuple[bool, float, str]:
    """``torch.allclose(got, want, rtol=tol, atol=tol)`` as the number it
    tests, max(|got - want| - tol |want|), which must not exceed tol: the
    verdict, that number, and the check as printed."""
    g, w = got.float(), want.float()
    excess = ((g - w).abs() - tol * w.abs()).max().item()
    return excess <= tol, excess, f"max(|got-want| - {tol:g}|want|) {excess:.3e} <= {tol:g}"


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
    op = torch.ops.repro_torch.rmsnorm
    before = rmsnorm.variant_launches[var]
    got, want = op(x, scale, 1e-6), rmsnorm_plain(x, scale)
    torch.cuda.synchronize()
    require(rmsnorm.variant_launches[var] == before + 1,
            f"rmsnorm {list(shape)} did not launch the {var} kernel")
    err = (got.float() - want.float()).abs().max().item()
    tol = RMS_TOL[dtype]
    ok, _, check = close(got, want, tol)
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
        "variant": var, "max_abs_err": err, "check": check,
        "ok": ok, "ms": time_ms(lambda a, s: op(a, s, 1e-6), sets, 50),
        "plain_ms": time_ms(rmsnorm_plain, sets, 20),
        "library_ms": time_ms(lambda a, s: F.rms_norm(a, (shape[-1],), s, 1e-6), lib_sets, 50),
        "bound_ms": b_ms, "bound_by": b_by, "other": ("scalar", time_ms(scalar_kernel, sets, 50)),
    }


def grad_ms(fwd, arg_sets, iters: int) -> float:
    """Device ms of a library call's backward alone: ``fwd`` builds the
    graph from fresh leaves and returns (output, leaves, upstream gradient);
    its forward and backward together are timed and its forward alone, both
    captured whole in a CUDA graph (autograd runs each backward op on its
    forward's stream, so both must run on the capturing stream), and the
    difference is returned."""
    def both(*args):
        out, leaves, g = fwd(*args)
        return torch.autograd.grad(out, leaves, g)

    return time_ms(both, arg_sets, iters) - time_ms(lambda *a: fwd(*a)[0], arg_sets, iters)


def rmsnorm_bwd_case(shape, dtype, gen, want_variant):
    """rmsnorm_bwd against rmsnorm_bwd_plain: dx at the dtype's tolerance, and
    dscale, a sum over all rows whose summation order differs, at DSCALE_TOL
    relative to max|dscale|.  The scalar kernel is timed beside
    the vector one on the same inputs."""
    from repro_torch.kernels.rmsnorm import _launch_bwd, rmsnorm_bwd, rmsnorm_bwd_plain, variant

    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    scale = (torch.rand(shape[-1], generator=gen, device="cuda") + 0.5).contiguous()
    var = variant(x, scale)
    require(var == want_variant, f"rmsnorm_bwd {list(shape)} routes to {var}, want {want_variant}")
    op = torch.ops.repro_torch.rmsnorm_bwd
    before = rmsnorm_bwd.variant_launches[var]
    (dx, ds), (dx_want, ds_want) = op(x, scale, dy, 1e-6), rmsnorm_bwd_plain(x, scale, dy)
    torch.cuda.synchronize()
    require(rmsnorm_bwd.variant_launches[var] == before + 1,
            f"rmsnorm_bwd {list(shape)} did not launch the {var} kernel")
    again = op(x, scale, dy, 1e-6)[1]
    require(torch.equal(again, ds), f"rmsnorm_bwd {list(shape)}: dscale differs between two runs")
    tol = TOL[dtype]
    ds_max = ds_want.abs().max().item()
    ds_rel = (ds - ds_want).abs().max().item() / ds_max
    dx_ok, _, dx_check = close(dx, dx_want, tol)
    ok = dx_ok and ds_rel <= DSCALE_TOL
    check = f"dx {dx_check}; dscale max|got-want| / max|want| {ds_rel:.3e} <= {DSCALE_TOL:g}"
    err = (dx.float() - dx_want.float()).abs().max().item()
    nbytes = 3 * x.numel() * x.element_size() + 8 * shape[-1]
    sets = copies((x, scale, dy), nbytes)
    b_ms, b_by = bound(nbytes, 10 * x.numel(), torch.float32)

    def lib(a, s, g):
        a, s = a.detach().requires_grad_(), s.detach().to(dtype).requires_grad_()
        return F.rms_norm(a, (shape[-1],), s, 1e-6), (a, s), g

    def scalar_kernel(a, s, g):  # the scalar variant on the same inputs, counting no launch
        return _launch_bwd("scalar", a, s, g, 1e-6)

    case = {
        "case": f"rmsnorm_bwd [{var}] {list(shape)} {str(dtype)[6:]} (max_abs_err of dx; "
                f"max|dscale| {ds_max:.1f}; dscale bit-equal across two runs)",
        "variant": var, "max_abs_err": err, "check": check, "ok": ok,
        "ms": time_ms(lambda a, s, g: op(a, s, g, 1e-6), sets, 50),
        "plain_ms": time_ms(rmsnorm_bwd_plain, sets, 10),
        "library_ms": grad_ms(lib, sets, 20), "bound_ms": b_ms, "bound_by": b_by,
    }
    if var == "vector":
        case["other"] = ("scalar", time_ms(scalar_kernel, sets, 50))
    return case


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

    def op(q, k, v):
        return torch.ops.repro_torch.flash_attention(q, k, v, causal, window, softcap, None)

    before = flash_attention.variant_launches[var]
    got, want = op(q, k, v), flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    require(flash_attention.variant_launches[var] == before + 1,
            f"flash B{B} Sq{Sq} hd{hd} {dtype} did not launch the {var} kernel")
    err = (got.float() - want.float()).abs().max().item()
    rel = err / want.float().abs().max().item()
    tol = TOL[dtype]
    ok, _, check = close(got, want, tol)
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
        "case": name, "variant": var, "max_abs_err": err, "check": check, "ok": ok,
        "ms": time_ms(op, sets, 20),
        "plain_ms": time_ms(lambda *a: flash_attention_plain(*a, **kw), sets, 3),
        "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
    }


def flash_lse_case(B, S, H, KV, hd, dtype, gen):
    """Causal flash with the LSE written (as training runs it) against the
    plain version's output and LSE; the LSE at fp32's tolerance in either
    type, since both sum fp32 scores of the same inputs."""
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_plain,
                                                     variant)

    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, S, KV, hd), generator=gen, device="cuda").to(dtype)
    var = variant(dtype, hd)

    def op(q, k, v):
        return torch.ops.repro_torch.flash_attention_lse(q, k, v, True, None, None, None)

    before = flash_attention.variant_launches[var]
    (out, lse), (out_want, lse_want) = (op(q, k, v),
                                        flash_attention_plain(q, k, v, return_lse=True))
    torch.cuda.synchronize()
    require(flash_attention.variant_launches[var] == before + 1,
            f"flash with LSE B{B} S{S} hd{hd} {dtype} did not launch the {var} kernel")
    tol, lse_tol = TOL[dtype], TOL[torch.float32]
    (out_ok, _, out_check), (lse_ok, _, lse_check) = (close(out, out_want, tol),
                                                      close(lse, lse_want, lse_tol))
    ok = out_ok and lse_ok
    err = (lse - lse_want).abs().max().item()
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + 4 * lse.numel()
    sets = copies((q, k, v), nbytes)
    b_ms, b_by = bound(nbytes, 4 * hd * B * H * live_pairs(S, S, True, None), dtype)

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), is_causal=True, enable_gqa=True)

    return {
        "case": f"flash+lse [{var}] B{B} S{S} H{H} KV{KV} hd{hd} {str(dtype)[6:]} causal "
                f"(max_abs_err of the LSE)",
        "variant": var, "max_abs_err": err, "ok": ok,
        "check": f"LSE {lse_check}; output {out_check}",
        "ms": time_ms(op, sets, 20),
        "plain_ms": time_ms(lambda *a: flash_attention_plain(*a, return_lse=True), sets, 3),
        "library_ms": time_ms(sdpa, sets, 20), "bound_ms": b_ms, "bound_by": b_by,
    }


def flash_bwd_case(B, Sq, H, KV, hd, dtype, gen, want_variant):
    """flash_attention_bwd against flash_attention_bwd_plain on the same q, k,
    v, dO and the kernel forward's o and LSE: dq, dk and dv at the dtype's
    tolerance.  A wgmma case must also give equal bits in two runs, and the
    mma kernel (the variant it replaced, through ``_launch_bwd``, counting
    no launch) is held to the same plain version at the same tolerance and
    timed beside it on the same inputs, as a yardstick."""
    from repro_torch.kernels.flash_attention import (_launch_bwd, bwd_variant, flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_bwd_plain)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    q, k, v, do = randn(B, Sq, H, hd), randn(B, Sq, KV, hd), randn(B, Sq, KV, hd), \
        randn(B, Sq, H, hd)
    o, lse = flash_attention(q, k, v, return_lse=True)
    var = bwd_variant(o, do)
    require(var == want_variant, f"flash_bwd B{B} S{Sq} hd{hd} {dtype} routes to {var}, "
                                 f"want {want_variant}")
    op = torch.ops.repro_torch.flash_attention_bwd
    before = flash_attention_bwd.variant_launches[var]
    got, want = (op(q, k, v, o, do, lse, None),
                 flash_attention_bwd_plain(q, k, v, o, do, lse))
    torch.cuda.synchronize()
    require(flash_attention_bwd.variant_launches[var] == before + 1,
            f"flash_bwd B{B} S{Sq} hd{hd} {dtype} did not launch the {var} kernel")
    if var == "wgmma":
        again = op(q, k, v, o, do, lse, None)
        require(all(torch.equal(a, g) for a, g in zip(again, got)),
                f"flash_bwd [wgmma] B{B} S{Sq} hd{hd}: two runs differ")
    tol = TOL[dtype]
    checks = [close(g, w, tol) for g, w in zip(got, want)]
    ok = all(c[0] for c in checks)
    check = "; ".join(f"{n} {c[2]}" for n, c in zip(("dq", "dk", "dv"), checks))
    mma_check = ""
    if var == "wgmma":
        mma = [close(g, w, tol) for g, w in
               zip(_launch_bwd("mma", q, k, v, o, do, lse, hd**-0.5), want)]
        mma_check = "; mma max excess " + ", ".join(f"{c[1]:.2e}" for c in mma)
        require(all(c[0] for c in mma), f"flash_bwd [mma] B{B} S{Sq} hd{hd}: " +
                "; ".join(f"{n} {c[2]}" for n, c in zip(("dq", "dk", "dv"), mma)))
    errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
    rels = [e / w.float().abs().max().item() for e, w in zip(errs, want)]
    args = (q, k, v, o, do, lse)
    nbytes = sum(t.numel() * t.element_size() for t in args) + \
        (q.numel() + 2 * k.numel()) * q.element_size()
    sets = copies(args, nbytes)
    b_ms, b_by = bound(nbytes, 10 * hd * B * H * live_pairs(Sq, Sq, True, None), dtype)

    def sdpa(q, k, v, o, do, lse):
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                             v.transpose(1, 2), is_causal=True, enable_gqa=True)
        return out, (q, k, v), do.transpose(1, 2)

    other = None
    if var == "wgmma":
        other = ("mma", time_ms(lambda *a: _launch_bwd("mma", *a, hd**-0.5), sets, 10))
    return {
        "case": f"flash_bwd [{var}] B{B} S{Sq} H{H} KV{KV} hd{hd} {str(dtype)[6:]} causal "
                f"(dq, dk, dv abs err {errs[0]:.2e}, {errs[1]:.2e}, {errs[2]:.2e}; relative to "
                f"max|want| {max(rels):.2e}{'; bit-equal across two runs' * (var == 'wgmma')}"
                f"{mma_check})",
        "variant": var, "max_abs_err": max(errs), "check": check, "ok": ok,
        "ms": time_ms(lambda *a: op(*a, None), sets, 10),
        "plain_ms": time_ms(flash_attention_bwd_plain, sets, 3),
        "library_ms": grad_ms(sdpa, sets, 10), "bound_ms": b_ms, "bound_by": b_by,
        "other": other,
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
    op = torch.ops.repro_torch.ssd_scan
    before = ssd_scan.variant_launches[var]
    (y, state), (y_want, state_want) = op(*args), ssd_scan_plain(*args)
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
                f"{LAYOUT_NOTE[layout]}",
        "variant": var, "max_abs_err": (y.float() - y_want.float()).abs().max().item(),
        "ok": rel_y < tol and rel_state < tol,
        "check": f"max|got-want| / max|want|: y {rel_y:.3e}, state {rel_state:.3e}, "
                 f"each < {tol:g}",
        "ms": time_ms(op, sets, 10), "plain_ms": time_ms(ssd_scan_plain, sets, 3),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "other": other,
    }


LAYOUT_NOTE = {"dense": "", "views": " (views of one tensor)",
               "offset": " (views starting one element in: not 16-byte aligned)"}


def print_case(c) -> None:
    lib = f"{c['library_ms']:.4f}ms" if c["library_ms"] is not None else "none"
    other = f" {c['other'][0]}={c['other'][1]:.4f}ms" if c.get("other") else ""
    print(f"  {c['case']}: max_abs_err={c['max_abs_err']:.3e}; {c['check']}: "
          f"{'ok' if c['ok'] else 'DISAGREES'}  kernel={c['ms']:.4f}ms{other} "
          f"plain={c['plain_ms']:.4f}ms library={lib} "
          f"bound={c['bound_ms'] * 1e3:.2f}us ({c['bound_by']}, "
          f"kernel at {c['bound_ms'] / c['ms']:.0%} of it)")


def opcheck_ops(gen) -> None:
    """``torch.library.opcheck`` of each of the five operators on CUDA tensors
    at a small shape: the schema, the autograd registration (rmsnorm and
    flash_attention_lse take inputs that need a gradient), the fake
    implementation against the kernel's real outputs (shapes, dtypes,
    strides), and AOT dispatch with dynamic shapes."""
    from torch.library import opcheck

    from repro_torch.kernels import ops  # noqa: F401  (defines the operators)

    O = torch.ops.repro_torch

    def randn(*shape, dtype=torch.float32, grad=False):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype).requires_grad_(grad)

    bf16 = torch.bfloat16
    q, k, v = randn(1, 128, 4, 64, dtype=bf16), randn(1, 128, 2, 64, dtype=bf16), \
        randn(1, 128, 2, 64, dtype=bf16)
    o, lse = O.flash_attention_lse(q, k, v, True, None, None, None)
    cases = {
        "rmsnorm": (O.rmsnorm, (randn(64, 256, dtype=bf16, grad=True),
                                randn(256, grad=True), 1e-6)),
        "rmsnorm_bwd": (O.rmsnorm_bwd, (randn(64, 256, dtype=bf16), randn(256),
                                        randn(64, 256, dtype=bf16), 1e-6)),
        "flash_attention": (O.flash_attention, (q, k, v, True, None, None, None)),
        "flash_attention_lse": (O.flash_attention_lse,
                                (q.detach().requires_grad_(), k.detach().requires_grad_(),
                                 v.detach().requires_grad_(), True, None, None, None)),
        "flash_attention_bwd": (O.flash_attention_bwd,
                                (q, k, v, o, randn(1, 128, 4, 64, dtype=bf16), lse, None)),
        "ssd_scan": (O.ssd_scan, (randn(1, 128, 4, 64, dtype=bf16),
                                  (torch.rand(1, 128, 4, generator=gen, device="cuda") * 0.1
                                   ).to(bf16),
                                  -torch.linspace(1.0, 4.0, 4, device="cuda").to(bf16),
                                  randn(1, 128, 1, 64, dtype=bf16),
                                  randn(1, 128, 1, 64, dtype=bf16))),
    }
    t0 = time.perf_counter()
    results = {name: opcheck(op, args) for name, (op, args) in cases.items()}
    print(f"[3] opcheck on CUDA tensors ({time.perf_counter() - t0:.1f}s): " + "; ".join(
        f"{name} {'ok' if set(r.values()) == {'SUCCESS'} else r}" for name, r in results.items()))
    for name, r in results.items():
        require(set(r.values()) == {"SUCCESS"}, f"opcheck of repro_torch::{name}: {r}")


def phase_kernels():
    gen = torch.Generator("cuda").manual_seed(0)
    print("[3] kernels vs plain versions on the card, through the repro_torch operators")
    opcheck_ops(gen)
    bf16, f32 = torch.bfloat16, torch.float32
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
    # The training path's gradients: qwen3-4b at B4 S512 (ln1/ln2, q-norm,
    # k-norm; causal GQA attention), and the kernels' edges.
    rms_bwd = [
        rmsnorm_bwd_case((2048, 2560), bf16, gen, "vector"),  # ln1, ln2, final norm
        rmsnorm_bwd_case((65536, 128), bf16, gen, "vector"),  # q-norm
        rmsnorm_bwd_case((16384, 128), bf16, gen, "vector"),  # k-norm
        rmsnorm_bwd_case((37, 1024), f32, gen, "vector"),
        rmsnorm_bwd_case((4, 16384), f32, gen, "vector"),    # 512 threads a row, 64 KB of scale
        rmsnorm_bwd_case((37, 1020), bf16, gen, "scalar"),   # D not a multiple of 8
        rmsnorm_bwd_case((2047, 2560), bf16, gen, "vector"),  # rows not a multiple of a block's
        rmsnorm_bwd_case((3, 2560), bf16, gen, "vector"),    # fewer rows than SMs
        rmsnorm_bwd_case((8192, 2048), bf16, gen, "vector"),  # mamba2's widths
        rmsnorm_bwd_case((8192, 1024), bf16, gen, "vector"),
        rmsnorm_bwd_case((8, 6144), f32, gen, "vector"),     # rows wider than a warp
    ]
    flash_lse = [
        flash_lse_case(4, 512, 32, 8, 128, bf16, gen),       # qwen3-4b training forward
        flash_lse_case(2, 512, 8, 2, 64, bf16, gen),
        flash_lse_case(1, 300, 32, 8, 128, f32, gen),        # simt, ragged tiles
    ]
    flash_bwd = [
        flash_bwd_case(4, 512, 32, 8, 128, bf16, gen, "wgmma"),  # qwen3-4b training
        flash_bwd_case(2, 512, 8, 2, 64, bf16, gen, "wgmma"),  # 32 dK/dV blocks on 132 SMs
        flash_bwd_case(1, 300, 32, 8, 128, bf16, gen, "wgmma"),  # S not a multiple of the tiles
        flash_bwd_case(1, 200, 4, 1, 64, bf16, gen, "wgmma"),  # MQA
        flash_bwd_case(1, 300, 32, 8, 128, f32, gen, "simt"),  # S not a multiple of the tile
        flash_bwd_case(1, 200, 4, 1, 32, bf16, gen, "simt"),   # MQA, hd 32
    ]
    every = rms + flash + ssd + rms_bwd + flash_lse + flash_bwd
    for c in every:
        print_case(c)
    for c in every:
        require(c["ok"], f"{c['case']} disagrees with its plain version ({c['check']})")
    return {"rmsnorm": rms, "flash_attention": flash, "ssd_scan": ssd, "rmsnorm_bwd": rms_bwd,
            "flash_attention_bwd": flash_bwd, "flash_lse": flash_lse}


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


def phase_train_parity(S: int):
    """One train step of qwen3-4b's widths at depth 2 in fp32 (B1): the loss
    and its gradients through ``Model.loss`` and ``torch.autograd.grad``,
    then ``adamw_step``, as ``build_train_step`` runs them; through the
    kernels on the card (forward and backward) against the plain path on the
    CPU, from the same fp32 masters and batch.  Each number is relative to
    its leaf's max and held to PARITY_TOL: the loss; every gradient leaf;
    and every parameter after the card's AdamW against the CPU's AdamW run
    on the card's own gradients.  The parameters after the two devices'
    whole steps are printed but held to no limit, since none would be
    usable: AdamW's first update is lr g / (|g| + eps), nearly lr sign(g),
    so an element whose gradient lies within the two sums' disagreement of
    0 (most of the tied embedding's, ~1e-8) may move up to 2 lr apart, and
    2 lr is the whole range of any first update."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.models.convert import to_device
    from repro_torch.optim import adamw_init, adamw_step
    from repro_torch.tree import map_tree, tree_leaves

    full = get_config("qwen3-4b")
    unit, _ = full.program[0]
    cfg = full.reduced(num_layers=2, program=((unit, 2),), dtype="float32")
    lr = 3e-4  # build_train_step's default
    t0 = time.perf_counter()
    batch = {k: torch.from_numpy(v).long()
             for k, v in SyntheticTokens(cfg.vocab_size, S, 1, seed=0).batch_at(0).items()}
    p_init = build_model(cfg, "cpu").init(torch.Generator("cpu").manual_seed(0), torch.float32)
    start = {"cpu": map_tree(torch.clone, p_init), "cuda": to_device(p_init, "cuda")}
    out = {}
    for dev, params in start.items():
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = build_model(cfg, dev).loss(params, {k: v.to(dev) for k, v in batch.items()})
        grads = list(torch.autograd.grad(loss, leaves))
        seen = [g.clone() for g in grads]  # adamw_step clips grads in place
        _, _, om = adamw_step(leaves, grads, adamw_init(leaves), lr)
        out[dev] = (loss.detach(), om["grad_norm"], seen, [t.detach() for t in leaves])
    (loss_c, norm_c, g_c, p_c), (loss_g, norm_g, g_g, p_g) = out["cpu"], out["cuda"]

    def rel(a, b):
        return ((a.cpu().float() - b.float()).abs().max() / b.float().abs().max()).item()

    loss_err = rel(loss_g, loss_c)
    grad_err = max(rel(g, w) for g, w in zip(g_g, g_c))
    replay = [t.clone() for t in tree_leaves(p_init)]
    adamw_step(replay, [g.cpu() for g in g_g], adamw_init(replay), lr)
    update_err = max(rel(p, w) for p, w in zip(p_g, replay))
    direct_abs = max((p.cpu() - w).abs().max().item() for p, w in zip(p_g, p_c))
    near_zero = sum(int((gw.abs() <= (g.cpu() - gw).abs().max()).sum())
                    for g, gw in zip(g_g, g_c))
    print(f"[8] train parity qwen3-4b widths, 2 layers, fp32, B1 S{S}, one step (Model.loss, "
          f"autograd, adamw_step): loss {float(loss_g):.6f} (cpu {float(loss_c):.6f}), rel loss "
          f"diff {loss_err:.3e}, max rel grad diff {grad_err:.3e} over {len(g_c)} leaves, max "
          f"rel param diff after the card's AdamW against the CPU's AdamW on the card's "
          f"gradients {update_err:.3e} (tol {PARITY_TOL:g} each); grad norm {float(norm_g):.4f} "
          f"(cpu {float(norm_c):.4f}); for information, held to no limit: the two whole steps' "
          f"params differ by {direct_abs:.3e} at most (AdamW's first update spans 2 lr = "
          f"{2 * lr:g}), {near_zero} element(s) have a CPU gradient within its leaf's "
          f"disagreement of 0; {time.perf_counter() - t0:.1f}s")
    require(math.isfinite(float(loss_g)), "train parity: non-finite loss on the card")
    require(loss_err < PARITY_TOL, f"train parity: loss differs by {loss_err:.3e}")
    require(grad_err < PARITY_TOL, f"train parity: a gradient differs by {grad_err:.3e}")
    require(update_err < PARITY_TOL, f"train parity: the card's AdamW differs by {update_err:.3e}")


def release_memory(phase: str = "5") -> int:
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
    print(f"[{phase}] memory: {before / 2**20:.1f} MiB allocated after the earlier phases, "
          f"{(before - held) / 2**20:.1f} MiB of it cuBLAS workspaces (cleared); "
          f"{held / 2**20:.1f} MiB still held")
    return held


def phase_serve(arch: str, B: int, P: int, G: int, want: dict[str, int]):
    """Serve the full model through ``serve.main`` (a prefill and G - 1 decode
    steps); each kernel must have been launched ``want[name]`` times.  ->
    (launch counts, the greedy tokens, decode ms a step)."""
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
    decode_s = float(re.search(r"decode: .* in ([0-9.]+)s", text).group(1))
    print(f"[5] serve {arch} ({cfg.num_layers} layers, bf16) B{B} P{P} gen {G}:")
    for line in text.strip().splitlines():
        print(f"  {line}")
    print(f"  logits finite (serve raises otherwise), "
          f"prefill {prefill_s * 1e3:.1f} ms, decode {decode_tps:.1f} tok/s "
          f"({decode_s / (G - 1) * 1e3:.2f} ms a step), "
          f"peak memory {peak / 2**30:.2f} GiB ({held / 2**30:.3f} GiB of it held before "
          f"the run), launches {counts}, "
          f"main() wall {wall:.1f}s (init included)")
    require(counts == want, f"{arch}: launch counts {counts}, want {want}")
    require(tuple(gen.shape) == (B, G), f"generated shape {tuple(gen.shape)}")
    require(int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab_size, "token out of range")
    return counts, gen, decode_s / (G - 1) * 1e3


# qwen3-4b in fp32 (4,022,468,096 parameters): masters, gradients, and AdamW's
# m and v, 16 bytes a parameter.
TRAIN_STATE_BYTES = 16 * 4_022_468_096


def phase_train(B: int, S: int, steps: int, want: dict[str, int], extra=(), phase="9",
                what="remat"):
    """Train the full qwen3-4b through ``train.main`` (fp32 masters, bf16
    compute, per-layer remat, chunked loss, AdamW) for ``steps`` steps, with
    ``extra`` arguments; each kernel must have been launched ``want[name]``
    times.  -> (launch counts, losses, peak bytes, host ms a step, output)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    held = release_memory(phase)
    out = io.StringIO()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        losses = train.main(["--arch", "qwen3-4b", "--batch", str(B), "--seq", str(S),
                             "--steps", str(steps), "--log-every", "1", *extra])
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    card = torch.cuda.get_device_properties(0).total_memory
    text = out.getvalue()
    step_ms = [float(m) for m in re.findall(r"loss +\S+ +([0-9.]+) ms", text)]
    print(f"[{phase}] train qwen3-4b (36 layers, fp32 masters, bf16 compute, {what}) B{B} "
          f"S{S}, {steps} steps:")
    for line in text.strip().splitlines():
        print(f"  {line}")
    warm = step_ms[1:]
    print(f"  losses {losses}; host ms a step (synchronised) {step_ms}; warm median "
          f"{float(np.median(warm)):.0f} ms, {B * S / float(np.median(warm)) * 1e3:.0f} tokens/s; "
          f"peak memory {peak / 1e9:.2f} GB ({peak / 2**30:.2f} GiB) beside "
          f"{TRAIN_STATE_BYTES / 1e9:.2f} GB of fp32 state (masters, gradients, m, v) and "
          f"{card / 2**30:.2f} GiB on the card ({held / 2**30:.3f} GiB held before the run); "
          f"launches {counts}; main() wall {wall:.1f}s (init included)")
    require(len(losses) == steps and all(math.isfinite(x) for x in losses),
            f"train: losses {losses}")
    require(peak < card, f"train: peak {peak} B exceeds the card's {card} B")
    require(counts == want, f"train: launch counts {counts}, want {want}")
    return counts, losses, peak, step_ms, text


def phase_train_profile(B: int, S: int, policy=None, phase="10"):
    """Where a warm training step's time goes: one step timed untraced, then
    one traced with torch.profiler; with ``policy``, under that offload
    policy.  -> the traced step's device figures (``copy_overlap``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init

    release_memory(phase)
    cfg = get_config("qwen3-4b")
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator("cuda").manual_seed(0), dtype=torch.float32)
    opt = adamw_init(params)
    step_fn = build_train_step(model, cfg, remat_policy=policy)
    batch_fn = make_batch_fn(cfg, B, S, 0, "cuda")

    def step(i):
        nonlocal params, opt
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch_fn(i), i)
        loss = float(metrics["loss"])
        return loss, (time.perf_counter() - t0) * 1e3

    step(0)  # warm
    loss, ms = step(1)
    what = "" if policy is None else f" offloading {sorted(policy.offload_names)}"
    print(f"[{phase}] profile train qwen3-4b B{B} S{S}{what}, warm, untraced: {ms:.1f} ms a "
          f"step ({B * S / ms * 1e3:.0f} tokens/s), loss {loss:.4f}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        loss, wall = step(2)
    figures = copy_overlap(prof)
    print(f"  train step traced: {device_breakdown(prof, wall, top=8)}")
    print(f"  train step by op: {op_breakdown(prof, top=8)}")
    print(f"  copies: {figures['copy_ms']:.3f} ms in all (device to host "
          f"{figures['d2h_ms']:.3f}, host to device {figures['h2d_ms']:.3f}), "
          f"{figures['overlap_ms']:.3f} ms of it beside compute; compute (kernels and "
          f"memsets) busy {figures['compute_ms']:.2f} ms of {wall:.2f} ms wall")
    require(math.isfinite(loss), "train profile: non-finite loss")
    return dict(figures, untraced_ms=ms, wall_ms=wall)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def copy_overlap(prof) -> dict[str, float]:
    """From a traced step's device events: the time of the copies
    (``Memcpy ...``) each way, of the rest (kernels, memsets: compute) as a
    union of intervals, and how much of the copies' time lies within it."""
    copies: dict[str, list] = {"d2h": [], "h2d": [], "other": []}
    compute = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        if e.name.startswith("Memcpy"):
            kind = "d2h" if "DtoH" in e.name else "h2d" if "HtoD" in e.name else "other"
            copies[kind].append(span)
        else:
            compute.append(span)
    busy = _union(compute)
    overlap = sum(max(0.0, min(b, d) - max(a, c))
                  for spans in copies.values() for a, b in spans for c, d in busy)
    ms = {k: sum(b - a for a, b in v) / 1e3 for k, v in copies.items()}
    return {"d2h_ms": ms["d2h"], "h2d_ms": ms["h2d"], "copy_ms": sum(ms.values()),
            "overlap_ms": overlap / 1e3, "compute_ms": sum(b - a for a, b in busy) / 1e3}


# Phase 11: AutoSwap's plan executed.  Solved plans land here, inside the checkout.
PLAN_DIR = Path(__file__).resolve().parent / "build" / "plans"


def phase_offload_plan(B: int, S: int):
    """Trace and plan the loss step ``train --hbm-limit-gb`` plans (the
    same key, so ``train.main`` restores it from PLAN_DIR) at half its peak
    load w, rounded down to 0.01 GiB; block_in must be named there.  ->
    (the limit in GiB, the OffloadPlan)."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import build_model

    shutil.rmtree(PLAN_DIR, ignore_errors=True)
    model = build_model(get_config("qwen3-4b"), "cuda")
    t0 = time.perf_counter()
    planner = train.step_planner(model, "qwen3-4b", B, S, False, str(PLAN_DIR))
    omega = planner.report().peak_load
    gb = math.floor(omega / 2 / 2**30 * 100) / 100
    limit = int(gb * 2**30)
    plan = planner.offload_plan(limit)
    sw = planner.swap_report(limit)
    print(f"[11] plan: loss step of qwen3-4b B{B} S{S} (fp32 masters) traced and planned "
          f"under H100_SXM in {time.perf_counter() - t0:.1f}s: w {omega:,} B, limit "
          f"{gb} GiB ({limit:,} B, {limit / omega:.4f} w): offload_names {plan.offload_names}, "
          f"save_names {plan.save_names}, predicted_savings {plan.predicted_savings:,} B, "
          f"transfer_bytes {plan.transfer_bytes:,} B; swdoa selects {sw.num_selected} "
          f"variables, {sw.selected_bytes:,} B (by name {sw.per_name_bytes}), simulated "
          f"overhead {sw.overhead * 100:.2f}%, stalls {sw.stalls}")
    require("block_in" in plan.offload_names, f"the plan at {gb} GiB names no block_in")
    return gb, plan


def phase_offload_memory(B: int, S: int, names):
    """Device memory between the forward and the backward of the full
    qwen3-4b loss, at the same resident fp32 masters and batch, under plain
    remat and under the policy offloading ``names``: offloading block_in
    keeps no layer input on the device, so the drop must be at least 90% of
    36 of them."""
    from repro_torch.configs import get_config
    from repro_torch.core.offload import remat_policy_for
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves

    release_memory("11")
    cfg = get_config("qwen3-4b")
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator("cuda").manual_seed(0), dtype=torch.float32)
    batch = make_batch_fn(cfg, B, S, 0, "cuda")(0)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    between, losses, moved = {}, {}, {}
    # A first run allocates what stays (cuBLAS's 32 MiB workspace), so that
    # the two measured runs start from the same memory.
    for tag, policy in (("warm", None), ("plain", None),
                        ("offload", remat_policy_for(names).policy())):
        gc.collect()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        loss, _ = model.loss(params, batch, remat_policy=policy)
        torch.cuda.synchronize()
        torch.empty(1, device="cuda")  # the allocator takes back blocks whose copies ended
        between[tag] = torch.cuda.memory_allocated() - resident
        grads = torch.autograd.grad(loss, leaves)
        losses[tag] = float(loss.detach())
        moved[tag] = (policy.bytes_d2h, policy.bytes_h2d) if policy else (0, 0)
        del grads, loss
    drop = between["plain"] - between["offload"]
    want = cfg.num_layers * ACT_BYTES
    print(f"[11] memory between forward and backward (params and batch resident): plain "
          f"remat {between['plain']:,} B (the run before it {between['warm']:,} B), "
          f"offloading {names} {between['offload']:,} B: drop {drop:,} B = "
          f"{drop / want:.4f} of the 36 block_in ({want:,} B); losses {losses}, bytes to "
          f"host and back {moved['offload']}")
    require(drop >= 0.9 * want, f"offload: device memory dropped {drop} B, want >= 0.9 x {want}")
    require(len(set(losses.values())) == 1, f"offload: loss {losses}")
    for t in leaves:
        t.requires_grad_(False)


# The __global__ functions of csrc/*.cu, as a trace names them.
PORT_KERNELS = ("rmsnorm_vec_kernel", "rmsnorm_scalar_kernel", "rmsnorm_bwd_vec_kernel",
                "rmsnorm_bwd_kernel", "rmsnorm_bwd_reduce_kernel",
                "flash_fwd_wgmma_kernel", "flash_fwd_kernel",
                "flash_bwd_delta_kernel", "flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                "flash_bwd_dot_kernel", "flash_bwd_dkdv_mma_kernel", "flash_bwd_dq_mma_kernel",
                "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel",
                "ssd_cb_kernel", "ssd_scan_tc_kernel", "ssd_scan_kernel")


# Phase 12: the serving steps planned (serve --plan --plan-cache PLAN_DIR),
# restored, measured against the card, and co-located with phase 11's train
# step.
def _plan_lines(text: str) -> dict[str, tuple[str, str]]:
    """role -> (its ``[plan] role: ...`` report line, its AutoSwap@80% line)."""
    out = {}
    for role in ("prefill", "decode"):
        lines = [ln for ln in text.splitlines() if ln.startswith(f"[plan] {role}: ")]
        require(len(lines) == 2, f"serve printed {lines} for {role}")
        out[role] = (lines[0], lines[1])
    return out


def phase_serve_plans(arch: str, B: int, P: int, G: int, want: dict[str, int], phase5_gen,
                      phase5_ms: float):
    """``serve.main --plan --plan-cache PLAN_DIR`` on the full model: the
    launch counts by variant must be phase 5's and the greedy tokens phase
    5's bit for bit (planning traces fake tensors and launches nothing; the
    decode loop passes 0-d device positions).  Then, for each step: its
    peak load w beside the card's real peak around one warm call with the
    params resident (w above the peak fails, as in phase 7 (a)), the
    traced decode step's events at two positions (must be equal), the
    static verifier and the artifact's byte-for-byte round trip; and a
    second ``serve.main`` that must restore both plans.  -> launch counts."""
    from repro_torch.analyze import verify_program
    from repro_torch.configs import get_config
    from repro_torch.core.trace import trace_step_fn
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.models import build_model
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.transformer import init_program_cache
    from repro_torch.plan import dumps_canonical, program_from_json

    cfg = get_config(arch)
    argv = ["--arch", arch, "--batch", str(B), "--prompt-len", str(P), "--gen", str(G),
            "--plan", "--plan-cache", str(PLAN_DIR)]
    held = release_memory("12")
    out = io.StringIO()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        gen = serve.main(argv)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    text = out.getvalue()
    decode_ms = float(re.search(r"decode: .* in ([0-9.]+)s", text).group(1)) / (G - 1) * 1e3
    print(f"[12] serve {arch} --plan --plan-cache (B{B} P{P} gen {G}), main() wall "
          f"{wall:.1f}s (init and planning included):")
    for line in text.strip().splitlines():
        print(f"  {line}")
    require(counts == want, f"{arch} planned: launch counts {counts}, want phase 5's {want}")
    require(torch.equal(gen, phase5_gen), f"{arch} planned: greedy tokens differ from phase 5's")
    require(all(ln[0].split(": ", 1)[1].startswith("solved")
                for ln in _plan_lines(text).values()), f"{arch}: the first run did not solve")
    print(f"  launches equal to phase 5's by variant, greedy tokens equal bit for bit; decode "
          f"{decode_ms:.2f} ms a step (0-d device positions), phase 5's run {phase5_ms:.2f}")

    # w beside the card's peak for one warm call of each step.
    model = build_model(cfg, "cuda")
    planners = {role: serve.serve_step_planner(model, arch, role, B, P, P + G, False,
                                               str(PLAN_DIR)) for role in ("prefill", "decode")}
    params = model.init(torch.Generator("cuda").manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (B, P)))
    tokens = tokens.cuda()
    positions = torch.arange(P, P + G, device="cuda")

    def prefill():
        logits, cache = model.prefill(params, {"tokens": tokens}, max_seq=P + G)
        return logits[:, -1].argmax(-1, keepdim=True), cache

    def real_peak(fn, *args):
        gc.collect()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        result = fn(*args)
        torch.cuda.synchronize()
        return result, torch.cuda.max_memory_allocated() - held, resident - held

    tok, cache = prefill()  # warm
    del tok, cache
    peaks, resident = {}, {}
    (tok, cache), peaks["prefill"], resident["prefill"] = real_peak(prefill)
    model.decode_step(params, cache, tok, positions[0])  # warm
    _, peaks["decode"], resident["decode"] = real_peak(model.decode_step, params, cache, tok,
                                                       positions[1])
    del tok, cache, params
    for role, planner in planners.items():
        rep = planner.report()
        sw = planner.swap_report(int(rep.peak_load * 0.8))
        omega = planner.trace.peak_load()
        cert = verify_program(planner.program)
        blob = dumps_canonical(planner.program)
        require(planner.from_cache, f"{arch} {role}: not restored from {PLAN_DIR}")
        require(cert.ok, f"{arch} {role}: the verifier failed {cert.failed()}")
        require(dumps_canonical(program_from_json(json.loads(blob))) == blob,
                f"{arch} {role}: the artifact does not round-trip byte for byte")
        print(f"[12] {arch} {role} (restored): vars {rep.num_variables}, w {omega:,} B, "
              f"SmartPool chi/w {rep.smartpool_ratio:.4f}, CnMem {rep.cnmem_ratio:.4f}; "
              f"AutoSwap@80% selects {sw.num_selected} vars, {sw.selected_bytes:,} B (by name "
              f"{sw.per_name_bytes}), simulated overhead {sw.overhead * 100:.2f}%, stalls "
              f"{sw.stalls}; verifier ok ({len(cert.checks)} checks), round trip byte-equal "
              f"({len(blob):,} B); real peak {peaks[role]:,} B ({resident[role]:,} B resident "
              f"first), w / peak {omega / peaks[role]:.4f}")
        require(omega <= peaks[role], f"{arch} {role}: w {omega} B exceeds the real peak "
                                      f"{peaks[role]} B")

    # The decode step traced at two positions (0-d CUDA tensors).
    kv = init_program_cache(cfg, cfg.program, B, P + G, dtype_of(cfg), "meta")
    tok_meta = torch.empty((B, 1), dtype=torch.long, device="meta")
    traced = []
    for pos in (P, P + G - 2):
        t0 = time.perf_counter()
        tr = trace_step_fn(build_serve_step(model, cfg), model.init_shapes(), kv, tok_meta,
                           torch.tensor(pos, device="cuda"))
        traced.append((pos, tr.num_indices, len(tr.variables), tr.peak_load(),
                       time.perf_counter() - t0))
    print(f"[12] {arch} decode traced at two positions: " + "; ".join(
        f"pos {p}: {n} events, {v} variables, w {w:,} B ({s:.1f}s)" for p, n, v, w, s in traced))
    require(len({t[1:4] for t in traced}) == 1, f"{arch}: the decode trace depends on pos")

    # Warm start: a second serving process restores both plans.
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(argv)
    lines = _plan_lines(out.getvalue())
    for role, (report, swap) in lines.items():
        print(f"[12] second run: {report}")
        require(report.split(": ", 1)[1].startswith("restored from cache"),
                f"{arch} {role}: the second run did not restore its plan")
    return counts


def phase_colocate(B: int, P: int, G: int, S: int):
    """``repro_torch.launch.colocate`` with prefill, decode@2.0 and train
    tenants of qwen3-4b at the serve and train cells' shapes, every plan
    from PLAN_DIR: the two serving steps of phase 12 and, under the same
    key ``train --plan-cache`` used, phase 11's train step; ``--verify``."""
    from repro_torch.launch import colocate

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        colocate.main(["--arch", "qwen3-4b", "--tenants", "prefill,decode@2.0,train",
                       "--batch", str(B), "--prompt-len", str(P), "--gen", str(G), "--seq",
                       str(S), "--plan-cache", str(PLAN_DIR), "--verify"])
    text = out.getvalue()
    print(f"[12] colocate qwen3-4b prefill + decode@2.0 + train (B{B} P{P} gen {G}, train "
          f"S{S}) under H100_SXM in {time.perf_counter() - t0:.1f}s:")
    for line in text.strip().splitlines():
        print(f"  {line}")
    for role in ("prefill", "decode", "train"):
        require(f"[plan] qwen3-4b:{role}: restored from cache" in text,
                f"colocate: the {role} tenant's plan was not restored from {PLAN_DIR}")
    require("[verify] schedule: ok" in text, "colocate: the schedule did not verify")


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
    """Device time by the PyTorch op that launched it, with its input shapes:
    aten's ops and the port's own (``repro_torch::rmsnorm`` and the rest,
    whose CUDA implementations launch the port's kernels; where a gradient
    is taken, the forward's launches fall under the autograd node that
    ``register_autograd`` names after the op,
    ``GeneratedBackwardFor_repro_torch_...``), and the device time of each
    of the port's ops."""
    rows = [e for e in prof.key_averages(group_by_input_shape=True)
            if (e.key.startswith("aten::") or "repro_torch" in e.key)
            and e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows)
    if busy == 0:
        return "no op launched device work"
    mine: dict[str, list] = {}
    for e in rows:
        if "repro_torch" in e.key:
            mine.setdefault(e.key, [0.0, 0])
            mine[e.key][0] += e.self_device_time_total / 1e3
            mine[e.key][1] += e.count
    own = "; ".join(f"{k} {ms:.2f}ms ({calls} calls)" for k, (ms, calls) in sorted(mine.items()))
    return f"ops' device time {busy / 1e3:.2f} ms; top: " + "; ".join(
        f"{e.key} {str(e.input_shapes)[:70]} {e.self_device_time_total / 1e3:.2f}ms "
        f"({e.self_device_time_total / busy:.0%})" for e in rows[:top]) + \
        f"; the port's ops: {own or 'none'}"


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


# Phase 7: the figures the planner's HardwareSpec prices swaps with, on the card.
PCIE5_X16_BYTES_PER_S = 64e9          # PCIe Gen5 x16, per direction, data sheet
LINK_BYTES = 256 * 2**20              # one buffer of the link measurement
ACT_BYTES = 4 * 512 * 2560 * 2        # qwen3-4b block_in at B4 S512, bf16
GEMM_MKN = (2048, 2560, 9728)         # qwen3-4b's FFN at 2048 tokens: [M, K] x [K, N]
# One qwen3-4b layer's bf16 matrices: q, k, v, o, and the FFN's three.
LAYER_WEIGHT_BYTES = 2 * (2560 * 4096 + 2 * 2560 * 1024 + 4096 * 2560 + 3 * 2560 * 9728)
SCORERS = ("doa", "aoa", "wdoa", "swdoa")
LIMIT_FRACS = (0.9, 0.7, 0.5)


def stream_seconds(stream, fn, reps: int) -> float:
    """Seconds of ``reps`` calls of ``fn`` enqueued on ``stream``, timed by
    CUDA events on it."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record(stream)
    with torch.cuda.stream(stream):
        for _ in range(reps):
            fn()
    end.record(stream)
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def concurrent_seconds(jobs):
    """Start every ``(stream, fn, reps)`` of ``jobs`` at one event; the
    seconds each stream took from it."""
    go = torch.cuda.Event(enable_timing=True)
    go.record()
    ends = []
    for stream, fn, reps in jobs:
        stream.wait_event(go)
        with torch.cuda.stream(stream):
            for _ in range(reps):
                fn()
        end = torch.cuda.Event(enable_timing=True)
        end.record(stream)
        ends.append(end)
    for end in ends:
        end.synchronize()
    return [go.elapsed_time(end) / 1e3 for end in ends]


def cudart():
    """The CUDA runtime of the toolkit that builds the kernels, for calls
    that must not go through PyTorch's caching allocator."""
    from repro_torch.kernels import _build

    lib = ctypes.CDLL(str(Path(_build._nvcc()).parents[1] / "lib64" / "libcudart.so"))
    lib.cudaMalloc.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_size_t]
    lib.cudaMalloc.restype = ctypes.c_int
    lib.cudaFree.argtypes = [ctypes.c_void_p]
    lib.cudaFree.restype = ctypes.c_int
    return lib


def malloc_free_seconds(lib, nbytes: int, reps: int = 20) -> tuple[float, float]:
    """Host seconds of one cudaMalloc and of one cudaFree of ``nbytes``,
    after one untimed pair (the library's first call sets up its state)."""
    t_malloc = t_free = 0.0
    for i in range(reps + 1):
        ptr = ctypes.c_void_p()
        t0 = time.perf_counter()
        rc = lib.cudaMalloc(ctypes.byref(ptr), nbytes)
        t1 = time.perf_counter()
        require(rc == 0, f"cudaMalloc({nbytes}) returned {rc}")
        rc = lib.cudaFree(ptr)
        t2 = time.perf_counter()
        require(rc == 0, f"cudaFree returned {rc}")
        if i:
            t_malloc += t1 - t0
            t_free += t2 - t1
    return t_malloc / reps, t_free / reps


def phase_link_and_compute():
    """Phase 7's measurements: pinned copy rates one direction at a time and
    both at once, one activation's copy, the bf16 GEMM rate alone and beside
    both copies, a tiny op's launch cost, cudaMalloc and cudaFree."""
    from repro_torch.core.simulator import CUDA_MALLOC_COST_S, H100_SXM

    spec = H100_SXM
    host_in = torch.empty(LINK_BYTES, dtype=torch.uint8, pin_memory=True).fill_(1)
    host_out = torch.empty(LINK_BYTES, dtype=torch.uint8, pin_memory=True)
    dev_in = torch.empty(LINK_BYTES, dtype=torch.uint8, device="cuda")
    dev_out = torch.ones(LINK_BYTES, dtype=torch.uint8, device="cuda")
    s_out, s_in = torch.cuda.Stream(), torch.cuda.Stream()

    def h2d():
        dev_in.copy_(host_in, non_blocking=True)

    def d2h():
        host_out.copy_(dev_out, non_blocking=True)

    reps = 8
    for fn in (h2d, d2h):  # warm: first touch of the pinned pages
        stream_seconds(s_in, fn, 1)
    r = {"h2d": LINK_BYTES * reps / stream_seconds(s_in, h2d, reps),
         "d2h": LINK_BYTES * reps / stream_seconds(s_out, d2h, reps)}
    t_out, t_in = concurrent_seconds([(s_out, d2h, reps), (s_in, h2d, reps)])
    r["both_d2h"], r["both_h2d"] = LINK_BYTES * reps / t_out, LINK_BYTES * reps / t_in
    print(f"[7] link, pinned {LINK_BYTES >> 20} MiB copies on a side stream, {reps} each: "
          f"H2D {r['h2d'] / 1e9:.2f} GB/s, D2H {r['d2h'] / 1e9:.2f} GB/s; both at once on two "
          f"streams: D2H {r['both_d2h'] / 1e9:.2f}, H2D {r['both_h2d'] / 1e9:.2f} GB/s "
          f"(H100_SXM.link_bw {spec.link_bw / 1e9:.2f} GB/s per direction with both busy; "
          f"PCIe Gen5 x16 data sheet "
          f"{PCIE5_X16_BYTES_PER_S / 1e9:.0f} GB/s per direction)")

    act_reps = 50
    act_in, act_out = dev_in[:ACT_BYTES], dev_out[:ACT_BYTES]
    host_act_in, host_act_out = host_in[:ACT_BYTES], host_out[:ACT_BYTES]
    t_act_in = stream_seconds(s_in, lambda: act_in.copy_(host_act_in, non_blocking=True),
                              act_reps) / act_reps
    t_act_out = stream_seconds(s_out, lambda: host_act_out.copy_(act_out, non_blocking=True),
                               act_reps) / act_reps
    print(f"[7] link, one activation (qwen3-4b block_in at B4 S512 bf16, {ACT_BYTES:,} B): "
          f"H2D {t_act_in * 1e3:.4f} ms, D2H {t_act_out * 1e3:.4f} ms; "
          f"the spec's size / link_bw {ACT_BYTES / spec.link_bw * 1e3:.4f} ms")

    M, K, N = GEMM_MKN
    gen = torch.Generator("cuda").manual_seed(0)
    a = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    b = torch.randn((K, N), generator=gen, device="cuda").to(torch.bfloat16)
    c = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
    main = torch.cuda.current_stream()

    def gemm():
        torch.matmul(a, b, out=c)

    flops = 2 * M * K * N
    gemm_reps = 200
    stream_seconds(main, gemm, 20)  # warm: cuBLAS's choice of kernel, clocks
    t_gemm = stream_seconds(main, gemm, gemm_reps)
    r["gemm"] = flops * gemm_reps / t_gemm
    require(torch.isfinite(c).all().item(), "the GEMM gave non-finite values")
    # Copies long enough to outlast the GEMM loop in both directions.
    copy_reps = max(reps, math.ceil(1.5 * t_gemm / (LINK_BYTES / min(r["h2d"], r["d2h"]))))
    t_g, t_out, t_in = concurrent_seconds([(main, gemm, gemm_reps), (s_out, d2h, copy_reps),
                                           (s_in, h2d, copy_reps)])
    r["gemm_copies"] = flops * gemm_reps / t_g
    r["copies_d2h"], r["copies_h2d"] = LINK_BYTES * copy_reps / t_out, LINK_BYTES * copy_reps / t_in
    print(f"[7] compute, bf16 torch.matmul [{M}, {K}] x [{K}, {N}], {gemm_reps} calls: "
          f"{r['gemm'] / 1e12:.1f} TFLOP/s, MFU {r['gemm'] / PEAK_FLOPS[torch.bfloat16]:.4f} of 989 TFLOP/s "
          f"(H100_SXM.efficiency {spec.efficiency:.4f}); beside a D2H and an H2D copy on side "
          f"streams ({copy_reps} x {LINK_BYTES >> 20} MiB each, running through the whole "
          f"GEMM loop: {min(t_out, t_in) >= t_g}): {r['gemm_copies'] / 1e12:.1f} TFLOP/s "
          f"({r['gemm_copies'] / r['gemm']:.4f} of alone), copies D2H "
          f"{r['copies_d2h'] / 1e9:.2f}, H2D {r['copies_h2d'] / 1e9:.2f} GB/s")

    x = torch.zeros(1, device="cuda")
    n_ops = 2000
    for _ in range(100):
        x.add_(1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_ops):
        x.add_(1.0)
    torch.cuda.synchronize()
    host_per_op = (time.perf_counter() - t0) / n_ops
    device_per_op = time_ms(lambda: x.add_(1.0), [()], 1000) / 1e3
    lib = cudart()
    mallocs = {n: malloc_free_seconds(lib, n) for n in (2**20, 256 * 2**20)}
    print(f"[7] costs: a tiny op (add_ on one element) {host_per_op * 1e6:.2f} us a call from "
          f"an eager loop, {device_per_op * 1e6:.2f} us a kernel replayed in a CUDA graph "
          f"(H100_SXM.op_overhead_s {spec.op_overhead_s * 1e6:.2f} us); cudaMalloc + cudaFree "
          f"through libcudart: " + ", ".join(
              f"{n >> 20} MiB {m * 1e6:.1f} + {f * 1e6:.1f} us" for n, (m, f) in mallocs.items())
          + f" (CUDA_MALLOC_COST_S {CUDA_MALLOC_COST_S * 1e6:.0f} us, the paper's; "
            f"H100_SXM.malloc_cost_s {spec.malloc_cost_s:g})")
    numbers = [*r.values(), t_act_in, t_act_out, host_per_op, device_per_op,
               *(t for pair in mallocs.values() for t in pair)]
    require(all(math.isfinite(v) and v > 0 for v in numbers), f"non-finite reading in {numbers}")
    for k in ("h2d", "d2h", "both_d2h", "both_h2d", "copies_d2h", "copies_h2d"):
        require(r[k] <= PCIE5_X16_BYTES_PER_S, f"{k} {r[k] / 1e9:.2f} GB/s exceeds the PCIe "
                                               f"Gen5 x16 data sheet's 64 GB/s: impossible")
    for k in ("gemm", "gemm_copies"):
        require(r[k] <= PEAK_FLOPS[torch.bfloat16],
                f"{k} {r[k] / 1e12:.1f} TFLOP/s exceeds the data sheet's 989")


def phase_planner():
    """The port's plan pipeline under H100_SXM and under TPU_V5E, on a
    synthetic training trace of qwen3-4b's layer structure."""
    from repro_torch.core.simulator import H100_SXM, TPU_V5E
    from repro_torch.plan import PlanKey
    from repro_torch.runtime.workload import synthetic_train_trace

    for hw in (H100_SXM, TPU_V5E):
        trace = synthetic_train_trace(n_layers=36, act_bytes=ACT_BYTES,
                                      weight_bytes=LAYER_WEIGHT_BYTES,
                                      flops_per_op=2 * (LAYER_WEIGHT_BYTES // 2) * 2048,
                                      bytes_per_op=LAYER_WEIGHT_BYTES)
        for v in trace.variables:  # the activations are block_in's
            if v.size == ACT_BYTES:
                v.name = "block_in"
        peak = trace.peak_load()
        prog, limits, solve_s, checks, nbytes = plan_and_check(
            trace, PlanKey("qwen3-4b", "train:synthetic", hw.name), hw)
        pools = {m: prog.pool_plans[m].footprint for m in ("best_fit", "first_fit")}
        pools.update({m: prog.baselines[m].footprint for m in ("cnmem", "exact")})
        print(f"[7] plan under {hw.name} (synthetic trace of qwen3-4b's shape: 36 layers, "
              f"weights {LAYER_WEIGHT_BYTES:,} B and activations {ACT_BYTES:,} B a layer; "
              f"not a captured trace): iteration {trace.op_times[-1] * 1e3:.3f} ms simulated, "
              f"peak load w {peak:,} B; pools " + ", ".join(
                  f"{m} {b:,} B ({b / peak:.4f} w)" for m, b in pools.items())
              + f"; solved in {solve_s:.2f}s, verifier ok ({checks} checks), "
                f"round trip byte-equal ({nbytes:,} B)")
        print_swaps(prog, limits, hw.name)


def plan_and_check(trace, key, hw):
    """The plan pipeline on ``trace`` under ``hw``: SmartPool and the baseline
    pools, AutoSwap's four scores at LIMIT_FRACS of the peak load, and
    OffloadLowering; fatal unless the static verifier passes and the
    artifact round-trips byte for byte.  -> (program, limits, solve s,
    verifier checks, artifact bytes)."""
    from repro_torch.analyze import verify_program
    from repro_torch.plan import (MemoryProgram, OffloadLowering, PassContext, Pipeline,
                                  PoolPlacement, SwapSelection, TimingAssign, dumps_canonical,
                                  program_from_json)

    peak = trace.peak_load()
    limits = [int(peak * f) for f in LIMIT_FRACS]
    passes = [TimingAssign(), PoolPlacement(("best_fit", "first_fit", "cnmem", "exact"))]
    passes += [SwapSelection(limit=lim, scorer=s) for lim in limits for s in SCORERS]
    passes += [OffloadLowering(limit=lim, scorer=s) for lim in limits for s in SCORERS]
    t0 = time.perf_counter()
    prog = Pipeline(passes).run(MemoryProgram.from_trace(trace, key), PassContext(hw=hw))
    solve_s = time.perf_counter() - t0
    cert = verify_program(prog)
    require(cert.ok, f"{key}: the verifier failed {cert.failed()}")
    blob = dumps_canonical(prog)
    require(dumps_canonical(program_from_json(json.loads(blob))) == blob,
            f"{key}: the artifact does not round-trip byte for byte")
    return prog, limits, solve_s, len(cert.checks), len(blob)


def print_swaps(prog, limits, hw_name: str) -> None:
    for frac, lim in zip(LIMIT_FRACS, limits):
        cells = []
        for s in SCORERS:
            summary = prog.swap_summaries[f"{s}@{lim}"]
            require(math.isfinite(summary.overhead), f"{hw_name} {s}@{lim}: overhead")
            cells.append(f"{s} {len(summary.decisions)} vars {summary.selected_bytes:,} B "
                         f"overhead {summary.overhead:.4f} stalls {summary.stalls}; offloads "
                         f"{prog.offload_plans[f'{s}@{lim}'].offload_names or 'nothing'}")
        print(f"  limit {frac:.0%} of w ({lim:,} B): " + "; ".join(cells))


def phase_captured_plans(B: int, S: int):
    """The full qwen3-4b train step captured by the port's graph tracer (on
    fake CUDA tensors: no memory, no launch) two ways, each planned under
    H100_SXM: (a) ``model.loss(params, batch)[0]``, the step ``train --plan``
    plans; (b) the loss and ``torch.autograd.grad`` of it with respect to
    the params, under per-layer remat.  Then both run for real at the same
    fp32 masters and batch, which are resident first, and the card's peak
    stands beside the trace's peak load w.  (a)'s w above its real peak is
    fatal: the trace frees each variable at its last use, the earliest any
    run can, so a larger w counts memory that never existed.  (b)'s is
    printed only: eager autograd accumulates the tied embedding's gradient
    in place, where the graph adds out of place (up to one fp32 table,
    151,936 x 2,560 x 4 B)."""
    from repro_torch.configs import get_config
    from repro_torch.core.simulator import H100_SXM
    from repro_torch.core.trace import _leaf_paths, capture_graph, trace_graph
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import build_model
    from repro_torch.plan import PlanKey
    from repro_torch.tree import tree_leaves

    cfg = get_config("qwen3-4b")
    model = build_model(cfg, "cuda")

    def loss(params, batch):
        return model.loss(params, batch)[0]

    def loss_and_grad(params, batch):
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        value = model.loss(params, batch)[0]
        return (value, *torch.autograd.grad(value, leaves))

    shapes = model.init_shapes(torch.float32)
    probe = {k: torch.empty(B, S, dtype=torch.long, device="meta") for k in ("tokens", "labels")}
    omega = {}
    for tag, fn in (("a", loss), ("b", loss_and_grad)):
        t0 = time.perf_counter()
        gm = capture_graph(fn, shapes, probe, device="cuda")
        trace = trace_graph(gm, arg_names=_leaf_paths((shapes, probe)))
        capture_s = time.perf_counter() - t0
        zero = zero_byte_nodes(gm)
        key = PlanKey("qwen3-4b", f"train:b{B}s{S}:{'loss' if tag == 'a' else 'grad'}",
                      H100_SXM.name)
        prog, limits, solve_s, checks, nbytes = plan_and_check(trace, key, H100_SXM)
        peak = trace.peak_load()
        omega[tag] = peak
        labels = {n: sum(v.name == n for v in trace.variables)
                  for n in ("block_in", "attn_out", "ffn_out")}
        print(f"[7] captured ({tag}) {'loss' if tag == 'a' else 'loss + grad (remat)'} qwen3-4b "
              f"B{B} S{S} fp32 masters under {H100_SXM.name}: capture {capture_s:.2f}s, "
              f"{len(trace.variables)} variables (labels {labels}), iteration "
              f"{trace.op_times[-1] * 1e3:.3f} ms simulated, peak load w {peak:,} B; "
              f"SmartPool chi/w {prog.pool_plans['best_fit'].footprint / peak:.4f} "
              f"(first_fit {prog.pool_plans['first_fit'].footprint / peak:.4f}), CnMem "
              f"{prog.baselines['cnmem'].footprint / peak:.4f}, exact "
              f"{prog.baselines['exact'].footprint / peak:.4f}; solved in {solve_s:.2f}s, "
              f"verifier ok ({checks} checks), round trip byte-equal ({nbytes:,} B)")
        print_swaps(prog, limits, H100_SXM.name)
        print(f"  0-byte nodes of the graph (no variable, no event): "
              f"{sum(zero.values())} {dict(zero)}")
        if tag == "a":
            got = (len(trace.variables),
                   tuple(round(prog.swap_summaries[f"swdoa@{lim}"].selected_bytes / 1e9, 2)
                         for lim in limits))
            print(f"  C1: variables and swdoa's GB at {LIMIT_FRACS} of w {got}; the CPU run "
                  f"of the same code under torch 2.13 {CPU_CAPTURE_A}: "
                  f"{'equal' if got == CPU_CAPTURE_A else 'NOT equal'}")

    held = release_memory("7")
    params = model.init(torch.Generator("cuda").manual_seed(0), dtype=torch.float32)
    batch = make_batch_fn(cfg, B, S, 0, "cuda")(0)
    for tag, fn in (("a", loss), ("b", loss_and_grad)):
        gc.collect()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(params, batch)
        torch.cuda.synchronize()
        real = torch.cuda.max_memory_allocated() - held
        value = float((out if tag == "a" else out[0]).detach())
        del out
        for t in tree_leaves(params):
            t.requires_grad_(False)
        print(f"[7] captured ({tag}) run for real: loss {value:.4f}, peak "
              f"{real:,} B on the card ({resident - held:,} B of params and batch resident "
              f"first) beside the trace's w {omega[tag]:,} B (w / peak "
              f"{omega[tag] / real:.4f})")
        require(math.isfinite(value), f"captured ({tag}): non-finite loss")
        if tag == "a":
            require(omega[tag] <= real, f"captured (a): w {omega[tag]} B exceeds the real peak "
                                        f"{real} B")
    del params, batch


# Capture (a) on fake CPU tensors under torch 2.13: variables and the GB
# swdoa selects at LIMIT_FRACS of w (PERF.md §6).
CPU_CAPTURE_A = (2424, (3.68, 7.93, 12.18))


def zero_byte_nodes(gm) -> Counter:
    """The graph's nodes whose tensor outputs hold 0 bytes, by target: what
    the tracer gives no variable (ROADMAP C1)."""
    out: Counter = Counter()
    for node in gm.graph.nodes:
        val = node.meta.get("val")
        vals = [v for v in (val if isinstance(val, (list, tuple)) else [val])
                if isinstance(v, torch.Tensor)]
        if vals and all(v.numel() == 0 for v in vals):
            out[f"{node.op}:{node.target}"] += 1
    return out


def mma_count(build, lib: str, ops: tuple[str, ...]) -> int:
    """Instructions of the SASS of library ``lib`` whose opcode is one of
    ``ops`` (HGMMA: warpgroup MMA; HMMA: warp MMA), by the cuobjdump of the
    toolkit whose nvcc built it."""
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(build.lib_path(lib))],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    return sum(any(re.search(rf"\b{op}\.", line) for op in ops) for line in sass.splitlines())


def template_args(mangled: str) -> str:
    """``<bf16,10,256>`` from the rest of a mangled kernel name after its
    identifier (``I13__nv_bfloat16Li10ELi256EEEv...``), or ``""``."""
    if not mangled.startswith("I"):
        return ""
    args = re.findall(r"(13__nv_bfloat16|(?<=I)f|Li(\d+)E)", mangled.split("EEv")[0] + "E")
    names = [{"13__nv_bfloat16": "bf16", "f": "f32"}.get(a, n) for a, n in args]
    return f"<{','.join(names)}>" if names else ""


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
        kernel = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = next((k + template_args(line[m.end():]) for k in PORT_KERNELS
                               if (m := re.search(rf"{len(k)}{k}", line))), "")
            elif ("registers" in line or "spill" in line or "wgmma" in line.lower()) \
                    and "Function properties" not in line:
                print(f"  {name} {kernel}: {line.strip().removeprefix('ptxas info    : ')}")
    for lib, ops in (("flash_attention_wgmma", ("HGMMA",)),
                     ("flash_attention_bwd_wgmma", ("HGMMA",)),
                     ("ssd_scan_tc", ("HMMA", "HGMMA"))):
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
    def want(rms, flash, ssd, rms_bwd=0, flash_bwd=0):
        return {"rmsnorm": rms, "rmsnorm/vector": rms, "rmsnorm/scalar": 0,
                "rmsnorm_bwd": rms_bwd, "rmsnorm_bwd/vector": rms_bwd, "rmsnorm_bwd/scalar": 0,
                "flash_attention": flash, "flash_attention/wgmma": flash,
                "flash_attention/simt": 0, "flash_attention_bwd": flash_bwd,
                "flash_attention_bwd/wgmma": flash_bwd, "flash_attention_bwd/mma": 0,
                "flash_attention_bwd/simt": 0,
                "ssd_scan": ssd, "ssd_scan/tc": ssd, "ssd_scan/simt": 0}

    serve_want = {"qwen3-4b": (512, want((4 * 36 + 1) * 32, 36, 0)),
                  "mamba2-370m": (2048, want((2 * 48 + 1) * 32, 0, 48))}
    paths, served = {}, {}
    for arch, (P, counts) in serve_want.items():
        paths[f"serve {arch}"], *served[arch] = phase_serve(arch, 4, P, 32, counts)
    phase_profile("qwen3-4b", 4, 512, 32)
    phase_profile("mamba2-370m", 4, 2048, 32)
    t7 = time.perf_counter()
    phase_link_and_compute()
    phase_planner()
    phase_captured_plans(4, 512)
    print(f"[7] planner phase took {time.perf_counter() - t7:.1f}s")

    phase_train_parity(128)
    # A train step of qwen3-4b under per-layer remat runs each layer's forward
    # twice (the step's, then its recompute in backward) and the final norm
    # once: RMSNorm forward 2 * 4 * 36 + 1 (ln1, ln2, q-norm, k-norm), flash
    # forward 2 * 36, and each backward once: RMSNorm 4 * 36 + 1, flash 36.
    # bf16 with 16-byte rows at head dim 128: every RMSNorm launch is
    # `vector` both ways, every flash forward and backward `wgmma`.
    steps = 5
    train_want = want((2 * 4 * 36 + 1) * steps, 2 * 36 * steps, 0, (4 * 36 + 1) * steps,
                      36 * steps)
    paths["train qwen3-4b"], plain_losses, plain_peak, plain_ms, _ = phase_train(
        4, 512, steps, train_want)
    plain_prof = phase_train_profile(4, 512)

    # Phase 11: the same training under AutoSwap's offload plan at half the
    # traced loss's w, which must launch every kernel as often as plain remat
    # does, give the same losses, and move each offloaded label of each of
    # the 36 layers once each way a step.
    gb, plan = phase_offload_plan(4, 512)
    counts, losses, peak, step_ms, text = phase_train(
        4, 512, steps, train_want, extra=("--hbm-limit-gb", str(gb), "--plan-cache",
                                          str(PLAN_DIR)),
        phase="11", what=f"remat, offloading {plan.offload_names}")
    paths["train qwen3-4b (offload)"] = counts
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    per_step = 36 * len(plan.offload_names) * ACT_BYTES
    d2h, h2d = (json.loads(m) for m in re.search(
        r"\[offload\] bytes a step to host (\[[0-9, ]*\]), back (\[[0-9, ]*\])", text).groups())
    print(f"[11] offload against phase 9: largest relative loss difference {rel:.3e} "
          f"({'equal bits' if losses == plain_losses else 'not equal bits'}); bytes a step to "
          f"host {d2h}, back {h2d} (want {per_step:,} each); peak {peak / 1e9:.2f} GB against "
          f"{plain_peak / 1e9:.2f} GB; host ms a step {step_ms} against {plain_ms}")
    require("(restored from cache)" in text, "offload: train.main did not restore the plan")
    require(rel <= 1e-6, f"offload: losses {losses} against {plain_losses}")
    require(d2h == h2d == [per_step] * steps, f"offload: bytes {d2h}, {h2d}; want {per_step}")
    phase_offload_memory(4, 512, plan.offload_names)
    prof = phase_train_profile(4, 512, plan.policy(), phase="11")
    print(f"[11] traced step with the plan against phase 10's: untraced {prof['untraced_ms']:.1f} "
          f"against {plain_prof['untraced_ms']:.1f} ms, compute busy {prof['compute_ms']:.2f} "
          f"against {plain_prof['compute_ms']:.2f} ms, copies {prof['copy_ms']:.3f} ms "
          f"({prof['overlap_ms']:.3f} beside compute) against {plain_prof['copy_ms']:.3f} ms")

    # Phase 12: the serving steps planned, restored and co-located with the
    # train step of phase 11's plan cache; serving with planning launches
    # every kernel as phase 5 does and gives its tokens.
    t12 = time.perf_counter()
    for arch, (P, counts) in serve_want.items():
        paths[f"serve {arch} (planned)"] = phase_serve_plans(arch, 4, P, 32, counts,
                                                             *served[arch])
    phase_colocate(4, 512, 32, 512)
    print(f"[12] serve plans phase took {time.perf_counter() - t12:.1f}s")

    # The backward kernels replace no Pallas kernel of their own: each is the
    # gradient of the TPU kernel named, which the reference takes by XLA
    # autodiff of its jnp paths.
    srcs = {"rmsnorm": "src/repro/kernels/rmsnorm.py:25",
            "flash_attention": "src/repro/kernels/flash_attention.py:99",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:65",
            "rmsnorm_bwd": "src/repro/kernels/rmsnorm.py:25",
            "flash_attention_bwd": "src/repro/kernels/flash_attention.py:99"}
    kernels = []
    for name, main_case in ((n, cases[n][0]) for n in srcs):
        by_path = {path: counts[name] for path, counts in paths.items()}
        launches = sum(by_path.values())
        require(launches > 0, f"{name} was not launched on a main path")
        var = main_case["variant"]
        source = name if var in ("vector", "simt") else f"{name}_{var}"
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{source}.cu",
            "replaces": srcs[name], "launches": launches,
            "max_abs_err": main_case["max_abs_err"], "ms": main_case["ms"],
            "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"], "library_ms": main_case["library_ms"],
            "variant": var, "launches_by_path": by_path, "check": main_case["check"],
        })
        if main_case.get("other"):  # the earlier variant's ms on the same inputs
            kernels[-1][f"{main_case['other'][0]}_ms"] = main_case["other"][1]
    # The train path runs the flash forward's LSE instantiation (phase 9:
    # 72 of a step's launches); its case at the same shape stands beside
    # the serving one.
    lse = cases["flash_lse"][0]
    next(k for k in kernels if k["name"] == "flash_attention").update(
        lse_ms=lse["ms"], lse_plain_ms=lse["plain_ms"], lse_bound_ms=lse["bound_ms"],
        lse_library_ms=lse["library_ms"], lse_max_abs_err=lse["max_abs_err"],
        lse_check=lse["check"])
    summary = [f"{k['name']} launches={k['launches']} "
               f"({', '.join(f'{p} {n}' for p, n in k['launches_by_path'].items())}) "
               f"parity=ok ({len(cases[k['name']])} cases)" for k in kernels]
    print("kernels: " + "; ".join(summary))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
