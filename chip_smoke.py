#!/usr/bin/env python3
"""Drive the PyTorch port (``repro_torch``) on one NVIDIA GPU and check it.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one CUDA
card and nvcc (CUDA_HOME or PATH); it imports the port from ``src/`` and
nothing of JAX or of the JAX package.  Phases, each fatal on failure:

  1. device   the card's name and power limit (nvidia-smi);
  2. build    the ten kernel libraries compiled from
              ``src/repro_torch/kernels/csrc``, one nvcc each, in parallel,
              with ptxas's register and spill report by kernel, and the
              count of tensor-core instructions in the SASS of the four
              tensor-core libraries, none of which may be 0: HGMMA
              (warpgroup MMA) in the wgmma flash forward and backward
              libraries, HMMA or HGMMA in the tc SSD forward and backward
              libraries;
  3. kernels  ``torch.library.opcheck`` of the seven ``repro_torch``
              operators on CUDA tensors at a small shape (schema, autograd
              registration, the fake implementation against the kernel's
              outputs, AOT dispatch); then each CUDA kernel, called
              through its operator, against its plain PyTorch version on
              the card, at the main paths' shapes and a few edge cases, timed beside
              its bound and a library call that computes the same function
              (none computes the SSD scan; a window is SDPA's boolean band
              mask); each case names the variant
              that ran and checks that it was that one (rmsnorm:
              ``vector``, or ``scalar`` where D or alignment rules out
              16-byte vectors; flash: ``wgmma`` for bf16 at head dim 64,
              128 or 256, ``simt`` the rest; SSD: ``tc`` for bf16 with P and N
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
              flash forwards with the LSE written; the flash rows include
              starcoder2-7b's prefill (causal, 36 query heads on 4 kv heads)
              and whisper-large-v3's encoder (unmasked, S 1500, which the
              128-key tiles pad), its cross attention (unmasked, Sq 128
              against Sk 1500) and its decoder's causal self attention; at
              whisper's two unmasked shapes a probe of the padded keys that
              no bf16 tolerance could miss (v's ones columns must come out
              1 within one bf16 step, the softmax mass on the partial last
              tile must match the plain version's); and the head-dim-256
              rows of gemma3-4b's prefill (B4 S2048 H8 KV4, global and with
              its window of 1024) and gemma2-9b's (B4 S512 H16 KV8, softcap
              50, scale 224^-0.5, and its window of 4096 at B1 S8192), with
              the simt kernel, which ran that head dim before, timed beside
              each on the same inputs, the LSE case at hd 256, and the
              padding probe at 1100 keys (17 tiles of 64 and one of 12);
              and qwen2-vl-7b's prefill (B4 S520 H28 KV4 hd128 causal: 8
              patches before a prompt of 512, groups of 7, a last 128-row
              tile of 8 rows) with its RMSNorm rows [2080, 3584] and
              [4, 3584];
  4. parity   qwen3-4b's, mamba2-370m's, deepseek-v2-lite-16b's,
              hymba-1.5b's, starcoder2-7b's, whisper-large-v3's, gemma3-4b's
              gemma2-9b's and qwen2-vl-7b's widths in fp32 (one layer of
              each program
              segment,
              or the one segment's unit twice: deepseek's dense layer, then an
              MoE layer; hymba's five hybrid layers, global and window in
              turn, at prompt 1100, which wraps the window's ring and pads
              the SSD; whisper's two encoder and two decoder layers over the
              full 1500 frames; each gemma's window layer, then a global
              one, gemma3 at prompt 1100, which wraps its ring of 1024,
              gemma2 at 256; qwen2-vl's two layers over 8 patches and 256
              text tokens, at M-RoPE positions whose channels differ:
              patch i at (t, h, w) = (0, i // 4, i % 4), text token j at
              its own index in all three, decode after them): prefill + 4
              decode steps through the kernels on the
              card against the plain path on the CPU, logits and every
              layer's cache (whisper's cross K/V too), and at each MoE call the routing equal (expert
              ids and ranks), its smallest top-k margin above NEAR_TIE
              times the card's and the CPU's largest router probability
              difference (the tokens within 1e-4 counted);
  5. serve    ``repro_torch.launch.serve.main`` on the full qwen3-4b (36
              layers, bf16, random weights) at batch 4, prompt 512, 32 tokens,
              on the full mamba2-370m (48 layers) at batch 4, prompt 2048,
              32 tokens, and on the full deepseek-v2-lite-16b (27 layers: MLA,
              one dense FFN, 26 MoE FFNs of 64 experts top-6) at batch 4,
              prompt 512, 32 tokens, and on the full hymba-1.5b (32 hybrid
              layers: attention, 29 of them with a window of 1024, beside a
              Mamba-2 mixer) at batch 4, prompt 2048, 32 tokens, with its
              cache's bytes by kind beside the arithmetic, on the full
              starcoder2-7b (32 layers: LayerNorm, GELU FFN) at batch 4,
              prompt 512, 32 tokens, and on the full whisper-large-v3 (32
              encoder and 32 decoder layers) at batch 4, 1500 frames,
              prompt 128, 32 tokens, with its self and cross caches' bytes
              beside the arithmetic, on the full gemma3-4b (34 layers, 29
              of them with a window of 1024, sandwich norms, qk-norm) at
              batch 4, prompt 2048, 32 tokens, and on the full gemma2-9b (42
              layers, window 4096 in every other one, softcap 50) at batch
              4, prompt 512, 32 tokens, each with its cache's bytes beside
              the arithmetic, and on the full qwen2-vl-7b (28 layers, M-RoPE,
              8 patch embeddings before the prompt) at batch 4, prompt 512,
              32 tokens, with its cache of 1568 slots (512 + 32 + 1024
              patch tokens, the reference's) beside the arithmetic; with
              the kernels'
              launch counts set to 0
              just before each run and read just after it, exactly, by
              variant (every flash launch ``wgmma``, every SSD launch
              ``tc``, every RMSNorm launch ``vector``; none for the two
              LayerNorm models; no ``simt`` launch on any path), and the decode ms a step; the memory that earlier phases hold is dropped first,
              and what is still held is printed, so the peak is the serve's
              own, beside the weights' bytes;
  6. profile  where the time goes: each served model's prefill and decode
              steps, warm, timed untraced (16 decode steps) and then traced
              with torch.profiler (prefill and TRACED_DECODE_STEPS decode
              steps; the top kernels, and each of the port's own kernels by name:
              the tc SSD is two, its C B^T prepass and the scan; the device
              time by op, the port's ``repro_torch`` operators among them;
              for deepseek the MoE dispatch's ops (found by their input
              shapes) against its expert GEMMs; hymba's, starcoder2's, whisper's
              and the gemmas' and qwen2-vl's too, whisper's encoder also
              timed alone; the seconds each part of the phase took, the
              profiler's parse included);
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
              under ``TPU_V5E``; then the qwen3-4b train step (B4 S512,
              fp32 masters) captured by the port's graph tracer on fake
              tensors, (a) the full model's loss and (b) the loss with its
              gradient under remat of a 12-layer cut at every width, each
              planned under ``H100_SXM`` and run
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
              update; ``phase_train_parity``, which phase 16 (a) runs on
              deepseek-v2-lite-16b's widths);
  9. train    ``repro_torch.launch.train.main`` on the full qwen3-4b (36
              layers, fp32 masters, bf16 compute, per-layer remat, chunked
              loss, AdamW) at batch 4, seq 512, 5 steps, after the memory
              of earlier phases is dropped: finite losses, step times,
              tokens/s, the peak beside the 64.36 GB of fp32 state and
              under the card's memory, and exact launch counts by variant;
 10. profile  a warm train step timed, then traced (top kernels, the port's
              kernels by name, the device's idle share), then timed in two
              parts with CUDA events (the loss with its backward, then
              ``adamw_step``);
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
 12. serve plans  ``serve.main --plan --plan-cache`` on phase 5's nine cells:
              launch counts by variant and greedy tokens equal to phase 5's
              (planning launches nothing; decode takes 0-d device positions),
              each step's vars, w, chi/w and AutoSwap@80%; w against the
              card's real peak around one warm call with the params resident
              (w above it fails), the decode step of phase 4's depth cut
              traced at two positions (its events equal), the verifier and
              the artifact's round trip,
              and a second run that restores both plans; then
              ``launch.colocate`` with prefill, decode@2.0 and train tenants
              of qwen3-4b, every plan restored (train's from phase 11),
              with its per-tenant report and ``--verify`` certificates;
 13. cnn      the paper's own networks (§VI) at CIFAR-10's 32x32 in fp32,
              after the memory of earlier phases is dropped: vgg11,
              resnet18 and resnet50 at batch 2 on the card against the CPU
              (fp32 logits and loss, remat's gradient against the plain
              one on the card; fp64 gradients and one ``train_step``'s
              params and momentum; each under PARITY_TOL); then vgg16 and
              resnet50 at batch 100 (Tables I and II) and 200 (Fig. 10's
              largest): each SGD step traced by ``cnn_trace``, plain and
              with memonger's segmented remat, and planned under
              ``H100_SXM`` (variables, w, SmartPool chi/w, CnMem/w, the
              zero-overhead reduction of Table II, the memonger row; the
              verifier and the round trip fatal); then 3 ``train_step``s
              on the card at lr 1e-5 (finite losses, ms a step), and around
              one warm step of each kind the real peak beside w (w above it
              fails), the largest blocks live at that peak, and the caching
              allocator's reserved peak beside SmartPool's and CnMem's
              footprints.  The phase launches none of the
              port's kernels (cuDNN and cuBLAS run the CNNs), which the
              counters must show;
 14. long decode  hymba-1.5b's long_500k cell: ``Model.init_cache(1, 524288)``
              on the card, its bytes by kind (3 global caches, 29 rings of
              1024, the SSM states and conv tails) against the arithmetic and
              the allocator's count, then 4 decode steps at its last
              positions: exact launch counts, finite logits, ms a step, the
              peak;
 15. example  ``examples/serve_batched_torch.py`` on the card: three smoke
              models, each served twice, the tokens equal.

 16. train deepseek  deepseek-v2-lite-16b trained at every published width
              (64 experts top-6, 2 shared, MLA with kv_lora 512, vocab
              102,400, the untied head), each part after the memory of the
              earlier ones is dropped:
              (a) one train step of its dense layer and one MoE layer in
              fp32 (B1 S128) on the card against the CPU, as phase 8, with
              the aux loss, and the routing of the MoE call equal on the
              two sides, its smallest top-k margin above NEAR_TIE times
              their largest router probability difference;
              (b) the dense layer and MOE_LAYERS MoE layers (3,424,678,912
              parameters, 54.79 GB of fp32 state) through the training
              launcher's own loop (``train.train``) at B4 S512 for 5
              steps: finite losses with ce and aux, ms a step, tokens/s,
              the peak beside the
              state's arithmetic and under the card's memory, exact launch
              counts by variant (RMSNorm 37 forward and 19 backward a step,
              all ``vector``; no flash, no SSD);
              (c) a warm step timed, traced (top kernels, the port's
              kernels, the idle share; the MoE dispatch's forward and
              backward ops against the expert GEMMs; MLA's dense softmax
              path) and timed in two parts, the loss with its backward and
              ``adamw_step``;
              (d) the loss, and the loss with its gradient under remat,
              traced on fake tensors and planned under H100_SXM (w,
              SmartPool chi/w, CnMem/w; the verifier and the artifact's
              round trip fatal), each beside the real peak around one warm
              call (the loss's w above it fails); then the training launcher's plan at
              half the loss's w, rounded down to 0.01 GiB, which must name
              a label, executed for (b)'s steps, seed and batches: losses
              within 1e-6 relative of (b)'s, the same launch counts, and
              exactly the layers x the names x one bf16 activation moved
              each way a step;
              (e) determinism: (a)'s gradients bit for bit in a second run
              on the card, and the routing of every MoE layer's recompute
              in backward equal to its forward's, under remat in (a) and
              (b) and under the offload policy in (d).
 17. checkpoint  fault-tolerant training (``repro_torch.checkpoint``,
              ``train.train(ckpt_dir=, ckpt_every=)``):
              (a) a qwen3-4b cut of 2 layers at every published width
              (590,820,352 parameters, 7,089,844,224 B a checkpoint: masters,
              m and v) at B4 S512, 8 steps, after a check of the disk's free
              space for three checkpoints: U uninterrupted, F saving async at
              step 4 and failing at step 6 (injected), R relaunched, resuming
              at step 5 and saving at step 7; F's and R's losses equal to
              U's bit for bit, R's resume line, the last checkpoint restored
              onto CPU tensors equal to U's final masters, m and v bit for
              bit with count 8, its bytes the arithmetic, the directory
              holding steps 4 and 7 and no ``.tmp``, exact launch counts by
              variant a step in each run; the snapshot's blocking ms, each
              save's seconds, the restore's, and the step with a save in
              flight beside the median;
              (b) ``examples/train_100m_torch.py`` (fp32) with ``--steps
              60`` and then ``--steps 70`` in the same directory, which must
              resume at step 60; exact launch counts (flash ``simt``).
 18. train mamba2  mamba2-370m trained at every published width, all 48
              layers (368,338,432 parameters, 5,893,414,912 B of fp32
              state), each part after the memory of the earlier ones is
              dropped:
              (a) the SSD scan's backward kernels (``ssd_scan_bwd``, the
              variant ``bwd_variant`` names) against their plain version on
              the card: ``tc`` at mamba2's training layout (x [4, 2048, 32,
              64], B and C [4, 2048, 1, 128], bf16 views into one tensor; a
              second call bit for bit), a ragged length of 1000, two groups
              over 8 heads at N 16, a nonzero final-state cotangent, and P =
              N = 128, each with ``simt`` timed on the same inputs; ``simt``
              on fp32 dense [1, 512, 32, 64], a ragged length of 1000, a
              nonzero final-state cotangent and P = N = 128; each output
              relative to its max under SSD_TOL, timed beside its bound and
              the plain backward;
              (b) one train step of two Mamba-2 layers in fp32 (B1 S300,
              which pads to two chunks of 256) on the card against the CPU,
              as phase 8;
              (c) the 48 layers through ``train.train`` at B4 S2048 for 5
              steps: finite losses, ms a step, tokens/s, the peak beside the
              state's arithmetic, exact launch counts by variant (a step:
              SSD 96 forward and 48 backward ``tc``, RMSNorm 193 forward and
              97 backward ``vector``); a warm step profiled (the SSD
              backward's share, the idle share);
              (d) the loss step ``train --plan`` plans, traced and planned
              under H100_SXM, its w beside the real peak of the loss run at
              resident masters (above it fails), AutoSwap's plan at half w
              (or a quarter, an eighth, until a label is named) executed for
              (c)'s steps, seed and batches: losses equal to (c)'s bit for
              bit, the same launch counts, and the bytes each way a step
              exactly 48 x the names x one [4, 2048, 1024] bf16 activation.
 19. train hymba  hymba-1.5b trained at every published width, all 32
              hybrid layers (1,589,773,120 parameters, 25,436,369,920 B of
              fp32 state), each part after the memory of the earlier ones
              is dropped:
              (a) the flash backward with a window against its plain
              version: ``wgmma`` at hymba's layout (B4 S2048 H25 KV5 hd64,
              window 1024, with ``simt`` timed on the same inputs), a
              ragged length (S 1000, window 300), a window below a tile
              (16), a window of at least S (equal to the causal call bit for
              bit) and hd 128 with a window, each bit for bit across two
              calls and with the ``mma`` yardstick held to the same plain
              version; ``simt`` in fp32 at the same cases, smaller; the
              forward with the LSE at hymba's window layout; each timed
              beside its bound and SDPA's (band mask) backward;
              (b) one train step of its five segments' layers in fp32 (B1
              S1100, past the window) on the card against the CPU, as
              phase 8 (the ``simt`` backward with a window);
              (c) the 32 layers through ``train.train`` at B4 S2048 for 5
              steps: finite losses, ms a step, tokens/s, the peak beside
              the state's arithmetic, exact launch counts by variant (a
              step: RMSNorm 321 forward and 161 backward ``vector``, flash
              64 forward and 32 backward ``wgmma``, SSD 64 forward and 32
              backward ``tc``); a warm step profiled;
              (d) as 18 (d), for hymba: losses equal to (c)'s bit for bit,
              the same launch counts, the bytes each way a step exactly 32 x
              the names x one [4, 2048, 1600] bf16 activation.
 20. train whisper  whisper-large-v3 trained at every published width, all
              32 encoder and 32 decoder layers (1,535,219,200 parameters,
              24,563,507,200 B of fp32 state), each part after the memory
              of the earlier ones is dropped, each part's seconds printed:
              (a) the flash backward of unmasked attention against its
              plain version: ``wgmma`` at whisper's encoder layout (B4
              S1500 H20 KV20 hd64), its cross attention's (448 queries
              against 1500 keys), Sq > Sk (B2 Sq700 Sk300) and GQA at hd 128
              (B1 S1100 H16 KV4), each bit for bit across two calls, with
              ``simt`` and the ``mma`` yardstick timed on the same inputs
              (``mma`` held to the plain version too); the causal backward
              at the decoder's B4 S448; ``simt`` in fp32 at the unmasked
              cases, smaller; the unmasked forward with the LSE at the
              encoder's and the cross layouts; each timed beside its bound
              and SDPA's unmasked backward;
              (b) one train step of two encoder and two decoder layers in
              fp32 over all 1500 frames (standard normal from seed 0) at
              decoder S 300 on the card against the CPU, as phase 8 (the
              ``simt`` backward, unmasked and causal);
              (c) the 64 layers through ``train.train`` at B4, decoder S
              448 (whisper's text context), 1500 zero frames, 5 steps:
              finite losses, ms a step, decoder tokens/s and frames/s, the
              peak beside the state's arithmetic, exact launch counts by
              variant (a step: flash 160 forward and 96 backward
              ``wgmma``, no RMSNorm, no SSD); a warm step profiled (the
              flash backward's share, the idle share, the top ops);
              (d) as 18 (d), for whisper: losses equal to (c)'s bit for
              bit, the same launch counts, the bytes each way a step
              exactly 32 x the names x one [4, 448, 1280] bf16 activation.

The last lines are a ``kernels`` summary, a JSON object of per-kernel
numbers (``launches`` summed over the main paths, the serve runs, plain
and planned, the train runs, plain and with the offload plan, the CNN
phase, the long decode, the example, deepseek's train runs, phase 17's
runs, mamba2's, hymba's and whisper's train runs, with each path's own
count in ``launches_by_path``; the flash backward's entry also holds
hymba's window case and whisper's unmasked encoder and cross cases, the
forward's the LSE with the window and unmasked), the nvidia-smi line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import io
import json
import math
import os
import re
import shutil
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


def keep_mask(Sq, Sk, causal, window) -> np.ndarray:
    """[Sq, Sk] bool: the (q, k) pairs that attention keeps, by absolute
    positions from 0, as the kernels mask them."""
    q = np.arange(Sq)[:, None]
    k = np.arange(Sk)[None, :]
    keep = np.ones((Sq, Sk), bool)
    if causal:
        keep &= q >= k
    if window is not None:
        keep &= q - k < window
    return keep


def live_pairs(Sq, Sk, causal, window) -> int:
    return int(keep_mask(Sq, Sk, causal, window).sum())


def flash_case(B, Sq, Sk, H, KV, hd, dtype, gen, causal=True, window=None, softcap=None,
               scale=None):
    """bf16 cases hold the wgmma variant, which rounds P to bf16 before P.V,
    to the plain version, which keeps P in fp32, at the bf16 tolerance.  At
    head dim 256, which the simt kernel ran before the wgmma kernel took it,
    the simt kernel is timed beside it on the same inputs (through
    ``_launch``, counting no launch)."""
    from repro_torch.kernels.flash_attention import (_launch, flash_attention,
                                                     flash_attention_plain, variant)

    q = torch.randn((B, Sq, H, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Sk, KV, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Sk, KV, hd), generator=gen, device="cuda").to(dtype)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    var = variant(dtype, hd)

    def op(q, k, v):
        return torch.ops.repro_torch.flash_attention(q, k, v, causal, window, softcap, scale)

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
    keep = keep_mask(Sq, Sk, causal, window)
    flops = 4 * hd * B * H * int(keep.sum())
    b_ms, b_by = bound(nbytes, flops, dtype)
    lib_ms = None
    # One library call computes the same function where there is no softcap
    # and every row keeps a key (SDPA gives NaN where the kernels give 0): a
    # window is SDPA's boolean band mask.
    if not softcap and keep.any(1).all():
        band = torch.from_numpy(keep).cuda() if window is not None else None

        def sdpa(q, k, v):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=band,
                is_causal=causal and band is None, scale=scale, enable_gqa=True)
        lib_ms = time_ms(sdpa, sets, 20)
    other = None
    if var == "wgmma" and hd == 256:
        # Where a row keeps no key, its output follows the kernel's tile (the
        # simt kernel's is 32 rows), so the two agree only where every row
        # keeps one.
        if keep.any(1).all():
            simt_ok, simt_excess, _ = close(_launch("simt", q, k, v, **kw), want, tol)
            require(simt_ok, f"flash [simt] B{B} Sq{Sq} hd{hd}: {simt_excess:.3e} beyond {tol:g}")
        other = ("simt", time_ms(lambda *a: _launch("simt", *a, **kw), sets, 10))
    name = (f"flash [{var}] B{B} Sq{Sq} Sk{Sk} H{H} KV{KV} hd{hd} {str(dtype)[6:]}"
            f"{' causal' if causal else ''}{f' window={window}' if window else ''}"
            f"{f' softcap={softcap}' if softcap else ''}"
            f"{f' scale={scale:.6f}' if scale else ''} "
            f"(error relative to max|want|: {rel:.2e})")
    return {
        "case": name, "variant": var, "max_abs_err": err, "check": check, "ok": ok,
        "ms": time_ms(op, sets, 20),
        "plain_ms": time_ms(lambda *a: flash_attention_plain(*a, **kw), sets, 3),
        "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by, "other": other,
    }


ONE_BF16_STEP = 2.0 ** -8  # the spacing of bf16 just below 1


def flash_padding_probe(B, Sq, Sk, H, KV, hd, gen):
    """The wgmma kernel's padded keys, unmasked, at an Sk that is not a
    multiple of its key tile, held where a fault cannot hide inside the bf16
    tolerance.  q and k are random, so the logits have a standard deviation
    of about 1.  v's first half of columns is all ones: every output there is
    a softmax's sum of weights, 1, and must come out within one bf16 step of
    it (a padded key that took weight would pull it down by that key's share,
    about 1.5% at Sk 1500).  v's second half is one on the keys of the last,
    partial tile and zero elsewhere: the output there is the softmax mass on
    those keys, about their share of Sk, and must agree with the plain
    version to 2e-2 of its largest value (a kernel that skipped or misread
    the partial tile would be off by all of it).  The key tile is the
    kernel's at this head dim (``block_shape``: 128 keys, 64 at hd 256)."""
    from repro_torch.kernels.flash_attention import (block_shape, flash_attention,
                                                     flash_attention_plain)

    q = torch.randn((B, Sq, H, hd), generator=gen, device="cuda").bfloat16()
    k = torch.randn((B, Sk, KV, hd), generator=gen, device="cuda").bfloat16()
    key_tile = block_shape(torch.bfloat16, hd)[1]
    tail = Sk - (Sk % key_tile or key_tile)
    v = torch.zeros((B, Sk, KV, hd), device="cuda", dtype=torch.bfloat16)
    v[..., : hd // 2] = 1
    v[:, tail:, :, hd // 2:] = 1
    before = flash_attention.variant_launches["wgmma"]
    got = torch.ops.repro_torch.flash_attention(q, k, v, False, None, None, None).float()
    want = flash_attention_plain(q, k, v, causal=False).float()
    torch.cuda.synchronize()
    require(flash_attention.variant_launches["wgmma"] == before + 1,
            f"flash padding probe Sq{Sq} Sk{Sk} did not launch the wgmma kernel")
    ones_err = (got[..., : hd // 2] - 1).abs().max().item()
    mass_got, mass_want = got[..., hd // 2:], want[..., hd // 2:]
    mass_rel = ((mass_got - mass_want).abs().max() / mass_want.abs().max()).item()
    ok = ones_err <= ONE_BF16_STEP and mass_rel <= TOL[torch.bfloat16]
    print(f"  flash [wgmma] key padding B{B} Sq{Sq} Sk{Sk} H{H} KV{KV} hd{hd} bfloat16 (keys "
          f"{tail}..{Sk - 1} in the last tile of {key_tile}, {-Sk % key_tile} padded): v = 1 "
          f"columns "
          f"max|got - 1| {ones_err:.3e} <= {ONE_BF16_STEP:.3e}; last tile's softmax mass "
          f"{mass_want.mean().item():.4f} on average, max|got-want| / max|want| "
          f"{mass_rel:.3e} <= {TOL[torch.bfloat16]}: {'ok' if ok else 'FAILED'}")
    require(ok, f"flash wgmma key padding at Sq{Sq} Sk{Sk}: ones columns off by {ones_err:.3e}, "
                f"last tile's mass off by {mass_rel:.3e} of its largest value")


def flash_lse_case(B, S, H, KV, hd, dtype, gen, window=None, causal=True, Sk=None):
    """Flash with the LSE written (as training runs it), causal with
    ``window`` where given or unmasked (``causal=False``, ``Sk`` keys, S by
    default), against the plain version's output and LSE; the LSE at fp32's
    tolerance in either type, since both sum fp32 scores of the same
    inputs.  A window's library call is SDPA with its boolean band mask."""
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_plain,
                                                     variant)

    Sk = Sk or S
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Sk, KV, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Sk, KV, hd), generator=gen, device="cuda").to(dtype)
    var = variant(dtype, hd)

    def op(q, k, v):
        return torch.ops.repro_torch.flash_attention_lse(q, k, v, causal, window, None, None)

    before = flash_attention.variant_launches[var]
    (out, lse), (out_want, lse_want) = (op(q, k, v),
                                        flash_attention_plain(q, k, v, causal=causal,
                                                              window=window, return_lse=True))
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
    b_ms, b_by = bound(nbytes, 4 * hd * B * H * live_pairs(S, Sk, causal, window), dtype)
    band = torch.from_numpy(keep_mask(S, Sk, causal, window)).cuda() if window else None

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), attn_mask=band,
                                              is_causal=causal and band is None, enable_gqa=True)

    return {
        "case": f"flash+lse [{var}] B{B} S{S}{f' Sk{Sk}' if Sk != S else ''} H{H} KV{KV} hd{hd} "
                f"{str(dtype)[6:]} {'causal' if causal else 'unmasked'}"
                f"{f' window={window}' if window else ''} (max_abs_err of the LSE)",
        "variant": var, "max_abs_err": err, "ok": ok,
        "check": f"LSE {lse_check}; output {out_check}",
        "ms": time_ms(op, sets, 20),
        "plain_ms": time_ms(lambda *a: flash_attention_plain(*a, causal=causal, window=window,
                                                             return_lse=True), sets, 3),
        "library_ms": time_ms(sdpa, sets, 20), "bound_ms": b_ms, "bound_by": b_by,
    }


def flash_bwd_case(B, Sq, H, KV, hd, dtype, gen, want_variant, window=None, yardstick="mma",
                   causal_bits=False, causal=True, Sk=None, also=None):
    """flash_attention_bwd against flash_attention_bwd_plain on the same q, k,
    v, dO and the kernel forward's o and LSE, causal with ``window`` where
    given, or unmasked (``causal=False``) with ``Sk`` keys (Sq by default):
    dq, dk and dv at the dtype's tolerance.  A wgmma case must also give
    equal bits in two runs, and the mma kernel (the variant it replaced,
    through ``_launch_bwd``, counting no launch) is held to the same plain
    version at the same tolerance; ``yardstick`` (mma, or simt), and
    ``also`` where given, are timed beside it on the same inputs.
    ``causal_bits``: the window reaches past every row, and the result must
    equal the causal call's bit for bit.  The library call is SDPA's
    backward (a window: its boolean band mask)."""
    from repro_torch.kernels.flash_attention import (_launch_bwd, bwd_variant, flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_bwd_plain)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    Sk = Sk or Sq
    q, k, v, do = randn(B, Sq, H, hd), randn(B, Sk, KV, hd), randn(B, Sk, KV, hd), \
        randn(B, Sq, H, hd)
    o, lse = flash_attention(q, k, v, causal=causal, window=window, return_lse=True)
    var = bwd_variant(o, do)
    mask = "causal" if causal else "unmasked"
    tag = (f"flash_bwd B{B} Sq{Sq} Sk{Sk} hd{hd} {dtype} {mask}"
           f"{f' window={window}' if window else ''}")
    require(var == want_variant, f"{tag} routes to {var}, want {want_variant}")

    def op(*args, window=window):
        return torch.ops.repro_torch.flash_attention_bwd(*args, causal, window, None, None)

    before = flash_attention_bwd.variant_launches[var]
    got, want = (op(q, k, v, o, do, lse),
                 flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal, window=window))
    torch.cuda.synchronize()
    require(flash_attention_bwd.variant_launches[var] == before + 1,
            f"{tag} did not launch the {var} kernel")
    if var == "wgmma":
        again = op(q, k, v, o, do, lse)
        require(all(torch.equal(a, g) for a, g in zip(again, got)), f"{tag} [wgmma]: two runs differ")
    if causal_bits:
        no_window = op(q, k, v, o, do, lse, window=None)
        require(all(torch.equal(a, g) for a, g in zip(no_window, got)),
                f"{tag} [{var}]: differs from the causal result")
    tol = TOL[dtype]
    checks = [close(g, w, tol) for g, w in zip(got, want)]
    ok = all(c[0] for c in checks)
    check = "; ".join(f"{n} {c[2]}" for n, c in zip(("dq", "dk", "dv"), checks))
    mma_check = ""
    if var == "wgmma":
        mma = [close(g, w, tol) for g, w in
               zip(_launch_bwd("mma", q, k, v, o, do, lse, hd**-0.5, window, causal), want)]
        mma_check = "; mma max excess " + ", ".join(f"{c[1]:.2e}" for c in mma)
        require(all(c[0] for c in mma), f"{tag} [mma]: " +
                "; ".join(f"{n} {c[2]}" for n, c in zip(("dq", "dk", "dv"), mma)))
    errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
    rels = [e / w.float().abs().max().item() for e, w in zip(errs, want)]
    args = (q, k, v, o, do, lse)
    nbytes = sum(t.numel() * t.element_size() for t in args) + \
        (q.numel() + 2 * k.numel()) * q.element_size()
    sets = copies(args, nbytes)
    b_ms, b_by = bound(nbytes, 10 * hd * B * H * live_pairs(Sq, Sk, causal, window), dtype)
    band = torch.from_numpy(keep_mask(Sq, Sk, causal, window)).cuda() if window else None

    def sdpa(q, k, v, o, do, lse):
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                             v.transpose(1, 2), attn_mask=band,
                                             is_causal=causal and band is None, enable_gqa=True)
        return out, (q, k, v), do.transpose(1, 2)

    def timed(name):
        return name, time_ms(lambda *a: _launch_bwd(name, *a, hd**-0.5, window, causal), sets, 10)

    other = timed(yardstick) if var == "wgmma" else None
    return {
        "case": f"flash_bwd [{var}] B{B} S{Sq}{f' Sk{Sk}' if Sk != Sq else ''} H{H} KV{KV} "
                f"hd{hd} {str(dtype)[6:]} {mask}{f' window={window}' if window else ''} "
                f"(dq, dk, dv abs err {errs[0]:.2e}, {errs[1]:.2e}, {errs[2]:.2e}; relative to "
                f"max|want| {max(rels):.2e}{'; bit-equal across two runs' * (var == 'wgmma')}"
                f"{'; bit-equal to the causal call' * causal_bits}{mma_check})",
        "variant": var, "max_abs_err": max(errs), "check": check, "ok": ok,
        "ms": time_ms(op, sets, 10),
        "plain_ms": time_ms(lambda *a: flash_attention_bwd_plain(*a, causal=causal, window=window),
                            sets, 3),
        "library_ms": grad_ms(sdpa, sets, 10), "bound_ms": b_ms, "bound_by": b_by,
        "other": other, "also": timed(also) if var == "wgmma" and also else None,
    }


def ssd_case(b, s, h, p, g, n, dtype, gen, want_variant, layout="dense"):
    """``layout``: ``"views"``, x, B and C are views into one [b, s, h p + 2 g n]
    tensor, as the model hands them over from its conv output (strided batch
    and sequence axes); ``"offset"``, views into such a tensor one element
    wider that start one element in (not 16-byte aligned, odd sequence
    stride); ``"dense"``, each is contiguous."""
    from repro_torch.kernels.ssd_scan import _launch, flops, ssd_scan, ssd_scan_plain, variant

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
    b_ms, b_by = bound(nbytes, flops(b, s, h, p, n), dtype)
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
    other = "".join(f" {o[0]}={o[1]:.4f}ms" for o in (c.get("other"), c.get("also")) if o)
    print(f"  {c['case']}: max_abs_err={c['max_abs_err']:.3e}; {c['check']}: "
          f"{'ok' if c['ok'] else 'DISAGREES'}  kernel={c['ms']:.4f}ms{other} "
          f"plain={c['plain_ms']:.4f}ms library={lib} "
          f"bound={c['bound_ms'] * 1e3:.2f}us ({c['bound_by']}, "
          f"kernel at {c['bound_ms'] / c['ms']:.0%} of it)")


def opcheck_ops(gen) -> None:
    """``torch.library.opcheck`` of each of the seven operators on CUDA
    tensors at a small shape (the flash forward also at head dim 256, with a
    window, a softcap and a scale; its backward also with a window, and
    unmasked with 128 queries against 200 keys; the SSD
    scan also with inputs that need a gradient, which its backward operator
    computes): the schema, the
    autograd registration (rmsnorm, flash_attention_lse and ssd_scan take
    inputs that need a gradient), the fake implementation against the
    kernel's real outputs (shapes, dtypes, strides), and AOT dispatch with
    dynamic shapes."""
    from torch.library import opcheck

    from repro_torch.kernels import ops  # noqa: F401  (defines the operators)

    O = torch.ops.repro_torch

    def randn(*shape, dtype=torch.float32, grad=False):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype).requires_grad_(grad)

    bf16 = torch.bfloat16
    q, k, v = randn(1, 128, 4, 64, dtype=bf16), randn(1, 128, 2, 64, dtype=bf16), \
        randn(1, 128, 2, 64, dtype=bf16)
    o, lse = O.flash_attention_lse(q, k, v, True, None, None, None)
    ow, lsew = O.flash_attention_lse(q, k, v, True, 48, None, None)
    ku, vu = randn(1, 200, 2, 64, dtype=bf16), randn(1, 200, 2, 64, dtype=bf16)
    ou, lseu = O.flash_attention_lse(q, ku, vu, False, None, None, None)
    q256, k256, v256 = randn(1, 192, 4, 256, dtype=bf16), randn(1, 192, 2, 256, dtype=bf16), \
        randn(1, 192, 2, 256, dtype=bf16)
    ssd_args = (randn(1, 128, 4, 64, dtype=bf16),
                (torch.rand(1, 128, 4, generator=gen, device="cuda") * 0.1).to(bf16),
                -torch.linspace(1.0, 4.0, 4, device="cuda").to(bf16),
                randn(1, 128, 1, 64, dtype=bf16), randn(1, 128, 1, 64, dtype=bf16))
    cases = {
        "rmsnorm": (O.rmsnorm, (randn(64, 256, dtype=bf16, grad=True),
                                randn(256, grad=True), 1e-6)),
        "rmsnorm_bwd": (O.rmsnorm_bwd, (randn(64, 256, dtype=bf16), randn(256),
                                        randn(64, 256, dtype=bf16), 1e-6)),
        "flash_attention": (O.flash_attention, (q, k, v, True, None, None, None)),
        "flash_attention hd256": (O.flash_attention, (q256, k256, v256, True, 100, 50.0,
                                                      224.0**-0.5)),
        "flash_attention_lse": (O.flash_attention_lse,
                                (q.detach().requires_grad_(), k.detach().requires_grad_(),
                                 v.detach().requires_grad_(), True, None, None, None)),
        "flash_attention_bwd": (O.flash_attention_bwd,
                                (q, k, v, o, randn(1, 128, 4, 64, dtype=bf16), lse, True, None,
                                 None, None)),
        "flash_attention_bwd window": (O.flash_attention_bwd,
                                       (q, k, v, ow, randn(1, 128, 4, 64, dtype=bf16), lsew,
                                        True, 48, None, None)),
        "flash_attention_bwd unmasked": (O.flash_attention_bwd,
                                         (q, ku, vu, ou, randn(1, 128, 4, 64, dtype=bf16), lseu,
                                          False, None, None, None)),
        "ssd_scan": (O.ssd_scan, ssd_args),
        "ssd_scan (grad)": (O.ssd_scan, tuple(t.clone().requires_grad_() for t in ssd_args)),
        "ssd_scan_bwd": (O.ssd_scan_bwd, (*ssd_args, randn(1, 128, 4, 64, dtype=bf16),
                                          randn(1, 4, 64, 64))),
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
        # deepseek-v2-lite at prefill B4 S512 and decode B4: ln1/ln2, kv_norm
        rmsnorm_case((2048, 2048), bf16, gen, "vector"),
        rmsnorm_case((2048, 512), bf16, gen, "vector"),
        rmsnorm_case((4, 2048), bf16, gen, "vector"),
        rmsnorm_case((4, 512), bf16, gen, "vector"),
        # hymba-1.5b at prefill B4 S2048: ln1, the branch norms, ln2 (D 1600);
        # the gated norm (d_inner 3200)
        rmsnorm_case((8192, 1600), bf16, gen, "vector"),
        rmsnorm_case((8192, 3200), bf16, gen, "vector"),
        # hymba-1.5b at decode B4: ln1, the branch norms, ln2; the gated norm
        rmsnorm_case((4, 1600), bf16, gen, "vector"),
        rmsnorm_case((4, 3200), bf16, gen, "vector"),
        # gemma3-4b at prefill B4 S2048 (ln1, ln1_post, ln2, ln2_post; the
        # q-norm over 8 heads of 256) and gemma2-9b at prefill B4 S512 and
        # decode B4 (its four norms; gemma3's decode q-norm)
        rmsnorm_case((8192, 2560), bf16, gen, "vector"),
        rmsnorm_case((65536, 256), bf16, gen, "vector"),
        rmsnorm_case((2048, 3584), bf16, gen, "vector"),
        rmsnorm_case((4, 3584), bf16, gen, "vector"),      # and qwen2-vl-7b's decode
        rmsnorm_case((32, 256), bf16, gen, "vector"),
        # qwen2-vl-7b at prefill B4, 8 patches and a prompt of 512: ln1, ln2
        rmsnorm_case((2080, 3584), bf16, gen, "vector"),
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
        flash_case(1, 192, 64, 2, 1, 256, torch.float32, gen, window=32),  # rows, no live key
        # hymba-1.5b prefill B4 S2048, 25 heads in 5 groups of 5: its 29 window
        # layers and its 3 global ones
        flash_case(4, 2048, 2048, 25, 5, 64, bf16, gen, window=1024),
        flash_case(4, 2048, 2048, 25, 5, 64, bf16, gen),
        # starcoder2-7b prefill B4 S512: 36 heads in 4 groups of 9
        flash_case(4, 512, 512, 36, 4, 128, bf16, gen),
        # whisper-large-v3 B4: the encoder over 1500 frames, unmasked (the
        # last 128-key tile padded); cross attention, the prompt's 128
        # queries against the 1500 frames, unmasked; the decoder's causal
        # self attention over the prompt
        flash_case(4, 1500, 1500, 20, 20, 64, bf16, gen, causal=False),
        flash_case(4, 128, 1500, 20, 20, 64, bf16, gen, causal=False),
        flash_case(4, 128, 128, 20, 20, 64, bf16, gen),
        # head dim 256, the wgmma kernel's tiles of 128 q rows by 64 keys:
        # gemma3-4b prefill B4 S2048, 8 heads in 4 groups of 2, its 5 global
        # layers and its 29 with a window of 1024; gemma2-9b prefill B4 S512,
        # 16 heads in 8 groups, softcap 50 and scale 224^-0.5 (its window of
        # 4096 masks nothing at 512, so both its kinds of layer run this
        # call), and its window at B1 S8192, where it masks; then the tile's
        # edges: ragged lengths with MQA, and rows with no live key
        flash_case(4, 2048, 2048, 8, 4, 256, bf16, gen),
        flash_case(4, 2048, 2048, 8, 4, 256, bf16, gen, window=1024),
        flash_case(4, 512, 512, 16, 8, 256, bf16, gen, softcap=50.0, scale=224.0**-0.5),
        flash_case(1, 8192, 8192, 16, 8, 256, bf16, gen, window=4096, softcap=50.0,
                   scale=224.0**-0.5),
        flash_case(1, 200, 200, 4, 1, 256, bf16, gen),
        flash_case(1, 384, 128, 2, 1, 256, bf16, gen, window=32),
        # qwen2-vl-7b prefill B4, 8 patches before a prompt of 512: 28 heads in
        # 4 groups of 7, S 520, whose last 128-row tile holds 8 rows
        flash_case(4, 520, 520, 28, 4, 128, bf16, gen),
    ]
    ssd = [
        ssd_case(4, 2048, 32, 64, 1, 128, bf16, gen, "tc", "views"),  # mamba2 prefill
        ssd_case(1, 300, 4, 16, 2, 8, bf16, gen, "tc"),            # narrow tiles, ragged
        ssd_case(2, 320, 4, 128, 2, 128, bf16, gen, "tc", "views"),  # the largest P and N
        ssd_case(2, 256, 8, 64, 2, 64, bf16, gen, "tc", "views"),  # two groups
        ssd_case(4, 2048, 50, 64, 1, 16, bf16, gen, "tc", "views"),  # hymba-1.5b prefill
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
        # deepseek-v2-lite-16b training at B4 S512: ln1, ln2, the final norm;
        # MLA's kv_norm over the 512-wide latent
        rmsnorm_bwd_case((2048, 2048), bf16, gen, "vector"),
        rmsnorm_bwd_case((2048, 512), bf16, gen, "vector"),
    ]
    flash_lse = [
        flash_lse_case(4, 512, 32, 8, 128, bf16, gen),       # qwen3-4b training forward
        flash_lse_case(2, 512, 8, 2, 64, bf16, gen),
        flash_lse_case(1, 300, 32, 8, 128, f32, gen),        # simt, ragged tiles
        flash_lse_case(1, 1024, 8, 4, 256, bf16, gen),       # hd 256, for B2d
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
    # whisper-large-v3's two unmasked launches, whose 1500 keys end in a
    # tile of 92 keys and 36 padded ones: the encoder and cross attention
    flash_padding_probe(4, 1500, 1500, 20, 20, 64, gen)
    flash_padding_probe(4, 128, 1500, 20, 20, 64, gen)
    # head dim 256: 1100 keys are 17 tiles of 64 and one of 12, 52 padded
    flash_padding_probe(4, 256, 1100, 8, 4, 256, gen)
    return {"rmsnorm": rms, "flash_attention": flash, "ssd_scan": ssd, "rmsnorm_bwd": rms_bwd,
            "flash_attention_bwd": flash_bwd, "flash_lse": flash_lse}


# Phase 4: a routing comparison needs each token's k-th router probability
# clear of its (k+1)-th by more than the card and the CPU disagree on them,
# else a near-tie that either side may break would be reported as a fault of
# the port.  The CPU tests (tests/test_torch_moe.py) hold the smallest gap
# above a fixed 1e-4 at smoke width (8 experts, top-2).  Among deepseek's 64
# experts the 6th and 7th probabilities of some tokens of a 64-token prompt
# lie within 1e-4, so here the gap is held to the run's own disagreement:
# two experts can change places only where their gap is at most the sum of
# their two probabilities' differences, so a smallest gap above NEAR_TIE = 2
# times the largest difference between the two sides' probabilities leaves
# every top-k set determined.  The tokens within 1e-4 are counted.
ROUTING_MARGIN = 1e-4
NEAR_TIE = 2.0


def depth_cut(full, tail: int | None = None):
    """The parity phases' 2-layer cut of a full config, in fp32: one layer of
    each program segment where there are several (deepseek: its dense
    layer, then an MoE layer), else the one segment's unit twice; an
    encoder-decoder's encoder is cut the same way.  With ``tail``, the last
    ``tail`` layers of the first segment's unit, once (the gemmas: a window
    layer, then a global one)."""
    def cut(program):
        if tail:
            return ((program[0][0][-tail:], 1),)
        if len(program) > 1:
            return tuple((unit, 1) for unit, _ in program)
        return ((program[0][0], 2),)

    program = cut(full.program)
    enc = {"enc_program": cut(full.enc_program)} if full.is_encoder_decoder else {}
    return full.reduced(num_layers=sum(len(unit) * reps for unit, reps in program),
                        program=program, dtype="float32", **enc)


def _routed(record):
    """One MoE call's routing as lists: each token's experts in ascending
    order, each with its pair's rank (a pair's rank does not depend on its
    place among its token's k), and the capacity."""
    ids, perm = record["idx"].cpu().sort(-1)
    return ids.tolist(), record["rank"].cpu().gather(-1, perm).tolist(), record["capacity"]


def grid_positions(B: int, P: int, npatch: int) -> torch.Tensor:
    """[3, B, npatch + P] int64 M-RoPE positions whose channels differ: patch
    i at (t, h, w) = (0, i // 4, i % 4), text token j at npatch + j in all
    three channels, so that decode continues at its cache slot.  With
    ``serve_batch``'s arange in every channel M-RoPE is plain RoPE, and a
    section taken from the wrong channel could not show."""
    i = torch.arange(npatch)
    pos = torch.cat([torch.stack([0 * i, i // 4, i % 4]),
                     torch.arange(npatch, npatch + P).expand(3, P)], dim=1)
    return pos[:, None].expand(3, B, npatch + P).contiguous()


def phase_parity(arch: str, P: int, tail: int | None = None):
    """``depth_cut(arch, tail)`` on the card against the CPU: prefill of a B1
    prompt of ``P`` tokens (after a vision model's patches, at
    ``grid_positions``, and beside an encoder-decoder's frames), then 4
    greedy decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_batch, serve_lengths, serve_patches
    from repro_torch.models import build_model, moe
    from repro_torch.models.convert import to_device

    cfg = depth_cut(get_config(arch), tail)
    cpu, gpu = build_model(cfg, "cpu"), build_model(cfg, "cuda")
    t0 = time.perf_counter()
    p_cpu = cpu.init(torch.Generator("cpu").manual_seed(0))
    p_gpu = to_device(p_cpu, "cuda")
    steps = 4
    batch = serve_batch(cfg, 1, P, 0, "cpu")
    npatch = serve_patches(cfg)
    if npatch:
        batch["positions"] = grid_positions(1, P, npatch)
    max_seq, pos0 = serve_lengths(cfg, P, steps)
    routing = {"cpu": [], "cuda": []}
    with moe.routing_hook(routing["cpu"].append):
        l_cpu, c_cpu = cpu.prefill(p_cpu, batch, max_seq=max_seq)
    with moe.routing_hook(routing["cuda"].append):
        l_gpu, c_gpu = gpu.prefill(p_gpu, to_device(batch, "cuda"), max_seq=max_seq)

    def rel(a, b):
        return ((a.cpu().float() - b.float()).abs().max() / b.float().abs().max()).item()

    worst, same = rel(l_gpu, l_cpu), 0
    for i in range(steps):
        tok_cpu = l_cpu[:, -1].argmax(-1, keepdim=True)
        same += int(torch.equal(l_gpu[:, -1].argmax(-1, keepdim=True).cpu(), tok_cpu))
        with moe.routing_hook(routing["cpu"].append):
            l_cpu, c_cpu = cpu.decode_step(p_cpu, c_cpu, tok_cpu, pos0 + i)
        with moe.routing_hook(routing["cuda"].append):
            l_gpu, c_gpu = gpu.decode_step(p_gpu, c_gpu, tok_cpu.cuda(), pos0 + i)
        worst = max(worst, rel(l_gpu, l_cpu))
    # every leaf of every layer's cache: kv {k, v}, MLA kv {c_kv, k_rope}, ssm
    # {state, conv} or enc_kv {k, v}
    cache_err = max(rel(g[kind][n], c[kind][n])
                    for g, c in zip(c_gpu, c_cpu) for kind in c for n in c[kind])
    route = ""
    if routing["cpu"]:
        k = cfg.top_k
        tops = [torch.topk(r["probs"], k + 1).values for r in routing["cpu"]]
        gaps = torch.cat([top[:, k - 1] - top[:, k] for top in tops])
        margin = gaps.min().item()
        drift = max((g["probs"].cpu() - c["probs"]).abs().max().item()
                    for g, c in zip(routing["cuda"], routing["cpu"]))
        kept = sum(int((r["rank"] < r["capacity"]).sum()) for r in routing["cpu"])
        pairs = sum(r["rank"].numel() for r in routing["cpu"])
        equal = [_routed(g) == _routed(c) for g, c in zip(routing["cuda"], routing["cpu"])]
        route = (f"; routing of {len(equal)} MoE calls equal {sum(equal)}/{len(equal)} "
                 f"(expert ids, ranks, {kept} of {pairs} pairs kept), smallest top-{k} margin "
                 f"{margin:.3e} against the largest card-CPU router probability "
                 f"difference {drift:.3e} (must exceed {NEAR_TIE:g}x it; "
                 f"{int((gaps <= ROUTING_MARGIN).sum())} of {gaps.numel()} tokens within "
                 f"{ROUTING_MARGIN:g})")
    kinds = ", ".join(f"{spec.attn}+{'cross+' if spec.cross_attn else ''}{spec.ffn}"
                      for unit, reps in cfg.program for _ in range(reps) for spec in unit)
    if cfg.is_encoder_decoder:
        kinds = (f"encoder {sum(len(u) * r for u, r in cfg.enc_program)} unmasked layers over "
                 f"{cfg.enc_seq} frames; decoder {kinds}")
    if npatch:
        kinds += (f"; M-RoPE {cfg.mrope_sections}, {npatch} patches on a 2x4 (h, w) grid "
                  f"first, decode from position {pos0}")
    print(f"[4] parity {arch} widths, {cfg.num_layers} layers ({kinds}), "
          f"fp32, B1 P{P} + {steps} decode steps: "
          f"max rel logit diff {worst:.3e}, max rel cache diff {cache_err:.3e} "
          f"(tol {PARITY_TOL:g}), greedy tokens equal {same}/{steps}{route}, "
          f"{time.perf_counter() - t0:.1f}s")
    if routing["cpu"]:
        require(len(routing["cuda"]) == len(routing["cpu"]) == steps + 1,
                f"{arch}: {len(routing['cuda'])} MoE calls on the card, {len(routing['cpu'])} "
                f"on the CPU")
        require(margin > NEAR_TIE * drift,
                f"{arch}: a near-tie in the router's top-{k} (margin {margin:.3e} against "
                f"a card-CPU difference of {drift:.3e}): the routing comparison cannot tell a "
                f"flip from a fault")
        require(all(equal), f"{arch}: the card routes differently from the CPU at MoE calls "
                            f"{[i for i, e in enumerate(equal) if not e]}")
    require(worst < PARITY_TOL,
            f"{arch}: kernel path logits differ from the plain path by {worst:.3e}")
    require(cache_err < PARITY_TOL, f"{arch}: kernel path cache differs by {cache_err:.3e}")
    require(torch.isfinite(l_gpu).all().item(), f"{arch}: non-finite logits in the parity run")


def phase_train_parity(arch: str, S: int, phase: str | None = None):
    """One train step of ``depth_cut(arch)`` in fp32 (B1; qwen3-4b: two of its
    layers; deepseek-v2-lite-16b: its dense layer, then an MoE layer;
    mamba2-370m: two Mamba-2 layers, whose SSD runs the simt kernels forward
    and backward; whisper-large-v3: two encoder and two decoder layers over
    all 1500 frames, standard normal from seed 0, whose unmasked and
    causal flash runs the simt kernels), printed under ``phase`` (by default
    8, or 16a for an MoE model): the
    loss and its gradients through ``Model.loss`` and ``torch.autograd.grad``,
    then ``adamw_step``, as ``build_train_step`` runs them; through the
    kernels on the card (forward and backward) against the plain path on the
    CPU, from the same fp32 masters and batch.  Each number is relative to
    its leaf's max and held to PARITY_TOL: the loss (an MoE model's aux too);
    every gradient leaf; and every parameter after the card's AdamW against
    the CPU's AdamW run on the card's own gradients.  The parameters after
    the two devices' whole steps are printed but held to no limit, since
    none would be usable: AdamW's first update is lr g / (|g| + eps), nearly
    lr sign(g), so an element whose gradient lies within the two sums'
    disagreement of 0 (most of the tied embedding's, ~1e-8) may move up to
    2 lr apart, and 2 lr is the whole range of any first update.

    For an MoE model also: the routing of every MoE call equal on the two
    sides (ids and ranks), its smallest top-k margin above NEAR_TIE times
    their largest router probability difference (as phase 4); the routing
    of each layer's recompute in backward (remat) equal to its forward's on
    each side; and a second run on the card giving every gradient bit for
    bit: the kept expert slots are distinct, so ``index_select``'s
    ``index_add`` backward adds once to each kept row (the dropped pairs all
    land on the spare row, which is discarded)."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import build_model, moe
    from repro_torch.models.convert import to_device
    from repro_torch.models.transformer import layer_specs
    from repro_torch.optim import adamw_init, adamw_step
    from repro_torch.tree import map_tree, tree_leaves

    cfg = depth_cut(get_config(arch))
    n_moe = sum(spec.ffn == "moe" for spec in layer_specs(cfg.program))
    lr = 3e-4  # build_train_step's default
    t0 = time.perf_counter()
    batch = {k: torch.from_numpy(v).long()
             for k, v in SyntheticTokens(cfg.vocab_size, S, 1, seed=0).batch_at(0).items()}
    if cfg.is_encoder_decoder:  # all enc_seq frames, standard normal from the seed
        batch["frames"] = torch.randn((1, cfg.enc_seq, cfg.d_model),
                                      generator=torch.Generator("cpu").manual_seed(0))
    p_init = build_model(cfg, "cpu").init(torch.Generator("cpu").manual_seed(0), torch.float32)
    runs = [("cpu", map_tree(torch.clone, p_init)), ("cuda", to_device(p_init, "cuda"))]
    if n_moe:
        runs.append(("cuda again", to_device(p_init, "cuda")))
    out, routing = {}, {}
    for tag, params in runs:
        dev = tag.split()[0]
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        routing[tag] = []
        with moe.routing_hook(routing[tag].append):
            loss, metrics = build_model(cfg, dev).loss(params,
                                                       {k: v.to(dev) for k, v in batch.items()})
            grads = list(torch.autograd.grad(loss, leaves))
        seen = [g.clone() for g in grads]  # adamw_step clips grads in place
        norm = None
        if tag != "cuda again":  # the second card run checks the gradients only
            norm = adamw_step(leaves, grads, adamw_init(leaves), lr)[2]["grad_norm"]
        out[tag] = (loss.detach(), norm, seen, [t.detach() for t in leaves],
                    metrics["aux"].detach())
        del params, leaves, grads
    (loss_c, norm_c, g_c, p_c, aux_c), (loss_g, norm_g, g_g, p_g, aux_g) = out["cpu"], out["cuda"]

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
    kinds = ", ".join(f"{spec.attn}+{spec.ffn}{'+cross' * spec.cross_attn}"
                      for spec in layer_specs(cfg.enc_program + cfg.program))
    aux = ""
    if n_moe:
        aux_err = rel(aux_g, aux_c)
        aux = (f"aux {float(aux_g):.6f} (cpu {float(aux_c):.6f}), rel aux diff {aux_err:.3e}, ")
    print(f"[{phase or ('16a' if n_moe else '8')}] train parity {arch} widths, {cfg.num_layers} layers "
          f"({kinds}), fp32, B1 S{S}, one step (Model.loss, autograd, adamw_step): loss "
          f"{float(loss_g):.6f} (cpu {float(loss_c):.6f}), rel loss diff {loss_err:.3e}, {aux}max "
          f"rel grad diff {grad_err:.3e} over {len(g_c)} leaves, max rel param diff after the "
          f"card's AdamW against the CPU's AdamW on the card's gradients {update_err:.3e} (tol "
          f"{PARITY_TOL:g} each); grad norm {float(norm_g):.4f} (cpu {float(norm_c):.4f}); for "
          f"information, held to no limit: the two whole steps' params differ by "
          f"{direct_abs:.3e} at most (AdamW's first update spans 2 lr = {2 * lr:g}), "
          f"{near_zero} element(s) have a CPU gradient within its leaf's disagreement of 0; "
          f"{time.perf_counter() - t0:.1f}s")
    require(math.isfinite(float(loss_g)), "train parity: non-finite loss on the card")
    require(loss_err < PARITY_TOL, f"train parity: loss differs by {loss_err:.3e}")
    require(grad_err < PARITY_TOL, f"train parity: a gradient differs by {grad_err:.3e}")
    require(update_err < PARITY_TOL, f"train parity: the card's AdamW differs by {update_err:.3e}")
    if not n_moe:
        return
    require(aux_err < PARITY_TOL, f"train parity: the aux loss differs by {aux_err:.3e}")
    k = cfg.top_k
    fwd = {tag: recs[:n_moe] for tag, recs in routing.items()}
    tops = [torch.topk(r["probs"], k + 1).values for r in fwd["cpu"]]
    gaps = torch.cat([top[:, k - 1] - top[:, k] for top in tops])
    margin = gaps.min().item()
    drift = max((g["probs"].cpu() - c["probs"]).abs().max().item()
                for g, c in zip(fwd["cuda"], fwd["cpu"]))
    equal = [_routed(g) == _routed(c) for g, c in zip(fwd["cuda"], fwd["cpu"])]
    recompute = {tag: [_routed(f) == _routed(r) for f, r in zip(recs[:n_moe],
                                                                reversed(recs[n_moe:]))]
                 for tag, recs in routing.items()}
    g_again = out["cuda again"][2]
    bitwise = sum(torch.equal(a, b) for a, b in zip(g_g, g_again))
    kept = sum(int((r["rank"] < r["capacity"]).sum()) for r in fwd["cpu"])
    pairs = sum(r["rank"].numel() for r in fwd["cpu"])
    print(f"[16a] routing of {len(equal)} MoE call(s) equal on the card and the CPU "
          f"{sum(equal)}/{len(equal)} ({kept} of {pairs} pairs kept), smallest top-{k} margin "
          f"{margin:.3e} against the largest card-CPU router probability difference "
          f"{drift:.3e} (must exceed {NEAR_TIE:g}x it; {int((gaps <= ROUTING_MARGIN).sum())} of "
          f"{gaps.numel()} tokens within {ROUTING_MARGIN:g})")
    same_loss = "equal" if torch.equal(out["cuda again"][0], loss_g) else "NOT equal"
    print(f"[16e] determinism: the card's second run gives {bitwise} of {len(g_g)} gradient "
          f"leaves bit for bit (loss {same_loss}); "
          f"each MoE layer's recompute (remat) routes as its forward: "
          + ", ".join(f"{tag} {sum(v)}/{len(v)}" for tag, v in recompute.items()))
    require(all(len(recs) == 2 * n_moe for recs in routing.values()),
            f"train parity: MoE calls {[len(r) for r in routing.values()]}, want {2 * n_moe}")
    require(margin > NEAR_TIE * drift,
            f"train parity: a near-tie in the router's top-{k} (margin {margin:.3e} against a "
            f"card-CPU difference of {drift:.3e})")
    require(all(equal), "train parity: the card routes differently from the CPU")
    require(all(all(v) for v in recompute.values()),
            f"train parity: a recompute routed differently from its forward {recompute}")
    require(bitwise == len(g_g) and same_loss == "equal",
            f"train parity: {len(g_g) - bitwise} gradient leaves differ between two card runs")


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
    steps); each kernel must have been launched ``want[name]`` times.  The
    cache of a model with window layers and an encoder-decoder's, as its
    prefill returned it on the card, are held to the arithmetic by kind.  -> (launch counts,
    the greedy tokens, decode ms a step)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    from repro_torch.models import build_model
    from repro_torch.models.transformer import layer_specs
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch)
    model = build_model(cfg, "cuda")
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(model.init_shapes()))
    held = release_memory()
    out = io.StringIO()
    served = {}
    cls = type(model)
    prefill = cls.prefill

    def recording_prefill(self, *args, **kwargs):  # keeps the bytes, not the cache
        logits, cache = prefill(self, *args, **kwargs)
        served.update(cache_bytes(cfg, cache))
        return logits, cache

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cls.prefill = recording_prefill
    try:
        with contextlib.redirect_stdout(out):
            gen = serve.main(["--arch", arch, "--batch", str(B), "--prompt-len", str(P),
                              "--gen", str(G)])
    finally:
        cls.prefill = prefill
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
          f"peak memory {peak / 2**30:.2f} GiB = {peak / 1e9:.2f} GB ({held / 2**30:.3f} GiB "
          f"of it held before the run) beside {weights / 1e9:.2f} GB of weights, "
          f"launches {counts}, "
          f"main() wall {wall:.1f}s (init included)")
    require(counts == want, f"{arch}: launch counts {counts}, want {want}")
    if cfg.is_encoder_decoder or cfg.frontend or any(spec.window
                                                     for spec in layer_specs(cfg.program)):
        print_cache_bytes("5", cfg, B, serve.serve_lengths(cfg, P, G)[0], served,
                          "the cache prefill returned on the card")
    require(tuple(gen.shape) == (B, G), f"generated shape {tuple(gen.shape)}")
    require(int(gen.min()) >= 0 and int(gen.max()) < cfg.vocab_size, "token out of range")
    return counts, gen, decode_s / (G - 1) * 1e3


CACHE_KINDS = ("global", "rings", "cross", "ssm state", "conv tails")


def cache_bytes(cfg, cache) -> dict[str, int]:
    """A serving cache's bytes by kind, the kinds it holds: the self
    attention caches of global layers, the rings of window layers, the
    cross K/V of an encoder-decoder's decoder layers, the SSM states and the
    conv tails."""
    from repro_torch.models.transformer import layer_specs

    out = dict.fromkeys(CACHE_KINDS, 0)
    for spec, layer in zip(layer_specs(cfg.program), cache):
        for part_name, part in layer.items():
            for name, t in part.items():
                kind = {"state": "ssm state", "conv": "conv tails"}.get(
                    name, "cross" if part_name == "enc_kv" else
                    "rings" if spec.window else "global")
                out[kind] += t.numel() * t.element_size()
    return {k: v for k, v in out.items() if v}


def cache_arithmetic(cfg, B: int, max_seq: int) -> dict[str, int]:
    """``cache_bytes`` from the config's widths alone: k and v [B, KV, slots,
    hd] in the config's dtype (2 bytes in bf16) a layer, max_seq slots in a
    global layer, min(max_seq, window) in a window layer's ring and enc_seq
    in a decoder layer's cross K/V; the fp32 state [B, H, P, N] and the conv
    tail [B, K - 1, d_inner + 2 G N] in the config's dtype a Mamba-2 or
    hybrid layer."""
    from repro_torch.models.transformer import layer_specs

    specs = layer_specs(cfg.program)
    size = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    kv = 2 * B * cfg.num_kv_heads * cfg.head_dim * size
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    ssm = sum(sp.attn in ("mamba", "hybrid") for sp in specs)
    out = {"global": sum(kv * max_seq for sp in specs if not sp.window),
           "rings": sum(kv * min(max_seq, sp.window) for sp in specs if sp.window),
           "cross": sum(kv * cfg.enc_seq for sp in specs if sp.cross_attn),
           "ssm state": ssm * B * cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4,
           "conv tails": ssm * B * (cfg.conv_kernel - 1) * conv_dim * size}
    return {k: v for k, v in out.items() if v}


def print_cache_bytes(phase: str, cfg, B: int, max_seq: int, got: dict[str, int], how: str):
    """Print a cache's bytes by kind beside the arithmetic and, where it
    holds window rings, beside what full caches in every layer would hold;
    fail where they differ."""
    want = cache_arithmetic(cfg, B, max_seq)
    size = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    full = cfg.num_layers * 2 * B * cfg.num_kv_heads * cfg.head_dim * size * max_seq
    tail = ""
    if "rings" in got:
        tail = (f"; full caches in every layer would hold {full:,} B of k and v, "
                f"{full / (got.get('global', 0) + got['rings']):.2f}x the global caches and "
                f"rings")
    elif "cross" in got:
        tail = f"; the cross K/V is {got['cross'] / sum(got.values()):.1%} of it"
    print(f"[{phase}] {cfg.name} cache at B{B} max_seq {max_seq} ({how}): " + ", ".join(
        f"{k} {v:,} B (arithmetic {want.get(k, 0):,})" for k, v in got.items()) +
        f"; total {sum(got.values()):,} B" + tail)
    require(got == want, f"{cfg.name}: cache bytes {got}, arithmetic {want}")


def phase_long_decode(arch: str, max_seq: int, steps: int, want: dict[str, int]):
    """The long_500k decode cell on the card: ``Model.init_cache(1, max_seq)``,
    its bytes by kind against the arithmetic and against what the caching
    allocator counted for it, then ``steps`` greedy decode steps at the
    cache's last positions (after one to warm), on the zeroed cache, with
    exact launch counts, finite logits, ms a step and the peak.  -> the
    launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch)
    held = release_memory("14")
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    cache = model.init_cache(1, max_seq)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated() - before
    got = cache_bytes(cfg, cache)
    print_cache_bytes("14", cfg, 1, max_seq, got, f"Model.init_cache on the card; the allocator "
                      f"counted {allocated:,} B for it")
    tensors = sum(len(part) for layer in cache for part in layer.values())
    require(0 <= allocated - sum(got.values()) < 512 * tensors,
            f"{arch}: the allocator counted {allocated} B for a cache of {sum(got.values())} B")
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 1))).cuda()
    positions = torch.arange(max_seq - steps - 1, max_seq, device="cuda")
    logits, cache = model.decode_step(params, cache, tok, positions[0])  # warm
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    finite = torch.isfinite(logits).all()
    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        tok = logits[:, -1].argmax(-1, keepdim=True)
        logits, cache = model.decode_step(params, cache, tok, positions[i])
        finite &= torch.isfinite(logits).all()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"[14] {arch} long_500k decode: {steps} steps at positions {max_seq - steps} to "
          f"{max_seq - 1} on the zeroed cache, {ms:.2f} ms a step (host clock, synchronised), "
          f"logits finite {bool(finite)}, peak {peak / 1e9:.3f} GB ({held / 2**30:.3f} GiB held "
          f"before; weights {sum(t.numel() * t.element_size() for t in tree_leaves(params)):,} "
          f"B), launches {counts}")
    require(bool(finite), f"{arch}: non-finite logits in the long decode")
    require(counts == want, f"{arch} long decode: launch counts {counts}, want {want}")
    return counts


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


def phase_train_profile(B: int, S: int, policy=None, phase="10", cfg=None):
    """Where a warm training step's time goes: one step timed untraced, then
    one traced with torch.profiler; with ``policy``, under that offload
    policy; of qwen3-4b, or of ``cfg``; then a warm step timed in two parts
    with CUDA events, the loss with its backward, then ``adamw_step``.  For
    an MoE model also the MoE dispatch's forward and backward ops against
    the expert GEMMs, for MLA its dense softmax path.  -> the traced step's
    device figures (``copy_overlap``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init, adamw_step
    from repro_torch.tree import map_tree, tree_leaves

    release_memory(phase)
    cfg = cfg or get_config("qwen3-4b")
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
    print(f"[{phase}] profile train {cfg.name} B{B} S{S}{what}, warm, untraced: {ms:.1f} ms a "
          f"step ({B * S / ms * 1e3:.0f} tokens/s), loss {loss:.4f}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        loss, wall = step(2)
    figures = copy_overlap(prof)
    print(f"  train step traced: {device_breakdown(prof, wall, top=8)}")
    bwd_ms, busy_ms = kernel_time(prof, "flash_bwd_")
    if bwd_ms:
        print(f"  the flash backward's kernels: {bwd_ms:.2f} ms, {bwd_ms / busy_ms:.1%} of the "
              f"device's busy {busy_ms:.2f} ms")
    print(f"  train step by op: {op_breakdown(prof, top=8)}")
    print(f"  copies: {figures['copy_ms']:.3f} ms in all (device to host "
          f"{figures['d2h_ms']:.3f}, host to device {figures['h2d_ms']:.3f}), "
          f"{figures['overlap_ms']:.3f} ms of it beside compute; compute (kernels and "
          f"memsets) busy {figures['compute_ms']:.2f} ms of {wall:.2f} ms wall")
    require(math.isfinite(loss), "train profile: non-finite loss")
    if cfg.num_experts:
        print(f"  MoE dispatch, forward and backward, against the expert GEMMs (self device "
              f"time): {moe_breakdown(prof, cfg, B * S)}")
    if cfg.kv_lora_rank:
        print(f"  MLA's dense attention on [B, H, S, S] scores (self device time): "
              f"{shape_breakdown(prof, [B, cfg.num_heads, S, S])}")
    leaves = tree_leaves(params)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    batch = batch_fn(3)
    torch.cuda.synchronize()
    events[0].record()
    model.loss(params, batch, remat_policy=policy)[0].backward()
    events[1].record()
    adamw_step(params, map_tree(lambda t: t.grad, params), opt, 3e-4)
    events[2].record()
    torch.cuda.synchronize()
    for t in leaves:
        t.grad = None
    print(f"  a warm step by part (CUDA events on the step's stream): the loss and its "
          f"backward {events[0].elapsed_time(events[1]):.2f} ms, adamw_step "
          f"{events[1].elapsed_time(events[2]):.2f} ms over {len(leaves)} leaves, "
          f"{sum(t.numel() for t in leaves):,} parameters")
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
                "ssd_cb_kernel", "ssd_scan_tc_kernel", "ssd_scan_kernel", "ssd_scan_bwd_kernel",
                "ssd_bwd_state_kernel", "ssd_bwd_chunk_kernel")


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
    decode step of phase 4's depth cut traced at two positions (its
    events must be equal), the
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
    max_seq, pos0 = serve.serve_lengths(cfg, P, G)
    planners = {role: serve.serve_step_planner(model, arch, role, B, P, max_seq, False,
                                               str(PLAN_DIR)) for role in ("prefill", "decode")}
    params = model.init(torch.Generator("cuda").manual_seed(0))
    batch = serve.serve_batch(cfg, B, P, 0, "cuda")
    positions = torch.arange(pos0, pos0 + G, device="cuda")

    def prefill():
        logits, cache = model.prefill(params, batch, max_seq=max_seq)
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
    del tok, cache, params, batch
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

    # The decode step traced at two positions (0-d CUDA tensors), on phase
    # 4's depth cut in the model's dtype: whether the trace depends on the
    # position is a property of each layer, and the full depth's two traces
    # took 5-10 s a model.
    cut = depth_cut(cfg).reduced(dtype=cfg.dtype)
    cut_model = build_model(cut, "cuda")
    kv = init_program_cache(cut, cut.program, B, max_seq, dtype_of(cut), "meta")
    tok_meta = torch.empty((B, 1), dtype=torch.long, device="meta")
    traced = []
    for pos in (pos0, pos0 + G - 2):
        t0 = time.perf_counter()
        tr = trace_step_fn(build_serve_step(cut_model, cut), cut_model.init_shapes(), kv,
                           tok_meta, torch.tensor(pos, device="cuda"))
        traced.append((pos, tr.num_indices, len(tr.variables), tr.peak_load(),
                       time.perf_counter() - t0))
    print(f"[12] {arch} decode of the {cut.num_layers}-layer cut traced at two positions: "
          + "; ".join(f"pos {p}: {n} events, {v} variables, w {w:,} B ({s:.1f}s)"
                      for p, n, v, w, s in traced))
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


# Phase 13: the paper's CNNs (§VI) at CIFAR-10's 32x32 in fp32: Tables I and
# II at batch 100, Fig. 10's largest batch 200.
CNN_CELLS = (("vgg16", 100), ("vgg16", 200), ("resnet50", 100), ("resnet50", 200))
# Parity models: plain VGG, basic blocks, bottleneck blocks with their
# projections and stride-2 pads.
CNN_PARITY = ("vgg11", "resnet18", "resnet50")


def _tree_to(tree, device, dtype):
    from repro_torch.tree import map_tree

    return map_tree(lambda t: None if t is None else t.to(device, dtype), tree)


def _tree_rel(got, want) -> float:
    """The largest leaf difference relative to the leaf's max|want|."""
    from repro_torch.tree import tree_leaves

    return max(((g.detach().cpu().double() - w.detach().cpu().double()).abs().max()
                / w.detach().double().abs().max().clamp_min(1e-300)).item()
               for g, w in zip(tree_leaves(got), tree_leaves(want)) if w is not None)


def phase_cnn_parity():
    """Each CNN_PARITY model at batch 2 on the card against the CPU, from the
    same weights and batch.  In fp32 (TF32 off): the logits and the loss
    under PARITY_TOL, and on the card ``loss_remat``'s gradient against
    ``loss``'s.  Gradients across devices are compared in fp64: a ReLU or
    max-pool input within fp32 rounding of 0 takes the other branch on one
    device and moves fp32 gradients by up to about 3e-3 of their largest
    entry (tests/test_torch_cnn.py), which PARITY_TOL cannot tell from a
    fault; the fp32 gradients' difference is printed beside them.  In
    fp64: every gradient, and the params and momentum after one
    ``train_step`` from zero momentum, under PARITY_TOL."""
    from repro_torch.models import CNN

    for name in CNN_PARITY:
        t0 = time.perf_counter()
        cnn = CNN(name)
        gen = torch.Generator("cpu").manual_seed(0)
        params = cnn.init(gen)
        x = torch.randn(2, 3, 32, 32, generator=gen)
        y = torch.randint(0, 10, (2,), generator=gen)
        out = {}
        for dev in ("cpu", "cuda"):
            p, xd, yd = _tree_to(params, dev, torch.float32), x.to(dev), y.to(dev)
            out[dev] = (cnn.apply(p, xd).detach(), cnn.loss(p, xd, yd).detach(),
                        cnn.grads(p, xd, yd))
            if dev == "cuda":
                remat = cnn.grads(p, xd, yd, remat=True)
        logit_err = _tree_rel(out["cuda"][0], out["cpu"][0])
        loss_err = _tree_rel(out["cuda"][1], out["cpu"][1])
        grad32_err = _tree_rel(out["cuda"][2], out["cpu"][2])
        remat_err = _tree_rel(remat, out["cuda"][2])
        step = {}
        for dev in ("cpu", "cuda"):
            p = _tree_to(params, dev, torch.float64)
            xd, yd = x.to(dev, torch.float64), y.to(dev)
            step[dev] = (cnn.grads(p, xd, yd), *cnn.train_step(p, cnn.zero_momentum(p), xd, yd))
        grad_err, param_err, mom_err = (_tree_rel(a, b) for a, b in zip(step["cuda"],
                                                                         step["cpu"]))
        print(f"[13] cnn parity {name} B2 32x32, card against CPU: fp32 logits {logit_err:.3e}, "
              f"loss {float(out['cuda'][1]):.6f} ({loss_err:.3e}), remat's gradient against "
              f"loss's on the card {remat_err:.3e}; fp64 gradients {grad_err:.3e}, params "
              f"{param_err:.3e} and momentum {mom_err:.3e} after one train_step (tol "
              f"{PARITY_TOL:g} each); for information, fp32 gradients {grad32_err:.3e}; "
              f"{time.perf_counter() - t0:.1f}s")
        for what, err in (("logits", logit_err), ("loss", loss_err), ("remat gradient", remat_err),
                          ("fp64 gradient", grad_err), ("fp64 params", param_err),
                          ("fp64 momentum", mom_err)):
            require(err < PARITY_TOL, f"cnn parity {name}: {what} differs by {err:.3e}")


def _zero_overhead(trace, hw) -> tuple[float, str, float]:
    """Table II: the largest zero-overhead load reduction over the four
    scores at grid 24, as ``benchmarks/bench_autoswap.py`` computes it ->
    (reduction, score, overhead)."""
    from repro_torch.core.autoswap import AutoSwapPlanner

    pl = AutoSwapPlanner(trace, hw)
    best_limit, best, best_m = pl.peak_load, 0.0, "none"
    for m in SCORERS:
        limit, ov = pl.max_zero_overhead_reduction(method=m, grid=24)
        if limit < best_limit:
            best_limit, best, best_m = limit, ov, m
    return 1 - best_limit / pl.peak_load, best_m, best


def phase_cnn_plans() -> dict:
    """Each CNN_CELLS step traced by ``cnn_trace`` (plain and memonger's
    remat), then on copies priced under H100_SXM: the plan pipeline (the
    verifier and the byte-for-byte round trip fatal), Table I's SmartPool
    chi/w and CnMem/w, Table II's zero-overhead reduction (and under the
    paper's GTX_1080TI beside it), and the memonger row (the remat trace's
    w reduction and simulated time against the plain one's, as
    ``benchmarks/bench_baseline_policies.py`` computes them).  -> per cell
    and step, w and the two pools' footprints."""
    import copy

    from repro_torch.core.simulator import GTX_1080TI, H100_SXM, assign_times
    from repro_torch.models.cnn import cnn_trace
    from repro_torch.plan import PlanKey

    rows = {}
    for name, B in CNN_CELLS:
        t0 = time.perf_counter()
        traces = {"plain": cnn_trace(name, B), "remat": cnn_trace(name, B, remat=True)}
        capture_s = time.perf_counter() - t0
        priced = {}
        for tag, tr in traces.items():
            h = assign_times(copy.deepcopy(tr), H100_SXM)
            prog, _, solve_s, checks, nbytes = plan_and_check(
                h, PlanKey(name, f"train:b{B}:{tag}", H100_SXM.name), H100_SXM)
            omega = tr.peak_load()
            pools = (prog.pool_plans["best_fit"].footprint, prog.baselines["cnmem"].footprint)
            priced[tag] = h
            rows[(name, B, tag)] = (omega, *pools)
            red, m, ov = _zero_overhead(h, H100_SXM)
            red_gtx, m_gtx, ov_gtx = _zero_overhead(tr, GTX_1080TI)
            print(f"[13] {name} B{B} {tag} step: {len(tr.variables)} variables, w {omega:,} B; "
                  f"Table I: SmartPool chi/w {pools[0] / omega:.4f}, CnMem {pools[1] / omega:.4f}; "
                  f"Table II under {H100_SXM.name}: zero-overhead reduction {red:.1%} ({m}, "
                  f"overhead {ov:.2%}; under {GTX_1080TI.name} {red_gtx:.1%} ({m_gtx})), "
                  f"iteration {h.op_times[-1] * 1e3:.3f} ms simulated; solved in {solve_s:.2f}s, "
                  f"verifier ok ({checks} checks), round trip byte-equal ({nbytes:,} B)")
        red = 1 - traces["remat"].peak_load() / traces["plain"].peak_load()
        ov = priced["remat"].op_times[-1] / priced["plain"].op_times[-1] - 1
        print(f"[13] {name} B{B} memonger (segmented remat) under {H100_SXM.name}: w reduction "
              f"{red:.1%}, simulated overhead {ov:.1%}; traced in {capture_s:.2f}s")
    return rows


# The learning rate of phase 13's runs.  The reference's BN-free resnet50 at
# He init has logits in the hundreds (loss 173 at B100), and its default lr
# 0.01 overflows in two steps (printed beside each cell); the lr is a
# constant of the update, so the traced step is the same at any.
CNN_LR = 1e-5


def _live_at_peak(snapshot, base: int, top: int = 4) -> str:
    """The largest blocks live at the peak of a recorded allocation history,
    each with the line of ``models/cnn.py`` that allocated it (none for the
    autograd engine's backward, which runs no Python)."""
    live, cur, best = {}, base, (base, {})
    for e in snapshot["device_traces"][0]:
        if e["action"] == "alloc":
            where = next((f"cnn.py:{f['line']} {f['name']}" for f in e.get("frames", [])
                          if f.get("filename", "").endswith("models/cnn.py")), "backward")
            live[e["addr"]] = (e["size"], where)
            cur += e["size"]
            if cur > best[0]:
                best = (cur, dict(live))
        elif e["action"] == "free_completed" and e["addr"] in live:
            cur -= live.pop(e["addr"])[0]
    blocks = sorted(best[1].values(), reverse=True)[:top]
    return ", ".join(f"{size:,} B ({where})" for size, where in blocks)


def phase_cnn_run(rows: dict, held: int, held_reserved: int):
    """Each CNN_CELLS cell run on the card from seeded weights: 3
    ``train_step``s at CNN_LR on seeded random CIFAR-shaped batches (losses,
    each taken by a forward before its step, must be finite; ms a step;
    and, printed only, the loss after one step at the reference's lr 0.01),
    then around one warm step of each kind, with params, momentum and
    batch resident and the allocator's cache and cuBLAS workspaces
    emptied first: the real peak beside the trace's w (w above it fails,
    as in phase 7 (a)), the largest blocks live at the plain step's peak, and the
    caching allocator's reserved peak beside SmartPool's and CnMem's
    footprints (printed only)."""
    from repro_torch.models import CNN

    for name, B in CNN_CELLS:
        cnn = CNN(name)
        gen = torch.Generator("cuda").manual_seed(0)
        params = cnn.init(gen)
        mom = cnn.zero_momentum(params)
        batches = [(torch.randn(B, 3, 32, 32, generator=gen, device="cuda"),
                    torch.randint(0, 10, (B,), generator=gen, device="cuda")) for _ in range(3)]
        with torch.no_grad():
            at_default = float(cnn.loss(cnn.train_step(params, mom, *batches[0])[0],
                                        *batches[1]))
        losses, ms = [], []
        for x, y in batches:
            with torch.no_grad():
                losses.append(float(cnn.loss(params, x, y)))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, mom = cnn.train_step(params, mom, x, y, lr=CNN_LR)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        print(f"[13] {name} B{B} trained 3 steps at lr {CNN_LR:g}: losses "
              f"{[round(v, 4) for v in losses]}, ms a step {[round(v, 2) for v in ms]} (the "
              f"first cold), {B / ms[-1] * 1e3:,.0f} images/s warm; one step at the "
              f"reference's lr 0.01 gives loss {at_default:.4g}")
        require(all(math.isfinite(v) for v in losses), f"{name} B{B}: non-finite loss")
        x, y = batches[-1]
        for tag, step in (("plain", cnn.train_step), ("remat", cnn.train_step_remat)):
            omega, smartpool, cnmem = rows[(name, B, tag)]
            step(params, mom, x, y)  # warm
            gc.collect()
            torch.cuda.synchronize()
            torch._C._cuda_clearCublasWorkspaces()
            torch.cuda.empty_cache()
            resident = torch.cuda.memory_allocated() - held
            torch.cuda.reset_peak_memory_stats()
            # Python stacks recorded while the autograd engine recomputes a
            # checkpointed segment crash it (torch 2.11), so only the plain
            # step's history is recorded.
            if tag == "plain":
                torch.cuda.memory._record_memory_history(max_entries=200_000, stacks="python")
            out = step(params, mom, x, y)
            torch.cuda.synchronize()
            blocks = ""
            if tag == "plain":
                blocks = (f"; largest blocks live at the peak: "
                          f"{_live_at_peak(torch.cuda.memory._snapshot(), resident + held)}")
                torch.cuda.memory._record_memory_history(enabled=None)
            peak = torch.cuda.max_memory_allocated() - held
            reserved = torch.cuda.max_memory_reserved() - held_reserved
            del out
            print(f"[13] {name} B{B} {tag} step, warm: real peak {peak:,} B ({resident:,} B of "
                  f"params, momentum and batch resident first) beside the trace's w {omega:,} B "
                  f"(w / peak {omega / peak:.4f}){blocks}; the caching allocator's reserved peak "
                  f"{reserved:,} B beside SmartPool's {smartpool:,} B "
                  f"({smartpool / reserved:.4f}) and CnMem's {cnmem:,} B ({cnmem / reserved:.4f})")
            require(omega <= peak, f"{name} B{B} {tag}: w {omega} B exceeds the real peak "
                                   f"{peak} B")
        del params, mom, batches, x, y


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


def kernel_time(prof, prefix: str) -> tuple[float, float]:
    """(device ms of the kernels whose names start with ``prefix``, device
    busy ms) in a torch.profiler trace."""
    ms = busy = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t = e.time_range.elapsed_us() / 1e3
            busy += t
            if re.search(rf"\b{prefix}", e.name):
                ms += t
    return ms, busy


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


def moe_breakdown(prof, cfg, tokens: int) -> str:
    """Self device time of a traced step's MoE ops by the op that ran them,
    found by their input shapes (one group of ``tokens`` T a call): the
    dispatch's (``models/moe.py``), forward and, in a train step, backward,
    on the token-expert pairs [1, T k] or [T, k], the
    dispatch buffer [E C + 1, d] (``index_put_`` into it, ``index_select``
    from it, and their backwards, ``index`` and ``index_add``) and the
    experts' padded output [1, E C, d]; the combine on [T, k, d]; the
    router's top-k; against the expert GEMMs (``aten::bmm`` with E leading
    and d or f among the other dims, forward and backward)."""
    from repro_torch.models.moe import capacity

    E, d, f, k = cfg.num_experts, cfg.d_model, cfg.moe_d_ff, cfg.top_k
    C = capacity(tokens, cfg)
    dispatch = ([1, tokens * k], [tokens, k], [E * C + 1, d], [1, E * C, d])
    by: dict[str, list] = {}
    for e in prof.key_averages(group_by_input_shape=True):
        t = e.self_device_time_total / 1e3
        shapes = [list(x) for x in (e.input_shapes or []) if isinstance(x, (list, tuple))]
        if t <= 0:
            continue
        if e.key == "aten::bmm" and any(s[:1] == [E] and (d in s[1:] or f in s[1:])
                                        for s in shapes):
            group = "expert GEMMs"
        elif e.key == "aten::topk":
            group = "top-k"
        elif [tokens, k, d] in shapes:
            group = f"combine {e.key}"
        elif any(s in dispatch for s in shapes):
            group = f"dispatch {e.key}"
        else:
            continue
        by.setdefault(group, [0.0, 0])
        by[group][0] += t
        by[group][1] += e.count
    total = sum(ms for g, (ms, _) in by.items() if g.startswith(("dispatch", "combine")))
    rows = sorted(by.items(), key=lambda kv: -kv[1][0])
    return (f"dispatch and combine {total:.2f} ms in all, expert GEMMs "
            f"{by.get('expert GEMMs', [0.0])[0]:.2f} ms; " +
            "; ".join(f"{g} {ms:.2f}ms ({n} calls)" for g, (ms, n) in rows))


def shape_breakdown(prof, shape) -> str:
    """Self device time of the ops with an input of ``shape``, by op."""
    by: dict[str, list] = {}
    for e in prof.key_averages(group_by_input_shape=True):
        shapes = [list(x) for x in (e.input_shapes or []) if isinstance(x, (list, tuple))]
        if e.self_device_time_total > 0 and list(shape) in shapes:
            by.setdefault(e.key, [0.0, 0])
            by[e.key][0] += e.self_device_time_total / 1e3
            by[e.key][1] += e.count
    total = sum(ms for ms, _ in by.values())
    return f"{total:.2f} ms in all; " + "; ".join(
        f"{key} {ms:.2f}ms ({n} calls)" for key, (ms, n) in sorted(by.items(),
                                                                   key=lambda kv: -kv[1][0]))


# Phase 6's traced decode steps a model (``phase_profile``): one, so that the
# whole script, phase 16 included, stays near its length before that phase.
TRACED_DECODE_STEPS = 1


def phase_profile(arch: str, B: int, P: int, G: int):
    """Where the time goes in the served model: a warm prefill and warm decode
    steps at the serve phase's shapes, timed untraced over ``steps`` decode
    steps, then traced once each, the decode over ``traced_steps`` (the
    profiler's parse of a trace takes seconds for each step of a 27-layer
    MoE, while the shares of a step change little from one to the next)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_batch, serve_lengths
    from repro_torch.models import build_model

    cfg = get_config(arch)
    steps, traced_steps = 16, TRACED_DECODE_STEPS
    t0 = time.perf_counter()
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator("cuda").manual_seed(0))
    batch = serve_batch(cfg, B, P, 0, "cuda")
    max_seq, pos0 = serve_lengths(cfg, P, G)

    def prefill():
        logits, cache = model.prefill(params, batch, max_seq=max_seq)
        return logits[:, -1].argmax(-1, keepdim=True), cache

    def decode(tok, cache, steps=steps):
        for i in range(steps):
            logits, cache = model.decode_step(params, cache, tok, pos0 + i)
            tok = logits[:, -1].argmax(-1, keepdim=True)
        return tok

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    decode(*prefill())  # warm: lazily loaded library kernels, allocator
    t_warm = time.perf_counter()
    (tok, cache), prefill_ms = timed(prefill)
    _, decode_ms = timed(decode, tok, cache)
    encoder = ""
    if cfg.is_encoder_decoder:
        _, enc_ms = timed(model.encode, params, batch["frames"])
        encoder = f" (the encoder alone over {cfg.enc_seq} frames {enc_ms:.2f} ms)"
    print(f"[6] profile {arch} B{B} P{P}, warm, untraced: prefill {prefill_ms:.2f} ms{encoder}, "
          f"decode {decode_ms / steps:.2f} ms/step ({B * steps / decode_ms * 1e3:.1f} tok/s)")
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t_traced = time.perf_counter()
    with profile(activities=acts, record_shapes=True) as prof:
        (tok, cache), wall = timed(prefill)
    print(f"  prefill traced: {device_breakdown(prof, wall)}")
    print(f"  prefill by op: {op_breakdown(prof)}")
    moe_prefill = moe_breakdown(prof, cfg, B * P) if cfg.num_experts else None
    t_decode = time.perf_counter()
    with profile(activities=acts, record_shapes=True) as prof:
        _, wall = timed(decode, tok, cache, traced_steps)
    print(f"  decode ({traced_steps} steps) traced: {device_breakdown(prof, wall)}")
    print(f"  decode by op: {op_breakdown(prof)}")
    if cfg.num_experts:
        print(f"  MoE dispatch against the expert GEMMs: prefill {moe_prefill}; decode "
              f"({traced_steps} steps) {moe_breakdown(prof, cfg, B)}")
    t_end = time.perf_counter()
    print(f"  seconds: build, init and warm run {t_warm - t0:.1f}, untraced runs "
          f"{t_traced - t_warm:.1f}, traced prefill and its parse {t_decode - t_traced:.1f}, "
          f"traced decode and its parse {t_end - t_decode:.1f}")


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


def plan_and_check(trace, key, hw, swaps: bool = True):
    """The plan pipeline on ``trace`` under ``hw``: SmartPool and the baseline
    pools, and with ``swaps`` AutoSwap's four scores at LIMIT_FRACS of the
    peak load and OffloadLowering; fatal unless the static verifier passes
    and the artifact round-trips byte for byte.  -> (program, limits, solve
    s, verifier checks, artifact bytes)."""
    from repro_torch.analyze import verify_program
    from repro_torch.plan import (MemoryProgram, OffloadLowering, PassContext, Pipeline,
                                  PoolPlacement, SwapSelection, TimingAssign, dumps_canonical,
                                  program_from_json)

    peak = trace.peak_load()
    limits = [int(peak * f) for f in LIMIT_FRACS] if swaps else []
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


def phase_captured_plans(B: int, S: int, cfg=None, phase: str = "7", swaps: bool = True,
                         grad_cfg=None):
    """The full qwen3-4b train step (or ``cfg``'s) captured by the port's
    graph tracer (on fake CUDA tensors: no memory, no launch) two ways, each
    planned under H100_SXM by ``plan_and_check`` (with AutoSwap where
    ``swaps``): (a) ``model.loss(params, batch)[0]``, the step
    ``train --plan`` plans; (b) the loss and ``torch.autograd.grad`` of it
    with respect to the params, under per-layer remat, of ``grad_cfg``
    (by default ``cfg``).  Then both run for
    real at the same fp32 masters and batch, which are resident first, and
    the card's peak stands beside the trace's peak load w.  (a)'s w above
    its real peak is fatal: the trace frees each variable at its last use,
    the earliest any run can, so a larger w counts memory that never
    existed.  (b)'s is printed only: the real run holds every gradient
    until the step ends, and eager autograd accumulates a tied embedding's
    gradient in place, where the graph adds out of place (qwen3-4b: up to
    one fp32 table, 151,936 x 2,560 x 4 B).  -> {tag: (w, real peak)}."""
    from repro_torch.configs import get_config
    from repro_torch.core.simulator import H100_SXM
    from repro_torch.core.trace import _leaf_paths, capture_graph, trace_graph
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import build_model
    from repro_torch.plan import PlanKey
    from repro_torch.tree import tree_leaves

    cfg = cfg or get_config("qwen3-4b")
    models = {"a": build_model(cfg, "cuda"), "b": build_model(grad_cfg or cfg, "cuda")}

    def loss(params, batch):
        return models["a"].loss(params, batch)[0]

    def loss_and_grad(params, batch):
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        value = models["b"].loss(params, batch)[0]
        return (value, *torch.autograd.grad(value, leaves))

    probe = {k: torch.empty(B, S, dtype=torch.long, device="meta") for k in ("tokens", "labels")}
    omega = {}
    for tag, fn in (("a", loss), ("b", loss_and_grad)):
        name = models[tag].cfg.name
        shapes = models[tag].init_shapes(torch.float32)
        t0 = time.perf_counter()
        gm = capture_graph(fn, shapes, probe, device="cuda")
        trace = trace_graph(gm, arg_names=_leaf_paths((shapes, probe)))
        capture_s = time.perf_counter() - t0
        zero = zero_byte_nodes(gm)
        key = PlanKey(name, f"train:b{B}s{S}:{'loss' if tag == 'a' else 'grad'}",
                      H100_SXM.name)
        prog, limits, solve_s, checks, nbytes = plan_and_check(trace, key, H100_SXM, swaps)
        peak = trace.peak_load()
        omega[tag] = peak
        labels = {n: sum(v.name == n for v in trace.variables)
                  for n in ("block_in", "attn_out", "ffn_out")}
        print(f"[{phase}] captured ({tag}) {'loss' if tag == 'a' else 'loss + grad (remat)'} "
              f"{name} "
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
        if tag == "a" and swaps and cfg.name == "qwen3-4b":
            got = (len(trace.variables),
                   tuple(round(prog.swap_summaries[f"swdoa@{lim}"].selected_bytes / 1e9, 2)
                         for lim in limits))
            print(f"  C1: variables and swdoa's GB at {LIMIT_FRACS} of w {got}; the CPU run "
                  f"of the same code under torch 2.13 {CPU_CAPTURE_A}: "
                  f"{'equal' if got == CPU_CAPTURE_A else 'NOT equal'}")

    held = release_memory(phase)
    batch = make_batch_fn(cfg, B, S, 0, "cuda")(0)
    peaks = {}
    for tag, fn in (("a", loss), ("b", loss_and_grad)):
        params = models[tag].init(torch.Generator("cuda").manual_seed(0), dtype=torch.float32)
        gc.collect()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(params, batch)
        torch.cuda.synchronize()
        real = torch.cuda.max_memory_allocated() - held
        value = float((out if tag == "a" else out[0]).detach())
        del out, params
        peaks[tag] = (omega[tag], real)
        print(f"[{phase}] captured ({tag}) run for real: loss {value:.4f}, peak "
              f"{real:,} B on the card ({resident - held:,} B of params and batch resident "
              f"first) beside the trace's w {omega[tag]:,} B (w / peak "
              f"{omega[tag] / real:.4f})")
        require(math.isfinite(value), f"captured ({tag}): non-finite loss")
        if tag == "a":
            require(omega[tag] <= real, f"captured (a): w {omega[tag]} B exceeds the real peak "
                                        f"{real} B")
    del batch
    return peaks


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


EXAMPLE = Path(__file__).resolve().parent / "examples" / "serve_batched_torch.py"


def phase_example() -> dict[str, int]:
    """``examples/serve_batched_torch.py`` on the card, as a user runs it:
    qwen3-4b's, gemma3-4b's and mamba2-370m's smoke models (fp32: flash and
    the SSD ``simt``, RMSNorm ``vector``) each served twice, its own
    assertion that the two runs' tokens are equal.  -> launch counts."""
    import importlib.util

    from repro_torch.kernels import ops

    spec = importlib.util.spec_from_file_location("serve_batched_torch", EXAMPLE)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    release_memory("15")
    out = io.StringIO()
    ops.reset_launch_counts()
    with contextlib.redirect_stdout(out):
        gens = example.main([])
    counts = ops.launch_counts()
    print("[15] example serve_batched_torch.py on the card:")
    for line in out.getvalue().strip().splitlines():
        print(f"  {line}")
    print(f"  launches {counts}")
    require(out.getvalue().strip().endswith("deterministic across repeats: OK"),
            "example: no determinism line")
    require(sorted(gens) == sorted(example.ARCHS), f"example served {sorted(gens)}")
    require(counts["rmsnorm"] > 0 and counts["flash_attention"] > 0 and counts["ssd_scan"] > 0,
            f"example: a kernel was not launched {counts}")
    return counts


# Phase 16: deepseek-v2-lite-16b trained at every published width on one
# card.  Its 27 layers need about 251 GB of fp32 state (16 B a parameter:
# masters, gradients, AdamW's m and v), so the card trains a depth cut: the
# dense layer and MOE_LAYERS MoE layers, 3,424,678,912 parameters, 54.79 GB
# of state.
DEEPSEEK = "deepseek-v2-lite-16b"
MOE_LAYERS = 5
# deepseek's parameters by part: the token table and the untied head; the
# final norm; the dense layer (MLA, the 10,944-wide SwiGLU, two norms); an
# MoE layer (MLA, 64 experts and 2 shared of 1,408, the fp32 router).
DEEPSEEK_PARAMS = {"embed": 2 * 102_400 * 2048, "final_norm": 2048, "dense": 81_007_104,
                   "moe": 584_847_872}


def deepseek_cut(moe_layers: int):
    """deepseek-v2-lite-16b at every published width (64 experts top-6, 2
    shared, MLA with kv_lora 512, vocab 102,400, the untied head), bf16, cut
    to its dense layer and ``moe_layers`` MoE layers, and named apart from
    the full model, so that its plans are its own."""
    from repro_torch.configs import get_config

    full = get_config(DEEPSEEK)
    (dense,), _ = full.program[0]
    (moe_spec,), _ = full.program[1]
    return full.reduced(name=f"{DEEPSEEK}-cut{1 + moe_layers}", num_layers=1 + moe_layers,
                        program=(((dense,), 1), ((moe_spec,), moe_layers)))


def recompute_routing(records, n_moe: int) -> list[bool]:
    """From a run's routing records (each step: the n_moe MoE layers'
    forwards, then, in backward, their recomputes, top layer first): for
    each layer of each step, whether the recompute routed as the forward."""
    per = 2 * n_moe
    out = []
    for i in range(0, len(records), per):
        step = records[i:i + per]
        out += [_routed(f) == _routed(r) for f, r in zip(step[:n_moe], reversed(step[n_moe:]))]
    return out


def phase_train_cut(B: int, S: int, steps: int, want: dict[str, int], extra=None,
                    phase="16b", what="remat"):
    """Train ``deepseek_cut(MOE_LAYERS)`` through the training launcher's own loop
    (``train.train``: fp32 masters, bf16 compute, per-layer remat, chunked
    loss, AdamW), ``extra`` its keyword arguments, with the routing of every
    MoE call recorded: finite losses, ce and aux, ms a step, tokens/s, the
    peak beside the state's arithmetic and under the card's memory, each
    layer's recompute routed as its forward, and exact launch counts by
    variant.  -> (launch counts, the ``TrainRun``, peak bytes, output)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import build_model, moe
    from repro_torch.tree import tree_leaves

    cfg = deepseek_cut(MOE_LAYERS)
    n = sum(t.numel() for t in tree_leaves(build_model(cfg, "cpu").init_shapes(torch.float32)))
    want_n = (DEEPSEEK_PARAMS["embed"] + DEEPSEEK_PARAMS["final_norm"] + DEEPSEEK_PARAMS["dense"]
              + MOE_LAYERS * DEEPSEEK_PARAMS["moe"])
    require(n == want_n, f"{cfg.name}: {n:,} parameters, the arithmetic gives {want_n:,}")
    held = release_memory(phase)
    out, records = io.StringIO(), []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), moe.routing_hook(records.append):
        run = train.train(cfg, steps=steps, batch=B, seq=S, seed=0, log_every=1,
                          **(extra or {}))
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    card = torch.cuda.get_device_properties(0).total_memory
    text = out.getvalue()
    recompute = recompute_routing(records, MOE_LAYERS)
    warm = run.step_ms[1:]
    print(f"[{phase}] train {cfg.name} (the dense layer and {MOE_LAYERS} MoE layers at full "
          f"width, {n:,} parameters, fp32 masters, bf16 compute, {what}) B{B} S{S}, {steps} "
          f"steps:")
    for line in text.strip().splitlines():
        print(f"  {line}")
    print(f"  losses {run.losses}; ce {[m['ce'] for m in run.metrics]}; aux "
          f"{[m['aux'] for m in run.metrics]}; grad norm {[m['grad_norm'] for m in run.metrics]}")
    print(f"  host ms a step (synchronised) {[round(t, 1) for t in run.step_ms]}; warm median "
          f"{float(np.median(warm)):.1f} ms, {B * S / float(np.median(warm)) * 1e3:.0f} "
          f"tokens/s; peak memory {peak / 1e9:.2f} GB ({peak / 2**30:.2f} GiB) beside "
          f"{16 * n / 1e9:.2f} GB of fp32 state (16 B x {n:,}: masters, gradients, m, v) and "
          f"{card / 2**30:.2f} GiB on the card, {(card - peak) / 1e9:.2f} GB free at the peak "
          f"({held / 2**30:.3f} GiB held before the run); each layer's recompute routed as its "
          f"forward {sum(recompute)}/{len(recompute)} ({len(records)} MoE calls); launches "
          f"{counts}; wall {wall:.1f}s (init included)")
    require(len(run.losses) == steps and all(math.isfinite(x) for x in run.losses),
            f"train cut: losses {run.losses}")
    require(all(math.isfinite(m["ce"]) and math.isfinite(m["aux"]) for m in run.metrics),
            f"train cut: metrics {run.metrics}")
    require(peak < card, f"train cut: peak {peak} B exceeds the card's {card} B")
    require(len(records) == 2 * MOE_LAYERS * steps and all(recompute),
            f"train cut: {len(records)} MoE calls, recomputes routed as forwards {recompute}")
    require(counts == want, f"train cut: launch counts {counts}, want {want}")
    run.params = run.opt = None  # the 54.79 GB of state would stay on the card
    return counts, run, peak, text


def phase_train_cut_offload(B: int, S: int, steps: int, want: dict[str, int], plain):
    """The cut's loss step planned by the training launcher's planner under H100_SXM
    (``train.step_planner`` under the cut's own key, solved into PLAN_DIR)
    at half its peak load w, rounded down to 0.01 GiB, which must name a
    label; then ``train.train`` at that limit, the plan restored from its
    cache, for phase 16b's steps, seed and batches: losses within 1e-6
    relative of ``plain``'s (16b's ``TrainRun``), launch counts equal to
    16b's, each layer's recompute under the policy routed as its forward,
    and the bytes moved each way a step exactly the layers x the names
    offloaded x one activation [B, S, d] in bf16."""
    from repro_torch.launch import train
    from repro_torch.models import build_model

    cfg = deepseek_cut(MOE_LAYERS)
    t0 = time.perf_counter()
    planner = train.step_planner(build_model(cfg, "cuda"), cfg.name, B, S, False,
                                 str(PLAN_DIR))
    rep = planner.report()
    omega = rep.peak_load
    gb = math.floor(omega / 2 / 2**30 * 100) / 100
    limit = int(gb * 2**30)
    plan = planner.offload_plan(limit)
    sw = planner.swap_report(limit)
    print(f"[16d] plan: loss step of {cfg.name} B{B} S{S} (fp32 masters) traced and planned "
          f"under H100_SXM in {time.perf_counter() - t0:.1f}s: {rep.num_variables} variables, w "
          f"{omega:,} B, SmartPool chi/w {rep.smartpool_ratio:.4f}, CnMem/w "
          f"{rep.cnmem_ratio:.4f}; limit {gb} GiB ({limit:,} B, {limit / omega:.4f} w): "
          f"offload_names {plan.offload_names}, save_names {plan.save_names}, "
          f"predicted_savings {plan.predicted_savings:,} B, transfer_bytes "
          f"{plan.transfer_bytes:,} B; swdoa selects {sw.num_selected} variables, "
          f"{sw.selected_bytes:,} B, simulated overhead {sw.overhead * 100:.2f}%, stalls "
          f"{sw.stalls}")
    require(plan.offload_names, f"the plan at {gb} GiB names no label")
    counts, run, peak, text = phase_train_cut(
        B, S, steps, want, extra=dict(hbm_limit_gb=gb, plan_cache=str(PLAN_DIR)),
        phase="16d", what=f"remat, offloading {plan.offload_names}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(run.losses, plain.losses))
    per_step = cfg.num_layers * len(plan.offload_names) * B * S * cfg.d_model * 2
    print(f"[16d] offload against 16b: largest relative loss difference {rel:.3e} "
          f"({'equal bits' if run.losses == plain.losses else 'not equal bits'}); bytes a step "
          f"to host and back {run.moved} (want {per_step:,} each); peak {peak / 1e9:.2f} GB; "
          f"host ms a step {[round(t, 1) for t in run.step_ms]} against "
          f"{[round(t, 1) for t in plain.step_ms]}")
    require("(restored from cache)" in text, "train cut offload: the plan was not restored")
    require(rel <= 1e-6, f"train cut offload: losses {run.losses} against {plain.losses}")
    require(run.moved == [(per_step, per_step)] * steps,
            f"train cut offload: bytes {run.moved}; want {per_step} each way a step")
    return counts


# Phase 17: fault-tolerant training.  A qwen3-4b cut of CKPT_LAYERS layers at
# every published width (vocab 151,936, d 2560, GQA 32/8 x 128, qk-norm, d_ff
# 9728), fp32 masters: the tied table 151,936 x 2,560, each layer (q, k, v, o,
# the SwiGLU's three, ln1, ln2, q-norm, k-norm) 100,930,816, the final norm
# 2,560.  A checkpoint holds masters, m and v, 12 B a parameter, and the count.
QWEN3_PARAMS = {"embed": 151_936 * 2560, "layer": 100_930_816, "final_norm": 2560}
CKPT_LAYERS = 2
# Checkpoints land here, inside the checkout, and are removed after the phase.
CKPT_ROOT = Path(__file__).resolve().parent / "build" / "ckpt"
EXAMPLE_100M = Path(__file__).resolve().parent / "examples" / "train_100m_torch.py"


def qwen3_cut(layers: int):
    """qwen3-4b at every published width, cut to ``layers`` layers and named
    apart from the full model."""
    from repro_torch.configs import get_config

    full = get_config("qwen3-4b")
    ((unit, _),) = full.program
    return full.reduced(name=f"qwen3-4b-cut{layers}", num_layers=layers,
                        program=((unit, layers),))


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def phase_checkpoint(B: int, S: int, steps: int, per_step: dict[str, int]):
    """(a) ``qwen3_cut(CKPT_LAYERS)`` through ``train.train`` for ``steps``
    steps three times: U uninterrupted; F with ``ckpt_dir``, ``ckpt_every=4``
    and ``fail_at=6`` (an async save at step 4, joined before the injected
    failure leaves); R, F relaunched, which resumes at step 5 and saves at
    the last step.  F's losses must equal U's steps 0-5 and R's U's steps
    5-7 bit for bit, R must print its resume, the last checkpoint restored
    onto CPU tensors must equal U's final masters, m and v bit for bit with
    count ``steps``, its bytes the arithmetic, the directory steps 4 and 7
    and no ``.tmp``, and each run's launch counts ``per_step`` times its
    steps.  -> {path: launch counts}."""
    from repro_torch.checkpoint import latest_step, restore_pytree
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_leaves

    cfg = qwen3_cut(CKPT_LAYERS)
    shapes = build_model(cfg, "cpu").init_shapes(torch.float32)
    n = sum(t.numel() for t in tree_leaves(shapes))
    want_n = QWEN3_PARAMS["embed"] + CKPT_LAYERS * QWEN3_PARAMS["layer"] + \
        QWEN3_PARAMS["final_norm"]
    state_bytes = 12 * n
    print(f"[17a] {cfg.name}: {n:,} parameters (arithmetic: {QWEN3_PARAMS['embed']:,} tied "
          f"embedding + {CKPT_LAYERS} x {QWEN3_PARAMS['layer']:,} + "
          f"{QWEN3_PARAMS['final_norm']:,} = {want_n:,}); a checkpoint holds masters, m and v, "
          f"12 B a parameter: {state_bytes:,} B, and the count")
    require(n == want_n, f"checkpoint: {n:,} parameters, the arithmetic gives {want_n:,}")
    shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    CKPT_ROOT.mkdir(parents=True)
    free = shutil.disk_usage(CKPT_ROOT).free
    print(f"[17a] disk: {free:,} B free under {CKPT_ROOT.relative_to(SRC.parent)}, "
          f"{3 * state_bytes:,} B needed for three checkpoints")
    require(free >= 3 * state_bytes, f"checkpoint: {free:,} B free on the disk, three "
            f"checkpoints of {cfg.name} need {3 * state_bytes:,} B")
    # The disk's own rates beside the saves' and restores': 1 GiB of random
    # bytes written in one call and fsynced, then read back (warm: the page
    # cache holds it).
    probe, blob = CKPT_ROOT / "probe", np.random.default_rng(0).bytes(2**30)
    t0 = time.perf_counter()
    with open(probe, "wb") as fh:
        fh.write(blob)
        fh.flush()
        os.fsync(fh.fileno())
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = probe.read_bytes()
    read_s = time.perf_counter() - t0
    print(f"[17a] disk: 1 GiB written and fsynced at {2**30 / write_s / 1e9:.2f} GB/s, read "
          f"back (warm) at {2**30 / read_s / 1e9:.2f} GB/s")
    require(back == blob, "checkpoint: the disk probe read back other bytes")
    probe.unlink()
    del blob, back
    ckpt = str(CKPT_ROOT / cfg.name)
    common = dict(steps=steps, batch=B, seq=S, seed=0, log_every=1)

    def counted(label, fn):
        held = release_memory("17a")
        out = io.StringIO()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            run = fn()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        print(f"[17a] {label}: wall {wall:.1f}s, peak {peak / 1e9:.2f} GB ({held / 2**30:.3f} "
              f"GiB held before), launches {counts}")
        for line in out.getvalue().strip().splitlines():
            print(f"  {line}")
        return run, counts, out.getvalue()

    def failed():
        try:
            train.train(cfg, ckpt_dir=ckpt, ckpt_every=4, fail_at=6, **common)
        except train.InjectedFailure as e:
            print(f"  raised: {e}")
            return e.run
        raise AssertionError("F did not raise its injected failure")

    u, u_counts, _ = counted("U, uninterrupted", lambda: train.train(cfg, **common))
    want_leaves = [t.detach().cpu() for t in tree_leaves((u.params, u.opt.m, u.opt.v))]
    u_count = u.opt.count
    u.params = u.opt = None
    f, f_counts, _ = counted("F, ckpt_every 4, fail_at 6", failed)
    after_f = sorted(os.listdir(ckpt))
    r, r_counts, r_text = counted("R, F relaunched",
                                  lambda: train.train(cfg, ckpt_dir=ckpt, ckpt_every=4,
                                                      **common))
    r.params = r.opt = None
    t0 = time.perf_counter()
    (params, opt), step = restore_pytree((shapes, adamw_init(shapes)), ckpt, device="cpu")
    restore_cpu_s = time.perf_counter() - t0
    got_leaves = tree_leaves((params, opt.m, opt.v))
    equal = [_bits_equal(g, w) for g, w in zip(got_leaves, want_leaves)]
    got_bytes = sum(t.numel() * t.element_size() for t in got_leaves)
    listing = sorted(os.listdir(ckpt))
    shard = Path(ckpt) / f"step_{step:08d}" / "shard_0.npz"
    manifest = json.loads((shard.parent / "MANIFEST.json").read_text())
    warm = float(np.median(u.step_ms[1:]))
    print(f"[17a] U losses {u.losses}")
    print(f"[17a] F losses {f.losses} ({'equal bits' if f.losses == u.losses[:6] else 'NOT EQUAL'}"
          f" to U's steps 0-5); R losses {r.losses} ("
          f"{'equal bits' if r.losses == u.losses[5:] else 'NOT EQUAL'} to U's steps 5-7)")
    print(f"[17a] directory after F {after_f}, after R {listing}; restored step {step} onto "
          f"CPU tensors in {restore_cpu_s:.2f}s: {sum(equal)}/{len(equal)} leaves (masters, m, v) "
          f"equal bits to U's final, count {opt.count} (U {u_count}); {got_bytes:,} B of "
          f"leaves (arithmetic {state_bytes:,}), shard file {shard.stat().st_size:,} B, "
          f"manifest {manifest['num_leaves']} leaves")
    for label, run in (("F", f), ("R", r)):
        for sv in run.saves:
            print(f"[17a] {label} save of step {sv['step']} ({'async' if sv['async'] else 'sync'}): "
                  f"snapshot blocked the caller {sv['snapshot_ms']:.1f} ms, write "
                  f"{sv['write_s']:.2f}s {'on its thread' if sv['async'] else 'in the caller'} "
                  f"({state_bytes / sv['write_s'] / 1e9:.2f} GB/s)")
    print(f"[17a] R restored step 4 onto the card in {r.restore_s:.2f}s "
          f"({state_bytes / r.restore_s / 1e9:.2f} GB/s); host ms a step: U "
          f"{[round(t, 1) for t in u.step_ms]} (warm median {warm:.1f}), F "
          f"{[round(t, 1) for t in f.step_ms]} (step 5, with the save of step 4 in flight: "
          f"{f.step_ms[5]:.1f}), R {[round(t, 1) for t in r.step_ms]}")
    want_counts = {k: v * steps for k, v in per_step.items()}
    require(all(math.isfinite(x) for x in u.losses) and len(u.losses) == steps,
            f"checkpoint: U's losses {u.losses}")
    require(f.losses == u.losses[:6], f"checkpoint: F's losses {f.losses}, U's {u.losses[:6]}")
    require(r.losses == u.losses[5:], f"checkpoint: R's losses {r.losses}, U's {u.losses[5:]}")
    require("[resume] restored checkpoint, continuing at step 5" in r_text,
            "checkpoint: R did not print its resume at step 5")
    require([sv["step"] for sv in f.saves] == [4] and f.saves[0]["async"],
            f"checkpoint: F's saves {f.saves}")
    require([sv["step"] for sv in r.saves] == [steps - 1], f"checkpoint: R's saves {r.saves}")
    require(step == steps - 1 and latest_step(ckpt) == steps - 1, f"checkpoint: last step {step}")
    require(len(equal) == len(want_leaves) and all(equal) and opt.count == u_count == steps,
            f"checkpoint: {equal.count(False)} leaves differ from U's, count {opt.count}")
    require(got_bytes == state_bytes, f"checkpoint: {got_bytes:,} B, want {state_bytes:,}")
    require(after_f == ["step_00000004"] and listing == ["step_00000004", f"step_{steps - 1:08d}"],
            f"checkpoint: directory after F {after_f}, after R {listing}")
    for label, counts, k in (("U", u_counts, steps), ("F", f_counts, 6), ("R", r_counts, 3)):
        want = {name: v * k for name, v in per_step.items()}
        require(counts == want, f"checkpoint: {label}'s launches {counts}, want {want}")
    shutil.rmtree(ckpt)
    return {f"train {cfg.name} (U)": u_counts, f"train {cfg.name} (F)": f_counts,
            f"train {cfg.name} (R)": r_counts}


def phase_example_100m(per_step: dict[str, int]) -> dict[str, dict[str, int]]:
    """(b) ``examples/train_100m_torch.py`` on the card, as a user runs it:
    ``--steps 60`` (an async save at step 50, the final one at 59), then
    ``--steps 70`` in the same directory, which must resume at step 60 and
    run steps 60-69; launch counts ``per_step`` times each run's steps.
    -> {path: launch counts}."""
    import importlib.util

    from repro_torch.checkpoint import latest_step
    from repro_torch.kernels import ops

    spec = importlib.util.spec_from_file_location("train_100m_torch", EXAMPLE_100M)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    ckpt = str(CKPT_ROOT / "100m")
    paths = {}
    for steps, done in ((60, 0), (70, 60)):
        release_memory("17b")
        out = io.StringIO()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            losses = example.main(["--steps", str(steps), "--ckpt-dir", ckpt])
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        text = out.getvalue()
        print(f"[17b] example train_100m_torch.py --steps {steps}: wall {wall:.1f}s, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches {counts}")
        for line in text.strip().splitlines():
            print(f"  {line}")
        want = {k: v * (steps - done) for k, v in per_step.items()}
        require(len(losses) == steps - done and all(math.isfinite(x) for x in losses),
                f"example 100m: losses {losses}")
        require("params=93.5M" in text, "example 100m: no parameter count line")
        require(("resumed at step 60" in text) == bool(done),
                f"example 100m --steps {steps}: resume line")
        require(counts == want, f"example 100m: launches {counts}, want {want}")
        paths[f"example train_100m --steps {steps}"] = counts
    listing = sorted(os.listdir(ckpt))
    print(f"[17b] directory {listing}")
    require(latest_step(ckpt) == 69 and listing == ["step_00000059", "step_00000069"],
            f"example 100m: directory {listing}")
    shutil.rmtree(CKPT_ROOT)
    return paths


# Phase 18: mamba2-370m trained at every published width on one card: its 48
# layers hold 368,338,432 parameters, 5,893,414,912 B of fp32 state (16 B a
# parameter: masters, gradients, AdamW's m and v), so no depth is cut.
MAMBA = "mamba2-370m"


def ssd_bwd_case(b, s, h, p, g, n, dtype, gen, layout="dense", dstate=False, again=False):
    """``repro_torch::ssd_scan_bwd`` (the CUDA kernel ``bwd_variant`` names,
    whose launch it must count) against ``ssd_scan_bwd_plain`` on the card,
    on the same inputs: dx, ddt, dA, dBm and dCm, each relative to its
    max|want| under SSD_TOL.  ``layout`` as
    ``ssd_case``'s (``"views"``: x, B and C views into one tensor, as the
    model hands them over); ``dstate`` a nonzero cotangent of the final
    state (zeros otherwise, as training gives); ``again`` a second call,
    which must give every output bit for bit.  Timed (CUDA-graph replay)
    beside its bound (the function's bytes, ``bwd_flops``) and the plain
    backward on the card, a ``tc`` case with ``simt`` on the same inputs
    beside it (through ``_launch_bwd``, counting no launch); no single
    PyTorch call computes it."""
    from repro_torch.kernels.ssd_scan import (_launch_bwd, bwd_flops, bwd_variant, ssd_scan_bwd,
                                              ssd_scan_bwd_plain)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def make():
        if layout == "views":
            xbc = randn(b, s, h * p + 2 * g * n)
            x, Bm, Cm = (t.unflatten(-1, (k, d)) for t, k, d in zip(
                xbc.split([h * p, g * n, g * n], dim=-1), (h, g, g), (p, n, n)))
        else:
            x, Bm, Cm = randn(b, s, h, p), randn(b, s, g, n), randn(b, s, g, n)
        # dt and A as ssd_case draws them: the slow heads carry their state
        # across many chunks, so the carried state's gradient is checked.
        dt = F.softplus(randn(b, s, h).float() - 4.0).to(dtype)
        A = (-torch.linspace(1.0, 16.0, h, device="cuda")).to(dtype)
        ds = (torch.randn((b, h, p, n), generator=gen, device="cuda") if dstate
              else torch.zeros((b, h, p, n), device="cuda"))
        return x, dt, A, Bm, Cm, randn(b, s, h, p), ds

    args = make()
    var = bwd_variant(args[0], args[3], args[4])
    op = torch.ops.repro_torch.ssd_scan_bwd
    before = ssd_scan_bwd.variant_launches[var]
    got, want = op(*args), ssd_scan_bwd_plain(*args)
    torch.cuda.synchronize()
    require(ssd_scan_bwd.variant_launches[var] == before + 1,
            f"ssd_bwd x[{b},{s},{h},{p}] did not launch the {var} kernel")
    tol = SSD_TOL[dtype]
    rels = [((a.float() - w.float()).abs().max() / w.float().abs().max()).item()
            for a, w in zip(got, want)]
    ok = all(r < tol for r in rels) and all(bool(torch.isfinite(t).all()) for t in got)
    check = ("max|got-want| / max|want|: "
             + ", ".join(f"{k} {r:.3e}" for k, r in zip(("dx", "ddt", "dA", "dB", "dC"), rels))
             + f", each < {tol:g}")
    if again:
        same = all(torch.equal(a, c) for a, c in zip(got, op(*args)))
        ok = ok and same
        check += f"; a second call bit for bit: {same}"
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *got))
    b_ms, b_by = bound(nbytes, bwd_flops(b, s, h, p, n), dtype)
    sets = [args] + [make() for _ in range(n_copies(nbytes) - 1)]
    other = None
    if var == "tc":  # the simt kernel on the same inputs
        other = ("simt", time_ms(lambda *a: _launch_bwd("simt", *a), sets, 10))
    return {
        "case": f"ssd_bwd [{var}] x[{b},{s},{h},{p}] B/C[{b},{s},{g},{n}] {str(dtype)[6:]}"
                f"{LAYOUT_NOTE[layout]}{', dstate' if dstate else ''}",
        "variant": var, "ok": ok, "check": check, "other": other,
        "max_abs_err": max((a.float() - w.float()).abs().max().item() for a, w in zip(got, want)),
        "ms": time_ms(op, sets, 10), "plain_ms": time_ms(ssd_scan_bwd_plain, sets, 2),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
    }


def phase_mamba_bwd_kernels():
    """(a) The SSD backward kernels against their plain version: ``tc`` (bf16)
    at mamba2's training layout (B4 S2048 H32 P64, B and C of one group of
    128, bf16 views into one tensor, twice, bit for bit), a ragged length,
    two groups of N 16, a nonzero final-state cotangent, and the largest P
    and N; ``simt`` (fp32) dense, at a ragged length, with a nonzero
    final-state cotangent, and at the largest P and N.  -> the cases."""
    gen = torch.Generator("cuda").manual_seed(18)
    bf16, f32 = torch.bfloat16, torch.float32
    t0 = time.perf_counter()
    cases = [
        ssd_bwd_case(4, 2048, 32, 64, 1, 128, bf16, gen, "views", again=True),  # mamba2 training
        ssd_bwd_case(1, 1000, 4, 64, 1, 128, bf16, gen, again=True),  # ragged last chunk
        ssd_bwd_case(2, 256, 8, 64, 2, 16, bf16, gen, "views"),    # g 2 over h 8, N 16
        ssd_bwd_case(2, 300, 4, 64, 1, 128, bf16, gen, dstate=True),
        ssd_bwd_case(1, 200, 2, 128, 1, 128, bf16, gen, dstate=True),  # the largest P and N
        ssd_bwd_case(1, 512, 32, 64, 1, 128, f32, gen),
        ssd_bwd_case(1, 1000, 4, 64, 1, 128, f32, gen),            # ragged last chunk
        ssd_bwd_case(2, 300, 4, 64, 1, 128, f32, gen, dstate=True),
        ssd_bwd_case(1, 200, 2, 128, 1, 128, f32, gen, dstate=True),  # the largest P and N
    ]
    for c in cases:  # bf16 takes the tensor cores here, fp32 keeps IEEE products
        want_var = "simt" if " float32" in c["case"] else "tc"
        require(c["variant"] == want_var, f"{c['case']}: routed to {c['variant']}")
    print(f"[18a] the SSD backward against its plain version on the card "
          f"({time.perf_counter() - t0:.1f}s):")
    for c in cases:
        print_case(c)
    for c in cases:
        require(c["ok"], f"{c['case']} disagrees with its plain version ({c['check']})")
    return cases


# The models that phases 18 and 19 train whole: (parameters, what the
# printed line says of the layers).
FULL_TRAIN = {"mamba2-370m": (368_338_432, "48 Mamba-2 layers at full width"),
              "hymba-1.5b": (1_589_773_120, "32 hybrid layers at full width, 29 with a window "
                                            "of 1024"),
              "whisper-large-v3": (1_535_219_200, "32 encoder and 32 decoder layers at full "
                                                  "width, 1500 frames")}


def phase_train_full(B: int, S: int, steps: int, want: dict[str, int], extra=None,
                     phase: str = "18c", what: str = "remat", arch: str = MAMBA):
    """(18c, 19c, 20c) The full ``arch`` (every layer at every published
    width, seed 0) through the training launcher's loop (``train.train``:
    fp32 masters, bf16 compute, per-layer remat, chunked loss, AdamW) at
    B``B`` S``S`` for ``steps`` steps, ``extra`` its keyword arguments:
    finite losses, ms a step, tokens/s (an encoder-decoder's decoder tokens,
    and its frames), the peak beside the state's arithmetic and under the
    card's memory, and exact launch counts by variant.  -> (launch counts,
    the ``TrainRun``, peak bytes, output)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch)
    want_n, layers = FULL_TRAIN[arch]
    n = sum(t.numel() for t in tree_leaves(build_model(cfg, "cpu").init_shapes(torch.float32)))
    require(n == want_n, f"{arch}: {n:,} parameters, want {want_n:,}")
    held = release_memory(phase)
    out = io.StringIO()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        run = train.train(cfg, steps=steps, batch=B, seq=S, seed=0, log_every=1, plan_name=arch,
                          **(extra or {}))
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    card = torch.cuda.get_device_properties(0).total_memory
    text = out.getvalue()
    warm = float(np.median(run.step_ms[1:]))
    frames = f", {B * cfg.enc_seq / warm * 1e3:.0f} frames/s" if cfg.is_encoder_decoder else ""
    print(f"[{phase}] train {arch} ({layers}, {n:,} parameters, fp32 masters, bf16 compute, "
          f"{what}) B{B} S{S}, {steps} steps:")
    for line in text.strip().splitlines():
        print(f"  {line}")
    print(f"  losses {run.losses}; grad norm {[m['grad_norm'] for m in run.metrics]}")
    print(f"  host ms a step (synchronised) {[round(t, 1) for t in run.step_ms]}; warm median "
          f"{warm:.1f} ms, {B * S / warm * 1e3:.0f} tokens/s{frames}; peak memory {peak:,} B "
          f"({peak / 2**30:.2f} GiB) beside {16 * n:,} B of fp32 state (16 B x {n:,}: masters, "
          f"gradients, m, v) and {card / 2**30:.2f} GiB on the card ({held / 2**30:.3f} GiB "
          f"held before the run); launches {counts}; wall {wall:.1f}s (init included)")
    require(len(run.losses) == steps and all(math.isfinite(x) for x in run.losses),
            f"train {arch}: losses {run.losses}")
    require(peak < card, f"train {arch}: peak {peak} B exceeds the card's {card} B")
    require(counts == want, f"train {arch}: launch counts {counts}, want {want}")
    run.params = run.opt = None
    return counts, run, peak, text


def phase_train_full_plan(B: int, S: int, steps: int, want: dict[str, int], plain,
                          phase: str = "18d", arch: str = MAMBA):
    """(18d, 19d, 20d) ``train --arch <arch> --plan`` with the offload plan
    applied: the loss step that ``train.step_planner`` traces, planned under
    H100_SXM (its key the arch's, solved into PLAN_DIR), its w beside the
    card's real peak around one call of that loss at resident masters (w
    above it fails), AutoSwap's plan at half w, rounded down to 0.01 GiB, or
    at a quarter or an eighth where half names no label (one must be
    named); then ``train.train(plan=True, hbm_limit_gb=...)`` with the plan
    restored from its cache for the plain run's steps, seed and batches:
    losses equal to ``plain``'s bit for bit, the same launch counts, and the
    bytes the policy's counters moved each way a step exactly the layers x
    the names x one [B, S, d] bf16 activation.  -> launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import build_model

    cfg = get_config(arch)
    L = cfg.num_layers
    t0 = time.perf_counter()
    planner = train.step_planner(build_model(cfg, "cuda"), arch, B, S, False, str(PLAN_DIR))
    rep = planner.report()
    omega = rep.peak_load
    plan_s = time.perf_counter() - t0
    for frac in (2, 4, 8):
        gb = math.floor(omega / frac / 2**30 * 100) / 100
        limit = int(gb * 2**30)
        t1 = time.perf_counter()
        plan = planner.offload_plan(limit)
        sw = planner.swap_report(limit)
        print(f"[{phase}] AutoSwap at w / {frac}, {gb} GiB ({limit:,} B): offload_names "
              f"{plan.offload_names}, save_names {plan.save_names}, predicted_savings "
              f"{plan.predicted_savings:,} B; swdoa selects {sw.num_selected} variables, "
              f"{sw.selected_bytes:,} B, simulated overhead {sw.overhead * 100:.2f}%, stalls "
              f"{sw.stalls} ({time.perf_counter() - t1:.1f}s)")
        if plan.offload_names:
            break
    print(f"[{phase}] plan: loss step of {arch} B{B} S{S} (fp32 masters, {L} layers) traced and "
          f"planned under H100_SXM in {plan_s:.1f}s: {rep.num_variables} variables, w "
          f"{omega:,} B, SmartPool chi/w {rep.smartpool_ratio:.4f}, CnMem/w "
          f"{rep.cnmem_ratio:.4f}")
    require(plan.offload_names, f"no plan down to w / 8 names a label")
    held = release_memory(phase)
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator("cuda").manual_seed(0), dtype=torch.float32)
    batch = make_batch_fn(cfg, B, S, 0, "cuda")(0)
    gc.collect()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    value = float(model.loss(params, batch)[0])
    real = torch.cuda.max_memory_allocated() - held
    del params, batch
    print(f"[{phase}] the traced loss run for real: loss {value:.4f}, peak {real:,} B on the "
          f"card ({resident - held:,} B of masters and batch resident first) beside w {omega:,} "
          f"B (w / peak {omega / real:.4f})")
    require(math.isfinite(value), f"{phase}: non-finite loss")
    require(omega <= real, f"{phase}: w {omega} B exceeds the real peak {real} B")
    counts, run, peak, text = phase_train_full(
        B, S, steps, want, extra=dict(plan=True, hbm_limit_gb=gb, plan_cache=str(PLAN_DIR)),
        phase=phase, what=f"remat, offloading {plan.offload_names}", arch=arch)
    per_step = L * len(plan.offload_names) * B * S * cfg.d_model * 2
    print(f"[{phase}] the planned run against the plain one: losses "
          f"{'equal bit for bit' if run.losses == plain.losses else 'NOT equal'}; bytes a step "
          f"to host and back {run.moved} (want {per_step:,} each); peak {peak:,} B; host ms a "
          f"step {[round(t, 1) for t in run.step_ms]} against "
          f"{[round(t, 1) for t in plain.step_ms]}")
    require("(restored from cache)" in text, f"{phase}: the plan was not restored from its cache")
    require(run.losses == plain.losses, f"{phase}: losses {run.losses} against {plain.losses}")
    require(run.moved == [(per_step, per_step)] * steps,
            f"{phase}: bytes {run.moved}; want {per_step} each way a step")
    return counts


# Phase 19: hymba-1.5b trained at every published width and full depth on one
# card: 1,589,773,120 parameters, 25,436,369,920 B of fp32 state.  Its 29
# window layers take the flash gradient with a window of 1024.
HYMBA = "hymba-1.5b"


def phase_hymba_bwd_kernels():
    """(19a) The flash backward with a window against its plain version:
    ``wgmma`` (bf16) at hymba's layout (B4 S2048 H25 KV5 hd64, window 1024;
    the ``simt`` kernel timed beside it on the same inputs), a ragged length
    (S 1000, window 300), a window narrower than a tile (16), a window of at
    least S (bit for bit the causal result) and hd 128 with a window, each
    bit for bit across two calls, with the ``mma`` yardstick held to the
    same plain version; ``simt`` (fp32) at the same cases, smaller; and the
    forward with the LSE at hymba's window layout, the instantiation its
    training runs.  Each beside its bound and SDPA's (band mask) backward.
    -> (the backward cases, the LSE case)."""
    gen = torch.Generator("cuda").manual_seed(19)
    bf16, f32 = torch.bfloat16, torch.float32
    t0 = time.perf_counter()
    cases = [
        flash_bwd_case(4, 2048, 25, 5, 64, bf16, gen, "wgmma", window=1024, yardstick="simt"),
        flash_bwd_case(1, 1000, 8, 2, 64, bf16, gen, "wgmma", window=300),    # ragged
        flash_bwd_case(2, 512, 8, 2, 64, bf16, gen, "wgmma", window=16),      # below a tile
        flash_bwd_case(1, 700, 10, 2, 64, bf16, gen, "wgmma", window=700,
                       causal_bits=True),                                    # window >= S
        flash_bwd_case(2, 1100, 16, 4, 128, bf16, gen, "wgmma", window=256),  # hd 128
        flash_bwd_case(1, 512, 25, 5, 64, f32, gen, "simt", window=256),      # hymba's heads
        flash_bwd_case(1, 300, 4, 2, 64, f32, gen, "simt", window=70),        # ragged
        flash_bwd_case(1, 200, 4, 1, 64, f32, gen, "simt", window=16),        # below a tile
        flash_bwd_case(1, 300, 4, 2, 64, f32, gen, "simt", window=300, causal_bits=True),
        flash_bwd_case(1, 300, 8, 2, 128, f32, gen, "simt", window=100),      # hd 128
    ]
    lse = flash_lse_case(4, 2048, 25, 5, 64, bf16, gen, window=1024)
    print(f"[19a] the flash backward with a window against its plain version on the card "
          f"({time.perf_counter() - t0:.1f}s):")
    for c in cases + [lse]:
        print_case(c)
    for c in cases + [lse]:
        require(c["ok"], f"{c['case']} disagrees with its plain version ({c['check']})")
    return cases, lse


# Phase 20: whisper-large-v3 trained at every published width and full depth
# on one card: 1,535,219,200 parameters, 24,563,507,200 B of fp32 state.  Its
# 32 encoder layers and its 32 decoder layers' cross attentions take the
# gradient of unmasked attention.
WHISPER = "whisper-large-v3"


def phase_whisper_bwd_kernels():
    """(20a) The flash backward of unmasked attention against its plain
    version: ``wgmma`` (bf16) at whisper's encoder layout (B4 S1500 H20 KV20
    hd64; 23 key tiles of 64 and one of 28), its cross attention's (448
    queries against 1500 keys), Sq > Sk (B2 Sq700 Sk300) and GQA at hd 128
    (B1 S1100 H16 KV4), each bit for bit across two calls, with ``simt`` and
    the ``mma`` yardstick timed on the same inputs and ``mma`` held to the
    same plain version; the causal backward at whisper's decoder layout (B4
    S448); ``simt`` (fp32) at the same unmasked cases, smaller; and the
    forward with the LSE, unmasked, at the encoder's and the cross
    attention's layouts, the instantiation whisper's training runs.  Each
    beside its bound and SDPA's backward (forward subtracted).  -> (the
    backward cases, the LSE cases)."""
    gen = torch.Generator("cuda").manual_seed(20)
    bf16, f32 = torch.bfloat16, torch.float32
    t0 = time.perf_counter()
    un = dict(causal=False, yardstick="simt", also="mma")
    cases = [
        flash_bwd_case(4, 1500, 20, 20, 64, bf16, gen, "wgmma", **un),            # encoder
        flash_bwd_case(4, 448, 20, 20, 64, bf16, gen, "wgmma", Sk=1500, **un),    # cross
        flash_bwd_case(2, 700, 8, 2, 64, bf16, gen, "wgmma", Sk=300, **un),       # Sq > Sk
        flash_bwd_case(1, 1100, 16, 4, 128, bf16, gen, "wgmma", **un),            # GQA, hd 128
        flash_bwd_case(4, 448, 20, 20, 64, bf16, gen, "wgmma", yardstick="simt"),  # decoder self
        flash_bwd_case(1, 300, 20, 20, 64, f32, gen, "simt", causal=False),
        flash_bwd_case(1, 100, 20, 20, 64, f32, gen, "simt", causal=False, Sk=300),
        flash_bwd_case(1, 300, 8, 2, 64, f32, gen, "simt", causal=False, Sk=100),
        flash_bwd_case(1, 220, 16, 4, 128, f32, gen, "simt", causal=False),
    ]
    lse = [flash_lse_case(4, 1500, 20, 20, 64, bf16, gen, causal=False),
           flash_lse_case(4, 448, 20, 20, 64, bf16, gen, causal=False, Sk=1500)]
    print(f"[20a] the flash backward of unmasked attention against its plain version on the "
          f"card ({time.perf_counter() - t0:.1f}s):")
    for c in cases + lse:
        print_case(c)
    for c in cases + lse:
        require(c["ok"], f"{c['case']} disagrees with its plain version ({c['check']})")
    return cases, lse


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
    args = re.findall(r"(13__nv_bfloat16|(?<=I)f|Li(\d+)E|Lb([01])E)",
                      mangled.split("EEv")[0] + "E")
    names = [{"13__nv_bfloat16": "bf16", "f": "f32"}.get(a, n or ("true" if b == "1" else "false"))
             for a, n, b in args]
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
                     ("ssd_scan_tc", ("HMMA", "HGMMA")),
                     ("ssd_scan_bwd_tc", ("HMMA", "HGMMA"))):
        count = mma_count(_build, lib, ops)
        print(f"  {'/'.join(ops)} instructions in {_build.lib_path(lib).name}: {count}")
        require(count > 0, f"the {lib} library holds no {'/'.join(ops)} instruction")

    cases = phase_kernels()
    phase_parity("qwen3-4b", 256)
    phase_parity("mamba2-370m", 300)  # pads to 512: two chunks of 256, the second ragged
    t4 = time.perf_counter()
    phase_parity("deepseek-v2-lite-16b", 64)
    print(f"[4] deepseek-v2-lite-16b parity took {time.perf_counter() - t4:.1f}s")
    # hymba's five segments, one layer each (global, window, global, window,
    # global): the prompt exceeds the window of 1024, so prefill writes a
    # wrapped ring, and is not a multiple of 64, so the SSD pads; the 4
    # decode steps write ring slots 76 to 79.
    t4 = time.perf_counter()
    phase_parity("hymba-1.5b", 1100)
    print(f"[4] hymba-1.5b parity took {time.perf_counter() - t4:.1f}s")
    # starcoder2's two layers at its served prompt's half; whisper's two
    # encoder layers over the full 1500 frames and two decoder layers at its
    # served prompt, 128.
    for arch, P in (("starcoder2-7b", 256), ("whisper-large-v3", 128)):
        t4 = time.perf_counter()
        phase_parity(arch, P)
        print(f"[4] {arch} parity took {time.perf_counter() - t4:.1f}s")
    # The gemmas at a window layer and a global one: gemma3's prompt of 1100
    # wraps its window's ring of 1024 (and pads the last 64-key tile), and
    # gemma2's window of 4096 masks nothing at 256, so its softcap and scale
    # are what the two layers hold.
    for arch, P in (("gemma3-4b", 1100), ("gemma2-9b", 256)):
        t4 = time.perf_counter()
        phase_parity(arch, P, tail=2)
        print(f"[4] {arch} parity took {time.perf_counter() - t4:.1f}s")
    # qwen2-vl's two layers at half its served prompt, after its 8 patches at
    # M-RoPE positions whose channels differ.
    t4 = time.perf_counter()
    phase_parity("qwen2-vl-7b", 256)
    print(f"[4] qwen2-vl-7b parity took {time.perf_counter() - t4:.1f}s")
    # Launches over 32 forwards (prefill and 31 decode steps): qwen3-4b runs
    # flash once a layer in prefill, RMSNorm 4 times a layer (ln1, ln2,
    # q-norm, k-norm) plus the final norm in every forward; mamba2-370m runs
    # the SSD once a layer in prefill, RMSNorm twice a layer (ln1, the gated
    # norm) plus the final norm in every forward; deepseek-v2-lite-16b runs
    # RMSNorm 3 times a layer (ln1, MLA's kv_norm, ln2) plus the final norm
    # in every forward, and no flash or SSD kernel (MLA's attention is the
    # reference's dense softmax); hymba-1.5b runs flash (with the window in
    # 29 of its layers) and the SSD once a layer in prefill, and RMSNorm 5
    # times a layer (ln1, the gated norm, the two branch norms, ln2) plus
    # the final norm in every forward; starcoder2-7b runs flash once a layer
    # in prefill and no RMSNorm (LayerNorm, no qk-norm); whisper-large-v3
    # runs flash once in each of its 32 encoder layers (unmasked) and twice
    # in each of its 32 decoder layers in prefill (causal self attention,
    # unmasked cross attention), and no RMSNorm; gemma3-4b runs flash once a
    # layer in prefill (29 with the window) and RMSNorm 6 times a layer (ln1,
    # q-norm, k-norm, ln1_post, ln2, ln2_post) plus the final norm in every
    # forward, gemma2-9b flash once a layer (softcap 50) and RMSNorm 4 times
    # a layer (no qk-norm) plus the final norm; qwen2-vl-7b flash once a
    # layer in prefill (over its 8 patches and the prompt) and RMSNorm twice
    # a layer (ln1, ln2) plus the final norm.  Everything is bf16 with
    # widths that take 16-byte vectors: flash at head dim 64, 128 or 256 is
    # the wgmma variant, the SSD the tc variant, RMSNorm the vector variant.
    def want(rms, flash, ssd, rms_bwd=0, flash_bwd=0, ssd_bwd=0):
        return {"rmsnorm": rms, "rmsnorm/vector": rms, "rmsnorm/scalar": 0,
                "rmsnorm_bwd": rms_bwd, "rmsnorm_bwd/vector": rms_bwd, "rmsnorm_bwd/scalar": 0,
                "flash_attention": flash, "flash_attention/wgmma": flash,
                "flash_attention/simt": 0, "flash_attention_bwd": flash_bwd,
                "flash_attention_bwd/wgmma": flash_bwd, "flash_attention_bwd/mma": 0,
                "flash_attention_bwd/simt": 0,
                "ssd_scan": ssd, "ssd_scan/tc": ssd, "ssd_scan/simt": 0,
                "ssd_scan_bwd": ssd_bwd, "ssd_scan_bwd/tc": ssd_bwd, "ssd_scan_bwd/simt": 0}

    serve_want = {"qwen3-4b": (512, want((4 * 36 + 1) * 32, 36, 0)),
                  "mamba2-370m": (2048, want((2 * 48 + 1) * 32, 0, 48)),
                  "deepseek-v2-lite-16b": (512, want((3 * 27 + 1) * 32, 0, 0)),
                  "hymba-1.5b": (2048, want((5 * 32 + 1) * 32, 32, 32)),
                  "starcoder2-7b": (512, want(0, 32, 0)),
                  "whisper-large-v3": (128, want(0, 32 + 2 * 32, 0)),
                  "gemma3-4b": (2048, want((6 * 34 + 1) * 32, 34, 0)),
                  "gemma2-9b": (512, want((4 * 42 + 1) * 32, 42, 0)),
                  "qwen2-vl-7b": (512, want((2 * 28 + 1) * 32, 28, 0))}
    paths, served = {}, {}
    for arch, (P, counts) in serve_want.items():
        t5 = time.perf_counter()
        paths[f"serve {arch}"], *served[arch] = phase_serve(arch, 4, P, 32, counts)
        print(f"[5] serve {arch} took {time.perf_counter() - t5:.1f}s")
    for arch, (P, _) in serve_want.items():
        t6 = time.perf_counter()
        phase_profile(arch, 4, P, 32)
        print(f"[6] {arch} profile took {time.perf_counter() - t6:.1f}s")
    t7 = time.perf_counter()
    phase_link_and_compute()
    phase_planner()
    # (b), the loss with its gradient, on a 12-layer cut: at 36 layers its
    # 6,593 variables took 80.55 s of AutoSwap's selections, the largest
    # host cost of the script.
    phase_captured_plans(4, 512, grad_cfg=qwen3_cut(12))
    print(f"[7] planner phase took {time.perf_counter() - t7:.1f}s")

    phase_train_parity("qwen3-4b", 128)
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
        t = time.perf_counter()
        paths[f"serve {arch} (planned)"] = phase_serve_plans(arch, 4, P, 32, counts,
                                                             *served[arch])
        print(f"[12] serve plans of {arch} took {time.perf_counter() - t:.1f}s")
    phase_colocate(4, 512, 32, 512)
    print(f"[12] serve plans phase took {time.perf_counter() - t12:.1f}s")

    # Phase 13: the paper's CNN training step, traced, planned and run; it
    # runs no kernel of the port (cuDNN convolutions, cuBLAS head).
    from repro_torch.kernels import ops

    t13 = time.perf_counter()
    held = release_memory("13")
    held_reserved = torch.cuda.memory_reserved()
    ops.reset_launch_counts()
    phase_cnn_parity()
    phase_cnn_run(phase_cnn_plans(), held, held_reserved)
    paths["cnn"] = ops.launch_counts()
    require(not any(paths["cnn"].values()), f"cnn: the port's kernels ran {paths['cnn']}")
    print(f"[13] cnn phase took {time.perf_counter() - t13:.1f}s; launches of the port's "
          f"kernels: 0")

    # Phase 14: hymba's long_500k decode cell, RMSNorm 5 times a layer and
    # the final norm a step, no flash or SSD (decode attention is the dense
    # step, the SSM the recurrence).
    t14 = time.perf_counter()
    long_steps = 4
    paths["decode hymba-1.5b long_500k"] = phase_long_decode(
        "hymba-1.5b", 524_288, long_steps, want((5 * 32 + 1) * long_steps, 0, 0))
    print(f"[14] long decode phase took {time.perf_counter() - t14:.1f}s")

    t15 = time.perf_counter()
    paths["example serve_batched"] = phase_example()
    print(f"[15] example phase took {time.perf_counter() - t15:.1f}s")

    # Phase 16: deepseek-v2-lite-16b trained at full width.  (a) and (e)
    # at depth 2 in fp32 against the CPU; (b)-(d) the dense layer and
    # MOE_LAYERS MoE layers, B4 S512.  A step under per-layer remat runs
    # each layer's forward twice and the final norm once: RMSNorm forward
    # 2 * 3 * 6 + 1 = 37 (ln1, MLA's kv_norm, ln2), backward 3 * 6 + 1 =
    # 19, all `vector` (bf16, d 2048 and 512); no flash (MLA's attention is
    # the reference's dense softmax) and no SSD.
    t16 = time.perf_counter()
    phase_train_parity(DEEPSEEK, 128)
    print(f"[16a] train parity and determinism took {time.perf_counter() - t16:.1f}s")
    layers = 1 + MOE_LAYERS
    cut_want = want((2 * 3 * layers + 1) * steps, 0, 0, (3 * layers + 1) * steps, 0)
    t = time.perf_counter()
    cut = deepseek_cut(MOE_LAYERS)
    paths[f"train {cut.name}"], cut_run, _, _ = phase_train_cut(4, 512, steps, cut_want)
    print(f"[16b] train took {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    phase_train_profile(4, 512, phase="16c", cfg=cut)
    print(f"[16c] profile took {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    captured = phase_captured_plans(4, 512, cfg=cut, phase="16d", swaps=False)
    print(f"[16d] w / real peak: loss {captured['a'][0] / captured['a'][1]:.4f}, loss + grad "
          f"{captured['b'][0] / captured['b'][1]:.4f}")
    paths[f"train {cut.name} (offload)"] = phase_train_cut_offload(4, 512, steps, cut_want,
                                                                   cut_run)
    print(f"[16d] plans and the offload run took {time.perf_counter() - t:.1f}s")
    print(f"[16] deepseek training phase took {time.perf_counter() - t16:.1f}s")

    # Phase 17: fault-tolerant training.  (a) The qwen3-4b cut's step under
    # per-layer remat runs each layer's forward twice and the final norm
    # once: RMSNorm forward 2 * 4 * 2 + 1 = 17 (ln1, ln2, q-norm, k-norm),
    # backward 4 * 2 + 1 = 9, all `vector` (bf16, d 2560 and hd 128); flash
    # 2 * 2 = 4 forward (with the LSE) and 2 backward, `wgmma` (bf16 at hd
    # 128); no SSD.  (b) The 100M example is fp32 at d 640 and hd 64 with 10
    # layers: RMSNorm forward 2 * 4 * 10 + 1 = 81 and backward 4 * 10 + 1 =
    # 41, `vector` (fp32 rows of 640 and 64 take 16-byte vectors); flash
    # 2 * 10 = 20 forward and 10 backward, `simt` (the wgmma kernels take
    # bf16 only); no SSD.
    t17 = time.perf_counter()
    L = CKPT_LAYERS
    paths.update(phase_checkpoint(4, 512, 8, want(2 * 4 * L + 1, 2 * L, 0, 4 * L + 1, L)))
    print(f"[17a] took {time.perf_counter() - t17:.1f}s")
    fp32 = want(2 * 4 * 10 + 1, 0, 0, 4 * 10 + 1, 0)
    fp32.update({"flash_attention": 20, "flash_attention/simt": 20, "flash_attention_bwd": 10,
                 "flash_attention_bwd/simt": 10})
    t = time.perf_counter()
    paths.update(phase_example_100m(fp32))
    print(f"[17b] took {time.perf_counter() - t:.1f}s")
    print(f"[17] checkpoint phase took {time.perf_counter() - t17:.1f}s")

    # Phase 18: mamba2-370m trained at full width.  A step under per-layer
    # remat runs each layer's forward twice and the final norm once: the SSD
    # forward 2 * 48 = 96 (`tc`: bf16, P 64 and N 128 in 16-byte rows of the
    # conv output), RMSNorm forward 2 * 2 * 48 + 1 = 193 (ln1 at d 1024, the
    # gated norm at d_inner 2048), and each backward once: the SSD 48 (`tc`,
    # as the forward), RMSNorm 2 * 48 + 1 = 97, all `vector`; no flash.
    from repro_torch.configs import get_config

    t18 = time.perf_counter()
    cases["ssd_scan_bwd"] = phase_mamba_bwd_kernels()
    t = time.perf_counter()
    # pads to 512: two of the config's chunks of 256, the second ragged
    phase_train_parity(MAMBA, 300, phase="18b")
    print(f"[18b] took {time.perf_counter() - t:.1f}s")
    L = 48
    mamba_want = want((2 * 2 * L + 1) * steps, 0, 2 * L * steps, (2 * L + 1) * steps, 0,
                      L * steps)
    t = time.perf_counter()
    paths[f"train {MAMBA}"], mamba_run, _, _ = phase_train_full(4, 2048, steps, mamba_want)
    phase_train_profile(4, 2048, phase="18c", cfg=get_config(MAMBA))
    print(f"[18c] took {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    paths[f"train {MAMBA} (offload)"] = phase_train_full_plan(4, 2048, steps, mamba_want,
                                                              mamba_run)
    print(f"[18d] took {time.perf_counter() - t:.1f}s")
    print(f"[18] mamba2 training phase took {time.perf_counter() - t18:.1f}s")

    # Phase 19: hymba-1.5b trained at full width and depth.  A step under
    # per-layer remat runs each layer's forward twice and the final norm
    # once: RMSNorm forward 2 * 5 * 32 + 1 = 321 (ln1, the gated norm, the
    # two branch norms, ln2, at d 1600 and d_inner 3200), flash with the LSE
    # 2 * 32 = 64 (`wgmma`: bf16 at hd 64; 29 of the 32 with the window of
    # 1024), the SSD 2 * 32 = 64 (`tc`: bf16, P 64 and N 16 in 16-byte rows),
    # and each backward once: RMSNorm 5 * 32 + 1 = 161 `vector`, flash 32
    # `wgmma`, the SSD 32 `tc`.
    t19 = time.perf_counter()
    cases["flash_window_bwd"], cases["flash_window_lse"] = phase_hymba_bwd_kernels()
    t = time.perf_counter()
    # one layer of each of its five segments (global, window, global, window,
    # global) at S 1100, past the window of 1024, which pads the SSD
    phase_train_parity(HYMBA, 1100, phase="19b")
    print(f"[19b] took {time.perf_counter() - t:.1f}s")
    L = 32
    hymba_want = want((2 * 5 * L + 1) * steps, 2 * L * steps, 2 * L * steps,
                      (5 * L + 1) * steps, L * steps, L * steps)
    t = time.perf_counter()
    paths[f"train {HYMBA}"], hymba_run, _, _ = phase_train_full(4, 2048, steps, hymba_want,
                                                                phase="19c", arch=HYMBA)
    phase_train_profile(4, 2048, phase="19c", cfg=get_config(HYMBA))
    print(f"[19c] took {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    paths[f"train {HYMBA} (offload)"] = phase_train_full_plan(4, 2048, steps, hymba_want,
                                                              hymba_run, phase="19d", arch=HYMBA)
    print(f"[19d] took {time.perf_counter() - t:.1f}s")
    print(f"[19] hymba training phase took {time.perf_counter() - t19:.1f}s")

    # Phase 20: whisper-large-v3 trained at full width and depth, B4 with the
    # decoder's text context of 448 tokens over 1500 frames.  A step runs each
    # of the 32 encoder layers once (no remat: flash with the LSE unmasked at
    # S 1500) and each of the 32 decoder layers twice (its forward and its
    # recompute: causal self attention and unmasked cross attention of 448
    # queries against 1500 keys), so flash with the LSE 32 + 2 * 2 * 32 = 160
    # `wgmma` (bf16 at hd 64), and each backward once: 32 unmasked, 32
    # causal, 32 cross, 96 `wgmma`; no RMSNorm (every norm a LayerNorm) and
    # no SSD.
    t20 = time.perf_counter()
    cases["flash_unmasked_bwd"], cases["flash_unmasked_lse"] = phase_whisper_bwd_kernels()
    print(f"[20a] took {time.perf_counter() - t20:.1f}s")
    t = time.perf_counter()
    phase_train_parity(WHISPER, 300, phase="20b")
    print(f"[20b] took {time.perf_counter() - t:.1f}s")
    L = 32
    whisper_want = want(0, 5 * L * steps, 0, 0, 3 * L * steps, 0)
    t = time.perf_counter()
    paths[f"train {WHISPER}"], whisper_run, _, _ = phase_train_full(
        4, 448, steps, whisper_want, phase="20c", arch=WHISPER)
    phase_train_profile(4, 448, phase="20c", cfg=get_config(WHISPER))
    print(f"[20c] took {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    paths[f"train {WHISPER} (offload)"] = phase_train_full_plan(4, 448, steps, whisper_want,
                                                                whisper_run, phase="20d",
                                                                arch=WHISPER)
    print(f"[20d] took {time.perf_counter() - t:.1f}s")
    print(f"[20] whisper training phase took {time.perf_counter() - t20:.1f}s")

    # The backward kernels replace no Pallas kernel of their own: each is the
    # gradient of the TPU kernel named, which the reference takes by XLA
    # autodiff of its jnp paths.
    srcs = {"rmsnorm": "src/repro/kernels/rmsnorm.py:25",
            "flash_attention": "src/repro/kernels/flash_attention.py:99",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:65",
            "rmsnorm_bwd": "src/repro/kernels/rmsnorm.py:25",
            "flash_attention_bwd": "src/repro/kernels/flash_attention.py:99",
            "ssd_scan_bwd": "src/repro/kernels/ssd_scan.py:65"}
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
    flash = next(k for k in kernels if k["name"] == "flash_attention")
    flash.update(lse_ms=lse["ms"], lse_plain_ms=lse["plain_ms"], lse_bound_ms=lse["bound_ms"],
                 lse_library_ms=lse["library_ms"], lse_max_abs_err=lse["max_abs_err"],
                 lse_check=lse["check"])
    # The gemmas' prefill runs the head-dim-256 instantiation: gemma3-4b's
    # global call stands beside the qwen3-4b one, with the simt kernel's ms.
    hd256 = next(c for c in cases["flash_attention"]
                 if c["variant"] == "wgmma" and "hd256" in c["case"])
    flash.update(hd256_case=hd256["case"], hd256_ms=hd256["ms"],
                 hd256_plain_ms=hd256["plain_ms"], hd256_bound_ms=hd256["bound_ms"],
                 hd256_bound_by=hd256["bound_by"], hd256_library_ms=hd256["library_ms"],
                 hd256_simt_ms=hd256["other"][1], hd256_max_abs_err=hd256["max_abs_err"])
    # hymba's training runs the backward with a window in 29 of its 32 layers
    # a step, and the forward with the LSE and the window: both at its layout.
    bwd = next(k for k in kernels if k["name"] == "flash_attention_bwd")
    win = cases["flash_window_bwd"][0]
    bwd.update(window_case=win["case"], window_ms=win["ms"], window_plain_ms=win["plain_ms"],
               window_bound_ms=win["bound_ms"], window_bound_by=win["bound_by"],
               window_library_ms=win["library_ms"], window_simt_ms=win["other"][1],
               window_max_abs_err=win["max_abs_err"])
    wl = cases["flash_window_lse"]
    flash.update(window_lse_case=wl["case"], window_lse_ms=wl["ms"],
                 window_lse_plain_ms=wl["plain_ms"], window_lse_bound_ms=wl["bound_ms"],
                 window_lse_library_ms=wl["library_ms"], window_lse_max_abs_err=wl["max_abs_err"])
    # whisper's training runs the unmasked backward in its 32 encoder layers
    # (S 1500) and its 32 cross attentions (448 against 1500 keys) a step, and
    # the unmasked forward with the LSE at both layouts.
    for key, c in zip(("unmasked", "cross"), cases["flash_unmasked_bwd"]):
        bwd.update({f"{key}_case": c["case"], f"{key}_ms": c["ms"],
                    f"{key}_plain_ms": c["plain_ms"], f"{key}_bound_ms": c["bound_ms"],
                    f"{key}_bound_by": c["bound_by"], f"{key}_library_ms": c["library_ms"],
                    f"{key}_simt_ms": c["other"][1], f"{key}_mma_ms": c["also"][1],
                    f"{key}_max_abs_err": c["max_abs_err"]})
    for key, c in zip(("unmasked_lse", "cross_lse"), cases["flash_unmasked_lse"]):
        flash.update({f"{key}_case": c["case"], f"{key}_ms": c["ms"],
                      f"{key}_plain_ms": c["plain_ms"], f"{key}_bound_ms": c["bound_ms"],
                      f"{key}_library_ms": c["library_ms"], f"{key}_max_abs_err": c["max_abs_err"]})
    extra_cases = {"flash_attention_bwd": cases["flash_window_bwd"] + cases["flash_unmasked_bwd"]}
    summary = [f"{k['name']} launches={k['launches']} "
               f"({', '.join(f'{p} {n}' for p, n in k['launches_by_path'].items())}) "
               f"parity=ok ({len(cases[k['name']]) + len(extra_cases.get(k['name'], []))} cases)"
               for k in kernels]
    print("kernels: " + "; ".join(summary))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
