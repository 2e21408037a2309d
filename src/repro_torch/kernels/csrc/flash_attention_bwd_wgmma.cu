// Flash attention backward for Hopper (sm_90a) on wgmma: bf16, head dim 64,
// 128 or 256.  The `wgmma` variant of flash_attention_bwd; the wrapper
// (kernels/flash_attention.py, `bwd_variant`) routes bf16 at those head dims
// with 16-byte aligned tensors here, and fp32 and the rest to the `simt`
// variant of flash_attention_bwd.cu.  That file's `mma` variant (mma.sync)
// computes the same function and is kept, unrouted, as a yardstick.
//
// The gradient of the TPU kernel repro/kernels/flash_attention.py:99
// `flash_attention` (causal, with or without a sliding window, or unmasked;
// GQA; with or without a tanh softcap), which the reference takes by XLA
// autodiff of `mha_dense` and `_sdpa` (repro/models/attention.py:157-182).
// Given q [B,Sq,H,hd], k, v [B,Sk,KV,hd], the forward's output o and its
// log-sum-exp lse [B,H,Sq], and dO, with P = exp(q k^T * scale - lse) (0 where masked; causal, row i sees
// keys k <= i, top-left aligned, and with a window W > 0 only those with
// i - k < W, the reference's `_causal_window_mask`; unmasked, every key, at
// any Sq and Sk: whisper's encoder and its cross attention):
//
//   D_i = sum_d dO_i,d o_i,d                       (the prepass)
//   dV  = P^T dO,   dP = dO V^T,   dS = P (dP - D)
//   dQ  = dS K * scale,   dK = dS^T Q * scale
//
// with every sum in fp32 and dq, dk, dv in bf16.  P and dS are rounded to
// bf16 where they enter a product (P for dV, dS for dK and dQ), as the `mma`
// variant and the wgmma forward round P; P is recomputed in fp32 from the
// LSE and dS is formed from the unrounded P.  dK and dV of a kv head sum
// over the G = H / KV query heads of its group.
//
// With a softcap c (gemma2: 50) the forward caps the scaled scores as c t,
// t = tanh(scale q.k / c) (the reference's `_softcap`), so P = exp(c t -
// lse) and dS = P (dP - D) (1 - t^2).  t comes from the same tanhf of the
// same argument as in the forward kernel, so the recomputed P agrees with
// the forward's LSE.  The softcap is a template flag (SOFTCAP) beside its
// runtime value, as the window is, so that the kernels without it carry
// none of its arithmetic.
//
// Bound on the H100: at qwen3-4b's training shape, B4 S512 H32 KV8 hd128
// causal, 5 products of 2 hd flops for each live (q, k) pair, 21.5 GFLOP
// (21.8 us at 989 TFLOP/s), and 84 MB moved (25.1 us at 3.35 TB/s): bytes,
// by a little.  At hymba-1.5b's, B4 S2048 H25 KV5 hd64 with a window of
// 1024, 1,573,376 live pairs a head, 100.7 GFLOP (101.8 us), and about 128
// MB (38 us): operations.  At whisper-large-v3's encoder, B4 S1500 H20 hd64
// unmasked, 115.2 GFLOP (116.5 us); its cross attention, 448 queries against
// 1500 keys, 34.4 GFLOP (34.8 us): operations.  At hd 256 a pair costs
// twice as much: gemma3-4b's B4 S2048 H8 KV4 causal, 171.9 GFLOP (173.8 us),
// 128.9 (130.3 us) with its window of 1024; gemma2-9b's B1 S8192 H16 KV8
// (softcap 50), 1,374.6 GFLOP (1.390 ms), 1,030.9 (1.042 ms) with its window
// of 4096: operations.
//
// The window only narrows the tile ranges: a key tile [k0, k0 + 64) is seen
// by q rows up to k0 + 63 + W - 1, so the dK/dV block stops its q tiles
// there; a q tile [q0, q0 + 64) sees keys from q0 - W + 1, so the dQ block
// starts at that key's tile.  A step whose tile pair crosses the window's
// lower edge (q0 + 63 - k0 >= W) masks its pairs, as a step on the diagonal
// does.  W >= Sq visits the causal tiles and masks the causal pairs, so it
// gives the causal result bit for bit.  The window is a template flag (WIN)
// beside its runtime width, so that the causal instantiation carries none of
// this arithmetic: with it in every step the causal kernels ran 8% (qwen3-4b's
// layout) and 16% (hymba's global layers) slower (PERF.md).
//
// Unmasked attention is the template flag CAUSAL = false (never with WIN):
// a dK/dV block visits every q tile from row 0, a dQ block every key tile up
// to Sk, and only a step on a ragged edge (rows past Sq, keys past Sk) turns
// the element masks on.  A row past Sq loads zeros and an LSE of 0, so its P
// would be exp(0) = 1: the mask sets it to 0 before it enters dV or dS (it
// is assigned, never multiplied, so an overflowed exponential of a padded
// pair cannot make a NaN), and a key past Sk adds nothing to dQ and is not
// written to dK or dV.  The causal instantiations compile to the PTX they had
// before the flag, instruction for instruction: the element masks are
// written out under `if constexpr`, since folding `(!CAUSAL || qp >= kp)`
// into the window's mask changed the window kernels' PTX and cost them 12%
// (PERF.md).
//
// Design.  Three launches and no atomics, as `mma`, so two runs give equal
// bits: a prepass writes D (fp32 [B,H,Sq]), a block for each position of
// [B, Sq] reading its H contiguous rows of o and dO in 16-byte chunks; a
// dK/dV kernel; a dQ kernel.  Every product is a wgmma on an operand layout
// that flash_attention_wgmma.cu runs:
//   dK/dV, a block of two warpgroups per 64 keys of one kv head: it holds
//     its K and V tiles, and its steps (a 64-row q tile of a query head of
//     the group) are dealt to the two warpgroups in turn, so the key tile
//     that every q tile sees (tile 0: 8 q tiles x G heads at S512) takes
//     half as long.  S^T = K Q^T and dP^T = V dO^T are SS m64n64k16, both
//     operands K-major over hd (the forward's S = Q K^T).  P^T and dS^T go
//     to bf16 in the accumulators' registers, whose layout is the A
//     operand's (the forward's P), and dV += P^T dO, dK += dS^T Q are RS
//     wgmma with dO and Q as the N-major B operand, stored [q][hd] (the
//     forward's P V).  At the end warpgroup 1 hands its dK and dV to
//     warpgroup 0 through shared memory, which adds them in that order.
//   dQ, a block of one warpgroup per 64 q rows of one head: it holds its Q
//     and dO tiles and steps over 64-key tiles.  S = Q K^T and dP = dO V^T
//     are SS; dS goes to bf16 in registers; dQ += dS K is RS with K stored
//     [key][hd] as the N-major B operand.
// Each product pair is issued as one wgmma group and waited for once: two
// waits a step.  The streamed tiles (Q, dO, and the LSE and D rows of a
// step in dK/dV, a ring for each warpgroup; K and V in dQ) go through a
// 2-stage cp.async ring into the 128-byte swizzle (16-byte chunk c of row r
// at chunk c ^ (r % 8) of 64-column panels), the next step's copies issued
// before this step's math, with one barrier of the ring's warpgroup a step.
// The LSE and D rows are copied 4 bytes at a time, since a row of [B,H,Sq]
// need not start 16-byte aligned.  Causal masks are applied only on a step
// that touches the diagonal or a ragged edge (rows past Sq or keys past Sk
// are zero-filled and masked).
//
// Heaviest first: the dK/dV grid's slowest axis is the key tile, from key
// tile 0 (seen by every q tile) up; the dQ grid's is the q tile, from the
// last (which sees every key tile) down, as the forward orders its grid.
//
// Small grids: the dK/dV kernel runs a block for each (64-key tile, kv
// head, batch), however few (at B2 S512 H8 KV2 hd64: 8 x 2 x 2 = 32 blocks
// on 132 SMs), and each block loops over its group's G query heads.  At the
// training shape there are 8 x 8 x 4 = 256.  Splitting a group's heads
// across blocks, with fp32 partial sums added by a fourth launch in a fixed
// order, was 1.14-1.47x faster on the small grids of chip_smoke.py's phase
// 3 and is not done: the training path does not take it (PERF.md).
//
// Shared memory at hd 128: dK/dV K 16 KB + V 16 KB + 2 warpgroups x 2
// stages x (Q 16 KB + dO 16 KB + LSE and D 1 KB) = 164 KB, one block an
// SM; dQ Q 16 KB + dO 16 KB + 2 x (K 16 KB + V 16 KB) = 96 KB, two blocks
// an SM.
//
// Head dim 256.  The dK/dV design above does not carry over: its rings
// would need K 32 + V 32 + 2 x 2 x (Q 32 + dO 32 + 1) KB = 324 KB of the
// 227 KB a block can have, and a warpgroup summing all 256 columns of dK
// and dV would hold 128 + 128 fp32 registers a thread before S^T and dP^T.
// So at hd 256 (SPLIT) both warpgroups take every step, the same 64-row q
// tile, from one ring under the block's barrier: K 32 + V 32 + 2 x (Q 32 +
// dO 32 + 1) KB = 195 KB.  Each sums one 128-column half of dK and dV (its
// B operands start at panel 2 wg of dO and Q), 64 + 64 registers a thread
// beside S^T and dP^T at 32 each, the hd-128 kernel's budget, and writes it
// itself, so no reduction through shared memory is left.  Each forms S^T
// and dP^T over all 256 columns for itself, so those two products are done
// twice (7 of the kernel's 9 products a pair, against 5 for the function):
// forming them once and handing P^T and dS^T to the other warpgroup through
// shared memory would need 32 KB more than the ring leaves and a block
// barrier between the two products of every step.  The dQ kernel keeps its
// shape: Q 32 + dO 32 + 2 x (K 32 + V 32) KB = 192 KB, one block an SM,
// dQ 128 fp32 registers a thread beside S and dP, and dQ += dS K as two
// m64n128k16 products a 16-key step, one on each half of K's columns.  Registers a thread at hd 128 (dK/dV): dK and dV 64 fp32 each, S^T
// and dP^T 32 each; the bf16 P^T and dS^T fragments (16 each) replace S^T
// and dP^T as they are formed.  ptxas for sm_90a at -O3 (chip_smoke.py's
// phase 2 prints it): dK/dV 254 registers at hd 128 and 194 at hd 64, dQ
// 183 and 138 (with the window: 255, 191, 184, 133; unmasked: 253, 192, 186,
// 128; with the softcap 251-254, 189-194, 188-190, 140-142), the prepass
// 32, none spilling.  At hd 256 dK/dV takes 248-254 registers and spills
// nothing; dQ takes 255 and spills 56-80 bytes (the most with the softcap).
//
// What bounds it (a probe timing copies of this file without the streamed
// loads and/or the exponentials; PERF.md): at the training shape the
// kernels run at about a third of the tensor cores' peak, and copies with
// neither the streamed loads nor the exponentials are only 9-20% faster,
// so the wgmma issue pattern is the limit: 64-wide products, each group
// waited for before the math that follows it.  Wider products and a
// producer warp with mbarriers in place of the barriers are the next step.
//
// The launcher allocates nothing and does not synchronise; no descriptor is
// built on the host, so the launch is legal inside a CUDA graph capture.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int WG = 128;          // threads a warpgroup: a dQ block
constexpr int NT2 = 256;         // threads a dK/dV block: two warpgroups
constexpr int TR = 64;           // rows of a tile: keys or q rows, a block's and a step's
constexpr int PANEL = TR * 128;  // bytes of a 64-column panel of a 64-row tile
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

// 4 bytes global -> shared, asynchronously; `bytes` 0 fills zeros.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
// Two fp32 values to a bf16 pair, round to nearest even; `lo` in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The descriptor of k-step kk (16 columns of hd) of a K-major 64-row tile.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk / 4) * PANEL + (kk % 4) * 32, 0, 1024);
}
// The descriptor of rows 16 t .. 16 t + 15 of a 64-row tile read as the
// N-major B operand (k = its rows, n = hd).
__device__ __forceinline__ uint64_t nmajor(uint32_t tile, int t) {
  return sw128_desc(tile + t * 16 * 128, PANEL, 1024);
}

// acc[64 x HD] += A[64 x 16] B[16 x HD], B the N-major rows 16 t.. of `tile`
// (at hd 256 two m64n128k16 products, on its panels 0-1 and 2-3).
template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&acc)[HD / 2], const uint32_t (&frag)[16], int t,
                                         uint32_t tile) {
  const uint32_t a[4] = {frag[4 * t], frag[4 * t + 1], frag[4 * t + 2], frag[4 * t + 3]};
  if constexpr (HD == 64) {
    wgmma_rs_n64(acc, a, nmajor(tile, t));
  } else if constexpr (HD == 128) {
    wgmma_rs_n128(acc, a, nmajor(tile, t));
  } else {
    wgmma_rs_n128<0>(acc, a, nmajor(tile, t));
    wgmma_rs_n128<64>(acc, a, nmajor(tile + 2 * PANEL, t));
  }
}

// S (+)= A B^T over hd for 64-row tiles A and B, both K-major.
template <int HD>
__device__ __forceinline__ void wgmma_abt(float (&s)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) wgmma_ss_n64(s, kmajor(a, kk), kmajor(b, kk), kk > 0);
}

// Byte offset of 16-byte chunk c (8 columns) of row r in a 64-row tile.
__device__ __forceinline__ uint32_t chunk_offset(int r, int c) {
  return (c >> 3) * PANEL + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Copy rows [0, 64) of a tile, HD columns, from `g` (row stride `stride`
// elements) into shared memory at `dst` by THREADS threads (this one
// `tid`); rows from `valid` on are zeros.
template <int HD, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* g, long long stride,
                                          int valid, int tid) {
  constexpr int CPR = HD / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < TR * CPR / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e / CPR, c = e % CPR;
    const bool in = r < valid;
    cp_async16(dst + chunk_offset(r, c), in ? g + r * stride + c * 8 : g, in ? 16 : 0);
  }
}

// D = rowsum(dO * o) in fp32, [B, H, Sq].  Block bi = b Sq + i reads the
// contiguous H rows of position i of o and dO [B, Sq, H, HD]: HD / 8 lanes
// a row, one 16-byte chunk each.
template <int HD>
__global__ void __launch_bounds__(WG) flash_bwd_delta_kernel(const bf16* __restrict__ o,
                                                             const bf16* __restrict__ dout,
                                                             float* __restrict__ delta, int Sq,
                                                             int H) {
  constexpr int LPR = HD / 8;
  const int bi = blockIdx.x, b = bi / Sq, i = bi - b * Sq;
  const bf16* ob = o + (long long)bi * H * HD;
  const bf16* gb = dout + (long long)bi * H * HD;
  for (int c0 = 0; c0 < H * LPR; c0 += WG) {  // every lane takes part in the shuffles
    const int c = c0 + threadIdx.x;
    float s = 0.f;
    if (c < H * LPR) {
      const uint4 a = *reinterpret_cast<const uint4*>(ob + c * 8);
      const uint4 g = *reinterpret_cast<const uint4*>(gb + c * 8);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float2 x = __bfloat1622float2(a2[t]), y = __bfloat1622float2(g2[t]);
        s = fmaf(y.x, x.x, s);
        s = fmaf(y.y, x.y, s);
      }
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (c < H * LPR && c % LPR == 0) delta[((long long)b * H + c / LPR) * Sq + i] = s;
  }
}

template <int HD>
__host__ __device__ constexpr uint32_t tile_bytes() {
  return TR * HD * 2;
}
// A dK/dV ring stage: the Q and dO tiles of a step, then its LSE and D rows
// (64 floats each), padded so that the next stage's tiles stay 1024-byte
// aligned, as the swizzle needs.
template <int HD>
__host__ __device__ constexpr uint32_t dkdv_stage_bytes() {
  return 2 * tile_bytes<HD>() + 1024;
}
// K, V, the rings (one a warpgroup up to hd 128, one shared above), alignment.
template <int HD>
constexpr size_t dkdv_smem() {
  return 2 * tile_bytes<HD>() + (HD > 128 ? 1 : 2) * 2 * dkdv_stage_bytes<HD>() + 1024;
}
template <int HD>
constexpr size_t dq_smem() {
  return 2 * tile_bytes<HD>() + 2 * 2 * tile_bytes<HD>() + 1024;  // Q, dO, the K/V ring, alignment
}
static_assert(dkdv_smem<256>() <= 232448 && dq_smem<256>() <= 232448,
              "the hd-256 tiles exceed a block's shared memory");

// dK and dV of 64 keys (tile blockIdx.z) of kv head blockIdx.x, batch
// blockIdx.y, summed over its group's query heads.  Up to hd 128 the steps
// (query head, q tile) are dealt to the two warpgroups in turn; each runs
// its own ring and barrier over all HD columns, and at the end warpgroup 1
// hands its sums to warpgroup 0 through shared memory.  Above (SPLIT, hd
// 256) both warpgroups take every step from one ring under the block's
// barrier, each forming S^T and dP^T itself and summing its own CW = 128
// columns of dK and dV, which it writes.
template <int HD, bool CAUSAL, bool WIN, bool SOFTCAP>
__global__ void __launch_bounds__(NT2, 1) flash_bwd_dkdv_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,
    int Sk, int H, int KV, int window, float scale, float softcap) {
  constexpr bool SPLIT = HD > 128;
  constexpr int CW = SPLIT ? HD / 2 : HD;  // columns of dK and dV a warpgroup sums
  constexpr uint32_t TILE = tile_bytes<HD>(), STAGE = dkdv_stage_bytes<HD>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023) & ~1023u;
  const uint32_t sV = sK + TILE;
  const int tid = threadIdx.x, wg = tid / WG, wtid = tid % WG, warp = wtid / 32, lane = tid % 32;
  // This warpgroup's ring (SPLIT: the block's): stage s at ring + s * STAGE
  // holds Q, dO, LSE, D.
  const uint32_t ring = sV + TILE + (SPLIT ? 0 : wg * 2 * STAGE);
  // This warpgroup's columns of dK and dV: the B operands' panels from here.
  const uint32_t cols = SPLIT ? wg * 2 * PANEL : 0;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * TR;  // key tile 0, seen by the most q tiles, launches first
  const int hs = H / KV, h0 = kvh * hs;
  const long long q_stride = (long long)H * HD, kv_stride = (long long)KV * HD;
  const long long kv_off = ((long long)b * Sk * KV + kvh) * HD + (long long)k0 * kv_stride;
  // Causal: q tiles from row k0 on; a window ends them at the last row that
  // sees the tile's last key, k0 + TR - 1 + window - 1.  Unmasked: every q
  // tile, from row 0.
  const int q_begin = CAUSAL ? k0 : 0;
  const int q_end = WIN ? min(Sq, k0 + TR - 1 + window) : Sq;
  const int n_q = q_end > q_begin ? (q_end - q_begin + TR - 1) / TR : 0;
  const int n_steps = hs * n_q;
  // This warpgroup's steps: j = wg, wg + 2, ... (SPLIT: every one).
  const int my_steps = SPLIT ? n_steps : (n_steps - wg + 1) / 2;

  // Step j: query head h0 + j / n_q, q rows from q_begin + (j % n_q) 64,
  // loaded by the warpgroup that takes it (SPLIT: by the block).
  auto load_step = [&](int j, uint32_t st) {
    const int h = h0 + j / n_q, q0 = q_begin + (j % n_q) * TR;
    const long long off = ((long long)b * Sq * H + h) * HD + (long long)q0 * q_stride;
    if constexpr (SPLIT) {
      load_tile<HD, NT2>(st, q + off, q_stride, Sq - q0, tid);
      load_tile<HD, NT2>(st + TILE, dout + off, q_stride, Sq - q0, tid);
    } else {
      load_tile<HD, WG>(st, q + off, q_stride, Sq - q0, wtid);
      load_tile<HD, WG>(st + TILE, dout + off, q_stride, Sq - q0, wtid);
    }
    if (!SPLIT || wg == 0) {  // the LSE and D rows, a float a thread
      const int r = wtid % TR;
      const float* row = (wtid < TR ? lse : delta) + ((long long)b * H + h) * Sq + q0;
      const bool in = q0 + r < Sq;
      cp_async4(st + 2 * TILE + wtid * 4, in ? row + r : row, in ? 4 : 0);
    }
  };

  // This thread's accumulator rows (keys) row0 and row0 + 8, columns 8 i + cq, + 1.
  const int row0 = 16 * warp + lane / 4, cq = 2 * (lane % 4);
  const int kp0 = k0 + row0, kp1 = kp0 + 8;
  float dk_acc[CW / 2], dv_acc[CW / 2];
#pragma unroll
  for (int i = 0; i < CW / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  if (n_steps > 0) {
    load_tile<HD, NT2>(sK, k + kv_off, kv_stride, Sk - k0, tid);
    load_tile<HD, NT2>(sV, v + kv_off, kv_stride, Sk - k0, tid);
  }
  if (my_steps > 0) load_step(SPLIT ? 0 : wg, ring);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();  // K, V and each warpgroup's first step have landed

  const float sl2 = scale * LOG2E;
  for (int t = 0; t < my_steps; ++t) {
    const int j = SPLIT ? t : wg + 2 * t;
    const uint32_t st = ring + (t & 1) * STAGE;
    const int q0 = q_begin + (j % n_q) * TR;
    if (t > 0) {
      cp_async_wait<0>();  // step j has landed (this thread's copies)
      fence_proxy_async();
      // ... and every copier's, and the ring's readers are done with the
      // step before (the warpgroup's, SPLIT the block's)
      if constexpr (SPLIT)
        __syncthreads();
      else
        warpgroup_barrier(1 + wg);
    }
    if (t + 1 < my_steps) load_step(SPLIT ? j + 1 : j + 2, ring + ((t + 1) & 1) * STAGE);
    cp_async_commit();

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 q rows each.
    float s[32], dp[32];
    wgmma_fence();
    wgmma_abt<HD>(s, sK, st);
    wgmma_abt<HD>(dp, sV, st + TILE);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T as bf16 A fragments over k = the step's q rows.  Only a
    // step on the diagonal (causal), across the window's lower edge or on a
    // ragged edge has a masked pair.
    const float* lse_s = reinterpret_cast<const float*>(smem_raw + (st - raw) + 2 * TILE);
    const float* dl_s = lse_s + TR;
    const bool edge = (CAUSAL && q0 < k0 + TR) || q0 + TR > Sq || k0 + TR > Sk ||
                      (WIN && q0 + TR - 1 - k0 >= window);
    uint32_t pa[16], sa[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = 8 * i + cq;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
      const float2 d2 = *reinterpret_cast<const float2*>(dl_s + c);
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l = (e & 1) ? l2.y : l2.x, d = (e & 1) ? d2.y : d2.x;
        float x;
        [[maybe_unused]] float slope;  // the softcap's 1 - t^2
        if constexpr (SOFTCAP) {
          const float th = tanhf(s[4 * i + e] * scale / softcap);  // the forward's t
          x = fast_exp2(fmaf(th, softcap * LOG2E, -l * LOG2E));
          slope = fmaf(-th, th, 1.f);
        } else {
          x = fast_exp2(fmaf(s[4 * i + e], sl2, -l * LOG2E));
        }
        if (edge) {
          const int qp = q0 + c + (e & 1), kp = e < 2 ? kp0 : kp1;
          if constexpr (CAUSAL) {
            if (!(qp < Sq && kp < Sk && qp >= kp && (!WIN || qp - kp < window))) x = 0.f;
          } else {
            if (!(qp < Sq && kp < Sk)) x = 0.f;
          }
        }
        p[e] = x;
        if constexpr (SOFTCAP)
          ds[e] = x * (dp[4 * i + e] - d) * slope;
        else
          ds[e] = x * (dp[4 * i + e] - d);
      }
      pa[2 * i] = pack(p[0], p[1]);
      pa[2 * i + 1] = pack(p[2], p[3]);
      sa[2 * i] = pack(ds[0], ds[1]);
      sa[2 * i + 1] = pack(ds[2], ds[3]);
    }

    // dV += P^T dO and dK += dS^T Q over this warpgroup's columns, dO and Q
    // the N-major B operand.
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < TR / 16; ++kt) {
      wgmma_rs<CW>(dv_acc, pa, kt, st + TILE + cols);
      wgmma_rs<CW>(dk_acc, sa, kt, st + cols);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pa);
    fence_regs(sa);
  }
  cp_async_wait<0>();

  if constexpr (!SPLIT) {
    // Warpgroup 1's sums to warpgroup 0 through the rings' memory, each
    // thread's values at a stride of 128 floats (no bank conflicts); then
    // warpgroup 0 adds them to its own, in this fixed order.
    float* red = reinterpret_cast<float*>(smem_raw + (sV + TILE - raw));
    __syncthreads();  // every warpgroup is done with its ring
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) {
        red[i * WG + wtid] = dk_acc[i];
        red[(HD / 2 + i) * WG + wtid] = dv_acc[i];
      }
    }
    __syncthreads();
    if (wg == 1) return;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) {
      dk_acc[i] += red[i * WG + wtid];
      dv_acc[i] += red[(HD / 2 + i) * WG + wtid];
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kp = half ? kp1 : kp0;
    if (kp >= Sk) continue;
    const long long row =
        ((long long)b * Sk + kp) * kv_stride + (long long)kvh * HD + (SPLIT ? wg * CW : 0);
#pragma unroll
    for (int i = 0; i < CW / 8; ++i) {
      const int col = 8 * i + cq, e = 4 * i + 2 * half;
      *reinterpret_cast<uint32_t*>(dk + row + col) =
          pack(dk_acc[e] * scale, dk_acc[e + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + row + col) = pack(dv_acc[e], dv_acc[e + 1]);
    }
  }
}

// dQ of 64 q rows (tile gridDim.z - 1 - blockIdx.z) of head blockIdx.x,
// batch blockIdx.y.
template <int HD, bool CAUSAL, bool WIN, bool SOFTCAP>
__global__ void __launch_bounds__(WG) flash_bwd_dq_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Sk, int H, int KV,
    int window, float scale, float softcap) {
  constexpr uint32_t TILE = tile_bytes<HD>(), STAGE = 2 * TILE;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sO = sQ + TILE;
  const uint32_t sRing = sO + TILE;  // stage s at sRing + s * STAGE: K, V

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TR;  // the last q tile, seen the longest, first
  const int kvh = h / (H / KV);
  const long long q_stride = (long long)H * HD, kv_stride = (long long)KV * HD;
  const long long q_off = ((long long)b * Sq * H + h) * HD + (long long)q0 * q_stride;
  const long long kv_off = ((long long)b * Sk * KV + kvh) * HD;
  // Causal: keys up to the tile's last row; unmasked: every key.
  const int k_end = CAUSAL ? min(Sk, min(q0 + TR, Sq)) : Sk;
  // A window starts at the tile of the first row's first key, q0 - window + 1.
  const int j0 = WIN ? max(0, q0 - window + 1) / TR : 0;
  const int n_k = (k_end + TR - 1) / TR;

  auto load_step = [&](int j, uint32_t st) {
    const int k0 = j * TR;
    load_tile<HD, WG>(st, k + kv_off + (long long)k0 * kv_stride, kv_stride, Sk - k0, tid);
    load_tile<HD, WG>(st + TILE, v + kv_off + (long long)k0 * kv_stride, kv_stride, Sk - k0,
                      tid);
  };
  load_tile<HD, WG>(sQ, q + q_off, q_stride, Sq - q0, tid);
  load_tile<HD, WG>(sO, dout + q_off, q_stride, Sq - q0, tid);
  if (!WIN || j0 < n_k) load_step(j0, sRing);
  cp_async_commit();

  // This thread's accumulator rows (q rows) row0 and row0 + 8.
  const int row0 = 16 * warp + lane / 4, cq = 2 * (lane % 4);
  const int qp0 = q0 + row0, qp1 = qp0 + 8;
  const float* lse_h = lse + ((long long)b * H + h) * Sq;
  const float* dl_h = delta + ((long long)b * H + h) * Sq;
  const float l0 = qp0 < Sq ? lse_h[qp0] * LOG2E : 0.f, l1 = qp1 < Sq ? lse_h[qp1] * LOG2E : 0.f;
  const float d0 = qp0 < Sq ? dl_h[qp0] : 0.f, d1 = qp1 < Sq ? dl_h[qp1] : 0.f;

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  const float sl2 = scale * LOG2E;
  for (int j = j0; j < n_k; ++j) {
    const uint32_t st = sRing + ((j - j0) & 1) * STAGE;
    const int k0 = j * TR;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (j + 1 < n_k) load_step(j + 1, sRing + ((j + 1 - j0) & 1) * STAGE);
    cp_async_commit();

    // S = Q K^T and dP = dO V^T: 64 q rows x 64 keys each.
    float s[32], dp[32];
    wgmma_fence();
    wgmma_abt<HD>(s, sQ, st);
    wgmma_abt<HD>(dp, sO, st + TILE);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    const bool edge = (CAUSAL && k0 + TR > q0) || k0 + TR > Sk || q0 + TR > Sq ||
                      (WIN && q0 + TR - 1 - k0 >= window);
    uint32_t sa[16];  // dS as bf16 A fragments over k = the step's keys
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x;
        [[maybe_unused]] float slope;  // the softcap's 1 - t^2
        if constexpr (SOFTCAP) {
          const float th = tanhf(s[4 * i + e] * scale / softcap);  // the forward's t
          x = fast_exp2(fmaf(th, softcap * LOG2E, -(e < 2 ? l0 : l1)));
          slope = fmaf(-th, th, 1.f);
        } else {
          x = fast_exp2(fmaf(s[4 * i + e], sl2, -(e < 2 ? l0 : l1)));
        }
        if (edge) {
          const int qp = e < 2 ? qp0 : qp1, kp = k0 + 8 * i + cq + (e & 1);
          if constexpr (CAUSAL) {
            if (!(qp < Sq && kp < Sk && qp >= kp && (!WIN || qp - kp < window))) x = 0.f;
          } else {
            if (!(qp < Sq && kp < Sk)) x = 0.f;
          }
        }
        if constexpr (SOFTCAP)
          ds[e] = x * (dp[4 * i + e] - (e < 2 ? d0 : d1)) * slope;
        else
          ds[e] = x * (dp[4 * i + e] - (e < 2 ? d0 : d1));
      }
      sa[2 * i] = pack(ds[0], ds[1]);
      sa[2 * i + 1] = pack(ds[2], ds[3]);
    }

    // dQ += dS K, K the N-major B operand.
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < TR / 16; ++t) wgmma_rs<HD>(acc, sa, t, st);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(sa);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qp = half ? qp1 : qp0;
    if (qp >= Sq) continue;
    bf16* row = dq + ((long long)b * Sq + qp) * q_stride + (long long)h * HD;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      const int e = 4 * i + 2 * half;
      *reinterpret_cast<uint32_t*>(row + 8 * i + cq) = pack(acc[e] * scale, acc[e + 1] * scale);
    }
  }
}

template <int HD, bool CAUSAL, bool WIN, bool SOFTCAP>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
                   const float* lse, float* delta, bf16* dq, bf16* dk, bf16* dv, int B, int Sq,
                   int Sk, int H, int KV, int window, float scale, float softcap,
                   cudaStream_t stream) {
  flash_bwd_delta_kernel<HD><<<(unsigned)B * Sq, WG, 0, stream>>>(o, dout, delta, Sq, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkdv = flash_bwd_dkdv_wgmma_kernel<HD, CAUSAL, WIN, SOFTCAP>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkdv_smem<HD>());
  if (err != cudaSuccess) return err;
  dkdv<<<dim3(KV, B, (Sk + TR - 1) / TR), NT2, dkdv_smem<HD>(), stream>>>(
      q, k, v, dout, lse, delta, dk, dv, Sq, Sk, H, KV, window, scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_wgmma_kernel<HD, CAUSAL, WIN, SOFTCAP>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem<HD>());
  if (err != cudaSuccess) return err;
  dqk<<<dim3(H, B, (Sq + TR - 1) / TR), WG, dq_smem<HD>(), stream>>>(
      q, k, v, dout, lse, delta, dq, Sq, Sk, H, KV, window, scale, softcap);
  return cudaGetLastError();
}

// The instantiation for the mask (unmasked, causal, causal with a window)
// and the softcap (none or one).
template <int HD>
cudaError_t dispatch(bool causal, bool win, bool cap, const bf16* q, const bf16* k,
                     const bf16* v, const bf16* o, const bf16* dout, const float* lse,
                     float* delta, bf16* dq, bf16* dk, bf16* dv, int B, int Sq, int Sk, int H,
                     int KV, int window, float scale, float softcap, cudaStream_t stream) {
  using Fn = decltype(&launch<HD, true, false, false>);
  constexpr Fn fns[2][3] = {
      {launch<HD, false, false, false>, launch<HD, true, false, false>,
       launch<HD, true, true, false>},
      {launch<HD, false, false, true>, launch<HD, true, false, true>,
       launch<HD, true, true, true>}};
  return fns[cap][!causal ? 0 : win ? 2 : 1](q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk,
                                             H, KV, window, scale, softcap, stream);
}

}  // namespace

// Attention's gradient on wgmma.  q, o, dout, dq: [B, Sq, H, hd]; k, v, dk,
// dv: [B, Sk, KV, hd]; all contiguous bf16 (DTypeCode) with 16-byte aligned
// base addresses; hd 64, 128 or 256; causal 1 (top-left aligned) or 0
// (unmasked); window the sliding window's width, 0 for none (causal only);
// softcap the tanh cap of the scaled scores, 0 for none.  lse: [B, H, Sq]
// fp32 from the forward; delta: [B, H, Sq] fp32 scratch.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int flash_attention_bwd_wgmma(int dtype, const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* delta, void* dq, void* dk, void* dv, int B, int Sq,
                                         int Sk, int H, int KV, int hd, int causal, int window,
                                         float scale, float softcap, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
                          reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
                          reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv);
  if (dtype != kBFloat16 || B < 1 || Sq < 1 || Sk < 1 || H < 1 || KV < 1 || H % KV ||
      H > 65535 || B > 65535 || (long long)B * Sq > 0x7fffffff || (Sq + TR - 1) / TR > 65535 ||
      (Sk + TR - 1) / TR > 65535 || window < 0 || (!causal && window > 0) || !(softcap >= 0.f) ||
      (align & 15))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* ob = static_cast<const bf16*>(o);
  const auto* gb = static_cast<const bf16*>(dout);
  const auto* lf = static_cast<const float*>(lse);
  auto* df = static_cast<float*>(delta);
  auto* dqb = static_cast<bf16*>(dq);
  auto* dkb = static_cast<bf16*>(dk);
  auto* dvb = static_cast<bf16*>(dv);
  const bool c = causal != 0, w = window > 0, cap = softcap > 0.f;
  switch (hd) {
    case 64:
      return dispatch<64>(c, w, cap, qb, kb, vb, ob, gb, lf, df, dqb, dkb, dvb, B, Sq, Sk, H, KV,
                          window, scale, softcap, s);
    case 128:
      return dispatch<128>(c, w, cap, qb, kb, vb, ob, gb, lf, df, dqb, dkb, dvb, B, Sq, Sk, H, KV,
                           window, scale, softcap, s);
    case 256:
      return dispatch<256>(c, w, cap, qb, kb, vb, ob, gb, lf, df, dqb, dkb, dvb, B, Sq, Sk, H, KV,
                           window, scale, softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_bwd_wgmma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
