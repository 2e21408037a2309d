// Flash attention backward for Hopper (sm_90a) on wgmma: bf16, head dim 64
// or 128.  The `wgmma` variant of flash_attention_bwd; the wrapper
// (kernels/flash_attention.py, `bwd_variant`) routes bf16 at those head dims
// with 16-byte aligned tensors here, and fp32 and the rest to the `simt`
// variant of flash_attention_bwd.cu.  That file's `mma` variant (mma.sync)
// computes the same function and is kept, unrouted, as a yardstick.
//
// The gradient of the TPU kernel repro/kernels/flash_attention.py:99
// `flash_attention` (causal, GQA, no window or softcap), which the reference
// takes by XLA autodiff of `mha_dense` (repro/models/attention.py:157-182).
// Given q [B,Sq,H,hd], k, v [B,Sk,KV,hd], the forward's output o and its
// log-sum-exp lse [B,H,Sq], and dO, with P = exp(q k^T * scale - lse) (0
// where masked; row i sees keys <= i, top-left aligned):
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
// Bound on the H100: at qwen3-4b's training shape, B4 S512 H32 KV8 hd128
// causal, 5 products of 2 hd flops for each live (q, k) pair, 21.5 GFLOP
// (21.8 us at 989 TFLOP/s), and 84 MB moved (25.1 us at 3.35 TB/s): bytes,
// by a little.
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
// an SM.  Registers a thread at hd 128 (dK/dV): dK and dV 64 fp32 each, S^T
// and dP^T 32 each; the bf16 P^T and dS^T fragments (16 each) replace S^T
// and dP^T as they are formed.  ptxas for sm_90a at -O3 (chip_smoke.py's
// phase 2 prints it): dK/dV 254 registers at hd 128 and 194 at hd 64, dQ
// 183 and 138, the prepass 32, none spilling.
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

// acc[64 x HD] += A[64 x 16] B[16 x HD], B the N-major rows 16 t.. of `tile`.
template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&acc)[HD / 2], const uint32_t (&frag)[16], int t,
                                         uint32_t tile) {
  const uint32_t a[4] = {frag[4 * t], frag[4 * t + 1], frag[4 * t + 2], frag[4 * t + 3]};
  if constexpr (HD == 64)
    wgmma_rs_n64(acc, a, nmajor(tile, t));
  else
    wgmma_rs_n128(acc, a, nmajor(tile, t));
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
template <int HD>
constexpr size_t dkdv_smem() {  // K, V, each warpgroup's ring, alignment
  return 2 * tile_bytes<HD>() + 2 * 2 * dkdv_stage_bytes<HD>() + 1024;
}
template <int HD>
constexpr size_t dq_smem() {
  return 2 * tile_bytes<HD>() + 2 * 2 * tile_bytes<HD>() + 1024;  // Q, dO, the K/V ring, alignment
}

// dK and dV of 64 keys (tile blockIdx.z) of kv head blockIdx.x, batch
// blockIdx.y, summed over its group's query heads.  The steps (query head,
// q tile) are dealt to the two warpgroups in turn; each runs its own ring
// and barrier, and at the end warpgroup 1 hands its sums to warpgroup 0
// through shared memory.
template <int HD>
__global__ void __launch_bounds__(NT2, 1) flash_bwd_dkdv_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,
    int Sk, int H, int KV, float scale) {
  constexpr uint32_t TILE = tile_bytes<HD>(), STAGE = dkdv_stage_bytes<HD>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023) & ~1023u;
  const uint32_t sV = sK + TILE;
  const int tid = threadIdx.x, wg = tid / WG, wtid = tid % WG, warp = wtid / 32, lane = tid % 32;
  // This warpgroup's ring: stage s at ring + s * STAGE holds Q, dO, LSE, D.
  const uint32_t ring = sV + TILE + wg * 2 * STAGE;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * TR;  // key tile 0, seen by the most q tiles, launches first
  const int hs = H / KV, h0 = kvh * hs;
  const long long q_stride = (long long)H * HD, kv_stride = (long long)KV * HD;
  const long long kv_off = ((long long)b * Sk * KV + kvh) * HD + (long long)k0 * kv_stride;
  const int n_q = Sq > k0 ? (Sq - k0 + TR - 1) / TR : 0;  // causal: q tiles from row k0 on
  const int n_steps = hs * n_q;
  const int my_steps = (n_steps - wg + 1) / 2;  // this warpgroup's: j = wg, wg + 2, ...

  // Step j: query head h0 + j / n_q, q rows from k0 + (j % n_q) 64.
  auto load_step = [&](int j, uint32_t st) {
    const int h = h0 + j / n_q, q0 = k0 + (j % n_q) * TR;
    const long long off = ((long long)b * Sq * H + h) * HD + (long long)q0 * q_stride;
    load_tile<HD, WG>(st, q + off, q_stride, Sq - q0, wtid);
    load_tile<HD, WG>(st + TILE, dout + off, q_stride, Sq - q0, wtid);
    const int r = wtid % TR;
    const float* row = (wtid < TR ? lse : delta) + ((long long)b * H + h) * Sq + q0;
    const bool in = q0 + r < Sq;
    cp_async4(st + 2 * TILE + wtid * 4, in ? row + r : row, in ? 4 : 0);
  };

  // This thread's accumulator rows (keys) row0 and row0 + 8, columns 8 i + cq, + 1.
  const int row0 = 16 * warp + lane / 4, cq = 2 * (lane % 4);
  const int kp0 = k0 + row0, kp1 = kp0 + 8;
  float dk_acc[HD / 2], dv_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  if (n_steps > 0) {
    load_tile<HD, NT2>(sK, k + kv_off, kv_stride, Sk - k0, tid);
    load_tile<HD, NT2>(sV, v + kv_off, kv_stride, Sk - k0, tid);
  }
  if (my_steps > 0) load_step(wg, ring);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();  // K, V and each warpgroup's first step have landed

  const float sl2 = scale * LOG2E;
  for (int t = 0; t < my_steps; ++t) {
    const int j = wg + 2 * t;
    const uint32_t st = ring + (t & 1) * STAGE;
    const int q0 = k0 + (j % n_q) * TR;
    if (t > 0) {
      cp_async_wait<0>();  // step j has landed (this thread's copies)
      fence_proxy_async();
      warpgroup_barrier(1 + wg);  // ... and the warpgroup's, which is done with step j - 2
    }
    if (t + 1 < my_steps) load_step(j + 2, ring + ((t + 1) & 1) * STAGE);
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
    // step on the diagonal or a ragged edge has a masked pair.
    const float* lse_s = reinterpret_cast<const float*>(smem_raw + (st - raw) + 2 * TILE);
    const float* dl_s = lse_s + TR;
    const bool edge = q0 < k0 + TR || q0 + TR > Sq || k0 + TR > Sk;
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
        float x = fast_exp2(fmaf(s[4 * i + e], sl2, -l * LOG2E));
        if (edge) {
          const int qp = q0 + c + (e & 1), kp = e < 2 ? kp0 : kp1;
          if (!(qp < Sq && kp < Sk && qp >= kp)) x = 0.f;
        }
        p[e] = x;
        ds[e] = x * (dp[4 * i + e] - d);
      }
      pa[2 * i] = pack(p[0], p[1]);
      pa[2 * i + 1] = pack(p[2], p[3]);
      sa[2 * i] = pack(ds[0], ds[1]);
      sa[2 * i + 1] = pack(ds[2], ds[3]);
    }

    // dV += P^T dO and dK += dS^T Q, dO and Q the N-major B operand.
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < TR / 16; ++kt) {
      wgmma_rs<HD>(dv_acc, pa, kt, st + TILE);
      wgmma_rs<HD>(dk_acc, sa, kt, st);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pa);
    fence_regs(sa);
  }
  cp_async_wait<0>();

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

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kp = half ? kp1 : kp0;
    if (kp >= Sk) continue;
    const long long row = ((long long)b * Sk + kp) * kv_stride + (long long)kvh * HD;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      const int col = 8 * i + cq, e = 4 * i + 2 * half;
      *reinterpret_cast<uint32_t*>(dk + row + col) =
          pack(dk_acc[e] * scale, dk_acc[e + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + row + col) = pack(dv_acc[e], dv_acc[e + 1]);
    }
  }
}

// dQ of 64 q rows (tile gridDim.z - 1 - blockIdx.z) of head blockIdx.x,
// batch blockIdx.y.
template <int HD>
__global__ void __launch_bounds__(WG) flash_bwd_dq_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Sk, int H, int KV,
    float scale) {
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
  const int k_end = min(Sk, min(q0 + TR, Sq));  // causal: keys up to the tile's last row
  const int n_k = (k_end + TR - 1) / TR;

  auto load_step = [&](int j, uint32_t st) {
    const int k0 = j * TR;
    load_tile<HD, WG>(st, k + kv_off + (long long)k0 * kv_stride, kv_stride, Sk - k0, tid);
    load_tile<HD, WG>(st + TILE, v + kv_off + (long long)k0 * kv_stride, kv_stride, Sk - k0,
                      tid);
  };
  load_tile<HD, WG>(sQ, q + q_off, q_stride, Sq - q0, tid);
  load_tile<HD, WG>(sO, dout + q_off, q_stride, Sq - q0, tid);
  load_step(0, sRing);
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
  for (int j = 0; j < n_k; ++j) {
    const uint32_t st = sRing + (j & 1) * STAGE;
    const int k0 = j * TR;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (j + 1 < n_k) load_step(j + 1, sRing + ((j + 1) & 1) * STAGE);
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

    const bool edge = k0 + TR > q0 || k0 + TR > Sk || q0 + TR > Sq;
    uint32_t sa[16];  // dS as bf16 A fragments over k = the step's keys
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = fast_exp2(fmaf(s[4 * i + e], sl2, -(e < 2 ? l0 : l1)));
        if (edge) {
          const int qp = e < 2 ? qp0 : qp1, kp = k0 + 8 * i + cq + (e & 1);
          if (!(qp < Sq && kp < Sk && qp >= kp)) x = 0.f;
        }
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

template <int HD>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
                   const float* lse, float* delta, bf16* dq, bf16* dk, bf16* dv, int B, int Sq,
                   int Sk, int H, int KV, float scale, cudaStream_t stream) {
  flash_bwd_delta_kernel<HD><<<(unsigned)B * Sq, WG, 0, stream>>>(o, dout, delta, Sq, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkdv = flash_bwd_dkdv_wgmma_kernel<HD>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkdv_smem<HD>());
  if (err != cudaSuccess) return err;
  dkdv<<<dim3(KV, B, (Sk + TR - 1) / TR), NT2, dkdv_smem<HD>(), stream>>>(
      q, k, v, dout, lse, delta, dk, dv, Sq, Sk, H, KV, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_wgmma_kernel<HD>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem<HD>());
  if (err != cudaSuccess) return err;
  dqk<<<dim3(H, B, (Sq + TR - 1) / TR), WG, dq_smem<HD>(), stream>>>(q, k, v, dout, lse, delta,
                                                                       dq, Sq, Sk, H, KV, scale);
  return cudaGetLastError();
}

}  // namespace

// Causal attention's gradient on wgmma.  q, o, dout, dq: [B, Sq, H, hd]; k,
// v, dk, dv: [B, Sk, KV, hd]; all contiguous bf16 (DTypeCode) with 16-byte
// aligned base addresses; hd 64 or 128.  lse: [B, H, Sq] fp32 from the
// forward; delta: [B, H, Sq] fp32 scratch.  Returns the cudaError_t of the
// launches (0 on success).
extern "C" int flash_attention_bwd_wgmma(int dtype, const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* delta, void* dq, void* dk, void* dv, int B, int Sq,
                                         int Sk, int H, int KV, int hd, float scale,
                                         void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
                          reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
                          reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv);
  if (dtype != kBFloat16 || B < 1 || Sq < 1 || Sk < 1 || H < 1 || KV < 1 || H % KV ||
      H > 65535 || B > 65535 || (long long)B * Sq > 0x7fffffff || (Sq + TR - 1) / TR > 65535 ||
      (Sk + TR - 1) / TR > 65535 || (align & 15))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* ob = static_cast<const bf16*>(o);
  const auto* gb = static_cast<const bf16*>(dout);
  const auto* lf = static_cast<const float*>(lse);
  auto* df = static_cast<float*>(delta);
  switch (hd) {
    case 64:
      return launch<64>(qb, kb, vb, ob, gb, lf, df, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                        static_cast<bf16*>(dv), B, Sq, Sk, H, KV, scale, s);
    case 128:
      return launch<128>(qb, kb, vb, ob, gb, lf, df, static_cast<bf16*>(dq),
                         static_cast<bf16*>(dk), static_cast<bf16*>(dv), B, Sq, Sk, H, KV,
                         scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_bwd_wgmma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
