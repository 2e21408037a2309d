// Flash attention forward for Hopper (sm_90a) on the tensor cores: bf16,
// head dim 64, 128 or 256.  The `wgmma` variant of `flash_attention`; the
// wrapper (kernels/flash_attention.py, `variant`) routes fp32 and other head
// dims to the CUDA-core kernel of flash_attention.cu.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:99
// `flash_attention` (body `_flash_kernel`) for those inputs, with its
// semantics at block_q = 128 and block_k = 128 (64 at hd 256): an online
// softmax (m, l, acc) in fp32; causal and sliding-window masks on absolute
// positions from 0; whole-tile skipping; an optional tanh logit softcap;
// GQA through kv head h / (H / KV).  Masked logits are -1e30, so a row that meets a live tile
// with every key masked averages that tile's values, and a row that meets
// no live tile outputs 0.  Keys past Sk are padding, not masked keys: their
// logit is -inf and they take no weight (a zero-filled K row would give a
// logit of 0, so the mask is by position).
//
// One stated difference from the TPU kernel: P is rounded to bf16 before
// P.V, which runs on the tensor cores with an fp32 sum.  The TPU kernel
// casts P to v's type, but v is fp32 there (:62, :87), so its P.V is fp32.
// The rounding moves each weight by at most 2^-9 of itself; the plain
// version keeps P in fp32 and the kernel is held to it at the bf16
// tolerance (rtol = atol = 2e-2).
//
// Bound on the H100: the causal B4 S512 H32 KV8 hd128 call of qwen3-4b's
// prefill moves 42 MB of q, k, v and out (12.5 us at 3.35 TB/s) and needs
// 8.6 GFLOP for its live (q, k) pairs (8.7 us at 989 TFLOP/s): bytes, by a
// little.  Flops grow with Sq * Sk, so longer prompts are bound by the
// tensor cores.  At hd 256 a pair costs twice the flops: gemma3-4b's causal
// B4 S2048 H8 KV4 prefill moves 101 MB (30 us) and needs 68.8 GFLOP (69.5
// us), and gemma2-9b's B4 S512 H16 KV8 (softcap 50) moves 50 MB (15.0 us)
// against 8.6 GFLOP (8.7 us): operations at gemma3's prompt, bytes at
// gemma2's.
//
// Design: one block of two warpgroups (256 threads) for each (q tile of 128
// rows, head, batch); each warpgroup owns 64 q rows.  The q tile is loaded
// once into shared memory; k and v tiles of BK keys go through a ring of
// STAGES, each tile's cp.async copies issued STAGES - 1 tiles ahead so that
// they overlap the math, with one block barrier a tile (`Tiles`: 128 keys
// and 3 stages up to hd 128; 64 keys and 2 stages at hd 256, where 128-key
// tiles in 3 stages would need 448 KB).  Tiles are stored as 64-column
// panels of 128-byte rows in the 128-byte swizzle that wgmma reads (16-byte
// chunk c of row r at chunk c ^ (r % 8)), written so by the cp.async
// addressing; a panel holds the tile's rows (16 KB for 128, 8 KB for 64)
// and is 1024-byte aligned.  S = Q K^T is wgmma m64nBKk16 with both
// operands in shared memory (K rows are contiguous in hd: the K-major B
// operand).  The online softmax runs on S in the accumulator's own
// registers, in log2 units
// (exp(s - m) = 2^(s log2(e) - m')): each row lies in the 4 threads of a
// quad, reduced with two shuffles, and a tile that no mask touches costs
// one FFMA and one ex2 a score.  P goes to bf16 in registers, where the
// accumulator's layout is the A operand's, and O += P V is wgmma with A
// from registers and V as the N-major B operand (the transpose bit), so no
// transposed copy of V is written; at hd 256 it is two m64n128k16 products
// a step of 16 keys, one on each half of O's columns.  The output goes
// through the block's own q rows in shared memory and out in 16-byte
// stores.  q tiles are launched
// longest first (the tile index is the slowest grid axis, reversed), so
// causal work leaves no tail wave.  Shared memory at hd 128: q 32 KB + 3 x
// (k 32 KB + v 32 KB) = 224 KB; registers a thread: S 64, O 64, P 32.  At
// hd 256: q 64 KB + 2 x (k 32 KB + v 32 KB) = 192 KB; registers: S 32, O
// 128, P 16.
//
// Not yet done (the next step for speed): the two warpgroups run their
// softmax at the same time, between the block's two products, so the
// tensor cores wait for it.  Overlapping one warpgroup's softmax with the
// other's products (or with the next tile's S) needs either a producer warp
// with mbarriers in place of the block barrier or room for a second S in
// registers; a version that ran warpgroup 1 half a tile behind in a branch
// of its own needed 254 registers a thread and was slower.
//
// When `lse` is not null the launcher picks the instantiation that also
// writes each row's log-sum-exp in natural units, fp32 [B, H, Sq]: m log 2
// + log l, where m is the row's running maximum in log2 units, and a row
// that met only masked keys (m = -1e30, which is -1e30 in either unit)
// gets -1e30 + log l, as the plain version gives.  The backward
// (flash_attention_bwd.cu) recomputes P from it.  Serving passes null and
// runs the instantiation without it.
//
// Addresses are computed from [B, S, heads, hd] with S as its own axis, so
// a tile never reads the next sequence's rows: rows past Sq or Sk are
// zero-filled (cp.async with a source size of 0).  The wrapper requires
// contiguous inputs with 16-byte aligned base addresses.  No descriptor is
// built on the host, so the launch is legal inside a CUDA graph capture;
// the launcher allocates nothing and does not synchronise.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int NT = 256;           // threads a block: two warpgroups
constexpr int BQ = 128;           // q rows a block (64 a warpgroup)
constexpr float NEG = -1e30f;     // the TPU kernel's mask value
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

// Keys a tile and the k/v ring's stages at head dim HD: the q tile and the
// ring, (BQ + 2 STAGES BK) HD bf16, must fit in the 227 KB a block can have.
// Up to hd 128: 128 keys, 3 stages, each tile loaded two ahead.  At hd 256:
// 64 keys, 2 stages, each tile loaded one ahead.
template <int HD>
struct Tiles {
  static constexpr int BK = HD <= 128 ? 128 : 64;
  static constexpr int STAGES = HD <= 128 ? 3 : 2;
  static constexpr size_t SMEM = (size_t)(BQ + 2 * STAGES * BK) * HD * 2 + 1024;  // + alignment
  static_assert(SMEM <= 232448, "the tiles exceed a block's shared memory");
};

// S = Q K^T += over one 16-column step, for BK keys.
template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&s)[BK / 2], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  if constexpr (BK == 64)
    wgmma_ss_n64(s, desc_a, desc_b, accumulate);
  else
    wgmma_ss_n128(s, desc_a, desc_b, accumulate);
}

// O += P V for head dim HD, 16 keys: V's rows from shared address `addr`,
// its 64-column panels `panel` bytes apart (the N-major B operand).  At hd
// 256, O's two 128-column halves over V's panels 0-1 and 2-3.
template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2], const uint32_t (&a)[4],
                                         uint32_t addr, uint32_t panel) {
  if constexpr (HD == 64) {
    wgmma_rs_n64(o, a, sw128_desc(addr, panel, 1024));
  } else if constexpr (HD == 128) {
    wgmma_rs_n128(o, a, sw128_desc(addr, panel, 1024));
  } else {
    wgmma_rs_n128<0>(o, a, sw128_desc(addr, panel, 1024));
    wgmma_rs_n128<64>(o, a, sw128_desc(addr + 2 * panel, panel, 1024));
  }
}

// Byte offset of 16-byte chunk c (8 columns) of row r in a tile of ROWS
// rows: 64-column panels of ROWS 128-byte rows each.
template <int ROWS>
__device__ __forceinline__ uint32_t chunk_offset(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Copy rows [0, ROWS) of a tile, hd columns, from `g` (row stride `stride`
// elements) into shared memory at `dst`; rows from `valid` on are zeros.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* g, long long stride, int valid,
                                          int tid) {
  constexpr int CPR = HD / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < ROWS * CPR / NT; ++i) {
    const int e = tid + i * NT;
    const int r = e / CPR, c = e % CPR;
    const bool in = r < valid;
    cp_async16(dst + chunk_offset<ROWS>(r, c), in ? g + r * stride + c * 8 : g, in ? 16 : 0);
  }
}

template <int HD, bool WRITE_LSE>
__global__ void __launch_bounds__(NT, 1)
    flash_fwd_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ out,
                           float* __restrict__ lse, int Sq, int Sk, int H, int KV, float scale,
                           int causal, int window, float softcap) {
  constexpr int BK = Tiles<HD>::BK, STAGES = Tiles<HD>::STAGES;
  constexpr uint32_t Q_PANEL = BQ * 128, KV_PANEL = BK * 128;  // bytes of a 64-column panel
  constexpr uint32_t KV_TILE = BK * HD * 2;                    // bytes of a k or v tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;  // the swizzle needs 1024-byte aligned panels
  const uint32_t sK = sQ + BQ * HD * 2;       // stage s at sK + s * KV_TILE
  const uint32_t sV = sK + STAGES * KV_TILE;  // stage s at sV + s * KV_TILE
  uint8_t* q_tile = smem_raw + (sQ - raw);

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // longest causal tiles first
  const int kvh = h / (H / KV);
  const long long q_stride = (long long)H * HD, kv_stride = (long long)KV * HD;
  const bf16* qb = q + ((long long)b * Sq * H + h) * HD + q0 * q_stride;
  const bf16* kb = k + ((long long)b * Sk * KV + kvh) * HD;
  const bf16* vb = v + ((long long)b * Sk * KV + kvh) * HD;

  // The k tiles holding a key that some row of this q tile may see.
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_first = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  const int n_tiles = k_end > k_first ? (k_end - k_first + BK - 1) / BK : 0;

  // This thread's two rows of the accumulators, and its columns 8 i + cq, + 1.
  const int row0 = 64 * wg + 16 * warp + lane / 4;
  const int qp0 = q0 + row0, qp1 = qp0 + 8;
  const int cq = 2 * (lane % 4);

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // l: this thread's share of the row sum

  if (n_tiles > 0) load_tile<HD, BQ>(sQ, qb, q_stride, Sq - q0, tid);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {  // the first tiles, one commit group each
    const int kt = k_first + t * BK;
    if (t < n_tiles) {
      load_tile<HD, BK>(sK + t * KV_TILE, kb + kt * kv_stride, kv_stride, Sk - kt, tid);
      load_tile<HD, BK>(sV + t * KV_TILE, vb + kt * kv_stride, kv_stride, Sk - kt, tid);
    }
    cp_async_commit();
  }

  const float sl2 = scale * LOG2E;  // scores are kept in log2 units: exp(s - m) = 2^(x - m2)
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = k_first + j * BK;
    const uint32_t st = (j % STAGES) * KV_TILE;
    cp_async_wait<STAGES - 2>();  // q and tile j have landed (this thread's copies)
    fence_proxy_async();
    __syncthreads();  // ... and every thread's, and every thread is done with tile j - 1
    {  // tile j + STAGES - 1 into the stage that tile j - 1 held
      const int kn = k0 + (STAGES - 1) * BK;
      if (j + STAGES - 1 < n_tiles) {
        const uint32_t sn = ((j + STAGES - 1) % STAGES) * KV_TILE;
        load_tile<HD, BK>(sK + sn, kb + kn * kv_stride, kv_stride, Sk - kn, tid);
        load_tile<HD, BK>(sV + sn, vb + kn * kv_stride, kv_stride, Sk - kn, tid);
      }
      cp_async_commit();
    }

    // S = Q K^T for this warpgroup's 64 rows: 64 x BK, hd / 16 steps, each
    // 16 columns of a q and a k panel.
    float s[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_qk<BK>(s, sw128_desc(sQ + (kk / 4) * Q_PANEL + col + wg * 64 * 128, 0, 1024),
                   sw128_desc(sK + st + (kk / 4) * KV_PANEL + col, 0, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // A tile away from the causal diagonal, the window's edge and Sk has no
    // masked key: there the raw scores go straight into the exponent, one
    // FFMA each.  Elsewhere (or with a softcap) they are first turned into
    // log2 units and masked: -1e30 for a masked key, -inf for padding.
    // -1e30 acts in log2 units as it does in natural ones: any live score
    // outweighs it entirely, and keys that are all masked weigh the same.
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && q0 + BQ - 1 - k0 >= window);
    const bool general = edge || softcap > 0.f;
    if (general) {
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = softcap > 0.f ? softcap * LOG2E * tanhf(s[4 * i + e] * scale / softcap)
                                  : s[4 * i + e] * sl2;
          if (edge) {
            const int kp = k0 + 8 * i + cq + (e & 1);
            const int qp = e < 2 ? qp0 : qp1;
            const bool keep = (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
            x = kp < Sk ? (keep ? x : NEG) : -INFINITY;
          }
          s[4 * i + e] = x;
        }
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // Rounding is monotonic, so the scaled max of raw scores is the max of
    // the scaled scores.  A tile always holds a key before Sk, so the maxima
    // are finite, and x - m is exactly 0 for a masked key in a row with no
    // live key.
    const float cs = general ? 1.f : sl2;
    const float mn0 = fmaxf(m0, mx0 * cs), mn1 = fmaxf(m1, mx1 * cs);
    const float c0 = fast_exp2(m0 - mn0), c1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P = exp(S - m) in bf16 pairs: p[4 t .. 4 t + 3] is the A fragment of
    // keys 16 t .. 16 t + 15.
    uint32_t p[BK / 4];
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const float p00 = fast_exp2(fmaf(s[4 * i], cs, -mn0));
      const float p01 = fast_exp2(fmaf(s[4 * i + 1], cs, -mn0));
      const float p10 = fast_exp2(fmaf(s[4 * i + 2], cs, -mn1));
      const float p11 = fast_exp2(fmaf(s[4 * i + 3], cs, -mn1));
      sum0 += p00 + p01;
      sum1 += p10 + p11;
      const __nv_bfloat162 r0 = __floats2bfloat162_rn(p00, p01);
      const __nv_bfloat162 r1 = __floats2bfloat162_rn(p10, p11);
      p[2 * i] = *reinterpret_cast<const uint32_t*>(&r0);
      p[2 * i + 1] = *reinterpret_cast<const uint32_t*>(&r1);
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      o[4 * i] *= c0;
      o[4 * i + 1] *= c0;
      o[4 * i + 2] *= c1;
      o[4 * i + 3] *= c1;
    }

    // O += P V: BK keys in steps of 16; V is the N-major B operand.
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      const uint32_t a[4] = {p[4 * t], p[4 * t + 1], p[4 * t + 2], p[4 * t + 3]};
      wgmma_pv<HD>(o, a, sV + st + t * 16 * 128, KV_PANEL);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(p);
  }
  cp_async_wait<0>();
  __syncthreads();

  // O / l in bf16 into this warpgroup's own q rows, then out in 16-byte rows.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if constexpr (WRITE_LSE) {
    if (lane % 4 == 0) {
      float* lse_row = lse + ((long long)b * H + h) * Sq;
      if (qp0 < Sq) lse_row[qp0] = (m0 == NEG ? NEG : m0 * LN2) + logf(l0);
      if (qp1 < Sq) lse_row[qp1] = (m1 == NEG ? NEG : m1 * LN2) + logf(l1);
    }
  }
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0), inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const __nv_bfloat162 r0 = __floats2bfloat162_rn(o[4 * i] * inv0, o[4 * i + 1] * inv0);
    const __nv_bfloat162 r1 = __floats2bfloat162_rn(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
    *reinterpret_cast<__nv_bfloat162*>(q_tile + chunk_offset<BQ>(row0, i) + 2 * cq) = r0;
    *reinterpret_cast<__nv_bfloat162*>(q_tile + chunk_offset<BQ>(row0 + 8, i) + 2 * cq) = r1;
  }
  warpgroup_barrier(1 + wg);
  constexpr int CPR = HD / 8;
#pragma unroll
  for (int e = tid % 128; e < 64 * CPR; e += 128) {
    const int r = 64 * wg + e / CPR, c = e % CPR;
    if (q0 + r < Sq)
      *reinterpret_cast<uint4*>(out + ((long long)b * Sq + q0 + r) * q_stride + h * HD + c * 8) =
          *reinterpret_cast<const uint4*>(q_tile + chunk_offset<BQ>(r, c));
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                   int Sq, int Sk, int H, int KV, float scale, int causal, int window,
                   float softcap, cudaStream_t stream) {
  // Two instantiations, so that serving's (no LSE) is the kernel without it.
  auto kernel = lse ? flash_fwd_wgmma_kernel<HD, true> : flash_fwd_wgmma_kernel<HD, false>;
  const size_t smem = Tiles<HD>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  kernel<<<grid, NT, smem, stream>>>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                     static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, Sq,
                                     Sk, H, KV, scale, causal, window, softcap);
  return cudaGetLastError();
}

}  // namespace

// q, out: [B, Sq, H, hd]; k, v: [B, Sk, KV, hd]; all contiguous, of `dtype`
// (DTypeCode: bf16 only), with 16-byte aligned base addresses; hd 64, 128
// or 256.  lse: null, or fp32 [B, H, Sq].  window <= 0 means none; softcap <=
// 0 means none.  The arguments are flash_attention_fwd's.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int flash_attention_wgmma_fwd(int dtype, const void* q, const void* k, const void* v,
                                         void* out, void* lse, int B, int Sq, int Sk, int H,
                                         int KV, int hd, float scale, int causal, int window,
                                         float softcap, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (dtype != kBFloat16 || B < 1 || Sq < 1 || Sk < 1 || H < 1 || KV < 1 || H % KV ||
      B > 65535 || (Sq + BQ - 1) / BQ > 65535 || (align & 15))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, out, static_cast<float*>(lse), B, Sq, Sk, H, KV, scale, causal,
                        window, softcap, s);
    case 128:
      return launch<128>(q, k, v, out, static_cast<float*>(lse), B, Sq, Sk, H, KV, scale, causal,
                         window, softcap, s);
    case 256:
      return launch<256>(q, k, v, out, static_cast<float*>(lse), B, Sq, Sk, H, KV, scale, causal,
                         window, softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_wgmma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
