// Flash attention backward for Hopper (sm_90a): two variants, `mma` (bf16
// at head dim 64 or 128 without a softcap, tensor cores; routed nowhere,
// kept as a yardstick) and `simt` (fp32, and bf16 at head dims other than
// 64, 128 and 256, CUDA cores); the wrapper (kernels/flash_attention.py,
// `bwd_variant`) routes by type, head dim and alignment.
//
// The gradient of the TPU kernel repro/kernels/flash_attention.py:99
// `flash_attention` (causal, with or without a sliding window, or unmasked;
// GQA; with or without a tanh softcap).  The TPU kernel has
// no backward: the reference trains through `mha_dense`
// (repro/models/attention.py:157-182), which XLA differentiates; this is the
// counterpart of that autodiff.  Given q [B,Sq,H,hd], k, v [B,Sk,KV,hd], the
// forward's output o and its log-sum-exp lse [B,H,Sq] (m + log l, written
// by either forward kernel when asked), and dO = dL/do, with P recomputed
// as exp(q k^T * scale - lse) (0 where masked):
//
//   D_i = sum_d dO_i,d o_i,d                       (the prepass)
//   dV  = P^T dO,   dP = dO V^T,   dS = P (dP - D)
//   dQ  = dS K * scale,   dK = dS^T Q * scale
//
// with every sum in fp32 and dq, dk, dv in q's type.  With a softcap c the
// forward caps the scaled scores as c t, t = tanh(s scale / c), so `simt`
// recomputes P = exp(c t - lse) from the forward's own t and multiplies dS
// by 1 - t^2 (a runtime argument: a branch on it costs the CUDA-core
// kernels little beside their products).  Query head h reads kv
// head h / (H / KV), so dK and dV of a kv head sum over the G = H / KV query
// heads of its group.  Causal (`causal` 1), keys are visible to row i when
// i >= key (top-left aligned when Sq != Sk) and, with a window W > 0, i -
// key < W; with Sq <= Sk (the wrapper refuses a window with Sq > Sk) every
// row sees key i, so no row is empty.  The window narrows each block's
// loop: a dK/dV block's q tiles end at the last row that sees its last key
// (k0 + BK - 1 + W - 1), a dQ block's key tiles start at the tile of its
// first row's first key (q0 - W + 1).  Unmasked (`causal` 0, never with a
// window), every row sees every key, at any Sq and Sk: a dK/dV block visits
// every q tile from row 0, a dQ block every key tile, and only the ragged
// edges are masked.
//
// Bound on the H100: at qwen3-4b's training shape, B4 S512 H32 KV8 hd128
// causal, the function needs 5 products of 2 hd flops for each live (q, k)
// pair, 21.5 GFLOP (21.8 us at 989 TFLOP/s of bf16 tensor cores), and moves
// 84 MB (q, k, v, o, dO and lse in; dq, dk, dv out: 25.1 us at 3.35 TB/s):
// bytes, by a little; longer sequences are bound by operations.
//
// Both variants run three kernels: a prepass, one warp a row, writes D to
// fp32 scratch; a dK/dV kernel whose block owns a tile of keys of one (kv
// head, batch) and loops over the G query heads of its group and over the q
// tiles that can see its keys, so the GQA sum stays in registers and needs
// no atomics; a dQ kernel whose block owns a tile of q rows of one head and
// loops over the key tiles its rows can see.  S and dP are recomputed in
// both (the price of no atomics).  The ragged last q and k tiles are
// zero-filled and masked (P = 0), so any Sq and Sk work.
//
// `mma`: blocks of 4 warps.  A dK/dV block owns 64 keys (16 a warp) and
// steps over 32 q rows; a dQ block owns 64 rows (16 a warp) and steps over
// 32 keys.  Tiles are staged as bf16 by cp.async in rows of hd + 8 values
// (an odd number of 16-byte units, so ldmatrix reads hit distinct banks);
// the products are mma.sync m16n8k16 with fp32 sums, operands by ldmatrix
// (.trans where a B operand lies [k][n]); P^T and dS^T (dK/dV) and dS (dQ)
// go from the accumulators to A fragments in registers, rounded to bf16,
// as the forward's wgmma kernel rounds P.  Each warp keeps its 16 x hd of
// dK and dV (or dQ) in registers.  Shared memory at hd 128: 52 KB.  Not yet
// done (the next steps for speed): cp.async double buffering of the q / key
// steps, and wgmma.
//
// `simt` (the first design; fp32 keeps IEEE products): blocks of 256
// threads, tiles of 64 rows and 64 keys staged as fp32 up to head dim 128
// and of 32 above (the forward's `simt` tiles), each thread a 4 x 4 (2 x 2)
// micro-tile of S and dP with CUDA-core FMAs, P and dS through shared
// memory, dK/dV or dQ accumulated in registers.  Rows are padded by one
// float so that the column walks hit distinct banks.  Shared memory at hd
// 128: 166 KB (dK/dV), 149 KB (dQ); at hd 256 with 32-row tiles 140 KB and
// 136 KB.  Each launcher raises its kernels' shared-memory limit above the
// 48 KB default.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads a block
// `simt` tiles: BT q rows by BT keys, 64 up to head dim 128 and 32 above
// (as the forward's `simt` kernel), each thread a BT / 16 x BT / 16
// micro-tile of S and dP.

template <typename T>
__global__ void __launch_bounds__(NT) flash_bwd_dot_kernel(const T* __restrict__ o,
                                                           const T* __restrict__ dout,
                                                           float* __restrict__ delta, int Sq,
                                                           int H, int hd, long long rows) {
  // Row r = (b * Sq + i) * H + h of o and dO, [B, Sq, H, hd]; one warp a row.
  const long long r = (long long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;  // uniform within the warp
  float s = 0.f;
  for (int d = lane; d < hd; d += 32) s = fmaf(to_float(dout[r * hd + d]), to_float(o[r * hd + d]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = (int)(r % H);
    const long long bi = r / H;
    delta[(bi / Sq * H + h) * Sq + bi % Sq] = s;
  }
}

// Rows [0, n) of a tile of hd columns from g (row stride `step` elements)
// into shared memory as fp32 with row stride ld; rows from `valid` on are 0.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* g, long long step, int n, int valid,
                                      int hd, int ld) {
  for (int e = threadIdx.x; e < n * hd; e += NT) {
    const int r = e / hd, d = e % hd;
    dst[r * ld + d] = r < valid ? to_float(g[r * step + d]) : 0.f;
  }
}

// This thread's RI x CJ micro-tiles of S = A B^T and dP = C E^T over hd,
// rows ty + 16 i of A and C, rows tx + 16 j of B and E (all with row stride
// ld).
template <int RI, int CJ>
__device__ __forceinline__ void two_products(const float* A, const float* Bm, const float* C,
                                             const float* E, int hd, int ld, int tx, int ty,
                                             float (&s)[RI][CJ], float (&dp)[RI][CJ]) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < hd; ++d) {
    float a[RI], c[RI], b[CJ], e[CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      a[i] = A[(ty + 16 * i) * ld + d];
      c[i] = C[(ty + 16 * i) * ld + d];
    }
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      b[j] = Bm[(tx + 16 * j) * ld + d];
      e[j] = E[(tx + 16 * j) * ld + d];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        dp[i][j] = fmaf(c[i], e[j], dp[i][j]);
      }
  }
}

size_t dkdv_smem(int hd, int bt) {
  return sizeof(float) * (4 * (size_t)bt * (hd + 1) + 2 * (size_t)bt * (bt + 1) + 2 * bt);
}

// P = exp(s scale - lse) of a live pair (0 masked) and, with a softcap c,
// P = exp(c t - lse), t = tanh(s scale / c) as the forward computes it, with
// `slope` = 1 - t^2 (else 1): dS = P (dP - D) slope.
__device__ __forceinline__ float recompute_p(float s, float scale, float softcap, float lse,
                                             bool live, float& slope) {
  slope = 1.f;
  if (!live) return 0.f;
  if (softcap > 0.f) {
    const float th = tanhf(s * scale / softcap);
    slope = fmaf(-th, th, 1.f);
    return expf(__fmul_rn(softcap, th) - lse);
  }
  return expf(s * scale - lse);
}

template <typename T, int HDMAX, int BT>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H, int KV, int hd, int causal,
    int window, float scale, float softcap) {
  constexpr int BQ = BT, BK = BT, RI = BQ / 16, CJ = BK / 16;
  constexpr int DJ = HDMAX / 16;  // head-dim columns a thread owns
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* Ks = smem;                // [BK][ld]
  float* Vs = Ks + BK * ld;        // [BK][ld]
  float* Qs = Vs + BK * ld;        // [BQ][ld]
  float* dOs = Qs + BQ * ld;       // [BQ][ld]
  float* Ps = dOs + BQ * ld;       // [BQ][BK + 1]
  float* dSs = Ps + BQ * (BK + 1);  // [BQ][BK + 1]
  float* lse_s = dSs + BQ * (BK + 1);
  float* dl_s = lse_s + BQ;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV, dcols = hd / 16;
  const long long q_step = (long long)H * hd, kv_step = (long long)KV * hd;
  const long long kv_off = ((long long)b * Sk * KV + kvh) * hd + k0 * kv_step;
  stage(Ks, k + kv_off, kv_step, BK, Sk - k0, hd, ld);
  stage(Vs, v + kv_off, kv_step, BK, Sk - k0, hd, ld);

  float dk_acc[CJ][DJ], dv_acc[CJ][DJ];  // keys ty + 16 i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < CJ; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // Causal: rows q >= k0 see the tile; a window, up to k0 + BK - 1 + window
  // - 1.  Unmasked: every row.
  const int q_begin = causal ? k0 / BQ * BQ : 0;
  const int q_end = window > 0 ? min(Sq, k0 + BK - 1 + window) : Sq;
  for (int h = kvh * G; h < (kvh + 1) * G; ++h) {
    const long long q_off = ((long long)b * Sq * H + h) * hd;
    const float* lse_h = lse + ((long long)b * H + h) * Sq;
    const float* dl_h = delta + ((long long)b * H + h) * Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
      __syncthreads();  // the previous tile's readers of Qs, dOs, Ps and dSs are done
      stage(Qs, q + q_off + q0 * q_step, q_step, BQ, Sq - q0, hd, ld);
      stage(dOs, dout + q_off + q0 * q_step, q_step, BQ, Sq - q0, hd, ld);
      for (int r = tid; r < BQ; r += NT) {
        lse_s[r] = q0 + r < Sq ? lse_h[q0 + r] : 0.f;
        dl_s[r] = q0 + r < Sq ? dl_h[q0 + r] : 0.f;
      }
      __syncthreads();

      float s[RI][CJ], dp[RI][CJ];
      two_products(Qs, Ks, dOs, Vs, hd, ld, tx, ty, s, dp);
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          const int qp = q0 + r, kp = k0 + c;
          const bool live = qp < Sq && kp < Sk && (!causal || qp >= kp) &&
                            (window <= 0 || qp - kp < window);
          float slope;
          const float p = recompute_p(s[i][j], scale, softcap, lse_s[r], live, slope);
          Ps[r * (BK + 1) + c] = p;
          dSs[r * (BK + 1) + c] = p * (dp[i][j] - dl_s[r]) * slope;
        }
      __syncthreads();

      for (int r = 0; r < BQ; ++r) {
        float pv[CJ], sv[CJ], ov[DJ], qv[DJ];
#pragma unroll
        for (int i = 0; i < CJ; ++i) {
          pv[i] = Ps[r * (BK + 1) + ty + 16 * i];
          sv[i] = dSs[r * (BK + 1) + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          ov[j] = j < dcols ? dOs[r * ld + tx + 16 * j] : 0.f;
          qv[j] = j < dcols ? Qs[r * ld + tx + 16 * j] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < CJ; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            dv_acc[i][j] = fmaf(pv[i], ov[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(sv[i], qv[j], dk_acc[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < CJ; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= Sk) continue;
    const long long row = ((long long)b * Sk + kp) * kv_step + (long long)kvh * hd;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      if (j < dcols) {
        dk[row + tx + 16 * j] = from_float<T>(dk_acc[i][j] * scale);
        dv[row + tx + 16 * j] = from_float<T>(dv_acc[i][j]);
      }
  }
}

size_t dq_smem(int hd, int bt) {
  return sizeof(float) * (4 * (size_t)bt * (hd + 1) + (size_t)bt * (bt + 1) + 2 * bt);
}

template <typename T, int HDMAX, int BT>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int Sq, int Sk, int H, int KV, int hd, int causal, int window,
    float scale, float softcap) {
  constexpr int BQ = BT, BK = BT, RI = BQ / 16, CJ = BK / 16;
  constexpr int DJ = HDMAX / 16;
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* Qs = smem;                 // [BQ][ld]
  float* dOs = Qs + BQ * ld;        // [BQ][ld]
  float* Ks = dOs + BQ * ld;        // [BK][ld]
  float* Vs = Ks + BK * ld;         // [BK][ld]
  float* dSs = Vs + BK * ld;        // [BQ][BK + 1]
  float* lse_s = dSs + BQ * (BK + 1);
  float* dl_s = lse_s + BQ;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV), dcols = hd / 16;
  const long long q_step = (long long)H * hd, kv_step = (long long)KV * hd;
  const long long q_off = ((long long)b * Sq * H + h) * hd + q0 * q_step;
  const long long kv_off = ((long long)b * Sk * KV + kvh) * hd;
  stage(Qs, q + q_off, q_step, BQ, Sq - q0, hd, ld);
  stage(dOs, dout + q_off, q_step, BQ, Sq - q0, hd, ld);
  const float* lse_h = lse + ((long long)b * H + h) * Sq;
  const float* dl_h = delta + ((long long)b * H + h) * Sq;
  for (int r = tid; r < BQ; r += NT) {
    lse_s[r] = q0 + r < Sq ? lse_h[q0 + r] : 0.f;
    dl_s[r] = q0 + r < Sq ? dl_h[q0 + r] : 0.f;
  }

  float acc[RI][DJ];  // rows ty + 16 i, columns tx + 16 j
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // Causal: keys up to the tile's last row; unmasked: every key.
  const int k_end = causal ? min(Sk, min(q0 + BQ, Sq)) : Sk;
  // A window: keys from the tile of the first row's first key, q0 - window + 1.
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers of Ks, Vs and dSs are done
    stage(Ks, k + kv_off + k0 * kv_step, kv_step, BK, Sk - k0, hd, ld);
    stage(Vs, v + kv_off + k0 * kv_step, kv_step, BK, Sk - k0, hd, ld);
    __syncthreads();

    float s[RI][CJ], dp[RI][CJ];
    two_products(Qs, Ks, dOs, Vs, hd, ld, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int qp = q0 + r, kp = k0 + c;
        const bool live = qp < Sq && kp < Sk && (!causal || qp >= kp) &&
                          (window <= 0 || qp - kp < window);
        float slope;
        const float p = recompute_p(s[i][j], scale, softcap, lse_s[r], live, slope);
        dSs[r * (BK + 1) + c] = p * (dp[i][j] - dl_s[r]) * slope;
      }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float sv[RI], kv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) sv[i] = dSs[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = j < dcols ? Ks[c * ld + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= Sq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      if (j < dcols) dq[q_off + r * q_step + tx + 16 * j] = from_float<T>(acc[i][j] * scale);
  }
}

template <typename T, int HDMAX, int BT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int Sq,
                   int Sk, int H, int KV, int hd, int causal, int window, float scale,
                   float softcap, cudaStream_t stream) {
  const long long rows = (long long)B * Sq * H;
  flash_bwd_dot_kernel<T><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<float*>(delta), Sq, H,
      hd, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkdv = flash_bwd_dkdv_kernel<T, HDMAX, BT>;
  const size_t s1 = dkdv_smem(hd, BT);
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((Sk + BT - 1) / BT, KV, B), NT, s1, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, KV,
      hd, causal, window, scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_kernel<T, HDMAX, BT>;
  const size_t s2 = dq_smem(hd, BT);
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (err != cudaSuccess) return err;
  dqk<<<dim3((Sq + BT - 1) / BT, H, B), NT, s2, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), Sq, Sk, H, KV, hd, causal, window,
      scale, softcap);
  return cudaGetLastError();
}

// Tiles of 64 up to head dim 128; above, 32, whose fp32 K, V, Q and dO
// rows of 257 floats and P and dS of 32 x 33 take 140 KB (64-row tiles
// would take about 296 KB).
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const void* lse, void* delta, void* dq, void* dk, void* dv,
                     int B, int Sq, int Sk, int H, int KV, int hd, int causal, int window,
                     float scale, float softcap, cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 64, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KV, hd,
                             causal, window, scale, softcap, stream);
  if (hd <= 128)
    return launch<T, 128, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KV, hd,
                              causal, window, scale, softcap, stream);
  return launch<T, 256, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KV, hd,
                            causal, window, scale, softcap, stream);
}

// ------------------------------------------------------------------- mma
// The `mma` variant: bf16 at head dim 64 or 128, the products on the tensor
// cores (mma.sync m16n8k16, bf16 in, fp32 sums), operands from shared
// memory by ldmatrix.  P and dS are rounded to bf16 where they enter a
// product (P for dV, dS for dK and dQ), as the forward's wgmma kernel rounds
// P before P.V; every sum stays fp32.

using bf16 = __nv_bfloat16;
constexpr int MT = 128;  // threads a block: 4 warps
constexpr int KB = 64;   // keys a dK/dV block, 16 a warp
constexpr int QT = 32;   // q rows a step of the dK/dV block
constexpr int QB = 64;   // q rows a dQ block, 16 a warp
constexpr int KT = 32;   // keys a step of the dQ block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronously; `bytes` 0 fills zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and r[i] gets its elements (lane / 4, 2 (lane % 4) and + 1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
// The same, transposed: r[i] gets elements (2 (lane % 4) and + 1, lane / 4).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
// d += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 fp32.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Two fp32 values to a bf16 pair, round to nearest even; `lo` in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [0, n) of a bf16 tile of HD columns from g (row stride `step`) into
// shared memory with row stride LD, by cp.async; rows from `valid` on are 0.
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* g, long long step, int n,
                                          int valid) {
  constexpr int CPR = HD / 8, LD = HD + 8;  // 16-byte chunks a row
  for (int e = threadIdx.x; e < n * CPR; e += MT) {
    const int r = e / CPR, c = e % CPR;
    const bool in = r < valid;
    cp_async16(smem_u32(dst + r * LD + c * 8), in ? g + r * step + c * 8 : g, in ? 16 : 0);
  }
}

// Shared-memory rows are HD + 8 bf16 long: 16-byte aligned, and an odd
// number of 16-byte units, so the 8 rows an ldmatrix reads fall in distinct
// banks.  Lane addressing of one x4 ldmatrix over a 16 x 16 block at (r, c):
// the A operand (and a B operand stored [k][n], transposed) takes row
// r + lane % 8 + (lane / 8 % 2) 8, column c + lane / 16 * 8; a B operand
// stored [n][k] takes row r + lane % 8 + lane / 16 * 8, column c + (lane / 8
// % 2) 8, and gives b0, b1 of n-tile r..r+7, then b0, b1 of r+8..r+15.
size_t mma_smem(int hd) { return (size_t)(2 * KB + 2 * QT) * (hd + 8) * 2 + 2 * QT * 4; }

template <int HD>
__global__ void __launch_bounds__(MT) flash_bwd_dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq,
    int Sk, int H, int KV, int causal, int window, float scale) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) uint8_t smem_mma[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_mma);  // [KB][LD]
  bf16* Vs = Ks + KB * LD;                       // [KB][LD]
  bf16* Qs = Vs + KB * LD;                       // [QT][LD]
  bf16* Os = Qs + QT * LD;                       // [QT][LD]: dO
  float* lse_s = reinterpret_cast<float*>(Os + QT * LD);
  float* dl_s = lse_s + QT;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * KB, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const long long q_step = (long long)H * HD, kv_step = (long long)KV * HD;
  const long long kv_off = ((long long)b * Sk * KV + kvh) * HD + (long long)k0 * kv_step;
  load_rows<HD>(Ks, k + kv_off, kv_step, KB, Sk - k0);
  load_rows<HD>(Vs, v + kv_off, kv_step, KB, Sk - k0);
  cp_async_commit();

  const int ra = lane % 8 + (lane / 8 % 2) * 8, ca = lane / 16 * 8;  // A, and B stored [k][n]
  const int rb = lane % 8 + lane / 16 * 8, cb = (lane / 8 % 2) * 8;  // B stored [n][k]
  const int kw = 16 * warp;                                         // this warp's keys
  const int kp0 = k0 + kw + g, kp1 = kp0 + 8;

  float dk_acc[HD / 8][4], dv_acc[HD / 8][4];  // keys kw + g (+ 8), columns 8 j + 2 t (+ 1)
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  // Causal: rows q >= k0 see the tile; a window, up to k0 + KB - 1 + window
  // - 1.  Unmasked: every row.
  const int q_begin = causal ? k0 / QT * QT : 0;
  const int q_end = window > 0 ? min(Sq, k0 + KB - 1 + window) : Sq;
  for (int h = kvh * G; h < (kvh + 1) * G; ++h) {
    const long long q_off = ((long long)b * Sq * H + h) * HD;
    const float* lse_h = lse + ((long long)b * H + h) * Sq;
    const float* dl_h = delta + ((long long)b * H + h) * Sq;
    for (int q0 = q_begin; q0 < q_end; q0 += QT) {
      __syncthreads();  // the previous step's readers of Qs, Os, lse_s and dl_s are done
      load_rows<HD>(Qs, q + q_off + (long long)q0 * q_step, q_step, QT, Sq - q0);
      load_rows<HD>(Os, dout + q_off + (long long)q0 * q_step, q_step, QT, Sq - q0);
      cp_async_commit();
      for (int r = tid; r < QT; r += MT) {
        lse_s[r] = q0 + r < Sq ? lse_h[q0 + r] : 0.f;
        dl_s[r] = q0 + r < Sq ? dl_h[q0 + r] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x QT rows.
      float st[QT / 8][4], dpt[QT / 8][4];
#pragma unroll
      for (int j = 0; j < QT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t ka[4], va[4];
        ldsm_x4(ka, Ks + (kw + ra) * LD + 16 * kk + ca);
        ldsm_x4(va, Vs + (kw + ra) * LD + 16 * kk + ca);
#pragma unroll
        for (int nb = 0; nb < QT / 16; ++nb) {
          uint32_t qb[4], ob[4];
          ldsm_x4(qb, Qs + (16 * nb + rb) * LD + 16 * kk + cb);
          ldsm_x4(ob, Os + (16 * nb + rb) * LD + 16 * kk + cb);
          mma(st[2 * nb], ka, qb[0], qb[1]);
          mma(st[2 * nb + 1], ka, qb[2], qb[3]);
          mma(dpt[2 * nb], va, ob[0], ob[1]);
          mma(dpt[2 * nb + 1], va, ob[2], ob[3]);
        }
      }

      // P^T and dS^T, as A fragments over k = the tile's q rows: n-tile j
      // of the accumulator is half j % 2 of k-step j / 2.
      uint32_t pa[QT / 16][4], sa[QT / 16][4];
#pragma unroll
      for (int j = 0; j < QT / 8; ++j) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * j + 2 * t + (e & 1);
          const int qp = q0 + r, kp = e < 2 ? kp0 : kp1;
          const bool live = qp < Sq && kp < Sk && (!causal || qp >= kp) &&
                            (window <= 0 || qp - kp < window);
          p[e] = live ? expf(st[j][e] * scale - lse_s[r]) : 0.f;
          ds[e] = p[e] * (dpt[j][e] - dl_s[r]);
        }
        const int half = (j % 2) * 2;
        pa[j / 2][half] = pack(p[0], p[1]);
        pa[j / 2][half + 1] = pack(p[2], p[3]);
        sa[j / 2][half] = pack(ds[0], ds[1]);
        sa[j / 2][half + 1] = pack(ds[2], ds[3]);
      }

      // dV += P^T dO and dK += dS^T Q, dO and Q stored [row][d] (B by .trans).
#pragma unroll
      for (int ks = 0; ks < QT / 16; ++ks) {
#pragma unroll
        for (int nb = 0; nb < HD / 16; ++nb) {
          uint32_t ob[4], qb[4];
          ldsm_x4_t(ob, Os + (16 * ks + ra) * LD + 16 * nb + ca);
          ldsm_x4_t(qb, Qs + (16 * ks + ra) * LD + 16 * nb + ca);
          mma(dv_acc[2 * nb], pa[ks], ob[0], ob[1]);
          mma(dv_acc[2 * nb + 1], pa[ks], ob[2], ob[3]);
          mma(dk_acc[2 * nb], sa[ks], qb[0], qb[1]);
          mma(dk_acc[2 * nb + 1], sa[ks], qb[2], qb[3]);
        }
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kp = half ? kp1 : kp0;
    if (kp >= Sk) continue;
    const long long row = ((long long)b * Sk + kp) * kv_step + (long long)kvh * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(dk + row + col) =
          pack(dk_acc[j][2 * half] * scale, dk_acc[j][2 * half + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + row + col) =
          pack(dv_acc[j][2 * half], dv_acc[j][2 * half + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(MT) flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Sk, int H, int KV,
    int causal, int window, float scale) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) uint8_t smem_mma[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_mma);  // [QB][LD]
  bf16* Os = Qs + QB * LD;                       // [QB][LD]: dO
  bf16* Ks = Os + QB * LD;                       // [KT][LD]
  bf16* Vs = Ks + KT * LD;                       // [KT][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * QB, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long q_step = (long long)H * HD, kv_step = (long long)KV * HD;
  const long long q_off = ((long long)b * Sq * H + h) * HD + (long long)q0 * q_step;
  const long long kv_off = ((long long)b * Sk * KV + kvh) * HD;
  load_rows<HD>(Qs, q + q_off, q_step, QB, Sq - q0);
  load_rows<HD>(Os, dout + q_off, q_step, QB, Sq - q0);
  cp_async_commit();

  const int ra = lane % 8 + (lane / 8 % 2) * 8, ca = lane / 16 * 8;
  const int rb = lane % 8 + lane / 16 * 8, cb = (lane / 8 % 2) * 8;
  const int qw = 16 * warp;  // this warp's rows
  const int qp0 = q0 + qw + g, qp1 = qp0 + 8;
  const float* lse_h = lse + ((long long)b * H + h) * Sq;
  const float* dl_h = delta + ((long long)b * H + h) * Sq;
  const float lse0 = qp0 < Sq ? lse_h[qp0] : 0.f, lse1 = qp1 < Sq ? lse_h[qp1] : 0.f;
  const float dl0 = qp0 < Sq ? dl_h[qp0] : 0.f, dl1 = qp1 < Sq ? dl_h[qp1] : 0.f;

  float acc[HD / 8][4];  // rows qw + g (+ 8), columns 8 j + 2 t (+ 1)
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // Causal: keys up to the block's last row; unmasked: every key.
  const int k_end = causal ? min(Sk, min(q0 + QB, Sq)) : Sk;
  // A window: keys from the step of the first row's first key, q0 - window + 1.
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / KT * KT : 0;
  for (int k0 = k_begin; k0 < k_end; k0 += KT) {
    __syncthreads();  // the previous step's readers of Ks and Vs are done
    load_rows<HD>(Ks, k + kv_off + (long long)k0 * kv_step, kv_step, KT, Sk - k0);
    load_rows<HD>(Vs, v + kv_off + (long long)k0 * kv_step, kv_step, KT, Sk - k0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 rows x KT keys.
    float s[KT / 8][4], dp[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4], oa[4];
      ldsm_x4(qa, Qs + (qw + ra) * LD + 16 * kk + ca);
      ldsm_x4(oa, Os + (qw + ra) * LD + 16 * kk + ca);
#pragma unroll
      for (int nb = 0; nb < KT / 16; ++nb) {
        uint32_t kb[4], vb[4];
        ldsm_x4(kb, Ks + (16 * nb + rb) * LD + 16 * kk + cb);
        ldsm_x4(vb, Vs + (16 * nb + rb) * LD + 16 * kk + cb);
        mma(s[2 * nb], qa, kb[0], kb[1]);
        mma(s[2 * nb + 1], qa, kb[2], kb[3]);
        mma(dp[2 * nb], oa, vb[0], vb[1]);
        mma(dp[2 * nb + 1], oa, vb[2], vb[3]);
      }
    }

    uint32_t sa[KT / 16][4];  // dS as A fragments over k = the step's keys
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = e < 2 ? qp0 : qp1, kp = k0 + 8 * j + 2 * t + (e & 1);
        const bool live = qp < Sq && kp < Sk && (!causal || qp >= kp) &&
                          (window <= 0 || qp - kp < window);
        const float p = live ? expf(s[j][e] * scale - (e < 2 ? lse0 : lse1)) : 0.f;
        ds[e] = p * (dp[j][e] - (e < 2 ? dl0 : dl1));
      }
      const int half = (j % 2) * 2;
      sa[j / 2][half] = pack(ds[0], ds[1]);
      sa[j / 2][half + 1] = pack(ds[2], ds[3]);
    }

    // dQ += dS K, K stored [key][d] (B by .trans).
#pragma unroll
    for (int ks = 0; ks < KT / 16; ++ks) {
#pragma unroll
      for (int nb = 0; nb < HD / 16; ++nb) {
        uint32_t kb[4];
        ldsm_x4_t(kb, Ks + (16 * ks + ra) * LD + 16 * nb + ca);
        mma(acc[2 * nb], sa[ks], kb[0], kb[1]);
        mma(acc[2 * nb + 1], sa[ks], kb[2], kb[3]);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qp = half ? qp1 : qp0;
    if (qp >= Sq) continue;
    bf16* row = dq + ((long long)b * Sq + qp) * q_step + (long long)h * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * t) =
          pack(acc[j][2 * half] * scale, acc[j][2 * half + 1] * scale);
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const void* lse, void* delta, void* dq, void* dk,
                       void* dv, int B, int Sq, int Sk, int H, int KV, int causal, int window,
                       float scale, cudaStream_t stream) {
  const long long rows = (long long)B * Sq * H;
  flash_bwd_dot_kernel<bf16><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<float*>(delta),
      Sq, H, HD, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = mma_smem(HD);
  auto dkdv = flash_bwd_dkdv_mma_kernel<HD>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((Sk + KB - 1) / KB, KV, B), MT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Sk,
      H, KV, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto dqk = flash_bwd_dq_mma_kernel<HD>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dqk<<<dim3((Sq + QB - 1) / QB, H, B), MT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), Sq, Sk, H, KV, causal, window,
      scale);
  return cudaGetLastError();
}

}  // namespace

// The `mma` variant of flash_attention_bwd: the same arguments, bf16 only,
// hd 64 or 128, no softcap (0), every tensor pointer 16-byte aligned.
extern "C" int flash_attention_bwd_mma(int dtype, const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const void* lse,
                                       void* delta, void* dq, void* dk, void* dv, int B, int Sq,
                                       int Sk, int H, int KV, int hd, int causal, int window,
                                       float scale, float softcap, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
                          reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(dq) |
                          reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv);
  if (dtype != kBFloat16 || B < 1 || Sq < 1 || Sk < 1 || H < 1 || KV < 1 || H % KV ||
      H > 65535 || B > 65535 || KV > 65535 || window < 0 || (!causal && window > 0) ||
      softcap != 0.f || (align & 15))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch_mma<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KV, causal,
                            window, scale, s);
    case 128:
      return launch_mma<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KV, causal,
                             window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Attention's gradient (the `simt` variant).  q, o, dout, dq: [B, Sq, H,
// hd]; k, v, dk, dv: [B, Sk, KV, hd]; all contiguous, of `dtype`
// (DTypeCode).  lse: [B, H, Sq] fp32 from the forward; delta: [B, H, Sq]
// fp32 scratch.  hd a multiple of 16 up to 256; causal 1 (top-left aligned)
// or 0 (unmasked); window the sliding window's width, 0 for none (causal
// only); softcap the tanh cap of the scaled scores, 0 for none.  Returns
// the cudaError_t of the launches (0 on success).
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                   const void* o, const void* dout, const void* lse, void* delta,
                                   void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
                                   int KV, int hd, int causal, int window, float scale,
                                   float softcap, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || KV < 1 || H % KV || hd < 16 || hd > 256 || hd % 16 ||
      H > 65535 || B > 65535 || KV > 65535 || window < 0 || (!causal && window > 0) ||
      !(softcap >= 0.f))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KV, hd,
                             causal, window, scale, softcap, s);
    case kBFloat16:
      return dispatch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KV,
                                     hd, causal, window, scale, softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
