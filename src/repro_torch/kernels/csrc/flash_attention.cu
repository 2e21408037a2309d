// Flash attention forward for Hopper (sm_90a) on the CUDA cores: the `simt`
// variant of `flash_attention`, which the wrapper (kernels/
// flash_attention.py, `variant`) routes fp32 and bf16 at head dims other
// than 64, 128 and 256 to.  bf16 at 64, 128 and 256 runs on the tensor cores
// in flash_attention_wgmma.cu.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:99
// `flash_attention` (body `_flash_kernel`): blockwise softmax(q k^T * scale) v
// with an online softmax (m, l, acc) in fp32, causal and sliding-window
// masks on absolute positions from 0 (top-left aligned when Sq != Sk),
// whole-block skipping, an optional tanh logit softcap, and GQA through kv
// head h / (H / KV).  Masked logits are -1e30 (as the TPU kernel: exp of
// -inf minus -inf would be NaN); rows that meet no live block output 0.
// The TPU kernel casts P to v's type before P.V, but v is already fp32
// there, so P.V runs in fp32 and does so here too.
//
// Bound on the H100: the larger of operations and bytes.  The causal
// B4 S512 H32 KV8 hd128 bf16 call of qwen3-4b's prefill needs 4 * hd flops
// for each live (q, k) pair, 8.6 GFLOP, 8.7 us at the 989 TFLOP/s of the
// bf16 tensor cores, and moves 42 MB of q, k, v and out, 12.5 us at
// 3.35 TB/s: bytes, by a little.  Flops grow with Sq * Sk and bytes with
// Sq + Sk, so longer prompts are bound by operations.
//
// Design (fp32 FMAs, so fp32 inputs keep IEEE products): one block
// of 256 threads for each (q tile, head, batch).  Where the TPU walked the k
// blocks as a sequential grid axis with (m, l, acc) in VMEM scratch, a block
// here loops over its k tiles itself, because Hopper's blocks run in
// parallel and carry nothing between them.  The q tile and each k/v tile are
// staged in shared memory as fp32 (rows padded by one float, so the column
// walks of q.k^T hit distinct banks); each thread computes a 4x4 (or 2x2)
// micro-tile of the scores with CUDA-core FMAs, one warp per row runs the
// online softmax with shuffles, and each thread keeps its share of the
// output accumulator (at most 32 floats) in registers.  Only the k tiles that
// the causal and window masks leave live are visited.  Unlike the TPU kernel,
// the ragged last q and k tiles are masked, so any Sq and Sk work.  A tile
// of 64 rows at hd 128 needs 116 KB of shared memory, above the 48 KB
// default, so the launcher raises the block's limit first.
//
// When `lse` is not null the launcher picks the instantiation that also
// writes each row's log-sum-exp, m + log l in natural units, fp32 [B, H,
// Sq], which the backward (flash_attention_bwd.cu) recomputes P from.
// Serving passes null and runs the instantiation without it.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;          // threads a block
constexpr float NEG = -1e30f;    // the TPU kernel's mask value

size_t smem_bytes(int bq, int bk, int hd) {
  return sizeof(float) *
         ((size_t)bq * (hd + 1) + (size_t)bk * (hd + 1) + (size_t)bk * hd + (size_t)bq * (bk + 1) +
          3 * (size_t)bq);
}

template <typename T, int BQ, int BK, int HDMAX, bool WRITE_LSE>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int H, int KV, int hd, float scale, int causal,
    int window, float softcap) {
  constexpr int RI = BQ / 16;     // q rows a thread owns
  constexpr int CJ = BK / 16;     // score columns a thread owns
  constexpr int DJ = HDMAX / 16;  // output columns a thread owns (at most)
  static_assert(RI * DJ <= 32, "accumulator exceeds 32 registers");

  extern __shared__ float smem[];
  const int ldq = hd + 1;
  float* Qs = smem;               // [BQ][hd + 1]
  float* Ks = Qs + BQ * ldq;      // [BK][hd + 1]
  float* Vs = Ks + BK * ldq;      // [BK][hd]
  float* Ps = Vs + BK * hd;       // [BQ][BK + 1]: scores, then probabilities
  float* m_s = Ps + BQ * (BK + 1);
  float* l_s = m_s + BQ;
  float* c_s = l_s + BQ;          // this tile's correction exp(m_prev - m_new)

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int dcols = hd / 16;
  const long long q_step = (long long)H * hd;   // elements between positions
  const long long kv_step = (long long)KV * hd;
  const T* qb = q + ((long long)b * Sq * H + h) * hd;
  const T* kb = k + ((long long)b * Sk * KV + kvh) * hd;
  const T* vb = v + ((long long)b * Sk * KV + kvh) * hd;
  T* ob = out + ((long long)b * Sq * H + h) * hd;

  for (int e = tid; e < BQ * hd; e += NT) {
    const int r = e / hd, d = e % hd;
    Qs[r * ldq + d] = q0 + r < Sq ? to_float(qb[(q0 + r) * q_step + d]) : 0.f;
  }
  for (int r = tid; r < BQ; r += NT) {
    m_s[r] = NEG;
    l_s[r] = 0.f;
  }
  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  __syncthreads();

  // The k tiles holding a key that some row of this q tile may see.
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int k0 = k_begin / BK * BK; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers of Ks, Vs and Ps are done
    for (int e = tid; e < BK * hd; e += NT) {
      const int r = e / hd, d = e % hd;
      const bool in = k0 + r < Sk;
      Ks[r * ldq + d] = in ? to_float(kb[(k0 + r) * kv_step + d]) : 0.f;
      Vs[r * hd + d] = in ? to_float(vb[(k0 + r) * kv_step + d]) : 0.f;
    }
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty + 16 * i) * ldq + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = Ks[(tx + 16 * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int qp = q0 + r, kp = k0 + c;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool keep = (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
        x = keep ? x : NEG;
        // Keys past Sk are padding, not masked keys: they take no weight.
        Ps[r * (BK + 1) + c] = kp < Sk ? x : -INFINITY;
      }
    }
    __syncthreads();

    for (int r = warp; r < BQ; r += NT / 32) {
      float* pr = Ps + r * (BK + 1);
      float mx = -INFINITY;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, pr[c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float p = expf(pr[c] - m_new);
        pr[c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    for (int c = 0; c < BK; ++c) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = j < dcols ? Vs[c * hd + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  if constexpr (WRITE_LSE)  // m_s and l_s are final: the last tile's barrier has passed
    for (int r = tid; r < BQ && q0 + r < Sq; r += NT)
      lse[((long long)b * H + h) * Sq + q0 + r] = m_s[r] + logf(l_s[r]);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= Sq) continue;
    const float l = l_s[r];
    const float safe = l == 0.f ? 1.f : l;
    T* orow = ob + (q0 + r) * q_step;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      if (j < dcols) orow[tx + 16 * j] = from_float<T>(acc[i][j] / safe);
  }
}

template <typename T, int BQ, int BK, int HDMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                   int Sq, int Sk, int H, int KV, int hd, float scale, int causal, int window,
                   float softcap, cudaStream_t stream) {
  // Two instantiations, so that a call without the LSE runs the kernel without it.
  auto kernel = lse ? flash_fwd_kernel<T, BQ, BK, HDMAX, true>
                    : flash_fwd_kernel<T, BQ, BK, HDMAX, false>;
  const size_t smem = smem_bytes(BQ, BK, hd);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, NT, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                     static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Sk,
                                     H, KV, hd, scale, causal, window, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                     int Sq, int Sk, int H, int KV, int hd, float scale, int causal, int window,
                     float softcap, cudaStream_t stream) {
  if (hd <= 128)
    return launch<T, 64, 64, 128>(q, k, v, out, lse, B, Sq, Sk, H, KV, hd, scale, causal,
                                  window, softcap, stream);
  return launch<T, 32, 32, 256>(q, k, v, out, lse, B, Sq, Sk, H, KV, hd, scale, causal, window,
                                softcap, stream);
}

}  // namespace

// q, out: [B, Sq, H, hd]; k, v: [B, Sk, KV, hd]; all contiguous, of `dtype`
// (DTypeCode).  lse: null, or fp32 [B, H, Sq] for each row's log-sum-exp.
// window <= 0 means none; softcap <= 0 means none.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* out, void* lse, int B, int Sq, int Sk, int H, int KV,
                                   int hd, float scale, int causal, int window, float softcap,
                                   void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || KV < 1 || H % KV || hd < 16 || hd > 256 || hd % 16 ||
      H > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch<float>(q, k, v, out, static_cast<float*>(lse), B, Sq, Sk, H, KV, hd, scale,
                             causal, window, softcap, s);
    case kBFloat16:
      return dispatch<__nv_bfloat16>(q, k, v, out, static_cast<float*>(lse), B, Sq, Sk, H, KV,
                                     hd, scale, causal, window, softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
