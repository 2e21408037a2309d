// Mamba-2 SSD chunked scan for Hopper (sm_90a) on the CUDA cores.  The
// `simt` variant of `ssd_scan`: fp32, whose 1e-4 parity needs IEEE fp32
// products, and bf16 whose P or N is not a multiple of 8; the wrapper
// (kernels/ssd_scan.py, `variant`) routes the rest of bf16 to the tensor-core
// kernel of ssd_scan_tc.cu (`tc`).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:65 `ssd_scan` (body
// `_ssd_kernel`).  For each (batch, head) pair, with group g = h / (H / G):
//
//   state_t = state_{t-1} * exp(dt_t A_h) + dt_t x_t B_t^T      [P, N]
//   y_t     = C_t . state_t                                      [P]
//
// evaluated by chunks of L steps, all in fp32, y written in x's type:
//
//   cum   = cumsum(dt A)                                         [L]
//   y     = (C B^T o tril exp(cum_i - cum_j)) (x dt)             intra-chunk
//         + exp(cum) o (C state^T)                               inter-chunk
//   state = state exp(cum_last) + (x dt)^T (B o exp(cum_last - cum))
//
// Unlike the TPU kernel, this one also writes the final state, [B, H, P, N]
// fp32: the decode cache starts from it.
//
// Bound on the H100: bytes, at the serve shape.  The function reads x, dt,
// B and C once and writes y and the final state once: at B4 S2048 H32 P64
// G1 N128 bf16 that is 76.0 MB, 22.7 us at 3.35 TB/s.  Its operations with
// 64-step chunks, about 2 * B * H * S * ((L + 1) (N + P) / 2 + 2 P N) flops
// (the lower triangle of the two chunk-square products, and the two P x N
// products a step), are 11.9 GFLOP, 12.0 us at the bf16 tensor-core rate.
//
// Design (the first, simple version, kept for fp32).  The TPU
// walked the chunks as a sequential grid axis with the state in VMEM
// scratch; here one block of 256 threads for each (batch, head) walks the
// chunks in a loop and keeps the running [P, N] state in shared memory.
// The chunk is the kernel's own, L = 64: chunking does not change the
// function, and at the config's 256 steps C B^T alone (256 KB in fp32)
// would not fit in a block's 227 KB.  At L = 64, P = 64, N = 128 the state,
// B, C, x dt and the masked C B^T take 133 KB.  Each chunk:
//   1. load: x dt, B and C as fp32 tiles, read through the caller's batch
//      and sequence strides (x, B and C may be views into the model's conv
//      output); steps past S load as 0 (dt = 0 is an exact no-op), so any
//      S works.  Warp 0 scans dt A into cum with shuffles.
//   2. C B^T, masked with a select before the exp (the upper-triangle
//      differences are positive and overflow; inf * 0 would be NaN).
//   3. y from the old state, written in x's type.
//   4. the state update, each thread on its own entries.
// Every product is a 16 x 16 grid of threads, each with a register tile of
// CUDA-core FMAs, PB x 16 columns of P and NB x 16 of N wide at most (PB and
// NB are 4 up to 64 and 8 up to 128, so mamba2's P 64 and N 128 waste no
// FMA on padding); rows of the tiles that are read across lanes are padded
// by one float so that the lanes hit distinct banks.

#include "common.cuh"

namespace {

constexpr int NT = 256;          // threads a block: a 16 x 16 grid
constexpr int L = 64;            // steps a chunk
constexpr int MAXD = 128;        // largest P and N
constexpr int RL = L / 16;       // chunk rows (or columns) a thread owns

size_t smem_bytes(int P, int N) {
  const size_t ldn = N + 1;
  return sizeof(float) * ((size_t)P * ldn      // state [P][N+1]
                          + 2 * (size_t)L * ldn // B, C [L][N+1]
                          + (size_t)L * P       // x dt [L][P]
                          + (size_t)L * (L + 1) // masked, decayed C B^T [L][L+1]
                          + 2 * (size_t)L);     // cum, exp(cum_last - cum)
}

// PB, NB: P and N columns a thread owns, each 16 apart.
template <typename T, int PB, int NB>
__global__ void __launch_bounds__(NT) ssd_scan_kernel(
    const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, T* __restrict__ y,
    float* __restrict__ state_out, int S, int H, int G, int P, int N, long long xsb,
    long long xss, long long dsb, long long dss, long long bsb, long long bss, long long csb,
    long long css) {
  extern __shared__ float smem[];
  const int ldn = N + 1;
  float* st = smem;              // [P][N+1] running state
  float* Bs = st + P * ldn;      // [L][N+1]
  float* Cs = Bs + L * ldn;      // [L][N+1]
  float* Xs = Cs + L * ldn;      // [L][P]: x * dt
  float* Ls = Xs + L * P;        // [L][L+1]: C B^T o tril exp(cum_i - cum_j)
  float* cum = Ls + L * (L + 1); // [L]
  float* decay = cum + L;        // [L]: exp(cum_last - cum)

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int g = h / (H / G);
  const float a = to_float(A[h]);
  const T* xb = x + b * xsb + (long long)h * P;
  const T* db = dt + b * dsb + h;
  const T* Bb = Bm + b * bsb + (long long)g * N;
  const T* Cb = Cm + b * csb + (long long)g * N;
  T* yb = y + ((long long)b * S * H + h) * P;  // y is contiguous [B, S, H, P]
  const long long ys = (long long)H * P;

  for (int e = tid; e < P * ldn; e += NT) st[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += L) {
    __syncthreads();  // the previous chunk's readers of every tile are done
    for (int e = tid; e < L * P; e += NT) {
      const int t = e / P, p = e % P;
      Xs[e] = c0 + t < S ? to_float(xb[(c0 + t) * xss + p]) * to_float(db[(c0 + t) * dss]) : 0.f;
    }
    for (int e = tid; e < L * N; e += NT) {
      const int t = e / N, n = e % N;
      const bool in = c0 + t < S;
      Bs[t * ldn + n] = in ? to_float(Bb[(c0 + t) * bss + n]) : 0.f;
      Cs[t * ldn + n] = in ? to_float(Cb[(c0 + t) * css + n]) : 0.f;
    }
    if (tid < 32) {  // scan of dt * A: lane l holds steps 2l and 2l + 1
      const int t0 = 2 * tid, t1 = t0 + 1;
      const float v0 = c0 + t0 < S ? to_float(db[(c0 + t0) * dss]) * a : 0.f;
      const float v1 = c0 + t1 < S ? to_float(db[(c0 + t1) * dss]) * a : 0.f;
      float run = v0 + v1;  // becomes the inclusive prefix of the lanes' pair sums
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, run, off);
        if (tid >= off) run += o;
      }
      float before = __shfl_up_sync(0xffffffffu, run, 1);
      if (tid == 0) before = 0.f;
      const float c_0 = before + v0, c_1 = c_0 + v1;
      const float last = __shfl_sync(0xffffffffu, c_1, 31);
      cum[t0] = c_0;
      cum[t1] = c_1;
      decay[t0] = expf(last - c_0);
      decay[t1] = expf(last - c_1);
    }
    __syncthreads();

    // C B^T on the lower triangle, times exp(cum_i - cum_j).
    {
      float acc[RL][RL];
#pragma unroll
      for (int i = 0; i < RL; ++i)
#pragma unroll
        for (int j = 0; j < RL; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[RL], bv[RL];
#pragma unroll
        for (int i = 0; i < RL; ++i) cv[i] = Cs[(ty + 16 * i) * ldn + n];
#pragma unroll
        for (int j = 0; j < RL; ++j) bv[j] = Bs[(tx + 16 * j) * ldn + n];
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int j = 0; j < RL; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RL; ++i) {
#pragma unroll
        for (int j = 0; j < RL; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          // Select before the exp: above the diagonal cum_r - cum_c > 0.
          Ls[r * (L + 1) + c] = c <= r ? acc[i][j] * expf(cum[r] - cum[c]) : 0.f;
        }
      }
    }
    __syncthreads();

    // y = exp(cum) o (C state^T) + Ls (x dt), rows ty + 16 i, columns p = tx + 16 j.
    {
      float acc[RL][PB];
#pragma unroll
      for (int i = 0; i < RL; ++i)
#pragma unroll
        for (int j = 0; j < PB; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[RL], sv[PB];
#pragma unroll
        for (int i = 0; i < RL; ++i) cv[i] = Cs[(ty + 16 * i) * ldn + n];
#pragma unroll
        for (int j = 0; j < PB; ++j) sv[j] = tx + 16 * j < P ? st[(tx + 16 * j) * ldn + n] : 0.f;
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int j = 0; j < PB; ++j) acc[i][j] = fmaf(cv[i], sv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        const float e = expf(cum[ty + 16 * i]);
#pragma unroll
        for (int j = 0; j < PB; ++j) acc[i][j] *= e;
      }
      for (int t = 0; t < L; ++t) {
        float lv[RL], xv[PB];
#pragma unroll
        for (int i = 0; i < RL; ++i) lv[i] = Ls[(ty + 16 * i) * (L + 1) + t];
#pragma unroll
        for (int j = 0; j < PB; ++j) xv[j] = tx + 16 * j < P ? Xs[t * P + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int j = 0; j < PB; ++j) acc[i][j] = fmaf(lv[i], xv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        const int t = c0 + ty + 16 * i;
        if (t >= S) continue;
#pragma unroll
        for (int j = 0; j < PB; ++j)
          if (tx + 16 * j < P) yb[t * ys + tx + 16 * j] = from_float<T>(acc[i][j]);
      }
    }
    __syncthreads();  // every reader of the old state is done

    // state = state exp(cum_last) + sum_t (x dt decay)_t^T B_t; rows p = ty + 16 i,
    // columns n = tx + 16 j, each entry owned by one thread.
    {
      const float e_last = expf(cum[L - 1]);
      float acc[PB][NB];
#pragma unroll
      for (int i = 0; i < PB; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const int p = ty + 16 * i, n = tx + 16 * j;
          acc[i][j] = p < P && n < N ? st[p * ldn + n] * e_last : 0.f;
        }
      for (int t = 0; t < L; ++t) {
        const float d = decay[t];
        float xv[PB], bv[NB];
#pragma unroll
        for (int i = 0; i < PB; ++i) xv[i] = ty + 16 * i < P ? Xs[t * P + ty + 16 * i] * d : 0.f;
#pragma unroll
        for (int j = 0; j < NB; ++j) bv[j] = tx + 16 * j < N ? Bs[t * ldn + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < PB; ++i)
#pragma unroll
          for (int j = 0; j < NB; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < PB; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const int p = ty + 16 * i, n = tx + 16 * j;
          if (p < P && n < N) st[p * ldn + n] = acc[i][j];
        }
    }
  }
  __syncthreads();

  float* so = state_out + (long long)blockIdx.x * P * N;
  for (int e = tid; e < P * N; e += NT) so[e] = st[(e / N) * ldn + e % N];
}

template <typename T, int PB, int NB>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                   void* y, void* state, int B, int S, int H, int G, int P, int N,
                   const long long* strides, cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<T, PB, NB>;
  const size_t smem = smem_bytes(P, N);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)((long long)B * H), NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const T*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<T*>(y),
      static_cast<float*>(state), S, H, G, P, N, strides[0], strides[1], strides[2], strides[3],
      strides[4], strides[5], strides[6], strides[7]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                     void* y, void* state, int B, int S, int H, int G, int P, int N,
                     const long long* strides, cudaStream_t stream) {
  if (P <= 64 && N <= 64)
    return launch<T, 4, 4>(x, dt, A, Bm, Cm, y, state, B, S, H, G, P, N, strides, stream);
  if (P <= 64)
    return launch<T, 4, 8>(x, dt, A, Bm, Cm, y, state, B, S, H, G, P, N, strides, stream);
  if (N <= 64)
    return launch<T, 8, 4>(x, dt, A, Bm, Cm, y, state, B, S, H, G, P, N, strides, stream);
  return launch<T, 8, 8>(x, dt, A, Bm, Cm, y, state, B, S, H, G, P, N, strides, stream);
}

}  // namespace

// x [B, S, H, P], dt [B, S, H], A [H], Bm and Cm [B, S, G, N], all of `dtype`
// (DTypeCode).  Only the batch and sequence axes may be strided (in elements:
// x, dt, Bm, Cm in turn, batch stride then sequence stride); the axes after
// them are dense.  Writes y [B, S, H, P] of `dtype` and the final state
// [B, H, P, N] fp32, both contiguous.  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int ssd_scan_fwd(int dtype, const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* y, void* state, int B, int S,
                            int H, int G, int P, int N, long long xsb, long long xss,
                            long long dsb, long long dss, long long bsb, long long bss,
                            long long csb, long long css, void* stream) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || H % G || P < 1 || P > MAXD || N < 1 || N > MAXD ||
      (long long)B * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const long long strides[8] = {xsb, xss, dsb, dss, bsb, bss, csb, css};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch<float>(x, dt, A, Bm, Cm, y, state, B, S, H, G, P, N, strides, s);
    case kBFloat16:
      return dispatch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, B, S, H, G, P, N, strides, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
