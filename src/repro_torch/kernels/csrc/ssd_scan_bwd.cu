// The gradient of the Mamba-2 SSD chunked scan for Hopper (sm_90a), on the
// CUDA cores: the `simt` variant of `ssd_scan_bwd` (kernels/ssd_scan.py),
// the one backward kernel, for fp32 and bf16 alike.
//
// The gradient of the TPU kernel repro/kernels/ssd_scan.py:65 `ssd_scan`,
// which the reference takes by XLA autodiff of its jnp path (`ssd_chunked`).
// For each (batch, head) pair, with group g = h / (H / G), the forward is
//
//   state_t = state_{t-1} * exp(dt_t A_h) + dt_t x_t B_t^T      [P, N]
//   y_t     = C_t . state_t                                      [P]
//
// and this kernel takes dy [B, S, H, P] (y's cotangent, x's type) and dstate
// [B, H, P, N] fp32 (the final state's; zeros in training) and writes dx
// and ddt in x's type, and in fp32 each block's term of dA and each head's
// dB and dC; the wrapper sums dA over the batch and dB, dC over the heads of
// a group, each a `sum` over one axis, in a fixed order, and rounds once.
// By chunks of L steps, with cum = cumsum(dt A) within the chunk, decay_ts
// = exp(cum_t - cum_s) for s <= t, Lm = C B^T o decay, Pd = dy (x dt)^T, W
// = Pd o decay, M = Lm o Pd, S_in the state entering the chunk and dS the
// gradient of the one leaving it (dstate for the last chunk):
//
//   d(x dt)_s = sum_t Lm_ts dy_t + exp(cum_last - cum_s) dS B_s
//   dC_t      = sum_s W_ts B_s + exp(cum_t) S_in^T dy_t
//   dB_s      = sum_t W_ts C_t + exp(cum_last - cum_s) dS^T (x dt)_s
//   d(dt A)_s = sum_{t >= s > u} M_tu + sum_{t >= s} exp(cum_t) C_t . (S_in^T dy_t)
//               + exp(cum_last) <dS, S_in> + sum_{t < s} (x dt)_t . (the dS term of d(x dt)_t)
//   dS_in     = exp(cum_last) dS + sum_t exp(cum_t) dy_t C_t^T
//
// then dx = dt d(x dt), ddt = x . d(x dt) + A d(dt A), and dA's term sum_s
// dt_s d(dt A)_s.
//
// Where trouble lies, and what the design does about it:
//   * Masked exponentials.  exp(cum_t - cum_s) is selected to 0 above the
//     diagonal BEFORE the exp, as the reference's `ssd_chunked` notes
//     (repro/models/ssm.py:101-103): there cum_t - cum_s > 0 may overflow,
//     and inf * 0 is NaN, in the forward's product and in every gradient.
//   * The gradient of the cumulative sum is a reverse cumulative sum within
//     each chunk, plus the term of the chunk's total decay exp(cum_last),
//     through which the state leaving the chunk depends on every step.
//     Summed as it stands (dcum_t = dy_t . y_t - (x dt)_t . d(x dt)_t, plus
//     <dS, S_out> at the last step, then summed from the end) it cancels
//     large terms: the diagonal of M, and the state's total against its
//     parts.  d(dt A) is therefore formed as the four sums above, none of
//     which cancels: the pairs whose decay spans step s (each row's
//     exclusive prefix over u by 16-lane scans, summed over rows t >= s),
//     the inter-chunk terms from s on (a suffix scan), the entering state's
//     term, and the state's terms before s (a prefix scan).  In fp32 the
//     other form's dA missed the reference's by more than the 1e-4 the
//     tests hold it to (tests/test_torch_ssm_train.py).
//   * Reductions in a fixed order, no floating-point atomics: the row sums
//     and scans over 16 lanes by shuffles, the block's sums through one slot
//     per warp (or per row of the thread grid) summed in order, dA's term
//     over the chunks in one register, and the sums over the batch and the
//     group's heads in the wrapper.  Two runs give the same bits.
//   * Round once: everything is fp32 until dx and ddt are written, and the
//     wrapper's sums round dA, dB and dC once into the inputs' type (bf16
//     when `apply_mamba` casts dt and A to the activations' dtype).
//   * Padded steps.  Steps past S load as 0 (dt = 0 makes them exact no-ops,
//     and dy = 0 gives them no gradient) and are not written, so any S
//     works; the model's own padding to its chunk (dt = 0 there too) reaches
//     F.pad's backward, which drops it.
//
// Design (the first, simple version).  One block of 256 threads for each
// (batch, head), L = 64, in two sweeps:
//   1. forward: the running state [P, N] in shared memory, as the forward
//      kernel keeps it; each chunk's entry state is written to fp32
//      scratch the wrapper allocates, [B, H, ceil(S / L), P, N] (134 MB at
//      mamba2's B4 S2048 H32 P64 N128).
//   2. reverse, from the last chunk to the first, dS [P, N] in shared memory:
//      load x dt, dy, B, C, dt, scan cum, and <dS, S_in> with S_in read
//      from the scratch through the cache; then (a) C B^T and dy (x dt)^T on
//      the chunk square, masked and decayed, and each thread's share of the
//      span sums; (b) dC and the inter-chunk dots; (c) dB; (d) d(x dt), dx,
//      x . d(x dt) and the state's dots; (e) warp 0 sums the span shares
//      and scans, and writes ddt and dA's term, while every thread updates
//      its own entries of dS.
// Every product is a 16 x 16 grid of threads, each with a register tile of
// CUDA-core FMAs (rows 16 apart, columns 16 apart), as in the forward
// kernel.  Tiles read with the row index across lanes (B, x dt, dS) are
// padded by one float a row; the others are not, for room: at P = N = 128
// the shared memory is 232,228 B of the 232,448 a block may have.
//
// Bound on the H100, at the training shape B4 S2048 H32 P64 G1 N128 bf16:
// bytes.  The function reads x, dt, A, B, C, dy and dstate once and writes
// dx, ddt, dA, dB and dC once, 114.3 MB, 34.1 us at 3.35 TB/s; its
// operations, about 2 B H sum_chunks (c (c + 1) / 2 (3 N + 2 P) + 5 c P N)
// (ssd_scan.py `bwd_flops`), are 30.2 GFLOP, 30.5 us at the bf16
// tensor-core rate.  This design adds scratch traffic (the entry states,
// 134 MB written and read; dB and dC per head in fp32, 268 MB written and
// read by the wrapper's sums) and computes on the CUDA cores, whose fp32
// rate (67 TFLOP/s) puts its operations alone at 451 us.

#include "common.cuh"

namespace {

constexpr int NT = 256;      // threads a block: a 16 x 16 grid
constexpr int NW = NT / 32;  // warps a block
constexpr int L = 64;        // steps a chunk
constexpr int MAXD = 128;    // largest P and N
constexpr int RL = L / 16;   // chunk rows (or columns) a thread owns

size_t smem_bytes(int P, int N) {
  return sizeof(float) * ((size_t)P * (N + 1)    // dS (the running state in sweep 1)
                          + (size_t)L * (N + 1)  // B
                          + (size_t)L * N        // C
                          + (size_t)L * (P + 1)  // x dt
                          + (size_t)L * P        // dy
                          + 2 * (size_t)L * L    // Lm, W
                          + 7 * (size_t)L        // cum, exp(cum), decay, dt, and three dots
                          + NW + 1);             // per-warp partials, <dS, S_in>
}

// Sum over the 16 lanes that share a row of the thread grid (tx = 0..15), in
// a fixed order; every one of them gets the sum.
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the block in a fixed order: each warp's lanes by xor shuffles,
// then thread 0 adds the warps' sums in turn into *out.  Every thread calls
// it; *out is ready after the next __syncthreads.
__device__ __forceinline__ void block_sum(float v, float* part, float* out) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < NW; ++w) s += part[w];
    *out = s;
  }
}

// Warp 0: cum (inclusive prefix of dt A within the chunk), exp(cum) and
// exp(cum_last - cum); lane l holds steps 2l and 2l + 1.
__device__ __forceinline__ void scan_cum(const float* dts, float a, float* cum, float* ecum,
                                         float* decay) {
  const int lane = threadIdx.x, t0 = 2 * lane, t1 = t0 + 1;
  const float v0 = dts[t0] * a, v1 = dts[t1] * a;
  float run = v0 + v1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, run, off);
    if (lane >= off) run += o;
  }
  float before = __shfl_up_sync(0xffffffffu, run, 1);
  if (lane == 0) before = 0.f;
  const float c0 = before + v0, c1 = c0 + v1;
  const float last = __shfl_sync(0xffffffffu, c1, 31);
  cum[t0] = c0;
  cum[t1] = c1;
  ecum[t0] = expf(c0);
  ecum[t1] = expf(c1);
  decay[t0] = expf(last - c0);
  decay[t1] = expf(last - c1);
}

template <typename T, int PB, int NB>
__global__ void __launch_bounds__(NT) ssd_scan_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dt, const T* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const T* __restrict__ dy,
    const float* __restrict__ dstate, float* __restrict__ states, T* __restrict__ dx,
    T* __restrict__ ddt, float* __restrict__ dA_part, float* __restrict__ dB_h,
    float* __restrict__ dC_h, int S, int H, int G, int P, int N, long long xsb, long long xss,
    long long dsb, long long dss, long long bsb, long long bss, long long csb, long long css) {
  extern __shared__ float smem[];
  const int ldn = N + 1, ldp = P + 1;
  float* dS = smem;               // [P][N+1]
  float* Bs = dS + P * ldn;       // [L][N+1]
  float* Cs = Bs + L * ldn;       // [L][N]
  float* Xs = Cs + L * N;         // [L][P+1]: x * dt
  float* Ds = Xs + L * ldp;       // [L][P]: dy
  float* Ls = Ds + L * P;         // [L][L]: C B^T o decay
  float* Ws = Ls + L * L;         // [L][L]: dy (x dt)^T o decay
  float* cum = Ws + L * L;        // [L]
  float* ecum = cum + L;          // [L]: exp(cum)
  float* decay = ecum + L;        // [L]: exp(cum_last - cum)
  float* dts = decay + L;         // [L]: dt
  float* inter = dts + L;         // [L]: exp(cum_t) C_t . (S_in^T dy_t)
  float* xdot = inter + L;        // [L]: x_t . d(x dt)_t
  float* sdot = xdot + L;         // [L]: (x dt)_t . (d(x dt)_t's dS term)
  float* part = sdot + L;         // [NW]
  float* dot_in = part + NW;      // <dS, S_in> of the chunk the reverse sweep is at
  float* colpart = Ws;            // [16][L], after (b) and (c): the span sums by ty

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int g = h / (H / G);
  const float a = to_float(A[h]);
  const T* xb = x + b * xsb + (long long)h * P;
  const T* db = dt + b * dsb + h;
  const T* Bb = Bm + b * bsb + (long long)g * N;
  const T* Cb = Cm + b * csb + (long long)g * N;
  const long long rowHP = (long long)H * P, rowHN = (long long)H * N;
  const T* dyb = dy + ((long long)b * S * H + h) * P;  // dy, dx: contiguous [B, S, H, P]
  T* dxb = dx + ((long long)b * S * H + h) * P;
  T* ddtb = ddt + (long long)b * S * H + h;           // contiguous [B, S, H]
  float* dBb = dB_h + ((long long)b * S * H + h) * N;  // contiguous [B, S, H, N]
  float* dCb = dC_h + ((long long)b * S * H + h) * N;
  const int NC = (S + L - 1) / L;
  float* st_scratch = states + (long long)blockIdx.x * NC * P * N;

  auto load_x_dt = [&](int c0) {  // Xs, dts, and the scan, for the chunk at c0
    for (int e = tid; e < L * P; e += NT) {
      const int t = e / P, p = e % P;
      Xs[t * ldp + p] = c0 + t < S ? to_float(xb[(c0 + t) * xss + p]) * to_float(db[(c0 + t) * dss])
                                   : 0.f;
    }
    for (int e = tid; e < L * N; e += NT) {
      const int t = e / N, n = e % N;
      Bs[t * ldn + n] = c0 + t < S ? to_float(Bb[(c0 + t) * bss + n]) : 0.f;
    }
    if (tid < L) dts[tid] = c0 + tid < S ? to_float(db[(c0 + tid) * dss]) : 0.f;
  };

  // ---- sweep 1: each chunk's entry state into the scratch
  for (int e = tid; e < P * ldn; e += NT) dS[e] = 0.f;
  for (int c = 0; c < NC; ++c) {
    const int c0 = c * L;
    __syncthreads();  // the state is complete; the last chunk's readers are done
    float* so = st_scratch + (long long)c * P * N;
    for (int e = tid; e < P * N; e += NT) so[e] = dS[(e / N) * ldn + e % N];
    if (c == NC - 1) break;  // no chunk enters with the final state
    load_x_dt(c0);
    __syncthreads();
    if (tid < 32) scan_cum(dts, a, cum, ecum, decay);
    __syncthreads();
    const float e_last = ecum[L - 1];
    float acc[PB][NB];
#pragma unroll
    for (int i = 0; i < PB; ++i)
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int p = ty + 16 * i, n = tx + 16 * j;
        acc[i][j] = p < P && n < N ? dS[p * ldn + n] * e_last : 0.f;
      }
    for (int t = 0; t < L; ++t) {
      const float d = decay[t];
      float xv[PB], bv[NB];
#pragma unroll
      for (int i = 0; i < PB; ++i) xv[i] = ty + 16 * i < P ? Xs[t * ldp + ty + 16 * i] * d : 0.f;
#pragma unroll
      for (int j = 0; j < NB; ++j) bv[j] = tx + 16 * j < N ? Bs[t * ldn + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < PB; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < PB; ++i)  // each thread writes only the entries it read
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const int p = ty + 16 * i, n = tx + 16 * j;
        if (p < P && n < N) dS[p * ldn + n] = acc[i][j];
      }
  }
  __syncthreads();  // every thread has stored the last entry state
  {
    const float* ds = dstate + (long long)blockIdx.x * P * N;
    for (int e = tid; e < P * N; e += NT) dS[(e / N) * ldn + e % N] = ds[e];
  }

  // ---- sweep 2: from the last chunk to the first
  float dA_acc = 0.f;  // thread 0's: sum of dt d(dt A) over the chunks, in order
  for (int c = NC - 1; c >= 0; --c) {
    const int c0 = c * L;
    const float* s_in = st_scratch + (long long)c * P * N;
    __syncthreads();  // dS is complete; the last chunk's readers are done
    load_x_dt(c0);
    for (int e = tid; e < L * N; e += NT) {
      const int t = e / N, n = e % N;
      Cs[e] = c0 + t < S ? to_float(Cb[(c0 + t) * css + n]) : 0.f;
    }
    for (int e = tid; e < L * P; e += NT) {
      const int t = e / P;
      Ds[e] = c0 + t < S ? to_float(dyb[(c0 + t) * rowHP + e % P]) : 0.f;
    }
    __syncthreads();
    if (tid < 32) scan_cum(dts, a, cum, ecum, decay);
    {  // <dS, S_in>
      float v = 0.f;
      for (int e = tid; e < P * N; e += NT) v = fmaf(dS[(e / N) * ldn + e % N], s_in[e], v);
      block_sum(v, part, dot_in);  // also the barrier after the scan
    }

    // (a) C B^T and dy (x dt)^T on rows t = ty + 16 i, columns s = tx + 16 j,
    // masked and decayed; M = Lm o (dy (x dt)^T), and for each column s this
    // thread's rows' share of sum_{t >= s > u} M_tu: each row's exclusive
    // prefix over u (16-lane scans, column blocks in turn), kept in colP.
    float colP[RL];
    {
      float g_[RL][RL], w_[RL][RL];
#pragma unroll
      for (int i = 0; i < RL; ++i)
#pragma unroll
        for (int j = 0; j < RL; ++j) g_[i][j] = w_[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[RL], bv[RL];
#pragma unroll
        for (int i = 0; i < RL; ++i) cv[i] = Cs[(ty + 16 * i) * N + n];
#pragma unroll
        for (int j = 0; j < RL; ++j) bv[j] = Bs[(tx + 16 * j) * ldn + n];
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int j = 0; j < RL; ++j) g_[i][j] = fmaf(cv[i], bv[j], g_[i][j]);
      }
      for (int p = 0; p < P; ++p) {
        float dv[RL], xv[RL];
#pragma unroll
        for (int i = 0; i < RL; ++i) dv[i] = Ds[(ty + 16 * i) * P + p];
#pragma unroll
        for (int j = 0; j < RL; ++j) xv[j] = Xs[(tx + 16 * j) * ldp + p];
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int j = 0; j < RL; ++j) w_[i][j] = fmaf(dv[i], xv[j], w_[i][j]);
      }
#pragma unroll
      for (int j = 0; j < RL; ++j) colP[j] = 0.f;
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        const int t = ty + 16 * i;
        float base = 0.f;  // sum of M_tu over the column blocks before j
#pragma unroll
        for (int j = 0; j < RL; ++j) {
          const int s = tx + 16 * j;
          // Select before the exp: above the diagonal cum_t - cum_s > 0.
          const float d = s <= t ? expf(cum[t] - cum[s]) : 0.f;
          const float lm = g_[i][j] * d;
          Ls[t * L + s] = lm;
          Ws[t * L + s] = w_[i][j] * d;
          const float m = lm * w_[i][j];
          float inc = m;
#pragma unroll
          for (int off = 1; off < 16; off <<= 1) {
            const float o = __shfl_up_sync(0xffffffffu, inc, off, 16);
            if (tx >= off) inc += o;
          }
          float before = __shfl_up_sync(0xffffffffu, inc, 1, 16);
          if (tx == 0) before = 0.f;
          if (t >= s) colP[j] += base + before;  // sum_{u < s} M_tu
          base += __shfl_sync(0xffffffffu, inc, 15, 16);
        }
      }
    }
    __syncthreads();

    // (b) dC = W B + exp(cum) o (dy S_in) on rows t = ty + 16 i, columns n =
    // tx + 16 j; inter_t = exp(cum_t) C_t . (S_in^T dy_t).
    {
      float aw[RL][NB], aq[RL][NB];
#pragma unroll
      for (int i = 0; i < RL; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j) aw[i][j] = aq[i][j] = 0.f;
      for (int s = 0; s < L; ++s) {
        float wv[RL], bv[NB];
#pragma unroll
        for (int i = 0; i < RL; ++i) wv[i] = Ws[(ty + 16 * i) * L + s];
#pragma unroll
        for (int j = 0; j < NB; ++j) bv[j] = tx + 16 * j < N ? Bs[s * ldn + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int j = 0; j < NB; ++j) aw[i][j] = fmaf(wv[i], bv[j], aw[i][j]);
      }
      for (int p = 0; p < P; ++p) {
        float dv[RL], sv[NB];
#pragma unroll
        for (int i = 0; i < RL; ++i) dv[i] = Ds[(ty + 16 * i) * P + p];
#pragma unroll
        for (int j = 0; j < NB; ++j) sv[j] = tx + 16 * j < N ? s_in[p * N + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int j = 0; j < NB; ++j) aq[i][j] = fmaf(dv[i], sv[j], aq[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        const int t = ty + 16 * i;
        const float e = ecum[t];
        float r = 0.f;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const int n = tx + 16 * j;
          if (n < N) {
            r = fmaf(Cs[t * N + n], aq[i][j], r);
            if (c0 + t < S) dCb[(c0 + t) * rowHN + n] = fmaf(e, aq[i][j], aw[i][j]);
          }
        }
        r = sum16(r);
        if (tx == 0) inter[t] = e * r;
      }
    }

    // (c) dB = W^T C + exp(cum_last - cum) o ((x dt) dS) on rows s = ty + 16 i,
    // columns n = tx + 16 j.
    {
      float aw[RL][NB], as[RL][NB];
#pragma unroll
      for (int i = 0; i < RL; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j) aw[i][j] = as[i][j] = 0.f;
      for (int t = 0; t < L; ++t) {
        float wv[RL], cv[NB];
#pragma unroll
        for (int i = 0; i < RL; ++i) wv[i] = Ws[t * L + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < NB; ++j) cv[j] = tx + 16 * j < N ? Cs[t * N + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int j = 0; j < NB; ++j) aw[i][j] = fmaf(wv[i], cv[j], aw[i][j]);
      }
      for (int p = 0; p < P; ++p) {
        float xv[RL], sv[NB];
#pragma unroll
        for (int i = 0; i < RL; ++i) xv[i] = Xs[(ty + 16 * i) * ldp + p];
#pragma unroll
        for (int j = 0; j < NB; ++j) sv[j] = tx + 16 * j < N ? dS[p * ldn + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int j = 0; j < NB; ++j) as[i][j] = fmaf(xv[i], sv[j], as[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        const int s = ty + 16 * i;
        if (c0 + s >= S) continue;
        const float d = decay[s];
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const int n = tx + 16 * j;
          if (n < N) dBb[(c0 + s) * rowHN + n] = fmaf(d, as[i][j], aw[i][j]);
        }
      }
    }

    // (d) d(x dt) = Lm^T dy + exp(cum_last - cum) o (B dS^T) on rows s = ty +
    // 16 i, columns p = tx + 16 j; dx = dt d(x dt); xdot_s = x_s . d(x dt)_s
    // and sdot_s = (x dt)_s . (the dS term of d(x dt)_s).
    {
      float al[RL][PB], as[RL][PB];
#pragma unroll
      for (int i = 0; i < RL; ++i)
#pragma unroll
        for (int j = 0; j < PB; ++j) al[i][j] = as[i][j] = 0.f;
      for (int t = 0; t < L; ++t) {
        float lv[RL], dv[PB];
#pragma unroll
        for (int i = 0; i < RL; ++i) lv[i] = Ls[t * L + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < PB; ++j) dv[j] = tx + 16 * j < P ? Ds[t * P + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int j = 0; j < PB; ++j) al[i][j] = fmaf(lv[i], dv[j], al[i][j]);
      }
      for (int n = 0; n < N; ++n) {
        float bv[RL], sv[PB];
#pragma unroll
        for (int i = 0; i < RL; ++i) bv[i] = Bs[(ty + 16 * i) * ldn + n];
#pragma unroll
        for (int j = 0; j < PB; ++j) sv[j] = tx + 16 * j < P ? dS[(tx + 16 * j) * ldn + n] : 0.f;
#pragma unroll
        for (int i = 0; i < RL; ++i)
#pragma unroll
          for (int j = 0; j < PB; ++j) as[i][j] = fmaf(bv[i], sv[j], as[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        const int s = ty + 16 * i;
        const bool in = c0 + s < S;
        const float d = decay[s], w = dts[s];
        float r = 0.f, q = 0.f;
#pragma unroll
        for (int j = 0; j < PB; ++j) {
          const int p = tx + 16 * j;
          if (p < P && in) {
            const float g = fmaf(d, as[i][j], al[i][j]);
            dxb[(c0 + s) * rowHP + p] = from_float<T>(w * g);
            r = fmaf(to_float(xb[(c0 + s) * xss + p]), g, r);
            q = fmaf(Xs[s * ldp + p], d * as[i][j], q);
          }
        }
        r = sum16(r);
        q = sum16(q);
        if (tx == 0) {
          xdot[s] = r;
          sdot[s] = q;
        }
      }
    }
    __syncthreads();  // inter, xdot, sdot complete; every reader of W and dS is done
#pragma unroll
    for (int j = 0; j < RL; ++j) colpart[ty * L + tx + 16 * j] = colP[j];
    __syncthreads();

    // (e) warp 0: d(dt A) = the span sums (colpart summed over ty) + the suffix
    // sums of inter + exp(cum_last) <dS, S_in> + the exclusive prefix sums of
    // sdot; then ddt and dA's term.
    if (tid < 32) {
      const int t0 = 2 * tid, t1 = t0 + 1;
      float span0 = 0.f, span1 = 0.f;
      for (int k = 0; k < 16; ++k) {
        span0 += colpart[k * L + t0];
        span1 += colpart[k * L + t1];
      }
      float run = inter[t0] + inter[t1];  // becomes the inclusive suffix sum of pair sums
      float pre = sdot[t0] + sdot[t1];    // becomes the inclusive prefix sum of pair sums
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, run, off);
        const float u = __shfl_up_sync(0xffffffffu, pre, off);
        if (tid + off < 32) run += o;
        if (tid >= off) pre += u;
      }
      float after = __shfl_down_sync(0xffffffffu, run, 1);
      float before = __shfl_up_sync(0xffffffffu, pre, 1);
      if (tid == 31) after = 0.f;
      if (tid == 0) before = 0.f;
      const float state = ecum[L - 1] * *dot_in;
      const float da1 = span1 + (after + inter[t1]) + state + (before + sdot[t0]);
      const float da0 = span0 + (after + inter[t1] + inter[t0]) + state + before;
      if (c0 + t0 < S) ddtb[(c0 + t0) * (long long)H] = from_float<T>(fmaf(a, da0, xdot[t0]));
      if (c0 + t1 < S) ddtb[(c0 + t1) * (long long)H] = from_float<T>(fmaf(a, da1, xdot[t1]));
      float v = fmaf(dts[t0], da0, dts[t1] * da1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (tid == 0) dA_acc += v;
    }
    // dS_in = exp(cum_last) dS + (exp(cum) o dy)^T C on rows p = ty + 16 i,
    // columns n = tx + 16 j, each entry owned by one thread.
    {
      const float e_last = ecum[L - 1];
      float acc[PB][NB];
#pragma unroll
      for (int i = 0; i < PB; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const int p = ty + 16 * i, n = tx + 16 * j;
          acc[i][j] = p < P && n < N ? dS[p * ldn + n] * e_last : 0.f;
        }
      for (int t = 0; t < L; ++t) {
        const float e = ecum[t];
        float dv[PB], cv[NB];
#pragma unroll
        for (int i = 0; i < PB; ++i) dv[i] = ty + 16 * i < P ? Ds[t * P + ty + 16 * i] * e : 0.f;
#pragma unroll
        for (int j = 0; j < NB; ++j) cv[j] = tx + 16 * j < N ? Cs[t * N + tx + 16 * j] : 0.f;
#pragma unroll
        for (int i = 0; i < PB; ++i)
#pragma unroll
          for (int j = 0; j < NB; ++j) acc[i][j] = fmaf(dv[i], cv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < PB; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          const int p = ty + 16 * i, n = tx + 16 * j;
          if (p < P && n < N) dS[p * ldn + n] = acc[i][j];
        }
    }
  }
  if (tid == 0) dA_part[blockIdx.x] = dA_acc;
}

template <typename T, int PB, int NB>
cudaError_t launch(const void* const* ptrs, void* const* outs, int B, int S, int H, int G, int P,
                   int N, const long long* st, cudaStream_t stream) {
  auto kernel = ssd_scan_bwd_kernel<T, PB, NB>;
  const size_t smem = smem_bytes(P, N);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)((long long)B * H), NT, smem, stream>>>(
      static_cast<const T*>(ptrs[0]), static_cast<const T*>(ptrs[1]),
      static_cast<const T*>(ptrs[2]), static_cast<const T*>(ptrs[3]),
      static_cast<const T*>(ptrs[4]), static_cast<const T*>(ptrs[5]),
      static_cast<const float*>(ptrs[6]), static_cast<float*>(outs[0]),
      static_cast<T*>(outs[1]), static_cast<T*>(outs[2]), static_cast<float*>(outs[3]),
      static_cast<float*>(outs[4]), static_cast<float*>(outs[5]), S, H, G, P, N, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* const* ptrs, void* const* outs, int B, int S, int H, int G,
                     int P, int N, const long long* st, cudaStream_t stream) {
  if (P <= 64 && N <= 64) return launch<T, 4, 4>(ptrs, outs, B, S, H, G, P, N, st, stream);
  if (P <= 64) return launch<T, 4, 8>(ptrs, outs, B, S, H, G, P, N, st, stream);
  if (N <= 64) return launch<T, 8, 4>(ptrs, outs, B, S, H, G, P, N, st, stream);
  return launch<T, 8, 8>(ptrs, outs, B, S, H, G, P, N, st, stream);
}

}  // namespace

// x [B, S, H, P], dt [B, S, H], A [H], Bm and Cm [B, S, G, N], all of `dtype`
// (DTypeCode), strided as ssd_scan_fwd takes them (batch and sequence
// strides in elements, x, dt, Bm, Cm in turn); dy [B, S, H, P] of `dtype`
// and dstate [B, H, P, N] fp32, contiguous.  `states` is fp32 scratch of [B,
// H, ceil(S / 64), P, N].  Writes dx [B, S, H, P] and ddt [B, S, H] of
// `dtype`, dA_part [B, H] (each (batch, head)'s term of dA), dB_h and dC_h
// [B, S, H, N] (each head's dB and dC), fp32, all contiguous.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ssd_scan_bwd(int dtype, const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, const void* dy, const void* dstate,
                            void* states, void* dx, void* ddt, void* dA_part, void* dB_h,
                            void* dC_h, int B, int S, int H, int G, int P, int N, long long xsb,
                            long long xss, long long dsb, long long dss, long long bsb,
                            long long bss, long long csb, long long css, void* stream) {
  if (B < 1 || S < 1 || H < 1 || G < 1 || H % G || P < 1 || P > MAXD || N < 1 || N > MAXD ||
      (long long)B * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const long long st[8] = {xsb, xss, dsb, dss, bsb, bss, csb, css};
  const void* ptrs[7] = {x, dt, A, Bm, Cm, dy, dstate};
  void* outs[6] = {states, dx, ddt, dA_part, dB_h, dC_h};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return dispatch<float>(ptrs, outs, B, S, H, G, P, N, st, s);
    case kBFloat16:
      return dispatch<__nv_bfloat16>(ptrs, outs, B, S, H, G, P, N, st, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* ssd_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
