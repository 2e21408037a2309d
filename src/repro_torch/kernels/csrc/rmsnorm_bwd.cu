// RMSNorm backward for Hopper (sm_90a): two variants of one function.
//
// The gradient of the TPU kernel repro/kernels/rmsnorm.py:25 `rmsnorm`
// (y = x * r * scale, r = rsqrt(mean(x^2) + eps), in fp32, cast to x's
// type).  The TPU kernel has no backward: the reference trains through
// `apply_norm` and `rmsnorm` (repro/models/layers.py:29,42), which XLA
// differentiates; these kernels are the counterpart of that autodiff.  For
// a row of D values, with g = dy * scale,
//
//   dx     = r * g - x * r^3 * sum(g * x) / D      (in x's type)
//   dscale = sum over rows of dy * x * r           (fp32)
//
// with every sum in fp32.
//
// Bound on the H100: bytes.  The function reads x and dy once and writes dx
// once, 3 * rows * D * sizeof(T) bytes plus 8 D for scale and dscale; at
// 3.35 TB/s the [2048, 2560] bf16 call of qwen3-4b's ln1/ln2 needs 9.4 us,
// the [65536, 128] one of its q-norm 15.0 us and the [16384, 128] one of
// its k-norm 3.8 us.  About 10 flops an element are far below the card's
// rate, so the design is about bytes in flight and reading each byte once.
//
// `vec` (rmsnorm_bwd_vec_kernel; the wrapper's variant "vector"): every
// access is 16 bytes, 8 bf16 or 4 fp32 values.  As in the forward's `vec`
// kernel (csrc/rmsnorm.cu), a team of `tpr` threads owns a row and thread t
// holds vectors t, t + tpr, ... of x and of dy in registers, packed as
// loaded (NV of each at most, a template argument sized to the row), so
// both sums (x^2 and dy * x * scale) and the dx write use them from there
// and each byte is read once.  D = 128 bf16 (the q- and k-norms) takes 16
// threads a row, two rows a warp, and each team walks R = 4 rows at once,
// so a streaming multiprocessor has the loads of about 200 rows (100 KB)
// in flight; its sums need warp shuffles only.  Wider rows take as many
// warps as keep a thread at MAX_NV = 3 vectors or fewer: D = 2560 bf16
// (ln1, ln2, the final norm) four warps a row, 2 or 3 vectors a thread,
// two rows a block.  A team of several warps combines its sums through
// shared memory behind one named barrier a row (`bar.sync` of the team's
// threads only).  Rows of more than 768 vectors (D > 6144 bf16, 3072 fp32)
// take 512 threads.  The most vectors a thread holds trades registers (228
// at 10 vectors, so one block an SM) against barriers: on an H100 SXM at
// 700 W, at [2048, 2560] bf16, one warp a row took 1.7x the time of four,
// two warps 5% and eight 10% more (PERF.md section 6, run T).
// `scale` is copied once a block into shared memory by cp.async, issued
// before the first rows' loads.  dscale is a sum over rows, reduced
// without atomics, so two runs give equal bits: each thread adds dy * x * r
// for its own columns into fp32 registers across every row its team walks;
// at the end the block folds its teams in team order (shuffles within a
// warp, then through shared memory a group at a time) into one fp32
// partial row in device memory, and a second kernel sums the blocks'
// partial rows in a fixed order, 32 warps a block (8 were 1.2-2.1 us a
// call slower at the train shapes, in the same run T).  The grid is as
// many blocks as fit on the streaming multiprocessors at once (from the
// occupancy the compiled kernel allows), so the partials are blocks-an-SM
// x SMs rows of D floats at most (3 x 132 rows of 2560 floats, 4.1 MB, at
// ln1's shape on an H100).  Measured by chip_smoke.py phase 3 on an H100
// SXM at 700 W, both launches: 0.0166 ms at [2048, 2560] bf16 (56% of the
// bound; F.rms_norm's backward 0.0214), 0.0235 at [65536, 128] (64%),
// 0.0099 at [16384, 128] (38%).
//
// `scalar` (rmsnorm_bwd_kernel; variant "scalar"): the first design, kept
// for rows that cannot take 16-byte vectors.  One value an access, a team
// per row, the row read twice (sums, then dx), dscale summed a row at a
// time into the team's row of a shared-memory array, the block's teams
// folded in order into its partial row, at most two blocks an SM.
//
// The wrapper (kernels/rmsnorm.py, `rmsnorm_bwd`) allocates dx, dscale and
// the partials (`rmsnorm_bwd_parts` rows of D floats) with torch.empty.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int MAX_D = 16 * 1024;
constexpr int MAX_NV = 3;  // most vectors a thread holds, below 512 threads a row

int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return count[dev];
}

// ------------------------------------------------------------------ vector

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The E = 16 / sizeof(T) values of one 16-byte vector, as fp32.
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x), f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z), f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = t.x, f[2 * i + 1] = t.y;
  }
}

// E fp32 values as one 16-byte vector of T, rounded to nearest even.
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&b);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The E scale values of vector c, from shared memory.
__device__ __forceinline__ void scale_at(const float4* s, int c, float (&f)[4]) {
  const float4 a = s[c];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
}
__device__ __forceinline__ void scale_at(const float4* s, int c, float (&f)[8]) {
  const float4 a = s[2 * c], b = s[2 * c + 1];
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

// Rows a team walks at once: four when a thread holds one vector of a row.
template <int NV>
constexpr int kRows = NV == 1 ? 4 : 1;

// NV: vectors of a row a thread holds at most; MAXT: the block's threads,
// 256, or 512 for rows that `geometry` gives 512 threads.  tpr: threads a
// row, a power of two up to MAXT; up to 32 the team lies in one warp.
// blockDim.x == MAXT.
template <typename T, int NV, int MAXT>
__global__ void __launch_bounds__(MAXT) rmsnorm_bwd_vec_kernel(
    const T* __restrict__ x, const float* __restrict__ scale, const T* __restrict__ dy,
    T* __restrict__ dx, float* __restrict__ partial, long long rows, int d, int tpr, float eps) {
  constexpr int E = 16 / sizeof(T);  // values a vector
  constexpr int R = kRows<NV>;
  extern __shared__ float4 scale_s[];      // [d / 4]; the fold's row at the end
  __shared__ float red[2][2][MAXT / 32];   // per-warp sums, double-buffered, for wide teams
  const int nvec = d / E;
  const int teams = MAXT / tpr;
  const int team = threadIdx.x / tpr, t = threadIdx.x % tpr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < d / 4; i += MAXT)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(scale_s + i)),
                 "l"(scale + 4 * i)
                 : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  float acc[NV][E];  // this thread's columns of dscale
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;

  bool first = true;
  int buf = 0;
  for (long long base = (long long)blockIdx.x * teams * R; base < rows;
       base += (long long)gridDim.x * teams * R) {  // the same trip count for the whole block
    uint4 xv[R][NV], gv[R][NV];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const long long row = base + (long long)team * R + j;
      const bool live = row < rows;
      const uint4* xr = reinterpret_cast<const uint4*>(x + (live ? row : 0) * d);
      const uint4* gr = reinterpret_cast<const uint4*>(dy + (live ? row : 0) * d);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = t + i * tpr;
        const bool in = live && c < nvec;
        xv[j][i] = in ? __ldg(xr + c) : make_uint4(0u, 0u, 0u, 0u);
        gv[j][i] = in ? __ldg(gr + c) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    if (first) {  // uniform: the scale has landed for the whole block
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      first = false;
    }
    float ss[R], dot[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      ss[j] = dot[j] = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = t + i * tpr;
        if (c >= nvec) continue;  // zeros
        float xf[E], gf[E], s[E];
        unpack(xv[j][i], xf);
        unpack(gv[j][i], gf);
        scale_at(scale_s, c, s);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          ss[j] = fmaf(xf[e], xf[e], ss[j]);
          dot[j] = fmaf(gf[e] * s[e], xf[e], dot[j]);
        }
      }
    }
    if (tpr <= 32) {  // uniform: the team is tpr lanes of one warp
#pragma unroll
      for (int j = 0; j < R; ++j)
        for (int o = tpr / 2; o > 0; o >>= 1) {
          ss[j] += __shfl_xor_sync(0xffffffffu, ss[j], o);
          dot[j] += __shfl_xor_sync(0xffffffffu, dot[j], o);
        }
    } else {  // R == 1: the team's warps meet at one named barrier
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        ss[0] += __shfl_xor_sync(0xffffffffu, ss[0], o);
        dot[0] += __shfl_xor_sync(0xffffffffu, dot[0], o);
      }
      if (lane == 0) red[buf][0][warp] = ss[0], red[buf][1][warp] = dot[0];
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "r"(tpr) : "memory");
      const int wpt = tpr / 32;
      ss[0] = dot[0] = 0.f;
      for (int w = 0; w < wpt; ++w) {
        ss[0] += red[buf][0][team * wpt + w];
        dot[0] += red[buf][1][team * wpt + w];
      }
      buf ^= 1;  // the next row writes the other buffer; this one is rewritten only
                 // after the team has passed the next barrier, so after these reads
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const long long row = base + (long long)team * R + j;
      if (row >= rows) continue;
      const float r = rsqrtf(ss[j] / (float)d + eps);
      const float k = r * r * r * dot[j] / (float)d;
      uint4* orow = reinterpret_cast<uint4*>(dx + row * d);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = t + i * tpr;
        if (c >= nvec) continue;
        float xf[E], gf[E], s[E], o[E];
        unpack(xv[j][i], xf);
        unpack(gv[j][i], gf);
        scale_at(scale_s, c, s);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          o[e] = fmaf(r, gf[e] * s[e], -k * xf[e]);
          acc[i][e] = fmaf(gf[e] * xf[e], r, acc[i][e]);
        }
        orow[c] = pack(o);
      }
    }
  }

  // The block's partial row: first the teams of a warp (lanes t, t + tpr,
  // ... hold the same columns) by shuffles, then the warps, or the teams
  // wider than a warp, in order through shared memory; the last adds
  // straight into the partial row.  Each column has one writer: the first
  // team of its group.
  if (tpr < 32) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e)
        for (int o = tpr; o < 32; o <<= 1) acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], o);
  }
  const int tw = tpr < 32 ? 32 : tpr;  // threads of one group of the fold
  const int groups = MAXT / tw, group = threadIdx.x / tw;
  const bool writer = threadIdx.x % tw < tpr;
  float4* out = reinterpret_cast<float4*>(partial + (long long)blockIdx.x * d);
  __syncthreads();  // every read of the scale is done: its memory takes the fold
  for (int gi = 0; gi < groups; ++gi) {
    if (group == gi && writer) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = t + i * tpr;
        if (c >= nvec) continue;
#pragma unroll
        for (int q = 0; q < E / 4; ++q) {
          float4 v = make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
                                 acc[i][4 * q + 3]);
          if (gi > 0) {
            const float4 f = scale_s[c * (E / 4) + q];
            v = make_float4(f.x + v.x, f.y + v.y, f.z + v.z, f.w + v.w);
          }
          if (gi + 1 < groups) scale_s[c * (E / 4) + q] = v;
          else out[c * (E / 4) + q] = v;
        }
      }
    }
    if (gi + 1 < groups) __syncthreads();
  }
}

// Vectors a thread holds at most, and threads a row, for rows of `nvec`
// 16-byte vectors: one vector a thread and a power-of-two team up to a
// warp; then one warp, and more warps (a power of two, up to 512) only
// when a thread would hold more than MAX_NV vectors.
void geometry(int nvec, int* tpr, int* nv) {
  int n = 1;
  if (nvec <= 32) {
    while (n < nvec) n *= 2;
  } else {
    n = 32;
    while (n * MAX_NV < nvec && n < 512) n *= 2;
  }
  *tpr = n;
  *nv = (nvec + n - 1) / n;
}

// The blocks of one wave: as many as fit on every SM at once.
template <typename T, int NV, int MAXT>
long long vec_grid_cap() {
  static int occ[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (occ[dev] == 0) {
    // The occupancy at the widest row this instantiation takes, so that the
    // grid, and with it dscale's order of sums, depends on no earlier call.
    constexpr int E = 16 / sizeof(T);
    constexpr int widest = NV * MAXT * E < MAX_D ? NV * MAXT * E : MAX_D;
    const int smem = widest * (int)sizeof(float);
    if (cudaFuncSetAttribute(rmsnorm_bwd_vec_kernel<T, NV, MAXT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_D * (int)sizeof(float)) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &occ[dev], rmsnorm_bwd_vec_kernel<T, NV, MAXT>, MAXT, smem) != cudaSuccess)
      return 0;
  }
  return (long long)occ[dev] * sm_count();
}

template <typename T, int NV, int MAXT>
long long vec_grid(long long rows, int d, int tpr) {
  const long long per_block = (long long)(MAXT / tpr) * kRows<NV>;
  const long long need = (rows + per_block - 1) / per_block;
  const long long cap = vec_grid_cap<T, NV, MAXT>();
  return need < cap ? need : cap;
}

template <typename T, int NV, int MAXT>
cudaError_t launch_vec_nv(const void* x, const void* scale, const void* dy, void* dx,
                          void* partial, long long rows, int d, int tpr, float eps,
                          cudaStream_t stream, long long* grid_out) {
  const long long grid = vec_grid<T, NV, MAXT>(rows, d, tpr);
  if (grid_out) {  // the size query of rmsnorm_bwd_parts: launch nothing
    *grid_out = grid;
    return grid > 0 ? cudaSuccess : cudaErrorInvalidValue;
  }
  if (grid < 1) return cudaErrorInvalidValue;
  rmsnorm_bwd_vec_kernel<T, NV, MAXT><<<(unsigned)grid, MAXT, d * (int)sizeof(float), stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(partial), rows, d, tpr, eps);
  return cudaGetLastError();
}

// The instantiation for rows of d values: its grid into *grid_out (and no
// launch) when grid_out is given, else its launch.
template <typename T>
cudaError_t launch_vec(const void* x, const void* scale, const void* dy, void* dx,
                       void* partial, long long rows, int d, float eps, cudaStream_t stream,
                       long long* grid_out) {
  constexpr int E = 16 / sizeof(T);
  int tpr, nv;
  geometry(d / E, &tpr, &nv);
  // Only the instantiations `geometry` can ask for: up to 256 threads a row
  // nv <= MAX_NV; at 512, nv <= 4 (bf16) or 8 (fp32) for D <= MAX_D.
#define VEC_CASE(N, M)                                                                     \
  if (nv <= N)                                                                             \
    return launch_vec_nv<T, N, M>(x, scale, dy, dx, partial, rows, d, tpr, eps, stream,   \
                                  grid_out);
  static_assert(MAX_NV == 3, "the cases below are those of MAX_NV = 3");
  if (tpr <= 256) {
    VEC_CASE(1, 256) VEC_CASE(2, 256) VEC_CASE(3, 256)
  } else {
    VEC_CASE(4, 512)
    if constexpr (sizeof(T) == 4) { VEC_CASE(8, 512) }
  }
#undef VEC_CASE
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------------ scalar

constexpr int NT = 256;  // threads a block of the scalar kernel

// tpr: threads a row, a power of two up to NT; blockDim.x == NT.
template <typename T>
__global__ void __launch_bounds__(NT) rmsnorm_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ scale, const T* __restrict__ dy,
    T* __restrict__ dx, float* __restrict__ partial, long long rows, int d, int tpr, float eps) {
  extern __shared__ float acc[];   // [teams][d]: each team's dscale sums
  __shared__ float red[2][NT / 32];  // per-warp sums, for teams wider than a warp
  const int teams = NT / tpr;
  const int team = threadIdx.x / tpr, t = threadIdx.x % tpr;
  float* mine = acc + team * d;
  for (int i = threadIdx.x; i < teams * d; i += NT) acc[i] = 0.f;
  __syncthreads();

  for (long long base = (long long)blockIdx.x * teams; base < rows;
       base += (long long)gridDim.x * teams) {  // the same trip count for the whole block
    const long long row = base + team;
    const bool live = row < rows;
    const long long off = (live ? row : 0) * d;
    float ss = 0.f, dot = 0.f;
    if (live) {
      for (int c = t; c < d; c += tpr) {
        const float xv = to_float(x[off + c]), gv = to_float(dy[off + c]);
        ss = fmaf(xv, xv, ss);
        dot = fmaf(gv * __ldg(scale + c), xv, dot);
      }
    }
    if (tpr <= 32) {  // uniform: the team is tpr lanes of one warp
      for (int o = tpr / 2; o > 0; o >>= 1) {
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      }
    } else {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      }
      if (threadIdx.x % 32 == 0) {
        red[0][threadIdx.x / 32] = ss;
        red[1][threadIdx.x / 32] = dot;
      }
      __syncthreads();
      const int wpt = tpr / 32;
      ss = dot = 0.f;
      for (int w = 0; w < wpt; ++w) {
        ss += red[0][team * wpt + w];
        dot += red[1][team * wpt + w];
      }
      __syncthreads();  // every read of `red` is done before the next row's writes
    }
    if (!live) continue;
    const float r = rsqrtf(ss / (float)d + eps);
    const float k = r * r * r * dot / (float)d;
    for (int c = t; c < d; c += tpr) {
      const float xv = to_float(x[off + c]), gv = to_float(dy[off + c]);
      dx[off + c] = from_float<T>(fmaf(r, gv * __ldg(scale + c), -k * xv));
      mine[c] += gv * xv * r;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < d; i += NT) {  // the block's partial: its teams in order
    float s = 0.f;
    for (int tm = 0; tm < teams; ++tm) s += acc[tm * d + i];
    partial[(long long)blockIdx.x * d + i] = s;
  }
}

// Threads a row: the smallest power of two that covers the row, at most NT.
int team_size(int d) {
  int tpr = 1;
  while (tpr < d && tpr < NT) tpr *= 2;
  return tpr;
}

long long scalar_grid(long long rows, int d) {
  const int teams = NT / team_size(d);
  const long long need = (rows + teams - 1) / teams;
  const long long cap = 2LL * sm_count();
  return need < cap ? need : cap;
}

template <typename T>
cudaError_t launch_scalar(const void* x, const void* scale, const void* dy, void* dx,
                          void* partial, long long rows, int d, float eps, cudaStream_t stream) {
  const int tpr = team_size(d);
  const int smem = (NT / tpr) * d * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rmsnorm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  rmsnorm_bwd_kernel<T><<<(unsigned)scalar_grid(rows, d), NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(partial), rows, d, tpr, eps);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ dscale

constexpr int RW = 32;  // warps a block of the reduce kernel

// dscale[c] = the sum of partial[p][c] over p, in a fixed order: warp w of a
// block sums parts w, w + RW, ... of 32 columns, then warp 0 the RW sums in
// order.  The partial rows were just written, so the loads hit L2; RW warps
// keep each thread's chain of dependent adds short.
__global__ void __launch_bounds__(RW * 32) rmsnorm_bwd_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ dscale, int parts, int d) {
  __shared__ float s[RW][33];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  float a = 0.f;
  if (c < d)
#pragma unroll 4
    for (int p = w; p < parts; p += RW) a += partial[(long long)p * d + c];
  s[w][lane] = a;
  __syncthreads();
  if (w == 0 && c < d) {
    float tot = 0.f;
#pragma unroll
    for (int i = 0; i < RW; ++i) tot += s[i][lane];
    dscale[c] = tot;
  }
}

bool valid(int dtype, int vec, long long rows, int d) {
  const int e = vec ? (dtype == kFloat32 ? 4 : 8) : 1;
  return rows >= 1 && d >= 1 && d <= MAX_D && d % e == 0 &&
         (dtype == kFloat32 || dtype == kBFloat16);
}

}  // namespace

// The number of partial rows of D floats that rmsnorm_bwd needs for these
// arguments (its grid), or -1 if it would refuse them.
extern "C" long long rmsnorm_bwd_parts(int dtype, int vec, long long rows, int d) {
  if (!valid(dtype, vec, rows, d)) return -1;
  if (!vec) return scalar_grid(rows, d);
  long long grid = 0;
  const cudaError_t err =
      dtype == kFloat32
          ? launch_vec<float>(nullptr, nullptr, nullptr, nullptr, nullptr, rows, d, 0.f, 0, &grid)
          : launch_vec<__nv_bfloat16>(nullptr, nullptr, nullptr, nullptr, nullptr, rows, d, 0.f,
                                      0, &grid);
  return err == cudaSuccess ? grid : -1;
}

// x, dy, dx: [rows, d] of `dtype` (DTypeCode), contiguous; scale, dscale:
// [d] fp32; partial: rmsnorm_bwd_parts(...) * d fp32.  `vec` 1 takes
// 16-byte accesses and needs d a multiple of 16 / sizeof(dtype) and x, dy,
// dx and scale 16-byte aligned; `vec` 0 takes one value at a time.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int rmsnorm_bwd(int dtype, int vec, const void* x, const void* scale, const void* dy,
                           void* dx, void* dscale, void* partial, long long rows, int d,
                           float eps, void* stream) {
  const long long parts = rmsnorm_bwd_parts(dtype, vec, rows, d);
  if (parts < 1) return cudaErrorInvalidValue;
  if (vec && (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
              reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(scale)) % 16)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kFloat32)
    err = vec ? launch_vec<float>(x, scale, dy, dx, partial, rows, d, eps, s, nullptr)
              : launch_scalar<float>(x, scale, dy, dx, partial, rows, d, eps, s);
  else
    err = vec ? launch_vec<__nv_bfloat16>(x, scale, dy, dx, partial, rows, d, eps, s, nullptr)
              : launch_scalar<__nv_bfloat16>(x, scale, dy, dx, partial, rows, d, eps, s);
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_reduce_kernel<<<(d + 31) / 32, RW * 32, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dscale), (int)parts, d);
  return cudaGetLastError();
}

extern "C" const char* rmsnorm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
