// RMSNorm backward for Hopper (sm_90a).
//
// The gradient of the TPU kernel repro/kernels/rmsnorm.py:25 `rmsnorm`
// (y = x * r * scale, r = rsqrt(mean(x^2) + eps), in fp32, cast to x's
// type).  The TPU kernel has no backward: the reference trains through
// `apply_norm` and `rmsnorm` (repro/models/layers.py:29,42), which XLA
// differentiates; this kernel is the counterpart of that autodiff.  For a
// row of D values, with g = dy * scale,
//
//   dx     = r * g - x * r^3 * sum(g * x) / D      (in x's type)
//   dscale = sum over rows of dy * x * r           (fp32)
//
// with every sum in fp32.
//
// Bound on the H100: bytes.  The function reads x and dy once and writes dx
// once, 3 * rows * D * sizeof(T) bytes plus 8 D for scale and dscale; at
// 3.35 TB/s the [2048, 2560] bf16 call of qwen3-4b's ln1/ln2 needs 9.4 us
// and the [65536, 128] one of its q-norm 15.0 us.  About 10 flops an
// element are far below the card's rate.
//
// Design: a team of `tpr` threads owns a row, as in the forward's `vec`
// kernel; every access is W values wide (16 bytes: 8 bf16 or 4 fp32 when D
// and the pointers allow, else one value).  A first walk over the row sums
// x^2 and g * x (warp shuffles within the team, shared memory across its
// warps), a second writes dx (the row is read twice; the second read comes
// from L1/L2).  dscale is a sum over rows, and it is reduced without
// atomics, so two runs give equal bits: each team adds dy * x * r for its
// rows into its own row of a shared-memory array (each thread only to its
// own columns), the block sums its teams in team order into one fp32
// partial row in device memory, and a second kernel sums the partials over
// blocks in a fixed order.  The grid is at most two blocks a streaming
// multiprocessor, so the partials stay small (2.7 MB at D = 2560).
//
// The wrapper (kernels/rmsnorm.py, `rmsnorm_bwd`) allocates dx, dscale and
// the partials (`rmsnorm_bwd_parts` blocks of D floats) with torch.empty.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;  // threads a block of the row kernel

// W values of type T at p (16-byte aligned when W > 1), as fp32.
template <typename T, int W>
__device__ __forceinline__ void load(const T* p, float (&f)[W]) {
  if constexpr (W == 1) {
    f[0] = to_float(*p);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(W == 4, "fp32 vectors hold 4 values");
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  } else {
    static_assert(W == 8, "bf16 vectors hold 8 values");
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = t.x, f[2 * i + 1] = t.y;
    }
  }
}

// W fp32 values of the scale at p (16-byte aligned when W > 1).
template <int W>
__device__ __forceinline__ void load_scale(const float* p, float (&f)[W]) {
  if constexpr (W == 1) {
    f[0] = __ldg(p);
  } else {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
      f[4 * i] = v.x, f[4 * i + 1] = v.y, f[4 * i + 2] = v.z, f[4 * i + 3] = v.w;
    }
  }
}

// W values to p as T, rounded to nearest even.
template <typename T, int W>
__device__ __forceinline__ void store(T* p, const float (&f)[W]) {
  if constexpr (W == 1) {
    *p = from_float<T>(f[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// tpr: threads a row, a power of two up to NT; blockDim.x == NT.
template <typename T, int W>
__global__ void __launch_bounds__(NT) rmsnorm_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ scale, const T* __restrict__ dy,
    T* __restrict__ dx, float* __restrict__ partial, long long rows, int d, int tpr, float eps) {
  extern __shared__ float acc[];   // [teams][d]: each team's dscale sums
  __shared__ float red[2][NT / 32];  // per-warp sums, for teams wider than a warp
  const int teams = NT / tpr;
  const int team = threadIdx.x / tpr, t = threadIdx.x % tpr;
  const int nvec = d / W;
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
      for (int c = t; c < nvec; c += tpr) {
        float xv[W], gv[W], sv[W];
        load<T, W>(x + off + c * W, xv);
        load<T, W>(dy + off + c * W, gv);
        load_scale<W>(scale + c * W, sv);
#pragma unroll
        for (int e = 0; e < W; ++e) {
          ss = fmaf(xv[e], xv[e], ss);
          dot = fmaf(gv[e] * sv[e], xv[e], dot);
        }
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
    for (int c = t; c < nvec; c += tpr) {
      float xv[W], gv[W], sv[W], o[W];
      load<T, W>(x + off + c * W, xv);
      load<T, W>(dy + off + c * W, gv);
      load_scale<W>(scale + c * W, sv);
#pragma unroll
      for (int e = 0; e < W; ++e) {
        o[e] = fmaf(r, gv[e] * sv[e], -k * xv[e]);
        mine[c * W + e] += gv[e] * xv[e] * r;
      }
      store<T, W>(dx + off + c * W, o);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < d; i += NT) {  // the block's partial: its teams in order
    float s = 0.f;
    for (int tm = 0; tm < teams; ++tm) s += acc[tm * d + i];
    partial[(long long)blockIdx.x * d + i] = s;
  }
}

// dscale[c] = the sum of partial[p][c] over p, in a fixed order: warp w of a
// block sums parts w, w + 8, ... of 32 columns, then the 8 sums in order.
__global__ void __launch_bounds__(256) rmsnorm_bwd_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ dscale, int parts, int d) {
  __shared__ float s[8][33];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  float a = 0.f;
  if (c < d)
    for (int p = w; p < parts; p += 8) a += partial[(long long)p * d + c];
  s[w][lane] = a;
  __syncthreads();
  if (w == 0 && c < d) {
    float tot = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) tot += s[i][lane];
    dscale[c] = tot;
  }
}

int sm_count() {
  int dev = 0, count = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return count;
}

// Threads a row for W-wide accesses: the smallest power of two that covers
// the row's vectors, at most NT.
int team_size(int d, int w) {
  const int nvec = d / w;
  int tpr = 1;
  while (tpr < nvec && tpr < NT) tpr *= 2;
  return tpr;
}

long long grid_size(long long rows, int d, int w) {
  const int teams = NT / team_size(d, w);
  const long long need = (rows + teams - 1) / teams;
  const long long cap = 2LL * sm_count();
  return need < cap ? need : cap;
}

template <typename T, int W>
cudaError_t launch(const void* x, const void* scale, const void* dy, void* dx, void* dscale,
                   void* partial, long long rows, int d, float eps, cudaStream_t stream) {
  const int tpr = team_size(d, W);
  const long long grid = grid_size(rows, d, W);
  const int smem = (NT / tpr) * d * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rmsnorm_bwd_kernel<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  rmsnorm_bwd_kernel<T, W><<<(unsigned)grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<float*>(partial), rows, d, tpr, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_reduce_kernel<<<(d + 31) / 32, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(dscale), (int)grid, d);
  return cudaGetLastError();
}

constexpr int MAX_D = 16 * 1024;

}  // namespace

// The number of partial rows of D floats that rmsnorm_bwd needs for these
// arguments (its grid), or -1 if it would refuse them.
extern "C" long long rmsnorm_bwd_parts(int dtype, int vec, long long rows, int d) {
  if (rows < 1 || d < 1 || d > MAX_D || (dtype != kFloat32 && dtype != kBFloat16)) return -1;
  const int w = vec ? (dtype == kFloat32 ? 4 : 8) : 1;
  if (d % w) return -1;
  return grid_size(rows, d, w);
}

// x, dy, dx: [rows, d] of `dtype` (DTypeCode), contiguous; scale, dscale:
// [d] fp32; partial: rmsnorm_bwd_parts(...) * d fp32.  `vec` 1 takes
// 16-byte accesses and needs d a multiple of 16 / sizeof(dtype) and x, dy,
// dx and scale 16-byte aligned; `vec` 0 takes one value at a time.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int rmsnorm_bwd(int dtype, int vec, const void* x, const void* scale, const void* dy,
                           void* dx, void* dscale, void* partial, long long rows, int d,
                           float eps, void* stream) {
  if (rmsnorm_bwd_parts(dtype, vec, rows, d) < 1) return cudaErrorInvalidValue;
  if (vec && (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy) |
              reinterpret_cast<uintptr_t>(dx) | reinterpret_cast<uintptr_t>(scale)) % 16)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return vec ? launch<float, 4>(x, scale, dy, dx, dscale, partial, rows, d, eps, s)
               : launch<float, 1>(x, scale, dy, dx, dscale, partial, rows, d, eps, s);
  return vec ? launch<__nv_bfloat16, 8>(x, scale, dy, dx, dscale, partial, rows, d, eps, s)
             : launch<__nv_bfloat16, 1>(x, scale, dy, dx, dscale, partial, rows, d, eps, s);
}

extern "C" const char* rmsnorm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
