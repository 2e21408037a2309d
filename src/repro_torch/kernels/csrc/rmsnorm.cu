// Fused RMSNorm forward for Hopper (sm_90a): two variants of one function.
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py:25 `rmsnorm`
// (body `_rmsnorm_kernel`): y = x * rsqrt(mean(x^2) + eps) * scale, row by
// row, in fp32, cast back to x's type.  x is [rows, D]; scale is [D] fp32.
//
// Bound on the H100: bytes.  The function must read each row once and
// write it once, 2 * rows * D * sizeof(T) + 4 * D bytes; at 3.35 TB/s a
// [2048, 2560] bf16 call needs 6.3 us and a [65536, 128] one 10.0 us.  Its
// 3 flops per element are far below the card's rate, so the design is about
// bytes in flight: full 16-byte accesses, and enough rows at once.
//
// `vec` (rmsnorm_vec_fwd; the wrapper's variant "vector"): every access is
// 16 bytes, 8 bf16 or 4 fp32 values.  A team of `tpr` threads owns a row;
// thread t holds vectors t, t + tpr, ... of it in registers (NV at most, a
// template argument sized to the row), so a row is read from device memory
// once and written once, and neighbouring threads touch neighbouring 16-byte
// vectors.  `scale` is copied once a block into shared memory in 16-byte
// pieces by cp.async, issued before the first row's loads and waited for
// only before its output, so its latency hides under the row's; every row
// then reads it from there.  The team is sized to the row so that the sum
// of squares needs warp shuffles only, with no shared memory and no block
// barrier: D = 128 bf16 (16 vectors, qk-norm) takes 16 threads, two rows a
// warp; D = 1024, 2048 and 2560 bf16 take one warp a row, 4, 8 and 10
// vectors a thread.  Only rows wider than 512 vectors (D > 4096 bf16,
// D > 2048 fp32) span several warps and combine them through shared memory.
// Blocks of 8 warps walk the rows in a grid-stride loop over a grid of at
// most one full load of blocks a streaming multiprocessor; when there are
// too few rows to give every SM a block (decode: 4 or 128 rows), blocks
// shrink, down to one warp, so the rows spread over as many SMs as they can.
//
// `scalar` (rmsnorm_scalar_fwd; variant "scalar"): the first design, kept
// for rows that cannot take 16-byte vectors (D not a multiple of the
// vector, or x or scale not 16-byte aligned).  A team of `tpr` threads (a
// multiple of 32) holds the row in registers, at most VPT values a thread,
// reads and writes element by element (coalesced), and reduces with warp
// shuffles and, across the team's warps, shared memory.
//
// The wrapper (kernels/rmsnorm.py, `variant`) routes by D and alignment;
// every call on the served models' paths takes `vec`.

#include <stdint.h>

#include "common.cuh"

namespace {

// ------------------------------------------------------------------ vector

// Sum of squares of one 16-byte vector, in fp32.
__device__ __forceinline__ float sumsq(const uint4& v, float) {
  const float a = __uint_as_float(v.x), b = __uint_as_float(v.y);
  const float c = __uint_as_float(v.z), d = __uint_as_float(v.w);
  return fmaf(a, a, fmaf(b, b, fmaf(c, c, d * d)));
}
__device__ __forceinline__ float sumsq(const uint4& v, __nv_bfloat16) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    s = fmaf(f.x, f.x, fmaf(f.y, f.y, s));
  }
  return s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// (x * r) * scale for one vector; `s` points at its scale values in shared memory.
__device__ __forceinline__ uint4 normed(const uint4& v, const float4* s, float r, float) {
  const float4 k = s[0];
  uint4 o;
  o.x = __float_as_uint(__uint_as_float(v.x) * r * k.x);
  o.y = __float_as_uint(__uint_as_float(v.y) * r * k.y);
  o.z = __float_as_uint(__uint_as_float(v.z) * r * k.z);
  o.w = __float_as_uint(__uint_as_float(v.w) * r * k.w);
  return o;
}
__device__ __forceinline__ uint4 normed(const uint4& v, const float4* s, float r, __nv_bfloat16) {
  const float4 k0 = s[0], k1 = s[1];
  const float k[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    // round to nearest even, as torch casts
    const __nv_bfloat162 b = __floats2bfloat162_rn(f.x * r * k[2 * i], f.y * r * k[2 * i + 1]);
    o[i] = *reinterpret_cast<const uint32_t*>(&b);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// NV: vectors a thread holds at most.  tpr: threads a row, a power of two
// up to 256; up to 32 the team lies in one warp.  blockDim.x (at most 256)
// is a multiple of tpr.
template <typename T, int NV>
__global__ void __launch_bounds__(256) rmsnorm_vec_kernel(
    const T* __restrict__ x, const float* __restrict__ scale, T* __restrict__ out,
    long long rows, int d, int tpr, float eps) {
  constexpr int E = 16 / sizeof(T);  // values a vector
  extern __shared__ float4 scale_s[];  // [d / 4]
  __shared__ float partial[32];      // one sum per warp, for rows wider than a warp
  const int nvec = d / E;
  const int rpb = blockDim.x / tpr;
  const int team = threadIdx.x / tpr, t = threadIdx.x % tpr;
  for (int i = threadIdx.x; i < d / 4; i += blockDim.x)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(scale_s + i)),
                 "l"(scale + 4 * i)
                 : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  bool first = true;  // every block runs at least one row
  for (long long base = (long long)blockIdx.x * rpb; base < rows;
       base += (long long)gridDim.x * rpb) {  // the same trip count for the whole block
    const long long row = base + team;
    const bool live = row < rows;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (live ? row : 0) * d);
    uint4 v[NV];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = t + i * tpr;
      v[i] = (live && c < nvec) ? __ldg(xr + c) : make_uint4(0u, 0u, 0u, 0u);
      ss += sumsq(v[i], T());
    }
    if (tpr <= 32) {  // uniform: the team is tpr lanes of one warp
      for (int off = tpr / 2; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    } else {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
      if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = ss;
      __syncthreads();
      const int wpt = tpr / 32;
      ss = 0.f;
      for (int w = 0; w < wpt; ++w) ss += partial[team * wpt + w];
      __syncthreads();  // every read of `partial` is done before the next row's writes
    }
    if (first) {  // uniform: the scale has landed for the whole block
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      first = false;
    }
    if (!live) continue;
    const float r = rsqrtf(ss / (float)d + eps);
    uint4* orow = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = t + i * tpr;
      if (c < nvec) orow[c] = normed(v[i], scale_s + c * (E / 4), r, T());
    }
  }
}

int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return count[dev];
}

template <typename T, int NV>
cudaError_t launch_vec_nv(const void* x, const void* scale, void* out, long long rows, int d,
                          int tpr, float eps, cudaStream_t stream) {
  const int nsm = sm_count();
  int block = 256;
  // Few rows: smaller blocks, so that they land on more SMs.
  while (block > 32 && block > tpr && (rows * tpr + block - 1) / block < nsm) block /= 2;
  const int rpb = block / tpr;
  const long long need = (rows + rpb - 1) / rpb;
  const long long cap = (long long)nsm * (2048 / block);
  const long long grid = need < cap ? need : cap;
  const int smem = d * (int)sizeof(float);  // the scale
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rmsnorm_vec_kernel<T, NV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  rmsnorm_vec_kernel<T, NV><<<(unsigned)grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<T*>(out), rows, d,
      tpr, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_vec(const void* x, const void* scale, void* out, long long rows, int d,
                       float eps, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const int nvec = d / E;
  int tpr = 1;
  if (nvec <= 32) {
    while (tpr < nvec) tpr *= 2;  // one vector a thread, a power-of-two team
  } else {
    tpr = 32;
    while (tpr * 16 < nvec) tpr *= 2;  // at most 16 vectors a thread
  }
  if (tpr > 256) return cudaErrorInvalidValue;  // d > 32768 bf16 or 16384 fp32
  const int nv = (nvec + tpr - 1) / tpr;
#define RMS_CASE(N) \
  if (nv <= N) return launch_vec_nv<T, N>(x, scale, out, rows, d, tpr, eps, stream);
  RMS_CASE(1) RMS_CASE(2) RMS_CASE(3) RMS_CASE(4) RMS_CASE(5) RMS_CASE(6) RMS_CASE(8)
  RMS_CASE(10) RMS_CASE(12) RMS_CASE(16)
#undef RMS_CASE
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------------ scalar

constexpr int VPT = 16;     // values a thread keeps in registers
constexpr int BLOCK = 256;  // threads a block aims at when rows are narrow

template <typename T>
__global__ void __launch_bounds__(1024) rmsnorm_scalar_kernel(
    const T* __restrict__ x, const float* __restrict__ scale, T* __restrict__ out,
    long long rows, int d, int tpr, float eps) {
  __shared__ float partial[32];  // one sum per warp of the block
  const int team = threadIdx.x / tpr;
  const int t = threadIdx.x % tpr;
  const long long row = (long long)blockIdx.x * (blockDim.x / tpr) + team;
  const bool live = row < rows;
  const T* xr = x + (live ? row : 0) * d;

  float v[VPT];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = t + i * tpr;
    v[i] = (live && c < d) ? to_float(xr[c]) : 0.f;
    ss = fmaf(v[i], v[i], ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (tpr > 32) {  // uniform across the block: combine the team's warps
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) partial[warp] = ss;
    __syncthreads();
    const int wpt = tpr / 32;
    ss = 0.f;
    for (int w = 0; w < wpt; ++w) ss += partial[team * wpt + w];
  }
  if (!live) return;

  const float r = rsqrtf(ss / (float)d + eps);
  T* orow = out + row * d;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = t + i * tpr;
    if (c < d) orow[c] = from_float<T>(v[i] * r * scale[c]);
  }
}

template <typename T>
cudaError_t launch_scalar(const void* x, const void* scale, void* out, long long rows, int d,
                          float eps, cudaStream_t stream) {
  const int tpr = ((d + VPT - 1) / VPT + 31) / 32 * 32;
  const int rows_per_block = tpr >= BLOCK ? 1 : BLOCK / tpr;
  const long long grid = (rows + rows_per_block - 1) / rows_per_block;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  rmsnorm_scalar_kernel<T><<<(unsigned)grid, tpr * rows_per_block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<T*>(out),
      rows, d, tpr, eps);
  return cudaGetLastError();
}

}  // namespace

// x, out: [rows, d] of `dtype` (DTypeCode), contiguous; scale: [d] fp32.
// rmsnorm_vec_fwd also needs d a multiple of 16 / sizeof(dtype) and x, out
// and scale 16-byte aligned.  Each returns the cudaError_t of the launch (0
// on success).
extern "C" int rmsnorm_vec_fwd(int dtype, const void* x, const void* scale, void* out,
                               long long rows, int d, float eps, void* stream) {
  const int e = dtype == kFloat32 ? 4 : 8;
  if (rows < 1 || d < 1 || d > VPT * 1024 || d % e ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(scale) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch_vec<float>(x, scale, out, rows, d, eps, s);
    case kBFloat16: return launch_vec<__nv_bfloat16>(x, scale, out, rows, d, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int rmsnorm_scalar_fwd(int dtype, const void* x, const void* scale, void* out,
                                  long long rows, int d, float eps, void* stream) {
  if (rows < 1 || d < 1 || d > VPT * 1024) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch_scalar<float>(x, scale, out, rows, d, eps, s);
    case kBFloat16: return launch_scalar<__nv_bfloat16>(x, scale, out, rows, d, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
