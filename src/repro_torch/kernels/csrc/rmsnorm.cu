// Fused RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py:25 `rmsnorm`
// (body `_rmsnorm_kernel`): y = x * rsqrt(mean(x^2) + eps) * scale, row by
// row, in fp32, cast back to x's type.  x is [rows, D]; scale is [D] fp32.
//
// Bound on the H100: bytes.  The function must read each row once and
// write it once, 2 * rows * D * sizeof(T) + 4 * D bytes; at 3.35 TB/s a
// [2048, 2560] bf16 call needs 6.3 us.  Its 3 flops per element are far
// below the card's rate.
//
// Design: a team of `tpr` threads (a multiple of 32) owns one row and holds
// it in registers, at most VPT values a thread, so each row is read from
// device memory once, reduced with warp shuffles (and through shared memory
// across the team's warps when the row is wider than 32 * VPT), scaled and
// written once.  Neighbouring threads touch neighbouring elements, so every
// load and store is coalesced.  Narrow rows (qk-norm, D = 128) get one warp a
// row and eight rows a 256-thread block, so no block idles on a short row;
// D = 2560 gets 160 threads (five warps) for its row.  Any row count works:
// the last block masks the rows past the end.

#include "common.cuh"

namespace {

constexpr int VPT = 16;     // values a thread keeps in registers
constexpr int BLOCK = 256;  // threads a block aims at when rows are narrow

template <typename T>
__global__ void __launch_bounds__(1024) rmsnorm_kernel(
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
cudaError_t launch(const void* x, const void* scale, void* out, long long rows, int d,
                   float eps, cudaStream_t stream) {
  const int tpr = ((d + VPT - 1) / VPT + 31) / 32 * 32;
  const int rows_per_block = tpr >= BLOCK ? 1 : BLOCK / tpr;
  const long long grid = (rows + rows_per_block - 1) / rows_per_block;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  rmsnorm_kernel<T><<<(unsigned)grid, tpr * rows_per_block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale), static_cast<T*>(out),
      rows, d, tpr, eps);
  return cudaGetLastError();
}

}  // namespace

// x, out: [rows, d] of `dtype` (DTypeCode), contiguous; scale: [d] fp32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int rmsnorm_fwd(int dtype, const void* x, const void* scale, void* out,
                           long long rows, int d, float eps, void* stream) {
  if (rows < 1 || d < 1 || d > VPT * 1024) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32: return launch<float>(x, scale, out, rows, d, eps, s);
    case kBFloat16: return launch<__nv_bfloat16>(x, scale, out, rows, d, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
