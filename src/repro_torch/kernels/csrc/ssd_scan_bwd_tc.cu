// The gradient of the Mamba-2 SSD chunked scan for Hopper (sm_90a) on the
// tensor cores, bf16: the `tc` variant of `ssd_scan_bwd`
// (kernels/ssd_scan.py, `bwd_variant`), which routes fp32, and the bf16
// inputs this kernel does not take (see the end of this note), to the
// CUDA-core kernel of ssd_scan_bwd.cu (`simt`).
//
// The gradient of the TPU kernel repro/kernels/ssd_scan.py:65 `ssd_scan`,
// which the reference takes by XLA autodiff of its jnp path (`ssd_chunked`).
// For each (batch, head), group g = h / (H / G), the forward is
//
//   state_t = state_{t-1} * exp(dt_t A_h) + dt_t x_t B_t^T      [P, N]
//   y_t     = C_t . state_t                                      [P]
//
// and this kernel takes dy [B, S, H, P] (y's cotangent) and dstate [B, H,
// P, N] fp32 (the final state's; zeros in training).  By chunks of L = 64
// steps, with cum = cumsum(dt A) within the chunk, decay_ts = exp(cum_t -
// cum_s) for s <= t (0 above), Lm = C B^T o decay, Pd = dy (x dt)^T, W = Pd o
// decay, M = Lm o Pd, e = exp(cum), dec = exp(cum_last - cum), S_in the state
// entering the chunk and dS the gradient of the one leaving it:
//
//   d(x dt) = Lm^T dy + dec o (B dS^T)
//   dC      = W B + e o (dy S_in)
//   dB      = W^T C + dec o ((x dt) dS)
//   d(dt A)_s = sum_{t >= s > u} M_tu + sum_{t >= s} e_t C_t . (S_in^T dy_t)
//               + exp(cum_last) <dS, S_in> + sum_{t < s} (x dt)_t . (dec_t (B dS^T)_t)
//
// then dx = dt d(x dt), ddt = x . d(x dt) + A d(dt A), dA = sum dt d(dt A),
// and dB, dC summed over the heads of a group (ssd_scan.py's
// `ssd_scan_bwd_plain` forms the same four sums of d(dt A), none of which
// cancels).  The only dependence between chunks is the [P, N] state carried
// across them, two linear recurrences:
//
//   S_in[c + 1] = exp(cum_last[c]) S_in[c] + x[c]^T (B[c] o dt exp(cum_last - cum))
//   dS[c - 1]   = exp(cum_last[c]) dS[c] + dy[c]^T (C[c] o exp(cum))
//
// with S_in[0] = 0 and dS[last] = dstate.  Everything else of a chunk depends
// on its own inputs, S_in[c] and dS[c] alone.
//
// Bound on the H100, at mamba2-370m's training shape (B4 S2048 H32 P64 G1
// N128 bf16): bytes.  The function reads x, dt, A, B, C, dy and dstate once
// and writes dx, ddt, dA, dB and dC once, 114.3 MB, 34.1 us at 3.35 TB/s; its
// operations (ssd_scan.py `bwd_flops`) are 30.2 GFLOP, 30.5 us at the bf16
// tensor-core rate.
//
// Design: two kernels, both on the tensor cores (mma.sync m16n8k16, bf16 in,
// fp32 sums), whose copies go through the bulk copy engine (cp.async.bulk,
// completing on an mbarrier): a row or a plane an instruction, since 16-byte
// cp.async requests, a few thousand a chunk, stalled their issue.
//   1. The state passes (ssd_bwd_state_kernel).  Rows of the two states are
//      independent (row p needs only x[:, p] or dy[:, p]), so a block of 8
//      warps owns PS = 64 rows of one (batch, head)'s state in one direction
//      and walks the chunks with them in fp32 registers, as the forward tc
//      kernel walks its state: warp w owns columns 16 w .. 16 w + 15 of N.
//      Forward (x, B) from the first chunk, reverse (dy, C) from the last:
//      B H ceil(P / PS) 2 blocks, 256 at the training shape, two to an SM
//      (88.6 KB of shared memory at N 128: two stages of the chunk's [L, PS]
//      x or dy and [L, N] B or C, the staging tile, the scale factors).
//      Before each chunk's update the block writes the state it holds, the
//      one that enters chunk c (forward) or leaves it (reverse), as hi and
//      lo planes: stmatrix into the staging tile, then one bulk store of
//      each plane's rows.
//   2. The chunk pass (ssd_bwd_chunk_kernel).  A block for each (chunk,
//      batch, group, slice of the group's heads): 256 blocks at the training
//      shape (two slices of 16 heads, the wrapper's `bwd_slices`), one to an
//      SM.  It loads the chunk's B and C and computes C B^T once, then walks
//      its heads, each head's rows of x and dy and the two states' planes
//      (one bulk copy a state: the state passes store each plane with the
//      tile's padded row stride) arriving in the second of two stages while
//      the first is in use, where they fit (P <= 64):
//        - warps 0-3 own chunk rows 8 w + g and 56 - 8 w + g (so that each
//          has the same share of the lower triangle) and compute dy x^T on
//          the triangle, then Lm, Pd, W and M in fp32 registers; they write
//          Lm and W in bf16 to shared memory and, by 4-lane scans and 8-lane
//          sums, each row's exclusive prefix of M summed over rows t >= s;
//          warps 4-7 meanwhile compute <dS, S_in>;
//        - then warp w owns rows 16 (w % 4) .. + 15 and half of the 16-column
//          pairs of dC, dB (of N) and d(x dt) (of P): dC += W B + e o (dy
//          S_in), dB += W^T C + dt dec o (x dS), summed over the block's
//          heads in fp32 registers, and d(x dt) = Lm^T dy + dec o (B dS^T),
//          with dx, x . d(x dt), (x dt) . (dec B dS^T) and C . (dy S_in), k
//          outermost so that the pairs' products are independent; the
//          transposed operands (W^T, Lm^T, and B, C, dy, S_in, dS as second
//          operands along their rows) are read by ldmatrix.trans, no copy;
//        - warp 0 adds the four sums of d(dt A) by scans over the chunk and
//          writes ddt and the head's dA term for the chunk.
//      Shared memory: 231,968 B at P 64 N 128 (two stages) and 229,920 B at
//      P = N = 128 (one stage), of the 232,448 B a block may have.
//
// Where bf16 rounding happens.  x, B, C and dy enter the products exactly as
// given, and dt is folded into fp32 factors after the products, never into a
// rounded x dt.  Three operands are rounded to bf16, once each, as the
// second operands of the chunk pass's products: Lm (before Lm^T dy), W
// (before W B and W^T C) and dS before x dS (dB's term; dB feeds no sum of
// d(dt A)).  Elsewhere the states are not rounded: the scaled operands of the
// state passes (B o dt exp(cum_last - cum), C o exp(cum)) and the stored S_in
// and dS are split into a bf16 hi part (the value rounded) and a bf16 lo part
// (the rest rounded), each product taken twice, which keeps about 16 of fp32's
// 24 bits.  A single rounding of them moved dA by up to 3e-2 of its max
// against jax.vjp in the CPU emulation (tests/test_torch_ssd_bwd.py), where
// the split keeps it near 1e-4: dA sums over every step and chunk terms that
// largely cancel.  cum, every exp, the decay and dt factors, the carried
// states, C B^T, dy x^T, Lm, Pd, W and M before their rounding, and every sum
// (the products' accumulators, the d(dt A) terms and scans, <dS, S_in> from
// the hi + lo values, dB and dC over the heads) are fp32.  The plain version
// is fp32 throughout; the kernel is held to it at 2e-2 of each output's max.
//
// Sums in a fixed order, no floating-point atomics: shuffles over fixed lanes,
// one shared-memory slot per warp or row group summed in order, dB and dC over
// a block's heads in turn; the wrapper sums dA over batch and chunks and dB,
// dC over the slices with `sum`s over fixed axes.  Two calls give the same
// bits.
//
// Scratch, which the wrapper allocates: the states as hi and lo planes, bf16
// [2 (S_in, dS)][B][H][chunks][2][P16][N16 + 8] (P and N rounded up to 16,
// rows padded as the tiles' are), 285 MB at the training shape, written once
// and read once (the simt kernel writes 134 MB of fp32 entry states and
// reads them back, and 268 MB of per-head dB and dC); dA's terms fp32
// [B][H][chunks]; dB and dC fp32 [2][slices][B][S][G][N], 16.8 MB.
//
// Padded steps: steps past S load as 0 (dt = 0 makes them exact no-ops, dy =
// 0 gives them no gradient) and are not written.  Needs bf16 with P and N
// multiples of 8 up to 128, 16-byte aligned x, B, C and dy, and batch and
// sequence strides of x, B and C that are multiples of 8 elements (dy is
// contiguous); the launcher refuses anything else.  It allocates nothing and
// does not synchronise, so the launches are legal inside a CUDA graph capture.

#include <stdint.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;     // threads a block, both kernels: 8 warps
constexpr int L = 64;       // steps a chunk
constexpr int PS = 64;      // state rows a block of the state passes owns
constexpr int US = PS + 8;  // row stride of the state passes' x or dy tile, in bf16
constexpr int LWS = 2 * L + 8;  // row stride of the [L][Lm | W] tile, in bf16
constexpr int MAXD = 128;   // largest P and N

__host__ __device__ constexpr int pad16(int d) { return (d + 15) / 16 * 16; }
// Row stride (bf16) of a tile of d16 columns (d rounded up to 16): 16-byte
// rows, an odd number of 16-byte units (the 8 rows an ldmatrix reads fall in
// distinct banks) and 4 words mod 32 between rows (an mma fragment's (row g,
// word t) loads are conflict-free).
__host__ __device__ constexpr int row_stride(int d16) { return d16 + 8; }

size_t state_smem_bytes(int N) {
  const size_t ns = row_stride(pad16(N));
  return (2 * ((size_t)L * US + L * ns) + 2 * PS * ns) * sizeof(bf16)  // U, V twice; staging
         + 2 * (L + 4) * sizeof(float) + 2 * sizeof(uint64_t);
}

// The chunk pass's shared memory with `stages` stages of the per-head tiles.
size_t chunk_smem_bytes(int P, int N, int stages) {
  const size_t pp = pad16(P), ns = row_stride(pad16(N)), xs = row_stride(pp);
  const size_t head = 2 * L * xs + 4 * pp * ns;  // x, dy, S_in hi/lo, dS hi/lo
  return (2 * L * ns + stages * head + L * LWS) * sizeof(bf16)  // + B, C, Lm | W
         + (4 * L + 4 * L + 6 * L + 4) * sizeof(float) + 2 * sizeof(uint64_t);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronously; `bytes` 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// The bulk copy engine (TMA without a tensor map): whole rows or planes
// between global and shared memory, one instruction each, loads completing
// on an mbarrier that expects their bytes.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// The one arrival of the barrier's phase, which then waits for `bytes` more.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait for the phase of parity `parity` to complete.  The spin is bounded: a
// copy that never lands traps, an error the launch's caller sees, and does
// not hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (long long i = 0; i < (1ll << 28) && !done; ++i)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  if (!done) __trap();
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// The bulk stores issued by this thread have read their shared memory (`read`)
// or are complete.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Order this thread's generic-proxy accesses of shared memory before later
// bulk copies (the async proxy).
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Four 8x8 bf16 matrices, transposed: lanes 8i..8i+7 give the row addresses
// of matrix i; r[i] gets matrix i's elements (2 (lane % 4), lane / 4) and
// (2 (lane % 4) + 1, lane / 4).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
// Four 8x8 bf16 matrices as stored: r[i] gets matrix i's elements (lane / 4,
// 2 (lane % 4)) and (lane / 4, 2 (lane % 4) + 1).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
// Four 8x8 bf16 matrices from fragments to shared memory, the inverse of
// ldsm_x4: lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void stsm_x4(bf16* p, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1,%2,%3,%4};\n"
               ::"r"(smem_u32(p)), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}
// d += a b, bf16 in, fp32 sum: a 16x16 (row), b 16x8 (col), d 16x8.
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
__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
// Two fp32 values as bf16 pairs hi (the values rounded) and lo (the rest rounded).
__device__ __forceinline__ void split(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  hi = pack(v0, v1);
  const float2 h = unpack(hi);
  lo = pack(v0 - h.x, v1 - h.y);
}
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// Warp 0's scan of dt A over a chunk, in fp32: lane l holds steps 2l and
// 2l + 1, with dt d0 and d1; returns cum at both steps and the last.
__device__ __forceinline__ void scan_cum(float d0, float d1, float a, float& c0, float& c1,
                                         float& last) {
  const int lane = threadIdx.x % 32;
  const float v0 = d0 * a, v1 = d1 * a;
  float run = v0 + v1;  // becomes the inclusive prefix of the lanes' pair sums
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, run, off);
    if (lane >= off) run += o;
  }
  float before = __shfl_up_sync(0xffffffffu, run, 1);
  if (lane == 0) before = 0.f;
  c0 = before + v0;
  c1 = c0 + v1;
  last = __shfl_sync(0xffffffffu, c1, 31);
}

// ------------------------------------------------------------ state passes
// Block (p slice, head, 2 batch + direction).  Direction 0 carries S_in from
// the first chunk with U = x and V = B o dt exp(cum_last - cum); direction 1
// carries dS from the last chunk, starting at dstate, with U = dy and V = C o
// exp(cum).  Each chunk: the state held is written to its slot of `states`
// as hi and lo planes, then updated to state exp(cum_last) + U^T V.
__global__ void __launch_bounds__(NT, 2) ssd_bwd_state_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dt, const bf16* __restrict__ A,
    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
    const float* __restrict__ dstate, bf16* __restrict__ states, int Bn, int S, int H, int G,
    int P, int N, long long xsb, long long xss, long long dsb, long long dss, long long bsb,
    long long bss, long long csb, long long css) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pp = pad16(P), np = pad16(N), ns = row_stride(np);
  const int stage_elems = L * US + L * ns;
  bf16* stages = reinterpret_cast<bf16*>(smem);  // stage s: U [L][US], V [L][ns]
  bf16* staging = stages + 2 * stage_elems;      // [2][PS][ns]: the state's hi and lo
  float* scal = reinterpret_cast<float*>(staging + 2 * PS * ns);  // [2][L + 4]
  uint64_t* bar = reinterpret_cast<uint64_t*>(scal + 2 * (L + 4));  // [2]: a stage's copies

  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int g = lane / 4, tq = lane % 4;
  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z / 2, dir = blockIdx.z % 2;
  const int grp = h / (H / G);
  const float a = to_float(A[h]);
  const int nc = (S + L - 1) / L, nk = np / 16;
  const int ucols = min(PS, P - p0);  // columns of U (rows of the state) that exist
  const bf16 *ub, *vb;
  long long uss, vss;
  if (dir == 0) {
    ub = x + b * xsb + (long long)h * P + p0;
    uss = xss;
    vb = Bm + b * bsb + (long long)grp * N;
    vss = bss;
  } else {  // dy is contiguous [B, S, H, P]
    ub = dy + ((long long)b * S * H + h) * P + p0;
    uss = (long long)H * P;
    vb = Cm + b * csb + (long long)grp * N;
    vss = css;
  }
  const bf16* db = dt + b * dsb + h;

  // Columns past P or N stay zero in both stages; rows past S are zeroed
  // where a chunk has them.
  for (int e = tid; e < stage_elems; e += NT) reinterpret_cast<uint32_t*>(stages)[e] = 0u;
  fence_async();
  if (tid == 0) {
    mbar_init(bar);
    mbar_init(bar + 1);
  }
  __syncthreads();
  auto chunk_rows = [&](int c) { return min(L, S - c * L); };
  // Thread 0: stage s's barrier expects chunk c's bytes.
  auto expect = [&](int c, int s) {
    mbar_expect(bar + s, (uint32_t)chunk_rows(c) * (ucols + N) * sizeof(bf16));
  };
  // Chunk c's rows of U and V into stage s, a bulk copy of each row by one
  // thread; rows past S zeroed.
  auto load = [&](int c, int s) {
    const int c0 = c * L, rows = chunk_rows(c);
    bf16* U = stages + s * stage_elems;
    bf16* V = U + L * US;
    if (tid < L) {
      if (tid < rows) {
        fence_async();
        bulk_load(U + tid * US, ub + (c0 + tid) * uss, ucols * sizeof(bf16), bar + s);
      } else {
        for (int k = 0; k < PS / 8; ++k) *reinterpret_cast<uint4*>(U + tid * US + 8 * k) = uint4{};
        fence_async();
      }
    } else if (tid < 2 * L) {
      const int t = tid - L;
      if (t < rows) {
        fence_async();
        bulk_load(V + t * ns, vb + (c0 + t) * vss, N * sizeof(bf16), bar + s);
      } else {
        for (int k = 0; k < np / 8; ++k) *reinterpret_cast<uint4*>(V + t * ns + 8 * k) = uint4{};
        fence_async();
      }
    }
  };
  float dt0 = 0.f, dt1 = 0.f;  // warp 0: dt of steps 2 lane, 2 lane + 1 of the chunk to come
  auto load_dt = [&](int c) {
    const int t0 = c * L + 2 * lane;
    dt0 = t0 < S ? to_float(db[t0 * dss]) : 0.f;
    dt1 = t0 + 1 < S ? to_float(db[(t0 + 1) * dss]) : 0.f;
  };

  // The state: warp w owns columns 16 w .. 16 w + 15 of N (if they exist)
  // and the PS rows: st[m][hf] is the fp32 tile of rows 16 m + g and + 8,
  // columns 16 w + 8 hf + 2 tq and + 1.
  float st[PS / 16][2][4];
#pragma unroll
  for (int m = 0; m < PS / 16; ++m)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + 16 * m + g + (e / 2) * 8, n = 16 * w + 8 * hf + 2 * tq + e % 2;
        st[m][hf][e] = dir == 1 && w < nk && p < P && n < N
                           ? dstate[(((long long)b * H + h) * P + p) * N + n] : 0.f;
      }

  int c = dir ? nc - 1 : 0;
  if (tid == 0) expect(c, 0);
  __syncthreads();  // the expectation precedes the copies
  load(c, 0);
  if (w == 0) load_dt(c);
  const int lm_row = (lane / 8 % 2) * 8 + lane % 8, lm_col = lane / 16 * 8;
  const int srows = min(PS, pp - p0);  // rows of each plane this block writes
  for (int i = 0; i < nc; ++i) {
    const int s = i & 1;
    c = dir ? nc - 1 - i : i;
    const int cn = dir ? c - 1 : c + 1;  // the chunk after this one
    float* f = scal + s * (L + 4);       // the scale of V's rows, then exp(cum_last) at L
    if (w == 0) {
      float c0, c1, last;
      scan_cum(dt0, dt1, a, c0, c1, last);
      f[2 * lane] = dir ? expf(c0) : dt0 * expf(last - c0);
      f[2 * lane + 1] = dir ? expf(c1) : dt1 * expf(last - c1);
      if (lane == 0) f[L] = expf(last);
    }
    mbar_wait(bar + s, (i >> 1) & 1);  // chunk c's rows have landed
    if (tid == 0) {
      bulk_wait_read();  // the last chunk's stores have read the staging tile
      if (i + 1 < nc) expect(cn, s ^ 1);
    }
    __syncthreads();  // the scale is written; the other stage and the staging tile are free
    if (i + 1 < nc) {
      load(cn, s ^ 1);
      if (w == 0) load_dt(cn);
    }
    // The state held, the one entering chunk c (direction 0) or leaving it
    // (1), as hi and lo bf16 parts, by stmatrix into the staging tile, then
    // one bulk store of each plane's rows.
    if (w < nk) {
#pragma unroll
      for (int m = 0; m < PS / 16; ++m) {
        uint32_t hi[4], lo[4];  // matrices (rows +0, cols +0), (+8, +0), (+0, +8), (+8, +8)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split(st[m][q / 2][2 * (q % 2)], st[m][q / 2][2 * (q % 2) + 1], hi[q], lo[q]);
        bf16* t = staging + (16 * m + lm_row) * ns + 16 * w + lm_col;
        stsm_x4(t, hi);
        stsm_x4(t + PS * ns, lo);
      }
      fence_async();
    }
    __syncthreads();  // the staging tile is complete
    if (tid == 0) {
      bf16* out = states + (((((long long)dir * Bn + b) * H + h) * nc + c) * 2) * pp * ns +
                  (long long)p0 * ns;
      bulk_store(out, staging, srows * ns * sizeof(bf16));
      bulk_store(out + (long long)pp * ns, staging + PS * ns, srows * ns * sizeof(bf16));
    }
    if (i + 1 == nc || w >= nk) continue;
    // state = state exp(cum_last) + U^T V on this warp's 16 columns: U^T as
    // the A operand and V as the B operand, both by ldmatrix.trans; V's
    // fragments are scaled in fp32 and split into hi and lo, two products.
    const bf16* U = stages + s * stage_elems;
    const bf16* V = U + L * US;
    const float el = f[L];
#pragma unroll
    for (int m = 0; m < PS / 16; ++m)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[m][hf][e] *= el;
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      // scale of steps 16 kk + 2 tq, + 1 (fragment registers 0 and 2) and + 8, + 9 (1 and 3)
      const float2 fa = *reinterpret_cast<const float2*>(f + 16 * kk + 2 * tq);
      const float2 fb = *reinterpret_cast<const float2*>(f + 16 * kk + 8 + 2 * tq);
      uint32_t br[4], hi[4], lo[4];
      ldsm_x4_t(br, V + (16 * kk + lm_row) * ns + 16 * w + lm_col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 v = unpack(br[e]), sc = e % 2 ? fb : fa;
        split(v.x * sc.x, v.y * sc.y, hi[e], lo[e]);
      }
#pragma unroll
      for (int m = 0; m < PS / 16; ++m) {
        uint32_t r[4];
        ldsm_x4_t(r, U + (16 * kk + lm_row) * US + 16 * m + lm_col);
        // rows p 16 m + g and + 8 at steps 2 tq.. (r[0], r[2]) and 2 tq + 8.. (r[1], r[3])
        const uint32_t ua[4] = {r[0], r[2], r[1], r[3]};
        mma(st[m][0], ua, hi[0], hi[1]);
        mma(st[m][1], ua, hi[2], hi[3]);
        mma(st[m][0], ua, lo[0], lo[1]);
        mma(st[m][1], ua, lo[2], lo[3]);
      }
    }
  }
  if (tid == 0) bulk_wait();  // the stores are complete before the block ends
}

// ------------------------------------------------------------- chunk pass
// KP, KN: P and N rounded up to 64 or 128, the register tiles' extent (the
// loops stop at P and N rounded up to 16).  KP 64 keeps two stages of the
// per-head tiles in shared memory, KP 128 one.
template <int KP, int KN>
__global__ void __launch_bounds__(NT, 1) ssd_bwd_chunk_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dt, const bf16* __restrict__ A,
    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
    const bf16* __restrict__ states, bf16* __restrict__ dx, bf16* __restrict__ ddt,
    float* __restrict__ dA_part, float* __restrict__ dBC, int Bn, int S, int H, int G, int P,
    int N, int nsl, long long xsb, long long xss, long long dsb, long long dss, long long bsb,
    long long bss, long long csb, long long css) {
  constexpr int STAGES = KP <= 64 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int pp = pad16(P), np = pad16(N), xs = row_stride(pp), ns = row_stride(np);
  const int head_elems = 2 * L * xs + 4 * pp * ns;
  bf16* Bt = reinterpret_cast<bf16*>(smem);  // [L][ns]
  bf16* Ct = Bt + L * ns;                     // [L][ns]
  bf16* heads = Ct + L * ns;  // stage s: x [L][xs], dy [L][xs], S_in [2][pp][ns], dS [2][pp][ns]
  bf16* Lsm = heads + STAGES * head_elems;  // [L][LWS]: Lm in bf16, then W
  bf16* Wsm = Lsm + L;                      // W: columns L .. 2 L - 1 of the same rows
  float* cum = reinterpret_cast<float*>(Lsm + L * LWS);  // [L]
  float* dts = cum + L;                                 // [L]: dt
  float* ecum = dts + L;                                // [L]: exp(cum)
  float* dec = ecum + L;                                // [L]: exp(cum_last - cum)
  float* colpart = dec + L;  // [4][L]: warp w's rows' share of sum_{t >= s > u} M_tu
  float* interp = colpart + 4 * L;  // [2][L]: C_t . (dy S_in)_t, by column half
  float* xdotp = interp + 2 * L;    // [2][L]: x_s . d(x dt)_s
  float* sdotp = xdotp + 2 * L;     // [2][L]: x_s . (B dS^T)_s
  float* dotp = sdotp + 2 * L;      // [4]: <dS, S_in> by warp 4..7
  uint64_t* bar = reinterpret_cast<uint64_t*>(dotp + 4);  // [STAGES]: a stage's copies

  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int g = lane / 4, tq = lane % 4;
  const int c = blockIdx.x, b = blockIdx.y, grp = blockIdx.z / nsl, sl = blockIdx.z % nsl;
  const int nc = gridDim.x, c0 = c * L;
  const int hs = H / G / nsl, h0 = grp * (H / G) + sl * hs;
  const bf16* Bb = Bm + b * bsb + (long long)grp * N;
  const bf16* Cb = Cm + b * csb + (long long)grp * N;
  const int lm_row = (lane / 8 % 2) * 8 + lane % 8, lm_col = lane / 16 * 8;

  // Lm and W start at 0: the entries no warp writes (above the diagonal)
  // stay 0 for every head; so do colpart's, and the columns of x and dy past
  // P and their rows past S (the chunk is the same for every head).
  for (int e = tid; e < L * LWS / 2; e += NT) reinterpret_cast<uint32_t*>(Lsm)[e] = 0u;
  for (int e = tid; e < 4 * L; e += NT) colpart[e] = 0.f;
  for (int e = tid; e < STAGES * L * xs; e += NT) {
    const int st = e / (L * xs), r = e % (L * xs);
    heads[st * head_elems + r] = __float2bfloat16(0.f);  // x, then dy: 2 L xs of each stage
    heads[st * head_elems + L * xs + r] = __float2bfloat16(0.f);
  }
  fence_async();
  const int rows = min(L, S - c0);  // the chunk's steps
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) mbar_init(bar + st);
  }
  for (int e = tid; e < L * (np / 8); e += NT) {
    const int t = e / (np / 8), k = e % (np / 8);
    const bool in = c0 + t < S && 8 * k < N;
    cp_async16(Bt + t * ns + 8 * k, in ? Bb + (c0 + t) * bss + 8 * k : Bb, in ? 16 : 0);
    cp_async16(Ct + t * ns + 8 * k, in ? Cb + (c0 + t) * css + 8 * k : Cb, in ? 16 : 0);
  }
  cp_async_commit();
  // Thread 0: stage s's barrier expects a head's bytes: the rows of x and dy,
  // and the hi and lo planes of S_in and of dS, each pair one copy.
  const uint32_t head_bytes = (2 * rows * P + 2 * 2 * pp * ns) * sizeof(bf16);
  // Head h's x, dy, S_in and dS into stage s: a bulk copy of each row of x
  // and dy by one thread, and of each state's two planes (stored with the
  // tile's row stride by the state passes) by thread 2 L.
  auto load_head = [&](int h, int s) {
    bf16* X = heads + s * head_elems;
    bf16* DY = X + L * xs;
    bf16* SI = DY + L * xs;
    bf16* DS = SI + 2 * pp * ns;
    if (tid < L) {
      if (tid < rows) {
        fence_async();
        bulk_load(X + tid * xs, x + b * xsb + (c0 + tid) * xss + (long long)h * P,
                  P * sizeof(bf16), bar + s);
      }
    } else if (tid < 2 * L) {
      const int t = tid - L;
      if (t < rows) {
        fence_async();
        bulk_load(DY + t * xs, dy + ((long long)b * S * H + (long long)(c0 + t) * H + h) * P,
                  P * sizeof(bf16), bar + s);
      }
    } else if (tid == 2 * L) {
      const long long plane = (long long)pp * ns;
      fence_async();
      bulk_load(SI, states + (((long long)b * H + h) * nc + c) * 2 * plane,
                2 * plane * sizeof(bf16), bar + s);
      bulk_load(DS, states + ((((long long)Bn + b) * H + h) * nc + c) * 2 * plane,
                2 * plane * sizeof(bf16), bar + s);
    }
  };
  float dtn0 = 0.f, dtn1 = 0.f;  // warp 0: dt of steps 2 lane, 2 lane + 1 for the head to come
  auto load_dt = [&](int h) {
    const int t0 = c0 + 2 * lane;
    const bf16* p = dt + b * dsb + h;
    dtn0 = t0 < S ? to_float(p[t0 * dss]) : 0.f;
    dtn1 = t0 + 1 < S ? to_float(p[(t0 + 1) * dss]) : 0.f;
  };

  if (tid == 0) mbar_expect(bar, head_bytes);
  __syncthreads();  // the barriers, the zeros and the expectation precede the copies
  load_head(h0, 0);
  if (w == 0) load_dt(h0);

  // Warps 0-3: chunk rows ia (8-row group w) and ib (group 7 - w), column
  // tiles j <= 7 - w (8 columns each); C B^T there, once for every head.
  const int rg = w & 3;
  const int ia = 8 * rg + g, ib = 8 * (7 - rg) + g;
  float cbr[8][4];
  // Warp w's rows of dC, dB and d(x dt): 16 rb .. + 15 (r0 = 16 rb + g, r1 =
  // r0 + 8), and half of their columns; dC and dB summed over the heads.
  const int rb = w & 3, half = w >> 2;
  const int r0 = 16 * rb + g, r1 = r0 + 8;
  // The 16-column pairs of N (of P) this warp's half owns: [np0, np1) ([pp0, pp1)).
  const int nk = np / 16, kp = pp / 16;
  const int np0 = half ? (nk + 1) / 2 : 0, np1 = half ? nk : (nk + 1) / 2;
  const int pp0 = half ? (kp + 1) / 2 : 0, pp1 = half ? kp : (kp + 1) / 2;
  float accB[KN / 32][2][4], accC[KN / 32][2][4];
#pragma unroll
  for (int jp = 0; jp < KN / 32; ++jp)
#pragma unroll
    for (int e = 0; e < 8; ++e) accB[jp][e / 4][e % 4] = accC[jp][e / 4][e % 4] = 0.f;

  for (int hh = 0; hh < hs; ++hh) {
    const int h = h0 + hh, s = STAGES == 2 ? hh & 1 : 0;
    if (STAGES == 1 && hh > 0) load_head(h, 0);  // its expectation came before the barrier
    const float a = to_float(A[h]);
    if (w == 0) {  // the scan of dt A, in fp32
      float cA, cB, last;
      const float d0 = dtn0, d1 = dtn1;
      scan_cum(d0, d1, a, cA, cB, last);
      if (hh + 1 < hs) load_dt(h + 1);
      cum[2 * lane] = cA;
      cum[2 * lane + 1] = cB;
      dts[2 * lane] = d0;
      dts[2 * lane + 1] = d1;
      ecum[2 * lane] = expf(cA);
      ecum[2 * lane + 1] = expf(cB);
      dec[2 * lane] = expf(last - cA);
      dec[2 * lane + 1] = expf(last - cB);
    }
    cp_async_wait_all();                                      // B and C have landed
    mbar_wait(bar + s, (STAGES == 2 ? hh >> 1 : hh) & 1);  // and head h's copies
    if (STAGES == 2 && tid == 0 && hh + 1 < hs) mbar_expect(bar + (s ^ 1), head_bytes);
    __syncthreads();  // the scalars are written; the other stage is free
    if (STAGES == 2 && hh + 1 < hs) load_head(h + 1, s ^ 1);
    const bf16* X = heads + s * head_elems;
    const bf16* DY = X + L * xs;
    const bf16* SI = DY + L * xs;
    const bf16* DS = SI + 2 * pp * ns;

    if (w < 4) {
      if (hh == 0) {  // C B^T on this warp's rows and column tiles
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) cbr[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KN / 16; ++kk) {
          if (16 * kk >= np) break;
          const int col = 16 * kk + 2 * tq;
          const uint32_t af[4] = {ld32(Ct + ia * ns + col), ld32(Ct + ib * ns + col),
                                  ld32(Ct + ia * ns + col + 8), ld32(Ct + ib * ns + col + 8)};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (j <= 7 - rg) {  // warp-uniform
              const bf16* br = Bt + (8 * j + g) * ns + col;
              mma(cbr[j], af, ld32(br), ld32(br + 8));
            }
          }
        }
      }
      // dy x^T on the same entries.
      float dxa[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dxa[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk) {
        if (16 * kk >= pp) break;
        const int col = 16 * kk + 2 * tq;
        const uint32_t af[4] = {ld32(DY + ia * xs + col), ld32(DY + ib * xs + col),
                                ld32(DY + ia * xs + col + 8), ld32(DY + ib * xs + col + 8)};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j <= 7 - rg) {
            const bf16* br = X + (8 * j + g) * xs + col;
            mma(dxa[j], af, ld32(br), ld32(br + 8));
          }
        }
      }
      // Lm, Pd, W, M in fp32; Lm and W to shared memory in bf16; each row's
      // exclusive prefix of M over the columns, summed over this warp's
      // rows t >= s for each column s.
      const float cia = cum[ia], cib = cum[ib];
      float carry_a = 0.f, carry_b = 0.f;  // M of rows ia, ib summed over the tiles before j
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j > 7 - rg) break;  // warp-uniform
        const int s0 = 8 * j + 2 * tq, s1 = s0 + 1;
        const float cs0 = cum[s0], cs1 = cum[s1], d0 = dts[s0], d1 = dts[s1];
        // Select before the exp: above the diagonal cum_t - cum_s > 0.
        const float ea0 = s0 <= ia ? expf(cia - cs0) : 0.f, ea1 = s1 <= ia ? expf(cia - cs1) : 0.f;
        const float eb0 = s0 <= ib ? expf(cib - cs0) : 0.f, eb1 = s1 <= ib ? expf(cib - cs1) : 0.f;
        const float pa0 = dxa[j][0] * d0, pa1 = dxa[j][1] * d1;  // Pd: dt folded in here
        const float pb0 = dxa[j][2] * d0, pb1 = dxa[j][3] * d1;
        const float la0 = cbr[j][0] * ea0, la1 = cbr[j][1] * ea1;
        const float lb0 = cbr[j][2] * eb0, lb1 = cbr[j][3] * eb1;
        *reinterpret_cast<uint32_t*>(Lsm + ia * LWS + s0) = pack(la0, la1);
        *reinterpret_cast<uint32_t*>(Lsm + ib * LWS + s0) = pack(lb0, lb1);
        *reinterpret_cast<uint32_t*>(Wsm + ia * LWS + s0) = pack(pa0 * ea0, pa1 * ea1);
        *reinterpret_cast<uint32_t*>(Wsm + ib * LWS + s0) = pack(pb0 * eb0, pb1 * eb1);
        const float ma0 = la0 * pa0, ma1 = la1 * pa1, mb0 = lb0 * pb0, mb1 = lb1 * pb1;
        // Inclusive scans of the pair sums over the 4 lanes of a row.
        const float va = ma0 + ma1, vb = mb0 + mb1;
        float sa = va, sb = vb;
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const float oa = __shfl_up_sync(0xffffffffu, sa, off, 4);
          const float ob = __shfl_up_sync(0xffffffffu, sb, off, 4);
          if (tq >= off) {
            sa += oa;
            sb += ob;
          }
        }
        const float xa = carry_a + (sa - va), xb = carry_b + (sb - vb);  // before column s0
        carry_a += __shfl_sync(0xffffffffu, sa, 3, 4);
        carry_b += __shfl_sync(0xffffffffu, sb, 3, 4);
        float v0 = (ia >= s0 ? xa : 0.f) + (ib >= s0 ? xb : 0.f);
        float v1 = (ia >= s1 ? xa + ma0 : 0.f) + (ib >= s1 ? xb + mb0 : 0.f);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {  // over the 8 rows g
          v0 += __shfl_xor_sync(0xffffffffu, v0, off);
          v1 += __shfl_xor_sync(0xffffffffu, v1, off);
        }
        if (g == 0) {
          colpart[rg * L + s0] = v0;
          colpart[rg * L + s1] = v1;
        }
      }
    } else {  // <dS, S_in> from the hi + lo values, in fp32
      float v = 0.f;
      for (int e = tid - 128; e < pp * (np / 8); e += 128) {
        const int off = (e / (np / 8)) * ns + 8 * (e % (np / 8));
        const uint4 sh = *reinterpret_cast<const uint4*>(SI + off);
        const uint4 slo = *reinterpret_cast<const uint4*>(SI + pp * ns + off);
        const uint4 dh = *reinterpret_cast<const uint4*>(DS + off);
        const uint4 dlo = *reinterpret_cast<const uint4*>(DS + pp * ns + off);
        const uint32_t a0[4] = {sh.x, sh.y, sh.z, sh.w}, a1[4] = {slo.x, slo.y, slo.z, slo.w};
        const uint32_t b0[4] = {dh.x, dh.y, dh.z, dh.w}, b1[4] = {dlo.x, dlo.y, dlo.z, dlo.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 s2 = unpack(a0[q]), s3 = unpack(a1[q]);
          const float2 d2 = unpack(b0[q]), d3 = unpack(b1[q]);
          v = fmaf(s2.x + s3.x, d2.x + d3.x, v);
          v = fmaf(s2.y + s3.y, d2.y + d3.y, v);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) dotp[w - 4] = v;
    }
    __syncthreads();  // Lm, W, colpart and dotp are complete

    const float e0 = ecum[r0], e1 = ecum[r1];
    const float dt0 = dts[r0], dt1 = dts[r1], dc0 = dec[r0], dc1 = dec[r1];
    const float f0 = dt0 * dc0, f1 = dt1 * dc1;
    float ip0 = 0.f, ip1 = 0.f;  // C_t . (dy S_in)_t over this thread's columns
    // dC += W B + e o (dy S_in), and C . (dy S_in) for the inter-chunk terms:
    // q = dy S_in over this warp's 16-column pairs of N, k over P outermost
    // so that the pairs' products are independent; S_in as hi + lo.
    {
      float q[KN / 32][2][4];
#pragma unroll
      for (int jp = 0; jp < KN / 32; ++jp)
#pragma unroll
        for (int e = 0; e < 8; ++e) q[jp][e / 4][e % 4] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk) {
        if (kk >= kp) break;
        const int col = 16 * kk + 2 * tq;
        const uint32_t ya[4] = {ld32(DY + r0 * xs + col), ld32(DY + r1 * xs + col),
                                ld32(DY + r0 * xs + col + 8), ld32(DY + r1 * xs + col + 8)};
        const bf16* row = SI + (16 * kk + lm_row) * ns + lm_col;
#pragma unroll
        for (int jp = 0; jp < KN / 32; ++jp) {
          if (np0 + jp >= np1) break;
          uint32_t hb[4], lb[4];
          ldsm_x4_t(hb, row + 16 * (np0 + jp));
          ldsm_x4_t(lb, row + pp * ns + 16 * (np0 + jp));
          mma(q[jp][0], ya, hb[0], hb[1]);
          mma(q[jp][1], ya, hb[2], hb[3]);
          mma(q[jp][0], ya, lb[0], lb[1]);
          mma(q[jp][1], ya, lb[2], lb[3]);
        }
      }
#pragma unroll
      for (int jp = 0; jp < KN / 32; ++jp) {
        if (np0 + jp >= np1) break;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int n = 16 * (np0 + jp) + 8 * hf + 2 * tq;
          const float2 ca = unpack(ld32(Ct + r0 * ns + n)), cb = unpack(ld32(Ct + r1 * ns + n));
          const float(&v)[4] = q[jp][hf];
          ip0 = fmaf(ca.x, v[0], fmaf(ca.y, v[1], ip0));
          ip1 = fmaf(cb.x, v[2], fmaf(cb.y, v[3], ip1));
          accC[jp][hf][0] = fmaf(e0, v[0], accC[jp][hf][0]);
          accC[jp][hf][1] = fmaf(e0, v[1], accC[jp][hf][1]);
          accC[jp][hf][2] = fmaf(e1, v[2], accC[jp][hf][2]);
          accC[jp][hf][3] = fmaf(e1, v[3], accC[jp][hf][3]);
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // W B: k = s up to the diagonal block
      if (kk > rb) break;
      const int col = 16 * kk + 2 * tq;
      const uint32_t wa[4] = {ld32(Wsm + r0 * LWS + col), ld32(Wsm + r1 * LWS + col),
                              ld32(Wsm + r0 * LWS + col + 8), ld32(Wsm + r1 * LWS + col + 8)};
      const bf16* row = Bt + (16 * kk + lm_row) * ns + lm_col;
#pragma unroll
      for (int jp = 0; jp < KN / 32; ++jp) {
        if (np0 + jp >= np1) break;
        uint32_t bb[4];
        ldsm_x4_t(bb, row + 16 * (np0 + jp));
        mma(accC[jp][0], wa, bb[0], bb[1]);
        mma(accC[jp][1], wa, bb[2], bb[3]);
      }
    }
    // dB += W^T C + dt dec o (x dS): x dS with dS's hi part alone (dB feeds
    // no sum of d(dt A)).
    {
      float u[KN / 32][2][4];
#pragma unroll
      for (int jp = 0; jp < KN / 32; ++jp)
#pragma unroll
        for (int e = 0; e < 8; ++e) u[jp][e / 4][e % 4] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KP / 16; ++kk) {
        if (kk >= kp) break;
        const int col = 16 * kk + 2 * tq;
        const uint32_t xa[4] = {ld32(X + r0 * xs + col), ld32(X + r1 * xs + col),
                                ld32(X + r0 * xs + col + 8), ld32(X + r1 * xs + col + 8)};
        const bf16* row = DS + (16 * kk + lm_row) * ns + lm_col;
#pragma unroll
        for (int jp = 0; jp < KN / 32; ++jp) {
          if (np0 + jp >= np1) break;
          uint32_t hb[4];
          ldsm_x4_t(hb, row + 16 * (np0 + jp));
          mma(u[jp][0], xa, hb[0], hb[1]);
          mma(u[jp][1], xa, hb[2], hb[3]);
        }
      }
#pragma unroll
      for (int jp = 0; jp < KN / 32; ++jp)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          accB[jp][hf][0] = fmaf(f0, u[jp][hf][0], accB[jp][hf][0]);
          accB[jp][hf][1] = fmaf(f0, u[jp][hf][1], accB[jp][hf][1]);
          accB[jp][hf][2] = fmaf(f1, u[jp][hf][2], accB[jp][hf][2]);
          accB[jp][hf][3] = fmaf(f1, u[jp][hf][3], accB[jp][hf][3]);
        }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // W^T C: k = t from the diagonal block on
      if (kk < rb) continue;
      uint32_t r[4];
      ldsm_x4_t(r, Wsm + (16 * kk + lm_row) * LWS + 16 * rb + lm_col);
      const uint32_t wt[4] = {r[0], r[2], r[1], r[3]};
      const bf16* row = Ct + (16 * kk + lm_row) * ns + lm_col;
#pragma unroll
      for (int jp = 0; jp < KN / 32; ++jp) {
        if (np0 + jp >= np1) break;
        uint32_t cb[4];
        ldsm_x4_t(cb, row + 16 * (np0 + jp));
        mma(accB[jp][0], wt, cb[0], cb[1]);
        mma(accB[jp][1], wt, cb[2], cb[3]);
      }
    }
    // d(x dt) = Lm^T dy + dec o (B dS^T) on this warp's 16-column pairs of P;
    // dx, x . d(x dt) and x . (B dS^T).  dS^T's fragments come from dS's
    // rows by ldmatrix (not transposed), hi + lo.
    float xd0 = 0.f, xd1 = 0.f, sd0 = 0.f, sd1 = 0.f;
    {
      float gs[KP / 32][2][4], gl[KP / 32][2][4];
#pragma unroll
      for (int jp = 0; jp < KP / 32; ++jp)
#pragma unroll
        for (int e = 0; e < 8; ++e) gs[jp][e / 4][e % 4] = gl[jp][e / 4][e % 4] = 0.f;
      // lane's row of dS for a 16-row pair (rows 8 (lane / 16) + lane % 8)
      // and column half ((lane / 8) % 2) of a k step
      const bf16* drow = DS + (8 * (lane / 16) + lane % 8) * ns + 8 * ((lane / 8) % 2);
#pragma unroll
      for (int kk = 0; kk < KN / 16; ++kk) {
        if (kk >= nk) break;
        const int col = 16 * kk + 2 * tq;
        const uint32_t ba[4] = {ld32(Bt + r0 * ns + col), ld32(Bt + r1 * ns + col),
                                ld32(Bt + r0 * ns + col + 8), ld32(Bt + r1 * ns + col + 8)};
#pragma unroll
        for (int jp = 0; jp < KP / 32; ++jp) {
          if (pp0 + jp >= pp1) break;
          uint32_t hb[4], lb[4];
          const bf16* a = drow + 16 * (pp0 + jp) * ns + 16 * kk;
          ldsm_x4(hb, a);
          ldsm_x4(lb, a + pp * ns);
          mma(gs[jp][0], ba, hb[0], hb[1]);
          mma(gs[jp][1], ba, hb[2], hb[3]);
          mma(gs[jp][0], ba, lb[0], lb[1]);
          mma(gs[jp][1], ba, lb[2], lb[3]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // Lm^T dy: k = t from the diagonal block on
        if (kk < rb) continue;
        uint32_t r[4];
        ldsm_x4_t(r, Lsm + (16 * kk + lm_row) * LWS + 16 * rb + lm_col);
        const uint32_t lt[4] = {r[0], r[2], r[1], r[3]};
        const bf16* row = DY + (16 * kk + lm_row) * xs + lm_col;
#pragma unroll
        for (int jp = 0; jp < KP / 32; ++jp) {
          if (pp0 + jp >= pp1) break;
          uint32_t yb[4];
          ldsm_x4_t(yb, row + 16 * (pp0 + jp));
          mma(gl[jp][0], lt, yb[0], yb[1]);
          mma(gl[jp][1], lt, yb[2], yb[3]);
        }
      }
      bf16* dxb = dx + ((long long)b * S * H + h) * P;  // dx: contiguous [B, S, H, P]
#pragma unroll
      for (int jp = 0; jp < KP / 32; ++jp) {
        if (pp0 + jp >= pp1) break;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = 16 * (pp0 + jp) + 8 * hf + 2 * tq;
          const float(&s_)[4] = gs[jp][hf];
          const float(&l_)[4] = gl[jp][hf];
          const float g00 = fmaf(dc0, s_[0], l_[0]), g01 = fmaf(dc0, s_[1], l_[1]);
          const float g10 = fmaf(dc1, s_[2], l_[2]), g11 = fmaf(dc1, s_[3], l_[3]);
          if (p < P) {
            if (c0 + r0 < S)
              *reinterpret_cast<uint32_t*>(dxb + (long long)(c0 + r0) * H * P + p) =
                  pack(dt0 * g00, dt0 * g01);
            if (c0 + r1 < S)
              *reinterpret_cast<uint32_t*>(dxb + (long long)(c0 + r1) * H * P + p) =
                  pack(dt1 * g10, dt1 * g11);
          }
          const float2 x0 = unpack(ld32(X + r0 * xs + p)), x1 = unpack(ld32(X + r1 * xs + p));
          xd0 = fmaf(x0.x, g00, fmaf(x0.y, g01, xd0));
          xd1 = fmaf(x1.x, g10, fmaf(x1.y, g11, xd1));
          sd0 = fmaf(x0.x, s_[0], fmaf(x0.y, s_[1], sd0));
          sd1 = fmaf(x1.x, s_[2], fmaf(x1.y, s_[3], sd1));
        }
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // over the 4 lanes of a row
      ip0 += __shfl_xor_sync(0xffffffffu, ip0, off);
      ip1 += __shfl_xor_sync(0xffffffffu, ip1, off);
      xd0 += __shfl_xor_sync(0xffffffffu, xd0, off);
      xd1 += __shfl_xor_sync(0xffffffffu, xd1, off);
      sd0 += __shfl_xor_sync(0xffffffffu, sd0, off);
      sd1 += __shfl_xor_sync(0xffffffffu, sd1, off);
    }
    if (tq == 0) {
      interp[half * L + r0] = ip0;
      interp[half * L + r1] = ip1;
      xdotp[half * L + r0] = xd0;
      xdotp[half * L + r1] = xd1;
      sdotp[half * L + r0] = sd0;
      sdotp[half * L + r1] = sd1;
    }
    if (STAGES == 1 && tid == 0 && hh + 1 < hs) mbar_expect(bar, head_bytes);
    __syncthreads();  // the partial sums are complete; every reader of this stage is done

    // Warp 0: d(dt A) = the span sums + the suffix sums of the inter-chunk
    // terms + exp(cum_last) <dS, S_in> + the exclusive prefix sums of the
    // state's terms; then ddt and the head's dA term for the chunk.
    if (w == 0) {
      const int t0 = 2 * lane, t1 = t0 + 1;
      float span0 = 0.f, span1 = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        span0 += colpart[k * L + t0];
        span1 += colpart[k * L + t1];
      }
      const float in0 = ecum[t0] * (interp[t0] + interp[L + t0]);
      const float in1 = ecum[t1] * (interp[t1] + interp[L + t1]);
      const float sd_0 = dts[t0] * dec[t0] * (sdotp[t0] + sdotp[L + t0]);
      const float sd_1 = dts[t1] * dec[t1] * (sdotp[t1] + sdotp[L + t1]);
      const float state = ecum[L - 1] * (((dotp[0] + dotp[1]) + dotp[2]) + dotp[3]);
      float run = in0 + in1;   // becomes the inclusive suffix sum of pair sums
      float pre = sd_0 + sd_1;  // becomes the inclusive prefix sum of pair sums
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(0xffffffffu, run, off);
        const float u = __shfl_up_sync(0xffffffffu, pre, off);
        if (lane + off < 32) run += o;
        if (lane >= off) pre += u;
      }
      float after = __shfl_down_sync(0xffffffffu, run, 1);
      float before = __shfl_up_sync(0xffffffffu, pre, 1);
      if (lane == 31) after = 0.f;
      if (lane == 0) before = 0.f;
      const float da1 = span1 + (after + in1) + state + (before + sd_0);
      const float da0 = span0 + (after + in1 + in0) + state + before;
      bf16* dd = ddt + (long long)b * S * H + h;  // ddt: contiguous [B, S, H]
      if (c0 + t0 < S)
        dd[(long long)(c0 + t0) * H] = __float2bfloat16(fmaf(a, da0, xdotp[t0] + xdotp[L + t0]));
      if (c0 + t1 < S)
        dd[(long long)(c0 + t1) * H] = __float2bfloat16(fmaf(a, da1, xdotp[t1] + xdotp[L + t1]));
      float v = fmaf(dts[t0], da0, dts[t1] * da1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) dA_part[((long long)b * H + h) * nc + c] = v;
    }
  }

  // dB and dC of the block's heads, fp32, into the slice's planes of dBC
  // [2][nsl][B][S][G][N].
#pragma unroll
  for (int jp = 0; jp < KN / 32; ++jp) {
    if (np0 + jp >= np1) break;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int n = 16 * (np0 + jp) + 8 * hf + 2 * tq;
      if (n >= N) continue;
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        const float(&acc)[4] = which ? accC[jp][hf] : accB[jp][hf];
        float* base = dBC + (((long long)which * nsl + sl) * Bn + b) * S * G * N +
                      (long long)grp * N + n;
        if (c0 + r0 < S)
          *reinterpret_cast<float2*>(base + (long long)(c0 + r0) * G * N) =
              make_float2(acc[0], acc[1]);
        if (c0 + r1 < S)
          *reinterpret_cast<float2*>(base + (long long)(c0 + r1) * G * N) =
              make_float2(acc[2], acc[3]);
      }
    }
  }
}

struct Args {
  const bf16 *x, *dt, *A, *Bm, *Cm, *dy;
  const bf16* states;
  bf16 *dx, *ddt;
  float *dA_part, *dBC;
  int B, S, H, G, P, N, nsl;
  long long st[8];  // batch and sequence strides of x, dt, Bm, Cm
};

template <int KP, int KN>
cudaError_t launch_chunk(const Args& a, cudaStream_t stream) {
  const size_t smem = chunk_smem_bytes(a.P, a.N, KP <= 64 ? 2 : 1);
  auto kernel = ssd_bwd_chunk_kernel<KP, KN>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + L - 1) / L, a.B, a.G * a.nsl);
  kernel<<<grid, NT, smem, stream>>>(a.x, a.dt, a.A, a.Bm, a.Cm, a.dy, a.states, a.dx, a.ddt,
                                     a.dA_part, a.dBC, a.B, a.S, a.H, a.G, a.P, a.N, a.nsl,
                                     a.st[0], a.st[1], a.st[2], a.st[3], a.st[4], a.st[5], a.st[6],
                                     a.st[7]);
  return cudaGetLastError();
}

}  // namespace

// x [B, S, H, P], dt [B, S, H], A [H], Bm and Cm [B, S, G, N], bf16, strided
// as ssd_scan_tc_fwd takes them (batch and sequence strides in elements: x,
// dt, Bm, Cm in turn); dy [B, S, H, P] bf16 and dstate [B, H, P, N] fp32,
// contiguous.  `states` is bf16 scratch of 2 B H ceil(S / 64) 2 P16 (N16 + 8)
// values (P and N rounded up to 16).
// Writes dx [B, S, H, P] and ddt [B, S, H] bf16, dA_part [B, H, ceil(S /
// 64)] (each (batch, head, chunk)'s term of dA) and dBC [2, nsl, B, S, G,
// N] (dB, then dC, each summed over a slice of H / G / nsl heads of a
// group), fp32, all contiguous.  Launches the state passes, then the chunk
// pass, on `stream`.  Returns the cudaError_t of the launches (0 on success).
extern "C" int ssd_scan_bwd_tc(const void* x, const void* dt, const void* A, const void* Bm,
                               const void* Cm, const void* dy, const void* dstate, void* states,
                               void* dx, void* ddt, void* dA_part, void* dBC, int B, int S,
                               int H, int G, int P, int N, int nsl, long long xsb, long long xss,
                               long long dsb, long long dss, long long bsb, long long bss,
                               long long csb, long long css, void* stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(Bm) |
                         reinterpret_cast<uintptr_t>(Cm) | reinterpret_cast<uintptr_t>(dy);
  if (B < 1 || B > 32767 || S < 1 || H < 1 || H > 65535 || G < 1 || H % G || nsl < 1 ||
      (H / G) % nsl || (long long)G * nsl > 65535 || P < 8 || P > MAXD || P % 8 || N < 8 ||
      N > MAXD || N % 8 || ptrs % 16 || (xsb | xss | bsb | bss | csb | css) % 8)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t ssmem = state_smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_state_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ssmem);
  if (err != cudaSuccess) return err;
  ssd_bwd_state_kernel<<<dim3((P + PS - 1) / PS, H, 2 * B), NT, ssmem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dt), static_cast<const bf16*>(A),
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm), static_cast<const bf16*>(dy),
      static_cast<const float*>(dstate), static_cast<bf16*>(states), B, S, H, G, P, N, xsb, xss,
      dsb, dss, bsb, bss, csb, css);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const Args args{static_cast<const bf16*>(x),      static_cast<const bf16*>(dt),
                  static_cast<const bf16*>(A),      static_cast<const bf16*>(Bm),
                  static_cast<const bf16*>(Cm),     static_cast<const bf16*>(dy),
                  static_cast<const bf16*>(states), static_cast<bf16*>(dx),
                  static_cast<bf16*>(ddt),          static_cast<float*>(dA_part),
                  static_cast<float*>(dBC),         B, S, H, G, P, N, nsl,
                  {xsb, xss, dsb, dss, bsb, bss, csb, css}};
  const bool p64 = pad16(P) <= 64, n64 = pad16(N) <= 64;
  if (p64 && n64) return launch_chunk<64, 64>(args, s);
  if (p64) return launch_chunk<64, 128>(args, s);
  if (n64) return launch_chunk<128, 64>(args, s);
  return launch_chunk<128, 128>(args, s);
}

extern "C" const char* ssd_scan_bwd_tc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
