// Mamba-2 SSD chunked scan for Hopper (sm_90a) on the tensor cores, bf16.
// The `tc` variant of `ssd_scan`; the wrapper (kernels/ssd_scan.py,
// `variant`) routes fp32, and the bf16 inputs this kernel does not take
// (see the end of this note), to the CUDA-core kernel of ssd_scan.cu
// (`simt`).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:65 `ssd_scan` (body
// `_ssd_kernel`) for those inputs.  For each (batch, head), group
// g = h / (H / G):
//
//   state_t = state_{t-1} * exp(dt_t A_h) + dt_t x_t B_t^T      [P, N]
//   y_t     = C_t . state_t                                      [P]
//
// by chunks of L = 64 steps (the kernel's own chunk, as simt's; chunking
// does not change the function):
//
//   cum   = cumsum(dt A)                                         [L]
//   y     = M x + exp(cum) o (C state^T),   M = C B^T o exp(cum_i - cum_j) o dt_j, j <= i
//   state = state exp(cum_last) + x^T (B o dt exp(cum_last - cum))
//
// and writes y in bf16 and the final state [B, H, P, N] in fp32.
//
// Bound on the H100: bytes.  At mamba2-370m's prefill (B4 S2048 H32 P64 G1
// N128) the function reads x, dt, B and C once and writes y and the final
// state once, 76.0 MB, 22.7 us at 3.35 TB/s; its 11.9 GFLOP of chunk
// products take 12.0 us at the bf16 tensor-core rate.
//
// Where bf16 rounding happens.  x, B and C enter the products exactly as
// given.  cumsum(dt A), every exp, the decay factors and the products with
// dt are fp32, and dt is folded into those factors, not into x.  Three
// operands are rounded to bf16, each once, as the second operand of its
// product: the masked tile M (before M x), B o dt exp(cum_last - cum)
// (before x^T (...)), and the state as it enters C state^T.  Every product
// sums in fp32 (mma.sync m16n8k16, fp32 accumulators); the carried state
// and the final state never leave fp32.  The plain version computes all of
// it in fp32, and the kernel is held to it at 2e-2 of max|y| and max|state|.
//
// Design: sequential in chunks, split across P, after a prepass for C B^T.
// Rows of the state are independent (y[:, p] and state[p, :] need only
// state row p), so a block of 8 warps owns PS = 32 rows of one (batch,
// head)'s state and walks the chunks with them in fp32 registers: at the
// serve shape B H P / PS = 256 blocks, two an SM (97 KB of shared memory
// and 256 threads each), where the simt kernel has 128 blocks of one (batch,
// head) each.
//   - The prepass (ssd_cb_kernel, one block for each (batch, chunk, group))
//     computes C B^T once in fp32 into scratch [B][G][chunks][L][L] that the
//     wrapper allocates: it depends on neither head nor P, so the scan does
//     not compute it again for each of the H P / PS blocks that share it.
//     The scan loads its entries straight into registers, a chunk ahead.
//   - x [L, PS], B and C [L, N] arrive by cp.async into one of two stages,
//     the next chunk's copies issued as soon as the current chunk's have
//     landed, so they overlap the whole chunk's math; rows past S and
//     columns past P or N are zero-filled (dt = 0 there, an exact no-op).
//     Warp 0 scans dt A with shuffles, in fp32.
//   - Warps w and w + 4 own chunk rows 8w + g and 56 - 8w + g (g < 8), so
//     every warp has the same share of the lower triangle; each of the two
//     computes y for 16 of the PS columns.  The mask, decay and dt are
//     applied to C B^T in registers, in the layout of M's A fragments for
//     M x (x read transposed by ldmatrix.trans, no copy); C state^T reads
//     the bf16 state from shared memory.
//   - Warp w then updates columns 16w..16w+15 of N of the state: state
//     exp(cum_last) enters the fp32 accumulators and x^T (B o w) is added
//     on the tensor cores, with x^T and B read by ldmatrix.trans and B's
//     fragments scaled by w and rounded to bf16 in registers.  The new state
//     goes to shared memory in bf16, into the second of two buffers, for the
//     next chunk's C state^T.
// Every buffer a chunk writes is one the other chunk reads, so one block
// barrier a chunk orders everything.
//
// Bytes: x, dt, y and the state move once.  B and C are read by every
// (head, P slice) block of a batch row, but a batch row's B and C are 1 MB
// at the serve shape, so the repeats are served by the 50 MB L2 and device
// memory sees about the inputs' own bytes.  The prepass adds its C B^T
// (B S/L G L^2 fp32: 2 MB at the serve shape, in L2) and reads B and C once
// more.
//
// Needs P and N multiples of 8 (16-byte rows) up to 128, 16-byte aligned
// x, B and C, and batch and sequence strides that are multiples of 8
// elements (the wrapper routes other inputs to simt and the launcher
// refuses them; mamba2's conv-output views have them).
// The launcher allocates nothing and does not synchronise, so the launch
// is legal inside a CUDA graph capture.

#include <stdint.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;      // threads a block of the scan: 8 warps
constexpr int CB_NT = 128;   // threads a block of the prepass: 4 warps
constexpr int L = 64;        // steps a chunk (16 rows a warp)
constexpr int PS = 32;       // state rows (head-dim entries p) a block
constexpr int XS = PS + 8;   // row stride of the x tile, in bf16: 80 bytes
constexpr int MAXD = 128;    // largest P and N

// Row stride (bf16) of the B, C and state tiles: N rounded up to 16, plus 8.
// 16-byte aligned rows; an odd number of 16-byte units, so the 8 rows an
// ldmatrix reads fall in distinct banks, and 4 words mod 32 between rows,
// so the (row g, word t) pattern of an mma fragment load is conflict-free.
__host__ __device__ constexpr int row_stride(int np) { return np + 8; }

size_t smem_bytes(int np) {
  const size_t stage = (size_t)L * XS + 2 * (size_t)L * row_stride(np);
  return 2 * stage * sizeof(bf16)                        // two stages of x, B, C
         + 2 * (size_t)PS * row_stride(np) * sizeof(bf16)  // two copies of the state in bf16
         + 2 * 4 * (size_t)L * sizeof(float);            // two sets of cum, dt, exp(cum), w
}

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
// Four 8x8 bf16 matrices, transposed: lanes 8i..8i+7 give the row addresses
// of matrix i; r[i] gets matrix i's elements (2 (lane % 4), lane / 4) and
// (2 (lane % 4) + 1, lane / 4).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
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
// A bf16 pair times an fp32 pair, rounded back to a bf16 pair.
__device__ __forceinline__ uint32_t scaled(uint32_t v, float2 f) {
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  return pack(b.x * f.x, b.y * f.y);
}
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// This thread's entries of one chunk's C B^T (fp32 [L][L], from the
// prepass): row ia at column tiles j <= w and row ib at j <= 7 - w, columns
// 8 j + 2 tq and + 1; 0 elsewhere.
__device__ __forceinline__ void load_cb(float2 (&d)[8][2], const float* t, int ia, int ib, int w,
                                        int tq) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * tq;
    d[j][0] = j <= w ? __ldg(reinterpret_cast<const float2*>(t + ia * L + col))
                     : make_float2(0.f, 0.f);
    d[j][1] = j <= 7 - w ? __ldg(reinterpret_cast<const float2*>(t + ib * L + col))
                         : make_float2(0.f, 0.f);
  }
}

// The prepass: C B^T of each (batch, chunk, group) in fp32, written to cb
// [B][G][chunks][L][L].  Warp w computes rows 16w..16w+15 at the column
// tiles on and left of the diagonal, which cover every entry the scan reads.
__global__ void __launch_bounds__(CB_NT) ssd_cb_kernel(
    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm, float* __restrict__ cb, int S,
    int G, int N, long long bsb, long long bss, long long csb, long long css) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int np = (N + 15) / 16 * 16;
  const int bs = row_stride(np);
  bf16* Bt = reinterpret_cast<bf16*>(smem);  // [L][bs]
  bf16* Ct = Bt + L * bs;                     // [L][bs]
  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int g = lane / 4, tq = lane % 4;
  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z, c0 = c * L;
  const bf16* Bb = Bm + b * bsb + (long long)grp * N;
  const bf16* Cb = Cm + b * csb + (long long)grp * N;
  const int ngran = np / 8;
  for (int e = tid; e < L * ngran; e += CB_NT) {
    const int t = e / ngran, k = e % ngran;
    const bool in = c0 + t < S && 8 * k < N;
    cp_async16(smem_u32(Bt + t * bs + 8 * k), in ? Bb + (c0 + t) * bss + 8 * k : Bm,
               in ? 16 : 0);
    cp_async16(smem_u32(Ct + t * bs + 8 * k), in ? Cb + (c0 + t) * css + 8 * k : Cm,
               in ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int i0 = 16 * w + g, i1 = i0 + 8;
  float acc[8][4] = {};
  for (int kk = 0; kk < np / 16; ++kk) {
    const int col = 16 * kk + 2 * tq;
    const uint32_t af[4] = {ld32(Ct + i0 * bs + col), ld32(Ct + i1 * bs + col),
                            ld32(Ct + i0 * bs + col + 8), ld32(Ct + i1 * bs + col + 8)};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < 2 * (w + 1)) {  // warp-uniform
        const bf16* br = Bt + (8 * j + g) * bs + col;
        mma(acc[j], af, ld32(br), ld32(br + 8));
      }
    }
  }
  float* out = cb + (((long long)b * G + grp) * gridDim.x + c) * L * L;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < 2 * (w + 1)) {
      const int col = 8 * j + 2 * tq;
      *reinterpret_cast<float2*>(out + i0 * L + col) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(out + i1 * L + col) = make_float2(acc[j][2], acc[j][3]);
    }
  }
}

// NP: N rounded up to 16 (the mma's k), a compile-time constant so that the
// loops over N unroll and the tile addressing folds.
template <int NP>
__global__ void __launch_bounds__(NT, 2) ssd_scan_tc_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dt, const bf16* __restrict__ A,
    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm, const float* __restrict__ cb,
    bf16* __restrict__ y, float* __restrict__ state_out, int S, int H, int G, int P, int N,
    long long xsb, long long xss, long long dsb, long long dss, long long bsb, long long bss,
    long long csb, long long css) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int bs = row_stride(NP);
  constexpr int stage_elems = L * XS + 2 * L * bs;
  bf16* stages = reinterpret_cast<bf16*>(smem);  // stage s: x [L][XS], B [L][bs], C [L][bs]
  bf16* Hs2 = stages + 2 * stage_elems;  // [2][PS][bs]: the state entering chunk c, at c % 2
  float* scal = reinterpret_cast<float*>(Hs2 + 2 * PS * bs);  // [2][4][L]

  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  const int g = lane / 4, tq = lane % 4;  // an mma fragment's row and column pair
  const int rg = w % 4, half = w / 4;     // this warp's row groups and half of the PS columns
  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (H / G);
  const float a = to_float(A[h]);
  const bf16* xb = x + b * xsb + (long long)h * P + p0;
  const bf16* db = dt + b * dsb + h;
  const bf16* Bb = Bm + b * bsb + (long long)grp * N;
  const bf16* Cb = Cm + b * csb + (long long)grp * N;
  const int nchunks = (S + L - 1) / L;
  constexpr int nk = NP / 16;   // k steps over N; also the 16-column pairs of the state
  constexpr int ngran = NP / 8;  // 16-byte pieces of a B or C row

  // Chunk c's x, B and C into stage s, as one cp.async group.
  auto load = [&](int c, int s) {
    const int c0 = c * L;
    bf16* X = stages + s * stage_elems;
    bf16* Bt = X + L * XS;
    bf16* Ct = Bt + L * bs;
    for (int e = tid; e < L * (PS / 8); e += NT) {
      const int t = e / (PS / 8), k = e % (PS / 8);
      const bool in = c0 + t < S && p0 + 8 * k < P;
      cp_async16(smem_u32(X + t * XS + 8 * k), in ? xb + (c0 + t) * xss + 8 * k : x,
                 in ? 16 : 0);
    }
    for (int e = tid; e < L * ngran; e += NT) {
      const int t = e / ngran, k = e % ngran;
      const bool in = c0 + t < S && 8 * k < N;
      cp_async16(smem_u32(Bt + t * bs + 8 * k), in ? Bb + (c0 + t) * bss + 8 * k : Bm,
                 in ? 16 : 0);
      cp_async16(smem_u32(Ct + t * bs + 8 * k), in ? Cb + (c0 + t) * css + 8 * k : Cm,
                 in ? 16 : 0);
    }
    cp_async_commit();
  };

  // Warp 0's lane l holds dt of steps 2l and 2l + 1 of the chunk to come.
  float dt0 = 0.f, dt1 = 0.f;
  auto load_dt = [&](int c) {
    const int t0 = c * L + 2 * lane;
    dt0 = t0 < S ? to_float(db[t0 * dss]) : 0.f;
    dt1 = t0 + 1 < S ? to_float(db[(t0 + 1) * dss]) : 0.f;
  };

  // The state: warp w owns the 16 columns 16 w .. 16 w + 15 of N (if they
  // exist) and all PS rows: st[m][hf] is the fp32 tile of rows 16 m + g and
  // + 8, columns 16 w + 8 hf + 2 tq and + 1.
  float st[2][2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[m][hf][e] = 0.f;
  for (int e = tid; e < PS * bs; e += NT) Hs2[e] = __float2bfloat16(0.f);

  load(0, 0);
  if (w == 0) load_dt(0);
  const long long yrow = (long long)H * P;  // y is contiguous [B, S, H, P]
  bf16* yb = y + (long long)b * S * yrow + (long long)h * P + p0;
  // This warp's chunk rows: ia in 8-row group rg and ib in group 7 - rg, so
  // that every warp has the same share of the lower triangle; warps rg and
  // rg + 4 share the rows and split the PS columns of y.
  const int ia = 8 * rg + g, ib = 8 * (7 - rg) + g;
  const float* cbg = cb + ((long long)b * G + grp) * nchunks * L * L;  // this group's C B^T
  float2 cbn[8][2];  // the coming chunk's C B^T at this thread's fragment entries
  load_cb(cbn, cbg, ia, ib, rg, tq);
  // ldmatrix row addresses: lane's matrix mi = lane / 8 covers rows
  // (mi % 2) 8 .. + 7 of a 16-row k step and columns (mi / 2) 8 .. + 7.
  const int lm_row = (lane / 8 % 2) * 8 + lane % 8, lm_col = lane / 16 * 8;

  for (int c = 0; c < nchunks; ++c) {
    const int s = c & 1, c0 = c * L;
    float* cum = scal + s * 4 * L;  // cumsum(dt A)
    float* dts = cum + L;           // dt
    float* ecum = dts + L;          // exp(cum)
    float* wt = ecum + L;           // dt exp(cum_last - cum)
    if (w == 0) {                   // the scan of dt A, in fp32
      const float v0 = dt0 * a, v1 = dt1 * a;
      float run = v0 + v1;          // becomes the inclusive prefix of the lanes' pair sums
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, run, off);
        if (lane >= off) run += o;
      }
      float before = __shfl_up_sync(0xffffffffu, run, 1);
      if (lane == 0) before = 0.f;
      const float c_0 = before + v0, c_1 = c_0 + v1;
      const float last = __shfl_sync(0xffffffffu, c_1, 31);
      cum[2 * lane] = c_0;
      cum[2 * lane + 1] = c_1;
      dts[2 * lane] = dt0;
      dts[2 * lane + 1] = dt1;
      ecum[2 * lane] = __expf(c_0);
      ecum[2 * lane + 1] = __expf(c_1);
      wt[2 * lane] = dt0 * __expf(last - c_0);
      wt[2 * lane + 1] = dt1 * __expf(last - c_1);
    }
    cp_async_wait_all();  // this thread's copies of chunk c have landed
    __syncthreads();      // everyone's have; chunk c - 1 is done with the other buffers
    if (c + 1 < nchunks) {
      load(c + 1, s ^ 1);
      if (w == 0) load_dt(c + 1);
    }
    const bf16* X = stages + s * stage_elems;
    const bf16* Bt = X + L * XS;
    const bf16* Ct = Bt + L * bs;
    const bf16* Hs = Hs2 + s * PS * bs;  // read here, by C state^T
    bf16* Hn = Hs2 + (s ^ 1) * PS * bs;  // written here, read by chunk c + 1

    // M = C B^T o exp(cum_i - cum_j) o dt_j on and below the diagonal, in
    // fp32 from the prepass's C B^T, then rounded to bf16 as M x's A
    // fragments (row ia: tiles j <= rg; row ib: j <= 7 - rg).  Select before
    // the exp's result is used: above the diagonal cum_i - cum_j > 0.
    const float ca = cum[ia], cb_ = cum[ib];
    uint32_t mf[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int j0 = 8 * j + 2 * tq, j1 = j0 + 1;
      const float cj0 = cum[j0], cj1 = cum[j1], d0 = dts[j0], d1 = dts[j1];
      mf[j][0] = mf[j][1] = 0u;
      if (j <= rg)
        mf[j][0] = pack(j0 <= ia ? cbn[j][0].x * __expf(ca - cj0) * d0 : 0.f,
                        j1 <= ia ? cbn[j][0].y * __expf(ca - cj1) * d1 : 0.f);
      if (j <= 7 - rg)
        mf[j][1] = pack(j0 <= ib ? cbn[j][1].x * __expf(cb_ - cj0) * d0 : 0.f,
                        j1 <= ib ? cbn[j][1].y * __expf(cb_ - cj1) * d1 : 0.f);
    }
    if (c + 1 < nchunks) load_cb(cbn, cbg + (long long)(c + 1) * L * L, ia, ib, rg, tq);

    // y = exp(cum_i) (C state^T) + M x for rows ia, ib and columns
    // 16 half .. + 15: C state^T in one pass over N, then M x with x read
    // transposed as the B operand.
    float yo[2][4];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) yo[q][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < nk; ++kk) {
      const int col = 16 * kk + 2 * tq;
      const uint32_t af[4] = {ld32(Ct + ia * bs + col), ld32(Ct + ib * bs + col),
                              ld32(Ct + ia * bs + col + 8), ld32(Ct + ib * bs + col + 8)};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const bf16* hr = Hs + (16 * half + 8 * q + g) * bs + col;
        mma(yo[q], af, ld32(hr), ld32(hr + 8));
      }
    }
    const float ea = ecum[ia], eb = ecum[ib];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      yo[q][0] *= ea;
      yo[q][1] *= ea;
      yo[q][2] *= eb;
      yo[q][3] *= eb;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (2 * kk <= 7 - rg) {  // k steps that reach row ib's diagonal
        const uint32_t af[4] = {mf[2 * kk][0], mf[2 * kk][1], mf[2 * kk + 1][0],
                                mf[2 * kk + 1][1]};
        uint32_t xr[4];
        ldsm_x4_t(xr, X + (16 * kk + lm_row) * XS + 16 * half + lm_col);
        mma(yo[0], af, xr[0], xr[1]);
        mma(yo[1], af, xr[2], xr[3]);
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int p = 16 * half + 8 * q + 2 * tq;
      if (p0 + p < P) {
        if (c0 + ia < S)
          *reinterpret_cast<uint32_t*>(yb + (c0 + ia) * yrow + p) = pack(yo[q][0], yo[q][1]);
        if (c0 + ib < S)
          *reinterpret_cast<uint32_t*>(yb + (c0 + ib) * yrow + p) = pack(yo[q][2], yo[q][3]);
      }
    }

    // state = state exp(cum_last) + x^T (B o w) on this warp's 16 columns:
    // x^T as the A operand and B as the B operand, both by ldmatrix.trans;
    // B's fragments are scaled by w = dt exp(cum_last - cum) in fp32 and
    // rounded to bf16 in registers.  The new state goes to Hn in bf16.
    if (w < nk) {  // warp-uniform
      const float el = ecum[L - 1];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[m][hf][e] *= el;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // w of steps 16 kk + 2 tq, + 1 (fragment registers 0 and 2) and + 8, + 9 (1 and 3)
        const float2 wa = *reinterpret_cast<const float2*>(wt + 16 * kk + 2 * tq);
        const float2 wb = *reinterpret_cast<const float2*>(wt + 16 * kk + 8 + 2 * tq);
        uint32_t br[4];
        ldsm_x4_t(br, Bt + (16 * kk + lm_row) * bs + 16 * w + lm_col);
        br[0] = scaled(br[0], wa);
        br[1] = scaled(br[1], wb);
        br[2] = scaled(br[2], wa);
        br[3] = scaled(br[3], wb);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          uint32_t r[4];
          ldsm_x4_t(r, X + (16 * kk + lm_row) * XS + 16 * m + lm_col);
          // rows p 16m + g and + 8 at steps 2tq.. (r[0], r[2]) and 2tq + 8.. (r[1], r[3])
          const uint32_t xa[4] = {r[0], r[2], r[1], r[3]};
          mma(st[m][0], xa, br[0], br[1]);
          mma(st[m][1], xa, br[2], br[3]);
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int n = 16 * w + 8 * hf + 2 * tq;
          *reinterpret_cast<uint32_t*>(Hn + (16 * m + g) * bs + n) =
              pack(st[m][hf][0], st[m][hf][1]);
          *reinterpret_cast<uint32_t*>(Hn + (16 * m + g + 8) * bs + n) =
              pack(st[m][hf][2], st[m][hf][3]);
        }
    }
  }

  // The final state, fp32, from the registers.
  if (w >= nk) return;
  float* so = state_out + (((long long)b * H + h) * P + p0) * N;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int n = 16 * w + 8 * hf + 2 * tq;
      const int pa = 16 * m + g, pb = pa + 8;
      if (n >= N) continue;
      if (p0 + pa < P)
        *reinterpret_cast<float2*>(so + (long long)pa * N + n) =
            make_float2(st[m][hf][0], st[m][hf][1]);
      if (p0 + pb < P)
        *reinterpret_cast<float2*>(so + (long long)pb * N + n) =
            make_float2(st[m][hf][2], st[m][hf][3]);
    }
}

struct Args {
  const bf16 *x, *dt, *A, *Bm, *Cm;
  const float* cb;
  bf16* y;
  float* state;
  int S, H, G, P, N;
  long long st[8];  // batch and sequence strides of x, dt, Bm, Cm
};

template <int NP>
cudaError_t launch(dim3 grid, const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(NP);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_tc_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_scan_tc_kernel<NP><<<grid, NT, smem, stream>>>(
      a.x, a.dt, a.A, a.Bm, a.Cm, a.cb, a.y, a.state, a.S, a.H, a.G, a.P, a.N, a.st[0], a.st[1],
      a.st[2], a.st[3], a.st[4], a.st[5], a.st[6], a.st[7]);
  return cudaGetLastError();
}

}  // namespace

// As ssd_scan.cu's ssd_scan_fwd, for bf16 (`dtype` 1) only, with P and N
// multiples of 8 up to 128, x, Bm and Cm 16-byte aligned and their batch and
// sequence strides multiples of 8 elements, and one more argument: `cb`,
// fp32 scratch of B * G * ceil(S / 64) * 64 * 64 values for the prepass's
// C B^T.  Launches the prepass, then the scan, on `stream`.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int ssd_scan_tc_fwd(int dtype, const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* cb, void* y, void* state,
                               int B,
                               int S, int H, int G, int P, int N, long long xsb, long long xss,
                               long long dsb, long long dss, long long bsb, long long bss,
                               long long csb, long long css, void* stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(Bm) |
                         reinterpret_cast<uintptr_t>(Cm);
  if (dtype != kBFloat16 || B < 1 || B > 65535 || S < 1 || H < 1 || H > 65535 || G < 1 ||
      H % G || P < 8 || P > MAXD || P % 8 || N < 8 || N > MAXD || N % 8 || ptrs % 16 ||
      (xsb | xss | bsb | bss | csb | css) % 8)
    return cudaErrorInvalidValue;
  const int np = (N + 15) / 16 * 16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nchunks = (S + L - 1) / L;
  ssd_cb_kernel<<<dim3(nchunks, G, B), CB_NT, 2 * L * row_stride(np) * sizeof(bf16), s>>>(
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm), static_cast<float*>(cb), S, G,
      N, bsb, bss, csb, css);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((P + PS - 1) / PS, H, B);
  const Args args{static_cast<const bf16*>(x), static_cast<const bf16*>(dt),
                  static_cast<const bf16*>(A), static_cast<const bf16*>(Bm),
                  static_cast<const bf16*>(Cm), static_cast<const float*>(cb),
                  static_cast<bf16*>(y), static_cast<float*>(state), S, H, G, P, N,
                  {xsb, xss, dsb, dss, bsb, bss, csb, css}};
  switch (np) {
    case 16: return launch<16>(grid, args, s);
    case 32: return launch<32>(grid, args, s);
    case 48: return launch<48>(grid, args, s);
    case 64: return launch<64>(grid, args, s);
    case 80: return launch<80>(grid, args, s);
    case 96: return launch<96>(grid, args, s);
    case 112: return launch<112>(grid, args, s);
    default: return launch<128>(grid, args, s);
  }
}

extern "C" const char* ssd_scan_tc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
