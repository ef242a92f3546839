// The core of the two decode-shaped dequant products (M <= 8 tokens),
// templated on where Ŵ's scale comes from:
//
//   y[M, N] (f32) = x[M, K] (bf16) · Ŵᵀ,   Ŵ = bf16(lut[unpack(Q)] ⊙ scale)
//
//   LORDS      scale = clamp(B·A), S by 3xTF32 on the tensor cores
//              (csrc/lords_decode.cu)
//   BLOCK      scale = s_blk[n, k / bs], bs % 16 == 0 (block_matmul.cu's
//              decode entry); BLOCK_ANY the same at any bs
//
// What bounds it on an H100: each weight is used once per call, so the
// packed codes (0.5 byte a weight at nf4) and the scales' bytes are the
// floor, 0.035 ms for llama3-8b's seven linears at 3.35 TB/s.  Keeping up
// with that rate leaves about 5 lane-instructions a weight, so the build
// of Ŵ and its product must cost few instructions; and LoRDS's S = B·A is
// 2r FLOP a weight, which only the tensor cores can afford (three TF32
// passes of it, 0.058 ms a layer at 495 TFLOP/s, bound LoRDS).
//
// The design (the transposed product yᵀ = Ŵ·xᵀ, every weight built once):
//  * The product is `mma.sync` m16n8k16 bf16: Ŵ's 16 rows x 16 k are the A
//    operand, built in registers by the thread that multiplies them; xᵀ is
//    the B operand, whose 8 columns are the tokens (rows past M are
//    zero-filled by the copy).  No FMA a token: M only sets the n8 side.
//  * The k columns of each k16 step are permuted: thread t of a quad takes
//    4 consecutive columns, and over a k64 half 16 (16t .. 16t+15, four
//    steps), for Ŵ and x alike.  A thread's codes of a row are then one 2-,
//    4-, 8- or 16-byte shared-memory read a half, its x fragments two
//    16-byte reads, and the sum is unchanged (both operands permuted).
//  * Ŵ = bf16(lut[code] · scale), rounded once as the plain version rounds
//    it.  The LUT sits at a 1024-aligned shared address, so a lookup is a
//    shift, one LOP3 (mask, OR the base) and one LDS.
//  * A CTA owns 256 rows and walks its K range in stages of 128 columns;
//    codes (64 bytes a row and stage at nf4, XOR-swizzled 16-byte chunks so
//    the fragment reads are conflict-free) and x arrive through a ring of
//    `cp.async` stages (four; three at int8 on the wgmma path).  Issuing a
//    stage's copies takes about a third of a warp's cycles (a clock64
//    probe); TMA boxes in their place were no faster (PERF.md §6).
//  * LORDS at r <= 24 (gemv_wg_kernel, every model's ranks): 16 warps, one
//    m16 tile each; a warpgroup computes S for its 64 rows and a quarter of
//    a stage (32 columns) with 3xTF32 `wgmma` m64n32k8 (B_lo·A_hi +
//    B_hi·A_lo + B_hi·A_hi: f32 accuracy; one TF32 pass flips bf16
//    roundings of Ŵ), both operands K-major tf32 tiles in shared memory: B's
//    split rows, written once per CTA, and A's split columns, written once a
//    stage in two buffers, in the product's permuted column order, so each
//    accumulator is the A fragment of the bf16 product as it lies and S ->
//    clamp -> x lut[code] -> bf16 never leaves registers.  The next
//    quarter's S is issued before this one is waited for and runs while
//    this one is built; every warp issues, waits and builds alike (a wgmma
//    or an accumulator read on a divergent path makes the compiler
//    serialize the wgmma), and only live rows are stored.
//  * LORDS at larger ranks (gemv_kernel): 8 warps of two m16 tiles; S by
//    3xTF32 `mma.sync` m16n8k8, B's split fragments re-read from L1 for
//    each use, A's written once a stage into shared memory in fragment
//    order (one 16-byte read per thread, chunk and k16 step).
//  * BLOCK (gemv_kernel): 8 warps of two m16 tiles, two CTAs an SM; at bs %
//    16 == 0 a thread's 16 columns of a half share one scale a row, loaded
//    one stage ahead (s_blk's column by a multiply-shift, no division).
//    BLOCK_ANY, a kernel of its own (compiled into one, its per-element
//    path cost the fast path's weights their issue slots even when
//    predicated off), reads each element's scale from L1.
//  * Narrow N leaves SMs idle: the grid splits K over `splits` CTAs per
//    256-row tile (the wrapper's plan).  Each writes its partial y to a
//    workspace and takes a ticket; the last CTA of a tile sums the partials
//    in split order and resets the ticket, so the result is bitwise the
//    same from run to run, with no atomics on y and no zero-filled output.
//
// Shapes: 1 <= M <= 8, N % 32 == 0 (whole warps), K % 128 == 0, and
// in BLOCK K % bs == 0 (the dispatch layer pads N and K; padded scales are
// 1.0); codes of a row sit at bit k·BITS of its little-endian byte stream.
// Launches on one stream run one after another; two at once on two streams
// would share the tickets.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "lords_common.cuh"

namespace gemv {

using namespace hopper;

constexpr int ROWS = 256;     // Ŵ rows of a CTA
constexpr int KSTEP = 128;    // k of one stage: two k64 halves
constexpr int THREADS = 256;  // 8 warps
constexpr int TILES = 2;      // m16 tiles of a warp (32 rows)
constexpr int MMAX = 8;       // tokens: the n8 side of the product
constexpr int STAGES = 4;
constexpr int XROW = KSTEP * 2 + 16;  // bytes of a staged x row (+16: conflict-free reads)

enum Mode { LORDS = 0, BLOCK = 1, BLOCK_ANY = 2 };

// bytes of a row's codes in one stage
template <int BITS>
__host__ __device__ constexpr int qrow() {
  return KSTEP * BITS / 8;
}

// Dynamic shared memory of one CTA, in bytes: the code and x rings and
// LORDS's split A fragments of a stage (8 k16 steps x r8 chunks x hi / lo x
// 32 lanes x 16 bytes).
struct Plan {
  size_t q, x, a, total;
};

template <int BITS>
__host__ __device__ inline Plan plan(int mode, int r8) {
  Plan p;
  p.q = 0;
  p.x = p.q + (size_t)STAGES * ROWS * qrow<BITS>();
  p.a = p.x + (size_t)STAGES * MMAX * XROW;
  p.total = p.a + (mode == LORDS ? (size_t)8 * r8 * 2 * 32 * 16 : 0);
  return p;
}

// The 16-byte chunk a row's chunk c is stored at: XOR-swizzled so that the
// rows of a fragment read fall on distinct banks (3 bits: 3 chunks a row,
// not swizzled).
template <int BITS>
__device__ __forceinline__ int swz(int row) {
  if constexpr (BITS == 4) return row & 2;
  else if constexpr (BITS == 2) return (row >> 2) & 1;
  else if constexpr (BITS == 8) return (row & 1) << 2;
  else return 0;
}

// A thread's 16 codes of one row in k64 half h (columns 64h + 16t ..
// +15): code i at bit i·BITS of w
template <int BITS>
__device__ __forceinline__ void load_window(const unsigned char* row_base, int row, int h, int t,
                                            uint32_t (&w)[4]) {
  if constexpr (BITS == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(
        row_base + 16 * ((2 * h + (t >> 1)) ^ swz<4>(row)) + 8 * (t & 1));
    w[0] = v.x, w[1] = v.y;
  } else if constexpr (BITS == 2) {
    w[0] = *reinterpret_cast<const uint32_t*>(row_base + 16 * (h ^ swz<2>(row)) + 4 * t);
  } else if constexpr (BITS == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(row_base + 16 * ((4 * h + t) ^ swz<8>(row)));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else {  // 48 bits at bit 192h + 48t
    const int bit = 192 * h + 48 * t;
    const uint32_t* words = reinterpret_cast<const uint32_t*>(row_base);
    const uint64_t v =
        ((uint64_t)words[(bit >> 5) + 1] << 32 | words[bit >> 5]) >> (bit & 31);
    w[0] = (uint32_t)v, w[1] = (uint32_t)(v >> 32);
  }
}

// Code i (0..15, a constant after unrolling) of a window
template <int BITS>
__device__ __forceinline__ uint32_t code_at(const uint32_t (&w)[4], int i) {
  if constexpr (BITS == 4) return (w[i >> 3] >> (4 * (i & 7))) & 15u;
  else if constexpr (BITS == 2) return (w[0] >> (2 * i)) & 3u;
  else if constexpr (BITS == 8) return (w[i >> 2] >> (8 * (i & 3))) & 255u;
  else return (uint32_t)((((uint64_t)w[1] << 32) | w[0]) >> (3 * i)) & 7u;
}

// lut[code i of w], the LUT at a 1024-aligned shared address `base`: the
// address is the code's byte offset OR-ed into it (a shift, one LOP3 and
// one LDS a weight)
template <int BITS>
__device__ __forceinline__ float lut_level(const uint32_t (&w)[4], int i, uint32_t base) {
  float v;
  asm("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"((code_at<BITS>(w, i) << 2) | base));
  return v;
}

// A stage into the rings, NT threads: every row's codes of its 128 columns
// (16-byte chunks, rows past N skipped) and the M rows of x (zero-filled
// past M).  Where a row's chunks are a power of two, a thread copies chunk
// tid % CH of rows tid / CH + u·(NT / CH), whose swizzle is that of its
// first row.
template <int BITS, int NT>
struct Stager {
  static constexpr int QROW = qrow<BITS>(), CH = QROW / 16, RU = NT / CH;
  static constexpr bool POW2 = (CH & (CH - 1)) == 0;
  const uint8_t* q;
  const __nv_bfloat16* x;
  const uint8_t* csrc;
  size_t row_bytes;
  uint32_t cdst;
  int n0, N, K, M, crow;

  __device__ Stager(const uint8_t* q_, const __nv_bfloat16* x_, int n0_, int N_, int K_, int M_)
      : q(q_), x(x_), row_bytes((size_t)K_ * BITS / 8), n0(n0_), N(N_), K(K_), M(M_),
        crow(threadIdx.x / CH) {
    const int cch = threadIdx.x % CH;
    csrc = q + (size_t)(n0 + crow) * row_bytes + 16 * cch;
    cdst = crow * QROW + 16 * (cch ^ swz<BITS>(crow));
  }

  // stage ks (K columns ks·KSTEP ..) into the code slot qs and the x slot xs
  __device__ __forceinline__ void copy(uint32_t qs, uint32_t xs, int ks) const {
    const int tid = threadIdx.x;
    if constexpr (POW2) {
#pragma unroll
      for (int u = 0; u < ROWS / RU; ++u)
        if (n0 + crow + u * RU < N)
          cp_async16(qs + cdst + u * RU * QROW,
                     csrc + (size_t)u * RU * row_bytes + (size_t)ks * QROW, 16);
    } else {
      for (int i = tid; i < ROWS * CH; i += NT) {
        const int row = i / CH, ch = i % CH;
        if (n0 + row < N)
          cp_async16(qs + row * QROW + 16 * (ch ^ swz<BITS>(row)),
                     q + (size_t)(n0 + row) * row_bytes + (size_t)ks * QROW + 16 * ch, 16);
      }
    }
    if (tid < MMAX * 16) {
      const int m = tid >> 4, ch = tid & 15;
      const bool on = m < M;
      cp_async16(xs + m * XROW + 16 * ch, on ? x + (size_t)m * K + ks * KSTEP + 8 * ch : x,
                 on ? 16 : 0);
    }
  }
};

// lut level · clamp_scale(s) with one max, one sign XOR and one product
// (sign(s)·level·max(|s|, eps)): equal to the plain version's for every s
// but -0.0, which clamp_scale takes to +eps and this to -eps.  A rank sum
// is -0.0 only when every one of its products is a negative zero, and then
// Ŵ is ±level·1e-8 either way.
__device__ __forceinline__ float times_clamped(float level, float s) {
  return __uint_as_float(__float_as_uint(level) ^ (__float_as_uint(s) & 0x80000000u)) *
         fmaxf(fabsf(s), lords::kScaleEps);
}

// After every CTA of a row tile wrote its partial y to ws: the last CTA to
// take the tile's ticket sums the partials in split order into y and resets
// the ticket for the next launch.  `last` is a shared flag.
template <int NT>
__device__ __forceinline__ void sum_splits(float* __restrict__ y, const float* __restrict__ ws,
                                           int* __restrict__ tickets, int M, int N, int n0,
                                           int& last) {
  const int tid = threadIdx.x, splits = gridDim.y;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const bool done = atomicAdd(tickets + blockIdx.x, 1) == splits - 1;
    if (done) tickets[blockIdx.x] = 0;  // ready for the next launch
    last = done;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < M * ROWS; i += NT) {
    const int m = i / ROWS, n = n0 + i % ROWS;
    if (n >= N) continue;
    float v = 0.f;
    for (int sp = 0; sp < splits; ++sp) v += __ldcg(ws + ((size_t)sp * M + m) * N + n);
    y[(size_t)m * N + n] = v;
  }
}

// x (M, K) bf16; q (N, K·BITS/8) u8; LORDS: b (N, r), a (r, K) f32; BLOCK: b
// is s_blk (N, K / bs) f32 and a unused; y (M, N) f32; ws: splits·M·N f32
// partials (splits > 1); tickets: one int32 a 256-row tile, zero (left
// zero).  LORDS here takes any rank, B's fragments re-read from L1 for each
// use (gemv_wg_kernel serves r <= 24); magic = ceil(2^32 / bs).
template <int BITS, int MODE>
__global__ void __launch_bounds__(THREADS, 2)
gemv_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
            const float* __restrict__ b, const float* __restrict__ a,
            const float* __restrict__ lut, float* __restrict__ y, float* __restrict__ ws,
            int* __restrict__ tickets, int M, int N, int K, int r, int n_levels, int bs,
            unsigned long long magic) {
  constexpr int QROW = qrow<BITS>();
  extern __shared__ __align__(16) unsigned char smem[];
  // the LUT at a 1024-aligned shared address: a lookup's address is the
  // code's byte offset OR-ed into it (one LOP3 with the extraction's mask)
  __shared__ __align__(1024) float lut_s[256];
  __shared__ int last;
  const int r8 = MODE == LORDS ? (r + 7) / 8 : 1;  // 1: no A split (and no division by 0)
  const Plan P = plan<BITS>(MODE, r8);
  float4* afrag = reinterpret_cast<float4*>(smem + P.a);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * ROWS, wrow = 32 * warp;
  const bool live = n0 + wrow < N;  // N % 32 == 0: a warp's rows are all in or all out
  const int nsteps = K / KSTEP;
  const int s0 = (int)((long long)nsteps * blockIdx.y / gridDim.y);
  const int steps = (int)((long long)nsteps * (blockIdx.y + 1) / gridDim.y) - s0;
  const int nblk = MODE != LORDS ? K / bs : 0;
  auto blk = [&](int col) { return (int)(((unsigned long long)col * magic) >> 32); };

  for (int i = tid; i < 256; i += THREADS) lut_s[i] = i < n_levels ? lut[i] : 0.f;
  const uint32_t lut_base = smem_u32(lut_s);
  const Stager<BITS, THREADS> stager(q, x, n0, N, K, M);
  auto load_stage = [&](int it) {
    const int slot = it % STAGES;
    stager.copy(smem_u32(smem + P.q + (size_t)slot * ROWS * QROW),
                smem_u32(smem + P.x + (size_t)slot * MMAX * XROW), s0 + it);
  };

  // LORDS: item i of a stage's split A fragments: k16 step qs = rest / r8
  // (half qs / 4, step qs % 4), chunk rest % r8, lane i % 32 — the B
  // operand of the S mma for both of the step's 8-column halves, ranks
  // 8c + t and 8c + t + 4 at the columns the lane's g stands for
  auto a_item = [&](int i, int k0, float (&v)[4]) {
    const int ln = i & 31, rest = i >> 5, qs = rest / r8, c = rest - qs * r8;
    const int gg = ln >> 2, tt = ln & 3;
    const int col = k0 + 64 * (qs >> 2) + 16 * (gg >> 1) + 4 * (qs & 3) + (gg & 1);
    const int ra = 8 * c + tt, rb = ra + 4;
    v[0] = ra < r ? __ldg(a + (size_t)ra * K + col) : 0.f;
    v[1] = rb < r ? __ldg(a + (size_t)rb * K + col) : 0.f;
    v[2] = ra < r ? __ldg(a + (size_t)ra * K + col + 2) : 0.f;
    v[3] = rb < r ? __ldg(a + (size_t)rb * K + col + 2) : 0.f;
  };
  auto a_store = [&](int i, const float (&v)[4]) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(v[e], hi[e], lo[e]);
    const int ln = i & 31, rest = i >> 5;
    afrag[(rest * 2) * 32 + ln] = make_float4(__uint_as_float(hi[0]), __uint_as_float(hi[1]),
                                             __uint_as_float(hi[2]), __uint_as_float(hi[3]));
    afrag[(rest * 2 + 1) * 32 + ln] = make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]),
                                                 __uint_as_float(lo[2]), __uint_as_float(lo[3]));
  };

  // LORDS: the split A-operand fragments (B's rows) of tile `tile`, chunk c
  auto b_frag = [&](int tile, int c, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    const int na = n0 + wrow + 16 * tile + g, nb = na + 8, ra = 8 * c + t, rb = ra + 4;
    const float v[4] = {ra < r ? __ldg(b + (size_t)na * r + ra) : 0.f,
                        ra < r ? __ldg(b + (size_t)nb * r + ra) : 0.f,
                        rb < r ? __ldg(b + (size_t)na * r + rb) : 0.f,
                        rb < r ? __ldg(b + (size_t)nb * r + rb) : 0.f};
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(v[e], hi[e], lo[e]);
  };

  // BLOCK, bs % 16 == 0: the scale of (tile, row g / g + 8, half) of a stage
  auto load_scales = [&](int it, float (&sc)[TILES][2][2]) {
    const int k0 = (s0 + it) * KSTEP;
#pragma unroll
    for (int tile = 0; tile < TILES; ++tile)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          sc[tile][hr][h] = __ldg(b + (size_t)(n0 + wrow + 16 * tile + g + 8 * hr) * nblk +
                                  blk(k0 + 64 * h + 16 * t));
  };

  // prologue: the ring's first stages, and the registers of stage 0
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < steps) load_stage(i);
    cp_async_commit();
  }
  float scn[TILES][2][2], scc[TILES][2][2];
  if constexpr (MODE == BLOCK) {
    if (live) load_scales(0, scn);
  }

  float acc[TILES][4];
#pragma unroll
  for (int tile = 0; tile < TILES; ++tile)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[tile][e] = 0.f;

  for (int it = 0; it < steps; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage it has landed; every warp is done with stage it - 1
    const int k0 = (s0 + it) * KSTEP;
    if constexpr (MODE == LORDS) {
      for (int i = tid; i < THREADS * r8; i += THREADS) {
        float v[4];
        a_item(i, k0, v);
        a_store(i, v);
      }
    }
    if (it + STAGES - 1 < steps) load_stage(it + STAGES - 1);
    cp_async_commit();
    if constexpr (MODE == BLOCK) {
      if (live) {
#pragma unroll
        for (int tile = 0; tile < TILES; ++tile)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
#pragma unroll
            for (int h = 0; h < 2; ++h) scc[tile][hr][h] = scn[tile][hr][h];
        if (it + 1 < steps) load_scales(it + 1, scn);
      }
    }
    if constexpr (MODE == LORDS) __syncthreads();  // the split A fragments are written
    if (!live) continue;

    const int slot = it % STAGES;
    const unsigned char* qs = smem + P.q + (size_t)slot * ROWS * QROW;
    const unsigned char* xs = smem + P.x + (size_t)slot * MMAX * XROW + g * XROW;
#pragma unroll 1  // one k64 half at a time: registers for two CTAs an SM
    for (int h = 0; h < 2; ++h) {
      // BLOCK: this half's scales, selected (an index by h would put the
      // array in local memory)
      float sch[TILES][2];
      if constexpr (MODE == BLOCK) {
#pragma unroll
        for (int tile = 0; tile < TILES; ++tile)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) sch[tile][hr] = h ? scc[tile][hr][1] : scc[tile][hr][0];
      }
      // x of token g at this thread's 16 columns; codes of its 4 rows
      const uint4 xa = *reinterpret_cast<const uint4*>(xs + 2 * (64 * h + 16 * t));
      const uint4 xb = *reinterpret_cast<const uint4*>(xs + 2 * (64 * h + 16 * t) + 16);
      const uint32_t xf[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      uint32_t win[TILES][2][4];
#pragma unroll
      for (int tile = 0; tile < TILES; ++tile)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = wrow + 16 * tile + g + 8 * hr;
          load_window<BITS>(qs + (size_t)row * QROW, row, h, t, win[tile][hr]);
        }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // S of both tiles: [tile][8-column half][c0..c3 of the mma]
        float s[TILES][2][4];
        if constexpr (MODE == LORDS) {
#pragma unroll
          for (int tile = 0; tile < TILES; ++tile)
#pragma unroll
            for (int e = 0; e < 8; ++e) s[tile][e >> 2][e & 3] = 0.f;
          const int step = 4 * h + j;
          // chunk c: B_lo·A_hi + B_hi·A_lo + B_hi·A_hi for both tiles and
          // both 8-column halves
          auto s_chunk = [&](int c, const uint32_t (&fh)[TILES][4],
                             const uint32_t (&fl)[TILES][4]) {
            const float4 ah = afrag[((step * r8 + c) * 2) * 32 + lane];
            const float4 al = afrag[((step * r8 + c) * 2 + 1) * 32 + lane];
            // pass-major, so that four independent accumulators lie between
            // two products into one
#pragma unroll
            for (int pass = 0; pass < 3; ++pass)
#pragma unroll
              for (int tile = 0; tile < TILES; ++tile)
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                  const float4& av = pass == 1 ? al : ah;
                  mma_tf32(s[tile][half], pass == 0 ? fl[tile] : fh[tile],
                           __float_as_uint(half ? av.z : av.x),
                           __float_as_uint(half ? av.w : av.y));
                }
          };
          for (int c = 0; c < r8; ++c) {
            uint32_t fh[TILES][4], fl[TILES][4];
#pragma unroll
            for (int tile = 0; tile < TILES; ++tile) b_frag(tile, c, fh[tile], fl[tile]);
            s_chunk(c, fh, fl);
          }
        }
#pragma unroll
        for (int tile = 0; tile < TILES; ++tile) {
          // element (row g + 8hr, column 4j + e of the thread's 16)
          float w[2][4];
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float sv;
              if constexpr (MODE == LORDS) {
                sv = s[tile][e >> 1][2 * hr + (e & 1)];
              } else if constexpr (MODE == BLOCK) {
                sv = sch[tile][hr];
              } else {
                sv = __ldg(b + (size_t)(n0 + wrow + 16 * tile + g + 8 * hr) * nblk +
                           blk(k0 + 64 * h + 16 * t + 4 * j + e));
              }
              const float lv = lut_level<BITS>(win[tile][hr], 4 * j + e, lut_base);
              w[hr][e] = MODE == LORDS ? times_clamped(lv, sv) : lv * sv;
            }
          const uint32_t fr[4] = {pack_bf16(w[0][0], w[0][1]), pack_bf16(w[1][0], w[1][1]),
                                  pack_bf16(w[0][2], w[0][3]), pack_bf16(w[1][2], w[1][3])};
          mma_bf16(acc[tile], fr, xf[2 * j], xf[2 * j + 1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // acc[tile]: rows n (c0, c1) and n + 8 (c2, c3), tokens 2t and 2t + 1
  const int splits = gridDim.y;
  float* out = splits > 1 ? ws + (size_t)blockIdx.y * M * N : y;
  if (live) {
#pragma unroll
    for (int tile = 0; tile < TILES; ++tile) {
      const int n = n0 + wrow + 16 * tile + g, m = 2 * t;
      if (m < M) out[(size_t)m * N + n] = acc[tile][0], out[(size_t)m * N + n + 8] = acc[tile][2];
      if (m + 1 < M)
        out[(size_t)(m + 1) * N + n] = acc[tile][1], out[(size_t)(m + 1) * N + n + 8] = acc[tile][3];
    }
  }
  if (splits > 1) sum_splits<THREADS>(y, ws, tickets, M, N, n0, last);
}

// ---------------------------------------------------------------------------
// LORDS at r <= 24: S on `wgmma` (see the notes above).
constexpr int WG_THREADS = 512;

template <int BITS>
__host__ __device__ constexpr int wg_stages() {
  return BITS == 8 ? 3 : 4;  // int8's 128-byte rows: three stages fit
}

// Dynamic shared memory of the wgmma path: code and x rings, B's split rows
// (hi, lo: ROWS x 8·r8 tf32 each) and A's split columns (2 buffers x 4
// quarters x hi / lo x 32 columns x 8·r8 tf32).
struct WgPlan {
  size_t q, x, u, a, total;
};

template <int BITS>
__host__ __device__ inline WgPlan wg_plan(int r8) {
  WgPlan p;
  p.q = 0;
  p.x = p.q + (size_t)wg_stages<BITS>() * ROWS * qrow<BITS>();
  p.u = p.x + (size_t)wg_stages<BITS>() * MMAX * XROW;
  p.a = p.u + (size_t)2 * ROWS * 8 * r8 * 4;
  p.total = p.a + (size_t)2 * 4 * 2 * 32 * 8 * r8 * 4;
  return p;
}

// x, q, b, a, lut, y, ws, tickets as gemv_kernel's (LORDS), r <= 8·R8.
template <int BITS, int R8>
__global__ void __launch_bounds__(WG_THREADS, 1)
gemv_wg_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
               const float* __restrict__ b, const float* __restrict__ a,
               const float* __restrict__ lut, float* __restrict__ y, float* __restrict__ ws,
               int* __restrict__ tickets, int M, int N, int K, int r, int n_levels) {
  constexpr int QROW = qrow<BITS>(), ST = wg_stages<BITS>();
  constexpr int AT = 32 * 8 * R8 * 4;                      // bytes of one A split tile
  constexpr int AI = (4 * 32 * 2 * R8 + WG_THREADS - 1) / WG_THREADS;  // A items a thread
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(1024) float lut_s[256];
  __shared__ int last;
  const WgPlan P = wg_plan<BITS>(R8);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * ROWS, wrow = 16 * warp;
  const bool live = n0 + wrow < N;  // N % 32 == 0: a warp's 16 rows are all in or all out
  const int nsteps = K / KSTEP;
  const int s0 = (int)((long long)nsteps * blockIdx.y / gridDim.y);
  const int steps = (int)((long long)nsteps * (blockIdx.y + 1) / gridDim.y) - s0;

  for (int i = tid; i < 256; i += WG_THREADS) lut_s[i] = i < n_levels ? lut[i] : 0.f;
  const uint32_t lut_base = smem_u32(lut_s);
  const Stager<BITS, WG_THREADS> stager(q, x, n0, N, K, M);
  auto load_stage = [&](int it) {
    const int slot = it % ST;
    stager.copy(smem_u32(smem + P.q + (size_t)slot * ROWS * QROW),
                smem_u32(smem + P.x + (size_t)slot * MMAX * XROW), s0 + it);
  };

  // B's split rows, once: (row, rank) at float ((rank/4)·32 + row/8)·32 +
  // (row%8)·4 + rank%4 of the hi and lo tiles (rank groups 4096 bytes apart,
  // 8-row groups 128), rows past N and ranks past r zero
  const uint32_t uhi = smem_u32(smem + P.u), ulo = uhi + ROWS * 8 * R8 * 4;
  for (int i = tid; i < ROWS * 2 * R8; i += WG_THREADS) {
    const int row = i & (ROWS - 1), rg = i / ROWS;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = 4 * rg + e < r && n0 + row < N ? __ldg(b + (size_t)(n0 + row) * r + 4 * rg + e)
                                             : 0.f;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(v[e], hi[e], lo[e]);
    const int off = ((rg * 32 + (row >> 3)) * 32 + (row & 7) * 4) * 4;
    *reinterpret_cast<uint4*>(smem + P.u + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(smem + P.u + ROWS * 8 * R8 * 4 + off) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }

  // A's split columns of a stage: item i = (quarter qq, tile column n, rank
  // group rg); tile column n of quarter qq holds stage column
  // 64·(qq/2) + 16tt + 4s + 2·two + e for L = 32·(qq%2) + n, s = L/16,
  // and L%16 = 8·two + 2tt + e
  auto a_load = [&](int it, int i, float (&v)[4]) {
    const int n = i & 31, rg = (i >> 5) % (2 * R8), qq = (i >> 5) / (2 * R8);
    const int L = 32 * (qq & 1) + n, w = L & 15;
    const int col = (s0 + it) * KSTEP + 64 * (qq >> 1) + 16 * ((w & 7) >> 1) + 4 * (L >> 4) +
                    2 * (w >> 3) + (w & 1);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = 4 * rg + e < r ? __ldg(a + (size_t)(4 * rg + e) * K + col) : 0.f;
  };
  auto a_store = [&](int par, int i, const float (&v)[4]) {
    const int n = i & 31, rg = (i >> 5) % (2 * R8), qq = (i >> 5) / (2 * R8);
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(v[e], hi[e], lo[e]);
    unsigned char* tile = smem + P.a + (size_t)((par * 4 + qq) * 2) * AT;
    const int off = ((rg * 4 + (n >> 3)) * 32 + (n & 7) * 4) * 4;
    *reinterpret_cast<uint4*>(tile + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(tile + AT + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  };

  // S of (stage it, quarter qq) for this warpgroup's 64 rows, issued and
  // committed
  const uint32_t uwg = uhi + (warp >> 2) * 1024;
  auto issue_s = [&](int it, int qq, float (&sacc)[16]) {
    const uint32_t vh = smem_u32(smem + P.a) + ((it & 1) * 4 + qq) * 2 * AT;
    s_3xtf32(sacc, uwg, uwg + (ulo - uhi), ROWS * 16, vh, vh + AT, 32 * 16, R8);
  };

  // prologue: the ring's first stages, stage 0's A split, stage 1's loads
  for (int i = 0; i < ST - 1; ++i) {
    if (i < steps) load_stage(i);
    cp_async_commit();
  }
  float apre[AI][4];
#pragma unroll
  for (int u = 0; u < AI; ++u) {
    const int i = tid + WG_THREADS * u;
    if (i < 4 * 32 * 2 * R8) {
      a_load(0, i, apre[u]);
      a_store(0, i, apre[u]);
      if (steps > 1) a_load(1, i, apre[u]);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float sacc[2][16];
  issue_s(0, 0, sacc[0]);

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<ST - 2>();
    __syncthreads();  // stage it has landed; every warp is done with stage it - 1
    if (it + 1 < steps) {
#pragma unroll
      for (int u = 0; u < AI; ++u) {
        const int i = tid + WG_THREADS * u;
        if (i < 4 * 32 * 2 * R8) {
          a_store((it + 1) & 1, i, apre[u]);
          if (it + 2 < steps) a_load(it + 2, i, apre[u]);
        }
      }
    }
    if (it + ST - 1 < steps) load_stage(it + ST - 1);
    cp_async_commit();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // stage it + 1's A split is visible to the tensor cores

    const int slot = it % ST;
    const unsigned char* qs = smem + P.q + (size_t)slot * ROWS * QROW;
    const unsigned char* xs = smem + P.x + (size_t)slot * MMAX * XROW + g * XROW;
    uint32_t xf[8], win[2][4];
    // every warp builds and multiplies, live or not (a dead warp's rows
    // are not stored): a `wgmma` or an accumulator read on a divergent path
    // makes the compiler serialize the wgmma
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      const int h = qq >> 1;
      if ((qq & 1) == 0) {
        const uint4 xa = *reinterpret_cast<const uint4*>(xs + 2 * (64 * h + 16 * t));
        const uint4 xb = *reinterpret_cast<const uint4*>(xs + 2 * (64 * h + 16 * t) + 16);
        xf[0] = xa.x, xf[1] = xa.y, xf[2] = xa.z, xf[3] = xa.w;
        xf[4] = xb.x, xf[5] = xb.y, xf[6] = xb.z, xf[7] = xb.w;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = wrow + g + 8 * hr;
          load_window<BITS>(qs + (size_t)row * QROW, row, h, t, win[hr]);
        }
      }
      // the next quarter's S (the last stage's last quarter issues its own
      // first one again, unused), then wait for this one's
      issue_s(qq < 3 ? it : min(it + 1, steps - 1), (qq + 1) & 3, sacc[(qq + 1) & 1]);
      wgmma_wait<1>();
#pragma unroll
      for (int jl = 0; jl < 2; ++jl) {
        const int j = 2 * (qq & 1) + jl;  // k16 step of the half
        float w[2][4];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            w[hr][e] = times_clamped(lut_level<BITS>(win[hr], 4 * j + e, lut_base),
                                     sacc[qq & 1][4 * (2 * jl + (e >> 1)) + 2 * hr + (e & 1)]);
        const uint32_t fr[4] = {pack_bf16(w[0][0], w[0][1]), pack_bf16(w[1][0], w[1][1]),
                                pack_bf16(w[0][2], w[0][3]), pack_bf16(w[1][2], w[1][3])};
        mma_bf16(acc, fr, xf[2 * j], xf[2 * j + 1]);
      }
    }
  }
  wgmma_wait<0>();
  cp_async_wait<0>();

  const int splits = gridDim.y;
  float* out = splits > 1 ? ws + (size_t)blockIdx.y * M * N : y;
  if (live) {
    const int n = n0 + wrow + g, m = 2 * t;
    if (m < M) out[(size_t)m * N + n] = acc[0], out[(size_t)m * N + n + 8] = acc[2];
    if (m + 1 < M) out[(size_t)(m + 1) * N + n] = acc[1], out[(size_t)(m + 1) * N + n + 8] = acc[3];
  }
  if (splits > 1) sum_splits<WG_THREADS>(y, ws, tickets, M, N, n0, last);
}

// The shapes the core takes
inline bool shapes_ok(int M, int N, int K, int splits) {
  return M >= 1 && M <= MMAX && N >= 32 && N % 32 == 0 && K >= KSTEP && K % KSTEP == 0 &&
         splits >= 1 && splits <= K / KSTEP;
}

// Launch the core on the grid (ceil(N / 256), splits); returns the CUDA
// error of the launch.
template <int BITS, int MODE>
inline cudaError_t run(const void* x, const void* q, const void* b, const void* a,
                       const void* lut, void* y, void* ws, void* tickets, int M, int N, int K,
                       int r, int n_levels, int bs, int splits, cudaStream_t stream) {
  const Plan p = plan<BITS>(MODE, MODE == LORDS ? (r + 7) / 8 : 0);
  cudaError_t err = lords::allow_smem(gemv_kernel<BITS, MODE>, p.total);
  if (err != cudaSuccess) return err;
  const unsigned long long magic = bs > 0 ? ((1ull << 32) + bs - 1) / bs : 0;
  dim3 grid((N + ROWS - 1) / ROWS, splits);
  gemv_kernel<BITS, MODE><<<grid, THREADS, p.total, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(b), static_cast<const float*>(a),
      static_cast<const float*>(lut), static_cast<float*>(y), static_cast<float*>(ws),
      static_cast<int*>(tickets), M, N, K, r, n_levels, bs, magic);
  return cudaGetLastError();
}

// Launch the wgmma path (LORDS, r <= 8·R8) on the grid (ceil(N / 256),
// splits); returns the CUDA error of the launch.
template <int BITS, int R8>
inline cudaError_t run_wg(const void* x, const void* q, const void* b, const void* a,
                          const void* lut, void* y, void* ws, void* tickets, int M, int N, int K,
                          int r, int n_levels, int splits, cudaStream_t stream) {
  const WgPlan p = wg_plan<BITS>(R8);
  cudaError_t err = lords::allow_smem(gemv_wg_kernel<BITS, R8>, p.total);
  if (err != cudaSuccess) return err;
  dim3 grid((N + ROWS - 1) / ROWS, splits);
  gemv_wg_kernel<BITS, R8><<<grid, WG_THREADS, p.total, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(b), static_cast<const float*>(a),
      static_cast<const float*>(lut), static_cast<float*>(y), static_cast<float*>(ws),
      static_cast<int*>(tickets), M, N, K, r, n_levels);
  return cudaGetLastError();
}

}  // namespace gemv
