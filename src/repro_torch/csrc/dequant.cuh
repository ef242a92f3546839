// The core of the two prefill dequant-matmuls, templated on where Ŵ's
// scale comes from:
//
//   y[M, N] (f32) = x[M, K] (bf16) · Ŵᵀ,   Ŵ = bf16(lut[unpack(Q)] ⊙ scale)
//
//   TF32   scale = clamp(B·A), S by 3xTF32 wgmma in the kernel (LoRDS)
//   S_MEM  scale = clamp(S), S = B·A staged from a pre-pass (LoRDS, ranks
//          whose split B does not fit in shared memory)
//   BLOCK  scale = s_blk[n, k / bs] (block-wise / QLoRA / the frozen base)
//
// What bounds it on an H100: at the main path's shapes (M = 2176 or 4096,
// N, K = 1024..14336) the bf16 product is far above the card's byte/FLOP
// ridge, so the function is bound by tensor-core operations.  The LoRDS S =
// B·A rebuild adds 2r FLOP per weight for every block of x rows, in f32.
//
// The design (the transposed product yᵀ = Ŵ·xᵀ):
//  * A CTA owns 128 Ŵ rows (two warpgroups of 64) and 256 x rows, and walks
//    K in steps of 64.  Each Ŵ element is built once per CTA and K step, by
//    the thread that holds it in its `wgmma` A fragment: the scale's cost is
//    amortised over 256 rows of x, and Ŵ never touches shared memory.
//  * The product is `wgmma.mma_async` m64n128k16 with A (Ŵ) from registers
//    and B (the x tile, K-major, 128-byte swizzle) from shared memory.
//  * TF32: S = B·A runs on the tensor cores at f32 accuracy: 3xTF32 `wgmma`
//    m64n64k8 (B_lo·A_hi + B_hi·A_lo + B_hi·A_hi), with B and A split into
//    tf32 hi / lo parts once per call by a small pre-pass and the rank padded
//    to a multiple of 8 with zeros.  The f32 accumulator of S is laid out
//    like the bf16 A fragment of the product, so S -> clamp -> x lut[code]
//    -> bf16 stays in registers.
//  * S_MEM: the pre-pass writes S = B·A in f32 (N, K) and the kernel stages
//    S tiles in place of the A slices.
//  * BLOCK: each step stages, in place of the A slices, the scale columns
//    its 64 columns touch for the CTA's 128 rows (one at bs = 64, 128, 256,
//    two at bs = 32, up to two at bs = 96), column-major.  A thread's
//    column of a pair is found from the step's offset into its block by a
//    compare (bs >= 64) or a multiply-shift (bs < 64), never a division;
//    Ŵ is bf16(lut[code] · s), rounded once, as the plain version rounds
//    it.  No S, no pre-pass, no workspace beyond the split-K partials.
//  * Step i issues S of step i+1 (TF32) and the product of step i to the
//    tensor cores back to back; step i+1's Ŵ is then built on the ALUs
//    while the product runs, into the other of two fragment register sets.
//  * x tiles, packed codes and A slices (S tiles, scales) arrive through
//    rings of `cp.async` stages issued two or three steps ahead; one
//    barrier per K step is the rings'.  Rows past M are zero-filled by the
//    copy and never stored, so the caller pads nothing in M.
//  * Narrow N leaves SMs idle: the wrapper splits K over `splits` CTAs per
//    output tile, which write f32 partials that a second kernel sums in
//    split order (deterministic).
//
// Shapes: any M >= 1, N % 128 == 0, K % 64 == 0, and in BLOCK K % bs == 0
// (the dispatch layer pads N and K); codes of a row sit at bit k·BITS of
// its little-endian byte stream, which covers the 2-, 3-, 4- and 8-bit pack
// layouts alike.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "lords_common.cuh"

namespace dequant {

using namespace hopper;

constexpr int BM = 256;      // x rows of a CTA (the wgmma N side, two n128 halves)
constexpr int BN = 128;      // Ŵ rows of a CTA (two warpgroups of 64)
constexpr int BK = 64;       // k per step: one 128-byte swizzle row of bf16
constexpr int THREADS = 256;
constexpr int X_STAGE = BM * BK * 2;  // bytes of one x tile
constexpr int SS = BK + 8;            // f32 row stride of a staged S tile
constexpr int SC = BN + 8;            // f32 stride of a staged scale column
constexpr size_t kMaxSmem = 232448;   // what one block may use on an H100

enum Mode { TF32 = 0, S_MEM = 1, BLOCK = 2 };

// Shared memory of one CTA, in bytes from a 1024-aligned base.
//
// Two rings.  x tile j is loaded at step j - lx into slot j % sx and read
// by step j's product; step j's codes and its A_hi / A_lo tiles (S tile,
// scale columns) are loaded at step j - lq into slot j % sq and read at
// step j - 1, where step j's Ŵ is built.  A slot is refilled only after its
// reader is done: product(i) is complete at step i + 2, so sx >= lx + 2;
// the build at step j - 1 is done at step j, so sq >= lq.  `pending` is how
// many cp.async groups may be in flight at the top of a step.  `bw` holds
// the CTA's B_hi / B_lo tiles in TF32 mode.
struct Plan {
  int mode, sx, lx, sq, lq, pending, r8, cols;
  size_t x, q, bw, lut, total, codes, a_tile, q_stage, bw_tile;
};

template <int BITS>
__host__ __device__ inline Plan make_plan(int mode, int r8, int cols, bool deep) {
  constexpr int QW = lords::code_stride64<BITS>();
  Plan p;
  p.mode = mode;
  p.r8 = r8;
  p.cols = cols;
  p.sx = deep ? 4 : 3;
  p.lx = deep ? 2 : 1;
  p.sq = deep ? 3 : 2;
  p.lq = deep ? 3 : 2;
  p.pending = deep ? 1 : 0;
  p.codes = (size_t)BN * QW * 4;
  p.a_tile = mode == TF32 ? (size_t)BK * 8 * r8 * 4 : 0;   // one of A_hi / A_lo
  p.bw_tile = mode == TF32 ? (size_t)BN * 8 * r8 * 4 : 0;  // one of B_hi / B_lo
  p.q_stage = p.codes + (mode == TF32    ? 2 * p.a_tile
                         : mode == S_MEM ? (size_t)BN * SS * 4
                                         : (size_t)cols * SC * 4);
  p.x = 0;
  p.q = p.x + (size_t)p.sx * X_STAGE;
  p.bw = p.q + (size_t)p.sq * p.q_stage;
  p.lut = p.bw + 2 * p.bw_tile;
  p.total = p.lut + 256 * 4 + 1024;  // + slack to align the base to 1024
  return p;
}

// The fastest LoRDS plan that fits: 3xTF32 in the kernel with the deep
// ring, then the shallow one; else S from memory, which fits at any rank.
template <int BITS>
inline Plan choose_plan(int r) {
  const int r8 = (r + 7) / 8;
  for (int mode = 0; mode < 2; ++mode) {
    const Plan p = make_plan<BITS>(TF32, r8, 0, mode == 0);
    if (p.total <= kMaxSmem) return p;
  }
  return make_plan<BITS>(S_MEM, r8, 0, false);
}

// Scale columns one K step can touch at block size bs
inline int block_cols(int bs) {
  const int c = (BK - 1) / bs + 2;
  return c < BK ? c : BK;
}

// The block-scale plan: the deep ring where it fits (every bs >= 2)
template <int BITS>
inline Plan choose_block_plan(int bs) {
  const Plan p = make_plan<BITS>(BLOCK, 0, block_cols(bs), true);
  return p.total <= kMaxSmem ? p : make_plan<BITS>(BLOCK, 0, block_cols(bs), false);
}

// The staged scale column of offset o (< bs + BK) into the step's first
// block: a compare when a step spans at most two blocks, else o / bs by a
// multiply-shift, exact for o < 128 with m16 = ceil(2^16 / bs).
__device__ __forceinline__ int block_col(int o, int bs, uint32_t m16) {
  return bs >= BK ? (int)(o >= bs) : (int)(((uint32_t)o * m16) >> 16);
}

// x (M, K) bf16; q (N, K·BITS/8) u8; src: the pre-pass's split A / B
// (TF32), S (N, K) f32 (S_MEM) or s_blk (N, K / bs) f32 (BLOCK); y (M, N)
// f32, or split-K partials (splits, M, N)
template <int BITS, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
dequant_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
               const float* __restrict__ ws, const float* __restrict__ lut,
               float* __restrict__ y, int M, int N, int K, int r8, int n_levels, int deep,
               int cols, int bs) {
  constexpr int QW = lords::code_stride64<BITS>();
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const Plan P = make_plan<BITS>(MODE, r8, cols, deep);
  const int rp = 8 * r8;
  float* lut_s = reinterpret_cast<float*>(smem + P.lut);
  // the pre-pass output (see hopper::prepass_kernel)
  const float* a_hi = ws;
  const float* a_lo = ws + (size_t)rp * K;
  const float* b_hi = a_lo + (size_t)rp * K;
  const float* b_lo = b_hi + (size_t)N * rp;
  // BLOCK: s_blk's row stride, and the multiplier of block_col
  const int nblk = MODE == BLOCK ? K / bs : 0;
  const uint32_t m16 = MODE == BLOCK ? (65536u + bs - 1) / bs : 0;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nk = K / BK;
  const int kb0 = (int)((long long)nk * blockIdx.z / gridDim.z);
  const int kb1 = (int)((long long)nk * (blockIdx.z + 1) / gridDim.z);
  const int steps = kb1 - kb0;
  const size_t row_bytes = (size_t)K * BITS / 8;

  for (int i = tid; i < 256; i += THREADS) lut_s[i] = i < n_levels ? lut[i] : 0.f;

  // this thread's x copies: rows xr + 32j, 16-byte chunk xc; rows past M
  // are zero-filled
  const int xr = tid >> 3, xc = tid & 7;
  const __nv_bfloat16* xsrc = x + (size_t)(m0 + xr) * K + xc * 8;
  const uint32_t xdst = xr * 128 + ((xc ^ (xr & 7)) << 4);
  uint32_t xlive = 0;
#pragma unroll
  for (int j = 0; j < BM / 32; ++j) xlive |= (uint32_t)(m0 + xr + 32 * j < M) << j;

  auto load_x = [&](int step) {
    const int k0 = (kb0 + step) * BK;
    const uint32_t xs = smem_u32(smem + P.x + (size_t)(step % P.sx) * X_STAGE) + xdst;
#pragma unroll
    for (int j = 0; j < BM / 32; ++j) {
      const bool live = (xlive >> j) & 1u;
      cp_async16(xs + j * 32 * 128, live ? xsrc + (size_t)32 * j * K + k0 : x, live ? 16 : 0);
    }
  };
  auto q_stage = [&](int step) { return smem + P.q + (size_t)(step % P.sq) * P.q_stage; };
  auto load_q = [&](int step) {
    const int kb = kb0 + step;
    const uint32_t qs = smem_u32(q_stage(step));
    // a row's 8·BITS bytes of this step, in 16-byte copies (8 at 3 bits)
    constexpr int CB = BITS == 3 ? 8 : 16, PER_ROW = 8 * BITS / CB;
    for (int i = tid; i < BN * PER_ROW; i += THREADS) {
      const int row = i / PER_ROW, c = i % PER_ROW;
      const uint8_t* src = q + (size_t)(n0 + row) * row_bytes + (size_t)kb * BK * BITS / 8 + CB * c;
      if constexpr (CB == 8) cp_async8(qs + row * QW * 4 + CB * c, src);
      else cp_async16(qs + row * QW * 4 + CB * c, src, 16);
    }
    const uint32_t rest = qs + (uint32_t)P.codes;
    if constexpr (MODE == S_MEM) {  // the S tile: 128 rows x 64 columns
#pragma unroll
      for (int j = 0; j < BN * BK / 4 / THREADS; ++j) {
        const int i = tid + j * THREADS, row = i >> 4, c = i & 15;
        cp_async16(rest + (row * SS + 4 * c) * 4,
                   ws + (size_t)(n0 + row) * K + (size_t)kb * BK + 4 * c, 16);
      }
    } else if constexpr (MODE == TF32) {  // A_hi and A_lo, contiguous in the pre-pass layout
      const int chunks = (int)(P.a_tile / 16);
      for (int i = tid; i < 2 * chunks; i += THREADS) {
        const int hl = i >= chunks, c = i - hl * chunks;
        cp_async16(rest + (uint32_t)(hl * P.a_tile) + 16 * c,
                   (hl ? a_lo : a_hi) + (size_t)kb * (P.a_tile / 4) + 4 * c, 16);
      }
    } else {  // the scale columns, column c of row n at c·SC + n
      const int c0 = kb * BK / bs, nsc = (kb * BK + BK - 1) / bs - c0 + 1;
      for (int i = tid; i < BN * nsc; i += THREADS) {
        const int row = i % BN, c = i / BN;
        cp_async4(rest + (c * SC + row) * 4, ws + (size_t)(n0 + row) * nblk + c0 + c);
      }
    }
  };

  // S of step `step` for this warpgroup's 64 Ŵ rows x 64 columns: 3xTF32
  // wgmma over 8-rank chunks, the resident B tiles x the step's A tiles.
  const uint32_t bw = smem_u32(smem + P.bw) + (warp >> 2) * 8 * 128;
  auto issue_s = [&](int step, float (&sacc)[32]) {
    const uint32_t ah = smem_u32(q_stage(step)) + (uint32_t)P.codes;
    s_3xtf32(sacc, bw, bw + (uint32_t)P.bw_tile, BN * 16, ah, ah + (uint32_t)P.a_tile, BK * 16,
             r8);
  };

  // Ŵ = bf16(lut[code] · scale) into the wgmma A fragments `fr`.  The
  // scale of n8 tile j, element e: row g (e < 2) or g + 8 of this warp's
  // 16, column 8j + 2t + (e & 1) — in registers (sacc[4j + e]), the staged
  // S tile or the staged scale columns.
  const int wrow = 16 * warp + g;
  auto build = [&](int step, const float (&sacc)[32], uint32_t* fr) {
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(q_stage(step)) + wrow * QW;
    const uint32_t* q1 = q0 + 8 * QW;
    const float* rest = reinterpret_cast<const float*>(q_stage(step) + P.codes);
    const float* st = rest + wrow * SS + 2 * t;
    // BLOCK: the step's offset into its first block, and odd blocks, whose
    // boundaries may split a column pair
    int r0 = 0;
    bool odd = false;
    if constexpr (MODE == BLOCK) {
      const int k0 = (kb0 + step) * BK;
      r0 = k0 - k0 / bs * bs;
      odd = bs & 1;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float s[4];
      if constexpr (MODE == S_MEM) {
        const float2 s0 = *reinterpret_cast<const float2*>(st + 8 * j);
        const float2 s1 = *reinterpret_cast<const float2*>(st + 8 * SS + 8 * j);
        s[0] = lords::clamp_scale(s0.x), s[1] = lords::clamp_scale(s0.y);
        s[2] = lords::clamp_scale(s1.x), s[3] = lords::clamp_scale(s1.y);
      } else if constexpr (MODE == TF32) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[e] = lords::clamp_scale(sacc[4 * j + e]);
      } else {
        const int o = r0 + 8 * j + 2 * t;
        const int ca = block_col(o, bs, m16), cb = odd ? block_col(o + 1, bs, m16) : ca;
        const float* col = rest + wrow;
        s[0] = col[ca * SC], s[1] = col[cb * SC];
        s[2] = col[ca * SC + 8], s[3] = col[cb * SC + 8];
      }
      const uint64_t c0 = lords::code_window<BITS>(q0, j) >> (2 * t * BITS);
      const uint64_t c1 = lords::code_window<BITS>(q1, j) >> (2 * t * BITS);
      const __nv_bfloat162 p0 = __floats2bfloat162_rn(lut_s[(uint32_t)c0 & kMask] * s[0],
                                                      lut_s[(uint32_t)(c0 >> BITS) & kMask] * s[1]);
      const __nv_bfloat162 p1 = __floats2bfloat162_rn(lut_s[(uint32_t)c1 & kMask] * s[2],
                                                      lut_s[(uint32_t)(c1 >> BITS) & kMask] * s[3]);
      // k16 slice j/2; an even n8 tile fills regs 0 (row g) and 1 (row g+8)
      fr[4 * (j >> 1) + 2 * (j & 1)] = *reinterpret_cast<const uint32_t*>(&p0);
      fr[4 * (j >> 1) + 2 * (j & 1) + 1] = *reinterpret_cast<const uint32_t*>(&p1);
    }
  };

  float acc[2][64];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
  uint32_t afr[2][16];  // Ŵ fragments of two K steps: 4 k16 slices x 4 regs
  float sacc[32];

  // prologue: the split B tiles (resident) and the first steps' data
  if constexpr (MODE == TF32) {
    const uint32_t bs_ = smem_u32(smem + P.bw);
    const int chunks = (int)(P.bw_tile / 16);
    for (int i = tid; i < 2 * chunks; i += THREADS) {
      const int hl = i >= chunks, c = i - hl * chunks;
      cp_async16(bs_ + (uint32_t)(hl * P.bw_tile) + 16 * c,
                 (hl ? b_lo : b_hi) + (size_t)blockIdx.x * (P.bw_tile / 4) + 4 * c, 16);
    }
  }
  const int lead = P.lx > P.lq ? P.lx : P.lq;
  for (int i = 0; i < lead; ++i) {
    if (i < P.lx && i < steps) load_x(i);
    if (i < P.lq && i < steps) load_q(i);
    cp_async_commit();
  }
  if (lead == 3) cp_async_wait<2>(); else cp_async_wait<1>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if constexpr (MODE == TF32) {
    issue_s(0, sacc);
    wgmma_wait<0>();
  }
  build(0, sacc, afr[0]);

  // Step it: S of step it+1, then the product of step it, both async on the
  // tensor cores; step it+1's Ŵ is built while the product runs.
  auto step = [&](int it, uint32_t* fr, uint32_t* fr_next) {
    if (P.pending == 1) cp_async_wait<1>(); else cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (it + P.lx < steps) load_x(it + P.lx);
    if (it + P.lq < steps) load_q(it + P.lq);
    cp_async_commit();
    const bool next = it + 1 < steps;
    if constexpr (MODE == TF32) {
      if (next) issue_s(it + 1, sacc);
    }
    const uint32_t xs = smem_u32(smem + P.x + (size_t)(it % P.sx) * X_STAGE);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      wgmma_m64n128k16(acc[0], fr + 4 * s, x_desc(xs + 32 * s));
      wgmma_m64n128k16(acc[1], fr + 4 * s, x_desc(xs + 128 * 128 + 32 * s));
    }
    wgmma_commit();
    wgmma_wait<1>();  // S of step it+1 and the product of step it-1 are done
    if (next) build(it + 1, sacc, fr_next);
  };

  for (int it = 0; it < steps; it += 2) {
    step(it, afr[0], afr[1]);
    if (it + 1 < steps) step(it + 1, afr[1], afr[0]);
  }
  wgmma_wait<0>();
  cp_async_wait<0>();

  // acc[h][4i + e]: Ŵ row wrow (+8 for e >= 2), x row 128h + 8i + 2t + (e & 1)
  float* out = y + (size_t)blockIdx.z * M * N;
  const int n = n0 + wrow;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int m = m0 + 128 * h + 8 * i + 2 * t;
      if (m < M) {
        out[(size_t)m * N + n] = acc[h][4 * i];
        out[(size_t)m * N + n + 8] = acc[h][4 * i + 2];
      }
      if (m + 1 < M) {
        out[(size_t)(m + 1) * N + n] = acc[h][4 * i + 1];
        out[(size_t)(m + 1) * N + n + 8] = acc[h][4 * i + 3];
      }
    }
}

// y = Σ_s part[s] in split order (deterministic), float4 at a time
template <int = 0>
__global__ void splitk_sum_kernel(const float4* __restrict__ part, float4* __restrict__ y,
                                  size_t n4, int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 s = part[i];
    for (int p = 1; p < splits; ++p) {
      const float4 v = part[(size_t)p * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    y[i] = s;
  }
}

// Launch the kernel of plan `p` on the grid (N / 128, ceil(M / 256),
// splits) into y, or into `part` (splits, M, N) summed into y after it when
// splits > 1; returns the CUDA error of the launches.
template <int BITS, int MODE>
inline cudaError_t run(const Plan& p, const void* x, const void* q, const float* src,
                       const void* lut, float* y, float* part, int M, int N, int K,
                       int n_levels, int splits, int bs, cudaStream_t stream) {
  cudaError_t err = lords::allow_smem(dequant_kernel<BITS, MODE>, p.total);
  if (err != cudaSuccess) return err;
  float* out = splits > 1 ? part : y;
  dim3 grid(N / BN, (M + BM - 1) / BM, splits);
  dequant_kernel<BITS, MODE><<<grid, THREADS, p.total, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q), src,
      static_cast<const float*>(lut), out, M, N, K, p.r8, n_levels, p.sx == 4, p.cols, bs);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n4 = (size_t)M * N / 4;
  splitk_sum_kernel<0><<<grid_for(n4), 256, 0, stream>>>(reinterpret_cast<const float4*>(part),
                                                      reinterpret_cast<float4*>(y), n4, splits);
  return cudaGetLastError();
}

// The shapes every mode takes
inline bool shapes_ok(int M, int N, int K, int splits) {
  return M >= 1 && N >= BN && N % BN == 0 && K >= BK && K % BK == 0 && splits >= 1 &&
         splits <= K / BK;
}

}  // namespace dequant
