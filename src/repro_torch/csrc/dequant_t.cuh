// The core of the two transposed dequant-matmuls (the activation gradient
// of a quantized linear), templated on where Ŵ's scale comes from:
//
//   dx[M, K] (f32) = g[M, N] (bf16) · Ŵ,   Ŵ = bf16(lut[unpack(Q)] ⊙ scale)
//
//   TF32   scale = clamp(B·A), S by 3xTF32 wgmma in the kernel (LoRDS)
//   S_MEM  scale = clamp(S), S = B·A staged from a pre-pass (LoRDS, ranks
//          whose split A does not fit in shared memory)
//   BLOCK  scale = s_blk[n, k / bs] (block-wise / QLoRA / PEQA)
//
// The design is the forward kernel's (csrc/lords_matmul.cu) turned around,
// as the transposed product dxᵀ = Ŵᵀ · gᵀ:
//  * A CTA owns 128 dx columns (two warpgroups of 64 rows of Ŵᵀ) and 256
//    tokens, and walks N, the reduction axis, in steps of 64: one 128-byte
//    swizzle row of bf16 g.  The whole reduction stays in the CTA, so dx is
//    deterministic and needs no atomics.
//  * The product is `wgmma.mma_async` m64n128k16, two token halves, with A
//    (Ŵᵀ) from registers and B (the 256 x 64 g tile, K-major, 128-byte
//    swizzle) from shared memory: the role and layout of the forward's x.
//  * Ŵᵀ is built in the A fragment by the thread that multiplies it.  Its
//    two Ŵᵀ rows (dx columns kl and kl + 8) are fixed for the whole N loop,
//    so the word and shift of its codes in every staged code row, its A
//    slices and its block-scale columns are found once per CTA.  The
//    fragment's pairs run along n, so a thread reads 16 code rows a step;
//    the code-row stride is padded so that the four rows a warp reads at
//    once fall on distinct banks.
//  * TF32: Sᵀ = Aᵀ·Bᵀ by 3xTF32 wgmma m64n64k8 (A_lo·B_hi + A_hi·B_lo +
//    A_hi·B_hi), the rank padded to a multiple of 8.  Both operands are
//    K-major in r and come from the pre-pass in 64-row tiles: the CTA's two
//    A tiles stay in shared memory for the whole loop, each step's B tile
//    arrives in the ring with its codes.  The f32 accumulator of Sᵀ is laid
//    out as the bf16 A fragment of the product.
//  * BLOCK: the step's scale columns are staged column-major beside its
//    codes; no S and no division per element.
//  * Step i issues S of step i+1 and the product of step i to the tensor
//    cores back to back, then builds step i+1's Ŵᵀ while the product runs,
//    into the other of two fragment register sets.
//  * g tiles arrive by TMA (one thread issues a 256 x 64 box a step into a
//    ring slot, completion on the slot's mbarrier), two or three steps
//    ahead; codes and B tiles (or S tiles, or scales) through a ring of
//    `cp.async` stages; one barrier a step.  Copying g with `cp.async`
//    cost about 170 instructions a thread and step, and a layer 15% more
//    time (PERF.md).  Sharing a g tile between two CTAs of a
//    cluster (TMA multicast) was slower still: each CTA then waits for its
//    peer before refilling a slot.
//  * The epilogue writes dx through shared memory (the g ring is free by
//    then), so the stores run along K and coalesce.  Token rows past M are
//    read as zeros by the TMA and never stored.
//
// Shapes: any M >= 1, N % 64 == 0, K % 128 == 0; codes of a row sit at bit
// k·BITS of its little-endian byte stream, which covers the 2-, 3-, 4- and
// 8-bit pack layouts alike.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "lords_common.cuh"

namespace dequant_t {

constexpr int BM = 256;      // tokens of a CTA (the wgmma N side, two n128 halves)
constexpr int BK = 128;      // dx columns of a CTA (two warpgroups of 64 Ŵᵀ rows)
constexpr int BN = 64;       // n per step: one 128-byte swizzle row of bf16 g
constexpr int THREADS = 256;
constexpr int G_STAGE = BM * BN * 2;  // bytes of one g tile
constexpr int SS = BK + 4;            // f32 row stride of a staged S or dx tile
constexpr size_t kMaxSmem = 232448;   // what one block may use on an H100

enum Mode { TF32 = 0, S_MEM = 1, BLOCK = 2 };

// Shared memory of one CTA, in bytes from a 1024-aligned base.
//
// Two rings, as in the forward kernel.  g tile j is loaded at step j - lx
// into slot j % sx (its arrival tracked by mbarrier j % sx at `bars`) and
// read by step j's product; step j's codes and its B_hi / B_lo tiles (or S
// tile, or scales) are loaded at step j - lq into slot j % sq and read at
// step j - 1, where step j's Ŵᵀ is built.  product(i) is complete at step
// i + 2, so sx >= lx + 2; the build at step j - 1 is done at step j, so
// sq >= lq.  `pending` is how many cp.async groups may be in flight at the
// top of a step.  `res` holds the CTA's A_hi / A_lo tiles in TF32 mode.
struct Plan {
  int mode, sx, lx, sq, lq, pending, r8, cols;
  size_t g, q, res, lut, bars, total, codes, a_tile, b_tile, q_stage;
};

// Words of a staged code row (its 128 codes), padded so that four rows two
// apart fall on banks 8 apart: the rows a warp's threads read at once.
template <int BITS>
__host__ __device__ constexpr int code_stride() {
  return (4 * BITS) % 8 == 0 ? 4 * BITS + 4 : 4 * BITS;
}

// r8: the rank in groups of 8 (TF32); cols: scale columns a step stages
// (BLOCK)
template <int BITS>
__host__ __device__ inline Plan make_plan(int mode, int r8, int cols, bool deep) {
  Plan p;
  p.mode = mode;
  p.r8 = r8;
  p.cols = cols;
  p.sx = deep ? 4 : 3;
  p.lx = deep ? 2 : 1;
  p.sq = deep ? 3 : 2;
  p.lq = deep ? 3 : 2;
  p.pending = deep ? 1 : 0;
  p.codes = (size_t)BN * code_stride<BITS>() * 4;
  p.a_tile = mode == TF32 ? (size_t)64 * 8 * r8 * 4 : 0;  // one warpgroup's A_hi or A_lo
  p.b_tile = mode == TF32 ? (size_t)BN * 8 * r8 * 4 : 0;  // one of the step's B_hi / B_lo
  const size_t rest = mode == TF32    ? 2 * p.b_tile
                      : mode == S_MEM ? (size_t)BN * SS * 4
                                      : (size_t)cols * BN * 4;
  p.q_stage = p.codes + (rest + 15) / 16 * 16;
  p.g = 0;
  p.q = p.g + (size_t)p.sx * G_STAGE;
  p.res = p.q + (size_t)p.sq * p.q_stage;
  p.lut = p.res + 4 * p.a_tile;
  p.bars = p.lut + 256 * 4;      // one mbarrier per g slot
  p.total = p.bars + 64 + 1024;  // + slack to align the base to 1024
  return p;
}

// The fastest plan that fits: the deep ring, then the shallow one; a LoRDS
// rank whose split A and B fit neither takes S from memory, which fits at
// any rank.
template <int BITS>
inline Plan choose_plan(int mode, int r, int cols) {
  const int r8 = (r + 7) / 8;
  for (int deep = 1; deep >= 0; --deep) {
    const Plan p = make_plan<BITS>(mode, r8, cols, deep);
    if (p.total <= kMaxSmem) return p;
  }
  return make_plan<BITS>(S_MEM, r8, cols, false);
}

// Scale columns a CTA's 128 dx columns can touch at block size bs
inline int block_cols(int bs) {
  const int c = (BK - 1) / bs + 2;
  return c < BK ? c : BK;
}

using namespace hopper;

// This thread's two codes of a staged row: columns kl and kl + 8, where the
// 16 codes from 16·(kl / 16) start at word `cw`, and code kl lies `cs` bits
// into the word (BITS 2, 4, 8) or the two-word window (BITS 3) there.
template <int BITS>
__device__ __forceinline__ void code_pair(const uint32_t* row, int cw, int cs, uint32_t& ca,
                                          uint32_t& cb) {
  constexpr uint32_t m = (1u << BITS) - 1u;
  if constexpr (BITS == 2) {
    const uint32_t v = row[cw];
    ca = (v >> cs) & m;
    cb = (v >> (cs + 16)) & m;
  } else if constexpr (BITS == 3) {
    const uint64_t v = (uint64_t)row[cw] | (uint64_t)row[cw + 1] << 32;
    ca = (uint32_t)(v >> cs) & m;
    cb = (uint32_t)(v >> (cs + 24)) & m;
  } else if constexpr (BITS == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(row + cw);
    ca = (v.x >> cs) & m;
    cb = (v.y >> cs) & m;
  } else {
    ca = (row[cw] >> cs) & m;
    cb = (row[cw + 2] >> cs) & m;
  }
}

// g (M, N) bf16; q (N, K·BITS/8) u8; src: the pre-pass's split A / B
// (TF32), S (N, K) f32 (S_MEM) or s_blk (N, K / bs) f32 (BLOCK); dx (M, K)
template <int BITS, int MODE, bool DEEP>
__global__ void __launch_bounds__(THREADS, 1)
dequant_t_kernel(const __grid_constant__ CUtensorMap g_map, const uint8_t* __restrict__ q,
                 const float* __restrict__ src, const float* __restrict__ lut,
                 float* __restrict__ dx, int M, int N, int K, int r8, int cols, int bs,
                 int n_levels) {
  constexpr int QW = code_stride<BITS>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const Plan P = make_plan<BITS>(MODE, r8, cols, DEEP);
  float* lut_s = reinterpret_cast<float*>(smem + P.lut);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gi = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK, m0 = blockIdx.y * BM;
  const int steps = N / BN;
  const size_t row_bytes = (size_t)K * BITS / 8;
  // the pre-pass output in 64-row tiles (see hopper::prepass_kernel)
  const size_t rp = 8 * (size_t)r8;
  const float* a_hi = src;
  const float* a_lo = src + rp * K;
  const float* b_hi = a_lo + rp * K;
  const float* b_lo = b_hi + rp * N;
  // BLOCK: the first scale column of the CTA's dx columns, how many it
  // stages, and the row stride of s_blk
  const int nblk = MODE == BLOCK ? K / bs : 0;
  const int c0 = MODE == BLOCK ? k0 / bs : 0;
  const int nsc = MODE == BLOCK ? (k0 + BK - 1) / bs - c0 + 1 : 0;

  for (int i = tid; i < 256; i += THREADS) lut_s[i] = i < n_levels ? lut[i] : 0.f;

  // g tiles by TMA, issued by thread 0; rows past M read as zeros.  Slot
  // s's mbarrier completes once per use: use u of it has parity u & 1.
  const uint32_t bars = smem_u32(smem + P.bars);
  auto load_g = [&](int step) {
    const int slot = step % P.sx;
    const uint32_t bar = bars + 8 * slot;
    mbar_expect_tx(bar, G_STAGE);
    tma_load_2d(smem_u32(smem + P.g + (size_t)slot * G_STAGE), &g_map, bar, step * BN, m0);
  };
  auto q_stage = [&](int step) { return smem + P.q + (size_t)(step % P.sq) * P.q_stage; };
  auto load_q = [&](int step) {
    const int n0 = step * BN;
    const uint32_t qs = smem_u32(q_stage(step));
    // a row's 16·BITS bytes of the CTA's columns: BITS 16-byte copies
    for (int i = tid; i < BN * BITS; i += THREADS) {
      const int row = i / BITS, c = i % BITS;
      cp_async16(qs + row * QW * 4 + 16 * c,
                 q + (size_t)(n0 + row) * row_bytes + (size_t)k0 * BITS / 8 + 16 * c, 16);
    }
    const uint32_t rest = qs + (uint32_t)P.codes;
    if constexpr (MODE == TF32) {  // B_hi and B_lo, contiguous in the pre-pass layout
      const int chunks = (int)(P.b_tile / 16);
      for (int i = tid; i < 2 * chunks; i += THREADS) {
        const int hl = i >= chunks, c = i - hl * chunks;
        cp_async16(rest + (uint32_t)(hl * P.b_tile) + 16 * c,
                   (hl ? b_lo : b_hi) + (size_t)step * (P.b_tile / 4) + 4 * c, 16);
      }
    } else if constexpr (MODE == S_MEM) {  // the S tile: 64 rows x 128 columns
#pragma unroll
      for (int j = 0; j < BN * BK / 4 / THREADS; ++j) {
        const int i = tid + j * THREADS, row = i >> 5, c = i & 31;
        cp_async16(rest + (row * SS + 4 * c) * 4, src + (size_t)(n0 + row) * K + k0 + 4 * c, 16);
      }
    } else {  // the scales, column-major: column c of row n at c·BN + n
      if (tid < BN) {
        const float* srow = src + (size_t)(n0 + tid) * nblk + c0;
        for (int c = 0; c < nsc; ++c) cp_async4(rest + (c * BN + tid) * 4, srow + c);
      }
    }
  };

  // this thread's Ŵᵀ rows: dx columns kl and kl + 8 of the CTA's 128
  const int kl = 16 * warp + gi;
  int cw, cs;  // its codes in a staged row (see code_pair)
  if constexpr (BITS == 2) cw = warp, cs = 2 * gi;
  else if constexpr (BITS == 3) cw = (48 * warp) >> 5, cs = ((48 * warp) & 31) + 3 * gi;
  else if constexpr (BITS == 4) cw = 2 * warp, cs = 4 * gi;
  else cw = 4 * warp + (gi >> 2), cs = 8 * (gi & 3);
  // BLOCK: its two scale columns among the staged ones
  const int sca = MODE == BLOCK ? (k0 + kl) / bs - c0 : 0;
  const int scb = MODE == BLOCK ? (k0 + kl + 8) / bs - c0 : 0;

  // Sᵀ of step `step` for this warpgroup's 64 dx columns x 64 n: 3xTF32
  // wgmma over 8-rank chunks, the resident A tiles x the step's B tiles
  // (both 64-row tiles, rank groups of 4 lie 1024 bytes apart).
  const uint32_t a_res = smem_u32(smem + P.res) + (uint32_t)((warp >> 2) * P.a_tile);
  auto issue_s = [&](int step, float (&sacc)[32]) {
    const uint32_t bh = smem_u32(q_stage(step)) + (uint32_t)P.codes;
    s_3xtf32(sacc, a_res, a_res + (uint32_t)(2 * P.a_tile), 64 * 16, bh,
             bh + (uint32_t)P.b_tile, 64 * 16, r8);
  };

  // Ŵᵀ into the wgmma A fragments `fr`.  n8 tile j holds step rows 8j + 2t
  // (e = 0) and 8j + 2t + 1 (e = 1); element (kl, n) of Sᵀ is sacc[4j + e],
  // (kl + 8, n) is sacc[4j + 2 + e].
  auto build = [&](int step, const float (&sacc)[32], uint32_t* fr) {
    const unsigned char* st = q_stage(step);
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(st) + 2 * t * QW;
    const float* rest = reinterpret_cast<const float*>(st + P.codes);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t ca[2], cb[2];
      code_pair<BITS>(q0 + 8 * j * QW, cw, cs, ca[0], cb[0]);
      code_pair<BITS>(q0 + (8 * j + 1) * QW, cw, cs, ca[1], cb[1]);
      float s[4];  // (row e = 0, kl), (1, kl), (0, kl + 8), (1, kl + 8)
      if constexpr (MODE == TF32) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[e] = lords::clamp_scale(sacc[4 * j + e]);
      } else if constexpr (MODE == S_MEM) {
        const float* sr = rest + (8 * j + 2 * t) * SS + kl;
        s[0] = lords::clamp_scale(sr[0]);
        s[1] = lords::clamp_scale(sr[SS]);
        s[2] = lords::clamp_scale(sr[8]);
        s[3] = lords::clamp_scale(sr[SS + 8]);
      } else {
        const float* sr = rest + 8 * j + 2 * t;
        s[0] = sr[sca * BN];
        s[1] = sr[sca * BN + 1];
        s[2] = sr[scb * BN];
        s[3] = sr[scb * BN + 1];
      }
      const __nv_bfloat162 p0 = __floats2bfloat162_rn(lut_s[ca[0]] * s[0], lut_s[ca[1]] * s[1]);
      const __nv_bfloat162 p1 = __floats2bfloat162_rn(lut_s[cb[0]] * s[2], lut_s[cb[1]] * s[3]);
      // k16 slice j/2; an even n8 tile fills regs 0 (row kl) and 1 (row kl+8)
      fr[4 * (j >> 1) + 2 * (j & 1)] = *reinterpret_cast<const uint32_t*>(&p0);
      fr[4 * (j >> 1) + 2 * (j & 1) + 1] = *reinterpret_cast<const uint32_t*>(&p1);
    }
  };

  float acc[2][64];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
  uint32_t afr[2][16];  // Ŵᵀ fragments of two steps: 4 k16 slices x 4 regs
  float sacc[32];

  // prologue: the split A tiles (resident) and the first steps' data
  if constexpr (MODE == TF32) {
    const uint32_t as = smem_u32(smem + P.res);
    const int chunks = (int)(2 * P.a_tile / 16);  // the CTA's two 64-column tiles
    for (int i = tid; i < 2 * chunks; i += THREADS) {
      const int hl = i >= chunks, c = i - hl * chunks;
      cp_async16(as + (uint32_t)(hl * 2 * P.a_tile) + 16 * c,
                 (hl ? a_lo : a_hi) + (size_t)blockIdx.x * (2 * P.a_tile / 4) + 4 * c, 16);
    }
  }
  if (tid == 0) {
    for (int s = 0; s < P.sx; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int lead = P.lx > P.lq ? P.lx : P.lq;
  for (int i = 0; i < lead; ++i) {
    if (tid == 0 && i < P.lx && i < steps) load_g(i);
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
  // tensor cores; step it+1's Ŵᵀ is built while the product runs.
  auto step = [&](int it, uint32_t* fr, uint32_t* fr_next) {
    if (P.pending == 1) cp_async_wait<1>(); else cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0 && it + P.lx < steps) load_g(it + P.lx);
    if (it + P.lq < steps) load_q(it + P.lq);
    cp_async_commit();
    const bool next = it + 1 < steps;
    if constexpr (MODE == TF32) {
      if (next) issue_s(it + 1, sacc);
    }
    const uint32_t gs = smem_u32(smem + P.g + (size_t)(it % P.sx) * G_STAGE);
    mbar_wait(bars + 8 * (it % P.sx), (it / P.sx) & 1);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      wgmma_m64n128k16(acc[0], fr + 4 * s, x_desc(gs + 32 * s));
      wgmma_m64n128k16(acc[1], fr + 4 * s, x_desc(gs + 128 * 128 + 32 * s));
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
  __syncthreads();

  // Epilogue, one half of the tokens at a time through shared memory:
  // acc[h][4i + e] is dx column kl (+8 for e >= 2) of token 128h + 8i + 2t +
  // (e & 1); then each row's 128 columns go out as float4 stores along K.
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float* row = tile + (8 * i + 2 * t) * SS + kl;
      row[0] = acc[h][4 * i];
      row[SS] = acc[h][4 * i + 1];
      row[8] = acc[h][4 * i + 2];
      row[SS + 8] = acc[h][4 * i + 3];
    }
    __syncthreads();
    for (int i = tid; i < 128 * (BK / 4); i += THREADS) {
      const int row = i / (BK / 4), c = i % (BK / 4);
      const int m = m0 + 128 * h + row;
      if (m < M)
        *reinterpret_cast<float4*>(dx + (size_t)m * K + k0 + 4 * c) =
            *reinterpret_cast<const float4*>(tile + row * SS + 4 * c);
    }
    __syncthreads();
  }
}

// Launch the kernel of `p` on the grid (K / 128, ceil(M / 256)); returns
// the CUDA error of the launch (cudaErrorInvalidValue: the driver refused
// g's tensor map).
template <int BITS, int MODE, bool DEEP>
inline cudaError_t launch_plan(const Plan& p, const void* g, const void* q, const float* src,
                               const void* lut, void* dx, int M, int N, int K, int bs,
                               int n_levels, cudaStream_t stream) {
  CUtensorMap map;
  if (!bf16_tile_map(&map, g, M, N, BM)) return cudaErrorInvalidValue;
  cudaError_t err = lords::allow_smem(dequant_t_kernel<BITS, MODE, DEEP>, p.total);
  if (err != cudaSuccess) return err;
  dim3 grid(K / BK, (M + BM - 1) / BM);
  dequant_t_kernel<BITS, MODE, DEEP><<<grid, THREADS, p.total, stream>>>(
      map, static_cast<const uint8_t*>(q), src, static_cast<const float*>(lut),
      static_cast<float*>(dx), M, N, K, p.r8, p.cols, bs, n_levels);
  return cudaGetLastError();
}

template <int BITS, int MODE>
inline cudaError_t run(const Plan& p, const void* g, const void* q, const float* src,
                       const void* lut, void* dx, int M, int N, int K, int bs, int n_levels,
                       cudaStream_t stream) {
  return p.sx == 4
             ? launch_plan<BITS, MODE, true>(p, g, q, src, lut, dx, M, N, K, bs, n_levels, stream)
             : launch_plan<BITS, MODE, false>(p, g, q, src, lut, dx, M, N, K, bs, n_levels, stream);
}

// The shapes every mode takes
inline bool shapes_ok(int M, int N, int K) {
  return M >= 1 && N >= BN && N % BN == 0 && K >= BK && K % BK == 0;
}

}  // namespace dequant_t
