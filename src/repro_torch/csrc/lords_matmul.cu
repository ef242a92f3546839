// Fused LoRDS dequant-matmul for prefill-shaped inputs (M > 8 tokens).
//
//   y[M, N] (f32) = x[M, K] (bf16) · Ŵᵀ,   Ŵ = bf16(lut[unpack(Q)] ⊙ clamp(B·A))
//
// Replaces: src/repro/kernels/lords_matmul.py::lords_matmul_pallas (the
// TPU kernel behind every prefill and training-forward linear).
//
// What bounds it on an H100: at the main path's shapes (M = 2176 or 4096,
// N, K = 1024..14336) the bf16 product is far above the card's byte/FLOP
// ridge, so the function is bound by tensor-core operations.  The S = B·A
// rebuild adds 2r FLOP per weight for every block of x rows, in f32.  This
// design reaches 150-250 TFLOP/s on an H100 SXM (PERF.md): the x tile and
// the split A slices (48 KB a CTA and K step) cross L2 and shared memory,
// where the two warpgroups' product and S operands are read as well, and
// 3xTF32 S shares the tensor pipe with the product (6r/256 of its time).
//
// What the design does about it (the transposed product yᵀ = Ŵ·xᵀ):
//  * A CTA owns 128 Ŵ rows (two warpgroups of 64) and 256 x rows, and walks
//    K in steps of 64.  Each Ŵ element is built once per CTA and K step, by
//    the thread that holds it in its `wgmma` A fragment: the S rebuild is
//    amortised over 256 rows of x, and Ŵ never touches shared memory.
//  * The product is `wgmma.mma_async` m64n128k16 with A (Ŵ) from registers
//    and B (the x tile, K-major, 128-byte swizzle) from shared memory.
//  * S = B·A runs on the tensor cores at f32 accuracy: 3xTF32 `wgmma`
//    m64n64k8 (B_lo·A_hi + B_hi·A_lo + B_hi·A_hi), with B and A split into
//    tf32 hi / lo parts once per call by a small pre-pass and the rank padded
//    to a multiple of 8 with zeros.  The f32 accumulator of S is laid out
//    like the bf16 A fragment of the product, so S -> clamp -> x lut[code]
//    -> bf16 stays in registers.
//  * Step i issues S of step i+1 and the product of step i to the tensor
//    cores back to back; step i+1's Ŵ is then built on the ALUs while the
//    product runs, into the other of two fragment register sets.
//  * x tiles, packed codes and A slices arrive through rings of `cp.async`
//    stages issued two or three steps ahead; one barrier per K step is the
//    rings'.  Rows past M are zero-filled by the copy and never stored, so
//    the caller pads nothing in M.
//  * Narrow N leaves SMs idle: the wrapper splits K over `splits` CTAs per
//    output tile, which write f32 partials that a second kernel sums in
//    split order (deterministic).
//  * A rank whose split B does not fit in shared memory takes the second
//    mode: the pre-pass writes S = B·A in f32 (N, K) and the kernel stages
//    S tiles in place of the A slices.
//
// Shapes: any M >= 1, N % 128 == 0, K % 64 == 0 (the dispatch layer pads N
// and K); codes of a row sit at bit k·BITS of its little-endian byte
// stream, which covers the 2-, 3-, 4- and 8-bit pack layouts alike.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "lords_common.cuh"

namespace {

using namespace hopper;

constexpr int BM = 256;      // x rows of a CTA (the wgmma N side, two n128 halves)
constexpr int BN = 128;      // Ŵ rows of a CTA (two warpgroups of 64)
constexpr int BK = 64;       // k per step: one 128-byte swizzle row of bf16
constexpr int THREADS = 256;
constexpr int X_STAGE = BM * BK * 2;  // bytes of one x tile
constexpr int SS = BK + 8;            // f32 row stride of a staged S tile
constexpr size_t kMaxSmem = 232448;   // what one block may use on an H100

// Shared memory of one CTA, in bytes from a 1024-aligned base.
//
// Two rings.  x tile j is loaded at step j - lx into slot j % sx and read
// by step j's product; step j's codes and its A_hi / A_lo tiles (or its S
// tile) are loaded at step j - lq into slot j % sq and read at step j - 1,
// where step j's Ŵ is built.  A slot is refilled only after its reader is
// done: product(i) is complete at step i + 2, so sx >= lx + 2; the build
// at step j - 1 is done at step j, so sq >= lq.  `pending` is how many
// cp.async groups may be in flight at the top of a step.
struct Plan {
  bool s_mem;  // S precomputed in f32 and staged (else 3xTF32 in the kernel)
  int sx, lx, sq, lq, pending, r8;
  size_t x, q, bw, lut, total, codes, a_tile, q_stage, bw_tile;
};

// Words of a staged code row: its 2·BITS words rounded up to whole 16-byte
// copies, plus 4 where that makes the stride a multiple of 8 (the eight
// rows of a fragment then fall on distinct banks).
template <int BITS>
__host__ __device__ constexpr int code_stride() {
  return ((2 * BITS + 3) / 4 * 4) % 8 == 0 ? (2 * BITS + 3) / 4 * 4 + 4 : (2 * BITS + 3) / 4 * 4;
}

template <int BITS>
__host__ __device__ inline Plan make_plan(int r8, bool s_mem, bool deep) {
  constexpr int QW = code_stride<BITS>();
  Plan p;
  p.s_mem = s_mem;
  p.r8 = r8;
  p.sx = deep ? 4 : 3;
  p.lx = deep ? 2 : 1;
  p.sq = deep ? 3 : 2;
  p.lq = deep ? 3 : 2;
  p.pending = deep ? 1 : 0;
  p.codes = (size_t)BN * QW * 4;
  p.a_tile = s_mem ? 0 : (size_t)BK * 8 * r8 * 4;   // one of A_hi / A_lo
  p.bw_tile = s_mem ? 0 : (size_t)BN * 8 * r8 * 4;  // one of B_hi / B_lo
  p.q_stage = p.codes + (s_mem ? (size_t)BN * SS * 4 : 2 * p.a_tile);
  p.x = 0;
  p.q = p.x + (size_t)p.sx * X_STAGE;
  p.bw = p.q + (size_t)p.sq * p.q_stage;
  p.lut = p.bw + 2 * p.bw_tile;
  p.total = p.lut + 256 * 4 + 1024;  // + slack to align the base to 1024
  return p;
}

// The fastest plan that fits: 3xTF32 in the kernel with the deep ring, then
// the shallow one; else S from memory, which fits at any rank.
template <int BITS>
inline Plan choose_plan(int r) {
  const int r8 = (r + 7) / 8;
  for (int mode = 0; mode < 2; ++mode) {
    const Plan p = make_plan<BITS>(r8, false, mode == 0);
    if (p.total <= kMaxSmem) return p;
  }
  return make_plan<BITS>(r8, true, false);
}

// Codes 8j .. 8j+7 of a staged row (code c at bit c·BITS), in the low bits
template <int BITS>
__device__ __forceinline__ uint64_t code_window(const uint32_t* row, int j) {
  const int bit = 8 * j * BITS, w = bit >> 5, off = bit & 31;
  uint64_t v = row[w];
  if (off + 8 * BITS > 32) v |= (uint64_t)row[w + 1] << 32;
  return v >> off;
}

template <int BITS, bool S_MEM>
__global__ void __launch_bounds__(THREADS, 1)
lords_matmul_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
                    const float* __restrict__ ws, const float* __restrict__ lut,
                    float* __restrict__ y, int M, int N, int K, int r8, int n_levels,
                    int deep) {
  constexpr int QW = code_stride<BITS>();
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const Plan P = make_plan<BITS>(r8, S_MEM, deep);
  const int rp = 8 * r8;
  float* lut_s = reinterpret_cast<float*>(smem + P.lut);
  // the pre-pass output (see hopper::prepass_kernel)
  const float* a_hi = ws;
  const float* a_lo = ws + (size_t)rp * K;
  const float* b_hi = a_lo + (size_t)rp * K;
  const float* b_lo = b_hi + (size_t)N * rp;

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
    if constexpr (S_MEM) {  // the S tile: 128 rows x 64 columns
#pragma unroll
      for (int j = 0; j < BN * BK / 4 / THREADS; ++j) {
        const int i = tid + j * THREADS, row = i >> 4, c = i & 15;
        cp_async16(rest + (row * SS + 4 * c) * 4,
                   ws + (size_t)(n0 + row) * K + (size_t)kb * BK + 4 * c, 16);
      }
    } else {  // the A_hi and A_lo tiles, contiguous in the pre-pass layout
      const int chunks = (int)(P.a_tile / 16);
      for (int i = tid; i < 2 * chunks; i += THREADS) {
        const int hl = i >= chunks, c = i - hl * chunks;
        cp_async16(rest + (uint32_t)(hl * P.a_tile) + 16 * c,
                   (hl ? a_lo : a_hi) + (size_t)kb * (P.a_tile / 4) + 4 * c, 16);
      }
    }
  };

  // S of step `step` for this warpgroup's 64 Ŵ rows x 64 columns: 3xTF32
  // wgmma over 8-rank chunks, the resident B tiles x the step's A tiles.
  const uint32_t bw = smem_u32(smem + P.bw) + (warp >> 2) * 8 * 128;
  auto issue_s = [&](int step, float (&sacc)[32]) {
    const uint32_t ah = smem_u32(q_stage(step)) + (uint32_t)P.codes;
    const uint32_t al = ah + (uint32_t)P.a_tile;
    const uint32_t blbo = BN * 16, albo = BK * 16;  // bytes between rank groups
    wgmma_fence();
    for (int c = 0; c < r8; ++c) {
      const uint32_t bo = 2 * c * blbo, ao = 2 * c * albo;
      wgmma_m64n64k8_tf32(sacc, tf32_desc(bw + (uint32_t)P.bw_tile + bo, blbo),
                          tf32_desc(ah + ao, albo), c > 0);  // c == 0 starts S at 0
      wgmma_m64n64k8_tf32(sacc, tf32_desc(bw + bo, blbo), tf32_desc(al + ao, albo), 1);
      wgmma_m64n64k8_tf32(sacc, tf32_desc(bw + bo, blbo), tf32_desc(ah + ao, albo), 1);
    }
    wgmma_commit();
  };

  // Ŵ = bf16(lut[code] · clamp(S)) into the wgmma A fragments `fr`.  S of
  // n8 tile j, element e: row g (e < 2) or g + 8 of this warp's 16, column
  // 8j + 2t + (e & 1) — in registers (sacc[4j + e]) or the staged S tile.
  const int wrow = 16 * warp + g;
  auto build = [&](int step, const float (&sacc)[32], uint32_t* fr) {
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(q_stage(step)) + wrow * QW;
    const uint32_t* q1 = q0 + 8 * QW;
    const float* st =
        reinterpret_cast<const float*>(q_stage(step) + P.codes) + wrow * SS + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float s[4];
      if constexpr (S_MEM) {
        const float2 s0 = *reinterpret_cast<const float2*>(st + 8 * j);
        const float2 s1 = *reinterpret_cast<const float2*>(st + 8 * SS + 8 * j);
        s[0] = s0.x, s[1] = s0.y, s[2] = s1.x, s[3] = s1.y;
      } else {
        s[0] = sacc[4 * j], s[1] = sacc[4 * j + 1], s[2] = sacc[4 * j + 2];
        s[3] = sacc[4 * j + 3];
      }
      const uint64_t c0 = code_window<BITS>(q0, j) >> (2 * t * BITS);
      const uint64_t c1 = code_window<BITS>(q1, j) >> (2 * t * BITS);
      const __nv_bfloat162 p0 = __floats2bfloat162_rn(
          lut_s[(uint32_t)c0 & kMask] * lords::clamp_scale(s[0]),
          lut_s[(uint32_t)(c0 >> BITS) & kMask] * lords::clamp_scale(s[1]));
      const __nv_bfloat162 p1 = __floats2bfloat162_rn(
          lut_s[(uint32_t)c1 & kMask] * lords::clamp_scale(s[2]),
          lut_s[(uint32_t)(c1 >> BITS) & kMask] * lords::clamp_scale(s[3]));
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
  if constexpr (!S_MEM) {
    const uint32_t bs = smem_u32(smem + P.bw);
    const int chunks = (int)(P.bw_tile / 16);
    for (int i = tid; i < 2 * chunks; i += THREADS) {
      const int hl = i >= chunks, c = i - hl * chunks;
      cp_async16(bs + (uint32_t)(hl * P.bw_tile) + 16 * c,
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
  if constexpr (!S_MEM) {
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
    if constexpr (!S_MEM) {
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

// f32 scratch of the pre-pass: split A and B, or S
inline size_t prepass_floats(const Plan& p, int N, int K) {
  return hopper::prepass_floats(p.s_mem, p.r8, N, K);
}

template <int BITS>
size_t workspace(int M, int N, int K, int r, int splits) {
  return prepass_floats(choose_plan<BITS>(r), N, K) + (splits > 1 ? (size_t)splits * M * N : 0);
}

template <int BITS, bool S_MEM>
cudaError_t run(const Plan& p, const void* x, const void* q, const float* ws, const void* lut,
                float* out, int M, int N, int K, int n_levels, int splits, cudaStream_t stream) {
  cudaError_t err = lords::allow_smem(lords_matmul_kernel<BITS, S_MEM>, p.total);
  if (err != cudaSuccess) return err;
  dim3 grid(N / BN, (M + BM - 1) / BM, splits);
  lords_matmul_kernel<BITS, S_MEM><<<grid, THREADS, p.total, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q), ws,
      static_cast<const float*>(lut), out, M, N, K, p.r8, n_levels, p.sx == 4);
  return cudaGetLastError();
}

template <int BITS>
int launch(const void* x, const void* q, const void* b, const void* a, const void* lut,
           void* y, void* ws, int M, int N, int K, int r, int n_levels, int splits,
           cudaStream_t stream) {
  const Plan p = choose_plan<BITS>(r);
  float* pre = static_cast<float*>(ws);
  float* part = pre + prepass_floats(p, N, K);
  cudaError_t err = hopper::prepass<BK, BN>(b, a, pre, N, K, r, p.r8, p.s_mem, stream);
  if (err != cudaSuccess) return err;
  float* out = splits > 1 ? part : static_cast<float*>(y);
  err = p.s_mem ? run<BITS, true>(p, x, q, pre, lut, out, M, N, K, n_levels, splits, stream)
                : run<BITS, false>(p, x, q, pre, lut, out, M, N, K, n_levels, splits, stream);
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n4 = (size_t)M * N / 4;
  splitk_sum_kernel<<<hopper::grid_for(n4), 256, 0, stream>>>(reinterpret_cast<const float4*>(part),
                                                      static_cast<float4*>(y), n4, splits);
  return cudaGetLastError();
}

}  // namespace

// The f32 scratch `lords_matmul_launch` needs, in floats (-1: bits not built).
extern "C" long long lords_matmul_workspace(int M, int N, int K, int r, int bits, int splits) {
  switch (bits) {
    case 2: return (long long)workspace<2>(M, N, K, r, splits);
    case 3: return (long long)workspace<3>(M, N, K, r, splits);
    case 4: return (long long)workspace<4>(M, N, K, r, splits);
    case 8: return (long long)workspace<8>(M, N, K, r, splits);
    default: return -1;
  }
}

// x (M, K) bf16; q (N, K·bits/8) u8; b (N, r), a (r, K), lut f32; y (M, N)
// f32; ws f32 scratch of lords_matmul_workspace(M, N, K, r, bits, splits)
// floats.
extern "C" int lords_matmul_launch(const void* x, const void* q, const void* b, const void* a,
                                   const void* lut, void* y, void* ws, int M, int N, int K,
                                   int r, int bits, int n_levels, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N % BN || K % BK || r < 1 || splits < 1 || splits > K / BK)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bits) {
    case 2: return launch<2>(x, q, b, a, lut, y, ws, M, N, K, r, n_levels, splits, st);
    case 3: return launch<3>(x, q, b, a, lut, y, ws, M, N, K, r, n_levels, splits, st);
    case 4: return launch<4>(x, q, b, a, lut, y, ws, M, N, K, r, n_levels, splits, st);
    case 8: return launch<8>(x, q, b, a, lut, y, ws, M, N, K, r, n_levels, splits, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
