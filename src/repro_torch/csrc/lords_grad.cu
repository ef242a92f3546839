// LoRDS parameter gradients of a quantized linear in training.
//
// Given the output gradient g[M, N] and the activations x[M, K] (both bf16),
// every LoRDS parameter gradient factors through the weight-space cotangent
//
//   ∂L/∂Ŵ = gᵀ·x                                            (N, K)
//
// which this kernel accumulates tile by tile and never writes out:
//
//   peft / frozen:  ∂S = ∂L/∂Ŵ ⊙ lut[Q] ⊙ 1[|S_raw| ≥ eps]
//   qat (STE):      ∂S = ∂L/∂Ŵ ⊙ (lut[Q] − W ⊘ clamp(S)) ⊙ 1[|S_raw| ≥ eps],
//                   dW = ∂L/∂Ŵ                                (paper Eq. 4/5)
//   then            dB-part[k128] = ∂S·Aᵀ  (N, r)   per 128-column K slice
//                   dA-part[n128] = Bᵀ·∂S  (r, K)   per 128-row N tile
//
// The dispatch layer sums the partials over their first axis, so the result
// is deterministic (no atomics).  The mask tests the raw S, the QAT
// residual divides by the clamped S.
//
// Replaces: src/repro/kernels/lords_grad.py::lords_grad_pallas.  The TPU
// kernel keeps its dBᵀ tile resident while the K grid axis runs in order;
// CUDA blocks over (N tile, K tile) run at once, hence the per-K-slice
// partials of dB.
//
// What bounds it on an H100: the gᵀ·x product, 2·M·N·K operations on the
// bf16 tensor cores, at the training step's shapes; the qat variant also
// reads W and writes dW (8 bytes per weight), still under the operation
// bound at M = 4096.  The epilogue (S, masks, the two rank-r contractions)
// is O(N·K·r) once per tile, not per M step.
//
// What the design does about it:
//  * The product is csrc/grad.cuh: a CTA owns a 128 x 256 (N, K) tile of
//    ∂L/∂Ŵ in the accumulators of two warpgroups, `wgmma` m64n256k16 with
//    both operands MN-major from shared memory, g and x tiles by TMA into a
//    ring of four stages on mbarriers.  Any M: the TMA reads rows past M as
//    zeros, so the caller pads nothing in M.
//  * The epilogue works in the accumulators' own layout.  Over the spent
//    ring it stages the tile's codes and the forward's pre-pass operands
//    (B and A split into tf32 hi / lo parts); S for each 64-column chunk is
//    3xTF32 `wgmma` m64n64k8, whose f32 accumulator has exactly the layout
//    of the ∂L/∂Ŵ accumulator, so the mask, lut[code], the qat residual and
//    ∂S combine element by element in registers (qat reads W and writes dW
//    at the thread's own positions).  A rank whose split operands do not
//    fit beside the codes takes S from memory (S_MEM): the pre-pass writes
//    S = B·A in f32 and each thread reads its own elements.
//  * The rank contractions read ∂S staged in shared memory 128 columns at
//    a time, with A's columns and B's rows in f32 (by cp.async, all in
//    flight at once: loading them in a loop of plain loads cost 9% of the
//    kernel's time): FP32 FMAs in 4 x 4 register blocks, 16 products a
//    pair of 16-byte reads, in f32 accuracy.  With the ∂S staging they are
//    the kernel's cost past the product: at r = 24 the kernel runs at ~470
//    TFLOP/s, its product alone at ~650 (PERF.md).
//
// Shapes: any M >= 1, N % 128 == 0, K % 256 == 0 (the dispatch layer pads
// N and K).

#include "grad.cuh"
#include "lords_common.cuh"

namespace {

using namespace hopper;

constexpr int BN = grad::BN, BK = grad::BK, THREADS = grad::THREADS;
constexpr int PASS = 128;       // columns of a contraction pass (a dB slice)
constexpr int DSS = PASS + 8;   // f32 row stride of the staged ∂S
constexpr size_t kMaxSmem = 232448;

// Shared memory of one CTA, in bytes from a 1024-aligned base.  Three
// phases share the region at 0: the g / x ring (the product), then the
// codes and, in TF32 mode, the split B / A tiles (∂S), then ∂S, A and B in
// f32 (the contractions).  The LUT and the ring's mbarriers lie past them.
struct Plan {
  bool s_mem;
  int r8, r4;
  size_t codes, b_tile, a_tile, region, lut, bars, total;
};

template <int BITS>
__host__ __device__ inline Plan make_plan(int r, bool s_mem) {
  constexpr int QW = lords::code_stride64<BITS>();
  Plan p;
  p.s_mem = s_mem;
  p.r8 = (r + 7) / 8;
  p.r4 = (r + 3) / 4;
  p.codes = (size_t)(BK / 64) * BN * QW * 4;
  p.b_tile = s_mem ? 0 : (size_t)BN * 8 * p.r8 * 4;  // one of B_hi / B_lo
  p.a_tile = s_mem ? 0 : (size_t)64 * 8 * p.r8 * 4;  // one 64-column tile of A_hi / A_lo
  const size_t split = p.codes + 2 * p.b_tile + 2 * (BK / 64) * p.a_tile;
  const size_t contract = (size_t)BN * DSS * 4 + 2 * (size_t)4 * p.r4 * PASS * 4;
  p.region = grad::RING_BYTES;
  if (split > p.region) p.region = split;
  if (contract > p.region) p.region = contract;
  p.lut = p.region;
  p.bars = p.lut + 256 * 4;
  p.total = p.bars + 8 * grad::RING + 1024;  // + slack to align the base to 1024
  return p;
}

// 3xTF32 S in the kernel where its split operands fit, else S from memory;
// total > kMaxSmem if neither fits (ranks past ~150)
template <int BITS>
inline Plan choose_plan(int r) {
  const Plan p = make_plan<BITS>(r, false);
  return p.total <= kMaxSmem ? p : make_plan<BITS>(r, true);
}

// x (M, K), g (M, N) as tensor maps; q (N, K·BITS/8) u8; ws: the pre-pass's
// split A / B, or S (N, K) f32 (S_MEM); b (N, r), a (r, K), lut, w (N, K)
// f32 (QAT); db_part (K / 128, N, r), da_part (N / 128, r, K), dw (N, K)
template <int BITS, bool QAT, bool S_MEM>
__global__ void __launch_bounds__(THREADS, 1)
lords_grad_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap g_map, const uint8_t* __restrict__ q,
                  const float* __restrict__ ws, const float* __restrict__ b,
                  const float* __restrict__ a, const float* __restrict__ lut,
                  const float* __restrict__ w, float* __restrict__ db_part,
                  float* __restrict__ da_part, float* __restrict__ dw, int M, int N, int K,
                  int r, int n_levels) {
  constexpr int QW = lords::code_stride64<BITS>();
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const Plan P = make_plan<BITS>(r, S_MEM);
  float* lut_s = reinterpret_cast<float*>(smem + P.lut);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  int nt, kt;
  grad::tile_of(nt, kt);
  const int k0 = kt * BK, n0 = nt * BN;
  const size_t row_bytes = (size_t)K * BITS / 8;
  for (int i = tid; i < 256; i += THREADS) lut_s[i] = i < n_levels ? lut[i] : 0.f;

  float acc[BK / 2];
  grad::product(acc, &g_map, &x_map, smem, smem_u32(smem + P.bars), M, n0, k0);

  // The ∂S phase's operands over the spent ring: the tile's codes, chunk c
  // of row n at (c·BN + n)·QW words, and in TF32 mode the CTA's B_hi, B_lo
  // and four A_hi, A_lo tiles of the pre-pass layout (hopper::prepass_kernel)
  {
    const uint32_t qs = smem_u32(smem);
    constexpr int CB = BITS == 3 ? 8 : 16, PER_ROW = 8 * BITS / CB;  // a chunk row: 8·BITS bytes
    for (int i = tid; i < (BK / 64) * BN * PER_ROW; i += THREADS) {
      const int c = i / (BN * PER_ROW), row = i / PER_ROW % BN, part = i % PER_ROW;
      const uint8_t* src = q + (size_t)(n0 + row) * row_bytes + (size_t)(k0 + 64 * c) * BITS / 8 +
                           CB * part;
      const uint32_t dst = qs + (c * BN + row) * QW * 4 + CB * part;
      if constexpr (CB == 8) cp_async8(dst, src);
      else cp_async16(dst, src, 16);
    }
    if constexpr (!S_MEM) {
      const size_t rp = 8 * (size_t)P.r8;
      const float* a_hi = ws;
      const float* a_lo = ws + rp * K;
      const float* b_hi = a_lo + rp * K;
      const float* b_lo = b_hi + rp * N;
      const uint32_t bs = qs + (uint32_t)P.codes;
      const int bchunks = (int)(P.b_tile / 16), achunks = (int)((BK / 64) * P.a_tile / 16);
      for (int i = tid; i < 2 * bchunks; i += THREADS) {
        const int hl = i >= bchunks, c = i - hl * bchunks;
        cp_async16(bs + (uint32_t)(hl * P.b_tile) + 16 * c,
                   (hl ? b_lo : b_hi) + (size_t)nt * (P.b_tile / 4) + 4 * c, 16);
      }
      const uint32_t as = bs + (uint32_t)(2 * P.b_tile);
      for (int i = tid; i < 2 * achunks; i += THREADS) {
        const int hl = i >= achunks, c = i - hl * achunks;
        cp_async16(as + (uint32_t)(hl * achunks * 16) + 16 * c,
                   (hl ? a_lo : a_hi) + (size_t)(k0 / 64) * (P.a_tile / 4) + 4 * c, 16);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }

  // ∂S in place of ∂L/∂Ŵ, one 64-column chunk at a time.  acc[4j + e] and
  // S's sacc[4(j % 8) + e] both hold row wrow (+8 for e >= 2) of the tile,
  // column 8j + 2t + (e & 1).
  const int wrow = 16 * warp + g;
  {
    const uint32_t bh = smem_u32(smem) + (uint32_t)P.codes + (warp >> 2) * 8 * 128;
    const uint32_t ah = smem_u32(smem) + (uint32_t)(P.codes + 2 * P.b_tile);
    const uint32_t al = ah + (uint32_t)((BK / 64) * P.a_tile);
#pragma unroll
    for (int c = 0; c < BK / 64; ++c) {
      float sacc[32];
      if constexpr (!S_MEM) {
        s_3xtf32(sacc, bh, bh + (uint32_t)P.b_tile, BN * 16, ah + (uint32_t)(c * P.a_tile),
                 al + (uint32_t)(c * P.a_tile), 64 * 16, P.r8);
        wgmma_wait<0>();
      }
      const uint32_t* q0 = reinterpret_cast<const uint32_t*>(smem) + (c * BN + wrow) * QW;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + 64 * c + 8 * j + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows wrow, wrow + 8
          const size_t at = (size_t)(n0 + wrow + 8 * h) * K + col;
          const uint64_t cw = lords::code_window<BITS>(q0 + 8 * h * QW, j) >> (2 * t * BITS);
          float s[2];
          if constexpr (S_MEM) {
            const float2 sv = *reinterpret_cast<const float2*>(ws + at);
            s[0] = sv.x, s[1] = sv.y;
          } else {
            s[0] = sacc[4 * j + 2 * h], s[1] = sacc[4 * j + 2 * h + 1];
          }
          float2 wv, dv;
          if constexpr (QAT) wv = *reinterpret_cast<const float2*>(w + at);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = acc[4 * (8 * c + j) + 2 * h + e];
            const float val = lut_s[(uint32_t)(cw >> (e * BITS)) & kMask];
            const float mask = fabsf(s[e]) >= lords::kScaleEps ? 1.f : 0.f;
            float term = val;
            if constexpr (QAT) {
              term = val - (e ? wv.y : wv.x) / lords::clamp_scale(s[e]);  // Q − W ⊘ S (Eq. 5)
              (e ? dv.y : dv.x) = v;                                       // ∂L/∂Ŵ     (Eq. 4)
            }
            v = v * term * mask;
          }
          if constexpr (QAT) *reinterpret_cast<float2*>(dw + at) = dv;
        }
      }
    }
  }

  // The contractions, one pass of 128 columns at a time: ∂S, A's columns
  // and (once) B's rows in f32, ranks zero-padded to 4·r4
  float* ds = reinterpret_cast<float*>(smem);
  float* as = ds + BN * DSS;                // (4·r4, PASS)
  float* bs = as + 4 * P.r4 * PASS;         // (BN, 4·r4)
  const int r4 = P.r4, rw = 4 * r4;
#pragma unroll
  for (int p = 0; p < BK / PASS; ++p) {
    __syncthreads();  // the previous phase's reads of the region are done
    const int kp = k0 + p * PASS;
#pragma unroll
    for (int j = 0; j < PASS / 8; ++j) {
      const int jj = p * PASS / 8 + j;
      float* row = ds + wrow * DSS + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(row) = make_float2(acc[4 * jj], acc[4 * jj + 1]);
      *reinterpret_cast<float2*>(row + 8 * DSS) = make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
    }
    // A's columns and B's rows by cp.async, all in flight at once; ranks
    // past r are zero-filled
    for (int i = tid; i < rw * PASS / 4; i += THREADS) {
      const int rr = i / (PASS / 4), c = 4 * (i % (PASS / 4));
      cp_async16(smem_u32(as + 4 * i), a + (size_t)(rr < r ? rr : 0) * K + kp + c,
                 rr < r ? 16 : 0);
    }
    if (p == 0)
      for (int i = tid; i < BN * rw; i += THREADS) {
        const int n = i / rw, rr = i % rw;
        cp_async4(smem_u32(bs + i), b + (size_t)(n0 + n) * r + (rr < r ? rr : 0), rr < r ? 4 : 0);
      }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // 64·r4 units of 4 x 4 outputs, each summed by two threads, lanes l and
    // l + 16 of a warp, over half its reduction: 32·r4 units of dA (4 ranks
    // x 4 columns, consecutive columns on consecutive lanes), then 32·r4 of
    // dB (4 rows x 4 ranks, consecutive row groups on consecutive lanes,
    // each walking the columns from its own start so that a quarter-warp's
    // reads of ∂S fall on distinct banks)
    for (int v = tid; v < 128 * r4; v += THREADS) {
      const int half = (v >> 4) & 1, u = (v >> 5) * 16 + (v & 15);
      float o[4][4] = {};
      if (u < 32 * r4) {
        const int rb = u >> 5, kb = u & 31;
        const float* bp = bs + half * (BN / 2) * rw + 4 * rb;
        const float* dp = ds + half * (BN / 2) * DSS + 4 * kb;
#pragma unroll 4
        for (int n = 0; n < BN / 2; ++n) {
          const float4 bb = *reinterpret_cast<const float4*>(bp + n * rw);
          const float4 d = *reinterpret_cast<const float4*>(dp + n * DSS);
          const float bv[4] = {bb.x, bb.y, bb.z, bb.w}, dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jn = 0; jn < 4; ++jn) o[i][jn] = fmaf(bv[i], dv[jn], o[i][jn]);
        }
      } else {
        const int ub = u - 32 * r4, rb = ub >> 5, nb = ub & 31;
#pragma unroll 2
        for (int s = half * (PASS / 8); s < (half + 1) * (PASS / 8); ++s) {
          const int kq = 4 * ((s + nb) & (PASS / 4 - 1));
          float4 d[4], av[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            d[i] = *reinterpret_cast<const float4*>(ds + (4 * nb + i) * DSS + kq);
            av[i] = *reinterpret_cast<const float4*>(as + (4 * rb + i) * PASS + kq);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jr = 0; jr < 4; ++jr) {
              float x = o[i][jr];
              x = fmaf(d[i].x, av[jr].x, x);
              x = fmaf(d[i].y, av[jr].y, x);
              x = fmaf(d[i].z, av[jr].z, x);
              o[i][jr] = fmaf(d[i].w, av[jr].w, x);
            }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] += __shfl_xor_sync(0xffffffffu, o[i][j], 16);
      if (half) continue;
      if (u < 32 * r4) {
        const int rb = u >> 5, kb = u & 31;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (4 * rb + i < r)
            *reinterpret_cast<float4*>(da_part + ((size_t)nt * r + 4 * rb + i) * K + kp +
                                       4 * kb) = make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
      } else {
        const int ub = u - 32 * r4, rb = ub >> 5, nb = ub & 31;
        float* dst = db_part + ((size_t)(kp / PASS) * N + n0 + 4 * nb) * r + 4 * rb;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jr = 0; jr < 4; ++jr)
            if (4 * rb + jr < r) dst[(size_t)i * r + jr] = o[i][jr];
      }
    }
  }
}

template <int BITS, bool QAT, bool S_MEM>
cudaError_t run(const Plan& p, const CUtensorMap& xm, const CUtensorMap& gm, const void* q,
                const float* ws, const void* b, const void* a, const void* lut, const void* w,
                void* db_part, void* da_part, void* dw, int M, int N, int K, int r, int n_levels,
                cudaStream_t stream) {
  cudaError_t err = lords::allow_smem(lords_grad_kernel<BITS, QAT, S_MEM>, p.total);
  if (err != cudaSuccess) return err;
  dim3 grid(K / BK, N / BN);
  lords_grad_kernel<BITS, QAT, S_MEM><<<grid, THREADS, p.total, stream>>>(
      xm, gm, static_cast<const uint8_t*>(q), ws, static_cast<const float*>(b),
      static_cast<const float*>(a), static_cast<const float*>(lut), static_cast<const float*>(w),
      static_cast<float*>(db_part), static_cast<float*>(da_part), static_cast<float*>(dw), M, N,
      K, r, n_levels);
  return cudaGetLastError();
}

template <int BITS>
size_t workspace(int N, int K, int r) {
  const Plan p = choose_plan<BITS>(r);
  return prepass_floats(p.s_mem, p.r8, N, K);
}

template <int BITS>
int launch(const void* x, const void* g, const void* q, const void* b, const void* a,
           const void* lut, const void* w, void* db_part, void* da_part, void* dw, void* ws,
           int M, int N, int K, int r, int n_levels, cudaStream_t stream) {
  const Plan p = choose_plan<BITS>(r);
  if (p.total > kMaxSmem) return cudaErrorInvalidValue;
  CUtensorMap xm, gm;
  if (!grad::tile_map(&xm, x, M, K) || !grad::tile_map(&gm, g, M, N))
    return cudaErrorInvalidValue;
  float* pre = static_cast<float*>(ws);
  cudaError_t err = prepass<64, BN>(b, a, pre, N, K, r, p.r8, p.s_mem, stream);
  if (err != cudaSuccess) return err;
#define LORDS_GRAD_RUN(QAT, SM)                                                                  \
  run<BITS, QAT, SM>(p, xm, gm, q, pre, b, a, lut, w, db_part, da_part, dw, M, N, K, r, n_levels, \
                     stream)
  if (w != nullptr) return p.s_mem ? LORDS_GRAD_RUN(true, true) : LORDS_GRAD_RUN(true, false);
  return p.s_mem ? LORDS_GRAD_RUN(false, true) : LORDS_GRAD_RUN(false, false);
#undef LORDS_GRAD_RUN
}

}  // namespace

// The f32 scratch `lords_grad_launch` needs, in floats (-1: bits not
// built): the pre-pass's split A and B, or S (N·K) at ranks whose split
// operands do not fit in shared memory.
extern "C" long long lords_grad_workspace(int N, int K, int r, int bits) {
  switch (bits) {
    case 2: return (long long)workspace<2>(N, K, r);
    case 3: return (long long)workspace<3>(N, K, r);
    case 4: return (long long)workspace<4>(N, K, r);
    case 8: return (long long)workspace<8>(N, K, r);
    default: return -1;
  }
}

// x (M, K), g (M, N) bf16; q (N, K·bits/8) u8; b (N, r), a (r, K), lut f32;
// w (N, K) f32 or nullptr (nullptr: the peft / frozen variant; otherwise the
// qat variant, which also writes dw (N, K)); db_part (K / 128, N, r),
// da_part (N / 128, r, K) f32; ws f32 scratch of lords_grad_workspace(N, K,
// r, bits) floats.
extern "C" int lords_grad_launch(const void* x, const void* g, const void* q, const void* b,
                                 const void* a, const void* lut, const void* w, void* db_part,
                                 void* da_part, void* dw, void* ws, int M, int N, int K, int r,
                                 int bits, int n_levels, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < BN || N % BN || K < BK || K % BK || r < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bits) {
    case 2: return launch<2>(x, g, q, b, a, lut, w, db_part, da_part, dw, ws, M, N, K, r, n_levels, st);
    case 3: return launch<3>(x, g, q, b, a, lut, w, db_part, da_part, dw, ws, M, N, K, r, n_levels, st);
    case 4: return launch<4>(x, g, q, b, a, lut, w, db_part, da_part, dw, ws, M, N, K, r, n_levels, st);
    case 8: return launch<8>(x, g, q, b, a, lut, w, db_part, da_part, dw, ws, M, N, K, r, n_levels, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
