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
//   then            dB-part[k-tile] = ∂S·Aᵀ  (N, r)   per 128-column K tile
//                   dA-part[n-tile] = Bᵀ·∂S  (r, K)   per 128-row N tile
//
// The dispatch layer sums the partials over their first axis, so the result
// is deterministic (no atomics).  S = B·A is rebuilt here in FP32 exactly as
// the forward kernels build it; the mask tests the raw S, the QAT residual
// divides by the clamped S.
//
// Replaces: src/repro/kernels/lords_grad.py::lords_grad_pallas.  The TPU
// kernel keeps its dBᵀ tile resident while the K grid axis runs in order;
// CUDA blocks over (N tile, K tile) run at once, hence the per-K-tile
// partials of dB.
//
// What bounds it on an H100: the gᵀ·x product, 2·M·N·K operations on the
// bf16 tensor cores, at the training step's shapes; the qat variant also
// reads W and writes dW (8 bytes per weight), still under the operation
// bound at M = 4096.  The epilogue (S rebuild, masks, the two rank-r
// contractions) is O(N·K·r) once per tile, not per M step.
//
// What the design does about it: a block owns one 128 x 128 (N, K) tile and
// walks M in steps of 32; its 8 warps keep the tile's ∂L/∂Ŵ in WMMA f32
// accumulators (bf16 operands: gᵀ read column-major straight from the staged
// g tile, so nothing is transposed in memory).  After the M loop the tile
// goes to shared memory (aliasing the staging buffers), the element-wise
// terms are applied in place and the rank contractions are read from there.
// Later work: wgmma + TMA pipelining of the M loop, split-M for small N·K.
//
// Shapes: M % 32 == 0, N % 128 == 0, K % 128 == 0 (the dispatch layer pads).

#include <mma.h>

#include "lords_common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 32, BN = 128, BK = 128;
constexpr int THREADS = 256;
constexpr int LDG = BN + 8;   // bf16 row stride of the staged g tile
constexpr int LDX = BK + 8;   // bf16 row stride of the staged x tile
constexpr int LDS = BK + 4;   // f32 row stride of the ∂L/∂Ŵ / ∂S tile
constexpr int AST = BK + 4;   // f32 row stride of the A slice

struct Smem {
  // byte offsets into the dynamic shared-memory block; the g / x staging
  // tiles and the f32 ∂S tile share the region at offset 0
  size_t gs, xs, ds, as, bs, lut, qs, total;
  int rs;  // row stride of the B tile, in floats (odd)
};

template <int BITS>
__host__ __device__ inline Smem smem_layout(int r) {
  constexpr int QW = BK * BITS / 32;
  Smem s;
  s.rs = (r % 2) ? r : r + 1;
  s.gs = 0;
  s.xs = s.gs + sizeof(__nv_bfloat16) * BM * LDG;
  s.ds = 0;
  const size_t staged = s.xs + sizeof(__nv_bfloat16) * BM * LDX;
  const size_t dsz = sizeof(float) * BN * LDS;
  s.as = staged > dsz ? staged : dsz;
  s.bs = s.as + sizeof(float) * r * AST;
  s.lut = s.bs + sizeof(float) * BN * s.rs;
  s.qs = s.lut + sizeof(float) * 256;
  s.total = s.qs + sizeof(uint32_t) * BN * (QW + 1);
  return s;
}

template <int BITS, bool QAT>
__global__ void __launch_bounds__(THREADS)
lords_grad_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                  const uint8_t* __restrict__ q, const float* __restrict__ b,
                  const float* __restrict__ a, const float* __restrict__ lut,
                  const float* __restrict__ w, float* __restrict__ db_part,
                  float* __restrict__ da_part, float* __restrict__ dw, int M, int N, int K,
                  int r, int n_levels) {
  constexpr int QW = BK * BITS / 32;
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L = smem_layout<BITS>(r);
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem + L.gs);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + L.xs);
  float* ds = reinterpret_cast<float*>(smem + L.ds);
  float* as = reinterpret_cast<float*>(smem + L.as);
  float* bs = reinterpret_cast<float*>(smem + L.bs);
  float* lut_s = reinterpret_cast<float*>(smem + L.lut);
  uint32_t* qs = reinterpret_cast<uint32_t*>(smem + L.qs);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int kt = blockIdx.x, jt = blockIdx.y;
  const int k0 = kt * BK, n0 = jt * BN;
  const int row_words = K * BITS / 32;
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q);

  // the tile's B rows, A slice, codes and the LUT (outside the staging region)
  for (int i = tid; i < BN * r; i += THREADS) {
    const int n = i / r, rr = i % r;
    bs[n * L.rs + rr] = b[(size_t)(n0 + n) * r + rr];
  }
  for (int i = tid; i < r * BK; i += THREADS) {
    const int rr = i / BK, c = i % BK;
    as[rr * AST + c] = a[(size_t)rr * K + k0 + c];
  }
  for (int i = tid; i < BN * QW; i += THREADS) {
    const int n = i / QW, wd = i % QW;
    qs[n * (QW + 1) + wd] = q32[(size_t)(n0 + n) * row_words + k0 * BITS / 32 + wd];
  }
  if (tid < BN) qs[tid * (QW + 1) + QW] = 0u;  // guard word for the pair read
  for (int i = tid; i < 256; i += THREADS) lut_s[i] = i < n_levels ? lut[i] : 0.f;

  // ∂L/∂Ŵ tile (BN x BK) in WMMA accumulators; warp tile 32 (n) x 64 (k)
  const int wr = warp % 4, wc = warp / 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int m0 = 0; m0 < M; m0 += BM) {
    // stage g (BM x BN) and x (BM x BK) tiles, bf16, 16-byte loads
    for (int i = tid; i < BM * BN / 8; i += THREADS) {
      const int row = i / (BN / 8), c = (i % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(gs + row * LDG + c) =
          *reinterpret_cast<const uint4*>(g + (size_t)(m0 + row) * N + n0 + c);
    }
    for (int i = tid; i < BM * BK / 8; i += THREADS) {
      const int row = i / (BK / 8), c = (i % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(xs + row * LDX + c) =
          *reinterpret_cast<const uint4*>(x + (size_t)(m0 + row) * K + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BM; kk += 16) {
      // gᵀ (n, m) is the staged g tile read column-major
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], gs + kk * LDG + wr * 32 + i * 16, LDG);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], xs + kk * LDX + wc * 64 + j * 16, LDX);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // the accumulated tile to shared memory (over the staging buffers)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(ds + (wr * 32 + i * 16) * LDS + wc * 64 + j * 16, acc[i][j],
                              LDS, wmma::mem_row_major);
  __syncthreads();

  // element-wise terms in place: a warp covers 32 consecutive k of one row
  for (int e = tid; e < BN * BK; e += THREADS) {
    const int n = e / BK, k = e % BK;
    const float* brow = bs + n * L.rs;
    float s_raw = 0.f;
    for (int rr = 0; rr < r; ++rr) s_raw = fmaf(brow[rr], as[rr * AST + k], s_raw);
    const uint32_t* qrow = qs + n * (QW + 1);
    const int bit = k * BITS;
    const uint64_t pair = (uint64_t)qrow[bit >> 5] | ((uint64_t)qrow[(bit >> 5) + 1] << 32);
    const float val = lut_s[(uint32_t)(pair >> (bit & 31)) & kMask];
    const float mask = fabsf(s_raw) >= lords::kScaleEps ? 1.f : 0.f;
    const float dwh = ds[n * LDS + k];
    float term = val;
    if constexpr (QAT) {
      const size_t at = (size_t)(n0 + n) * K + k0 + k;
      term = val - w[at] / lords::clamp_scale(s_raw);  // Q − W ⊘ S   (Eq. 5)
      dw[at] = dwh;                                    // ∂L/∂Ŵ       (Eq. 4)
    }
    ds[n * LDS + k] = dwh * term * mask;
  }
  __syncthreads();

  // dB-part[kt] (N, r) = ∂S · Aᵀ: one warp per row, lanes over k, warp sum
  for (int n = warp; n < BN; n += THREADS / 32) {
    float dv[BK / 32];
#pragma unroll
    for (int c = 0; c < BK / 32; ++c) dv[c] = ds[n * LDS + lane + 32 * c];
    for (int rr = 0; rr < r; ++rr) {
      float v = 0.f;
#pragma unroll
      for (int c = 0; c < BK / 32; ++c) v = fmaf(dv[c], as[rr * AST + lane + 32 * c], v);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) db_part[((size_t)kt * N + n0 + n) * r + rr] = v;
    }
  }

  // dA-part[jt] (r, K) = Bᵀ · ∂S: a thread per (rank, column), sum over n
  for (int o = tid; o < r * BK; o += THREADS) {
    const int rr = o / BK, k = o % BK;
    float v = 0.f;
    for (int n = 0; n < BN; ++n) v = fmaf(bs[n * L.rs + rr], ds[n * LDS + k], v);
    da_part[((size_t)jt * r + rr) * K + k0 + k] = v;
  }
}

template <int BITS>
int launch(const void* x, const void* g, const void* q, const void* b, const void* a,
           const void* lut, const void* w, void* db_part, void* da_part, void* dw, int M,
           int N, int K, int r, int n_levels, cudaStream_t stream) {
  const size_t smem = smem_layout<BITS>(r).total;
  dim3 grid(K / BK, N / BN);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* gb = static_cast<const __nv_bfloat16*>(g);
  const auto* qb = static_cast<const uint8_t*>(q);
  const auto* bf = static_cast<const float*>(b);
  const auto* af = static_cast<const float*>(a);
  const auto* lf = static_cast<const float*>(lut);
  const auto* wf = static_cast<const float*>(w);
  auto* dbp = static_cast<float*>(db_part);
  auto* dap = static_cast<float*>(da_part);
  auto* dwf = static_cast<float*>(dw);
  cudaError_t err;
  if (w != nullptr) {
    err = lords::allow_smem(lords_grad_kernel<BITS, true>, smem);
    if (err != cudaSuccess) return err;
    lords_grad_kernel<BITS, true><<<grid, THREADS, smem, stream>>>(
        xb, gb, qb, bf, af, lf, wf, dbp, dap, dwf, M, N, K, r, n_levels);
  } else {
    err = lords::allow_smem(lords_grad_kernel<BITS, false>, smem);
    if (err != cudaSuccess) return err;
    lords_grad_kernel<BITS, false><<<grid, THREADS, smem, stream>>>(
        xb, gb, qb, bf, af, lf, nullptr, dbp, dap, nullptr, M, N, K, r, n_levels);
  }
  return cudaGetLastError();
}

}  // namespace

// w == nullptr: the peft / frozen variant; otherwise the qat variant, which
// also writes dw (N, K).
extern "C" int lords_grad_launch(const void* x, const void* g, const void* q, const void* b,
                                 const void* a, const void* lut, const void* w, void* db_part,
                                 void* da_part, void* dw, int M, int N, int K, int r, int bits,
                                 int n_levels, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return launch<2>(x, g, q, b, a, lut, w, db_part, da_part, dw, M, N, K, r, n_levels, st);
    case 3: return launch<3>(x, g, q, b, a, lut, w, db_part, da_part, dw, M, N, K, r, n_levels, st);
    case 4: return launch<4>(x, g, q, b, a, lut, w, db_part, da_part, dw, M, N, K, r, n_levels, st);
    case 8: return launch<8>(x, g, q, b, a, lut, w, db_part, da_part, dw, M, N, K, r, n_levels, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
