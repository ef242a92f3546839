// Fused LoRDS dequant-matmul for prefill-shaped inputs (M > 8 tokens).
//
//   y[M, N] (f32) = x[M, K] (bf16) · Ŵᵀ,   Ŵ = bf16(lut[unpack(Q)] ⊙ clamp(B·A))
//
// Replaces: src/repro/kernels/lords_matmul.py::lords_matmul_pallas (the
// TPU kernel behind every prefill linear).
//
// What bounds it on an H100: at the main path's shapes (M = batch·window
// = 2176, N, K = 1024..14336) the bf16 product is far above the card's
// byte/FLOP ridge, so the function is bound by tensor-core operations.
// This kernel rebuilds S = B·A (2r FLOP per weight, r = 6..24 here) on the
// FP32 cores once per M tile, 17 times at M = 2176: about a fifth of the
// product's FLOP, but on cores ~15x slower, so the S rebuild, not the
// product, bounds this first kernel.
//
// What the design does about it: the whole Ŵ tile is built once per
// (M tile, N tile, K step) in shared memory and consumed by all 8 warps'
// WMMA bf16 products (f32 accumulators), so S is computed once per M tile
// and never per output row.  Codes, B rows and the A slice are staged in
// shared memory (B with an odd row stride: conflict-free).  Later work:
// the S tile on the tensor cores, wgmma + TMA pipelining, larger BM.
//
// Shapes: M % 128 == 0, N % 128 == 0, K % 32 == 0 (the dispatch layer pads);
// codes of a row sit at bit k·BITS of its little-endian byte stream, which
// covers the 2-, 3-, 4- and 8-bit pack layouts alike.

#include <mma.h>

#include "lords_common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int THREADS = 256;
constexpr int LDS = BK + 8;  // bf16 row stride of the x / Ŵ tiles (80 bytes)

struct Smem {
  // byte offsets into the dynamic shared-memory block
  size_t xs, ws, bs, as, lut, qs, total;
  int rs;  // row stride of the B tile, in floats (odd)
};

template <int BITS>
__host__ __device__ inline Smem smem_layout(int r) {
  Smem s;
  s.rs = (r % 2) ? r : r + 1;
  s.xs = 0;
  s.ws = s.xs + sizeof(__nv_bfloat16) * BM * LDS;
  s.bs = s.ws + sizeof(__nv_bfloat16) * BN * LDS;
  s.as = s.bs + sizeof(float) * BN * s.rs;
  s.lut = s.as + sizeof(float) * r * BK;
  s.qs = s.lut + sizeof(float) * 256;
  s.total = s.qs + sizeof(uint32_t) * BN * (BITS + 1);
  return s;
}

template <int BITS>
__global__ void __launch_bounds__(THREADS)
lords_matmul_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
                    const float* __restrict__ b, const float* __restrict__ a,
                    const float* __restrict__ lut, float* __restrict__ y, int M, int N,
                    int K, int r, int n_levels) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L = smem_layout<BITS>(r);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + L.xs);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + L.ws);
  float* bs = reinterpret_cast<float*>(smem + L.bs);
  float* as = reinterpret_cast<float*>(smem + L.as);
  float* lut_s = reinterpret_cast<float*>(smem + L.lut);
  uint32_t* qs = reinterpret_cast<uint32_t*>(smem + L.qs);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int row_words = K * BITS / 32;  // packed words of one weight row
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q);
  constexpr uint32_t kMask = (1u << BITS) - 1u;

  // B rows and the LUT stay in shared memory for the whole K loop.
  for (int i = tid; i < BN * r; i += THREADS) {
    const int n = i / r, rr = i % r;
    bs[n * L.rs + rr] = b[(size_t)(n0 + n) * r + rr];
  }
  for (int i = tid; i < 256; i += THREADS) lut_s[i] = i < n_levels ? lut[i] : 0.f;

  // warp tile: 32 rows x 64 columns of the 128 x 128 output tile
  const int wr = warp % 4, wc = warp / 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // Ŵ-tile mapping: thread -> one weight row, 16 consecutive k
  const int wn = tid / 2, wk = (tid % 2) * 16;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // stage x tile (BM x BK bf16, 16-byte loads), A slice and packed codes
    for (int i = tid; i < BM * BK / 8; i += THREADS) {
      const int row = i / (BK / 8), c = (i % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(xs + row * LDS + c) =
          *reinterpret_cast<const uint4*>(x + (size_t)(m0 + row) * K + k0 + c);
    }
    for (int i = tid; i < r * BK; i += THREADS) {
      const int rr = i / BK, c = i % BK;
      as[rr * BK + c] = a[(size_t)rr * K + k0 + c];
    }
    for (int i = tid; i < BN * BITS; i += THREADS) {
      const int n = i / BITS, w = i % BITS;
      qs[n * (BITS + 1) + w] = q32[(size_t)(n0 + n) * row_words + k0 * BITS / 32 + w];
    }
    if (tid < BN) qs[tid * (BITS + 1) + BITS] = 0u;  // guard word for the pair read
    __syncthreads();

    // build the Ŵ tile: S = B·A (FP32), clamp, LUT gather, round to bf16
    {
      float s[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) s[j] = 0.f;
      const float* brow = bs + wn * L.rs;
      for (int rr = 0; rr < r; ++rr) {
        const float bv = brow[rr];
        const float4* arow = reinterpret_cast<const float4*>(as + rr * BK + wk);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float4 av = arow[v];
          s[4 * v + 0] = fmaf(bv, av.x, s[4 * v + 0]);
          s[4 * v + 1] = fmaf(bv, av.y, s[4 * v + 1]);
          s[4 * v + 2] = fmaf(bv, av.z, s[4 * v + 2]);
          s[4 * v + 3] = fmaf(bv, av.w, s[4 * v + 3]);
        }
      }
      const uint32_t* qrow = qs + wn * (BITS + 1);
      alignas(16) __nv_bfloat16 wv[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int bit = (wk + j) * BITS;
        const uint64_t pair =
            (uint64_t)qrow[bit >> 5] | ((uint64_t)qrow[(bit >> 5) + 1] << 32);
        const uint32_t code = (uint32_t)(pair >> (bit & 31)) & kMask;
        wv[j] = __float2bfloat16_rn(lut_s[code] * lords::clamp_scale(s[j]));
      }
      uint4* dst = reinterpret_cast<uint4*>(ws + wn * LDS + wk);
      dst[0] = reinterpret_cast<const uint4*>(wv)[0];
      dst[1] = reinterpret_cast<const uint4*>(wv)[1];
    }
    __syncthreads();

    // tensor-core product of the staged tiles
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], xs + (wr * 32 + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], ws + (wc * 64 + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(y + (size_t)(m0 + wr * 32 + i * 16) * N + n0 + wc * 64 + j * 16,
                              acc[i][j], N, wmma::mem_row_major);
}

template <int BITS>
int launch(const void* x, const void* q, const void* b, const void* a, const void* lut,
           void* y, int M, int N, int K, int r, int n_levels, cudaStream_t stream) {
  const size_t smem = smem_layout<BITS>(r).total;
  cudaError_t err = lords::allow_smem(lords_matmul_kernel<BITS>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(N / BN, M / BM);
  lords_matmul_kernel<BITS><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(b), static_cast<const float*>(a),
      static_cast<const float*>(lut), static_cast<float*>(y), M, N, K, r, n_levels);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lords_matmul_launch(const void* x, const void* q, const void* b, const void* a,
                                   const void* lut, void* y, int M, int N, int K, int r,
                                   int bits, int n_levels, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return launch<2>(x, q, b, a, lut, y, M, N, K, r, n_levels, st);
    case 3: return launch<3>(x, q, b, a, lut, y, M, N, K, r, n_levels, st);
    case 4: return launch<4>(x, q, b, a, lut, y, M, N, K, r, n_levels, st);
    case 8: return launch<8>(x, q, b, a, lut, y, M, N, K, r, n_levels, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
