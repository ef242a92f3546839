// Transposed LoRDS dequant-matmul: the activation gradient of a quantized
// linear in training.
//
//   dx[M, K] (f32) = g[M, N] (bf16) · Ŵ,   Ŵ = bf16(lut[unpack(Q)] ⊙ clamp(B·A))
//
// Replaces: src/repro/kernels/lords_matmul_t.py::lords_matmul_t_pallas.
//
// What bounds it on an H100: at the training step's shapes (M = 4096 tokens,
// N, K = 1024..14336) the bf16 product is far above the card's byte/FLOP
// ridge, so the function is bound by tensor-core operations (2·M·N·K).  As
// in the forward kernel, this first version rebuilds S = B·A on the FP32
// cores once per M tile (2r FLOP per weight, 32 times at M = 4096), which
// costs about as much time as the product at the card's rates.
//
// What the design does about it: the reduction runs over N (the forward's
// output axis), so a block owns a 128 x 128 tile of dx and walks N in steps
// of 32.  At each step the 32 x 128 Ŵ tile is built once in shared memory,
// already in the row-major (N, K) layout the product wants — Ŵ is used
// untransposed, so no transpose costs anything — and all 8 warps' WMMA bf16
// products (f32 accumulators) consume it.  The A slice of the block's K
// columns stays in shared memory for the whole N loop; B rows and codes
// are staged per step.  Ŵ never exists in device memory.  Later work: S on
// the tensor cores, wgmma + TMA pipelining.
//
// Shapes: M % 128 == 0, N % 32 == 0, K % 128 == 0 (the dispatch layer pads).
// Codes of a row sit at bit k·BITS of its little-endian byte stream.

#include <mma.h>

#include "lords_common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 128, BN = 32, BK = 128;
constexpr int THREADS = 256;
constexpr int LDG = BN + 8;  // bf16 row stride of the g tile (80 bytes)
constexpr int LDW = BK + 8;  // bf16 row stride of the Ŵ tile (272 bytes)

struct Smem {
  // byte offsets into the dynamic shared-memory block
  size_t gs, ws, as, bs, lut, qs, total;
  int rs;  // row stride of the B tile, in floats (odd)
};

template <int BITS>
__host__ __device__ inline Smem smem_layout(int r) {
  constexpr int QW = BK * BITS / 32;  // packed words of a tile row
  Smem s;
  s.rs = (r % 2) ? r : r + 1;
  s.gs = 0;
  s.ws = s.gs + sizeof(__nv_bfloat16) * BM * LDG;
  s.as = s.ws + sizeof(__nv_bfloat16) * BN * LDW;
  s.bs = s.as + sizeof(float) * r * BK;
  s.lut = s.bs + sizeof(float) * BN * s.rs;
  s.qs = s.lut + sizeof(float) * 256;
  s.total = s.qs + sizeof(uint32_t) * BN * (QW + 1);
  return s;
}

template <int BITS>
__global__ void __launch_bounds__(THREADS)
lords_matmul_t_kernel(const __nv_bfloat16* __restrict__ g, const uint8_t* __restrict__ q,
                      const float* __restrict__ b, const float* __restrict__ a,
                      const float* __restrict__ lut, float* __restrict__ dx, int M, int N,
                      int K, int r, int n_levels) {
  constexpr int QW = BK * BITS / 32;
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L = smem_layout<BITS>(r);
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem + L.gs);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + L.ws);
  float* as = reinterpret_cast<float*>(smem + L.as);
  float* bs = reinterpret_cast<float*>(smem + L.bs);
  float* lut_s = reinterpret_cast<float*>(smem + L.lut);
  uint32_t* qs = reinterpret_cast<uint32_t*>(smem + L.qs);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int k0 = blockIdx.x * BK, m0 = blockIdx.y * BM;
  const int row_words = K * BITS / 32;
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q);

  // the A slice of this block's K columns and the LUT, for the whole N loop
  for (int i = tid; i < r * BK; i += THREADS) {
    const int rr = i / BK, c = i % BK;
    as[rr * BK + c] = a[(size_t)rr * K + k0 + c];
  }
  for (int i = tid; i < 256; i += THREADS) lut_s[i] = i < n_levels ? lut[i] : 0.f;

  // warp tile: 32 rows x 64 columns of the 128 x 128 dx tile
  const int wr = warp % 4, wc = warp / 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // Ŵ-tile mapping: thread -> one weight row n, 16 consecutive k; a warp
  // holds the 32 rows of one k chunk, so its A reads are one broadcast and
  // its Ŵ stores (row stride 272 bytes) fall in distinct banks
  const int wn = tid % 32, wk = (tid / 32) * 16;

  for (int n0 = 0; n0 < N; n0 += BN) {
    // stage the g tile (BM x BN bf16, 16-byte loads), B rows and codes
    for (int i = tid; i < BM * BN / 8; i += THREADS) {
      const int row = i / (BN / 8), c = (i % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(gs + row * LDG + c) =
          *reinterpret_cast<const uint4*>(g + (size_t)(m0 + row) * N + n0 + c);
    }
    for (int i = tid; i < BN * r; i += THREADS) {
      const int n = i / r, rr = i % r;
      bs[n * L.rs + rr] = b[(size_t)(n0 + n) * r + rr];
    }
    for (int i = tid; i < BN * QW; i += THREADS) {
      const int n = i / QW, w = i % QW;
      qs[n * (QW + 1) + w] = q32[(size_t)(n0 + n) * row_words + k0 * BITS / 32 + w];
    }
    if (tid < BN) qs[tid * (QW + 1) + QW] = 0u;  // guard word for the pair read
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
      const uint32_t* qrow = qs + wn * (QW + 1);
      alignas(16) __nv_bfloat16 wv[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int bit = (wk + j) * BITS;
        const uint64_t pair =
            (uint64_t)qrow[bit >> 5] | ((uint64_t)qrow[(bit >> 5) + 1] << 32);
        const uint32_t code = (uint32_t)(pair >> (bit & 31)) & kMask;
        wv[j] = __float2bfloat16_rn(lut_s[code] * lords::clamp_scale(s[j]));
      }
      uint4* dst = reinterpret_cast<uint4*>(ws + wn * LDW + wk);
      dst[0] = reinterpret_cast<const uint4*>(wv)[0];
      dst[1] = reinterpret_cast<const uint4*>(wv)[1];
    }
    __syncthreads();

    // tensor-core product g_tile (BM x BN) · Ŵ_tile (BN x BK)
#pragma unroll
    for (int kk = 0; kk < BN; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], gs + (wr * 32 + i * 16) * LDG + kk, LDG);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], ws + kk * LDW + wc * 64 + j * 16, LDW);
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
      wmma::store_matrix_sync(dx + (size_t)(m0 + wr * 32 + i * 16) * K + k0 + wc * 64 + j * 16,
                              acc[i][j], K, wmma::mem_row_major);
}

template <int BITS>
int launch(const void* g, const void* q, const void* b, const void* a, const void* lut,
           void* dx, int M, int N, int K, int r, int n_levels, cudaStream_t stream) {
  const size_t smem = smem_layout<BITS>(r).total;
  cudaError_t err = lords::allow_smem(lords_matmul_t_kernel<BITS>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(K / BK, M / BM);
  lords_matmul_t_kernel<BITS><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const uint8_t*>(q),
      static_cast<const float*>(b), static_cast<const float*>(a),
      static_cast<const float*>(lut), static_cast<float*>(dx), M, N, K, r, n_levels);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lords_matmul_t_launch(const void* g, const void* q, const void* b,
                                     const void* a, const void* lut, void* dx, int M, int N,
                                     int K, int r, int bits, int n_levels, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return launch<2>(g, q, b, a, lut, dx, M, N, K, r, n_levels, st);
    case 3: return launch<3>(g, q, b, a, lut, dx, M, N, K, r, n_levels, st);
    case 4: return launch<4>(g, q, b, a, lut, dx, M, N, K, r, n_levels, st);
    case 8: return launch<8>(g, q, b, a, lut, dx, M, N, K, r, n_levels, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
