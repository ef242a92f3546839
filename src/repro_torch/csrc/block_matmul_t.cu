// Transposed block-wise dequant-matmul: the activation gradient of a
// block-wise / QLoRA linear in training.
//
//   dx[M, K] (f32) = g[M, N] (bf16) · Ŵ,   Ŵ = bf16(lut[unpack(Q)] ⊙ repeat(s_blk))
//
// Column k of row n is scaled by s_blk[n, k / bs], bs = K / (s_blk's
// columns), any divisor of K.
//
// Replaces: src/repro/kernels/lords_matmul_t.py::block_matmul_t_pallas.
// The JAX package feeds it an f32 g; this kernel takes g rounded to bf16,
// as csrc/lords_matmul_t.cu does, so both operands of the product go to
// the bf16 tensor cores.
//
// What bounds it on an H100: at the training step's shapes (M = 4096
// tokens, N, K = 1024..14336) the bf16 product, 2·M·N·K operations, is far
// above the card's byte/FLOP ridge: tensor-core operations bound it.
//
// What the design does about it: the reduction runs over N (the forward's
// output axis), so a block owns a 128 x 128 tile of dx and walks N in steps
// of 32.  At each step the 32 x 128 Ŵ tile is built once in shared memory,
// in the row-major (N, K) layout the product wants (Ŵ is used
// untransposed), and all 8 warps' WMMA bf16 products (f32 accumulators)
// consume it.  The tile build maps a warp to the 32 rows of one 16-column
// chunk, the mapping that removed csrc/lords_matmul_t.cu's bank conflicts:
// its Ŵ stores (row stride 272 bytes) fall in distinct banks and its scale
// reads (odd row stride) too.  One scale load per (row, block) replaces the
// LoRDS kernel's rank-r S rebuild.  Later work: wgmma + TMA pipelining.
//
// Shapes: M % 128 == 0, N % 32 == 0, K % 128 == 0, K % bs == 0 (the
// dispatch layer pads; padded scales are 1.0).

#include <mma.h>

#include "lords_common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 128, BN = 32, BK = 128;
constexpr int THREADS = 256;
constexpr int LDG = BN + 8;  // bf16 row stride of the g tile (80 bytes)
constexpr int LDW = BK + 8;  // bf16 row stride of the Ŵ tile (272 bytes)

// the block columns a dx tile's K range can touch, and the odd row stride
// of their staged scales
__host__ __device__ inline int scale_cols(int bs) {
  const int c = (BK - 1) / bs + 2;
  return c < BK ? c : BK;
}
__host__ __device__ inline int scale_stride(int bs) { return scale_cols(bs) | 1; }

struct Smem {
  size_t gs, ws, ss, lut, qs, total;  // byte offsets of the dynamic block
};

template <int BITS>
__host__ __device__ inline Smem smem_layout(int bs) {
  constexpr int QW = BK * BITS / 32;  // packed words of a tile row
  Smem s;
  s.gs = 0;
  s.ws = s.gs + sizeof(__nv_bfloat16) * BM * LDG;
  s.ss = s.ws + sizeof(__nv_bfloat16) * BN * LDW;
  s.lut = s.ss + sizeof(float) * BN * scale_stride(bs);
  s.qs = s.lut + sizeof(float) * 256;
  s.total = s.qs + sizeof(uint32_t) * BN * (QW + 1);
  return s;
}

template <int BITS>
__global__ void __launch_bounds__(THREADS)
block_matmul_t_kernel(const __nv_bfloat16* __restrict__ g, const uint8_t* __restrict__ q,
                      const float* __restrict__ s_blk, const float* __restrict__ lut,
                      float* __restrict__ dx, int M, int N, int K, int bs, int n_levels) {
  constexpr int QW = BK * BITS / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L = smem_layout<BITS>(bs);
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem + L.gs);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + L.ws);
  float* ss = reinterpret_cast<float*>(smem + L.ss);
  float* lut_s = reinterpret_cast<float*>(smem + L.lut);
  uint32_t* qs = reinterpret_cast<uint32_t*>(smem + L.qs);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int k0 = blockIdx.x * BK, m0 = blockIdx.y * BM;
  const int row_words = K * BITS / 32;
  const int nblk = K / bs, sst = scale_stride(bs);
  const int c0 = k0 / bs, nsc = (k0 + BK - 1) / bs - c0 + 1;
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q);

  for (int i = tid; i < 256; i += THREADS) lut_s[i] = i < n_levels ? lut[i] : 0.f;

  // warp tile: 32 rows x 64 columns of the 128 x 128 dx tile
  const int wr = warp % 4, wc = warp / 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // Ŵ-tile mapping: thread -> one weight row n, 16 consecutive k; a warp
  // holds the 32 rows of one k chunk
  const int wn = tid % 32, wk = (tid / 32) * 16;

  for (int n0 = 0; n0 < N; n0 += BN) {
    // stage the g tile (BM x BN bf16, 16-byte loads), codes and scales
    for (int i = tid; i < BM * BN / 8; i += THREADS) {
      const int row = i / (BN / 8), c = (i % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(gs + row * LDG + c) =
          *reinterpret_cast<const uint4*>(g + (size_t)(m0 + row) * N + n0 + c);
    }
    for (int i = tid; i < BN * QW; i += THREADS) {
      const int n = i / QW, w = i % QW;
      qs[n * (QW + 1) + w] = q32[(size_t)(n0 + n) * row_words + k0 * BITS / 32 + w];
    }
    if (tid < BN) qs[tid * (QW + 1) + QW] = 0u;  // guard word for the pair read
    for (int i = tid; i < BN * nsc; i += THREADS) {
      const int n = i / nsc, c = i % nsc;
      ss[n * sst + c] = s_blk[(size_t)(n0 + n) * nblk + c0 + c];
    }
    __syncthreads();

    // build the Ŵ tile: LUT gather times the block scale, rounded to bf16
    {
      const uint32_t* qrow = qs + wn * (QW + 1);
      const float* srow = ss + wn * sst;
      alignas(16) __nv_bfloat16 wv[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int k = wk + j;
        const float level = lut_s[lords::unpack_code<BITS>(qrow, k)];
        wv[j] = __float2bfloat16_rn(level * srow[(k0 + k) / bs - c0]);
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
int launch(const void* g, const void* q, const void* s_blk, const void* lut, void* dx, int M,
           int N, int K, int bs, int n_levels, cudaStream_t stream) {
  const size_t smem = smem_layout<BITS>(bs).total;
  cudaError_t err = lords::allow_smem(block_matmul_t_kernel<BITS>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(K / BK, M / BM);
  block_matmul_t_kernel<BITS><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const uint8_t*>(q),
      static_cast<const float*>(s_blk), static_cast<const float*>(lut),
      static_cast<float*>(dx), M, N, K, bs, n_levels);
  return cudaGetLastError();
}

}  // namespace

extern "C" int block_matmul_t_launch(const void* g, const void* q, const void* s_blk,
                                     const void* lut, void* dx, int M, int N, int K, int bs,
                                     int bits, int n_levels, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bs <= 0 || K % bs) return static_cast<int>(cudaErrorInvalidValue);
  switch (bits) {
    case 2: return launch<2>(g, q, s_blk, lut, dx, M, N, K, bs, n_levels, st);
    case 3: return launch<3>(g, q, s_blk, lut, dx, M, N, K, bs, n_levels, st);
    case 4: return launch<4>(g, q, s_blk, lut, dx, M, N, K, bs, n_levels, st);
    case 8: return launch<8>(g, q, s_blk, lut, dx, M, N, K, bs, n_levels, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
