// Fused block-wise dequant-matmul: the bitsandbytes-style NF4 baseline
// (block-wise NF4 serving, and the frozen base of QLoRA / LoftQ / QPiSSA).
//
//   y[M, N] (f32) = x[M, K] (bf16) · Ŵᵀ,   Ŵ = bf16(lut[unpack(Q)] ⊙ repeat(s_blk))
//
// Column k of row n is scaled by s_blk[n, k / bs]; bs is the effective
// block, K / (s_blk's columns), which may be any divisor of K.
//
// Replaces: src/repro/kernels/block_matmul.py::block_matmul_pallas, which
// the JAX package runs for every block-wise linear at every M (it has no
// decode kernel of its own).
//
// What bounds it on an H100: at prefill shapes (M = 2176, N, K =
// 1024..14336) the bf16 product is far above the card's byte/FLOP ridge:
// tensor-core operations bound it.  At decode (M = 4) the packed codes and
// scales (0.5 + 4/bs bytes per weight) bound it, and the 128-row tile of
// this first kernel is 97% padding there.
//
// What the design does about it: the LoRDS kernel's shape
// (csrc/lords_matmul.cu) with its rank-r FP32 rebuild of S replaced by one
// scale load per (row, block): each K step stages the x tile, the packed
// codes and the scales of the block columns the step touches, builds the
// 128 x 32 Ŵ tile once in shared memory, and all 8 warps consume it with
// bf16 WMMA into f32 accumulators.  Ŵ never exists in device memory.  Later
// work: wgmma + TMA pipelining.
//
// Decode (M <= 8) has a second entry point, block_decode_launch: a
// weight-stream GEMV in the manner of csrc/lords_decode.cu, which the
// 128-row tile above wastes 97% of at M = 4 (3.47 ms a layer against a
// 0.035 ms byte bound, NVIDIA H100 80GB HBM3 at 700 W).  A warp owns four
// weight rows and walks all of K, each lane taking 8 consecutive codes per
// step (coalesced: 32 lanes read one contiguous run of each row); every
// weight is dequantized once per call, all M rows ride along, and x comes
// from L1.  No K split, so no atomics and no zeroed output: each (row,
// token) is one warp's fixed shuffle-tree sum.
//
// Shapes: M % 128 == 0, N % 128 == 0, K % 32 == 0, K % bs == 0; decode:
// 1 <= M <= 8, N % 32 == 0, K % 256 == 0, K % bs == 0 (the dispatch layer
// pads; padded scales are 1.0).

#include <mma.h>

#include "lords_common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int THREADS = 256;
constexpr int LDS = BK + 8;  // bf16 row stride of the x / Ŵ tiles (80 bytes)

// the block columns one K step can touch, and the odd row stride of their
// staged scales
__host__ __device__ inline int scale_cols(int bs) {
  const int c = (BK - 1) / bs + 2;
  return c < BK ? c : BK;
}
__host__ __device__ inline int scale_stride(int bs) { return scale_cols(bs) | 1; }

struct Smem {
  size_t xs, ws, ss, lut, qs, total;  // byte offsets of the dynamic block
};

template <int BITS>
__host__ __device__ inline Smem smem_layout(int bs) {
  Smem s;
  s.xs = 0;
  s.ws = s.xs + sizeof(__nv_bfloat16) * BM * LDS;
  s.ss = s.ws + sizeof(__nv_bfloat16) * BN * LDS;
  s.lut = s.ss + sizeof(float) * BN * scale_stride(bs);
  s.qs = s.lut + sizeof(float) * 256;
  s.total = s.qs + sizeof(uint32_t) * BN * (BITS + 1);
  return s;
}

template <int BITS>
__global__ void __launch_bounds__(THREADS)
block_matmul_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
                    const float* __restrict__ s_blk, const float* __restrict__ lut,
                    float* __restrict__ y, int M, int N, int K, int bs, int n_levels) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L = smem_layout<BITS>(bs);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + L.xs);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + L.ws);
  float* ss = reinterpret_cast<float*>(smem + L.ss);
  float* lut_s = reinterpret_cast<float*>(smem + L.lut);
  uint32_t* qs = reinterpret_cast<uint32_t*>(smem + L.qs);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int row_words = K * BITS / 32;  // packed words of one weight row
  const int nblk = K / bs, sst = scale_stride(bs);
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q);

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
    const int c0 = k0 / bs, nsc = (k0 + BK - 1) / bs - c0 + 1;
    // stage the x tile (BM x BK bf16, 16-byte loads), codes and scales
    for (int i = tid; i < BM * BK / 8; i += THREADS) {
      const int row = i / (BK / 8), c = (i % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(xs + row * LDS + c) =
          *reinterpret_cast<const uint4*>(x + (size_t)(m0 + row) * K + k0 + c);
    }
    for (int i = tid; i < BN * BITS; i += THREADS) {
      const int n = i / BITS, w = i % BITS;
      qs[n * (BITS + 1) + w] = q32[(size_t)(n0 + n) * row_words + k0 * BITS / 32 + w];
    }
    if (tid < BN) qs[tid * (BITS + 1) + BITS] = 0u;  // guard word for the pair read
    for (int i = tid; i < BN * nsc; i += THREADS) {
      const int n = i / nsc, c = i % nsc;
      ss[n * sst + c] = s_blk[(size_t)(n0 + n) * nblk + c0 + c];
    }
    __syncthreads();

    // build the Ŵ tile: LUT gather times the block scale, rounded to bf16
    {
      const uint32_t* qrow = qs + wn * (BITS + 1);
      const float* srow = ss + wn * sst;
      alignas(16) __nv_bfloat16 wv[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int k = wk + j;
        const float level = lut_s[lords::unpack_code<BITS>(qrow, k)];
        wv[j] = __float2bfloat16_rn(level * srow[(k0 + k) / bs - c0]);
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
int launch(const void* x, const void* q, const void* s_blk, const void* lut, void* y, int M,
           int N, int K, int bs, int n_levels, cudaStream_t stream) {
  const size_t smem = smem_layout<BITS>(bs).total;
  cudaError_t err = lords::allow_smem(block_matmul_kernel<BITS>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(N / BN, M / BM);
  block_matmul_kernel<BITS><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(s_blk), static_cast<const float*>(lut),
      static_cast<float*>(y), M, N, K, bs, n_levels);
  return cudaGetLastError();
}

constexpr int DEC_THREADS = 256;                     // 8 warps
constexpr int DEC_R = 4;                              // weight rows per warp
constexpr int DEC_ROWS = DEC_R * (DEC_THREADS / 32);  // weight rows per block
constexpr int DEC_MMAX = 8;

template <int BITS>
__global__ void __launch_bounds__(DEC_THREADS)
block_decode_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
                    const float* __restrict__ s_blk, const float* __restrict__ lut,
                    float* __restrict__ y, int M, int N, int K, int bs, int n_levels) {
  __shared__ float lut_s[256];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.x * DEC_ROWS + warp * DEC_R;  // this warp's first row
  const int nblk = K / bs;
  const size_t row_bytes = (size_t)K * BITS / 8;
  constexpr uint64_t kMask = (1ull << BITS) - 1ull;
  for (int i = tid; i < 256; i += DEC_THREADS) lut_s[i] = i < n_levels ? lut[i] : 0.f;
  __syncthreads();

  float acc[DEC_R][DEC_MMAX];
#pragma unroll
  for (int i = 0; i < DEC_R; ++i)
#pragma unroll
    for (int m = 0; m < DEC_MMAX; ++m) acc[i][m] = 0.f;

  for (int kb = lane * 8; kb < K; kb += 32 * 8) {
    // the M rows of x at this lane's 8 columns (16-byte loads, L1-resident)
    float xv[DEC_MMAX][8];
#pragma unroll
    for (int m = 0; m < DEC_MMAX; ++m) {
      if (m < M) {
        const uint4 raw = *reinterpret_cast<const uint4*>(x + (size_t)m * K + kb);
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) xv[m][j] = __bfloat162float(h[j]);
      }
    }
    const int c0 = kb / bs, c7 = (kb + 7) / bs;
#pragma unroll
    for (int i = 0; i < DEC_R; ++i) {
      const int n = n0 + i;
      const uint64_t codes = lords::load_codes8<BITS>(q + (size_t)n * row_bytes, kb);
      const float* srow = s_blk + (size_t)n * nblk;
      const float s0 = srow[c0], s7 = srow[c7];
      float w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = (kb + j) / bs;
        const float sv = c == c0 ? s0 : (c == c7 ? s7 : srow[c]);
        w[j] = __bfloat162float(
            __float2bfloat16_rn(lut_s[(codes >> (j * BITS)) & kMask] * sv));
      }
#pragma unroll
      for (int m = 0; m < DEC_MMAX; ++m) {
        if (m < M) {
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][m] = fmaf(w[j], xv[m][j], acc[i][m]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < DEC_R; ++i) {
#pragma unroll
    for (int m = 0; m < DEC_MMAX; ++m) {
      if (m < M) {
        float v = acc[i][m];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) y[(size_t)m * N + n0 + i] = v;
      }
    }
  }
}

template <int BITS>
int launch_decode(const void* x, const void* q, const void* s_blk, const void* lut, void* y,
                  int M, int N, int K, int bs, int n_levels, cudaStream_t stream) {
  block_decode_kernel<BITS><<<N / DEC_ROWS, DEC_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(s_blk), static_cast<const float*>(lut),
      static_cast<float*>(y), M, N, K, bs, n_levels);
  return cudaGetLastError();
}

}  // namespace

extern "C" int block_decode_launch(const void* x, const void* q, const void* s_blk,
                                   const void* lut, void* y, int M, int N, int K, int bs,
                                   int bits, int n_levels, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || M > DEC_MMAX || bs <= 0 || K % bs) return static_cast<int>(cudaErrorInvalidValue);
  switch (bits) {
    case 2: return launch_decode<2>(x, q, s_blk, lut, y, M, N, K, bs, n_levels, st);
    case 3: return launch_decode<3>(x, q, s_blk, lut, y, M, N, K, bs, n_levels, st);
    case 4: return launch_decode<4>(x, q, s_blk, lut, y, M, N, K, bs, n_levels, st);
    case 8: return launch_decode<8>(x, q, s_blk, lut, y, M, N, K, bs, n_levels, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int block_matmul_launch(const void* x, const void* q, const void* s_blk,
                                   const void* lut, void* y, int M, int N, int K, int bs,
                                   int bits, int n_levels, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bs <= 0 || K % bs) return static_cast<int>(cudaErrorInvalidValue);
  switch (bits) {
    case 2: return launch<2>(x, q, s_blk, lut, y, M, N, K, bs, n_levels, st);
    case 3: return launch<3>(x, q, s_blk, lut, y, M, N, K, bs, n_levels, st);
    case 4: return launch<4>(x, q, s_blk, lut, y, M, N, K, bs, n_levels, st);
    case 8: return launch<8>(x, q, s_blk, lut, y, M, N, K, bs, n_levels, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
