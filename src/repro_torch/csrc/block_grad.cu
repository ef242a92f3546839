// Block-scale gradient of a block-wise linear (PEQA-style PEFT, which
// trains s_blk only).
//
// Given the output gradient g[M, N] and the activations x[M, K] (both bf16),
//
//   ∂L/∂Ŵ = gᵀ·x   (N, K), accumulated tile by tile and never written out,
//   ∂s_blk[n, c] = Σ_{k in block c} ∂L/∂Ŵ[n, k] · lut[Q[n, k]]
//
// with no clamp mask: block scales are not clamped in the forward (this is
// not csrc/lords_grad.cu's ∂S, whose mask tests |B·A| ≥ eps).
//
// Replaces: src/repro/kernels/lords_grad.py::block_grad_pallas.  The TPU
// kernel keeps an output column resident while its K grid axis runs in
// order; CUDA blocks over (N tile, K tile) run at once, in no order.  So
// each block writes its own per-tile partial sums: parts[slot, n, c] is the
// sum over the columns of block c that K tile kt holds, slot = kt − (the
// first K tile of block c).  A block spans several K tiles when bs > 128
// (or straddles two when bs does not divide 128); the dispatch sums the
// slots.  No atomics: the result is deterministic.
//
// What bounds it on an H100: the gᵀ·x product, 2·M·N·K operations on the
// bf16 tensor cores, at the training step's shapes (M = 4096); the
// epilogue is O(N·K) once per tile, not per M step.
//
// What the design does about it: a block owns one 128 x 128 (N, K) tile
// and walks M in steps of 32; its 8 warps keep the tile's ∂L/∂Ŵ in WMMA f32
// accumulators (bf16 operands: gᵀ read column-major straight from the
// staged g tile, so nothing is transposed in memory), as csrc/lords_grad.cu
// does.  After the M loop the tile goes to shared memory over the staging
// buffers; a warp then takes one row at a time, its lanes over consecutive
// columns (conflict-free), multiplies by lut[Q] and reduces each block's
// columns with a fixed shuffle tree.
//
// Shapes: M % 32 == 0, N % 128 == 0, K % 128 == 0, K % bs == 0 (the
// dispatch layer pads).

#include <mma.h>

#include "lords_common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 32, BN = 128, BK = 128;
constexpr int THREADS = 256;
constexpr int LDG = BN + 8;  // bf16 row stride of the staged g tile
constexpr int LDX = BK + 8;  // bf16 row stride of the staged x tile
constexpr int LDS = BK + 4;  // f32 row stride of the ∂L/∂Ŵ tile

struct Smem {
  // byte offsets; the g / x staging tiles and the f32 tile share offset 0
  size_t gs, xs, ds, lut, qs, total;
};

template <int BITS>
__host__ __device__ inline Smem smem_layout() {
  constexpr int QW = BK * BITS / 32;
  Smem s;
  s.gs = 0;
  s.xs = s.gs + sizeof(__nv_bfloat16) * BM * LDG;
  s.ds = 0;
  const size_t staged = s.xs + sizeof(__nv_bfloat16) * BM * LDX;
  const size_t dsz = sizeof(float) * BN * LDS;
  s.lut = staged > dsz ? staged : dsz;
  s.qs = s.lut + sizeof(float) * 256;
  s.total = s.qs + sizeof(uint32_t) * BN * (QW + 1);
  return s;
}

template <int BITS>
__global__ void __launch_bounds__(THREADS)
block_grad_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                  const uint8_t* __restrict__ q, const float* __restrict__ lut,
                  float* __restrict__ parts, int M, int N, int K, int bs, int n_levels) {
  constexpr int QW = BK * BITS / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L = smem_layout<BITS>();
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem + L.gs);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + L.xs);
  float* ds = reinterpret_cast<float*>(smem + L.ds);
  float* lut_s = reinterpret_cast<float*>(smem + L.lut);
  uint32_t* qs = reinterpret_cast<uint32_t*>(smem + L.qs);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int kt = blockIdx.x, jt = blockIdx.y;
  const int k0 = kt * BK, n0 = jt * BN;
  const int row_words = K * BITS / 32;
  const int nblk = K / bs;
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q);

  // the tile's codes and the LUT (outside the staging region)
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

  // per-block sums of ∂L/∂Ŵ ⊙ lut[Q]: a warp per row, lane l holds columns
  // l, l + 32, l + 64, l + 96; each block column of the tile is one fixed
  // shuffle-tree reduction of the lanes' in-block terms
  const int c_lo = k0 / bs, c_hi = (k0 + BK - 1) / bs;
  for (int n = warp; n < BN; n += THREADS / 32) {
    const uint32_t* qrow = qs + n * (QW + 1);
    float t[BK / 32];
#pragma unroll
    for (int c = 0; c < BK / 32; ++c) {
      const int k = lane + 32 * c;
      t[c] = ds[n * LDS + k] * lut_s[lords::unpack_code<BITS>(qrow, k)];
    }
    for (int cb = c_lo; cb <= c_hi; ++cb) {
      const int kb = cb * bs - k0, ke = kb + bs;  // block columns, tile-relative
      float v = 0.f;
#pragma unroll
      for (int c = 0; c < BK / 32; ++c) {
        const int k = lane + 32 * c;
        if (k >= kb && k < ke) v += t[c];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) {
        const int slot = kt - (cb * bs) / BK;
        parts[((size_t)slot * N + n0 + n) * nblk + cb] = v;
      }
    }
  }
}

template <int BITS>
int launch(const void* x, const void* g, const void* q, const void* lut, void* parts, int M,
           int N, int K, int bs, int n_levels, cudaStream_t stream) {
  const size_t smem = smem_layout<BITS>().total;
  cudaError_t err = lords::allow_smem(block_grad_kernel<BITS>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(K / BK, N / BN);
  block_grad_kernel<BITS><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
      static_cast<const uint8_t*>(q), static_cast<const float*>(lut),
      static_cast<float*>(parts), M, N, K, bs, n_levels);
  return cudaGetLastError();
}

}  // namespace

// parts: (slots, N, K / bs) f32, zeroed by the caller; slots >= the most K
// tiles of 128 one block touches.
extern "C" int block_grad_launch(const void* x, const void* g, const void* q, const void* lut,
                                 void* parts, int M, int N, int K, int bs, int bits,
                                 int n_levels, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bs <= 0 || K % bs) return static_cast<int>(cudaErrorInvalidValue);
  switch (bits) {
    case 2: return launch<2>(x, g, q, lut, parts, M, N, K, bs, n_levels, st);
    case 3: return launch<3>(x, g, q, lut, parts, M, N, K, bs, n_levels, st);
    case 4: return launch<4>(x, g, q, lut, parts, M, N, K, bs, n_levels, st);
    case 8: return launch<8>(x, g, q, lut, parts, M, N, K, bs, n_levels, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
