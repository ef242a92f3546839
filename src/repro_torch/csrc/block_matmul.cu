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
// scales (0.5 + 4/bs bytes per weight) bound it.
//
// What the design does about it, prefill (block_matmul_launch, M > 8):
// csrc/dequant.cuh, the core this entry shares with csrc/lords_matmul.cu,
// in its BLOCK mode: wgmma m64n128k16 with Ŵ built in registers by the
// thread that multiplies it, x tiles through a ring of cp.async stages;
// each K step stages the scale columns its 64 columns touch beside its
// codes, so Ŵ costs a code, a LUT read, a scale read and a product per
// element, with no S and no division.  Rows past M are zero-filled and
// never stored; narrow N splits K over CTAs with a deterministic sum.
//
// Decode (M <= 8) has a second entry point, block_decode_launch: a
// weight-stream GEMV in the manner of csrc/lords_decode.cu, which a
// 256-row tile would waste 98% of at M = 4.  A warp owns four weight rows
// and walks all of K, each lane taking 8 consecutive codes per step
// (coalesced: 32 lanes read one contiguous run of each row); every weight
// is dequantized once per call, all M rows ride along, and x comes from L1.
// No K split, so no atomics and no zeroed output: each (row, token) is one
// warp's fixed shuffle-tree sum.
//
// Shapes: prefill any M >= 1, N % 128 == 0, K % 64 == 0, K % bs == 0;
// decode 1 <= M <= 8, N % 32 == 0, K % 256 == 0, K % bs == 0 (the dispatch
// layer pads; padded scales are 1.0).

#include "dequant.cuh"

namespace {

using namespace dequant;

template <int BITS>
int launch(const void* x, const void* q, const void* s_blk, const void* lut, void* y, void* ws,
           int M, int N, int K, int bs, int n_levels, int splits, cudaStream_t stream) {
  return run<BITS, BLOCK>(choose_block_plan<BITS>(bs), x, q, static_cast<const float*>(s_blk),
                          lut, static_cast<float*>(y), static_cast<float*>(ws), M, N, K,
                          n_levels, splits, bs, stream);
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

// x (M, K) bf16; q (N, K·bits/8) u8; s_blk (N, K / bs), lut f32; y (M, N)
// f32; ws f32 scratch of splits·M·N floats when splits > 1 (the split-K
// partials), else unused.
extern "C" int block_matmul_launch(const void* x, const void* q, const void* s_blk,
                                   const void* lut, void* y, void* ws, int M, int N, int K,
                                   int bs, int bits, int n_levels, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shapes_ok(M, N, K, splits) || bs <= 0 || K % bs)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bits) {
    case 2: return launch<2>(x, q, s_blk, lut, y, ws, M, N, K, bs, n_levels, splits, st);
    case 3: return launch<3>(x, q, s_blk, lut, y, ws, M, N, K, bs, n_levels, splits, st);
    case 4: return launch<4>(x, q, s_blk, lut, y, ws, M, N, K, bs, n_levels, splits, st);
    case 8: return launch<8>(x, q, s_blk, lut, y, ws, M, N, K, bs, n_levels, splits, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
