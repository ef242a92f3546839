// LoRDS quantization step (paper Alg. 1, step 2.1), emitted packed:
//
//   S = clamp(B·A),   ratio = W ⊘ S,   code = Σ_l [ratio > mid_l]
//
// i.e. the nearest codebook level of W/S (a value exactly on a midpoint
// takes the lower level), written in the repository's pack layout: code k of
// a row at bit k·BITS of the row's little-endian byte stream.
//
// Replaces: src/repro/kernels/lut_quantize.py::lut_quantize_pallas, the QAT
// fake-quant forward (and the PTQ refinement loop's quantization).
//
// What bounds it on an H100: bytes.  It reads the f32 master W once (4 bytes
// per weight) and writes BITS/8 bytes of codes; the S = B·A rebuild is 2r
// FP32 operations per weight, well under the byte time at r <= 24.
//
// What the design does about it: one warp per weight row, each lane 8
// consecutive weights (two 16-byte loads, so a warp reads 1 KB contiguous);
// the block's A slice (r x 256) and B rows sit in shared memory; the codes
// are packed in registers and each lane stores its BITS bytes at once.
//
// Shapes: K % 8 == 0; N and K otherwise free (ragged edges are masked).

#include "lords_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = THREADS / 32;  // rows of a block: one per warp
constexpr int CPT = 8;              // codes per thread
constexpr int BK = 32 * CPT;        // columns of a block

template <int BITS>
__global__ void __launch_bounds__(THREADS)
lut_quantize_kernel(const float* __restrict__ w, const float* __restrict__ b,
                    const float* __restrict__ a, const float* __restrict__ mids,
                    uint8_t* __restrict__ out, int N, int K, int r, int n_mids) {
  extern __shared__ __align__(16) float smem_f[];
  float* as = smem_f;                // r x BK
  float* bs = as + r * BK;           // ROWS x r
  float* ms = bs + ROWS * r;         // n_mids

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * BK, n0 = blockIdx.y * ROWS;

  for (int i = tid; i < r * BK; i += THREADS) {
    const int rr = i / BK, c = i % BK;
    as[i] = k0 + c < K ? a[(size_t)rr * K + k0 + c] : 0.f;
  }
  for (int i = tid; i < ROWS * r; i += THREADS) {
    const int n = i / r, rr = i % r;
    bs[i] = n0 + n < N ? b[(size_t)(n0 + n) * r + rr] : 0.f;
  }
  for (int i = tid; i < n_mids; i += THREADS) ms[i] = mids[i];
  __syncthreads();

  const int n = n0 + warp, k = k0 + lane * CPT;
  if (n >= N || k >= K) return;

  float s[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) s[j] = 0.f;
  for (int rr = 0; rr < r; ++rr) {
    const float bv = bs[warp * r + rr];
    const float4* arow = reinterpret_cast<const float4*>(as + rr * BK + lane * CPT);
    const float4 a0 = arow[0], a1 = arow[1];
    const float av[CPT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int j = 0; j < CPT; ++j) s[j] = fmaf(bv, av[j], s[j]);
  }
  const float4* wp = reinterpret_cast<const float4*>(w + (size_t)n * K + k);
  const float4 w0 = wp[0], w1 = wp[1];
  const float wv[CPT] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};

  uint64_t word = 0;
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const float ratio = wv[j] / lords::clamp_scale(s[j]);
    uint32_t code = 0;
    for (int l = 0; l < n_mids; ++l) code += ratio > ms[l] ? 1u : 0u;
    word |= (uint64_t)code << (j * BITS);
  }

  // this lane's CPT codes are BITS bytes at byte k·BITS/8 of the row
  uint8_t* dst = out + (size_t)n * (K / 8 * BITS) + (size_t)k / 8 * BITS;
  if constexpr (BITS == 8) {
    *reinterpret_cast<uint64_t*>(dst) = word;
  } else if constexpr (BITS == 4) {
    *reinterpret_cast<uint32_t*>(dst) = (uint32_t)word;
  } else if constexpr (BITS == 2) {
    *reinterpret_cast<uint16_t*>(dst) = (uint16_t)word;
  } else {
#pragma unroll
    for (int i = 0; i < BITS; ++i) dst[i] = (uint8_t)(word >> (8 * i));
  }
}

template <int BITS>
int launch(const void* w, const void* b, const void* a, const void* mids, void* out, int N,
           int K, int r, int n_mids, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (r * BK + ROWS * r + n_mids);
  cudaError_t err = lords::allow_smem(lut_quantize_kernel<BITS>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((K + BK - 1) / BK, (N + ROWS - 1) / ROWS);
  lut_quantize_kernel<BITS><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<const float*>(a), static_cast<const float*>(mids),
      static_cast<uint8_t*>(out), N, K, r, n_mids);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lut_quantize_launch(const void* w, const void* b, const void* a,
                                   const void* mids, void* out, int N, int K, int r, int bits,
                                   int n_mids, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return launch<2>(w, b, a, mids, out, N, K, r, n_mids, st);
    case 3: return launch<3>(w, b, a, mids, out, N, K, r, n_mids, st);
    case 4: return launch<4>(w, b, a, mids, out, N, K, r, n_mids, st);
    case 8: return launch<8>(w, b, a, mids, out, N, K, r, n_mids, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
