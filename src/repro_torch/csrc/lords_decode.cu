// Fused LoRDS dequant-GEMV for decode-shaped inputs (M <= 8 tokens).
//
//   y[M, N] (f32) = x[M, K] (bf16) · Ŵᵀ,   Ŵ = bf16(lut[unpack(Q)] ⊙ clamp(B·A))
//
// Replaces: src/repro/kernels/lords_decode.py::lords_decode_pallas (the
// weight-stationary TPU kernel behind every decode linear).
//
// What bounds it on an H100: the packed codes are 0.5 byte per weight at
// nf4, so streaming them once at 3.35 TB/s is the memory floor; but
// rebuilding S = B·A costs 2r FLOP per weight (48 at r = 24) on the FP32
// cores, about 96 FLOP per byte of codes — several times above the FP32
// ridge (67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte).  This first kernel is
// bound by the S product, not by the bytes.
//
// What the design does about it: every weight element is dequantized
// exactly once per call (weight-stationary: no M tiling, all M <= 8 rows
// ride along), each block stages its A slice, B rows and x slice in shared
// memory, and a warp builds four weight rows per pass so one A read feeds
// four rows.  To give 132 SMs enough blocks at N = 1024, K is split into
// 256-wide slices across blocks and the partial sums meet in the output
// with atomicAdd (the wrapper zeroes y first), so the summation order of
// the K slices varies from run to run.  Later work: the S tile on the
// tensor cores, which would bring this kernel to the byte bound.
//
// Shapes: M <= 8, N % 128 == 0, K % 256 == 0 (the dispatch layer pads).

#include "lords_common.cuh"

namespace {

constexpr int DBN = 128;       // weight rows per block
constexpr int DKS = 256;       // K slice per block
constexpr int THREADS = 256;   // 8 warps
constexpr int ROWS_PER_WARP = DBN / (THREADS / 32);
constexpr int R = 4;           // weight rows built together by one warp
constexpr int MMAX = 8;

struct Smem {
  size_t xs, as, bs, lut, total;
  int rs;
};

__host__ __device__ inline Smem smem_layout(int r) {
  Smem s;
  s.rs = (r % 2) ? r : r + 1;
  s.xs = 0;
  s.as = s.xs + sizeof(float) * MMAX * DKS;
  s.bs = s.as + sizeof(float) * r * DKS;
  s.lut = s.bs + sizeof(float) * DBN * s.rs;
  s.total = s.lut + sizeof(float) * 256;
  return s;
}

template <int BITS>
__device__ __forceinline__ uint64_t load_codes(const uint8_t* p) {
  // the 8 codes of one lane: BITS bytes, little-endian
  if constexpr (BITS == 4) {
    return *reinterpret_cast<const uint32_t*>(p);
  } else {
    uint64_t w = 0;
#pragma unroll
    for (int i = 0; i < BITS; ++i) w |= (uint64_t)p[i] << (8 * i);
    return w;
  }
}

template <int BITS>
__global__ void __launch_bounds__(THREADS)
lords_decode_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
                    const float* __restrict__ b, const float* __restrict__ a,
                    const float* __restrict__ lut, float* __restrict__ y, int M, int N,
                    int K, int r, int n_levels) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L = smem_layout(r);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* as = reinterpret_cast<float*>(smem + L.as);
  float* bs = reinterpret_cast<float*>(smem + L.bs);
  float* lut_s = reinterpret_cast<float*>(smem + L.lut);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.x * DBN, k0 = blockIdx.y * DKS;
  constexpr uint64_t kMask = (1ull << BITS) - 1ull;

  for (int i = tid; i < MMAX * DKS; i += THREADS) {
    const int m = i / DKS, c = i % DKS;
    xs[i] = m < M ? __bfloat162float(x[(size_t)m * K + k0 + c]) : 0.f;
  }
  for (int i = tid; i < r * DKS; i += THREADS) {
    const int rr = i / DKS, c = i % DKS;
    as[i] = a[(size_t)rr * K + k0 + c];
  }
  for (int i = tid; i < DBN * r; i += THREADS) {
    const int n = i / r, rr = i % r;
    bs[n * L.rs + rr] = b[(size_t)(n0 + n) * r + rr];
  }
  for (int i = tid; i < 256; i += THREADS) lut_s[i] = i < n_levels ? lut[i] : 0.f;
  __syncthreads();

  const int kl = lane * 8;  // this lane's 8 consecutive k of the slice
  const size_t row_bytes = (size_t)K * BITS / 8;
  for (int g = 0; g < ROWS_PER_WARP; g += R) {
    const int nb = warp * ROWS_PER_WARP + g;  // first of this pass' R rows
    float w[R][8];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) w[i][j] = 0.f;
    // S = B·A for R rows x 8 k
    for (int rr = 0; rr < r; ++rr) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + rr * DKS + kl);
      const float4 a1 = *reinterpret_cast<const float4*>(as + rr * DKS + kl + 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float bv = bs[(nb + i) * L.rs + rr];
#pragma unroll
        for (int j = 0; j < 8; ++j) w[i][j] = fmaf(bv, av[j], w[i][j]);
      }
    }
    // dequantize, then the M-row dot products over this lane's 8 k
    float acc[R][MMAX];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const uint64_t codes = load_codes<BITS>(
          q + (size_t)(n0 + nb + i) * row_bytes + (size_t)(k0 + kl) * BITS / 8);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        w[i][j] = lords::dequant_bf16(lut_s[(codes >> (j * BITS)) & kMask], w[i][j]);
#pragma unroll
      for (int m = 0; m < MMAX; ++m) acc[i][m] = 0.f;
    }
#pragma unroll
    for (int m = 0; m < MMAX; ++m) {
      if (m < M) {
        const float4 x0 = *reinterpret_cast<const float4*>(xs + m * DKS + kl);
        const float4 x1 = *reinterpret_cast<const float4*>(xs + m * DKS + kl + 4);
        const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][m] = fmaf(w[i][j], xv[j], acc[i][m]);
      }
    }
    // warp sums, one atomic per (row, token) and block
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int m = 0; m < MMAX; ++m) {
        if (m < M) {
          float v = acc[i][m];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
          if (lane == 0) atomicAdd(y + (size_t)m * N + n0 + nb + i, v);
        }
      }
    }
  }
}

template <int BITS>
int launch(const void* x, const void* q, const void* b, const void* a, const void* lut,
           void* y, int M, int N, int K, int r, int n_levels, cudaStream_t stream) {
  const size_t smem = smem_layout(r).total;
  cudaError_t err = lords::allow_smem(lords_decode_kernel<BITS>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(N / DBN, K / DKS);
  lords_decode_kernel<BITS><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const float*>(b), static_cast<const float*>(a),
      static_cast<const float*>(lut), static_cast<float*>(y), M, N, K, r, n_levels);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lords_decode_launch(const void* x, const void* q, const void* b, const void* a,
                                   const void* lut, void* y, int M, int N, int K, int r,
                                   int bits, int n_levels, void* stream) {
  if (M < 1 || M > MMAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return launch<2>(x, q, b, a, lut, y, M, N, K, r, n_levels, st);
    case 3: return launch<3>(x, q, b, a, lut, y, M, N, K, r, n_levels, st);
    case 4: return launch<4>(x, q, b, a, lut, y, M, N, K, r, n_levels, st);
    case 8: return launch<8>(x, q, b, a, lut, y, M, N, K, r, n_levels, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
