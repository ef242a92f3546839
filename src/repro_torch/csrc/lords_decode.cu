// Fused LoRDS dequant-GEMV for decode-shaped inputs (M <= 8 tokens).
//
//   y[M, N] (f32) = x[M, K] (bf16) · Ŵᵀ,   Ŵ = bf16(lut[unpack(Q)] ⊙ clamp(B·A))
//
// Replaces: src/repro/kernels/lords_decode.py::lords_decode_pallas (the
// weight-stationary TPU kernel behind every decode linear).
//
// What bounds it on an H100: the packed codes (0.5 byte a weight at nf4)
// are the byte floor, and S = B·A costs 2r FLOP a weight, 48 at r = 24:
// three TF32 passes of it on the tensor cores (495 TFLOP/s) take longer
// than the codes' bytes at 3.35 TB/s, so S's tensor-core operations bound
// it.
//
// What the design does about it: the GEMV core csrc/gemv.cuh in its LORDS
// mode (S by 3xTF32 on the tensor cores straight into the bf16 product's A
// fragments, every weight built once, codes through a `cp.async` ring,
// split-K with a deterministic last-CTA sum); this file only instantiates
// it: ranks up to 24 (every model's) on the `wgmma` path (gemv_wg_kernel),
// larger ones on `mma.sync` with B's fragments re-read from L1.
//
// Shapes: 1 <= M <= 8, N % 32 == 0, K % 128 == 0 (the dispatch layer pads).

#include "gemv.cuh"

namespace {

template <int BITS>
int launch(const void* x, const void* q, const void* b, const void* a, const void* lut, void* y,
           void* ws, void* tickets, int M, int N, int K, int r, int n_levels, int splits,
           cudaStream_t st) {
  switch ((r + 7) / 8) {
    case 1: return gemv::run_wg<BITS, 1>(x, q, b, a, lut, y, ws, tickets, M, N, K, r, n_levels,
                                         splits, st);
    case 2: return gemv::run_wg<BITS, 2>(x, q, b, a, lut, y, ws, tickets, M, N, K, r, n_levels,
                                         splits, st);
    case 3: return gemv::run_wg<BITS, 3>(x, q, b, a, lut, y, ws, tickets, M, N, K, r, n_levels,
                                         splits, st);
    default: return gemv::run<BITS, gemv::LORDS>(x, q, b, a, lut, y, ws, tickets, M, N, K, r,
                                                    n_levels, 0, splits, st);
  }
}

}  // namespace

// x (M, K) bf16; q (N, K·bits/8) u8; b (N, r), a (r, K), lut f32; y (M, N)
// f32; ws f32 scratch of splits·M·N floats when splits > 1 (the split-K
// partials), else unused; tickets: ceil(N / 256) int32, zero (left zero).
extern "C" int lords_decode_launch(const void* x, const void* q, const void* b, const void* a,
                                   const void* lut, void* y, void* ws, void* tickets, int M,
                                   int N, int K, int r, int bits, int n_levels, int splits,
                                   void* stream) {
  if (!gemv::shapes_ok(M, N, K, splits) || r < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: return launch<2>(x, q, b, a, lut, y, ws, tickets, M, N, K, r, n_levels, splits, st);
    case 3: return launch<3>(x, q, b, a, lut, y, ws, tickets, M, N, K, r, n_levels, splits, st);
    case 4: return launch<4>(x, q, b, a, lut, y, ws, tickets, M, N, K, r, n_levels, splits, st);
    case 8: return launch<8>(x, q, b, a, lut, y, ws, tickets, M, N, K, r, n_levels, splits, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
