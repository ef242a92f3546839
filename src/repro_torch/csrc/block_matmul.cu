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
// Decode (M <= 8) has a second entry point, block_decode_launch: the GEMV
// core csrc/gemv.cuh, which csrc/lords_decode.cu shares, in its BLOCK
// mode: `mma.sync` m16n8k16 with Ŵ's 16 rows as the A operand and the
// tokens as the n8 side (no FMA a token), every weight built once from a
// code, a LUT read and its block's scale, codes through a four-stage
// `cp.async` ring, split-K for narrow N with a deterministic last-CTA sum
// (no atomics, no zeroed output).
//
// Shapes: prefill any M >= 1, N % 128 == 0, K % 64 == 0, K % bs == 0;
// decode 1 <= M <= 8, N % 32 == 0, K % 128 == 0, K % bs == 0 (the dispatch
// layer pads; padded scales are 1.0).

#include "dequant.cuh"
#include "gemv.cuh"

namespace {

using namespace dequant;

template <int BITS>
int launch(const void* x, const void* q, const void* s_blk, const void* lut, void* y, void* ws,
           int M, int N, int K, int bs, int n_levels, int splits, cudaStream_t stream) {
  return run<BITS, BLOCK>(choose_block_plan<BITS>(bs), x, q, static_cast<const float*>(s_blk),
                          lut, static_cast<float*>(y), static_cast<float*>(ws), M, N, K,
                          n_levels, splits, bs, stream);
}

template <int BITS>
int launch_decode(const void* x, const void* q, const void* s_blk, const void* lut, void* y,
                  void* ws, void* tickets, int M, int N, int K, int bs, int n_levels, int splits,
                  cudaStream_t stream) {
  if (bs % 16 == 0)
    return gemv::run<BITS, gemv::BLOCK>(x, q, s_blk, nullptr, lut, y, ws, tickets, M, N, K,
                                           0, n_levels, bs, splits, stream);
  return gemv::run<BITS, gemv::BLOCK_ANY>(x, q, s_blk, nullptr, lut, y, ws, tickets, M, N, K,
                                             0, n_levels, bs, splits, stream);
}

}  // namespace

// x (M, K) bf16, 1 <= M <= 8; q (N, K·bits/8) u8; s_blk (N, K / bs), lut
// f32; y (M, N) f32; ws f32 scratch of splits·M·N floats when splits > 1,
// else unused; tickets: ceil(N / 256) int32, zero (left zero).
extern "C" int block_decode_launch(const void* x, const void* q, const void* s_blk,
                                   const void* lut, void* y, void* ws, void* tickets, int M,
                                   int N, int K, int bs, int bits, int n_levels, int splits,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!gemv::shapes_ok(M, N, K, splits) || bs <= 0 || K % bs)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bits) {
    case 2: return launch_decode<2>(x, q, s_blk, lut, y, ws, tickets, M, N, K, bs, n_levels, splits, st);
    case 3: return launch_decode<3>(x, q, s_blk, lut, y, ws, tickets, M, N, K, bs, n_levels, splits, st);
    case 4: return launch_decode<4>(x, q, s_blk, lut, y, ws, tickets, M, N, K, bs, n_levels, splits, st);
    case 8: return launch_decode<8>(x, q, s_blk, lut, y, ws, tickets, M, N, K, bs, n_levels, splits, st);
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
