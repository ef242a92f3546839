// Transposed block-wise dequant-matmul: the activation gradient of a
// block-wise / QLoRA / PEQA linear in training.
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
// What the design does about it: csrc/dequant_t.cuh, the core this kernel
// shares with csrc/lords_matmul_t.cu, in its BLOCK mode: each step stages
// the scale columns of its 64 rows beside their codes, and each thread
// finds its two scale columns once per CTA, so Ŵ costs a code, a LUT read
// and a product per element, with no S and no division.
//
// Shapes: any M >= 1, N % 64 == 0, K % 128 == 0, K % bs == 0 (the dispatch
// layer pads; padded scales are 1.0).

#include "dequant_t.cuh"

namespace {

using namespace dequant_t;

template <int BITS>
int launch(const void* g, const void* q, const void* s_blk, const void* lut, void* dx, int M,
           int N, int K, int bs, int n_levels, cudaStream_t stream) {
  const Plan p = choose_plan<BITS>(BLOCK, 0, block_cols(bs));
  return run<BITS, BLOCK>(p, g, q, static_cast<const float*>(s_blk), lut, dx, M, N, K, bs,
                          n_levels, stream);
}

}  // namespace

// g (M, N) bf16; q (N, K·bits/8) u8; s_blk (N, K / bs), lut f32; dx (M, K)
// f32.
extern "C" int block_matmul_t_launch(const void* g, const void* q, const void* s_blk,
                                     const void* lut, void* dx, int M, int N, int K, int bs,
                                     int bits, int n_levels, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shapes_ok(M, N, K) || bs <= 0 || K % bs) return static_cast<int>(cudaErrorInvalidValue);
  switch (bits) {
    case 2: return launch<2>(g, q, s_blk, lut, dx, M, N, K, bs, n_levels, st);
    case 3: return launch<3>(g, q, s_blk, lut, dx, M, N, K, bs, n_levels, st);
    case 4: return launch<4>(g, q, s_blk, lut, dx, M, N, K, bs, n_levels, st);
    case 8: return launch<8>(g, q, s_blk, lut, dx, M, N, K, bs, n_levels, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
