// Transposed LoRDS dequant-matmul: the activation gradient of a quantized
// linear in training.
//
//   dx[M, K] (f32) = g[M, N] (bf16) · Ŵ,   Ŵ = bf16(lut[unpack(Q)] ⊙ clamp(B·A))
//
// Replaces: src/repro/kernels/lords_matmul_t.py::lords_matmul_t_pallas.
//
// What bounds it on an H100: at the training step's shapes (M = 4096 tokens,
// N, K = 1024..14336) the bf16 product, 2·M·N·K operations, is far above the
// card's byte/FLOP ridge: tensor-core operations bound it.  Rebuilding S =
// B·A for every 256-token tile adds 2r operations per weight, which 3xTF32
// wgmma runs on the tensor cores at f32 accuracy (6r/256 of the product's
// time at the TF32 rate).
//
// What the design does about it: csrc/dequant_t.cuh, the core this kernel
// shares with csrc/block_matmul_t.cu (the forward kernel's design turned
// around: wgmma with Ŵᵀ built in registers and the g tile, loaded by TMA,
// from shared memory; codes and B tiles through a cp.async ring; one
// barrier a step).  Here a pre-pass splits A and B into
// tf32 hi / lo parts once per call, in 64-row tiles; a rank whose split A
// does not fit in shared memory beside the rings takes the S_MEM mode, where
// the pre-pass writes S = B·A in f32 and the kernel stages S tiles instead.
//
// Shapes: any M >= 1, N % 64 == 0, K % 128 == 0 (the dispatch layer pads N
// and K; it pads M to 128 for the lords_grad kernel that shares g).

#include "dequant_t.cuh"

namespace {

using namespace dequant_t;

template <int BITS>
size_t workspace(int N, int K, int r) {
  const Plan p = choose_plan<BITS>(TF32, r, 0);
  return hopper::prepass_floats(p.mode == S_MEM, p.r8, N, K);
}

template <int BITS>
int launch(const void* g, const void* q, const void* b, const void* a, const void* lut,
           void* dx, void* ws, int M, int N, int K, int r, int n_levels, cudaStream_t stream) {
  const Plan p = choose_plan<BITS>(TF32, r, 0);
  float* pre = static_cast<float*>(ws);
  cudaError_t err =
      hopper::prepass<64, BN>(b, a, pre, N, K, r, p.r8, p.mode == S_MEM, stream);
  if (err != cudaSuccess) return err;
  return p.mode == S_MEM ? run<BITS, S_MEM>(p, g, q, pre, lut, dx, M, N, K, 0, n_levels, stream)
                         : run<BITS, TF32>(p, g, q, pre, lut, dx, M, N, K, 0, n_levels, stream);
}

}  // namespace

// The f32 scratch `lords_matmul_t_launch` needs, in floats (-1: bits not
// built): N·K for S from memory, else the split A and B.
extern "C" long long lords_matmul_t_workspace(int N, int K, int r, int bits) {
  switch (bits) {
    case 2: return (long long)workspace<2>(N, K, r);
    case 3: return (long long)workspace<3>(N, K, r);
    case 4: return (long long)workspace<4>(N, K, r);
    case 8: return (long long)workspace<8>(N, K, r);
    default: return -1;
  }
}

// g (M, N) bf16; q (N, K·bits/8) u8; b (N, r), a (r, K), lut f32; dx (M, K)
// f32; ws f32 scratch of lords_matmul_t_workspace(N, K, r, bits) floats.
extern "C" int lords_matmul_t_launch(const void* g, const void* q, const void* b,
                                     const void* a, const void* lut, void* dx, void* ws, int M,
                                     int N, int K, int r, int bits, int n_levels, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shapes_ok(M, N, K) || r < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (bits) {
    case 2: return launch<2>(g, q, b, a, lut, dx, ws, M, N, K, r, n_levels, st);
    case 3: return launch<3>(g, q, b, a, lut, dx, ws, M, N, K, r, n_levels, st);
    case 4: return launch<4>(g, q, b, a, lut, dx, ws, M, N, K, r, n_levels, st);
    case 8: return launch<8>(g, q, b, a, lut, dx, ws, M, N, K, r, n_levels, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
