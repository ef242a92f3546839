// Fused LoRDS dequant-matmul for prefill-shaped inputs (M > 8 tokens).
//
//   y[M, N] (f32) = x[M, K] (bf16) · Ŵᵀ,   Ŵ = bf16(lut[unpack(Q)] ⊙ clamp(B·A))
//
// Replaces: src/repro/kernels/lords_matmul.py::lords_matmul_pallas (the
// TPU kernel behind every prefill and training-forward linear).
//
// What bounds it on an H100: at the main path's shapes (M = 2176 or 4096,
// N, K = 1024..14336) the bf16 product is far above the card's byte/FLOP
// ridge, so the function is bound by tensor-core operations.  The S = B·A
// rebuild adds 2r FLOP per weight for every block of x rows, in f32.  This
// design reaches 150-250 TFLOP/s on an H100 SXM (PERF.md): the x tile and
// the split A slices (48 KB a CTA and K step) cross L2 and shared memory,
// where the two warpgroups' product and S operands are read as well, and
// 3xTF32 S shares the tensor pipe with the product (6r/256 of its time).
//
// What the design does about it: csrc/dequant.cuh, the core this kernel
// shares with the prefill entry of csrc/block_matmul.cu (wgmma with Ŵ built
// in registers, x tiles, codes and A slices through rings of cp.async
// stages, split-K for narrow N).  Here a pre-pass splits A and B into tf32
// hi / lo parts once per call for 3xTF32 S in the kernel (TF32 mode); a
// rank whose split B does not fit in shared memory takes the S_MEM mode,
// where the pre-pass writes S = B·A in f32 and the kernel stages S tiles.
//
// Shapes: any M >= 1, N % 128 == 0, K % 64 == 0 (the dispatch layer pads N
// and K).

#include "dequant.cuh"

namespace {

using namespace dequant;

// f32 scratch of the pre-pass: split A and B, or S
inline size_t prepass_floats(const Plan& p, int N, int K) {
  return hopper::prepass_floats(p.mode == S_MEM, p.r8, N, K);
}

template <int BITS>
size_t workspace(int M, int N, int K, int r, int splits) {
  return prepass_floats(choose_plan<BITS>(r), N, K) + (splits > 1 ? (size_t)splits * M * N : 0);
}

template <int BITS>
int launch(const void* x, const void* q, const void* b, const void* a, const void* lut,
           void* y, void* ws, int M, int N, int K, int r, int n_levels, int splits,
           cudaStream_t stream) {
  const Plan p = choose_plan<BITS>(r);
  float* pre = static_cast<float*>(ws);
  float* part = pre + prepass_floats(p, N, K);
  float* out = static_cast<float*>(y);
  cudaError_t err = hopper::prepass<BK, BN>(b, a, pre, N, K, r, p.r8, p.mode == S_MEM, stream);
  if (err != cudaSuccess) return err;
  return p.mode == S_MEM
             ? run<BITS, S_MEM>(p, x, q, pre, lut, out, part, M, N, K, n_levels, splits, 0, stream)
             : run<BITS, TF32>(p, x, q, pre, lut, out, part, M, N, K, n_levels, splits, 0, stream);
}

}  // namespace

// The f32 scratch `lords_matmul_launch` needs, in floats (-1: bits not built).
extern "C" long long lords_matmul_workspace(int M, int N, int K, int r, int bits, int splits) {
  switch (bits) {
    case 2: return (long long)workspace<2>(M, N, K, r, splits);
    case 3: return (long long)workspace<3>(M, N, K, r, splits);
    case 4: return (long long)workspace<4>(M, N, K, r, splits);
    case 8: return (long long)workspace<8>(M, N, K, r, splits);
    default: return -1;
  }
}

// x (M, K) bf16; q (N, K·bits/8) u8; b (N, r), a (r, K), lut f32; y (M, N)
// f32; ws f32 scratch of lords_matmul_workspace(M, N, K, r, bits, splits)
// floats.
extern "C" int lords_matmul_launch(const void* x, const void* q, const void* b, const void* a,
                                   const void* lut, void* y, void* ws, int M, int N, int K,
                                   int r, int bits, int n_levels, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!shapes_ok(M, N, K, splits) || r < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (bits) {
    case 2: return launch<2>(x, q, b, a, lut, y, ws, M, N, K, r, n_levels, splits, st);
    case 3: return launch<3>(x, q, b, a, lut, y, ws, M, N, K, r, n_levels, splits, st);
    case 4: return launch<4>(x, q, b, a, lut, y, ws, M, N, K, r, n_levels, splits, st);
    case 8: return launch<8>(x, q, b, a, lut, y, ws, M, N, K, r, n_levels, splits, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
