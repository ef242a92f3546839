// Shared device helpers of the LoRDS dequant-matmul kernels.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lords {

constexpr float kScaleEps = 1e-8f;  // |S| >= eps, the JAX package's SCALE_EPS

// clamp_scale: sign-preserving |S| >= eps; +0.0 and -0.0 both become +eps.
__device__ __forceinline__ float clamp_scale(float s) {
  return fabsf(s) < kScaleEps ? (s >= 0.f ? kScaleEps : -kScaleEps) : s;
}

// Ŵ element exactly as the plain version computes it: lut[code] * S in f32,
// rounded to bf16 (the activation dtype) before the product.
__device__ __forceinline__ float dequant_bf16(float level, float s) {
  return __bfloat162float(__float2bfloat16_rn(level * clamp_scale(s)));
}

// Set the dynamic shared-memory ceiling of a kernel when it needs more than
// the default 48 KB; returns the CUDA error of the call.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace lords
