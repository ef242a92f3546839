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

// Code k of a row whose packed 32-bit words are staged in shared memory
// with one guard word after them: code k sits at bit k·BITS of the row's
// little-endian bit stream, which covers the 2-, 3- (8 codes per 3 bytes),
// 4- and 8-bit pack layouts alike.
template <int BITS>
__device__ __forceinline__ uint32_t unpack_code(const uint32_t* row, int k) {
  const int bit = k * BITS;
  const uint64_t pair = (uint64_t)row[bit >> 5] | ((uint64_t)row[(bit >> 5) + 1] << 32);
  return (uint32_t)(pair >> (bit & 31)) & ((1u << BITS) - 1u);
}

// Words of a staged row of 64 codes: its 2·BITS words rounded up to whole
// 16-byte copies, plus 4 where that makes the stride a multiple of 8 (the
// eight rows of a wgmma fragment then fall on distinct banks).
template <int BITS>
__host__ __device__ constexpr int code_stride64() {
  return ((2 * BITS + 3) / 4 * 4) % 8 == 0 ? (2 * BITS + 3) / 4 * 4 + 4 : (2 * BITS + 3) / 4 * 4;
}

// Codes 8j .. 8j+7 of a staged row of 64 (code c at bit c·BITS), in the low
// bits
template <int BITS>
__device__ __forceinline__ uint64_t code_window(const uint32_t* row, int j) {
  const int bit = 8 * j * BITS, w = bit >> 5, off = bit & 31;
  uint64_t v = row[w];
  if (off + 8 * BITS > 32) v |= (uint64_t)row[w + 1] << 32;
  return v >> off;
}

// Codes k0 .. k0+7 of a row (k0 a multiple of 8) straight from device
// memory: BITS bytes at byte k0·BITS/8, little-endian, code j in bits
// [j·BITS, (j+1)·BITS) of the result.
template <int BITS>
__device__ __forceinline__ uint64_t load_codes8(const uint8_t* row, int k0) {
  const uint8_t* p = row + (size_t)k0 * BITS / 8;
  if constexpr (BITS == 4) {
    return *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (BITS == 8) {
    return *reinterpret_cast<const uint64_t*>(p);
  } else if constexpr (BITS == 2) {
    return *reinterpret_cast<const uint16_t*>(p);
  } else {
    uint64_t w = 0;
#pragma unroll
    for (int i = 0; i < BITS; ++i) w |= (uint64_t)p[i] << (8 * i);
    return w;
  }
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
