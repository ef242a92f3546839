// The product core of the parameter-gradient kernels: one CTA's tile of
//
//   ∂L/∂Ŵ = gᵀ·x   (N, K), from g[M, N] and x[M, K] (bf16), summed over M
//
// kept in the f32 accumulators of two warpgroups and never written out.
// The kernel that includes it reduces the tile in its own epilogue
// (csrc/lords_grad.cu: the LoRDS ∂S and its rank contractions).
//
// What bounds it on an H100: 2·M·N·K operations on the bf16 tensor cores
// at the training step's shapes (M = 4096): far above the byte/FLOP ridge.
// The product has no dequantization inside its loop, so it is a plain bf16
// GEMM whose reduction axis, M, is the outer (strided) axis of both inputs.
//
// The design:
//  * A CTA owns a 128 x 256 (N, K) tile: two warpgroups of 64 N rows, each
//    a `wgmma` m64n256k16 accumulator (128 f32 registers a thread), and
//    walks M in steps of 64.  A 128 x 128 tile took 18% more time a layer
//    (PERF.md).
//  * Both operands are MN-major: gᵀ's 64 rows (n) and x's BK columns (k)
//    are each contiguous in memory, the depth M strided.  A TMA box of 64
//    columns x 64 rows under the 128-byte swizzle is exactly the MN-major
//    swizzle atom stacked along the depth, so the boxes go to `wgmma` as
//    they land: both operands from shared memory with the transpose flags
//    (hopper::wgmma_m64n256k16_tt, descriptors hopper::mn_desc).
//    A k16 slice of a step is 16 rows = 2048 bytes into every box; x's
//    boxes lie one box apart, the descriptor's leading byte offset.
//  * CTAs walk the tiles in bands of GROUP N tiles (tile_of): 8% less
//    time a layer than row order, 17% at down (PERF.md).
//  * g and x tiles arrive by TMA, issued by one thread, into a ring of
//    RING stages on mbarriers, RING - 1 steps ahead.  A step issues its
//    product, waits for the previous step's, and a barrier then frees that
//    slot for the load RING - 1 steps on: the tensor cores always hold one
//    step's product while the ring refills.  Rows past M read as zeros.
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace grad {

constexpr int BM = 64;        // tokens (the reduction) a step
constexpr int BN = 128;       // N rows of a CTA's tile (two warpgroups of 64)
constexpr int BK = 256;       // K columns of a CTA's tile
constexpr int THREADS = 256;
constexpr int RING = 4;       // stages of the g / x ring
constexpr int GROUP = 8;      // N tiles a band of CTAs walks K over
constexpr int BOX = 64 * BM * 2;  // one TMA box: 64 columns x 64 rows of bf16
constexpr int G_BOXES = BN / 64, X_BOXES = BK / 64;
constexpr int STAGE = (G_BOXES + X_BOXES) * BOX;
constexpr size_t RING_BYTES = (size_t)RING * STAGE;

// The (N, K) tile of this CTA on a grid of (K / BK, N / BN): in launch
// order the CTAs take bands of GROUP N tiles, K tiles outer, so that the
// CTAs on the card at once share a few g and x slices in L2 (one x slice
// per K tile at gate / up's 16, a band of 8 g and 16 x slices at down's
// 56 K tiles, where the plain order streams all of x for every 2.4 N tiles).
__device__ __forceinline__ void tile_of(int& nt, int& kt) {
  const int id = blockIdx.y * gridDim.x + blockIdx.x, band = GROUP * gridDim.x;
  const int first = id / band * GROUP, rows = min((int)gridDim.y - first, GROUP);
  nt = first + id % band % rows;
  kt = id % band / rows;
}

// The tile of CTA (n0, k0) into acc: acc[4j + e] is row 16·warp + g + 8·(e
// >> 1) of the 128 (g = lane / 4), column 8j + 2t + (e & 1) of the BK (t =
// lane % 4).  ring: RING_BYTES of shared memory at a 1024-aligned address;
// bars: RING mbarriers (8 bytes each), not yet initialised.  Ends with
// every product done and the ring free.
__device__ __forceinline__ void product(float (&acc)[BK / 2], const CUtensorMap* g_map,
                                        const CUtensorMap* x_map, unsigned char* ring,
                                        uint32_t bars, int M, int n0, int k0) {
  const int tid = threadIdx.x, wg = tid >> 7;
  const int steps = (M + BM - 1) / BM;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) acc[i] = 0.f;

  auto load = [&](int step) {
    const int slot = step % RING;
    const uint32_t bar = bars + 8 * slot, base = hopper::smem_u32(ring + (size_t)slot * STAGE);
    hopper::mbar_expect_tx(bar, STAGE);
#pragma unroll
    for (int b = 0; b < G_BOXES; ++b)
      hopper::tma_load_2d(base + b * BOX, g_map, bar, n0 + 64 * b, step * BM);
#pragma unroll
    for (int c = 0; c < X_BOXES; ++c)
      hopper::tma_load_2d(base + (G_BOXES + c) * BOX, x_map, bar, k0 + 64 * c, step * BM);
  };

  if (tid == 0) {
    for (int s = 0; s < RING; ++s) hopper::mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < RING - 1 && s < steps; ++s) load(s);

  for (int it = 0; it < steps; ++it) {
    const int slot = it % RING;
    hopper::mbar_wait(bars + 8 * slot, (it / RING) & 1);
    const uint32_t base = hopper::smem_u32(ring + (size_t)slot * STAGE);
    hopper::wgmma_fence();
#pragma unroll
    for (int s = 0; s < BM / 16; ++s) {
      const uint64_t da = hopper::mn_desc(base + wg * BOX + 2048 * s, BOX);
      const uint64_t db = hopper::mn_desc(base + G_BOXES * BOX + 2048 * s, BOX);
      hopper::wgmma_m64n256k16_tt(acc, da, db);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // the product of step it - 1 is done
    __syncthreads();          // in both warpgroups: its slot is free
    if (tid == 0 && it + RING - 1 < steps) load(it + RING - 1);
  }
  hopper::wgmma_wait<0>();
  __syncthreads();
}

// A tensor map of x (M, K) or g (M, N) for product(): boxes of 64 columns x
// BM rows; false if cuTensorMapEncodeTiled refuses it.
inline bool tile_map(CUtensorMap* map, const void* base, int rows, int cols) {
  return hopper::bf16_tile_map(map, base, rows, cols, BM);
}

}  // namespace grad
