// Block-scale gradient of a block-wise linear (PEQA-style PEFT, which
// trains s_blk only).
//
// Given the output gradient g[M, N] and the activations x[M, K] (both bf16),
//
//   ∂L/∂Ŵ = gᵀ·x   (N, K), accumulated tile by tile and never written out,
//   ∂s_blk[n, c] = Σ_{k in block c} ∂L/∂Ŵ[n, k] · lut[Q[n, k]]
//
// with no clamp mask: block scales are not clamped in the forward (this is
// not csrc/lords_grad.cu's ∂S, whose mask tests |B·A| ≥ eps).
//
// Replaces: src/repro/kernels/lords_grad.py::block_grad_pallas.  The TPU
// kernel keeps an output column resident while its K grid axis runs in
// order; CUDA CTAs over (N tile, K tile) run at once, in no order.  So each
// CTA writes its own per-tile partial sums: parts[slot, n, c] is the sum
// over the columns of block c that K tile kt holds, slot = kt − (the first
// K tile of block c).  A block spans several K tiles when bs > 256 (or
// straddles two when bs does not divide 256); the dispatch sums the slots.
// No atomics: the result is deterministic.
//
// What bounds it on an H100: the gᵀ·x product, 2·M·N·K operations on the
// bf16 tensor cores, at the training step's shapes (M = 4096); the
// epilogue is O(N·K) once per tile, not per M step.
//
// What the design does about it:
//  * The product is csrc/grad.cuh, shared with csrc/lords_grad.cu: a CTA
//    owns a 128 x 256 (N, K) tile of ∂L/∂Ŵ in the accumulators of two
//    warpgroups, `wgmma` m64n256k16 with both operands MN-major from shared
//    memory, g and x tiles by TMA into a four-stage mbarrier ring.  Any M:
//    the TMA reads rows past M as zeros, so the caller pads nothing in M.
//  * The epilogue stages the tile's codes over the spent ring and
//    multiplies each accumulator by lut[code] in registers, in the
//    accumulators' own layout.  Where a block is whole 8-column groups (bs
//    % 8 == 0) a thread sums its own pairs of each block in its two rows
//    and a quad shuffle over t finishes the row's block sum: nothing goes
//    back through shared memory.  Other block sizes stage the product tile
//    (128 x 256 f32) over the ring and reduce it a row per warp.
//
// Shapes: any M >= 1, N % 128 == 0, K % 256 == 0, K % bs == 0 (the
// dispatch layer pads N and K).

#include "grad.cuh"
#include "lords_common.cuh"

namespace {

using namespace hopper;

constexpr int BN = grad::BN, BK = grad::BK, THREADS = grad::THREADS;
constexpr int LDS = BK + 4;  // f32 row stride of the staged product tile
constexpr size_t kTileBytes = (size_t)BN * LDS * 4;

// Shared memory from a 1024-aligned base: the ring, then the LUT and the
// ring's mbarriers.  Over the spent ring: the staged tile (STAGED only)
// and then the tile's codes, chunk c of row n at (c·BN + n)·QW words.
template <int BITS, bool STAGED>
struct Plan {
  static constexpr int QW = lords::code_stride64<BITS>();
  static constexpr size_t codes = STAGED ? kTileBytes : 0;
  static constexpr size_t lut = grad::RING_BYTES;
  static constexpr size_t bars = lut + 256 * 4;
  static constexpr size_t total = bars + 8 * grad::RING + 1024;  // + slack to align to 1024
  static_assert(codes + (size_t)(BK / 64) * BN * QW * 4 <= grad::RING_BYTES,
                "the codes and the staged tile must fit over the ring");
};

// The K tile of block cb's first column: parts' slot of block cb is kt
// minus this.
__device__ __forceinline__ int first_tile(int cb, int bs) { return cb * bs / BK; }

template <int BITS, bool STAGED>
__global__ void __launch_bounds__(THREADS, 1)
block_grad_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap g_map, const uint8_t* __restrict__ q,
                  const float* __restrict__ lut, float* __restrict__ parts, int M, int N, int K,
                  int bs, int n_levels) {
  using P = Plan<BITS, STAGED>;
  constexpr int QW = P::QW;
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  float* lut_s = reinterpret_cast<float*>(smem + P::lut);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  int nt, kt;
  grad::tile_of(nt, kt);
  const int k0 = kt * BK, n0 = nt * BN, nblk = K / bs;
  const size_t row_bytes = (size_t)K * BITS / 8;
  for (int i = tid; i < 256; i += THREADS) lut_s[i] = i < n_levels ? lut[i] : 0.f;

  float acc[BK / 2];
  grad::product(acc, &g_map, &x_map, smem, smem_u32(smem + P::bars), M, n0, k0);
  // the ring's TMA writes and wgmma reads are done: generic writes follow
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  // the tile's codes over the spent ring
  const uint32_t* codes = reinterpret_cast<const uint32_t*>(smem + P::codes);
  {
    constexpr int CB = BITS == 3 ? 8 : 16, PER_ROW = 8 * BITS / CB;  // a chunk row: 8·BITS bytes
    const uint32_t qs = smem_u32(smem + P::codes);
    for (int i = tid; i < (BK / 64) * BN * PER_ROW; i += THREADS) {
      const int c = i / (BN * PER_ROW), row = i / PER_ROW % BN, part = i % PER_ROW;
      const uint8_t* src = q + (size_t)(n0 + row) * row_bytes + (size_t)(k0 + 64 * c) * BITS / 8 +
                           CB * part;
      const uint32_t dst = qs + (c * BN + row) * QW * 4 + CB * part;
      if constexpr (CB == 8) cp_async8(dst, src);
      else cp_async16(dst, src, 16);
    }
    cp_async_commit();
  }
  const int wrow = 16 * warp + g;  // acc[4j + e]: row wrow + 8·(e >> 1), column 8j + 2t + (e & 1)

  if constexpr (!STAGED) {
    cp_async_wait<0>();
    __syncthreads();
    // ∂L/∂Ŵ ⊙ lut[Q] in place
#pragma unroll
    for (int c = 0; c < BK / 64; ++c) {
      const uint32_t* q0 = codes + (c * BN + wrow) * QW;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows wrow, wrow + 8
          const uint64_t cw = lords::code_window<BITS>(q0 + 8 * h * QW, j) >> (2 * t * BITS);
#pragma unroll
          for (int e = 0; e < 2; ++e)
            acc[4 * (8 * c + j) + 2 * h + e] *= lut_s[(uint32_t)(cw >> (e * BITS)) & kMask];
        }
    }
    // Block sums: an 8-column group lies in one block (bs % 8 == 0), the
    // same for the whole warp, so a block's sum runs over consecutive
    // groups and its quad shuffle is uniform.
    auto flush = [&](int cb, float s0, float s1) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, o);
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      }
      if (t == 0) {
        float* dst = parts + ((size_t)(kt - first_tile(cb, bs)) * N + n0 + wrow) * nblk + cb;
        dst[0] = s0;
        dst[(size_t)8 * nblk] = s1;
      }
    };
    int cur = k0 / bs;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int cb = (k0 + 8 * j) / bs;
      if (cb != cur) {
        flush(cur, s0, s1);
        s0 = s1 = 0.f;
        cur = cb;
      }
      s0 += acc[4 * j] + acc[4 * j + 1];
      s1 += acc[4 * j + 2] + acc[4 * j + 3];
    }
    flush(cur, s0, s1);
  } else {
    // the product tile to shared memory (its rows of the ring are spent;
    // the codes lie past it)
    float* ds = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      float* row = ds + wrow * LDS + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(row) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(row + 8 * LDS) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
    cp_async_wait<0>();
    __syncthreads();
    // a warp per row, lane l holding columns l + 32c; each block column of
    // the tile is one fixed shuffle-tree reduction of the lanes' terms
    const int c_lo = k0 / bs, c_hi = (k0 + BK - 1) / bs;
    for (int n = warp; n < BN; n += THREADS / 32) {
      float v[BK / 32];
#pragma unroll
      for (int c = 0; c < BK / 32; ++c) {
        const int k = lane + 32 * c;
        const uint32_t* qrow = codes + ((k >> 6) * BN + n) * QW;
        v[c] = ds[n * LDS + k] * lut_s[lords::unpack_code<BITS>(qrow, k & 63)];
      }
      for (int cb = c_lo; cb <= c_hi; ++cb) {
        const int kb = cb * bs - k0, ke = kb + bs;  // block columns, tile-relative
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < BK / 32; ++c) {
          const int k = lane + 32 * c;
          if (k >= kb && k < ke) s += v[c];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) parts[((size_t)(kt - first_tile(cb, bs)) * N + n0 + n) * nblk + cb] = s;
      }
    }
  }
}

template <int BITS, bool STAGED>
cudaError_t run(const CUtensorMap& xm, const CUtensorMap& gm, const void* q, const void* lut,
                void* parts, int M, int N, int K, int bs, int n_levels, cudaStream_t stream) {
  constexpr size_t smem = Plan<BITS, STAGED>::total;
  cudaError_t err = lords::allow_smem(block_grad_kernel<BITS, STAGED>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(K / BK, N / BN);
  block_grad_kernel<BITS, STAGED><<<grid, THREADS, smem, stream>>>(
      xm, gm, static_cast<const uint8_t*>(q), static_cast<const float*>(lut),
      static_cast<float*>(parts), M, N, K, bs, n_levels);
  return cudaGetLastError();
}

template <int BITS>
int launch(const CUtensorMap& xm, const CUtensorMap& gm, const void* q, const void* lut,
           void* parts, int M, int N, int K, int bs, int n_levels, cudaStream_t stream) {
  if (bs % 8 == 0) return run<BITS, false>(xm, gm, q, lut, parts, M, N, K, bs, n_levels, stream);
  return run<BITS, true>(xm, gm, q, lut, parts, M, N, K, bs, n_levels, stream);
}

}  // namespace

// x (M, K), g (M, N) bf16; q (N, K·bits/8) u8; lut f32; parts (slots, N,
// K / bs) f32, zeroed by the caller, slots >= the most K tiles of 256 one
// block touches.
extern "C" int block_grad_launch(const void* x, const void* g, const void* q, const void* lut,
                                 void* parts, int M, int N, int K, int bs, int bits,
                                 int n_levels, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < BN || N % BN || K < BK || K % BK || bs <= 0 || K % bs)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xm, gm;
  if (!grad::tile_map(&xm, x, M, K) || !grad::tile_map(&gm, g, M, N))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bits) {
    case 2: return launch<2>(xm, gm, q, lut, parts, M, N, K, bs, n_levels, st);
    case 3: return launch<3>(xm, gm, q, lut, parts, M, N, K, bs, n_levels, st);
    case 4: return launch<4>(xm, gm, q, lut, parts, M, N, K, bs, n_levels, st);
    case 8: return launch<8>(xm, gm, q, lut, parts, M, N, K, bs, n_levels, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
