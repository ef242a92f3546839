// Flash-2 causal prefill attention, GQA in the model's native layout.
//
//   O = softmax(mask(Q·Kᵀ·scale)) · V      per (batch, head), f32 out
//
// Replaces: src/repro/kernels/attn_prefill.py::attn_prefill_pallas.
//
// Semantics carried over exactly: q (b, s, nh, hd), k (b, S, nkv, hd) and
// v (b, S, nkv, hd_v) bf16 stay in their stored layout (hd_v is the value
// head dim, as the TPU kernel's hdv = v.shape[-1]: MLA attends with
// hd 96 = nope 64 + rope 32 and hd_v 64); query head h reads KV head h / g (no
// expansion of K/V in memory); query i attends key j when
// 0 <= kpos[j] <= qpos[i] (-1 marks a dead row or column); the mask value is
// the finite -1e30; p is zeroed through the liveness mask; the 1/l
// normalization happens once at the end and rows with l == 0 are zero.
//
// What bounds it on an H100: at the main path's shapes (window 544 or a
// 512-query chunk, hd 128) the function's least time is its bytes (q, k,
// v, out); its products, on the tensor cores, are a few GFLOP.  With
// `mma.sync` every warp reads the whole K and V tile from shared memory
// (ldmatrix), so shared-memory bandwidth and the per-tile softmax bound
// this kernel before either.
//
// What the design does about it:
//  * A CTA of four warps owns 64 query rows of one KV head, the rows being
//    (position, head) pairs of that head's g query heads taken in storage
//    order, so each K/V tile is staged once for all g heads that read it,
//    for any g.
//  * The CTA first marks, in a bit mask in shared memory, the KV tiles that
//    hold a key inside [0, max qpos of its rows]; the others are skipped
//    outright — exact, since such a tile leaves m, l and acc as they were —
//    which drops the causal upper triangle, the dead window tail and a
//    chunk's dead prefix pages (kpos need not be monotonic).
//  * Live K/V tiles (and their kpos) arrive through a two-stage `cp.async`
//    ring: the next live tile loads while this one is used.
//  * Q·Kᵀ is `mma.sync` m16n8k16 in bf16 with f32 accumulators (products of
//    bf16 values are exact in f32); the scale is applied in f32.
//  * The softmax stays in f32 registers: running max and sum per row, quad
//    shuffles, exp as 2^x on the MUFU unit (2 ulp), one 1/l at the end.
//  * P·V is `mma.sync` too, with P at f32 accuracy: P = P_hi + P_lo, both
//    bf16, two products into the same f32 accumulators (rounding P alone to
//    bf16 errs by up to 2^-9 relative, 30x the 1e-4 bound on rows with one
//    or two live keys).  The m16n8 accumulator of S is laid out like the A
//    fragment of the next product, so P never leaves registers.
//
// Shapes: s % 64 == 0, S % 64 == 0 (the dispatch layer pads with -1
// positions); (hd, hd_v) in {(16, 16), (32, 32), (64, 64), (112, 112),
// (128, 128), (96, 64)}.  hd 112 (kimi-k2) is 7 k16 steps of Q·Kᵀ and 7
// n16 steps of P·V; nothing here takes hd to be a power of two: the
// cp.async loops divide by hd / 8 (14), and the 240-byte row stride still
// puts ldmatrix's eight rows on distinct bank groups.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 64, BKV = 64, THREADS = 128;
constexpr float kNegInf = -1e30f;

template <int HD, int HDV>
struct Smem {
  static constexpr int QS = HD + 8;   // bf16 row strides: 16 bytes of pad keep
  static constexpr int KS = HD + 8;   // ldmatrix's eight row addresses on
  static constexpr int VS = HDV + 8;  // distinct bank groups
  static constexpr size_t q = 0;
  static constexpr size_t k = q + 2 * BQ * QS;                    // two stages each
  static constexpr size_t v = k + 2 * 2 * BKV * KS;
  static constexpr size_t kpos = v + 2 * 2 * BKV * VS;
  static constexpr size_t qmax = kpos + 2 * 4 * BKV;
  static constexpr size_t total = qmax + 16;
};

template <int HD, int HDV>
__global__ void __launch_bounds__(THREADS)
attn_prefill_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const int* __restrict__ qpos,
                    const int* __restrict__ kpos, float* __restrict__ out, float scale,
                    int s, int S, int nh, int nkv) {
  using L = Smem<HD, HDV>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q);
  int* qmax_s = reinterpret_cast<int*>(smem + L::qmax);
  uint32_t* live_s = reinterpret_cast<uint32_t*>(smem + L::total);  // a bit per KV tile

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int G = nh / nkv, hk = blockIdx.y, bi = blockIdx.z;
  const int row0 = blockIdx.x * BQ;  // first (position, head) row of the CTA
  const int ntiles = S / BKV, nwords = (ntiles + 31) / 32;

  // Q tile: row ρ is position ρ / G, head hk·G + ρ % G
  for (int i = tid; i < BQ * HD / 8; i += THREADS) {
    const int row = i / (HD / 8), c = (i % (HD / 8)) * 8;
    const int rho = row0 + row, pi = rho / G, hj = rho % G;
    cp_async16(smem_u32(qs + row * L::QS + c),
               q + (((size_t)bi * s + pi) * nh + hk * G + hj) * HD + c, 16);
  }
  cp_async_commit();

  // this thread's rows: ρ0 (fragment row g) and ρ1 = ρ0 + 8
  const int rho0 = row0 + 16 * warp + g, rho1 = rho0 + 8;
  const int qp0 = qpos[(size_t)bi * s + rho0 / G], qp1 = qpos[(size_t)bi * s + rho1 / G];
  int mx = max(qp0, qp1);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (tid == 0) *qmax_s = -1;
  for (int i = tid; i < nwords; i += THREADS) live_s[i] = 0u;
  __syncthreads();
  if (lane == 0) atomicMax(qmax_s, mx);
  __syncthreads();
  const int qmax = *qmax_s;

  // the live KV tiles: those holding a key in [0, qmax] (a warp's 32 keys
  // lie in one tile)
  const int* kp_row = kpos + (size_t)bi * S;
  for (int i = tid; i < S; i += THREADS) {
    const int kp = kp_row[i];
    if (__any_sync(0xffffffffu, kp >= 0 && kp <= qmax) && lane == 0)
      atomicOr(live_s + (i >> 11), 1u << ((i >> 6) & 31));
  }
  __syncthreads();
  auto next_live = [&](int from) {  // first live tile >= from, or ntiles
    if (from >= ntiles) return ntiles;
    int w = from >> 5;
    uint32_t bits = live_s[w] & (~0u << (from & 31));
    while (!bits && ++w < nwords) bits = live_s[w];
    return bits ? 32 * w + __ffs(bits) - 1 : ntiles;
  };
  auto load_tile = [&](int tl, int slot) {
    const int kv0 = tl * BKV;
    __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem + L::k) + slot * BKV * L::KS;
    __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(smem + L::v) + slot * BKV * L::VS;
    for (int i = tid; i < BKV * HD / 8; i += THREADS) {
      const int row = i / (HD / 8), c = (i % (HD / 8)) * 8;
      cp_async16(smem_u32(ks + row * L::KS + c),
                 k + (((size_t)bi * S + kv0 + row) * nkv + hk) * HD + c, 16);
    }
    for (int i = tid; i < BKV * HDV / 8; i += THREADS) {
      const int row = i / (HDV / 8), c = (i % (HDV / 8)) * 8;
      cp_async16(smem_u32(vs + row * L::VS + c),
                 v + (((size_t)bi * S + kv0 + row) * nkv + hk) * HDV + c, 16);
    }
    if (tid < BKV / 4)
      cp_async16(smem_u32(reinterpret_cast<int*>(smem + L::kpos) + slot * BKV + 4 * tid),
                 kp_row + kv0 + 4 * tid, 16);
  };

  int cur = next_live(0);
  if (cur < ntiles) load_tile(cur, 0);
  cp_async_commit();
  int nxt = next_live(cur + 1);
  if (nxt < ntiles) load_tile(nxt, 1);
  cp_async_commit();

  // Q fragments stay in registers for the whole KV loop
  cp_async_wait<2>();
  __syncthreads();
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int row = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
    ldmatrix_x4(qf[kk], smem_u32(qs + row * L::QS + 16 * kk + (lane >> 4) * 8));
  }

  float o[HDV / 8][4];
#pragma unroll
  for (int n = 0; n < HDV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // running max (in log2 units) and per-thread partial sums of rows ρ0, ρ1
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const float scale2 = scale * 1.4426950408889634f;  // exp(x) = 2^(x·log2 e)

  int slot = 0;
  while (cur < ntiles) {
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* ks =
        reinterpret_cast<const __nv_bfloat16*>(smem + L::k) + slot * BKV * L::KS;
    const __nv_bfloat16* vs =
        reinterpret_cast<const __nv_bfloat16*>(smem + L::v) + slot * BKV * L::VS;
    const int* kps = reinterpret_cast<const int*>(smem + L::kpos) + slot * BKV;

    // scores: 16 rows x 64 keys per warp
    float sc[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int jp = 0; jp < BKV / 16; ++jp) {
        uint32_t bfr[4];
        const int key = 16 * jp + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(bfr, smem_u32(ks + key * L::KS + 16 * kk + ((lane >> 3) & 1) * 8));
        mma_bf16(sc[2 * jp], qf[kk], bfr[0], bfr[1]);
        mma_bf16(sc[2 * jp + 1], qf[kk], bfr[2], bfr[3]);
      }

    // liveness of the 16 (row, key) pairs of each row, bit 2j + e
    uint32_t live0 = 0, live1 = 0;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      const int2 kp = *reinterpret_cast<const int2*>(kps + 8 * j + 2 * t);
      live0 |= (uint32_t)(kp.x >= 0 && kp.x <= qp0) << (2 * j);
      live0 |= (uint32_t)(kp.y >= 0 && kp.y <= qp0) << (2 * j + 1);
      live1 |= (uint32_t)(kp.x >= 0 && kp.x <= qp1) << (2 * j);
      live1 |= (uint32_t)(kp.y >= 0 && kp.y <= qp1) << (2 * j + 1);
    }
    // scaled scores (log2 units), the running max over live pairs
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[j][e] = (live0 >> (2 * j + e)) & 1u ? sc[j][e] * scale2 : kNegInf;
        sc[j][2 + e] = (live1 >> (2 * j + e)) & 1u ? sc[j][2 + e] * scale2 : kNegInf;
        mx0 = fmaxf(mx0, sc[j][e]);
        mx1 = fmaxf(mx1, sc[j][2 + e]);
      }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2_approx(m0 - mn0), al1 = exp2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[j][e] = (live0 >> (2 * j + e)) & 1u ? exp2_approx(sc[j][e] - mn0) : 0.f;
        sc[j][2 + e] = (live1 >> (2 * j + e)) & 1u ? exp2_approx(sc[j][2 + e] - mn1) : 0.f;
        sum0 += sc[j][e];
        sum1 += sc[j][2 + e];
      }
    l0 = al0 * l0 + sum0;  // per-thread partial sums; the quad adds them at the end
    l1 = al1 * l1 + sum1;
#pragma unroll
    for (int n = 0; n < HDV / 8; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }

    // o += (P_hi + P_lo) · V
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
      split_bf16(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
      split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int np = 0; np < HDV / 16; ++np) {
        uint32_t bfr[4];
        const int key = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(bfr, smem_u32(vs + key * L::VS + 16 * np + (lane >> 4) * 8));
        mma_bf16(o[2 * np], pl, bfr[0], bfr[1]);
        mma_bf16(o[2 * np + 1], pl, bfr[2], bfr[3]);
        mma_bf16(o[2 * np], ph, bfr[0], bfr[1]);
        mma_bf16(o[2 * np + 1], ph, bfr[2], bfr[3]);
      }
    }

    __syncthreads();  // the slot is refilled below
    cur = nxt;
    nxt = next_live(cur + 1);
    if (nxt < ntiles) load_tile(nxt, slot);
    cp_async_commit();
    slot ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
  }
  const float inv0 = l0 == 0.f ? 0.f : 1.f / l0, inv1 = l1 == 0.f ? 0.f : 1.f / l1;
  float* out0 = out + (((size_t)bi * s + rho0 / G) * nh + hk * G + rho0 % G) * HDV + 2 * t;
  float* out1 = out + (((size_t)bi * s + rho1 / G) * nh + hk * G + rho1 % G) * HDV + 2 * t;
#pragma unroll
  for (int n = 0; n < HDV / 8; ++n) {
    *reinterpret_cast<float2*>(out0 + 8 * n) = make_float2(o[n][0] * inv0, o[n][1] * inv0);
    *reinterpret_cast<float2*>(out1 + 8 * n) = make_float2(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int HD, int HDV>
int launch(const void* q, const void* k, const void* v, const void* qpos, const void* kpos,
           void* out, float scale, int b, int s, int S, int nh, int nkv,
           cudaStream_t stream) {
  const size_t smem = Smem<HD, HDV>::total + 4 * (size_t)((S / BKV + 31) / 32);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(attn_prefill_kernel<HD, HDV>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(s * (nh / nkv) / BQ, nkv, b);
  attn_prefill_kernel<HD, HDV><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kpos), static_cast<float*>(out), scale, s, S, nh, nkv);
  return cudaGetLastError();
}

}  // namespace

// q (b, s, nh, hd), k (b, S, nkv, hd), v (b, S, nkv, hd_v) bf16; qpos
// (b, s), kpos (b, S) int32; out (b, s, nh, hd_v) f32.
extern "C" int attn_prefill_launch(const void* q, const void* k, const void* v,
                                   const void* qpos, const void* kpos, void* out, float scale,
                                   int b, int s, int S, int nh, int nkv, int hd, int hd_v,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PAIR(HD, HDV)                                                                   \
  if (hd == HD && hd_v == HDV)                                                          \
    return launch<HD, HDV>(q, k, v, qpos, kpos, out, scale, b, s, S, nh, nkv, st);
  PAIR(16, 16)
  PAIR(32, 32)
  PAIR(64, 64)
  PAIR(112, 112)
  PAIR(128, 128)
  PAIR(96, 64)
#undef PAIR
  return static_cast<int>(cudaErrorInvalidValue);
}
