// Absorbed-latent MLA decode over a bf16 or int8 latent cache, contiguous
// or paged.
//
//   s[h, j]   = ((q_lat[h]·c_j)·c_scale_j + q_rope[h]·k_rope_j)·scale
//   out[h, :] = Σ_j softmax_j(s[h, :]) · c_j·c_scale_j
//
// Replaces: src/repro/kernels/attn_decode.py::attn_decode_mla_pallas (body
// _mla_kernel) through attn_decode_mla_launch, and
// src/repro/kernels/attn_decode.py::attn_decode_mla_paged_pallas through
// attn_decode_mla_paged_launch.  As on the TPU, where the paged kernel
// reuses _mla_kernel with other index maps, both entry points run one body;
// only the slot -> cache row map differs (struct Contig / struct Paged, as
// in attn_decode.cu).
//
// Semantics carried over exactly: q_lat (b, nh, L) f32 and q_rope
// (b, nh, R) bf16 against the latent cache c (rows, L) and the shared RoPE
// key cache k_rope (rows, R) bf16, read in their stored layout; for an int8
// cache the latent score is (q_lat·codes_j)·c_scale_j and the value row is
// codes_j·c_scale_j (the scale is folded into the probability, the same
// product); slot j is live when j <= pos[b] and dead slots never
// contribute; the flash-2 online softmax (running m, l, acc with the alpha
// correction); 1/l once at the end, l == 0 giving 1.  The output is the
// weighted latent: the v_up absorption stays outside, as on the TPU.  Slots
// past pos[b] are never read, so the paged entry reads no page past
// pos[b] / ps and never the dummy page of an unmapped entry.  There is no
// scalar prefetch: each CTA reads its own page-table entries.  pos[b] must
// be >= 0.
//
// What bounds it on an H100: the live cache is read once — per batch row
// (pos+1)·(L + R)·2 bytes at bf16, (pos+1)·(L + 4 + 2R) at int8 — for
// 2·(2L + R) operations per (head, slot).  All nh heads read each latent
// row (multi-query attention), ~60 operations a byte at nh = 40: far below
// the tensor cores' ridge, so bytes bound it, and at minicpm3's shapes
// (about 1.2 MB) in well under a microsecond: launch latency and the CTAs'
// serial chain of loads set the floor.
//
// What the design does about it:
//  * Split-KV: the grid is (slot chunks, groups of HEADS = 8 heads, b).  A
//    CTA takes one chunk (whole TILE-slot tiles; whole pages on the paged
//    entry) of one batch row for 8 heads, rows 0-7 of the m16 products
//    (rows 8-15 zero: with 16 heads a CTA the partials to merge were twice
//    as large and the CTAs fewer, and the engine's shape ran 11% slower;
//    PERF.md §6).  The wrapper picks the chunk from attn_decode.split_plan,
//    so the CTAs fill the card.  A chunk past pos[b] returns at once.  Each
//    CTA writes its partial (m, l, acc) to a workspace and takes a ticket;
//    the last CTA of a (batch row, head group) merges the partials by
//    log-sum-exp in chunk order (bitwise deterministic: each head's max and
//    sum in one round of loads, then every output) and resets the ticket.
//    A row with one chunk writes its output directly.
//  * Tiles of c and k_rope arrive in 16-byte `cp.async` copies through a
//    two-stage ring, in their stored type; one tile feeds both products.
//    Row strides are 16 bytes past a multiple of 32 words, so the eight
//    rows of an `ldmatrix` (scores, bf16), the eight rows of the int8
//    score reads and the four rows of a P·c fragment read all fall on
//    distinct banks.
//  * Scores on tensor cores, `mma.sync` m16n8k16 bf16 with f32 sums: warp w
//    takes slots 8w .. 8w + 7 of a tile for the CTA's heads.  q_lat is f32 and
//    not bf16-exact, so the CTA splits it once into three bf16 parts whose
//    sum is its f32 value (A fragments in shared memory) and the latent
//    score is three passes: with two (16 bits of q_lat) the logits at 30x
//    the model's scale missed the 1e-4 bound (4.2e-4 in a numpy model of
//    the rounding).  q_rope·k_rope is one pass.  int8 codes widen to bf16
//    in registers, exactly; c_scale_j multiplies the latent score after the
//    product.
//  * The warps share the tile's row max through shared memory, so all four
//    keep one running max; each writes its slots' P·c_scale (split in bf16
//    hi / lo parts, f32 accuracy) as A fragments, and then warp w computes
//    P·c for latent columns 64w .. 64w + 63 over the whole tile: its
//    accumulator is 16 x 64 (32 registers a thread), never merged across
//    warps.  Its value columns are permuted (thread g of a quad reads 8
//    consecutive columns of a row, one vector read per fragment row).
//
// Shapes: (L, R) = (256, 32) (minicpm3-4b); any nh; contiguous: any S;
// paged: any ps; chunk a multiple of TILE (and of ps on the paged entry).
// Launches on one stream run one after another; two launches at once on
// two streams would share the tickets.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TILE = 32;  // slots of a ring stage: 8 a warp in the scores
constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int ROWS = 16;   // rows of the products (m16): the CTA's heads, then zeros
constexpr int HEADS = 8;   // heads of a CTA (PERF.md §6: 8 against 16)
constexpr int MERGE = 32;  // chunks whose merge weights are staged at once
constexpr int PARTS = 3;   // bf16 parts of q_lat: hi + mid + lo is the f32 value
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Shared memory of one CTA: two ring stages of a tile (c rows, k_rope rows,
// c scales), the A fragments of q_lat's PARTS bf16 parts and of q_rope
// ([k16 step][lane], 16 bytes each), P's fragments ([n8 tile][lane]), the
// warps' row maxima and sums, the merge weights, the ticket flag.
template <int L, int R, typename T>
struct Smem {
  static constexpr int E = sizeof(T);
  // 16 bytes past a multiple of 32 words: (stride / 16) odd
  static constexpr int CS = L * E + 16, RS = R * 2 + 16;
  static_assert((CS / 16) % 2 == 1 && (RS / 16) % 2 == 1, "row strides");
  static constexpr size_t c = 0, kr = c + (size_t)TILE * CS, cs = kr + (size_t)TILE * RS,
                          stage = (cs + 4 * TILE + 127) / 128 * 128;
  static constexpr size_t q = 2 * stage, qr = q + (size_t)PARTS * L / 16 * 512,
                          p = qr + (size_t)R / 16 * 512,
                          red = p + (size_t)TILE / 8 * 512,  // [2][WARPS][ROWS] f32
                          wt = red + 2 * WARPS * ROWS * 4,   // [MERGE][HEADS] f32
                          flag = wt + MERGE * HEADS * 4, total = flag + 16;
};

// slot j of batch row bi -> row of the (rows, L) / (rows, R) cache view
struct Contig {
  int S;
  __device__ size_t row(int bi, int j) const { return (size_t)bi * S + j; }
};

struct Paged {
  const int* pt;
  int npages, ps;
  __device__ size_t row(int bi, int j) const {
    return (size_t)pt[(size_t)bi * npages + j / ps] * ps + j % ps;
  }
};

// (m, l) += (m2, l2): the larger max, each sum rescaled to it
__device__ __forceinline__ void merge_stat(float& m, float& l, float m2, float l2) {
  const float n = fmaxf(m, m2);
  if (n == neg_inf()) return;  // both empty
  l = l * exp2_approx(m - n) + l2 * exp2_approx(m2 - n);
  m = n;
}

__device__ __forceinline__ void frag(uint32_t (&a)[4], const uint4& v) {
  a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
}

// int8 code i of a row's words
__device__ __forceinline__ float code(const uint32_t* w, int i) {
  return (float)(int8_t)(w[i >> 2] >> (8 * (i & 3)));
}

// element i of two rows' words as a bf16 pair (row a low, row b high)
template <typename T>
__device__ __forceinline__ uint32_t pair(const uint32_t* a, const uint32_t* b, int i) {
  if constexpr (sizeof(T) == 2)
    return __byte_perm(a[i >> 1], b[i >> 1], (i & 1) ? 0x7632 : 0x5410);
  else
    return pack_bf16(code(a, i), code(b, i));
}

// c_scale (rows,) f32 for an int8 cache, else nullptr.  ws: per (unit,
// chunk) HEADS rows of m, HEADS of l, HEADS x L of acc, where unit =
// bi·groups + group; tickets: one zero int per unit.
template <int L, int R, typename T, typename Addr>
__global__ void __launch_bounds__(THREADS, 3)
attn_decode_mla_kernel(const float* __restrict__ q_lat, const __nv_bfloat16* __restrict__ q_rope,
                       const T* __restrict__ c, const __nv_bfloat16* __restrict__ k_rope,
                       const float* __restrict__ c_scale, const int* __restrict__ pos,
                       float* __restrict__ out, float* __restrict__ ws,
                       int* __restrict__ tickets, float scale, Addr addr, int cap, int nh,
                       int chunk) {
  using S = Smem<L, R, T>;
  constexpr int E = sizeof(T), REC = HEADS * (L + 2);
  constexpr int VC = L / WARPS;  // value columns of a warp in P·c
  constexpr bool kInt8 = E == 1;
  static_assert(L % 64 == 0 && R % 32 == 0 && VC % 64 == 0, "latent dims");
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int ci = blockIdx.x, hg = blockIdx.y, bi = blockIdx.z;
  // slots at or past `limit` are dead and never read
  const int limit = min(cap, pos[bi] + 1);
  const int nlive = (limit + chunk - 1) / chunk;  // chunks holding a slot below limit
  if (ci >= nlive) return;
  const int s_begin = ci * chunk, s_end = min(limit, s_begin + chunk);
  const int rows = min(HEADS, nh - HEADS * hg);
  const size_t unit = (size_t)bi * gridDim.y + hg;
  const size_t h0 = (size_t)bi * nh + HEADS * hg;  // the group's first (batch, head) row
  const float mul = scale * kLog2e;

  auto load_tile = [&](int s0, int stage) {
    unsigned char* base = smem + stage * S::stage;
    constexpr int CP = L * E / 16, RP = R * 2 / 16;  // 16-byte copies a row
    for (int i = tid; i < TILE * (CP + RP); i += THREADS) {
      const int r = i / (CP + RP), piece = i % (CP + RP), j = s0 + r;
      const bool live = j < s_end;
      const size_t row = live ? addr.row(bi, j) : 0;
      if (piece < CP)
        cp_async16(smem_u32(base + S::c + r * S::CS + 16 * piece),
                   reinterpret_cast<const unsigned char*>(c) + row * L * E + 16 * piece,
                   live ? 16 : 0);
      else
        cp_async16(smem_u32(base + S::kr + r * S::RS + 16 * (piece - CP)),
                   reinterpret_cast<const unsigned char*>(k_rope) + row * R * 2 +
                       16 * (piece - CP),
                   live ? 16 : 0);
    }
    if (kInt8 && tid < TILE) {
      const int j = s0 + tid;
      const bool live = j < s_end;
      cp_async4(smem_u32(base + S::cs + 4 * tid), c_scale + (live ? addr.row(bi, j) : 0),
                live ? 4 : 0);
    }
  };

  const int ntiles = (s_end - s_begin + TILE - 1) / TILE;
  load_tile(s_begin, 0);
  cp_async_commit();

  // A fragments of the group's heads, [k16 step][lane]: rows gq, gq + 8 (zero
  // past nh), columns 16s + 2t, + 1 and 16s + 2t + 8, + 9 (registers a0-a3);
  // q_lat as PARTS bf16 parts, [part][k16 step][lane]
  uint4* qp = reinterpret_cast<uint4*>(smem + S::q);
  uint4* qr = reinterpret_cast<uint4*>(smem + S::qr);
  for (int i = tid; i < L / 16 * 32; i += THREADS) {
    const int s = i >> 5, g = (i & 31) >> 2, tt = i & 3;
    uint32_t w[PARTS][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e & 1), col = 16 * s + 2 * tt + 8 * (e >> 1);
      float2 v = r < rows ? *reinterpret_cast<const float2*>(q_lat + (h0 + r) * L + col)
                          : make_float2(0.f, 0.f);
#pragma unroll
      for (int k = 0; k < PARTS; ++k) {  // each part the rest's bf16 rounding
        const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
        w[k][e] = *reinterpret_cast<const uint32_t*>(&h);
        v.x -= __low2float(h);
        v.y -= __high2float(h);
      }
    }
#pragma unroll
    for (int k = 0; k < PARTS; ++k)
      qp[k * (L / 16 * 32) + i] = make_uint4(w[k][0], w[k][1], w[k][2], w[k][3]);
  }
  for (int i = tid; i < R / 16 * 32; i += THREADS) {
    const int s = i >> 5, g = (i & 31) >> 2, tt = i & 3;
    uint32_t a[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e & 1), col = 16 * s + 2 * tt + 8 * (e >> 1);
      a[e] = r < rows ? *reinterpret_cast<const uint32_t*>(q_rope + (h0 + r) * R + col) : 0u;
    }
    qr[i] = make_uint4(a[0], a[1], a[2], a[3]);
  }

  uint4* pf = reinterpret_cast<uint4*>(smem + S::p);  // [TILE / 8][32]: P hi and lo
  float* red = reinterpret_cast<float*>(smem + S::red);  // [WARPS][ROWS] maxima, then sums
  // acc[c][e]: head gq + 8·(e >> 1), latent column VC·warp + 8·(2t + (e & 1)) + c
  float acc[VC / 8][4];
#pragma unroll
  for (int n = 0; n < VC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // running max (log2 units, the same in every warp) and per-thread partial
  // sums of heads gq, gq + 8 over this warp's slots
  float m0 = neg_inf(), m1 = neg_inf(), l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // the tile (and q) landed; the previous tile is consumed
    const int s0 = s_begin + it * TILE;
    if (it + 1 < ntiles) load_tile(s0 + TILE, (it + 1) & 1);
    cp_async_commit();
    const unsigned char* base = smem + (it & 1) * S::stage;

    // scores of slots 8·warp + (0..7) for the 16 heads: the latent's hi
    // pass and its mid and lo passes in two accumulators each (even and odd
    // k16 steps), RoPE in two
    float sc[6][4] = {};
    auto latent = [&](int s, uint32_t b0, uint32_t b1) {
#pragma unroll
      for (int k = 0; k < PARTS; ++k) {
        uint32_t a[4];
        frag(a, qp[(k * (L / 16) + s) * 32 + lane]);
        mma_bf16(sc[(k ? 2 : 0) + (s & 1)], a, b0, b1);
      }
    };
    if constexpr (!kInt8) {
      const uint32_t a0 =
          smem_u32(base + S::c + (8 * warp + (lane & 7)) * S::CS + 16 * (lane >> 3));
#pragma unroll
      for (int s = 0; s < L / 16; s += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, a0 + 32 * s);  // k16 steps s and s + 1
        latent(s, b[0], b[1]);
        latent(s + 1, b[2], b[3]);
      }
    } else {
      const unsigned char* crow = base + S::c + (8 * warp + gq) * S::CS + 2 * t;
#pragma unroll
      for (int s = 0; s < L / 16; ++s) {
        const uint32_t w0 = *reinterpret_cast<const uint16_t*>(crow + 16 * s);
        const uint32_t w1 = *reinterpret_cast<const uint16_t*>(crow + 16 * s + 8);
        latent(s, pack_bf16(code(&w0, 0), code(&w0, 1)), pack_bf16(code(&w1, 0), code(&w1, 1)));
      }
    }
    {
      const uint32_t a0 =
          smem_u32(base + S::kr + (8 * warp + (lane & 7)) * S::RS + 16 * (lane >> 3));
#pragma unroll
      for (int s = 0; s < R / 16; s += 2) {
        uint32_t b[4], a[4];
        ldmatrix_x4(b, a0 + 32 * s);
        frag(a, qr[s * 32 + lane]);
        mma_bf16(sc[4], a, b[0], b[1]);
        frag(a, qr[(s + 1) * 32 + lane]);
        mma_bf16(sc[5], a, b[2], b[3]);
      }
    }
    // column e of the n8 tile is slot 8·warp + 2t + (e & 1), head gq + 8·(e >> 1)
    const float* cs = reinterpret_cast<const float*>(base + S::cs);
    float sv[4], mx0, mx1;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 8 * warp + 2 * t + (e & 1);
      const float lat = (sc[0][e] + sc[1][e]) + (sc[2][e] + sc[3][e]);
      const float rope = sc[4][e] + sc[5][e];
      const float dot = kInt8 ? fmaf(lat, cs[r], rope) : lat + rope;
      sv[e] = s0 + r < s_end ? dot * mul : neg_inf();
    }
    mx0 = fmaxf(sv[0], sv[1]);
    mx1 = fmaxf(sv[2], sv[3]);
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
    }
    if (t == 0) red[warp * ROWS + gq] = mx0, red[warp * ROWS + gq + 8] = mx1;
    __syncthreads();  // the warps' maxima
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      mx0 = fmaxf(mx0, red[w * ROWS + gq]);
      mx1 = fmaxf(mx1, red[w * ROWS + gq + 8]);
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a head with no live slot yet keeps m = -inf: subtract 0 there
    const float c0 = mn0 == neg_inf() ? 0.f : mn0, c1 = mn1 == neg_inf() ? 0.f : mn1;
    const float al0 = exp2_approx(m0 - c0), al1 = exp2_approx(m1 - c1);
    m0 = mn0;
    m1 = mn1;
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = exp2_approx(sv[e] - (e < 2 ? c0 : c1));
    l0 = al0 * l0 + (p[0] + p[1]);
    l1 = al1 * l1 + (p[2] + p[3]);
    if constexpr (kInt8) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] *= cs[8 * warp + 2 * t + (e & 1)];  // the value row's scale
    }
    uint4 pv;
    split_bf16(p[0], p[1], pv.x, pv.z);
    split_bf16(p[2], p[3], pv.y, pv.w);
    pf[warp * 32 + lane] = pv;  // {hi gq, hi gq + 8, lo gq, lo gq + 8}
#pragma unroll
    for (int n = 0; n < VC / 8; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }
    __syncthreads();  // P of the whole tile

    // acc += (P_hi + P_lo) · c over the tile's slots, k16 step ks = slots
    // 16ks .. 16ks + 15 (the n8 tiles of warps 2ks, 2ks + 1); thread (gq, t)
    // reads latent columns VC·warp + 8gq .. + 7 of slots 2t, 2t + 1, 2t + 8,
    // 2t + 9
#pragma unroll
    for (int ks = 0; ks < TILE / 16; ++ks) {
      const uint4 pa = pf[2 * ks * 32 + lane], pb = pf[(2 * ks + 1) * 32 + lane];
      const uint32_t ah[4] = {pa.x, pa.y, pb.x, pb.y}, alo[4] = {pa.z, pa.w, pb.z, pb.w};
      constexpr int NW = 8 * E / 4;  // words of a thread's 8 columns
      uint32_t vr[4][NW];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * ks + 2 * t + (i & 1) + 8 * (i >> 1);
        const unsigned char* src = base + S::c + r * S::CS + (VC * warp + 8 * gq) * E;
        if constexpr (kInt8) {
          const uint2 w = *reinterpret_cast<const uint2*>(src);
          vr[i][0] = w.x, vr[i][1] = w.y;
        } else {
          const uint4 w = *reinterpret_cast<const uint4*>(src);
          vr[i][0] = w.x, vr[i][1] = w.y, vr[i][2] = w.z, vr[i][3] = w.w;
        }
      }
#pragma unroll
      for (int n = 0; n < VC / 8; ++n) {
        const uint32_t b0 = pair<T>(vr[0], vr[1], n), b1 = pair<T>(vr[2], vr[3], n);
        mma_bf16(acc[n], alo, b0, b1);
        mma_bf16(acc[n], ah, b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  // the heads' sums over the four warps' slots
#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
  }
  float* sums = red + WARPS * ROWS;
  if (t == 0) sums[warp * ROWS + gq] = l0, sums[warp * ROWS + gq + 8] = l1;
  __syncthreads();
  l0 = l1 = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) l0 += sums[w * ROWS + gq], l1 += sums[w * ROWS + gq + 8];

  // this thread's 8 consecutive columns of head gq + 8hh at column group e2
  auto put = [&](float* dst, int hh, int e2, float f) {
    float4* d = reinterpret_cast<float4*>(dst);
    const int e = 2 * hh + e2;
    d[0] = make_float4(acc[0][e] * f, acc[1][e] * f, acc[2][e] * f, acc[3][e] * f);
    d[1] = make_float4(acc[4][e] * f, acc[5][e] * f, acc[6][e] * f, acc[7][e] * f);
  };
  static_assert(VC / 8 == 8, "put() writes 8 columns");
  if (nlive == 1) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = gq + 8 * hh;
      if (r >= rows) continue;
      const float l = hh ? l1 : l0, inv = l == 0.f ? 1.f : 1.f / l;
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2)
        put(out + (h0 + r) * L + VC * warp + 8 * (2 * t + e2), hh, e2, inv);
    }
    return;
  }

  // this chunk's partial, then the last CTA of the unit merges them all
  float* rec = ws + (unit * gridDim.x + ci) * REC;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = gq + 8 * hh;
    if (r >= rows) continue;
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2)
      put(rec + 2 * HEADS + r * L + VC * warp + 8 * (2 * t + e2), hh, e2, 1.f);
  }
  if (warp == 0 && t == 0) {
    rec[gq] = m0, rec[HEADS + gq] = l0;
    if (gq + 8 < HEADS) rec[gq + 8] = m1, rec[HEADS + gq + 8] = l1;
  }
  int* last = reinterpret_cast<int*>(smem + S::flag);
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const bool done = atomicAdd(tickets + unit, 1) == nlive - 1;
    if (done) tickets[unit] = 0;  // ready for the next launch
    *last = done;
  }
  __syncthreads();
  if (!*last) return;
  __threadfence();
  const float* recs = ws + unit * gridDim.x * REC;
  float* row_max = red;  // [HEADS] the heads' maxima, then their sums [HEADS]
  float* wt = reinterpret_cast<float*>(smem + S::wt);  // [MERGE][HEADS] merge weights
  {
    // PER threads a head, each over every PER-th chunk (an online max and
    // sum, one round of loads), merged across the PER; the first MERGE
    // chunks' maxima become their weights in place
    constexpr int PER = THREADS / HEADS;
    static_assert(THREADS % HEADS == 0 && PER <= 32, "threads a head");
    const int r = tid / PER, sub = tid % PER;
    float mx = neg_inf(), l = 0.f;
    for (int ch = sub; ch < nlive; ch += PER) {
      const float m = __ldcg(recs + ch * REC + r);
      if (ch < MERGE) wt[ch * HEADS + r] = m;
      merge_stat(mx, l, m, __ldcg(recs + ch * REC + HEADS + r));
    }
#pragma unroll
    for (int o2 = 1; o2 < PER; o2 <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, mx, o2);
      merge_stat(mx, l, m2, __shfl_xor_sync(0xffffffffu, l, o2));
    }
    const float b = mx == neg_inf() ? 0.f : mx;
    for (int ch = sub; ch < min(nlive, MERGE); ch += PER)
      wt[ch * HEADS + r] = exp2_approx(wt[ch * HEADS + r] - b);
    if (sub == 0) row_max[r] = b, row_max[HEADS + r] = l;
  }
  // every output over the chunks, MERGE chunks' weights at a time; a thread
  // owns up to OUT float4 of the rows x L outputs, all loads independent
  constexpr int OUT = HEADS * L / 4 / THREADS;
  float4 a[OUT];
#pragma unroll
  for (int k = 0; k < OUT; ++k) a[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int n4 = rows * L / 4;
  for (int c0 = 0; c0 < nlive; c0 += MERGE) {
    const int nc = min(MERGE, nlive - c0);
    if (c0 > 0) {
      __syncthreads();  // the previous weights are consumed
      for (int i = tid; i < nc * HEADS; i += THREADS)
        wt[i] = exp2_approx(__ldcg(recs + (c0 + i / HEADS) * REC + i % HEADS) -
                            row_max[i % HEADS]);
    }
    __syncthreads();
#pragma unroll 4
    for (int ch = 0; ch < nc; ++ch) {
      const float* p = recs + (c0 + ch) * REC + 2 * HEADS;
#pragma unroll
      for (int k = 0; k < OUT; ++k) {
        const int i = tid + k * THREADS;
        if (i < n4) {
          const float f = wt[ch * HEADS + i / (L / 4)];
          const float4 v = __ldcg(reinterpret_cast<const float4*>(p) + i);
          a[k].x = fmaf(f, v.x, a[k].x);
          a[k].y = fmaf(f, v.y, a[k].y);
          a[k].z = fmaf(f, v.z, a[k].z);
          a[k].w = fmaf(f, v.w, a[k].w);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < OUT; ++k) {
    const int i = tid + k * THREADS;
    if (i < n4) {
      const float l = row_max[HEADS + i / (L / 4)], inv = l == 0.f ? 1.f : 1.f / l;
      reinterpret_cast<float4*>(out + h0 * L)[i] =
          make_float4(a[k].x * inv, a[k].y * inv, a[k].z * inv, a[k].w * inv);
    }
  }
}

template <int L, int R, typename T, typename Addr>
int launch(const void* q_lat, const void* q_rope, const void* c, const void* k_rope,
           const void* c_scale, const void* pos, void* out, void* ws, void* tickets,
           float scale, Addr addr, int b, int cap, int nh, int chunk, cudaStream_t stream) {
  const size_t smem = Smem<L, R, T>::total;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(attn_decode_mla_kernel<L, R, T, Addr>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((cap + chunk - 1) / chunk, (nh + HEADS - 1) / HEADS, b);
  attn_decode_mla_kernel<L, R, T, Addr><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q_lat), static_cast<const __nv_bfloat16*>(q_rope),
      static_cast<const T*>(c), static_cast<const __nv_bfloat16*>(k_rope),
      static_cast<const float*>(c_scale), static_cast<const int*>(pos),
      static_cast<float*>(out), static_cast<float*>(ws), static_cast<int*>(tickets), scale,
      addr, cap, nh, chunk);
  return cudaGetLastError();
}

template <typename Addr>
int by_dims(int L, int R, int c_int8, const void* q_lat, const void* q_rope, const void* c,
            const void* k_rope, const void* c_scale, const void* pos, void* out, void* ws,
            void* tickets, float scale, Addr addr, int b, int cap, int nh, int chunk,
            cudaStream_t st) {
  if (L != 256 || R != 32 || nh < 1 || chunk < TILE || chunk % TILE)
    return static_cast<int>(cudaErrorInvalidValue);
  if (c_int8)
    return launch<256, 32, int8_t>(q_lat, q_rope, c, k_rope, c_scale, pos, out, ws, tickets,
                                   scale, addr, b, cap, nh, chunk, st);
  return launch<256, 32, __nv_bfloat16>(q_lat, q_rope, c, k_rope, nullptr, pos, out, ws,
                                        tickets, scale, addr, b, cap, nh, chunk, st);
}

}  // namespace

// q_lat (b, nh, L) f32; q_rope (b, nh, R) bf16; c (b, S, L) bf16, or int8
// with c_scale (b, S) f32 when c_int8; k_rope (b, S, R) bf16; pos (b,)
// int32 >= 0; out (b, nh, L) f32; ws f32 of b·ceil(nh / 8)·ceil(S /
// chunk)·8·(L + 2) floats; tickets b·ceil(nh / 8) int32, zero (left zero);
// chunk a multiple of 32.
extern "C" int attn_decode_mla_launch(const void* q_lat, const void* q_rope, const void* c,
                                      const void* k_rope, const void* c_scale,
                                      const void* pos, void* out, void* ws, void* tickets,
                                      float scale, int b, int S, int nh, int L, int R,
                                      int c_int8, int chunk, void* stream) {
  return by_dims(L, R, c_int8, q_lat, q_rope, c, k_rope, c_scale, pos, out, ws, tickets,
                 scale, Contig{S}, b, S, nh, chunk, static_cast<cudaStream_t>(stream));
}

// q_lat (b, nh, L) f32; q_rope (b, nh, R) bf16; pools c (P, ps, L) bf16,
// or int8 with c_scale (P, ps) f32 when c_int8, and k_rope (P, ps, R)
// bf16; pt (b, npages) int32; pos (b,) int32 >= 0; out, ws, tickets as
// attn_decode_mla_launch's, at S = npages·ps; chunk also a multiple of ps.
extern "C" int attn_decode_mla_paged_launch(const void* q_lat, const void* q_rope,
                                            const void* c, const void* k_rope,
                                            const void* c_scale, const void* pt,
                                            const void* pos, void* out, void* ws,
                                            void* tickets, float scale, int b, int npages,
                                            int ps, int nh, int L, int R, int c_int8,
                                            int chunk, void* stream) {
  if (ps < 1 || chunk % ps) return static_cast<int>(cudaErrorInvalidValue);
  return by_dims(L, R, c_int8, q_lat, q_rope, c, k_rope, c_scale, pos, out, ws, tickets,
                 scale, Paged{static_cast<const int*>(pt), npages, ps}, b, npages * ps, nh,
                 chunk, static_cast<cudaStream_t>(stream));
}
