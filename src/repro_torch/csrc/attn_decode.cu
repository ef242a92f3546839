// GQA decode attention over a bf16 or int8 KV cache, contiguous or paged.
//
//   out[b, h, i, :] = softmax(q[b, h, i, :]·scale · Kᵀ + mask[b]) · V
//
// Replaces: src/repro/kernels/attn_decode.py::attn_decode_gqa_pallas (both
// branches: bf16, and int8 with per-(token, head) scales folded into the
// dots) through attn_decode_launch, and
// src/repro/kernels/attn_decode.py::attn_decode_gqa_paged_pallas through
// attn_decode_paged_launch.  As on the TPU, where the paged kernel reuses
// _gqa_kernel with other index maps, both entry points run one body; only
// the slot -> cache row map differs (struct Contig / struct Paged).
//
// Semantics carried over exactly: q (b, nkv, g, hd) — the g query heads of
// one KV head — against k/v read in their stored layout, (b, S, nkv, hd)
// contiguous or (P, ps, nkv, hd) pools; the flash-2 online softmax (running
// m, l, acc with the alpha correction); 1/l at the end with l == 0 giving 1.
// int8: score(j) = (q·codes_j)·k_scale[j] before the mask is added, and the
// value row is codes·v_scale[j] (folded into p_j: p_j·v_scale[j] times the
// codes, the same product in another f32 order).  Liveness: the contiguous
// entry takes the additive kmask (b, S) f32 (0 live, -1e30 dead) over every
// slot below S.  The paged entry takes pos (b,): logical slot j is live
// when j <= pos[b] and lives at pool row pt[b, j / ps]·ps + j % ps; no page
// past pos[b] / ps is read (unmapped entries are the dummy page 0).  There
// is no scalar prefetch: each CTA reads its own page-table entries.  pos[b]
// must be >= 0.
//
// What bounds it on an H100: decode attention reads the live cache once —
// per batch row S·nkv·hd·2 bytes at bf16, S·nkv·(hd + 4)·2 at int8 (codes
// plus scales, about half) — for ~4·g·hd operations per slot, far below the
// byte/FLOP ridge: bytes bound it, and at serve_batch's 8.9 MB only if the
// whole card reads at once.
//
// What the design does about it:
//  * Split-KV: the grid is (slot chunks, nkv · row groups, b).  A CTA takes
//    one chunk of `chunk` slots (whole 64-slot tiles; whole pages on the
//    paged entry) of one (batch row, KV head) for a group of up to 16 of
//    that head's query rows, so b·nkv·(S / chunk) CTAs share the read
//    (the wrapper picks chunk: two tiles, the ring's depth, or fewer where
//    that leaves SMs idle).  A paged chunk past pos[b] returns at once.
//  * Each CTA writes its partial (m, l, acc) rows to a workspace and takes
//    a ticket; the last CTA of a (batch row, KV head, row group) merges the
//    partials by log-sum-exp in chunk order, so the result does not depend
//    on which CTA finishes last, and resets the ticket for the next launch.
//    A chunk whose slots kmask all kills has m ≈ -1e30 and p = 1 inside;
//    its merge weight 2^(m_chunk − m_row) = 0 removes it.  A row with one
//    chunk writes its output directly.
//  * K/V tiles arrive in 16-byte `cp.async` copies through a two-stage
//    ring in their stored type (no widening in shared memory); each warp
//    takes 16 slots of a tile for all rows of the group.
//  * q·k and p·v are `mma.sync` m16n8k16 bf16 with f32 accumulators (the
//    g rows padded to 16; int8 codes widen to bf16 in registers, exactly).
//    Warp FMAs in f32, which spend nothing on padded rows, were slower even
//    at g = 4 (PERF.md §6).  The hd columns of each k16 step are
//    permuted (thread t takes columns 4t..4t+3 of K and q alike), so a
//    thread's K fragment is one 8-byte (bf16) or 4-byte (int8) read; the
//    value columns are permuted the other way (thread g of a quad owns hd/8
//    consecutive columns), so its V fragments are one row read each.  P is
//    split in bf16 hi / lo parts (f32 accuracy, as csrc/attn_prefill.cu).
//  * hd 112 (kimi-k2) is 7 k16 steps and 14 value columns a quad thread:
//    its V segment (28 bytes bf16, 14 int8) is read as words or halfwords,
//    the only code path that differs from the other head dims'.
//  * The warps' (m, l, acc) meet in shared memory in the fragments' order
//    (row stride hd + 8: conflict-free stores; in the columns' order the
//    stores were 32-way bank conflicts that cost the kernel a third of its
//    time); the partials keep that order and the output write maps it back.
//    The last CTA's merge takes each row's max and sum over the chunks a
//    warp per row, then every output over the chunks with independent loads.
//
// Shapes: hd in {16, 32, 64, 112, 128}; any g; contiguous: any S; paged: any ps
// (the wrapper asks for a multiple of 8); chunk a multiple of 64 (and of ps
// on the paged entry).  Launches on one stream run one after another; two
// launches at once on two streams would share the tickets.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int TILE = 64;   // slots of a ring stage; a warp takes 16 of them
constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int ROWS = 16;   // query rows of a CTA
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Shared memory of one CTA: two ring stages of a tile (K rows, V rows, k /
// v scales, mask), then, over the spent ring, the four warps' (m, l, acc)
// for the CTA's merge; the ticket flag lies past both.
template <int HD, typename T>
struct Tile {
  static constexpr int E = sizeof(T);
  // K row stride in words: 8 mod 16 (bf16: 8-byte reads) or 4 mod 8 (int8:
  // 4-byte reads), so a warp's K fragment reads fall on distinct banks
  static constexpr int KW = HD * E / 4, KM = E == 2 ? 16 : 8;
  static constexpr int KS = 4 * (KW + ((KM / 2 - KW) % KM + KM) % KM);
  static constexpr int VS = HD * E + 16;
  static constexpr int WS = HD + 8;  // f32 row stride of the warps' acc
  static constexpr size_t k = 0, v = k + (size_t)TILE * KS, ksc = v + (size_t)TILE * VS,
                          vsc = ksc + 4 * TILE, mask = vsc + 4 * TILE, stage = mask + 4 * TILE;
  static constexpr size_t merge = (size_t)WARPS * ROWS * (WS + 2) * 4;
  static constexpr size_t flag = 2 * stage > merge ? 2 * stage : merge;
  static constexpr size_t total = flag + 16;
};

// The value column of position j = 8c + n of a row in the fragments' order:
// n·HD/8 + c
template <int HD>
__device__ __forceinline__ int col_of(int j) { return (j & 7) * (HD / 8) + (j >> 3); }

// slot j of batch row bi -> row of the (rows, nkv, hd) cache view
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

// NB bytes of shared memory into words: 2, 4, 8 or a multiple of 16 read
// whole; hd 112's 28 bytes (bf16, 4-byte aligned at gq·28) as words and 14
// bytes (int8, 2-byte aligned at gq·14) as halfwords
template <int NB>
__device__ __forceinline__ void load_row(uint32_t* dst, const unsigned char* src) {
  if constexpr (NB % 16 == 0) {
#pragma unroll
    for (int i = 0; i < NB / 16; ++i)
      *reinterpret_cast<uint4*>(dst + 4 * i) = *reinterpret_cast<const uint4*>(src + 16 * i);
  } else if constexpr (NB == 8) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  } else if constexpr (NB == 4) {
    dst[0] = *reinterpret_cast<const uint32_t*>(src);
  } else if constexpr (NB == 2) {
    dst[0] = *reinterpret_cast<const uint16_t*>(src);
  } else if constexpr (NB % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NB / 4; ++i) dst[i] = reinterpret_cast<const uint32_t*>(src)[i];
  } else {
    static_assert(NB % 2 == 0, "a row segment is whole halfwords");
    const uint16_t* h = reinterpret_cast<const uint16_t*>(src);
#pragma unroll
    for (int i = 0; i < (NB + 3) / 4; ++i) {
      const uint32_t lo = h[2 * i], hi = 2 * i + 1 < NB / 2 ? h[2 * i + 1] : 0u;
      dst[i] = lo | hi << 16;
    }
  }
}

// int8 code i of a row's words
__device__ __forceinline__ float code(const uint32_t* w, int i) {
  return (float)(int8_t)(w[i >> 2] >> (8 * (i & 3)));
}

// element i of two rows' words as a bf16 pair (row a low, row b high)
template <typename T>
__device__ __forceinline__ uint32_t pair(const uint32_t* a, const uint32_t* b, int i) {
  if constexpr (sizeof(T) == 2) return __byte_perm(a[i >> 1], b[i >> 1], (i & 1) ? 0x7632 : 0x5410);
  else return pack_bf16(code(a, i), code(b, i));
}

// kmask (b, cap) additive, or nullptr with pos (b,): live iff j <= pos[bi].
// k_scale / v_scale (rows, nkv) f32 for an int8 cache, else nullptr.  ws:
// per (unit, chunk) 16 rows of m, 16 of l, 16 x HD of acc (each row in the
// fragments' order), where unit = (bi·nkv + head)·groups + group; tickets:
// one zero int per unit.
template <int HD, typename T, typename Addr>
__global__ void __launch_bounds__(THREADS)
attn_decode_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, const float* __restrict__ kmask,
                   const int* __restrict__ pos, float* __restrict__ out, float* __restrict__ ws,
                   int* __restrict__ tickets, float scale, Addr addr, int cap, int nkv, int g,
                   int chunk) {
  using L = Tile<HD, T>;
  constexpr int E = sizeof(T), REC = ROWS * (HD + 2), WS = L::WS;
  constexpr bool kInt8 = E == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int groups = (g + ROWS - 1) / ROWS;
  const int ci = blockIdx.x, hk = blockIdx.y / groups, rg = blockIdx.y % groups;
  const int bi = blockIdx.z;
  // slots at or past `limit` are dead and never read
  const int limit = kmask != nullptr ? cap : min(cap, pos[bi] + 1);
  const int nlive = (limit + chunk - 1) / chunk;  // chunks holding a slot below limit
  if (ci >= nlive) return;
  const int s_begin = ci * chunk, s_end = min(limit, s_begin + chunk);
  const int rows = min(ROWS, g - ROWS * rg);
  const size_t unit = ((size_t)bi * nkv + hk) * groups + rg;
  const size_t q0 = (((size_t)bi * nkv + hk) * g + ROWS * rg) * HD;  // the group's first row
  const float mul = scale * kLog2e;

  auto load_tile = [&](int s0, int stage) {
    unsigned char* base = smem + stage * L::stage;
    constexpr int PIECES = HD * E / 16;  // 16-byte copies a row
    for (int i = tid; i < TILE * PIECES; i += THREADS) {
      const int r = i / PIECES, c = i % PIECES, j = s0 + r;
      const bool live = j < s_end;
      const size_t off = live ? (addr.row(bi, j) * nkv + hk) * HD * E + 16 * c : 0;
      cp_async16(smem_u32(base + L::k + r * L::KS + 16 * c),
                 reinterpret_cast<const unsigned char*>(k) + off, live ? 16 : 0);
      cp_async16(smem_u32(base + L::v + r * L::VS + 16 * c),
                 reinterpret_cast<const unsigned char*>(v) + off, live ? 16 : 0);
    }
    if (tid < TILE) {
      const int j = s0 + tid;
      const bool live = j < s_end;
      if constexpr (kInt8) {
        const size_t at = live ? addr.row(bi, j) * nkv + hk : 0;
        cp_async4(smem_u32(base + L::ksc + 4 * tid), k_scale + at, live ? 4 : 0);
        cp_async4(smem_u32(base + L::vsc + 4 * tid), v_scale + at, live ? 4 : 0);
      }
      if (kmask != nullptr)
        cp_async4(smem_u32(base + L::mask + 4 * tid), kmask + (size_t)bi * cap + (live ? j : 0),
                  live ? 4 : 0);
    }
  };

  const int ntiles = (s_end - s_begin + TILE - 1) / TILE;
  load_tile(s_begin, 0);
  cp_async_commit();
  if (ntiles > 1) load_tile(s_begin + TILE, 1);
  cp_async_commit();

  // scaled score (log2 units) of a slot r of the tile at s0; -inf past the
  // chunk's live slots
  auto score = [&](const unsigned char* base, int s0, int r, float dot) {
    const float f = kInt8 ? mul * reinterpret_cast<const float*>(base + L::ksc)[r] : mul;
    const float add =
        kmask != nullptr ? reinterpret_cast<const float*>(base + L::mask)[r] * kLog2e : 0.f;
    return s0 + r < s_end ? fmaf(dot, f, add) : neg_inf();
  };
  auto v_scale_of = [&](const unsigned char* base, int r) {
    return kInt8 ? reinterpret_cast<const float*>(base + L::vsc)[r] : 1.f;
  };

  // each warp's (m, l, acc) for the CTA's merge, over the spent ring
  float* wm = reinterpret_cast<float*>(smem);  // [WARPS][ROWS]
  float* wl = wm + WARPS * ROWS;               // [WARPS][ROWS]
  float* wo = wl + WARPS * ROWS;               // [WARPS][ROWS][WS]

  const int gq = lane >> 2, t = lane & 3;
  // A fragments of q, rows gq and gq + 8 of the group (zero past g), hd
  // columns 16s + 4t .. 16s + 4t + 3 of each k16 step s: the permutation
  // the K fragments share
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int s = 0; s < HD / 16; ++s) {
    const uint2 z = make_uint2(0u, 0u);
    const __nv_bfloat16* qr = q + q0 + gq * HD + 16 * s + 4 * t;
    const uint2 r0 = gq < rows ? *reinterpret_cast<const uint2*>(qr) : z;
    const uint2 r1 = gq + 8 < rows ? *reinterpret_cast<const uint2*>(qr + 8 * HD) : z;
    qf[s][0] = r0.x, qf[s][1] = r1.x, qf[s][2] = r0.y, qf[s][3] = r1.y;
  }
  // o[c][e]: row gq + 8·(e >> 1), value column (2t + (e & 1))·HD/8 + c
  float o[HD / 8][4];
#pragma unroll
  for (int c = 0; c < HD / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c][e] = 0.f;
  // running max (log2 units) and per-thread partial sums of rows gq, gq + 8
  float m0 = neg_inf(), m1 = neg_inf(), l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* base = smem + (it & 1) * L::stage;
    const int s0 = s_begin + it * TILE;

    // scores of the warp's 16 slots: column gq of n-tile jn is slot
    // 16·warp + 8·jn + gq of the tile
    float sc[2][4] = {};
#pragma unroll
    for (int s = 0; s < HD / 16; ++s)
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
        const unsigned char* kr =
            base + L::k + (16 * warp + 8 * jn + gq) * L::KS + (16 * s + 4 * t) * E;
        uint32_t b0, b1;
        if constexpr (kInt8) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(kr);  // four codes
          b0 = pack_bf16(code(&w, 0), code(&w, 1));
          b1 = pack_bf16(code(&w, 2), code(&w, 3));
        } else {
          const uint2 w = *reinterpret_cast<const uint2*>(kr);
          b0 = w.x, b1 = w.y;
        }
        mma_bf16(sc[jn], qf[s], b0, b1);
      }

    float mx0 = neg_inf(), mx1 = neg_inf();
#pragma unroll
    for (int jn = 0; jn < 2; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 16 * warp + 8 * jn + 2 * t + e;
        sc[jn][e] = score(base, s0, r, sc[jn][e]);
        sc[jn][2 + e] = score(base, s0, r, sc[jn][2 + e]);
        mx0 = fmaxf(mx0, sc[jn][e]);
        mx1 = fmaxf(mx1, sc[jn][2 + e]);
      }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // a row with no live slot yet keeps m = -inf: subtract 0 there
    const float c0 = mn0 == neg_inf() ? 0.f : mn0, c1 = mn1 == neg_inf() ? 0.f : mn1;
    const float al0 = exp2_approx(m0 - c0), al1 = exp2_approx(m1 - c1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int jn = 0; jn < 2; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float vs = v_scale_of(base, 16 * warp + 8 * jn + 2 * t + e);
        sc[jn][e] = exp2_approx(sc[jn][e] - c0);
        sc[jn][2 + e] = exp2_approx(sc[jn][2 + e] - c1);
        sum0 += sc[jn][e];
        sum1 += sc[jn][2 + e];
        sc[jn][e] *= vs;  // p·v_scale: the value row's scale
        sc[jn][2 + e] *= vs;
      }
    l0 = al0 * l0 + sum0;  // per-thread partial sums; the quad adds them at the end
    l1 = al1 * l1 + sum1;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      o[c][0] *= al0;
      o[c][1] *= al0;
      o[c][2] *= al1;
      o[c][3] *= al1;
    }

    // o += (P_hi + P_lo) · V over the warp's 16 slots; thread (gq, t)
    // reads value columns gq·HD/8 .. + HD/8 - 1 of slots 2t, 2t + 1,
    // 2t + 8, 2t + 9
    uint32_t ph[4], pl[4];
    split_bf16(sc[0][0], sc[0][1], ph[0], pl[0]);
    split_bf16(sc[0][2], sc[0][3], ph[1], pl[1]);
    split_bf16(sc[1][0], sc[1][1], ph[2], pl[2]);
    split_bf16(sc[1][2], sc[1][3], ph[3], pl[3]);
    constexpr int NB = HD / 8 * E, NW = (NB + 3) / 4;
    uint32_t vr[4][NW];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 16 * warp + 2 * t + (i & 1) + 8 * (i >> 1);
      load_row<NB>(vr[i], base + L::v + r * L::VS + gq * NB);
    }
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      const uint32_t b0 = pair<T>(vr[0], vr[1], c), b1 = pair<T>(vr[2], vr[3], c);
      mma_bf16(o[c], pl, b0, b1);
      mma_bf16(o[c], ph, b0, b1);
    }

    __syncthreads();  // the stage is refilled below
    if (it + 2 < ntiles) load_tile(s0 + 2 * TILE, it & 1);
    cp_async_commit();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
  }
  if (t == 0) {
    wm[warp * ROWS + gq] = m0, wm[warp * ROWS + gq + 8] = m1;
    wl[warp * ROWS + gq] = l0, wl[warp * ROWS + gq + 8] = l1;
  }
  // acc row r, position 8c + n (column col_of(8c + n))
#pragma unroll
  for (int c = 0; c < HD / 8; ++c)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(wo + (warp * ROWS + gq + 8 * hh) * WS + 8 * c + 2 * t) =
          make_float2(o[c][2 * hh], o[c][2 * hh + 1]);
  __syncthreads();

  // the CTA's four warps merged; the chunk's partial (or, for a row with
  // one chunk, its output)
  float* rec = ws + (unit * gridDim.x + ci) * REC;  // this chunk's m, l, acc
  for (int i = tid; i < rows * HD; i += THREADS) {
    const int r = i / HD, j = i % HD;
    float mx = neg_inf();
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wm[w * ROWS + r]);
    const float base = mx == neg_inf() ? 0.f : mx;
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = exp2_approx(wm[w * ROWS + r] - base);
      l += f * wl[w * ROWS + r];
      a += f * wo[(w * ROWS + r) * WS + j];
    }
    if (nlive == 1) {
      out[q0 + r * HD + col_of<HD>(j)] = a * (l == 0.f ? 1.f : 1.f / l);
    } else {
      rec[2 * ROWS + i] = a;
      if (j == 0) rec[r] = mx, rec[ROWS + r] = l;
    }
  }
  if (nlive == 1) return;

  // the last CTA of the unit merges every chunk's partial, in chunk order
  int* last = reinterpret_cast<int*>(smem + L::flag);
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
  float* row_max = reinterpret_cast<float*>(smem);  // [ROWS], then the rows' sums [ROWS]
  for (int r = warp; r < rows; r += WARPS) {  // a warp per row, lanes over the chunks
    float mx = neg_inf();
    for (int ch = lane; ch < nlive; ch += 32) mx = fmaxf(mx, __ldcg(recs + ch * REC + r));
#pragma unroll
    for (int o2 = 16; o2 > 0; o2 >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
    const float base = mx == neg_inf() ? 0.f : mx;
    float l = 0.f;
    for (int ch = lane; ch < nlive; ch += 32)
      l += exp2_approx(__ldcg(recs + ch * REC + r) - base) * __ldcg(recs + ch * REC + ROWS + r);
#pragma unroll
    for (int o2 = 16; o2 > 0; o2 >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o2);
    if (lane == 0) row_max[r] = base, row_max[ROWS + r] = l;
  }
  __syncthreads();
  for (int i = tid; i < rows * HD; i += THREADS) {
    const int r = i / HD;
    const float base = row_max[r], l = row_max[ROWS + r];
    float a = 0.f;
#pragma unroll 4
    for (int ch = 0; ch < nlive; ++ch) {
      const float* p = recs + ch * REC;
      a += exp2_approx(__ldcg(p + r) - base) * __ldcg(p + 2 * ROWS + i);
    }
    out[q0 + r * HD + col_of<HD>(i % HD)] = a * (l == 0.f ? 1.f : 1.f / l);
  }
}

template <int HD, typename T, typename Addr>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* kmask, const void* pos, void* out, void* ws,
           void* tickets, float scale, Addr addr, int b, int cap, int nkv, int g, int chunk,
           cudaStream_t stream) {
  const size_t smem = Tile<HD, T>::total;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(attn_decode_kernel<HD, T, Addr>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((cap + chunk - 1) / chunk, nkv * ((g + ROWS - 1) / ROWS), b);
  attn_decode_kernel<HD, T, Addr><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const float*>(kmask),
      static_cast<const int*>(pos), static_cast<float*>(out), static_cast<float*>(ws),
      static_cast<int*>(tickets), scale, addr, cap, nkv, g, chunk);
  return cudaGetLastError();
}

template <typename T, typename Addr>
int by_head_dim(int hd, const void* q, const void* k, const void* v, const void* k_scale,
                const void* v_scale, const void* kmask, const void* pos, void* out, void* ws,
                void* tickets, float scale, Addr addr, int b, int cap, int nkv, int g,
                int chunk, cudaStream_t st) {
#define HEAD_DIM(HD)                                                                      \
  case HD:                                                                                \
    return launch<HD, T>(q, k, v, k_scale, v_scale, kmask, pos, out, ws, tickets, scale, \
                         addr, b, cap, nkv, g, chunk, st);
  switch (hd) {
    HEAD_DIM(16)
    HEAD_DIM(32)
    HEAD_DIM(64)
    HEAD_DIM(112)
    HEAD_DIM(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HEAD_DIM
}

template <typename Addr>
int by_dtype(int kv_int8, int hd, const void* q, const void* k, const void* v,
             const void* k_scale, const void* v_scale, const void* kmask, const void* pos,
             void* out, void* ws, void* tickets, float scale, Addr addr, int b, int cap,
             int nkv, int g, int chunk, cudaStream_t st) {
  if (g < 1 || chunk < TILE || chunk % TILE) return static_cast<int>(cudaErrorInvalidValue);
  if (kv_int8)
    return by_head_dim<int8_t>(hd, q, k, v, k_scale, v_scale, kmask, pos, out, ws, tickets,
                               scale, addr, b, cap, nkv, g, chunk, st);
  return by_head_dim<__nv_bfloat16>(hd, q, k, v, nullptr, nullptr, kmask, pos, out, ws,
                                    tickets, scale, addr, b, cap, nkv, g, chunk, st);
}

}  // namespace

// q (b, nkv, g, hd) bf16; k/v (b, S, nkv, hd) bf16, or int8 with
// k_scale/v_scale (b, S, nkv) f32 when kv_int8; kmask (b, S) f32;
// out (b, nkv, g, hd) f32; ws f32 of b·nkv·ceil(g / 16)·ceil(S / chunk)·16·
// (hd + 2) floats; tickets b·nkv·ceil(g / 16) int32, zero (left zero).
extern "C" int attn_decode_launch(const void* q, const void* k, const void* v,
                                  const void* k_scale, const void* v_scale, const void* kmask,
                                  void* out, void* ws, void* tickets, float scale, int b, int S,
                                  int nkv, int g, int hd, int kv_int8, int chunk, void* stream) {
  return by_dtype(kv_int8, hd, q, k, v, k_scale, v_scale, kmask, nullptr, out, ws, tickets,
                  scale, Contig{S}, b, S, nkv, g, chunk, static_cast<cudaStream_t>(stream));
}

// q (b, nkv, g, hd) bf16; pools k/v (P, ps, nkv, hd) bf16, or int8 with
// k_scale/v_scale (P, ps, nkv) f32 when kv_int8; pt (b, npages) int32;
// pos (b,) int32 >= 0; out, ws, tickets as attn_decode_launch's, at
// S = npages·ps; chunk a multiple of ps.
extern "C" int attn_decode_paged_launch(const void* q, const void* k, const void* v,
                                        const void* k_scale, const void* v_scale,
                                        const void* pt, const void* pos, void* out, void* ws,
                                        void* tickets, float scale, int b, int npages, int ps,
                                        int nkv, int g, int hd, int kv_int8, int chunk,
                                        void* stream) {
  if (ps < 1 || chunk % ps) return static_cast<int>(cudaErrorInvalidValue);
  return by_dtype(kv_int8, hd, q, k, v, k_scale, v_scale, nullptr, pos, out, ws, tickets,
                  scale, Paged{static_cast<const int*>(pt), npages, ps}, b, npages * ps, nkv,
                  g, chunk, static_cast<cudaStream_t>(stream));
}
