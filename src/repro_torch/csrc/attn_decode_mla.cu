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
// product); slot j is live when j <= pos[b], dead slots score -1e30; the
// flash-2 online softmax (running m, l, acc with the alpha correction); 1/l
// once at the end, l == 0 giving 1.  The output is the weighted latent: the
// v_up absorption stays outside, as on the TPU.  Slots past pos[b] are never
// read, so the paged entry stops at the last live page and never reads the
// dummy page of an unmapped entry.  There is no scalar prefetch: each block
// reads its own page-table row.  pos[b] must be >= 0.
//
// What bounds it on an H100: the live cache is read once — per batch row
// (pos+1)·(L + R)·2 bytes at bf16, (pos+1)·(L + 4 + 2R) at int8 — for
// 2·(2L + R) FLOP per (head, slot).  With nh = 40 heads sharing each latent
// row the arithmetic intensity is ~60 FLOP per byte: on the FP32 cores the
// operations, not the bytes, bound it (at minicpm3's shapes a few
// microseconds either way, so launch overhead and the few blocks dominate).
//
// What the design does about it: a block takes HG = 4 heads of one batch
// row (grid nh/4 x b: 40 blocks for serve_batch's b = 4, 80 for the
// engine's 8 slots, where one block per row would give 4 and 8).  Each
// 32-slot tile of c and k_rope is staged in shared memory once, as f32, and
// the block's four heads reuse it: one warp per head computes the tile's 32
// scores (lane = slot, odd row strides: conflict-free) and its online
// softmax in registers, then every thread accumulates its latent columns of
// P·c for the four heads in registers.  The TPU kernel's 8-row sublane
// padding and 128-lane m/l scratch have no counterpart.  Later work: split
// the cache across blocks with a log-sum-exp merge, tensor-core products.
//
// Shapes: (L, R) = (256, 32) (minicpm3-4b); any nh, any S; paged: any ps.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int HG = 4;                  // heads per block, one warp each
constexpr int THREADS = 32 * HG;
constexpr int BS = 32;                 // slots per tile, one lane each
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = __bfloat162float(e[j]);
}

__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = static_cast<float>(e[j]);
}

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

// c_scale (rows,) f32 for an int8 cache, else nullptr.
template <int L, int R, typename T, typename Addr>
__global__ void __launch_bounds__(THREADS)
attn_decode_mla_kernel(const float* __restrict__ q_lat, const __nv_bfloat16* __restrict__ q_rope,
                       const T* __restrict__ c, const __nv_bfloat16* __restrict__ k_rope,
                       const float* __restrict__ c_scale, const int* __restrict__ pos,
                       float* __restrict__ out, float scale, Addr addr, int cap, int nh) {
  static_assert(L % THREADS == 0 && L % 8 == 0 && R % 8 == 0, "latent dims");
  constexpr int LC = L / THREADS;  // latent columns per thread in P·c
  __shared__ float c_s[BS][L + 1];  // odd strides: lane j reads row j
  __shared__ float kr_s[BS][R + 1];
  __shared__ float ql_s[HG][L];
  __shared__ float qr_s[HG][R];
  __shared__ float p_s[HG][BS];     // probabilities times the slot's c scale
  __shared__ float cs_s[BS];
  __shared__ float alpha_s[HG], l_s[HG];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int h0 = blockIdx.x * HG, bi = blockIdx.y;
  const bool quantized = c_scale != nullptr;
  const int limit = min(cap, pos[bi] + 1);  // slots at or past it are dead

  for (int i = tid; i < HG * L; i += THREADS) {
    const int hh = h0 + i / L;
    ql_s[i / L][i % L] = hh < nh ? q_lat[((size_t)bi * nh + hh) * L + i % L] : 0.f;
  }
  for (int i = tid; i < HG * R; i += THREADS) {
    const int hh = h0 + i / R;
    qr_s[i / R][i % R] =
        hh < nh ? __bfloat162float(q_rope[((size_t)bi * nh + hh) * R + i % R]) : 0.f;
  }

  float m = kNegInf, l = 0.f;  // this warp's head, the same in every lane
  float acc[HG][LC];
#pragma unroll
  for (int i = 0; i < HG; ++i)
#pragma unroll
    for (int k = 0; k < LC; ++k) acc[i][k] = 0.f;

  for (int s0 = 0; s0 < limit; s0 += BS) {
    __syncthreads();  // previous tile fully consumed (and q staged)
    for (int i = tid; i < BS * L / 8; i += THREADS) {
      const int r = i / (L / 8), col = (i % (L / 8)) * 8;
      float f[8];
      if (s0 + r < limit) {
        load8(c + addr.row(bi, s0 + r) * L + col, f);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) c_s[r][col + j] = f[j];
    }
    for (int i = tid; i < BS * R / 8; i += THREADS) {
      const int r = i / (R / 8), col = (i % (R / 8)) * 8;
      float f[8];
      if (s0 + r < limit) {
        load8(k_rope + addr.row(bi, s0 + r) * R + col, f);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) kr_s[r][col + j] = f[j];
    }
    if (tid < BS)
      cs_s[tid] = quantized && s0 + tid < limit ? c_scale[addr.row(bi, s0 + tid)] : 1.f;
    __syncthreads();

    // scores of head `warp` against slot `lane`, then the online softmax
    {
      const float* qr = ql_s[warp];
      const float* cr = c_s[lane];
      float sl = 0.f, sr = 0.f;
#pragma unroll 8
      for (int d = 0; d < L; ++d) sl = fmaf(qr[d], cr[d], sl);
#pragma unroll
      for (int d = 0; d < R; ++d) sr = fmaf(qr_s[warp][d], kr_s[lane][d], sr);
      const float s = s0 + lane < limit ? (sl * cs_s[lane] + sr) * scale : kNegInf;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_next = fmaxf(m, mx);
      const float p = expf(s - m_next);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m - m_next);
      l = alpha * l + sum;
      m = m_next;
      p_s[warp][lane] = p * cs_s[lane];
      if (lane == 0) alpha_s[warp] = alpha;
    }
    __syncthreads();

    // acc = acc·alpha + P·c over this thread's latent columns
#pragma unroll
    for (int k = 0; k < LC; ++k) {
      const int col = tid + k * THREADS;
#pragma unroll
      for (int i = 0; i < HG; ++i) acc[i][k] *= alpha_s[i];
#pragma unroll 4
      for (int j = 0; j < BS; ++j) {
        const float cv = c_s[j][col];
#pragma unroll
        for (int i = 0; i < HG; ++i) acc[i][k] = fmaf(p_s[i][j], cv, acc[i][k]);
      }
    }
  }

  if (lane == 0) l_s[warp] = l;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < HG; ++i) {
    const int hh = h0 + i;
    if (hh >= nh) continue;
    const float inv = l_s[i] == 0.f ? 1.f : 1.f / l_s[i];
#pragma unroll
    for (int k = 0; k < LC; ++k)
      out[((size_t)bi * nh + hh) * L + tid + k * THREADS] = acc[i][k] * inv;
  }
}

template <int L, int R, typename Addr>
int launch(int c_int8, const void* q_lat, const void* q_rope, const void* c,
           const void* k_rope, const void* c_scale, const void* pos, void* out, float scale,
           Addr addr, int b, int cap, int nh, cudaStream_t stream) {
  dim3 grid((nh + HG - 1) / HG, b);
  const float* ql = static_cast<const float*>(q_lat);
  const __nv_bfloat16* qr = static_cast<const __nv_bfloat16*>(q_rope);
  const __nv_bfloat16* kr = static_cast<const __nv_bfloat16*>(k_rope);
  const int* ps = static_cast<const int*>(pos);
  float* o = static_cast<float*>(out);
  if (c_int8)
    attn_decode_mla_kernel<L, R, int8_t, Addr><<<grid, THREADS, 0, stream>>>(
        ql, qr, static_cast<const int8_t*>(c), kr, static_cast<const float*>(c_scale), ps, o,
        scale, addr, cap, nh);
  else
    attn_decode_mla_kernel<L, R, __nv_bfloat16, Addr><<<grid, THREADS, 0, stream>>>(
        ql, qr, static_cast<const __nv_bfloat16*>(c), kr, nullptr, ps, o, scale, addr, cap,
        nh);
  return cudaGetLastError();
}

template <typename Addr>
int by_dims(int L, int R, int c_int8, const void* q_lat, const void* q_rope, const void* c,
            const void* k_rope, const void* c_scale, const void* pos, void* out, float scale,
            Addr addr, int b, int cap, int nh, cudaStream_t st) {
  if (L == 256 && R == 32)
    return launch<256, 32>(c_int8, q_lat, q_rope, c, k_rope, c_scale, pos, out, scale, addr,
                           b, cap, nh, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q_lat (b, nh, L) f32; q_rope (b, nh, R) bf16; c (b, S, L) bf16, or int8
// with c_scale (b, S) f32 when c_int8; k_rope (b, S, R) bf16; pos (b,)
// int32 >= 0; out (b, nh, L) f32.
extern "C" int attn_decode_mla_launch(const void* q_lat, const void* q_rope, const void* c,
                                      const void* k_rope, const void* c_scale,
                                      const void* pos, void* out, float scale, int b, int S,
                                      int nh, int L, int R, int c_int8, void* stream) {
  return by_dims(L, R, c_int8, q_lat, q_rope, c, k_rope, c_scale, pos, out, scale,
                 Contig{S}, b, S, nh, static_cast<cudaStream_t>(stream));
}

// q_lat (b, nh, L) f32; q_rope (b, nh, R) bf16; pools c (P, ps, L) bf16,
// or int8 with c_scale (P, ps) f32 when c_int8, and k_rope (P, ps, R)
// bf16; pt (b, npages) int32; pos (b,) int32 >= 0; out (b, nh, L) f32.
extern "C" int attn_decode_mla_paged_launch(const void* q_lat, const void* q_rope,
                                            const void* c, const void* k_rope,
                                            const void* c_scale, const void* pt,
                                            const void* pos, void* out, float scale, int b,
                                            int npages, int ps, int nh, int L, int R,
                                            int c_int8, void* stream) {
  return by_dims(L, R, c_int8, q_lat, q_rope, c, k_rope, c_scale, pos, out, scale,
                 Paged{static_cast<const int*>(pt), npages, ps}, b, npages * ps, nh,
                 static_cast<cudaStream_t>(stream));
}
