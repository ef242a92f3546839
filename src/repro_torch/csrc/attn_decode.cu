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
// value row is codes·v_scale[j] before the p·v product, as on the TPU.
// Liveness: the contiguous entry takes the additive kmask (b, S) f32
// (0 live, -1e30 dead); slots past S in the last tile score -1e30 with a
// zero value row, exactly what the TPU kernel's padded slots contribute.
// The paged entry takes pos (b,): logical slot j is live when j <= pos[b]
// and lives at pool row pt[b, j / ps]·ps + j % ps.  There is no scalar
// prefetch: each block reads its own page-table row.  Pages past pos[b]/ps
// are fully masked, so the block stops there — exact, and it never reads
// the dummy page of an unmapped entry.  pos[b] must be >= 0.
//
// What bounds it on an H100: decode attention reads the live cache once —
// per batch row S·nkv·hd·2 bytes at bf16, S·nkv·(hd + 4)·2 at int8 (codes
// plus scales, about half) — for ~4·g·hd FLOP per slot, far below the
// byte/FLOP ridge: bytes bound it.  But one block per (KV head, batch row)
// gives only b·nkv blocks (32 for serve_batch, 64 for the engine), under
// half of the 132 SMs, so this kernel cannot reach the card's memory rate
// and halving the bytes (int8) or skipping dead pages moves little.
//
// What the design does about it: 64-slot K/V tiles are staged in shared
// memory as f32 (int8 codes widened, V pre-multiplied by its scale) with an
// odd K row stride (conflict-free dot products), the g query rows share
// each staged tile, and the accumulator lives in shared memory so any g
// fits.  Later work: split S across blocks with a log-sum-exp merge.
//
// Shapes: hd in {16, 32, 64, 128}; g any (shared memory grows with g);
// contiguous: any S; paged: any ps (the wrapper asks for a multiple of 8).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BS = 64, THREADS = 128, WARPS = THREADS / 32;
constexpr float kNegInf = -1e30f;

template <int HD>
struct Layout {
  static constexpr int KS = HD + 1;  // f32 row stride of the K tile (odd)
  size_t q, k, v, p, acc, stats, mask, total;
  __host__ __device__ explicit Layout(int g) {
    q = 0;
    k = q + sizeof(float) * g * HD;
    v = k + sizeof(float) * BS * KS;
    p = v + sizeof(float) * BS * HD;
    acc = p + sizeof(float) * g * BS;
    stats = acc + sizeof(float) * g * HD;  // m, l, alpha
    mask = stats + sizeof(float) * 3 * g;  // additive mask, k scale
    total = mask + sizeof(float) * 2 * BS;
  }
};

// eight consecutive cache elements widened to f32
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

// kmask (b, cap) additive, or nullptr with pos (b,): live iff j <= pos[bi].
// k_scale / v_scale (rows, nkv) f32 for an int8 cache, else nullptr.
template <int HD, typename T, typename Addr>
__global__ void __launch_bounds__(THREADS)
attn_decode_kernel(const __nv_bfloat16* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, const float* __restrict__ kmask,
                   const int* __restrict__ pos, float* __restrict__ out, float scale,
                   Addr addr, int cap, int nkv, int g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<HD> L(g);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* ks = reinterpret_cast<float*>(smem + L.k);
  float* vs = reinterpret_cast<float*>(smem + L.v);
  float* ps = reinterpret_cast<float*>(smem + L.p);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* m_s = reinterpret_cast<float*>(smem + L.stats);
  float* l_s = m_s + g;
  float* alpha_s = l_s + g;
  float* mask_s = reinterpret_cast<float*>(smem + L.mask);
  float* kscale_s = mask_s + BS;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int h = blockIdx.x, bi = blockIdx.y;
  const size_t qbase = ((size_t)bi * nkv + h) * g * HD;
  const bool quantized = k_scale != nullptr;
  // slots at or past `limit` are dead and never read
  const int limit = kmask != nullptr ? cap : min(cap, pos[bi] + 1);

  for (int i = tid; i < g * HD; i += THREADS) {
    qs[i] = __bfloat162float(q[qbase + i]) * scale;
    acc[i] = 0.f;
  }
  for (int i = tid; i < g; i += THREADS) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  for (int s0 = 0; s0 < limit; s0 += BS) {
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < BS * HD / 8; i += THREADS) {
      const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
      float kf[8], vf[8];
      if (s0 + r < limit) {
        const size_t cache_row = addr.row(bi, s0 + r);
        const size_t off = (cache_row * nkv + h) * HD + c;
        load8(k + off, kf);
        load8(v + off, vf);
        if (quantized) {
          const float vsc = v_scale[cache_row * nkv + h];
#pragma unroll
          for (int j = 0; j < 8; ++j) vf[j] *= vsc;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) kf[j] = vf[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ks[r * L.KS + c + j] = kf[j];
        vs[r * HD + c + j] = vf[j];
      }
    }
    if (tid < BS) {
      const int j = s0 + tid;
      const bool in = j < limit;
      mask_s[tid] = !in ? kNegInf : kmask != nullptr ? kmask[(size_t)bi * cap + j] : 0.f;
      kscale_s[tid] = in && quantized ? k_scale[addr.row(bi, j) * nkv + h] : 1.f;
    }
    __syncthreads();

    // scores for every (query row, slot) pair of the tile
    for (int idx = tid; idx < g * BS; idx += THREADS) {
      const int i = idx / BS, j = idx % BS;
      const float* qr = qs + i * HD;
      const float* kr = ks + j * L.KS;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
      if (quantized) dot *= kscale_s[j];
      ps[idx] = s0 + j < limit ? dot + mask_s[j] : kNegInf;
    }
    __syncthreads();

    // online softmax, one warp per query row
    for (int i = warp; i < g; i += WARPS) {
      float* pr = ps + i * BS;
      float mx = kNegInf;
      for (int j = lane; j < BS; j += 32) mx = fmaxf(mx, pr[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[i];
      const float m_next = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < BS; j += 32) {
        const float p = expf(pr[j] - m_next);
        pr[j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_next);
        alpha_s[i] = alpha;
        l_s[i] = alpha * l_s[i] + sum;
        m_s[i] = m_next;
      }
    }
    __syncthreads();

    // acc = acc·alpha + P·V
    for (int idx = tid; idx < g * HD; idx += THREADS) {
      const int i = idx / HD, c = idx % HD;
      const float* pr = ps + i * BS;
      float a = acc[idx] * alpha_s[i];
#pragma unroll 8
      for (int j = 0; j < BS; ++j) a = fmaf(pr[j], vs[j * HD + c], a);
      acc[idx] = a;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < g * HD; idx += THREADS) {
    const float l = l_s[idx / HD];
    out[qbase + idx] = acc[idx] * (l == 0.f ? 1.f : 1.f / l);
  }
}

template <int HD, typename T, typename Addr>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* kmask, const void* pos, void* out, float scale,
           Addr addr, int b, int cap, int nkv, int g, cudaStream_t stream) {
  const size_t smem = Layout<HD>(g).total;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(attn_decode_kernel<HD, T, Addr>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(nkv, b);
  attn_decode_kernel<HD, T, Addr><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const float*>(kmask),
      static_cast<const int*>(pos), static_cast<float*>(out), scale, addr, cap, nkv, g);
  return cudaGetLastError();
}

template <typename T, typename Addr>
int by_head_dim(int hd, const void* q, const void* k, const void* v, const void* k_scale,
                const void* v_scale, const void* kmask, const void* pos, void* out,
                float scale, Addr addr, int b, int cap, int nkv, int g, cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch<16, T>(q, k, v, k_scale, v_scale, kmask, pos, out, scale, addr, b, cap,
                           nkv, g, st);
    case 32:
      return launch<32, T>(q, k, v, k_scale, v_scale, kmask, pos, out, scale, addr, b, cap,
                           nkv, g, st);
    case 64:
      return launch<64, T>(q, k, v, k_scale, v_scale, kmask, pos, out, scale, addr, b, cap,
                           nkv, g, st);
    case 128:
      return launch<128, T>(q, k, v, k_scale, v_scale, kmask, pos, out, scale, addr, b, cap,
                            nkv, g, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename Addr>
int by_dtype(int kv_int8, int hd, const void* q, const void* k, const void* v,
             const void* k_scale, const void* v_scale, const void* kmask, const void* pos,
             void* out, float scale, Addr addr, int b, int cap, int nkv, int g,
             cudaStream_t st) {
  if (kv_int8)
    return by_head_dim<int8_t>(hd, q, k, v, k_scale, v_scale, kmask, pos, out, scale, addr,
                               b, cap, nkv, g, st);
  return by_head_dim<__nv_bfloat16>(hd, q, k, v, nullptr, nullptr, kmask, pos, out, scale,
                                    addr, b, cap, nkv, g, st);
}

}  // namespace

// q (b, nkv, g, hd) bf16; k/v (b, S, nkv, hd) bf16, or int8 with
// k_scale/v_scale (b, S, nkv) f32 when kv_int8; kmask (b, S) f32;
// out (b, nkv, g, hd) f32.
extern "C" int attn_decode_launch(const void* q, const void* k, const void* v,
                                  const void* k_scale, const void* v_scale, const void* kmask,
                                  void* out, float scale, int b, int S, int nkv, int g, int hd,
                                  int kv_int8, void* stream) {
  return by_dtype(kv_int8, hd, q, k, v, k_scale, v_scale, kmask, nullptr, out, scale,
                  Contig{S}, b, S, nkv, g, static_cast<cudaStream_t>(stream));
}

// q (b, nkv, g, hd) bf16; pools k/v (P, ps, nkv, hd) bf16, or int8 with
// k_scale/v_scale (P, ps, nkv) f32 when kv_int8; pt (b, npages) int32;
// pos (b,) int32 >= 0; out (b, nkv, g, hd) f32.
extern "C" int attn_decode_paged_launch(const void* q, const void* k, const void* v,
                                        const void* k_scale, const void* v_scale,
                                        const void* pt, const void* pos, void* out,
                                        float scale, int b, int npages, int ps, int nkv,
                                        int g, int hd, int kv_int8, void* stream) {
  return by_dtype(kv_int8, hd, q, k, v, k_scale, v_scale, nullptr, pos, out, scale,
                  Paged{static_cast<const int*>(pt), npages, ps}, b, npages * ps, nkv, g,
                  static_cast<cudaStream_t>(stream));
}
