// GQA decode attention over a contiguous bf16 KV cache.
//
//   out[b, h, i, :] = softmax(q[b, h, i, :]·scale · Kᵀ + kmask[b]) · V
//
// Replaces: src/repro/kernels/attn_decode.py::attn_decode_gqa_pallas (its
// bf16 branch; the int8 branch with scales folded into the dots belongs to
// the int8-KV slice).
//
// Semantics carried over exactly: q (b, nkv, g, hd) — the g query heads of
// one KV head — against k/v (b, S, nkv, hd) read in their stored layout;
// the additive kmask (b, S) f32 (0 live, -1e30 dead); the flash-2 online
// softmax (running m, l, acc with the alpha correction); 1/l at the end with
// l == 0 giving 1.  Slots past S in the last tile score -1e30 with a zero
// value row, exactly what the TPU kernel's padded slots contribute.
//
// What bounds it on an H100: decode attention reads the live cache once
// (2·S·nkv·hd·2 bytes per batch row) for ~4·g·hd FLOP per slot, far below
// the byte/FLOP ridge: bytes bound it.  But one block per (KV head, batch
// row) gives only b·nkv = 32 blocks at the main path's shapes, a quarter of
// the 132 SMs, so this first kernel cannot reach the card's memory rate.
//
// What the design does about it: 64-slot K/V tiles are staged in shared
// memory as f32 with an odd row stride (conflict-free dot products), the g
// query rows share each staged tile, and the accumulator lives in shared
// memory so any g fits.  Later work: split S across blocks with a
// log-sum-exp merge.
//
// Shapes: any S; hd in {16, 32, 64, 128}; g any (shared memory grows with g).

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
    mask = stats + sizeof(float) * 3 * g;
    total = mask + sizeof(float) * BS;
  }
};

template <int HD>
__global__ void __launch_bounds__(THREADS)
attn_decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const float* __restrict__ kmask,
                   float* __restrict__ out, float scale, int S, int nkv, int g) {
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

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int h = blockIdx.x, bi = blockIdx.y;
  const size_t qbase = ((size_t)bi * nkv + h) * g * HD;

  for (int i = tid; i < g * HD; i += THREADS) {
    qs[i] = __bfloat162float(q[qbase + i]) * scale;
    acc[i] = 0.f;
  }
  for (int i = tid; i < g; i += THREADS) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  for (int s0 = 0; s0 < S; s0 += BS) {
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < BS * HD / 8; i += THREADS) {
      const int row = i / (HD / 8), c = (i % (HD / 8)) * 8;
      float kf[8], vf[8];
      if (s0 + row < S) {
        const size_t off = (((size_t)bi * S + s0 + row) * nkv + h) * HD + c;
        const uint4 kq = *reinterpret_cast<const uint4*>(k + off);
        const uint4 vq = *reinterpret_cast<const uint4*>(v + off);
        const __nv_bfloat16* kb = reinterpret_cast<const __nv_bfloat16*>(&kq);
        const __nv_bfloat16* vb = reinterpret_cast<const __nv_bfloat16*>(&vq);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          kf[j] = __bfloat162float(kb[j]);
          vf[j] = __bfloat162float(vb[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) kf[j] = vf[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ks[row * L.KS + c + j] = kf[j];
        vs[row * HD + c + j] = vf[j];
      }
    }
    if (tid < BS) mask_s[tid] = s0 + tid < S ? kmask[(size_t)bi * S + s0 + tid] : kNegInf;
    __syncthreads();

    // scores for every (query row, slot) pair of the tile
    for (int idx = tid; idx < g * BS; idx += THREADS) {
      const int i = idx / BS, j = idx % BS;
      const float* qr = qs + i * HD;
      const float* kr = ks + j * L.KS;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
      ps[idx] = s0 + j < S ? dot + mask_s[j] : kNegInf;
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

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* kmask, void* out,
           float scale, int b, int S, int nkv, int g, cudaStream_t stream) {
  const size_t smem = Layout<HD>(g).total;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attn_decode_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(nkv, b);
  attn_decode_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(kmask),
      static_cast<float*>(out), scale, S, nkv, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" int attn_decode_launch(const void* q, const void* k, const void* v,
                                  const void* kmask, void* out, float scale, int b, int S,
                                  int nkv, int g, int hd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(q, k, v, kmask, out, scale, b, S, nkv, g, st);
    case 32: return launch<32>(q, k, v, kmask, out, scale, b, S, nkv, g, st);
    case 64: return launch<64>(q, k, v, kmask, out, scale, b, S, nkv, g, st);
    case 128: return launch<128>(q, k, v, kmask, out, scale, b, S, nkv, g, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
